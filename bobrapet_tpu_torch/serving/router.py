"""ServingRouter: disaggregated prefill/decode pools with prefix-aware
routing.

The port's copy of ``bobrapet_tpu/serving/router.py``. Prompt-heavy
requests stall decode horizons when one engine does both (any ingesting
slot takes the engine off the fused horizon), so the work is split:

- a **prefill pool** (engines with ``role="prefill"``) retires each
  request the moment its first token is picked, its full prompt blocks
  already exported through the
  :class:`~.prefix_cache.SharedPrefixRegistry` (in memory, spilling to the
  slice-local disk tier where one is attached);
- a **decode pool** (``role="decode"`` / ``"unified"``) adopts those blocks
  with one copy a pool at admission: the continuation prefills at most the
  last partial block (none for a block-aligned prompt) and then rides the
  fused decode horizons.

**Prefix-aware routing**: each decode admission probes every candidate
engine's local chain (``PrefixCache.longest_local_match``) and the shared
registry (``SharedPrefixRegistry.longest_match``) and lands on the engine
already holding the longest matching chain, falling back to the least
loaded one on a miss.

**Correctness bar**: the decode output equals a unified engine's serving
the same requests, token for token, greedy and sampled: the pick is keyed
by (rid, token index), and the router pins one rid on every engine a
request touches.

The router is single-threaded by the engine's own contract: one serve loop
drives ``submit``/``step``. It duck-types the engine surface
:class:`~.service.StreamServer` consumes (``submit``/``step``/
``finished``/``active_slots``/``pending``).

Live tuning: :func:`apply_tuning` retunes the prefill threshold, the
prefix affinity and the tenant weights of live routers, and a role change
re-pools an engine at its next admission (pools are derived from each
engine's current role). The JAX router's metrics and flight-recorder
decisions wait for the port's observability slice.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _walltime
import weakref
from collections import deque
from typing import Any, Optional

from .engine import Request, ServingEngine

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DrainStatus:
    """One engine's drain progress: ``in_flight`` counts everything not
    yet delivered (engine queue, active slots, finishes the router has not
    harvested), and ``empty`` says the engine is safe to remove or
    retune."""

    engine: str
    draining: bool
    in_flight: int

    @property
    def empty(self) -> bool:
        return self.draining and self.in_flight == 0

#: routers this process is serving: the live-reload targets of the
#: ``serving.router-*`` knobs
_LIVE_ROUTERS: "weakref.WeakSet[ServingRouter]" = weakref.WeakSet()


def apply_tuning(scfg: Any) -> None:
    """Apply the ``serving.router-*`` (and tenant-weight) knobs of ``scfg``
    (any object with ``ServingConfig``'s fields) to every live router;
    ``engram.apply_tuning`` forwards here once this module is loaded."""
    from ..traffic.fairness import parse_tenant_weights

    try:
        weights: Optional[dict] = parse_tenant_weights(scfg.tenant_weights)
    except ValueError as e:
        _log.warning("serving.tenant-weights unparseable, keeping prior "
                     "weights: %s", e)
        weights = None
    for router in list(_LIVE_ROUTERS):
        try:
            router.set_prefill_threshold(scfg.router_prefill_threshold)
            router.set_prefix_affinity(scfg.router_prefix_affinity)
            if weights is not None:
                router.set_tenant_weights(weights)
        except ValueError as e:
            _log.warning("serving.router-* reload skipped a router: %s", e)


class _Queued:
    """One router-queued request (not yet admitted to an engine)."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature",
                 "eos_token", "adapter", "tenant", "output",
                 "enqueued_at", "enqueued_wall", "handoff_from", "carry",
                 "_hashes")

    def __init__(self, rid, prompt, max_new_tokens, temperature,
                 eos_token, adapter, tenant, output=None,
                 handoff_from: Optional[float] = None,
                 carry: Optional[dict] = None):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_token = eos_token
        self.adapter = adapter
        self.tenant = tenant
        self.output = output
        self.enqueued_at = _walltime.perf_counter()
        self.enqueued_wall = _walltime.time()
        #: perf_counter of the prefill-pool retirement (handoffs only)
        self.handoff_from = handoff_from
        #: request clocks carried onto the engine Request after submit:
        #: a first leg carries the router's enqueue clocks (engine.submit
        #: stamps arrival at admission, which would leave the router's
        #: queue wait out of TTFT), a handoff leg the prefill leg's set
        self.carry = carry or {"submitted_at": self.enqueued_at,
                               "submitted_wall": self.enqueued_wall}
        #: chain digests, hashed once per queued request (affinity probes
        #: retry every scheduling pass)
        self._hashes: Optional[list[bytes]] = None

    def hashes(self, block_size: int) -> list[bytes]:
        if self._hashes is None:
            from .prefix_cache import chain_hashes

            self._hashes = chain_hashes(
                self.prompt + (self.output or []), block_size,
                self.adapter or 0)
        return self._hashes


class ServingRouter:
    """See module docstring.

    ``engines`` is ``{name: ServingEngine}``; pools are derived from
    each engine's live ``role``. ``registry`` overrides the shared
    registry probed for prefix affinity (defaults to whatever the
    engines share through)."""

    def __init__(self, engines: dict[str, ServingEngine],
                 registry: Any = None,
                 prefill_threshold: int = 0,
                 prefix_affinity: bool = True,
                 tenant_weights: Optional[dict[str, float]] = None):
        if not engines:
            raise ValueError("ServingRouter needs at least one engine")
        if prefill_threshold < 0:
            raise ValueError("prefill_threshold must be >= 0")
        self.engines = dict(engines)
        self.registry = registry
        self.prefill_threshold = int(prefill_threshold)
        self.prefix_affinity = bool(prefix_affinity)
        self._tenant_weights: Optional[dict[str, float]] = None
        self._queues: dict[str, Any] = {
            "prefill": deque(), "decode": deque(),
        }
        if tenant_weights:
            self.set_tenant_weights(tenant_weights)
        #: engines the autoscaler (or a role change) is draining: still
        #: stepped and harvested, never routed new work
        self._draining: set[str] = set()
        #: engine -> target role applied once its drain reaches empty
        #: (live role demotion through the drain contract: the flip
        #: never truncates in-flight work)
        self._pending_roles: dict[str, str] = {}
        # start ABOVE every engine's own counter: router rids are
        # pinned onto engines, and a collision with a directly-
        # submitted request's rid would alias their sampled streams
        # AND make _harvest claim the foreign request as owned
        self._next_rid = max(eng._next_rid for eng in self.engines.values())
        #: engine.finished index already harvested, per engine (engines
        #: may carry history from direct use before the router attached)
        self._consumed = {name: len(eng.finished)
                          for name, eng in self.engines.items()}
        #: rid -> final decode-pool routing outcome ("prefix-hit"|"miss")
        self.outcomes: dict[int, str] = {}
        #: rids the router owns (a finished request with a foreign rid —
        #: direct engine use — is left alone, never harvested)
        self._owned: set[int] = set()
        #: rid -> perf_counter of the prefill-pool retirement, pending
        #: resolution into kv_handoff_s at completion
        self._handoff_clock: dict[int, float] = {}
        self.finished: list[Request] = []
        _LIVE_ROUTERS.add(self)

    # -- live tuning -------------------------------------------------------

    def set_prefill_threshold(self, tokens: int) -> None:
        """Live-reloadable (`serving.router-prefill-threshold`): prompts
        shorter than this skip the prefill pool (their prefill is too
        small to be worth a handoff); 0 routes every request through it
        while one exists."""
        if tokens < 0:
            raise ValueError("router-prefill-threshold must be >= 0")
        self.prefill_threshold = int(tokens)

    def set_prefix_affinity(self, enabled: bool) -> None:
        """Live-reloadable (`serving.router-prefix-affinity`): False
        degrades routing to pure least-loaded (every decode admission
        counts as a miss) — the A/B lever that prices the
        affinity itself."""
        self.prefix_affinity = bool(enabled)

    def set_tenant_weights(self, weights: Optional[dict[str, float]]) -> None:
        """Live-reloadable (`serving.tenant-weights`): swap the per-pool
        queues between plain FIFO (no weights) and the weighted
        start-time fair scheduler. Queued work transfers in arrival order, so a
        mid-traffic reload reorders SERVICE, never loses or duplicates
        a request."""
        weights = dict(weights) if weights else None
        if weights == self._tenant_weights:
            return
        self._tenant_weights = weights
        for pool, q in self._queues.items():
            if weights:
                from ..traffic.fairness import WeightedFairQueue

                fresh: Any = WeightedFairQueue(weights)
            else:
                fresh = deque()
            fresh.extend(q)  # arrival order either way
            self._queues[pool] = fresh

    # -- replica lifecycle (the drain contract) ----------------------------

    def add_engine(self, name: str, engine: ServingEngine) -> None:
        """Register a replica (the autoscaler's scale-up actuator).
        The rid counters sync both ways so the newcomer's history can
        never alias a routed rid."""
        if name in self.engines:
            raise ValueError(f"engine {name!r} already registered")
        self._next_rid = max(self._next_rid, engine._next_rid)
        engine._next_rid = max(engine._next_rid, self._next_rid)
        self.engines[name] = engine
        self._consumed[name] = len(engine.finished)
        engine.undrain()

    def drain(self, name: str) -> DrainStatus:
        """Stop routing new work to ``name`` (and block direct submits
        on the engine itself); everything already accepted keeps
        stepping to retirement. Idempotent."""
        eng = self._engine(name)
        self._draining.add(name)
        eng.drain()
        return self.drain_status(name)  # type: ignore[return-value]

    def undrain(self, name: str) -> None:
        """Cancel a drain: the engine is routable again."""
        eng = self._engine(name)
        self._draining.discard(name)
        self._pending_roles.pop(name, None)
        eng.undrain()

    def drain_status(self, name: str) -> Optional[DrainStatus]:
        """None for an unknown engine (a preempted replica already
        evicted — the autoscaler treats that as drain complete)."""
        eng = self.engines.get(name)
        if eng is None:
            return None
        unharvested = len(eng.finished) - self._consumed[name]
        return DrainStatus(
            engine=name,
            draining=name in self._draining,
            in_flight=eng.in_flight + unharvested,
        )

    def remove_engine(self, name: str) -> ServingEngine:
        """Unregister a DRAINED replica (scale-down's final step). The
        engine must be empty — removing live work would strand it; use
        :meth:`evict_engine` for a dead (preempted) replica."""
        self._harvest()  # deliver any finishes still on the engine
        status = self.drain_status(name)
        if status is None:
            raise ValueError(f"unknown engine {name!r}")
        if not status.empty:
            raise ValueError(
                f"engine {name!r} still has {status.in_flight} request(s) "
                f"in flight (draining={status.draining}) — drain it first"
            )
        self._draining.discard(name)
        self._pending_roles.pop(name, None)
        self._consumed.pop(name, None)
        return self.engines.pop(name)

    def evict_engine(self, name: str) -> int:
        """A replica died under us (slice preempted): requeue every
        unfinished owned request onto the router — output so far rides
        along as a preseed, lifecycle clocks carry, sampled streams
        stay byte-identical (keys fold from the pinned rid) — then
        unregister the engine. Returns the number requeued. Completed
        work still on the engine is harvested first, so every rid
        retires exactly once no matter when the preemption lands."""
        eng = self.engines.get(name)
        if eng is None:
            raise ValueError(f"unknown engine {name!r}")
        self._harvest()
        stranded: list[Request] = []
        for slot in eng.slots:
            if slot is not None and slot.request.rid in self._owned:
                stranded.append(slot.request)
        for req in eng.pending:
            if req.rid in self._owned:
                stranded.append(req)
        for req in stranded:
            self._requeue_evicted(req)
        self._draining.discard(name)
        self._pending_roles.pop(name, None)
        self._consumed.pop(name, None)
        self.engines.pop(name)
        return len(stranded)

    def set_role(self, name: str, role: str) -> None:
        """Live role change through the drain contract: the engine
        stops receiving new work, finishes what it holds under its OLD
        role, then flips and rejoins its new pool — a demotion can
        never truncate in-flight requests, a promotion can never leak
        a full-budget continuation. No-op when already in role."""
        eng = self._engine(name)
        if eng.role == role and name not in self._pending_roles:
            return
        if role not in ServingEngine.ROLES:
            raise ValueError(
                f"role must be one of {sorted(ServingEngine.ROLES)}, "
                f"got {role!r}"
            )
        self._pending_roles[name] = role
        self.drain(name)
        self._apply_pending_roles()

    def _apply_pending_roles(self) -> None:
        for name in list(self._pending_roles):
            status = self.drain_status(name)
            if status is not None and status.empty:
                role = self._pending_roles.pop(name)
                eng = self.engines[name]
                eng.set_role(role)
                self._draining.discard(name)
                eng.undrain()

    def _engine(self, name: str) -> ServingEngine:
        eng = self.engines.get(name)
        if eng is None:
            raise ValueError(f"unknown engine {name!r}")
        return eng

    def _requeue_evicted(self, req: Request) -> None:
        carry: dict[str, Any] = {
            "submitted_at": req.submitted_at,
            "submitted_wall": req.submitted_wall,
            # queue wait was observed at the FIRST admission; carrying
            # the clock keeps the re-admission from minting a second
            # sample (engine._prefill guards on admitted_at)
            "admitted_at": req.admitted_at,
        }
        ttft = req.ttft_seconds
        if ttft is not None:
            # the user already saw their first token before the
            # preemption — re-deriving TTFT on the new engine would
            # count the eviction gap as fresh first-token latency
            carry["ttft_carried_s"] = ttft
        q = _Queued(req.rid, req.prompt, req.max_new_tokens,
                    req.temperature, req.eos_token,
                    req.adapter, req.tenant,
                    output=list(req.output), carry=carry)
        pool = "decode" if req.output else self._submit_pool(q)
        self._queues[pool].append(q)

    def queue_depths(self) -> dict[str, int]:
        """Router backlog per pool (the autoscaler's depth signal)."""
        return {pool: len(q) for pool, q in self._queues.items()}

    # -- StreamServer surface ----------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(eng.active_slots for eng in self.engines.values())

    @property
    def pending(self) -> tuple:
        """Everything admitted but unfinished ANYWHERE (router queues +
        engine queues) — truthy exactly while a drain must keep
        stepping, which is all StreamServer consumes."""
        out: list = []
        for q in self._queues.values():
            out.extend(q)
        for eng in self.engines.values():
            out.extend(eng.pending)
        return tuple(out)

    def submit(self, prompt: list[int], max_new_tokens: int,
               temperature: float = 0.0,
               eos_token: Optional[int] = None,
               adapter: Optional[int] = None,
               tenant: str = "") -> int:
        """Queue one request; returns its router-wide rid (the SAME rid
        every engine that touches the request decodes under)."""
        # re-sync against the engine counters each submit: traffic
        # submitted DIRECTLY to a pool engine since the last call must
        # never share a rid with a routed request (see ctor comment)
        self._next_rid = max(
            self._next_rid,
            max(eng._next_rid for eng in self.engines.values()),
        )
        rid = self._next_rid
        self._next_rid += 1
        # ...and advance every engine's counter PAST the rid now: the
        # routed request only reaches an engine at _admit, and a direct
        # submit landing in that window would otherwise mint the same
        # rid (aliased sampling streams + a foreign harvest)
        for eng in self.engines.values():
            eng._next_rid = max(eng._next_rid, rid + 1)
        self._owned.add(rid)
        q = _Queued(rid, list(prompt), max_new_tokens, temperature,
                    eos_token, adapter, tenant)
        pool = self._submit_pool(q)
        self._queues[pool].append(q)
        return rid

    def _submit_pool(self, q: _Queued) -> str:
        if len(q.prompt) >= self.prefill_threshold and self._pool("prefill"):
            return "prefill"
        return "decode"

    def step(self) -> list[int]:
        """One router tick: admit queued work onto engines, step every
        engine with work, harvest finishes (handoffs re-queue onto the
        decode pool). Returns rids that COMPLETED this tick."""
        self._admit("prefill")
        self._admit("decode")
        for eng in self.engines.values():
            if eng.pending or eng.active_slots:
                eng.step()
        done = self._harvest()
        # deferred role changes apply the moment their drain is empty
        self._apply_pending_roles()
        return done

    def run(self, max_steps: int = 1_000_000) -> list[Request]:
        """Drive until every submitted request completes; returns them
        in completion order."""
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    @property
    def busy(self) -> bool:
        # cheap form of bool(self.pending) — the drain loop checks this
        # every step, and materializing the combined tuple each time
        # was pure allocation churn
        return (any(len(q) for q in self._queues.values())
                or any(eng.pending or eng.active_slots
                       for eng in self.engines.values()))

    # -- routing -----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        """Fraction of decode-pool admissions routed by prefix chain;
        1.0 before any decode admission."""
        hits = sum(1 for o in self.outcomes.values() if o == "prefix-hit")
        total = len(self.outcomes)
        return hits / total if total else 1.0

    def _pool(self, *roles: str) -> list[tuple[str, ServingEngine]]:
        return [(n, e) for n, e in self.engines.items()
                if e.role in roles and n not in self._draining]

    @staticmethod
    def _load(eng: ServingEngine) -> int:
        return eng.active_slots + len(eng.pending)

    def _has_room(self, eng: ServingEngine) -> bool:
        return self._load(eng) < eng.pcfg.max_slots

    def _admit(self, pool: str) -> None:
        queue = self._queues[pool]
        if pool == "prefill" and queue and not self._pool("prefill"):
            # live demotion emptied the pool: everything queued drains
            # through the decode pool instead of deadlocking
            self._queues["decode"].extend(queue)
            queue.clear()
            return
        while queue:
            q = queue[0]
            if pool == "prefill":
                target = self._pick_prefill(q)
            else:
                target = self._pick_decode(q)
            if target is None:
                return  # no engine can take the head; FIFO holds
            name, eng = target
            queue.popleft()
            eng.submit(q.prompt, q.max_new_tokens,
                       temperature=q.temperature, eos_token=q.eos_token,
                       adapter=q.adapter, tenant=q.tenant,
                       rid=q.rid, output=q.output)
            # restore the request's true clocks onto the engine Request
            # (the freshly queued tail of pending): engine.submit stamps
            # arrival at admission, which would leave the router's queue
            # wait out of TTFT; a handoff leg carries the prefill leg's
            # set, its TTFT included
            req = eng.pending[-1]
            for field, value in q.carry.items():
                setattr(req, field, value)

    def _pick_prefill(self, q: _Queued) -> Optional[tuple[str, ServingEngine]]:
        pool = self._pool("prefill")
        cands = [(self._load(e), n, e) for n, e in pool if self._has_room(e)]
        if not cands:
            return None
        _, name, eng = min(cands)
        return name, eng

    def _pick_decode(self, q: _Queued) -> Optional[tuple[str, ServingEngine]]:
        pool = self._pool("decode", "unified")
        if not pool:
            # every engine is prefill-role (operator misstep mid-reload):
            # decoding SOMEWHERE beats deadlock — a prefill engine still
            # decodes correctly, it just retires at the first token and
            # the request comes back around as another handoff
            pool = self._pool("prefill")
        if not pool:
            # everything is draining: the queue holds until a drain
            # finishes (undrain/role flip) or a replica joins — a
            # draining engine must never be handed NEW work
            return None
        outcome, choice = "miss", None
        has_room = any(self._has_room(e) for _n, e in pool)
        if self.prefix_affinity:
            # local probes are cheap dict lookups over the queued
            # request's cached digests — safe to repeat while the head
            # stalls on a full pool
            hashes = q.hashes(pool[0][1].pcfg.block_size)
            ranked = sorted(
                ((e.blocks.longest_local_match_hashes(hashes), n, e)
                 for n, e in pool),
                key=lambda t: (-t[0], t[1]),
            )
            best_depth, best_name, best_eng = ranked[0]
            if best_depth > 0:
                # the KV already resident on one engine beats both load
                # balance and a registry adoption — route to it even
                # when it is the busier engine
                outcome = "prefix-hit"
                choice = (best_name, best_eng)
            elif has_room:
                # the registry probe touches LRU entries, so it runs only
                # when a placement can actually happen
                if self._registry_depth(pool[0][1], hashes) > 0:
                    # any engine adopts registry blocks at equal cost:
                    # prefix-routed, placed least-loaded
                    outcome = "prefix-hit"
        if choice is None:
            if not has_room:
                return None
            cands = [(self._load(e), n, e) for n, e in pool
                     if self._has_room(e)]
            _, name, eng = min(cands)
            choice = (name, eng)
        self.outcomes[q.rid] = outcome
        return choice

    def _registry_depth(self, eng: ServingEngine,
                        hashes: list[bytes]) -> int:
        """Shared-registry chain depth for a queued prompt under the
        pool's scope (engines in one pool share weights, hence scope)."""
        reg = self.registry if self.registry is not None else eng.blocks.shared
        if reg is None:
            return 0
        scope = eng.blocks.scope
        if not scope:
            return 0
        return reg.longest_match_hashes(scope, hashes)

    # -- harvest -----------------------------------------------------------

    def _harvest(self) -> list[int]:
        done: list[int] = []
        for name, eng in self.engines.items():
            idx = self._consumed[name]
            while idx < len(eng.finished):
                req = eng.finished[idx]
                idx += 1
                if req.rid not in self._owned:
                    continue  # direct engine traffic, not ours
                if req.prefilled and len(req.output) < req.max_new_tokens:
                    self._handoff(req)
                else:
                    # not prefilled, OR a prefilled retirement whose
                    # output already fills the budget (a role flip
                    # landing on the final token): nothing left to
                    # decode — complete it rather than hand off a
                    # continuation with no remaining budget
                    self._complete(req)
                    done.append(req.rid)
            self._consumed[name] = idx
        return done

    def _handoff(self, req: Request) -> None:
        """A prefill-pool retirement: re-queue the request onto the
        decode pool with its output preseeded. The KV needs no copy
        here — register() exported the prompt blocks at prefill time,
        and the decode engine's admission adopts them by chain hash."""
        now = _walltime.perf_counter()
        self._handoff_clock[req.rid] = now
        q = _Queued(req.rid, req.prompt, req.max_new_tokens,
                    req.temperature, req.eos_token,
                    req.adapter, req.tenant,
                    output=list(req.output), handoff_from=now,
                    carry={"submitted_at": req.submitted_at,
                           "submitted_wall": req.submitted_wall,
                           "admitted_at": req.admitted_at,
                           # the TRUE user TTFT: prefill-leg first
                           # token against the original submit clock
                           "ttft_carried_s": req.ttft_seconds})
        self._queues["decode"].append(q)

    def _complete(self, req: Request) -> None:
        t0 = self._handoff_clock.pop(req.rid, None)
        if t0 is not None and req.first_token_at is not None:
            # the full prefill-retire -> first-NEW-token latency
            # (decode-pool queue + registry adoption scatter + the
            # suffix prefill) — disaggregation's per-request cost
            req.kv_handoff_s = max(0.0, req.first_token_at - t0)
        self.finished.append(req)
