"""Weighted-fair tenant admission: a start-time fair queuing scheduler.

The port's copy of ``bobrapet_tpu/traffic/fairness.py``.
:class:`WeightedFairQueue` keeps one FIFO per tenant and picks the next
admission by **start-time fair queuing** (SFQ, Goyal et al.): each pop
stamps its tenant a virtual finish tag advanced by ``cost / weight`` (cost
= prompt tokens + new-token budget, so a flood cannot buy extra turns with
fewer, bigger requests), and the backlogged tenant with the smallest tag
is served next. A tenant's tag moves only when it is served, so a victim
tenant's next request is always within one request of the head of service
however deep another tenant's backlog is. The virtual clock rides the
served tenant's start tag, and an idle tenant re-entering is clamped to
it: idle time banks no credit.

With **no weights** the queue is exact global FIFO (arrival order across
tenants), like the deque it replaces, so the engine and the router can
swap it in and out on a live reload without disturbing queued work.
Unlisted tenants weigh ``1.0``; the ``*`` key overrides that default.

The class is deque-compatible for every operation the engine and router
perform on their pending queues (``append``, ``appendleft``, ``popleft``,
``extend``, ``clear``, ``len``, truth, iteration in arrival order, and
``[0]`` peeking the current head, stable until a pop or an appendleft
changes it). The JAX module's ``guarded_state`` decorator (a declaration
for its race detector) is left out.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Callable, Iterable, Optional


def parse_tenant_weights(raw: str) -> dict[str, float]:
    """Parse the ``serving.tenant-weights`` operator value:
    ``"alice:4,bob:1"`` -> ``{"alice": 4.0, "bob": 1.0}``. Empty string
    = no weights (FIFO). Raises ``ValueError`` on malformed entries or
    non-positive weights — the config layer validates with this exact
    function, so an invalid ConfigMap never half-applies."""
    out: dict[str, float] = {}
    if not raw or not str(raw).strip():
        return out
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        tenant, sep, w = part.rpartition(":")
        if not sep or not tenant.strip():
            raise ValueError(
                f"tenant-weights entry {part!r} is not <tenant>:<weight>"
            )
        weight = float(w)
        if weight <= 0:
            raise ValueError(
                f"tenant-weights entry {part!r}: weight must be > 0"
            )
        out[tenant.strip()] = weight
    return out


def _default_cost(item: Any) -> float:
    """Admission cost of a queued request: prompt tokens + new-token
    budget (works for both the engine's ``Request`` and the router's
    ``_Queued``; anything else costs 1)."""
    prompt = getattr(item, "prompt", None)
    if prompt is None:
        return 1.0
    return max(
        1.0,
        float(len(prompt) + int(getattr(item, "max_new_tokens", 0) or 0)),
    )


class WeightedFairQueue:
    """See module docstring. Single-threaded by the same contract as
    the engine/router that owns it."""

    def __init__(
        self,
        weights: Optional[dict[str, float]] = None,
        cost: Optional[Callable[[Any], float]] = None,
        items: Iterable[Any] = (),
    ):
        self._weights = dict(weights or {})
        self._default_weight = float(self._weights.pop("*", 1.0))
        self._cost = cost or _default_cost
        #: tenant -> deque[(seq, item)] — seq is the global arrival
        #: stamp that makes no-weights mode exact FIFO
        self._queues: dict[str, deque] = {}
        #: tenant -> virtual finish tag of its last served request
        self._vfinish: dict[str, float] = {}
        #: virtual clock = start tag of the request last served
        self._vclock = 0.0
        self._seq = itertools.count()
        self._len = 0
        #: cached head tenant — stable across repeated [0] peeks while
        #: the engine retries a stalled head-of-line admission
        self._head_tenant: Optional[str] = None
        self.extend(items)

    # -- deque-compatible surface ------------------------------------------

    def append(self, item: Any) -> None:
        self._push(item, front=False)

    def appendleft(self, item: Any) -> None:
        """Requeue to the FRONT of the item's tenant queue and make it
        the head choice: the engine's preemption/chunked-prefill paths
        appendleft a request and expect the very next ``[0]``/
        ``popleft`` to see it again."""
        self._push(item, front=True)
        self._head_tenant = self._tenant(item)

    def extend(self, items: Iterable[Any]) -> None:
        for item in items:
            self._push(item, front=False)

    def clear(self) -> None:
        self._queues.clear()
        self._vfinish.clear()
        self._vclock = 0.0
        self._len = 0
        self._head_tenant = None

    def popleft(self) -> Any:
        if not self._len:
            raise IndexError("pop from an empty WeightedFairQueue")
        tenant = self._select()
        q = self._queues[tenant]
        _seq, item = q.popleft()
        self._len -= 1
        # SFQ tag update: start = max(vclock, tenant's last finish);
        # finish = start + cost/weight; the clock rides the start tag
        start = max(self._vclock, self._vfinish.get(tenant, 0.0))
        self._vfinish[tenant] = start + self._cost(item) / self._weight(tenant)
        self._vclock = start
        if not q:
            del self._queues[tenant]
            if len(self._vfinish) > 4096:
                # idle-tenant tags at/below the clock carry no state
                # (re-entry clamps to the clock anyway) — prune so a
                # churn of one-shot tenants cannot grow this forever
                self._vfinish = {
                    t: v for t, v in self._vfinish.items()
                    if t in self._queues or v > self._vclock
                }
        self._head_tenant = None
        return item

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        """Arrival order across tenants (what ``pending`` displays and
        drain bookkeeping iterate; NOT the service order)."""
        merged = sorted(
            (entry for q in self._queues.values() for entry in q),
            key=lambda e: e[0],
        )
        return (item for _seq, item in merged)

    def __getitem__(self, idx: int) -> Any:
        if idx == 0:
            if not self._len:
                raise IndexError("empty WeightedFairQueue")
            return self._queues[self._select()][0][1]
        return list(self)[idx]

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Per-tenant backlog + virtual tags."""
        return {
            "tenants": {
                t: {
                    "queued": len(q),
                    "vfinish": round(self._vfinish.get(t, 0.0), 3),
                    "weight": self._weight(t),
                }
                for t, q in self._queues.items()
            },
            "vclock": round(self._vclock, 3),
            "fair": self._fair,
        }

    # -- internals ----------------------------------------------------------

    @property
    def _fair(self) -> bool:
        return bool(self._weights) or self._default_weight != 1.0

    @staticmethod
    def _tenant(item: Any) -> str:
        return str(getattr(item, "tenant", "") or "")

    def _weight(self, tenant: str) -> float:
        return float(self._weights.get(tenant, self._default_weight))

    def _push(self, item: Any, front: bool) -> None:
        tenant = self._tenant(item)
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            # an idle tenant re-enters AT the virtual clock: its stale
            # (lower) tag would otherwise bank idle time as burst credit
            self._vfinish[tenant] = max(
                self._vfinish.get(tenant, 0.0), self._vclock
            )
        if front:
            # re-queued work keeps (a fresh low) arrival precedence:
            # negative stamps sort ahead of everything that arrived
            # after the original admission attempt
            seq = (q[0][0] - 1) if q else -next(self._seq) - 1
            q.appendleft((seq, item))
        else:
            q.append((next(self._seq), item))
        self._len += 1

    def _select(self) -> str:
        """Tenant whose head is served next (cached until a pop or an
        appendleft invalidates it).

        FIFO mode (no weights configured): globally oldest arrival.
        Fair mode: smallest start tag ``max(vclock, vfinish[t])``, ties
        broken by oldest head arrival — a backlogged tenant's tag only
        moves when it is served, so every backlogged tenant reaches the
        minimum within one request of each other tenant (bounded wait,
        no starvation, no quantum batching)."""
        if self._head_tenant is not None and self._head_tenant in self._queues:
            return self._head_tenant
        if not self._fair:
            tenant = min(self._queues, key=lambda t: self._queues[t][0][0])
        else:
            tenant = min(
                self._queues,
                key=lambda t: (
                    max(self._vclock, self._vfinish.get(t, 0.0)),
                    self._queues[t][0][0],
                ),
            )
        self._head_tenant = tenant
        return tenant
