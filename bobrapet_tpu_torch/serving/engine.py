"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``bobrapet_tpu/serving/engine.py``, sub-slices (a) and
(b): the classic single-step engine and the fused decode horizon, at
``dispatch_depth=1``, greedy, without prefix caching. Requests stream
through a fixed set of slots: a request is admitted the moment a slot and
enough KV blocks are free, decodes fused with every other live request,
and leaves the instant it finishes.

- One decode step for every slot: liveness is a mask, never a shape;
  inactive slots compute garbage that lands in the scratch block.
- Prefill runs per length bucket (next power of two, whole blocks).
- The host scheduler (admit, retire, grow, preempt, block accounting)
  touches only small int lists; the pools are written in place.
- Preemption is recompute: the youngest slot's blocks are freed and it
  re-queues with its prompt + the tokens it already generated.
- ``pipeline_decode``: in the steady decode state tick N+1 is dispatched
  from tick N's device tokens before tick N is read back, so the host's
  launches overlap the card's work; eos is seen one tick late and the
  extra lane's token is dropped. Small host arrays go up from pinned
  memory without blocking, and each tick's tokens come back through a
  pinned buffer behind an event, so nothing else waits on the card.
- ``decode_horizon`` H > 1: H greedy steps per engine tick with the lane
  state (last token, length, liveness, emitted count, budget, eos, block
  table) resident on the device; eos and budgets deactivate lanes there,
  a dead lane writes the scratch block and emits -1. Each lane's table is
  funded H tokens ahead first (without preemption: when that fails the
  classic tick runs, which may preempt). Only the lanes the host changed
  are patched before a horizon, and one copy brings back the tokens
  ``[H, S]`` and the lane state after it. On a card the horizon is one
  CUDA graph per H (:class:`~bobrapet_tpu_torch.graphs.GraphedStep`),
  replayed once per tick: the JAX engine's ``lax.scan``.

On a card every norm (each but the first fused with the residual add
before it), the prefill attention and the decode attention launch the
port's kernels; on the CPU their plain versions run.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..models.llama import (
    LlamaConfig,
    _freqs_table,
    _logits,
    _mlp_block,
    _qkv,
    forward,
    init_cache,
)
from ..graphs import GraphedStep
from ..models.quant import matmul as _mm
from ..ops.paged_attention import paged_attention
from .paged_cache import SCRATCH_BLOCK, BlockAllocator, PagedConfig, init_pools, write_prefill


@dataclasses.dataclass
class Request:
    """The JAX engine's request, field for field and in its order. The port
    serves greedy requests of the base model: ``temperature`` 0 and
    ``adapter`` 0; ``tenant`` and ``trace`` are carried for a router."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_token: Optional[int] = None
    #: multi-LoRA adapter index (0 = the base model)
    adapter: int = 0
    #: SLO attribution label ("" = unattributed)
    tenant: str = ""
    #: per-request trace context override ({traceId, spanId})
    trace: Optional[dict] = None
    #: filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0
    #: retired by a prefill-role engine for a decode engine to continue
    prefilled: bool = False
    #: tokens already in ``output`` at submit (a KV-handoff continuation)
    preseeded: int = 0
    #: prefill-pool retirement to this engine's first new token (handoffs)
    kv_handoff_s: Optional[float] = None
    #: the user-visible TTFT carried across a handoff
    ttft_carried_s: Optional[float] = None
    #: host perf_counter stamps: TTFT = first_token_at - submitted_at,
    #: TPOT from first_token_at to finished_at; one wall-clock anchor
    submitted_at: float = 0.0
    submitted_wall: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def ttft_seconds(self) -> Optional[float]:
        if self.ttft_carried_s is not None:
            return self.ttft_carried_s
        if self.first_token_at is None or not self.submitted_at:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot_seconds(self) -> Optional[float]:
        """Mean time per output token after the first (None until the
        request finishes with >= 2 tokens of its own; preseeded tokens
        came from another engine)."""
        emitted = len(self.output) - self.preseeded
        if self.finished_at is None or self.first_token_at is None or emitted < 2:
            return None
        return (self.finished_at - self.first_token_at) / (emitted - 1)


@dataclasses.dataclass
class _SlotState:
    request: Request
    blocks: list[int]
    seq_len: int  # tokens currently in the cache (prompt + generated)


#: columns of the device lane state [S, LANE_TABLE + max_blocks_per_seq]
#: int32: the four the horizon advances, then budget, eos, the block table
LANE_LAST, LANE_SEQ, LANE_ACT, LANE_EMITTED, LANE_BUDGET, LANE_EOS, LANE_TABLE = range(7)
LANE_FIELDS = ("last", "seq", "act", "emitted", "budget", "eos")


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _weights_device(tree: Any) -> torch.device:
    """The one device every tensor of ``tree`` lives on; raises otherwise."""
    devices = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            devices.add(node.device)
    if len(devices) != 1:
        raise ValueError(
            f"the weights must all live on one device, found {sorted(map(str, devices))}")
    return devices.pop()


def _not_ported(what: str, instead: str, sub_slice: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: pass {instead} (it comes with ROADMAP Queue 1, "
        f"engine sub-slice {sub_slice})")


class ServingEngine:
    """See the module docstring. The params tree may be int8
    (``models.quant``); the pools live on the device of the weights."""

    ROLES = frozenset({"unified", "prefill", "decode"})

    def __init__(self, params: Any, cfg: LlamaConfig,
                 pcfg: Optional[PagedConfig] = None,
                 loras: Optional[Any] = None,
                 draft_params: Optional[Any] = None,
                 pipeline_decode: bool = True,
                 decode_horizon: int = 8,
                 dispatch_depth: int = 2,
                 role: str = "unified"):
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if dispatch_depth < 1:
            raise ValueError("dispatch_depth must be >= 1")
        if role not in self.ROLES:
            raise ValueError(f"role must be one of {sorted(self.ROLES)}, got {role!r}")
        pcfg = pcfg or PagedConfig()
        if dispatch_depth > 1:
            raise _not_ported("the depth-N dispatch pipeline", "dispatch_depth=1", "(c)")
        if pcfg.prefix_caching:
            raise _not_ported("prefix caching",
                              "PagedConfig(..., prefix_caching=False)", "(d)")
        if pcfg.prefill_chunk is not None:
            raise _not_ported("chunked prefill", "PagedConfig(..., prefill_chunk=None)", "(d)")
        if loras is not None:
            raise _not_ported("multi-LoRA serving", "loras=None", "(d)")
        if draft_params is not None:
            raise _not_ported("speculative decoding", "draft_params=None", "(e)")
        if getattr(cfg, "n_experts", None) is not None:
            raise NotImplementedError(
                "MoE serving is not ported yet: pass a dense LlamaConfig (the MoE "
                "family comes with ROADMAP Queue 1 item 8)")
        if role != "unified":
            raise NotImplementedError(
                f"role {role!r} is not ported yet: pass role='unified' (disaggregated "
                "serving comes with ROADMAP Queue 1 item 7)")
        self.params = params
        self.cfg = cfg
        self.pcfg = pcfg
        self.pipeline_decode = pipeline_decode
        #: greedy steps per horizon; 1 = the classic single-step engine
        self.decode_horizon = int(decode_horizon)
        self.dispatch_depth = int(dispatch_depth)
        self.device = _weights_device(params)
        self.pools = init_pools(cfg, pcfg, self.device)
        self.allocator = BlockAllocator(pcfg.num_blocks)
        #: a draining engine refuses new submissions but serves its queue
        self.draining = False
        self.pending: deque[Request] = deque()
        self.slots: list[Optional[_SlotState]] = [None] * pcfg.max_slots
        self.finished: list[Request] = []
        self._next_rid = 0
        self._last_tokens = [0] * pcfg.max_slots
        self._pending_tick: Optional[dict] = None
        S, MB = pcfg.max_slots, pcfg.max_blocks_per_seq
        #: the classic tick's block tables: one static buffer, rewritten in
        #: place on a structural change (admission, growth, retire)
        self._tables = torch.full((S, MB), SCRATCH_BLOCK, dtype=torch.int32, device=self.device)
        self._tables_key: Optional[tuple] = None
        self._lane_cache: Optional[tuple] = None
        self._lane_key: Optional[tuple] = None
        #: the horizon's device lane state, one static int32 buffer
        #: [S, LANE_TABLE + MB] (last, seq, act, emitted, budget, eos, then
        #: the block table): patched lane by lane, advanced in place
        self._dev = torch.zeros((S, LANE_TABLE + MB), dtype=torch.int32, device=self.device)
        #: what the device holds per lane, as the host last wrote or read it
        self._dev_mirror: list[Optional[dict]] = [None] * S
        #: per horizon length: the graphed horizon, its output [H + 4, S]
        #: and the pinned host buffer it is read back through
        self._hz: dict[int, tuple[GraphedStep, torch.Tensor]] = {}
        #: host seconds per phase: ``prefill`` (forward + first-token
        #: readback), ``decode_device`` (issuing decode ticks and horizons:
        #: every launch or replay is enqueued here), ``host_sync`` (waiting
        #: for their tokens)
        self.phase_seconds = {"prefill": 0.0, "decode_device": 0.0, "host_sync": 0.0}
        #: ``device_steps`` counts decode steps dispatched (H per horizon),
        #: ``horizons`` the horizons
        self.phase_counts = {"host_syncs": 0, "horizons": 0, "device_steps": 0}

    # -- public API --------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int,
               temperature: float = 0.0, eos_token: Optional[int] = None) -> int:
        """Queue a greedy request; returns its rid."""
        if self.draining:
            raise ValueError(
                "engine is draining (scale-down or role change in progress): "
                "submit to another replica")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill always "
                             "samples one token)")
        if not prompt:
            raise ValueError("prompt must hold at least one token")
        if len(prompt) + max_new_tokens > self.pcfg.capacity:
            raise ValueError(
                f"prompt+new ({len(prompt)}+{max_new_tokens}) exceeds slot "
                f"capacity {self.pcfg.capacity}")
        if temperature > 0:
            raise NotImplementedError(
                "sampled decoding is not ported yet: pass temperature=0 (greedy); "
                "it comes with its own invariant in ROADMAP Queue 1 item 6")
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(Request(rid, list(prompt), max_new_tokens, temperature, eos_token,
                                    submitted_at=time.perf_counter(),
                                    submitted_wall=time.time()))
        return rid

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive until every submitted request finishes; returns them in
        completion order."""
        steps = 0
        while (self.pending or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        # a pipelined tick may still be pending at loop exit
        self._commit_tick(self._pending_tick)
        self._pending_tick = None
        return self.finished

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def drain(self) -> None:
        """Stop admitting new submissions; everything already accepted
        keeps stepping to retirement. Idempotent."""
        self.draining = True

    def undrain(self) -> None:
        self.draining = False

    @property
    def in_flight(self) -> int:
        """Requests accepted but not yet finished (queue + slots)."""
        return len(self.pending) + self.active_slots

    @property
    def drained(self) -> bool:
        """True exactly when a requested drain has fully retired."""
        return self.draining and self.in_flight == 0

    def set_decode_horizon(self, horizon: int) -> None:
        """Live: takes effect at the next tick. One graph is kept per
        horizon length, so flipping back and forth captures each once."""
        if horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        self.decode_horizon = int(horizon)

    def reset_phase_stats(self) -> None:
        """Zero the per-phase counters (after a warm-up)."""
        for k in self.phase_seconds:
            self.phase_seconds[k] = 0.0
        for k in self.phase_counts:
            self.phase_counts[k] = 0

    # -- scheduler ---------------------------------------------------------

    def step(self) -> list[int]:
        """One engine tick. Steady decode state with ``pipeline_decode``
        (and H = 1; a horizon subsumes it): dispatch tick N+1, then read
        back tick N. Otherwise: commit any pending tick, then the settled
        sequence (admit -> retire finished -> a horizon, or grow/preempt ->
        decode -> retire). Returns rids that finished."""
        if self.decode_horizon <= 1 and self.pipeline_decode and self._steady_state():
            prev = self._pending_tick
            self._pending_tick = None
            new_tick = self._dispatch_plain(prev)
            done = self._commit_tick(prev)
            self._pending_tick = new_tick
            return done
        done = self._commit_tick(self._pending_tick)
        self._pending_tick = None
        done.extend(self._settled_step())
        return done

    @staticmethod
    def _pending_indices(tick: Optional[dict]) -> set:
        """Slot indexes with an uncommitted token in the in-flight tick;
        their effective seq_len is one ahead of the committed value."""
        return {i for i, _rid in tick["snapshot"]} if tick else set()

    def _steady_state(self) -> bool:
        """True when the next tick is pure decode: nothing to admit, every
        active slot's next write position already block-covered, and at
        least one slot decoding."""
        if self.pending:
            return False
        pend_idx = self._pending_indices(self._pending_tick)
        any_active = False
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            any_active = True
            # the next dispatch passes seq_lens == predicted and writes at
            # position predicted - 1
            predicted = s.seq_len + (1 if i in pend_idx else 0)
            if self.pcfg.blocks_for(predicted) > len(s.blocks):
                return False
            if predicted > self.pcfg.capacity:
                return False
        return any_active

    def _settled_step(self) -> list[int]:
        self._admit()
        # a request can finish on its prefill token (max_new_tokens=1, or
        # eos as the first token): decoding it once more would overrun
        done: list[int] = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.done:
                done.append(slot.request.rid)
                self._retire(i)
        if not any(self.slots):
            return done
        if self.decode_horizon > 1:
            hz = self._plain_horizon_decode(self.decode_horizon)
            if hz is not None:
                done.extend(hz)
                return done
            # lookahead unfundable without preemption: the classic tick,
            # which may preempt
        self._ensure_growth()
        if not any(self.slots):
            return done
        done.extend(self._decode_once())
        return done

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if not self.pending:
                return
            if slot is not None:
                continue
            req = self.pending[0]
            effective = req.prompt + req.output
            need_total = self.pcfg.blocks_for(len(effective) + 1)
            if need_total > self.pcfg.max_blocks_per_seq:
                req.done = True
                self.pending.popleft()
                self.finished.append(req)
                continue
            fresh = self.allocator.alloc(need_total)
            if fresh is None:
                return  # head-of-line waits for memory
            self.pending.popleft()
            self._prefill(i, req, fresh)

    def _ensure_growth(self) -> None:
        """Ensure every slot's table covers its next write (position
        seq_len - 1, i.e. blocks_for(seq_len) blocks); preempt the
        youngest slot when the pool is exhausted."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            needed = self.pcfg.blocks_for(slot.seq_len)
            if needed <= len(slot.blocks):
                continue
            if needed > self.pcfg.max_blocks_per_seq:
                self._retire(i)  # capacity cap reached
                continue
            while self.slots[i] is not None and len(slot.blocks) < needed:
                got = self.allocator.alloc(1)
                while got is None:
                    victim = self._youngest(exclude=i)
                    if victim is None:
                        # nothing to steal from: retire this request with
                        # what it has rather than deadlock
                        self._retire(i)
                        break
                    self._preempt(victim)
                    got = self.allocator.alloc(1)
                if self.slots[i] is not None and got:
                    slot.blocks.extend(got)

    def _youngest(self, exclude: int) -> Optional[int]:
        cands = [(self.slots[i].request.rid, i) for i in range(len(self.slots))
                 if i != exclude and self.slots[i] is not None]
        return max(cands)[1] if cands else None

    def _preempt(self, slot_idx: int) -> None:
        """Recompute strategy: free the blocks now; on readmission the
        prefill recomputes prompt + the tokens already generated."""
        slot = self.slots[slot_idx]
        assert slot is not None
        slot.request.preemptions += 1
        self.allocator.free(slot.blocks)
        self.slots[slot_idx] = None
        self.pending.appendleft(slot.request)

    def _retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        assert slot is not None
        slot.request.done = True
        slot.request.finished_at = time.perf_counter()
        self.allocator.free(slot.blocks)
        self.finished.append(slot.request)
        self.slots[slot_idx] = None

    # -- compute -----------------------------------------------------------

    def _upload(self, values: Any, dtype: torch.dtype) -> torch.Tensor:
        """A small host array onto the engine's device. On a card it goes
        from pinned memory without blocking: a pageable copy would wait for
        every launch already queued, and undo the dispatch-ahead tick."""
        t = torch.tensor(values, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _whole_block_bucket(self, sp: int, room: int) -> int:
        """Prefill width: the power-of-two bucket of ``sp`` rounded up to
        whole blocks (write_prefill scatters whole blocks), clamped to
        ``room`` (block-aligned)."""
        B = self.pcfg.block_size
        bucket = min(_bucket(sp), room)
        return min(-(-bucket // B) * B, room)

    def _prefill(self, slot_idx: int, req: Request, fresh: list[int]) -> None:
        if req.admitted_at is None:
            # first admission only: a preemption recompute re-enters here
            req.admitted_at = time.perf_counter()
        # a preempted request resumes by prefilling prompt + its own output
        self._run_prefill_graph(slot_idx, req, req.prompt + req.output, fresh)

    def _run_prefill_graph(self, slot_idx: int, req: Request, effective: list[int],
                           fresh: list[int]) -> bool:
        """One-shot prefill; returns False when the padded bucket cannot be
        funded (the request is re-queued at the head)."""
        p = len(effective)
        bucket = self._whole_block_bucket(p, self.pcfg.capacity)
        n_blocks = bucket // self.pcfg.block_size
        while len(fresh) < n_blocks:
            more = self.allocator.alloc(1)
            if more is None:
                self.allocator.free(fresh)
                self.pending.appendleft(req)
                return False
            fresh.extend(more)
        t0 = time.perf_counter()
        logits = self._dispatch_prefill(effective + [0] * (bucket - p), fresh[:n_blocks], bucket)
        tok = self._sample_host(logits[0, p - 1])
        self.phase_seconds["prefill"] += time.perf_counter() - t0
        self.slots[slot_idx] = _SlotState(req, fresh, p + 1)
        self._record(slot_idx, req, tok)
        return True

    def _dispatch_prefill(self, tokens: list[int], target_blocks: list[int],
                          bucket: int) -> torch.Tensor:
        """The bucket-wide prefill into ``target_blocks``; returns the
        logits [1, bucket, V]."""
        self.pools, logits = _prefill_plain(
            self.params, self.pools, self._upload([tokens], torch.long),
            self._upload(target_blocks, torch.long), cfg=self.cfg, bucket=bucket)
        return logits

    def _decode_once(self) -> list[int]:
        return self._plain_decode_once()

    def _plain_decode_once(self) -> list[int]:
        # synchronous tick: dispatch, then harvest at once
        return self._commit_tick(self._dispatch_plain(None))

    def _dispatch_plain(self, prev: Optional[dict]) -> dict:
        """Dispatch one fused decode step. With ``prev`` (the previous
        tick, still in flight) the input tokens are its device outputs and
        seq_lens are advanced by the commit its harvest will apply."""
        t0 = time.perf_counter()
        pend_idx = self._pending_indices(prev)
        active_l, active = self._lane_arrays()
        seq_lens = self._upload(
            [(s.seq_len + (1 if i in pend_idx else 0)) if s else 1
             for i, s in enumerate(self.slots)], torch.int32)
        if prev is None:
            tokens = self._upload(self._last_tokens, torch.int32)
        else:
            # every active slot was in prev's snapshot (steady state admits
            # nothing); lanes of slots retired at harvest are masked
            # inactive and write only the scratch block
            tokens = prev["next"]
        tables = self._block_tables()
        self.pools, next_tokens = _decode_step(self.params, self.pools, tokens, seq_lens,
                                               active, tables, cfg=self.cfg, pcfg=self.pcfg)
        host, ready = next_tokens, None
        if next_tokens.device.type == "cuda":
            host = torch.empty(next_tokens.shape, dtype=next_tokens.dtype, pin_memory=True)
            host.copy_(next_tokens, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        snapshot = [(i, self.slots[i].request.rid)
                    for i in range(self.pcfg.max_slots) if active_l[i]]
        self.phase_seconds["decode_device"] += time.perf_counter() - t0
        self.phase_counts["device_steps"] += 1
        return {"next": next_tokens, "host": host, "ready": ready, "snapshot": snapshot}

    def _lane_arrays(self) -> tuple[list[bool], torch.Tensor]:
        """The [S] active mask, kept on the device between occupancy
        changes."""
        key = tuple(s.request.rid if s is not None else None for s in self.slots)
        if self._lane_key != key:
            active_l = [s is not None for s in self.slots]
            self._lane_cache = (active_l, self._upload(active_l, torch.bool))
            self._lane_key = key
        return self._lane_cache

    def _commit_tick(self, tick: Optional[dict]) -> list[int]:
        """Read one tick's tokens back and commit them; lanes whose slot
        churned since dispatch (retired or replaced) are discarded."""
        if tick is None:
            return []
        t0 = time.perf_counter()
        if tick["ready"] is not None:
            tick["ready"].synchronize()
        next_host = tick["host"].tolist()
        self.phase_seconds["host_sync"] += time.perf_counter() - t0
        self.phase_counts["host_syncs"] += 1
        done: list[int] = []
        for i, rid in tick["snapshot"]:
            slot = self.slots[i]
            if slot is None or slot.request.rid != rid:
                continue
            slot.seq_len += 1
            req = slot.request
            self._record(i, req, int(next_host[i]))
            if req.done:  # _record observed eos or the budget
                done.append(req.rid)
                self._retire(i)
        return done

    def _record(self, slot_idx: int, req: Request, tok: int) -> None:
        """Account one generated token (host side)."""
        self._last_tokens[slot_idx] = tok
        req.output.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        if (req.eos_token is not None and tok == req.eos_token) or (
                len(req.output) >= req.max_new_tokens):
            req.done = True

    @staticmethod
    def _sample_host(logits: torch.Tensor) -> int:
        """The next token from one row of logits (greedy)."""
        return int(torch.argmax(logits))

    def _block_tables(self) -> torch.Tensor:
        """[S, max_blocks_per_seq] int32, scratch-padded: the one static
        buffer, rewritten in place (from pinned memory) only on a
        structural change (admission, growth, retire)."""
        key = tuple(tuple(s.blocks) if s is not None else None for s in self.slots)
        if self._tables_key != key:
            t = np.full((self.pcfg.max_slots, self.pcfg.max_blocks_per_seq), SCRATCH_BLOCK,
                        np.int32)
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    t[i, :len(slot.blocks)] = slot.blocks
            self._tables.copy_(self._pinned(t), non_blocking=True)
            self._tables_key = key
        return self._tables

    def _pinned(self, values: Any) -> torch.Tensor:
        """A small int32 host array, in pinned memory when it goes to a card
        (its copy then does not block, and the caching host allocator keeps
        it until the copy has run)."""
        t = torch.as_tensor(np.asarray(values, np.int32))
        return t.pin_memory() if self.device.type == "cuda" else t

    # -- device-resident horizon -------------------------------------------

    def _decoding_slots(self) -> list[tuple[int, _SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def _fund_lookahead(self, slot: _SlotState, tokens_ahead: int) -> bool:
        """Grow the slot's table to cover ``tokens_ahead`` more commits
        without preemption; partial growth is kept (the blocks belong to
        the slot either way). With ``tokens_ahead`` at most the budget
        left, the per-sequence cap is out of reach (``submit`` bounds
        prompt + budget by the capacity), so False means the pool is
        exhausted: the caller takes the classic tick, the one place that
        preempts."""
        need = self.pcfg.blocks_for(slot.seq_len + tokens_ahead)
        if need > self.pcfg.max_blocks_per_seq:
            return False
        while len(slot.blocks) < need:
            got = self.allocator.alloc(1)
            if got is None:
                return False
            slot.blocks.extend(got)
        return True

    def _sync_device_state(self) -> None:
        """Reconcile the device lane state with the host scheduler: diff
        each lane against the mirror of what the device holds and patch
        only the lanes that changed. Catches every mutation path
        (admission, retire, preempt, growth, classic ticks between
        horizons) without invalidation hooks. A free lane keeps its last
        values, inactive."""
        for i, s in enumerate(self.slots):
            if s is not None:
                req = s.request
                want = {"last": int(self._last_tokens[i]), "seq": int(s.seq_len), "act": True,
                        "emitted": len(req.output), "budget": int(req.max_new_tokens),
                        "eos": -1 if req.eos_token is None else int(req.eos_token),
                        "table": tuple(s.blocks)}
            else:
                prev = self._dev_mirror[i]
                want = dict(prev) if prev is not None else {
                    "last": 0, "seq": 1, "act": False, "emitted": 0, "budget": 0, "eos": -1,
                    "table": ()}
                want["act"] = False
            if want != self._dev_mirror[i]:
                self._patch_lane(i, want)
                self._dev_mirror[i] = want

    def _patch_lane(self, i: int, lane: dict) -> None:
        """Write lane ``i`` of the device state in place: one copy of its
        row from pinned memory, on the stream the horizon replays on."""
        row = np.full(self._dev.shape[1], SCRATCH_BLOCK, np.int32)
        row[:LANE_TABLE] = [int(lane[name]) for name in LANE_FIELDS]
        row[LANE_TABLE:LANE_TABLE + len(lane["table"])] = lane["table"]
        self._dev[i].copy_(self._pinned(row), non_blocking=True)

    def _mirror_from_device(self, last_h, seq_h, act_h, em_h) -> None:
        """After a horizon the device's lane values are authoritative: copy
        them into the mirror, so the next sync patches only what the host
        scheduler really changed."""
        for i in range(self.pcfg.max_slots):
            m = self._dev_mirror[i]
            m["last"], m["seq"] = int(last_h[i]), int(seq_h[i])
            m["act"], m["emitted"] = bool(act_h[i]), int(em_h[i])

    def _horizon_step(self, horizon: int) -> tuple[GraphedStep, torch.Tensor]:
        """The graphed horizon of this length and its pinned host buffer,
        made on first use."""
        hz = self._hz.get(horizon)
        if hz is None:
            out = torch.empty((horizon + LANE_BUDGET, self.pcfg.max_slots),
                              dtype=torch.int32, device=self.device)
            fn = functools.partial(_horizon_plain, self.params, self.pools, cfg=self.cfg,
                                   pcfg=self.pcfg, H=horizon)
            host = out if self.device.type == "cpu" else torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True)
            hz = self._hz[horizon] = (GraphedStep(fn, self._dev, out), host)
        return hz

    def _plain_horizon_decode(self, horizon: int) -> Optional[list[int]]:
        """Fund every decoding lane ``horizon`` tokens ahead (at most its
        budget left), sync the lane state, run one horizon and commit its
        tokens. None when the funding fails: the caller falls back to the
        classic tick. Always the full horizon: a lane that ends early is
        deactivated on the device and its later steps are no-ops."""
        acts = self._decoding_slots()
        for _, s in acts:
            rem = s.request.max_new_tokens - len(s.request.output)
            if not self._fund_lookahead(s, min(horizon, rem)):
                return None
        self._sync_device_state()
        step, host = self._horizon_step(horizon)
        t0 = time.perf_counter()
        out = step()
        ready = None
        if host is not out:
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        self.phase_seconds["decode_device"] += time.perf_counter() - t0
        self.phase_counts["horizons"] += 1
        self.phase_counts["device_steps"] += horizon
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        got = host.numpy()
        toks_h, (last_h, seq_h, act_h, em_h) = got[:horizon], got[horizon:]
        self.phase_seconds["host_sync"] += time.perf_counter() - t0
        self.phase_counts["host_syncs"] += 1
        done: list[int] = []
        for i, s in acts:
            req = s.request
            for t in range(int(em_h[i]) - self._dev_mirror[i]["emitted"]):
                s.seq_len += 1
                self._record(i, req, int(toks_h[t][i]))
                if req.done:
                    break
            if req.done:
                done.append(req.rid)
                self._retire(i)
        self._mirror_from_device(last_h, seq_h, act_h, em_h)
        return done


# ---------------------------------------------------------------------------
# device work
# ---------------------------------------------------------------------------


@torch.no_grad()
def _prefill_plain(params: dict[str, Any], pools: dict[str, torch.Tensor],
                   tokens: torch.Tensor, block_ids: torch.Tensor, *,
                   cfg: LlamaConfig, bucket: int):
    """Full-prompt prefill: a fresh contiguous cache of exactly bucket
    capacity, the model forward, then its K/V scattered into the blocks.
    Returns ``(pools, logits [1, bucket, V])``."""
    cache = init_cache(cfg, 1, bucket, device=tokens.device)
    positions = torch.arange(bucket, device=tokens.device)[None, :]
    logits, cache = forward(params, tokens, cfg, cache=cache, positions=positions)
    k = torch.stack([c["k"][0] for c in cache])
    v = torch.stack([c["v"][0] for c in cache])
    return write_prefill(pools, k, v, block_ids), logits


@torch.no_grad()
def _decode_step(params: dict[str, Any], pools: dict[str, torch.Tensor],
                 tokens: torch.Tensor, seq_lens: torch.Tensor, active: torch.Tensor,
                 block_tables: torch.Tensor, *, cfg: LlamaConfig, pcfg: PagedConfig):
    """One fused greedy token step for every slot: the incoming token sits
    at position ``seq_len - 1``; its K/V is written into the pools before
    the layer's attention reads them. Returns ``(pools, next tokens [S]
    int32)``, all on the device."""
    S = tokens.shape[0]
    freqs = _freqs_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling,
                         tokens.device)
    positions = seq_lens.long() - 1
    x = params["embed"]["weight"][tokens.long()].to(cfg.dtype)[:, None, :]

    # masked write target: inactive slots scribble on the scratch block
    block_idx = (positions // pcfg.block_size).clamp(0, block_tables.shape[1] - 1)
    row = block_tables.long().gather(1, block_idx[:, None])[:, 0]
    write_block = torch.where(active, row, SCRATCH_BLOCK)
    write_off = torch.where(active, positions % pcfg.block_size, 0)

    delta = None  # the pending residual delta, added by the next norm
    for layer_i, layer in enumerate(params["layers"]):
        x, q, k, v = _qkv(layer, x, delta, freqs, cfg, positions[:, None])
        pools = _write_layer(pools, layer_i, k, v, write_block, write_off)
        out = _paged_attention(q, pools, block_tables, seq_lens, layer_i, cfg)
        delta = _mm(out.reshape(S, 1, cfg.dim), layer["attn"]["wo"])
        x, delta = _mlp_block(layer, x, delta, cfg)

    logits = _logits(params, x, delta, cfg)[:, 0]  # [S, V]
    return pools, logits.argmax(dim=-1).to(torch.int32)


@torch.no_grad()
def _horizon_plain(params: dict[str, Any], pools: dict[str, torch.Tensor], lanes: torch.Tensor,
                   out: torch.Tensor, *, cfg: LlamaConfig, pcfg: PagedConfig, H: int
                   ) -> torch.Tensor:
    """H fused greedy steps over the device lane state, no host read: each
    step is :func:`_decode_step` over every slot, then JAX's liveness
    (``bobrapet_tpu/serving/engine.py:_horizon_plain``): a lane that hits
    its eos or its budget is deactivated, and from then on writes only the
    scratch block and emits -1.

    ``lanes`` [S, LANE_TABLE + MB] int32 (columns ``LANE_*``); writes into
    ``out`` [H + 4, S] int32 the tokens of every step, then last, seq, act
    and emitted after the horizon, and writes those four back into
    ``lanes``. Pools are written in place. Returns ``out``."""
    last = lanes[:, LANE_LAST]
    seq = lanes[:, LANE_SEQ].contiguous()
    act = lanes[:, LANE_ACT] != 0
    emitted = lanes[:, LANE_EMITTED]
    budget, eos = lanes[:, LANE_BUDGET], lanes[:, LANE_EOS]
    tables = lanes[:, LANE_TABLE:].contiguous()
    for t in range(H):
        pools, tok = _decode_step(params, pools, last, seq, act, tables, cfg=cfg, pcfg=pcfg)
        live = act.to(torch.int32)
        emitted = emitted + live
        seq = seq + live
        done = ((eos >= 0) & (tok == eos)) | (emitted >= budget)
        out[t] = torch.where(act, tok, -1)
        last = torch.where(act, tok, last)
        act = act & ~done
    for row, value in enumerate((last, seq, act.to(torch.int32), emitted)):
        out[H + row] = value
    lanes[:, :LANE_BUDGET] = out[H:].T
    return out


def _write_layer(pools: dict[str, torch.Tensor], layer_i: int, k: torch.Tensor,
                 v: torch.Tensor, write_block: torch.Tensor,
                 write_off: torch.Tensor) -> dict[str, torch.Tensor]:
    """Write one layer's new token K/V [S, 1, H, D] into pool[layer], in
    place; masked lanes land in the scratch block."""
    pools["k"][layer_i, write_block, write_off] = k[:, 0].to(pools["k"].dtype)
    pools["v"][layer_i, write_block, write_off] = v[:, 0].to(pools["v"].dtype)
    return pools


def _paged_attention(q: torch.Tensor, pools: dict[str, torch.Tensor],
                     block_tables: torch.Tensor, seq_lens: torch.Tensor, layer_i: int,
                     cfg: LlamaConfig) -> torch.Tensor:
    """Decode attention over the paged cache of layer ``layer_i``, read in
    place (a view of the pools, no copy): q [S, 1, Hq, D] -> [S, 1, Hq, D]."""
    out = paged_attention(q[:, 0], pools["k"][layer_i], pools["v"][layer_i],
                          block_tables, seq_lens)
    return out[:, None]
