"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``bobrapet_tpu/serving/engine.py``: the classic single-step
engine, the fused decode horizon and its depth-N dispatch pipeline, greedy
and sampled decoding, with prefix caching, chunked prefill, multi-LoRA and
speculative decoding. Requests stream through a fixed set of slots: a
request is admitted the moment a slot and enough KV blocks are free,
decodes fused with every other live request, and leaves the instant it
finishes.

- One decode step for every slot: liveness is a mask, never a shape;
  inactive slots compute garbage that lands in the scratch block.
- Prefill runs per length bucket (next power of two, whole blocks).
- Prefix caching (``PagedConfig.prefix_caching``): full prompt blocks are
  content-addressed (:class:`~.prefix_cache.PrefixCache`); an admission
  takes the matched blocks into its table and prefills only the rest,
  against a contiguous cache seeded with the prefix's KV
  (:func:`_prefill_bucket`: one flash launch a layer at ``q_offset`` = the
  prefix length).
- Chunked prefill (``PagedConfig.prefill_chunk``): an uncached suffix
  longer than a chunk secures its whole table at admission, then ingests
  one chunk per engine tick, each chunk a seeded prefill over the chunks
  before it, so the live slots keep decoding meanwhile.
- Multi-LoRA (``loras``, a stacked adapter tree, index 0 the zero
  adapter): a prefill takes its request's adapter; every decode step
  gathers each slot's adapter by an index on the device, so one step (one
  graph) serves any adapter mix.
- Sampling (``submit(temperature=T)``): every token the engine commits is
  picked by :func:`~bobrapet_tpu_torch.ops.pick_tokens`, the argmax at
  T = 0 and a Gumbel-max draw keyed by (rid, token index) at T > 0, so a
  sampled stream is a pure function of the request: the same across slots,
  co-tenants, preemption, horizons, dispatch depth and speculation.
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
- ``decode_horizon`` H > 1: H steps per engine tick with the lane state
  (last token, length, liveness, emitted count, budget, eos, adapter,
  temperature, rid, block table) resident on the device; eos and budgets
  deactivate lanes there, a dead lane writes the scratch block and emits
  -1. Each lane's table is funded H tokens ahead first (without
  preemption: when that fails the classic tick runs, which may preempt).
  Only the lanes the host changed are patched before a horizon, and one
  copy brings back the tokens ``[H, S]`` and the lane state after it. On a
  card the horizon is one CUDA graph per H
  (:class:`~bobrapet_tpu_torch.graphs.GraphedStep`), replayed once per
  tick: the JAX engine's ``lax.scan``.
- ``dispatch_depth`` N > 1 (with H > 1): up to N horizons in flight. A
  tick commits the oldest horizon, admits, ingests chunks and retires
  while the others replay, then tops the queue up; new and retired lanes
  are patched into the next horizon (stream order keeps every patch
  behind the replays already queued). Each horizon's output, rewritten by
  the next replay of its graph, is copied right after its own replay into
  a pinned buffer of its own behind an event; a commit folds a lane's
  device state into the host mirror only while the lane's patch epoch is
  the one the horizon was dispatched with. Funding that needs preemption
  drains the queue to the classic tick.
- Speculative decoding (``draft_params``, ``draft_cfg``, ``spec_k``;
  :mod:`.spec_decode`): a draft model over its own pools (every prefill is
  mirrored into them) proposes ``spec_k`` tokens a greedy slot, one
  ``k + 1``-token target step verifies them, and the greedy-exact accept
  prefix is committed; a sampled slot commits one token a round from the
  position-0 logits. The classic tick speculates once per tick; a horizon
  runs ``ceil(H / (k + 1))`` draft + verify rounds with the lane state on
  the device, one CUDA graph each for draft and verify per ``(k,
  rounds)``, and the host reads the commits once a horizon. A plain tick
  or horizon on a draft engine catches the draft pools up. The payoff
  guard first alternates speculative and plain decoding, measuring tokens
  per second each way, and keeps the draft only if it pays
  (``spec_guard``).

- Disaggregated serving (``role``): a ``"prefill"`` engine retires every
  request at its first sampled token (``prefilled``), its prompt blocks
  exported through the shared prefix registry (``prefix_shared``,
  :class:`~.prefix_cache.SharedPrefixRegistry`); a ``"decode"`` engine
  adopts them at admission with one copy a pool (:meth:`_import_blocks`)
  and continues from the first token (``submit(rid=, output=)``, which
  :class:`~.router.ServingRouter` calls). A block-aligned prompt then needs
  no prefill forward at all on the decode side. ``"decode"`` and
  ``"unified"`` run the same loop; the role is a routing statement.
- Tenant weights (:meth:`set_tenant_weights`): the pending queue becomes
  :class:`~bobrapet_tpu_torch.traffic.fairness.WeightedFairQueue`.

On a card every norm (each but the first fused with the residual add
before it), the prefill attention, the decode attention (one query a slot,
or T: a verify, a draft catch-up), every int8 product and every token pick
launch the port's kernels; on the CPU their plain versions run.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import time
from collections import deque
from statistics import median
from typing import Any, Optional

import numpy as np
import torch

from ..graphs import GraphedStep
from ..models.llama import (
    LlamaConfig,
    _freqs_table,
    _logits,
    _lora_mm,
    _mlp_block,
    _qkv,
    forward,
    init_cache,
)
from ..models.lora import select_adapter
from ..models.moe import moe_mlp_block, routed_forward
from ..models.quant import is_quantized
from ..ops.paged_attention import paged_attention
from ..ops.pick_tokens import pick_tokens
from ..tree import flatten_with_path
from .paged_cache import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PagedConfig,
    init_cache_seed,
    init_pools,
    write_prefill,
)
from .prefix_cache import GLOBAL_SHARED_PREFIXES, PrefixCache, SharedPrefixRegistry
from .spec_decode import (
    _draft_append,
    _draft_sync_block,
    _spec_accept,
    _spec_draft,
    _spec_step,
    _spec_verify,
)

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    """The JAX engine's request, field for field and in its order. The port
    serves it at any ``temperature`` (0: greedy) under any adapter of the
    engine's stack; ``tenant`` is carried for a router, and ``trace``
    waits for the observability slice."""

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
    #: chunked prefill in progress: tokens of the effective prompt already
    #: ingested (block-aligned); None once decoding
    ingest_pos: Optional[int] = None
    #: prefix-cache hit at admission (its stats are recorded at the end
    #: of the prefill)
    shared_tokens: int = 0


#: columns of the device lane state [S, LANE_TABLE + max_blocks_per_seq]
#: int32: the four the horizon advances, then budget, eos, the LoRA
#: adapter, the temperature (its fp32 bits), the rid, the block table
(LANE_LAST, LANE_SEQ, LANE_ACT, LANE_EMITTED, LANE_BUDGET, LANE_EOS, LANE_ADAPTER, LANE_TEMP,
 LANE_RID, LANE_TABLE) = range(10)
LANE_FIELDS = ("last", "seq", "act", "emitted", "budget", "eos", "adapter", "temp", "rid")
#: a free lane's values (inactive; its table all scratch)
_FREE_LANE = {"last": 0, "seq": 1, "act": False, "emitted": 0, "budget": 0, "eos": -1,
              "adapter": 0, "temp": 0.0, "rid": 0, "table": ()}
#: a pipelined dispatch found a lane's lookahead unfundable without
#: preemption: the pipeline drains to the classic tick, the one place that
#: preempts
_UNFUNDABLE = object()


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _leaves(tree: Any) -> list[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _weights_device(tree: Any) -> torch.device:
    """The one device every tensor of ``tree`` lives on; raises otherwise."""
    devices = {leaf.device for leaf in _leaves(tree) if isinstance(leaf, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(
            f"the weights must all live on one device, found {sorted(map(str, devices))}")
    return devices.pop()


def _f32_bits(value: float) -> int:
    """The int32 whose bits are ``value`` as fp32 (a temperature in the
    int32 lane state)."""
    return int(np.float32(value).view(np.int32))


def _is_moe(cfg: Any) -> bool:
    return getattr(cfg, "n_experts", None) is not None


class ServingEngine:
    """See the module docstring. The params tree (and a draft's) may be
    int8 (``models.quant``); the pools live on the device of the weights."""

    ROLES = frozenset({"unified", "prefill", "decode"})

    def __init__(self, params: Any, cfg: LlamaConfig,
                 pcfg: Optional[PagedConfig] = None,
                 loras: Optional[Any] = None, lora_scale: float = 1.0,
                 draft_params: Optional[Any] = None,
                 draft_cfg: Optional[LlamaConfig] = None,
                 spec_k: int = 4,
                 spec_guard: bool = True,
                 spec_guard_ticks: int = 6,
                 spec_guard_margin: float = 0.05,
                 pipeline_decode: bool = True,
                 decode_horizon: int = 8,
                 dispatch_depth: int = 2,
                 prefix_shared: Any = False,
                 role: str = "unified"):
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if dispatch_depth < 1:
            raise ValueError("dispatch_depth must be >= 1")
        pcfg = pcfg or PagedConfig()
        if draft_params is not None:
            # the JAX engine's checks, in its order
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if _is_moe(cfg):
                raise ValueError(
                    "speculative serving is dense-target only (the MoE fused step routes "
                    "slots, not slot x position grids)")
            if _is_moe(draft_cfg):
                raise ValueError("the draft model must be dense")
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft_cfg.max_seq_len < cfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} < target {cfg.max_seq_len}: "
                    "the draft must cover every position the target can reach")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft_cfg.vocab_size} != target {cfg.vocab_size}: "
                    "draft and target must share the tokenizer")
        #: sparse-MoE family (MoEConfig): the decode step swaps the dense
        #: MLP for the routed block; attention, paging, scheduling are the
        #: same. JAX's checks, in its order, with its messages.
        self.is_moe = _is_moe(cfg)
        if self.is_moe:
            if loras is not None:
                raise ValueError("multi-LoRA serving is dense-family only")
            if cfg.capacity_factor < cfg.n_experts:
                # every slot is routed as one token batch: under a droppy
                # capacity, co-scheduled requests (and inactive slots) would
                # displace each other's experts, and outputs would vary with
                # co-tenancy
                raise ValueError(
                    f"MoE serving requires a no-drop capacity_factor "
                    f">= n_experts ({cfg.n_experts}); got "
                    f"{cfg.capacity_factor}. Use dataclasses.replace "
                    f"(moe_config_from_hf defaults to no-drop).")
            router = params["layers"][0]["moe"]["w_router"]
            if is_quantized(router) or isinstance(router, dict):
                raise ValueError(
                    "int8 weight-only quantization is dense-family "
                    "only (the MoE dispatch einsums do not consume "
                    "quantized leaves)")
        self.params = params
        self.cfg = cfg
        self.pcfg = pcfg
        #: multi-LoRA: a stacked adapter tree (``models.lora.stack_adapters``;
        #: index 0 must be the zero adapter)
        self.loras = loras
        self.lora_scale = lora_scale
        if loras is not None:
            leaves = _leaves(loras)
            counts = {leaf.shape[0] for leaf in leaves}
            if any(leaf.dim() != 3 for leaf in leaves) or len(counts) != 1:
                raise ValueError(
                    "loras must be a stacked adapter tree (models.lora.stack_adapters: "
                    "every leaf [n_adapters, in, r] / [n_adapters, r, out]); got leaf "
                    f"shapes {[tuple(leaf.shape) for leaf in leaves[:3]]}")
            self.n_adapters = counts.pop()
        else:
            self.n_adapters = 1
        #: one adapter's tree per index, selected out of the stack once
        self._adapter_cache: dict[int, Any] = {}
        self.pipeline_decode = pipeline_decode
        #: decode steps per horizon; 1 = the classic single-step engine
        self.decode_horizon = int(decode_horizon)
        #: horizons kept in flight on the card (with H > 1): while one
        #: replays, the host commits the one before, admits and enqueues the
        #: next; 1 = dispatch, then commit, nothing overlapped
        self.dispatch_depth = int(dispatch_depth)
        #: dispatched but uncommitted horizons, oldest first: commit order
        #: is dispatch order
        self._inflight: deque[dict] = deque()
        #: per lane: bumped by every patch that rewrites the lane's scalar
        #: state, so that a commit folds the device values of a horizon into
        #: the mirror only while the lane is the one it was dispatched with
        self._patch_epoch = [0] * pcfg.max_slots
        #: when the decode pipeline last went empty with work left (the next
        #: horizon dispatch books the gap into ``host_gap``)
        self._dev_idle_at: Optional[float] = None
        #: the previous pipelined speculative commit (the watchdog's window
        #: runs commit to commit)
        self._watch_commit_t: Optional[float] = None
        self.device = _weights_device(params)
        if loras is not None and _weights_device(loras) != self.device:
            raise ValueError(f"the adapters must live with the weights on {self.device}")
        self.pools = init_pools(cfg, pcfg, self.device)
        # speculative decoding (spec_decode.py): a dense draft over its own
        # pools proposes spec_k tokens a slot; one fused verify commits the
        # greedy-exact accept prefix
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = int(spec_k)
        self.spec_drafted = 0
        self.spec_accepted = 0
        #: the payoff guard: the first decode ticks (or horizons) alternate
        #: speculative and plain decoding, measuring realized tokens/s each
        #: way; then speculation stays on only if it beats plain by the
        #: margin. One-shot, recorded in ``spec_guard_decision``.
        self.spec_guard = spec_guard
        self.spec_guard_ticks = spec_guard_ticks
        self.spec_guard_margin = spec_guard_margin
        self.spec_active = draft_params is not None
        self.spec_guard_decision: Optional[dict] = None
        self._guard_samples: dict[str, list[float]] = {"spec": [], "plain": []}
        self._tokens_emitted = 0
        #: post-guard watchdog window: [tokens, seconds] of realized
        #: spec-horizon throughput (see _watched_spec_horizon)
        self._spec_watch: list = [0, 0.0]
        if draft_params is not None:
            if _weights_device(draft_params) != self.device:
                raise ValueError(f"the draft's weights must live with the target's on "
                                 f"{self.device}")
            self.dpools = init_pools(draft_cfg, pcfg, self.device)
        self.allocator = BlockAllocator(pcfg.num_blocks)
        # every block goes through the prefix cache, so a freed block that
        # is still registered is invalidated when it is handed out again
        self.blocks = PrefixCache(self.allocator, pcfg.block_size)
        #: a draining engine refuses new submissions but serves its queue
        self.draining = False
        #: a FIFO until set_tenant_weights installs the weighted-fair queue
        self.pending: Any = deque()
        self._tenant_weights: Optional[dict[str, float]] = None
        #: tenant labels admitted so far (bounded: MAX_TENANT_LABELS)
        self._tenant_labels: set[str] = set()
        self._sharing_scope_cache: Optional[str] = None
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
        #: [S, LANE_TABLE + MB] (last, seq, act, emitted, budget, eos,
        #: adapter, temperature bits, rid, then the block table): patched
        #: lane by lane, advanced in place
        self._dev = torch.zeros((S, LANE_TABLE + MB), dtype=torch.int32, device=self.device)
        #: what the device holds per lane, as the host last wrote or read it
        self._dev_mirror: list[Optional[dict]] = [None] * S
        #: per horizon length: the graphed horizon (its output [H + 4, S])
        #: and the free host buffers its outputs are read back through, one
        #: taken by each horizon in flight
        self._hz: dict[int, tuple[GraphedStep, list[torch.Tensor]]] = {}
        #: the speculative horizon per (k, rounds): its graphed draft and
        #: verify rounds, their output [rounds + 1, S + 1, max(k + 2, 4)]
        #: and its free host buffers; the draft catch-up per H
        self._hz_spec: dict[tuple[int, int], tuple] = {}
        self._hz_sync: dict[int, GraphedStep] = {}
        #: a horizon's funded lookahead per lane, the round index of the
        #: verify graph, and the lane state before a plain horizon (the
        #: draft catch-up reads it)
        self._cov = torch.zeros((S,), dtype=torch.int32, device=self.device)
        self._round = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._pre = torch.zeros((S, LANE_BUDGET), dtype=torch.int32, device=self.device)
        #: host seconds per phase: ``prefill`` (issuing every prefill and
        #: chunk, the draft's mirror included, and reading back a prefill's
        #: first token), ``decode_device`` (issuing decode ticks and
        #: horizons: every launch or replay is enqueued here), ``host_sync``
        #: (waiting for their tokens), ``draft`` and ``verify`` (issuing the
        #: speculative horizon's draft and verify rounds, and the draft's
        #: catch-up after a plain horizon); in the pipeline
        #: ``decode_device`` is the wait for a horizon at its commit,
        #: ``host_overlap`` the host's work while a horizon was in flight and
        #: ``host_gap`` the time the decode pipeline sat empty with work left
        #: (JAX's names)
        self.phase_seconds = {"prefill": 0.0, "decode_device": 0.0, "host_sync": 0.0,
                              "draft": 0.0, "verify": 0.0, "host_gap": 0.0,
                              "host_overlap": 0.0}
        #: ``device_steps`` counts the target's one-token decode steps
        #: dispatched (H per plain horizon), ``horizons`` the horizons (plain
        #: and speculative), ``prefills`` the prefill dispatches (one-shot or
        #: chunk), ``chunks`` those that were chunks, ``spec_rounds`` the
        #: draft + verify rounds of speculative horizons (JAX's names); the
        #: port also counts ``spec_ticks`` (classic speculative ticks),
        #: ``draft_prefills`` (the draft's mirror of a prefill),
        #: ``draft_syncs`` (T = H catch-ups after a plain horizon),
        #: ``draft_appends`` (T = 1 catch-ups before a plain tick) and
        #: ``prefill_picks`` (first tokens picked at the end of a prefill)
        self.phase_counts = {"host_syncs": 0, "horizons": 0, "device_steps": 0,
                             "prefills": 0, "chunks": 0, "spec_rounds": 0, "spec_ticks": 0,
                             "draft_prefills": 0, "draft_syncs": 0, "draft_appends": 0,
                             "prefill_picks": 0}
        # identity, not truth: an empty registry is falsy
        if prefix_shared is not False and prefix_shared is not None:
            self.set_prefix_sharing(prefix_shared)
        #: disaggregated serving role: "prefill" retires every request at
        #: its first sampled token (the exported prompt blocks and that
        #: token are its product); "decode" and "unified" decode to the end
        #: ("decode" is a routing statement, not another loop)
        self.set_role(role)

    # -- public API --------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int,
               temperature: float = 0.0, eos_token: Optional[int] = None,
               adapter: Optional[int] = None, tenant: str = "",
               rid: Optional[int] = None,
               output: Optional[list[int]] = None) -> int:
        """Queue a request under LoRA ``adapter`` (None or 0: the base
        model), greedy at ``temperature`` 0, else sampled at it; returns its
        rid. ``rid`` and ``output`` are the KV-handoff continuation (the
        router's): a pinned rid keeps a sampled stream the same across
        engines (the pick is keyed by (rid, token index)), and ``output``
        preseeds the tokens already generated, so admission adopts the
        exported prompt blocks and prefills only the rest.
        ``max_new_tokens`` stays the whole budget, the preseed included."""
        preseed = list(output or [])
        if self.draining:
            raise ValueError(
                "engine is draining (scale-down or role change in progress): "
                "submit to another replica")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill always "
                             "samples one token)")
        if preseed and max_new_tokens <= len(preseed):
            raise ValueError(
                f"max_new_tokens ({max_new_tokens}) must exceed the preseeded output "
                f"({len(preseed)} tokens) — nothing would be left to decode")
        if not prompt:
            raise ValueError("prompt must hold at least one token")
        if len(prompt) + max_new_tokens > self.pcfg.capacity:
            raise ValueError(
                f"prompt+new ({len(prompt)}+{max_new_tokens}) exceeds slot "
                f"capacity {self.pcfg.capacity}")
        if adapter is not None and not (0 <= adapter < self.n_adapters):
            raise ValueError(
                f"adapter {adapter} out of range (engine has {self.n_adapters} incl. the base "
                "at 0)")
        if rid is None:
            rid = self._next_rid
        elif rid < 0:
            raise ValueError("rid must be >= 0")
        self._next_rid = max(self._next_rid, rid + 1)
        self.pending.append(Request(rid, list(prompt), max_new_tokens, temperature, eos_token,
                                    adapter=adapter or 0, tenant=self._bound_tenant(tenant),
                                    output=preseed, preseeded=len(preseed),
                                    submitted_at=time.perf_counter(),
                                    submitted_wall=time.time()))
        return rid

    #: distinct tenant labels one engine will ever mint
    MAX_TENANT_LABELS = 64

    def _bound_tenant(self, tenant: Any) -> str:
        """The wire tenant in a bounded label vocabulary: past
        MAX_TENANT_LABELS distinct values every new one is "other"."""
        t = str(tenant or "")[:64]
        if t in self._tenant_labels:
            return t
        if len(self._tenant_labels) < self.MAX_TENANT_LABELS:
            self._tenant_labels.add(t)
            return t
        return "other"

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive until every submitted request finishes; returns them in
        completion order."""
        steps = 0
        while (self.pending or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        # a pipelined tick or horizons may still be in flight at loop exit
        self._commit_tick(self._pending_tick)
        self._pending_tick = None
        self._drain_inflight()
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

    def set_tenant_weights(self, weights: Optional[dict[str, float]]) -> None:
        """Live: swap the pending queue between FIFO and the weighted
        start-time fair queue. Queued requests move over in arrival order:
        a reload reorders later service and loses nothing."""
        weights = dict(weights) if weights else None
        if weights == self._tenant_weights:
            return
        self._tenant_weights = weights
        if weights:
            from ..traffic.fairness import WeightedFairQueue

            fresh: Any = WeightedFairQueue(weights)
        else:
            fresh = deque()
        fresh.extend(self.pending)
        self.pending = fresh

    def set_role(self, role: str) -> None:
        """Live: takes effect at the next sampled token. A demotion from
        prefill lets every request whose first token lands after it decode
        here to its end; a promotion to prefill retires each decoding
        request at its next committed token with the output it has (a
        handoff continuation preseeds it downstream)."""
        if role not in self.ROLES:
            raise ValueError(f"role must be one of {sorted(self.ROLES)}, got {role!r}")
        if role == "prefill" and not self.pcfg.prefix_caching:
            raise ValueError(
                "prefill role requires prefix_caching=True — the KV handoff to the decode "
                "pool rides the prefix cache's block registration/export")
        if role == "prefill" and self.blocks.shared is None:
            _log.warning("prefill-role engine has NO shared prefix registry: nothing will be "
                         "exported for the decode pool to adopt")
        self.role = role

    def set_prefix_sharing(self, enabled: Any) -> None:
        """Live: cross-engine prefix sharing through a
        :class:`~.prefix_cache.SharedPrefixRegistry` (``True``: the
        process's global one) or none (``False``/``None``). Only engines
        with the same weights fingerprint (params, LoRA stack, live draft)
        ever share a block; the adapter salt stays in the chain."""
        if enabled is False or enabled is None:
            self.blocks.disable_sharing()
            return
        if not self.pcfg.prefix_caching:
            raise ValueError("prefix sharing requires prefix_caching=True")
        reg = enabled if isinstance(enabled, SharedPrefixRegistry) else GLOBAL_SHARED_PREFIXES
        self.blocks.enable_sharing(reg, self._sharing_scope(), self._export_block,
                                   self._import_block, import_many_cb=self._import_blocks)

    def _sharing_scope(self) -> str:
        """The weights fingerprint that namespaces shared blocks: blake2b
        over the config's repr and, per leaf of the params, the LoRA stack
        and the live draft (with its config), the shape, dtype, a strided
        fp32 sample of 16 values and the fp32 sum. Computed once (one copy
        to the host); a guard-retired draft is left out, so the engine then
        shares with draft-less engines (:meth:`_retire_draft_scope`)."""
        if self._sharing_scope_cache is None:
            trees = [(b"params", self.params)]
            if self.loras is not None:
                trees.append((b"loras", self.loras))
            if self.draft_params is not None and self.spec_active:
                trees.append((b"draft", self.draft_params))
            stats = []
            for _tag, tree in trees:
                for _path, leaf in flatten_with_path(tree):
                    flat = leaf.reshape(-1)
                    stride = max(1, flat.shape[0] // 16)
                    stats.append(torch.cat([flat[::stride][:16].float(),
                                            flat.sum(dtype=torch.float32).reshape(1)]))
            values = iter(torch.cat(stats).cpu().split([len(x) for x in stats]))
            h = hashlib.blake2b(digest_size=16)
            h.update(repr(self.cfg).encode())
            for tag, tree in trees:
                if tag == b"draft":
                    h.update(repr(self.draft_cfg).encode())
                h.update(tag)
                for _path, leaf in flatten_with_path(tree):
                    h.update(str(tuple(leaf.shape)).encode())
                    h.update(str(leaf.dtype).encode())
                    h.update(next(values).numpy().tobytes())
            self._sharing_scope_cache = h.hexdigest()
        return self._sharing_scope_cache

    def _export_block(self, blk: int) -> dict[str, torch.Tensor]:
        """The shared registry's payload of one full prompt block: its K/V
        across every layer (and the draft's), copied out of the pools: an
        index of the pool is a view, and the next write to the block would
        change a registry entry."""
        payload = {"k": self.pools["k"][:, blk].clone(), "v": self.pools["v"][:, blk].clone()}
        if self.draft_params is not None and self.spec_active:
            payload["dk"] = self.dpools["k"][:, blk].clone()
            payload["dv"] = self.dpools["v"][:, blk].clone()
        return payload

    def _import_block(self, blk: int, payload: dict) -> bool:
        """Adopt another engine's exported block into this engine's pools (a
        copy instead of a prefill forward). A speculative engine refuses a
        payload without draft K/V: adopting a hole would collapse its
        accept rate."""
        return self._import_blocks([blk], [payload])

    def _import_blocks(self, blks: list[int], payloads: list[dict]) -> bool:
        """Adopt a run of exported blocks (a handoff's whole prompt chain):
        one ``index_copy_`` along the block dimension a pool, on the current
        stream, which the horizons replay on, so it lands before the next
        dispatch. Same refusal of draft-less payloads as
        :meth:`_import_block`."""
        needs_draft = self.draft_params is not None and self.spec_active
        if needs_draft and any("dk" not in p for p in payloads):
            return False
        ids = self._upload(blks, torch.long)
        pairs = [(self.pools, "k", "v")] + ([(self.dpools, "dk", "dv")] if needs_draft else [])
        for pools, kn, vn in pairs:
            for name, key in (("k", kn), ("v", vn)):
                parts = [p[key] for p in payloads]
                if self.device.type == "cuda" and any(t.device.type == "cpu" for t in parts):
                    # a run mixing registry entries in device memory with
                    # ones read back from the disk tier: all on the host,
                    # so one pinned upload below carries the run
                    parts = [t.cpu() for t in parts]
                # payloads [L, B, Hkv, D] -> [L, n, B, Hkv, D]
                run = torch.stack(parts, dim=1)
                if run.device != self.device:
                    run = run.pin_memory().to(self.device, non_blocking=True)
                pools[name].index_copy_(1, ids, run.to(pools[name].dtype))
        return True

    def set_dispatch_depth(self, depth: int) -> None:
        """Live: a smaller depth commits the pipeline down to it at the next
        tick, a larger one fills at the next dispatch. Every record carries
        its own bookkeeping and commits are in dispatch order, so the
        streams are the same at every depth."""
        if depth < 1:
            raise ValueError("dispatch_depth must be >= 1")
        self.dispatch_depth = int(depth)

    def set_decode_horizon(self, horizon: int) -> None:
        """Live: takes effect at the next tick. One graph is kept per
        horizon length, so flipping back and forth captures each once. A
        new horizon re-arms the payoff guard (its measurement shape)."""
        if horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        changed = int(horizon) != self.decode_horizon
        self.decode_horizon = int(horizon)
        if changed:
            self._rearm_spec_guard()

    def set_spec_k(self, k: int) -> None:
        """Live, on a draft engine: the next tick speculates ``k`` tokens (the
        graphs are kept per k, so a k seen before is not captured again) and
        the payoff guard re-arms; on an engine without a draft it only
        records k."""
        if k < 1:
            raise ValueError("spec_k must be >= 1")
        if self.draft_params is None or k == self.spec_k:
            self.spec_k = int(k)
            return
        self.spec_k = int(k)
        self._rearm_spec_guard()

    def _rearm_spec_guard(self) -> None:
        """The horizon and spec_k are the payoff guard's measurement shape:
        after either changes, a decision (and half-collected samples) says
        nothing about the new shape, so the guard starts again and the draft
        gets a fresh shot even if it was retired (its pools may have gone
        stale while off, which lowers the accept rate for one window; the
        commits stay token-exact)."""
        if self.draft_params is None or not self.spec_guard:
            return
        self.spec_guard_decision = None
        self._guard_samples = {"spec": [], "plain": []}
        self._spec_watch = [0, 0.0]
        self._watch_commit_t = None
        self.spec_active = True
        self._retire_draft_scope()

    def reset_phase_stats(self) -> None:
        """Zero the per-phase counters (after a warm-up)."""
        for k in self.phase_seconds:
            self.phase_seconds[k] = 0.0
        for k in self.phase_counts:
            self.phase_counts[k] = 0
        # a stale idle stamp would book the window before the reset into
        # the first measured dispatch's host_gap
        self._dev_idle_at = None

    # -- scheduler ---------------------------------------------------------

    def step(self) -> list[int]:
        """One engine tick. With H > 1 and depth > 1: a tick of the dispatch
        pipeline (:meth:`_pipelined_step`). Steady decode state with
        ``pipeline_decode`` (and H = 1; a horizon subsumes it): dispatch tick
        N+1, then read back tick N. Otherwise: commit whatever is in flight,
        then the settled sequence (admit -> retire finished -> a horizon, or
        grow/preempt -> decode -> retire). Returns rids that finished."""
        if self._pipeline_ready():
            return self._pipelined_step()
        # a mode change (depth, horizon, the guard re-armed): commit what the
        # pipeline left in flight, so the mirror and the host state are exact
        # before the diff-based sync
        pre = self._drain_inflight() if self._inflight else []
        # the dispatch-ahead tick composes with a draft engine only after the
        # payoff guard turned speculation off: from then on no tick drafts
        if (self.decode_horizon <= 1 and self.pipeline_decode
                and (self.draft_params is None or not self.spec_active)
                and self._steady_state()):
            prev = self._pending_tick
            self._pending_tick = None
            new_tick = self._dispatch_plain(prev)
            done = pre + self._commit_tick(prev)
            self._pending_tick = new_tick
            return done
        done = pre + self._commit_tick(self._pending_tick)
        self._pending_tick = None
        done.extend(self._settled_step())
        return done

    @staticmethod
    def _pending_indices(tick: Optional[dict]) -> set:
        """Slot indexes with an uncommitted token in the in-flight tick;
        their effective seq_len is one ahead of the committed value."""
        return {i for i, _rid in tick["snapshot"]} if tick else set()

    def _steady_state(self) -> bool:
        """True when the next tick is pure decode: nothing to admit, no slot
        ingesting, every active slot's next write position already
        block-covered, and at least one slot decoding."""
        if self.pending:
            return False
        pend_idx = self._pending_indices(self._pending_tick)
        any_active = False
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.ingest_pos is not None:
                return False
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
        # chunked prefill: each ingesting slot advances one chunk a tick,
        # so a long prompt never stalls the live slots' decode
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.ingest_pos is not None:
                self._ingest_chunk(i)
        # a request can finish on its prefill token (max_new_tokens=1, or
        # eos as the first token): decoding it once more would overrun
        done: list[int] = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.done:
                done.append(slot.request.rid)
                self._retire(i)
        if not self._decoding_slots():
            return done
        if self.decode_horizon > 1 and not any(
                s is not None and s.ingest_pos is not None for s in self.slots):
            hz = self._horizon_decode()
            if hz is not None:
                done.extend(hz)
                return done
            # lookahead unfundable without preemption: the classic tick,
            # which may preempt
        self._ensure_growth()
        if not self._decoding_slots():
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
            shared: list[int] = []
            shared_tokens = 0
            if self.pcfg.prefix_caching:
                shared, shared_tokens = self.blocks.match_prefix(effective, salt=req.adapter)
            fresh = self.blocks.alloc(need_total - len(shared))
            if fresh is None:
                self.blocks.free(shared)
                return  # head-of-line waits for memory
            self.pending.popleft()
            self._prefill(i, req, shared, shared_tokens, fresh)

    def _ensure_growth(self) -> None:
        """Ensure every decoding slot's table covers its next write
        (position seq_len - 1, i.e. blocks_for(seq_len) blocks); preempt
        the youngest slot when the pool is exhausted. Ingesting slots
        secured their whole table at admission."""
        for i, slot in enumerate(self.slots):
            if slot is None or slot.ingest_pos is not None:
                continue
            needed = self.pcfg.blocks_for(slot.seq_len)
            if needed <= len(slot.blocks):
                continue
            if needed > self.pcfg.max_blocks_per_seq:
                self._retire(i)  # capacity cap reached
                continue
            while self.slots[i] is not None and len(slot.blocks) < needed:
                got = self.blocks.alloc(1)
                while got is None:
                    victim = self._youngest(exclude=i)
                    if victim is None:
                        # nothing to steal from: retire this request with
                        # what it has rather than deadlock
                        self._retire(i)
                        break
                    self._preempt(victim)
                    got = self.blocks.alloc(1)
                if self.slots[i] is not None and got:
                    slot.blocks.extend(got)

    def _youngest(self, exclude: int) -> Optional[int]:
        cands = [(self.slots[i].request.rid, i) for i in range(len(self.slots))
                 if i != exclude and self.slots[i] is not None]
        return max(cands)[1] if cands else None

    def _preempt(self, slot_idx: int) -> None:
        """Recompute strategy: free the blocks now; on readmission the
        prefill recomputes prompt + the tokens already generated. Registered
        prefix blocks stay matchable, so the recompute usually takes them
        back for free."""
        slot = self.slots[slot_idx]
        assert slot is not None
        slot.request.preemptions += 1
        self.blocks.free(slot.blocks)
        self.slots[slot_idx] = None
        self.pending.appendleft(slot.request)

    def _retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        assert slot is not None
        slot.request.done = True
        slot.request.finished_at = time.perf_counter()
        self.blocks.free(slot.blocks)
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

    def _chunk_size(self) -> Optional[int]:
        """The chunked-prefill unit: block-aligned and equal to a bucket
        width (at least the smallest block multiple >= the bucket minimum
        of 16), so every middle chunk is exactly one bucket wide."""
        if self.pcfg.prefill_chunk is None:
            return None
        B = self.pcfg.block_size
        floor = -(-16 // B) * B  # smallest multiple of B >= 16
        return _bucket(self.pcfg.prefill_chunk, minimum=floor)

    def _prefill(self, slot_idx: int, req: Request, shared: list[int], shared_tokens: int,
                 fresh: list[int]) -> None:
        if req.admitted_at is None:
            # first admission only: a preemption recompute re-enters here
            req.admitted_at = time.perf_counter()
        # a preempted request resumes by prefilling prompt + its own output;
        # a matched prefix skips straight to the uncached suffix
        effective = req.prompt + req.output
        p = len(effective)
        sp = p - shared_tokens
        if sp == 1 and req.output:
            # every cached position [0, p - 1) matched, and the one token
            # left is already sampled (a recompute whose whole tail
            # matched): it is just the next decode input, whose K/V the
            # decode step writes at position p - 1. No prefill at all.
            self.slots[slot_idx] = _SlotState(req, shared + fresh, p,
                                              shared_tokens=shared_tokens)
            self._last_tokens[slot_idx] = req.output[-1]
            if self.pcfg.prefix_caching:
                self.blocks.register(effective, shared + fresh, salt=req.adapter)
                self.blocks.record_stats(p, shared_tokens)
            return
        chunk = self._chunk_size()
        if chunk is not None and sp > chunk:
            # chunked: secure the whole table now (the final chunk's bucket
            # padding included), then ingest a chunk per tick
            B = self.pcfg.block_size
            n_chunks = -(-sp // chunk)
            final_start = shared_tokens + (n_chunks - 1) * chunk
            final_bucket = self._whole_block_bucket(p - final_start,
                                                    self.pcfg.capacity - final_start)
            # every chunk's (padded) writes plus the first decode token
            total_blocks = max(final_start // B + final_bucket // B, self.pcfg.blocks_for(p + 1))
            while len(shared) + len(fresh) < total_blocks:
                more = self.blocks.alloc(1)
                if more is None:
                    self.blocks.free(shared + fresh)
                    self.pending.appendleft(req)
                    return
                fresh.extend(more)
            self.slots[slot_idx] = _SlotState(req, shared + fresh, 0, ingest_pos=shared_tokens,
                                              shared_tokens=shared_tokens)
            return
        if not self._run_prefill_graph(slot_idx, req, effective, shared, shared_tokens, fresh,
                                       start=shared_tokens, end=p):
            return
        if self.pcfg.prefix_caching:
            self.blocks.register(effective, shared + fresh, salt=req.adapter)
            self.blocks.record_stats(p, shared_tokens)

    def _ingest_chunk(self, slot_idx: int) -> None:
        """Advance one ingesting slot by one chunk; the final chunk samples
        the first token and turns the slot to decoding."""
        slot = self.slots[slot_idx]
        assert slot is not None and slot.ingest_pos is not None
        req = slot.request
        effective = req.prompt + req.output
        p = len(effective)
        chunk = self._chunk_size()
        assert chunk is not None  # ingest_pos is only set on the chunked path
        start = slot.ingest_pos
        prefix_blocks = slot.blocks[:start // self.pcfg.block_size]
        if p - start > chunk:
            # a middle chunk: exactly one bucket, nothing sampled
            self._run_chunk_graph(effective, prefix_blocks, start, start + chunk, slot.blocks,
                                  req.adapter)
            slot.ingest_pos = start + chunk
            return
        logits = self._run_chunk_graph(effective, prefix_blocks, start, p, slot.blocks,
                                       req.adapter)
        t0 = time.perf_counter()
        tok = self._sample_host(logits, req)
        self.phase_seconds["prefill"] += time.perf_counter() - t0
        slot.ingest_pos = None
        slot.seq_len = p + 1
        if self.pcfg.prefix_caching:
            self.blocks.register(effective, slot.blocks, salt=req.adapter)
            self.blocks.record_stats(p, slot.shared_tokens)
        self._record(slot_idx, req, tok)

    def _run_chunk_graph(self, effective: list[int], prefix_blocks: list[int], start: int,
                         end: int, table: list[int], adapter: int) -> torch.Tensor:
        """Ingest ``effective[start:end]`` over the blocks already ingested;
        returns the last real token's logits [V]."""
        B = self.pcfg.block_size
        sp = end - start
        bucket = self._whole_block_bucket(sp, self.pcfg.capacity - start)
        target = table[start // B:start // B + bucket // B]
        logits = self._dispatch_prefill(effective[start:end] + [0] * (bucket - sp),
                                        prefix_blocks, start, target, bucket, adapter)
        self.phase_counts["chunks"] += 1
        return logits[0, sp - 1]

    def _run_prefill_graph(self, slot_idx: int, req: Request, effective: list[int],
                           shared: list[int], shared_tokens: int, fresh: list[int],
                           start: int, end: int) -> bool:
        """One-shot prefill of ``effective[start:end]`` after the matched
        prefix; returns False when the padded bucket cannot be funded (the
        request is re-queued at the head)."""
        p = len(effective)
        sp = end - start
        # within what the table can still hold past the matched prefix
        bucket = self._whole_block_bucket(sp, self.pcfg.capacity - shared_tokens)
        n_sfx_blocks = bucket // self.pcfg.block_size
        while len(fresh) < n_sfx_blocks:
            more = self.blocks.alloc(1)
            if more is None:
                self.blocks.free(shared + fresh)
                self.pending.appendleft(req)
                return False
            fresh.extend(more)
        logits = self._dispatch_prefill(effective[start:end] + [0] * (bucket - sp), shared,
                                        shared_tokens, fresh[:n_sfx_blocks], bucket, req.adapter)
        t0 = time.perf_counter()
        tok = self._sample_host(logits[0, sp - 1], req)
        self.phase_seconds["prefill"] += time.perf_counter() - t0
        self.slots[slot_idx] = _SlotState(req, shared + fresh, p + 1)
        self._record(slot_idx, req, tok)
        return True

    def _dispatch_prefill(self, tokens: list[int], prefix_blocks: list[int], prefix_len: int,
                          target_blocks: list[int], bucket: int, adapter: int = 0
                          ) -> torch.Tensor:
        """The bucket-wide prefill of ``tokens`` after ``prefix_len`` cached
        tokens in ``prefix_blocks``, written into ``target_blocks``; returns
        the logits [1, bucket, V]. Adapter 0 is the zero adapter: it takes
        the LoRA-free forward. Another adapter's tree is selected out of
        the stack once and kept."""
        lora = None
        if self.loras is not None and adapter != 0:
            lora = self._adapter_cache.get(adapter)
            if lora is None:
                lora = self._adapter_cache[adapter] = select_adapter(self.loras, adapter)
        t0 = time.perf_counter()
        args = (self._upload([tokens], torch.long), prefix_blocks, prefix_len,
                self._upload(target_blocks, torch.long), bucket)
        self.pools, logits = self._run_prefill_graphs(self.params, self.pools, self.cfg, *args,
                                                      lora, self.lora_scale)
        if self.draft_params is not None and self.spec_active:
            # mirror every prefill into the draft pools: the draft's cache
            # covers the prompt before the first speculative tick, and a
            # registered prefix block stays valid for the draft on reuse
            # (same tokens, same draft K/V). Skipped once the payoff guard
            # turned speculation off.
            self.dpools, _ = self._run_prefill_graphs(self.draft_params, self.dpools,
                                                      self.draft_cfg, *args, None, 1.0)
            self.phase_counts["draft_prefills"] += 1
        self.phase_seconds["prefill"] += time.perf_counter() - t0
        self.phase_counts["prefills"] += 1
        return logits

    def _run_prefill_graphs(self, params: Any, pools: dict[str, torch.Tensor], cfg: LlamaConfig,
                            suffix: torch.Tensor, prefix_blocks: list[int], prefix_len: int,
                            target: torch.Tensor, bucket: int, lora: Optional[Any],
                            lora_scale: float) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """One prefill of one model (the target, or the draft's mirror):
        the plain bucket-wide one without a prefix, else the prefix-seeded
        one, whose gathered prefix region is the power-of-two block bucket
        of the prefix."""
        if prefix_blocks:
            prefix_bucket = min(_bucket(len(prefix_blocks), minimum=1),
                                self.pcfg.max_blocks_per_seq)
            table = prefix_blocks + [SCRATCH_BLOCK] * (prefix_bucket - len(prefix_blocks))
            return _prefill_bucket(params, pools, suffix, self._upload(table, torch.long),
                                   prefix_len, target, lora, cfg=cfg, pcfg=self.pcfg,
                                   bucket=bucket, lora_scale=lora_scale, is_moe=_is_moe(cfg))
        return _prefill_plain(params, pools, suffix, target, lora, cfg=cfg, bucket=bucket,
                              lora_scale=lora_scale, is_moe=_is_moe(cfg))

    def _decode_once(self) -> list[int]:
        if self.draft_params is None or not self.spec_active:
            return self._plain_decode_once()
        if self.spec_guard and self.spec_guard_decision is None:
            return self._guarded_tick()
        return self._spec_decode_once()

    def _plain_decode_once(self) -> list[int]:
        # synchronous tick: dispatch, then harvest at once
        return self._commit_tick(self._dispatch_plain(None))

    def _dispatch_plain(self, prev: Optional[dict]) -> dict:
        """Dispatch one fused decode step. With ``prev`` (the previous
        tick, still in flight) the input tokens are its device outputs and
        seq_lens are advanced by the commit its harvest will apply."""
        t0 = time.perf_counter()
        pend_idx = self._pending_indices(prev)
        active_l, active, adapters, temps, rids = self._lane_arrays()
        # seq_lens, and with a sampled lane each request's token index: the
        # tokens already committed, plus the one a pending tick will commit
        ahead = [(s.seq_len + (1 if i in pend_idx else 0), len(s.request.output)
                  + (1 if i in pend_idx else 0)) if ok else (1, 0)
                 for i, (s, ok) in enumerate(zip(self.slots, active_l))]
        lanes = self._upload([list(col) for col in zip(*ahead)], torch.int32)
        seq_lens, emitted = lanes[0], (lanes[1] if temps is not None else None)
        if prev is None:
            tokens = self._upload(self._last_tokens, torch.int32)
        else:
            # every active slot was in prev's snapshot (steady state admits
            # nothing); lanes of slots retired at harvest are masked
            # inactive and write only the scratch block
            tokens = prev["next"]
        tables = self._block_tables()
        self.pools, next_tokens = _decode_step(self.params, self.pools, tokens, seq_lens,
                                               active, tables, self.loras, adapters,
                                               cfg=self.cfg, pcfg=self.pcfg,
                                               lora_scale=self.lora_scale, temps=temps,
                                               rids=rids, emitted=emitted, is_moe=self.is_moe)
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

    def _lane_arrays(self) -> tuple[list[bool], torch.Tensor, Optional[torch.Tensor],
                                    Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The [S] active mask, (with LoRA) the [S] adapters and (with a
        sampled request in a slot) the [S] temperatures and rids, kept on
        the device between occupancy changes. An ingesting slot is not in the
        decode batch: its cache is mid-prefill."""
        key = tuple((s.request.rid, s.ingest_pos is None) if s is not None else None
                    for s in self.slots)
        if self._lane_key != key:
            active_l = [s is not None and s.ingest_pos is None for s in self.slots]
            adapters = temps = rids = None
            if self.loras is not None:
                adapters = self._upload([s.request.adapter if s else 0 for s in self.slots],
                                        torch.int32)
            if any(s is not None and s.request.temperature > 0 for s in self.slots):
                keyed = self._upload(
                    [[_f32_bits(s.request.temperature) if s else 0 for s in self.slots],
                     [s.request.rid if s else 0 for s in self.slots]], torch.int32)
                temps, rids = keyed[0].view(torch.float32), keyed[1]
            self._lane_cache = (active_l, self._upload(active_l, torch.bool), adapters, temps,
                                rids)
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
        self._tokens_emitted += 1
        req.output.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        if (req.eos_token is not None and tok == req.eos_token) or (
                len(req.output) >= req.max_new_tokens):
            req.done = True
        elif self.role == "prefill":
            # the prefill pool's product is the exported prompt blocks and
            # this token: retire now, a decode engine continues
            req.done = True
            req.prefilled = True

    def _sample_host(self, logits: torch.Tensor, req: Request) -> int:
        """The request's next token from one row of logits (a prefill's
        first token), keyed by (rid, token index) as every fused pick is,
        so the stream does not depend on the schedule."""
        self.phase_counts["prefill_picks"] += 1
        if req.temperature > 0:
            keyed = self._upload([[_f32_bits(req.temperature)], [req.rid], [len(req.output)]],
                                 torch.int32)
            tok = pick_tokens(logits[None], keyed[0].view(torch.float32), keyed[1], keyed[2])
        else:
            tok = pick_tokens(logits[None])
        return int(tok[0])

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
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and s.ingest_pos is None]

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
            got = self.blocks.alloc(1)
            if got is None:
                return False
            slot.blocks.extend(got)
        return True

    def _lane_want(self, i: int) -> dict:
        """What lane ``i`` of the device state should hold for the host's
        slot: a decoding slot's values, else its last values inactive."""
        s = self.slots[i]
        if s is not None and s.ingest_pos is None:
            req = s.request
            return {"last": int(self._last_tokens[i]), "seq": int(s.seq_len), "act": True,
                    "emitted": len(req.output), "budget": int(req.max_new_tokens),
                    "eos": -1 if req.eos_token is None else int(req.eos_token),
                    "adapter": int(req.adapter), "temp": float(req.temperature),
                    "rid": int(req.rid), "table": tuple(s.blocks)}
        prev = self._dev_mirror[i]
        return {**(prev if prev is not None else _FREE_LANE), "act": False}

    def _sync_device_state(self) -> None:
        """Reconcile the device lane state with the host scheduler: diff
        each lane against the mirror of what the device holds and patch
        only the lanes that changed. Catches every mutation path
        (admission, retire, preempt, growth, classic ticks between
        horizons) without invalidation hooks. A free lane keeps its last
        values, inactive."""
        for i in range(self.pcfg.max_slots):
            want = self._lane_want(i)
            if want != self._dev_mirror[i]:
                self._patch_lane(i, want)
                self._dev_mirror[i] = want

    def _patch_lane(self, i: int, lane: dict) -> None:
        """Write lane ``i`` of the device state in place: one copy of its
        row from pinned memory, on the stream the horizon replays on (so it
        lands after every horizon already queued)."""
        row = np.full(self._dev.shape[1], SCRATCH_BLOCK, np.int32)
        row[:LANE_TEMP] = [int(lane[name]) for name in LANE_FIELDS[:LANE_TEMP]]
        row[LANE_TEMP], row[LANE_RID] = _f32_bits(lane["temp"]), lane["rid"]
        row[LANE_TABLE:LANE_TABLE + len(lane["table"])] = lane["table"]
        self._dev[i].copy_(self._pinned(row), non_blocking=True)

    def _patch_lane_act(self, i: int, act: bool) -> None:
        """Set lane ``i``'s active flag alone: its last, seq and emitted may
        be ahead on the device of what the host has committed, and writing
        the host's values would rewind a live lane."""
        self._dev[i, LANE_ACT] = int(act)

    def _horizon_step(self, horizon: int) -> tuple[GraphedStep, list[torch.Tensor]]:
        """The graphed horizon of this length and its free host buffers,
        made on first use."""
        hz = self._hz.get(horizon)
        if hz is None:
            out = torch.empty((horizon + LANE_BUDGET, self.pcfg.max_slots),
                              dtype=torch.int32, device=self.device)
            fn = functools.partial(_horizon_plain, self.params, self.pools, loras=self.loras,
                                   cfg=self.cfg, pcfg=self.pcfg, H=horizon,
                                   lora_scale=self.lora_scale, is_moe=self.is_moe)
            hz = self._hz[horizon] = (GraphedStep(fn, self._dev, out), [])
        return hz

    def _read_back(self, out: torch.Tensor, free: list[torch.Tensor]
                   ) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Enqueue the copy of a horizon's output right behind its replay,
        into a host buffer of its own (pinned on a card: a free one of
        ``free``, or a new one), since the next replay rewrites ``out``.
        Returns the buffer and, on a card, the event after the copy."""
        host = free.pop() if free else torch.empty(
            out.shape, dtype=out.dtype, pin_memory=self.device.type == "cuda")
        host.copy_(out, non_blocking=True)
        if self.device.type == "cpu":
            return host, None
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _horizon_decode(self) -> Optional[list[int]]:
        """One horizon: speculative on a draft engine (through the payoff
        guard while it measures, then its watchdog), else plain. None when
        the lookahead cannot be funded without preemption (the caller takes
        the classic tick, which may preempt)."""
        if self.draft_params is not None and self.spec_active:
            if self.spec_guard and self.spec_guard_decision is None:
                return self._guarded_horizon()
            if self.spec_guard:
                return self._watched_spec_horizon()
            return self._spec_horizon_decode(self._spec_rounds())
        return self._plain_horizon_decode(self.decode_horizon, draft_sync=False)

    def _plain_horizon_decode(self, horizon: int, draft_sync: bool = False
                              ) -> Optional[list[int]]:
        """Fund every decoding lane ``horizon`` tokens ahead (at most its
        budget left), sync the lane state, run one horizon and commit its
        tokens. None when the funding fails: the caller falls back to the
        classic tick. Always the full horizon: a lane that ends early is
        deactivated on the device and its later steps are no-ops. With
        ``draft_sync`` (a draft engine decoding plainly: the guard's plain
        arm) and a greedy lane, the horizon's tokens are then appended to the
        draft pools in one T = H pass, keeping the draft cache lag-one
        current (a sampled lane never speculates)."""
        acts = self._decoding_slots()
        for _, s in acts:
            rem = s.request.max_new_tokens - len(s.request.output)
            if not self._fund_lookahead(s, min(horizon, rem)):
                return None
        self._sync_device_state()
        step, free = self._horizon_step(horizon)
        draft_sync = draft_sync and any(s.request.temperature == 0 for _, s in acts)
        self._note_dispatch_gap()
        t0 = time.perf_counter()
        if draft_sync:
            self._pre.copy_(self._dev[:, :LANE_BUDGET])
        out = step()
        self.phase_seconds["decode_device"] += time.perf_counter() - t0
        if draft_sync:
            t0 = time.perf_counter()
            self._draft_sync_step(horizon, out)()
            self.phase_seconds["draft"] += time.perf_counter() - t0
            self.phase_counts["draft_syncs"] += 1
        t0 = time.perf_counter()
        rec = self._record_horizon({"kind": "plain", "H": horizon}, out, free, acts, {})
        self.phase_seconds["decode_device"] += time.perf_counter() - t0
        self.phase_counts["horizons"] += 1
        self.phase_counts["device_steps"] += horizon
        t0 = time.perf_counter()
        if rec["ready"] is not None:
            rec["ready"].synchronize()
        self.phase_seconds["host_sync"] += time.perf_counter() - t0
        return self._land_horizon(rec)[0]

    # -- the depth-N dispatch pipeline ---------------------------------------

    def _pipeline_ready(self) -> bool:
        """True when this tick may run the pipeline: a horizon, depth > 1,
        and on a draft engine a settled payoff guard (its samples time a
        dispatch and its commit as one unit, which the pipeline would smear
        over the horizons beside it)."""
        if self.decode_horizon <= 1 or self.dispatch_depth <= 1:
            return False
        return not (self.draft_params is not None and self.spec_active
                    and self.spec_guard and self.spec_guard_decision is None)

    def _pipelined_step(self) -> list[int]:
        """One tick of the pipeline: commit the oldest horizons down to
        depth - 1 in flight, run the host's scheduling (admission, chunked
        ingest, retirement) while the others replay, then top the pipeline
        up. New and retired lanes are patched into the next horizon
        (:meth:`_patch_pipeline_lanes`), with no drain. The pipeline drains
        only when a lane's lookahead cannot be funded without preemption:
        eviction stays with the classic tick, which needs the exact host
        state."""
        # a dispatch-ahead tick left by a live change of the horizon commits
        # first: the horizon starts from the host's committed state
        done = self._commit_tick(self._pending_tick)
        self._pending_tick = None
        while len(self._inflight) >= self.dispatch_depth:
            done.extend(self._commit_horizon(self._inflight.popleft()))
        # everything below overlaps the horizons still in flight
        overlap = bool(self._inflight)
        t_host = time.perf_counter()
        self._admit()
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.ingest_pos is not None:
                self._ingest_chunk(i)
        # a request can finish on its prefill token
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.done:
                done.append(slot.request.rid)
                self._retire(i)
        dispatched = unfundable = False
        while len(self._inflight) < self.dispatch_depth:
            rec = self._dispatch_horizon()
            if rec is None:
                break
            if rec is _UNFUNDABLE:
                unfundable = True
                break
            self._inflight.append(rec)
            dispatched = True
        if overlap:
            self.phase_seconds["host_overlap"] += time.perf_counter() - t_host
        if unfundable:
            # the lookahead needs preemption: drain, so that the classic
            # tick's eviction sees the exact committed state
            done.extend(self._drain_inflight())
            if self._decoding_slots():
                self._ensure_growth()
                if self._decoding_slots():
                    done.extend(self._decode_once())
            return done
        if not dispatched and self._inflight:
            # every budget token left is in flight already: commit the
            # oldest, so that the loop always moves toward retirement
            done.extend(self._commit_horizon(self._inflight.popleft()))
        return done

    def _drain_inflight(self) -> list[int]:
        """Commit every horizon in flight, in dispatch order (mode changes,
        unfundable lookahead, the end of :meth:`run`). After a drain the
        mirror is the host's committed view, so the diff-based sync is
        exact again."""
        done: list[int] = []
        while self._inflight:
            done.extend(self._commit_horizon(self._inflight.popleft()))
        return done

    def _inflight_ahead(self, i: int, rid: int) -> int:
        """Tokens dispatched but not committed for slot ``i`` as request
        ``rid``, at most (a replaced rid's records are discarded at their
        commit and do not count)."""
        return sum(rec["ahead"].get(i, 0) for rec in self._inflight if rec["rids"].get(i) == rid)

    def _dispatch_horizon(self):
        """Enqueue one horizon without waiting for it. Returns its record,
        None when there is nothing to dispatch (no decoding lane, or every
        token left already in flight), or ``_UNFUNDABLE`` when a lane's
        lookahead needs preemption."""
        if not self._decoding_slots():
            return None
        if self.draft_params is not None and self.spec_active:
            return self._dispatch_spec_horizon(self._spec_rounds())
        return self._dispatch_plain_horizon(self.decode_horizon)

    def _dispatch_plain_horizon(self, horizon: int):
        """The dispatch half of :meth:`_plain_horizon_decode`: fund each
        lane's committed + in-flight + this horizon's tokens, patch the
        changed lanes, replay the horizon and enqueue the copy of its
        output; returns the record."""
        acts = self._decoding_slots()
        ahead: dict[int, int] = {}
        for i, s in acts:
            req = s.request
            pend = self._inflight_ahead(i, req.rid)
            ahead[i] = max(0, min(horizon, req.max_new_tokens - len(req.output) - pend))
        if all(a == 0 for a in ahead.values()):
            return None
        for i, s in acts:
            if not self._fund_lookahead(s, self._inflight_ahead(i, s.request.rid) + ahead[i]):
                return _UNFUNDABLE
        self._patch_pipeline_lanes()
        step, free = self._horizon_step(horizon)
        self._note_dispatch_gap()
        rec = self._record_horizon({"kind": "plain", "H": horizon}, step(), free, acts, ahead)
        self.phase_counts["horizons"] += 1
        self.phase_counts["device_steps"] += horizon
        return rec

    def _dispatch_spec_horizon(self, rounds: int):
        """The dispatch half of :meth:`_spec_horizon_decode`: ``rounds``
        draft + verify rounds ride the pipeline as a plain horizon does;
        the commits and the speculation counts are read at the commit."""
        acts = self._decoding_slots()
        if all(self._budget_left(i, s) == 0 for i, s in acts):
            return None
        k = self.spec_k
        funded = self._fund_spec_lanes(acts, rounds, k)
        if funded is None:
            return _UNFUNDABLE
        cov, ahead = funded
        self._patch_pipeline_lanes()
        draft, verify, out, free = self._spec_horizon_fns(k, rounds)
        self._note_dispatch_gap()
        self._run_spec_rounds(draft, verify, cov, rounds)
        return self._record_horizon({"kind": "spec", "k": k, "rounds": rounds}, out, free, acts,
                                    ahead)

    def _budget_left(self, i: int, s: _SlotState) -> int:
        """Tokens slot ``i``'s request may still commit beyond those in
        flight."""
        req = s.request
        return max(0, req.max_new_tokens - len(req.output) - self._inflight_ahead(i, req.rid))

    def _fund_spec_lanes(self, acts: list, rounds: int, k: int
                         ) -> Optional[tuple[list[int], dict[int, int]]]:
        """Fund a speculative horizon's lookahead past what is in flight: a
        greedy lane with 2 tokens of budget left speculates (``rounds *
        (k + 1)`` tokens ahead), any other commits one token a round; a lane
        whose speculative lookahead cannot be funded degrades to one a
        round. Returns (cov [S], tokens ahead by lane), or None when a lane
        cannot be funded even so."""
        cov = [0] * self.pcfg.max_slots
        ahead: dict[int, int] = {}
        for i, s in acts:
            rem, pend = self._budget_left(i, s), self._inflight_ahead(i, s.request.rid)
            spec_capable = s.request.temperature == 0 and rem >= 2
            want = min(rounds * (k + 1), rem) if spec_capable else min(rounds, rem)
            ok = self._fund_lookahead(s, pend + want)
            if not ok and spec_capable:
                spec_capable = False
                want = min(rounds, rem)
                ok = self._fund_lookahead(s, pend + want)
            if not ok:
                return None
            cov[i] = int(spec_capable)
            ahead[i] = want
        return cov, ahead

    def _record_horizon(self, rec: dict, out: torch.Tensor, free: list[torch.Tensor],
                        acts: list, ahead: dict[int, int]) -> dict:
        """A dispatched horizon's record: ``rec`` (its kind and shape) with
        the copy of its output ``out`` enqueued (:meth:`_read_back`), the
        lanes it decodes, their tokens ahead and the patch epochs."""
        host, ready = self._read_back(out, free)
        return {**rec, "host": host, "ready": ready, "free": free,
                "snapshot": [(i, s.request.rid) for i, s in acts],
                "rids": {i: s.request.rid for i, s in acts}, "ahead": ahead,
                "epochs": list(self._patch_epoch)}

    def _commit_horizon(self, rec: dict) -> list[int]:
        """Wait for one horizon in flight and commit its tokens. Dispatch
        order is load-bearing: a commit assumes every earlier record of the
        same request has landed in ``req.output``. Lanes whose slot churned
        since the dispatch (retired, replaced) are discarded; their tokens
        come again, the same, wherever the request runs next, since a token
        is a function of (rid, token index). The wait for the card is
        ``decode_device`` (what the overlapped host work did not hide), the
        read of the ready buffer ``host_sync``."""
        t0 = time.perf_counter()
        if rec["ready"] is not None:
            rec["ready"].synchronize()
        self.phase_seconds["decode_device"] += time.perf_counter() - t0
        done, tokens = self._land_horizon(rec)
        if rec["kind"] == "spec":
            self._watch_spec_commit(tokens)
        return done

    def _land_horizon(self, rec: dict) -> tuple[list[int], int]:
        """Commit a finished horizon's tokens (its copy has run): read its
        host buffer, record each live lane's tokens (a plain horizon's lane
        took the tokens its device ``emitted`` counts beyond the request's
        output, every earlier record having landed; a speculative one's
        commits round by round), retire the finished, and fold the device's
        lane state into the mirror for each lane not re-patched since the
        dispatch. Returns (finished rids, tokens committed)."""
        t0 = time.perf_counter()
        S = self.pcfg.max_slots
        got = rec["host"].numpy()
        if rec["kind"] == "plain":
            H = rec["H"]
            toks_h, (last_h, seq_h, act_h, em_h) = got[:H].tolist(), got[H:].tolist()
        else:
            rounds, k = rec["rounds"], rec["k"]
            rounds_h = [(got[r, :S, :k + 1].tolist(), got[r, :S, k + 1].tolist(),
                         got[r, S, :2].tolist()) for r in range(rounds)]
            last_h, seq_h, act_h, em_h = got[rounds, :S, :LANE_BUDGET].T.tolist()
        rec["free"].append(rec["host"])
        self.phase_seconds["host_sync"] += time.perf_counter() - t0
        self.phase_counts["host_syncs"] += 1
        before = self._tokens_emitted
        live = [(i, self.slots[i]) for i, rid in rec["snapshot"]
                if self.slots[i] is not None and self.slots[i].request.rid == rid]
        if rec["kind"] == "plain":
            for i, s in live:
                for t in range(em_h[i] - len(s.request.output)):
                    s.seq_len += 1
                    self._record(i, s.request, toks_h[t][i])
                    if s.request.done:
                        break
        else:
            for c_out, ncommit, (drafted, accepted) in rounds_h:
                self.spec_drafted += drafted
                self.spec_accepted += accepted
                for i, s in live:
                    for t in range(0 if s.request.done else ncommit[i]):
                        s.seq_len += 1
                        self._record(i, s.request, c_out[i][t])
                        if s.request.done:
                            break
        done: list[int] = []
        for i, s in live:
            if s.request.done:
                done.append(s.request.rid)
                self._retire(i)
        for i in range(S):
            if rec["epochs"][i] == self._patch_epoch[i]:  # not re-patched since
                m = self._dev_mirror[i]
                m["last"], m["seq"] = last_h[i], seq_h[i]
                m["act"], m["emitted"] = bool(act_h[i]), em_h[i]
        if not self._inflight:
            self._stamp_dev_idle()
        return done, self._tokens_emitted - before

    def _watch_spec_commit(self, tokens: int) -> None:
        """The pipeline's speculation watchdog: the one-way demotion of
        :meth:`_watched_spec_horizon`, over commit-to-commit windows (a
        record's dispatch and commit overlap other records, so a per-record
        time would count the pipeline twice). A gap over a second is idle
        time between workloads, not cadence, and is left out."""
        if not (self.spec_guard and self.spec_guard_decision is not None and self.spec_active):
            self._watch_commit_t = None
            return
        now = time.perf_counter()
        t_prev, self._watch_commit_t = self._watch_commit_t, now
        if t_prev is not None and now - t_prev <= 1.0:
            self._watch_window(tokens, now - t_prev)

    def _patch_pipeline_lanes(self) -> None:
        """The pipeline's :meth:`_sync_device_state`: fold the host's lane
        changes into the next horizon while earlier ones are in flight.
        Three cases a lane:

        - the host freed it (or it ingests) but the device lane may be live:
          set its active flag alone (a dead lane is a fixed point of the
          horizon; a lane retired by the host would otherwise decode into
          blocks the allocator handed out again);
        - a decoding slot whose scalar state differs from the mirror (an
          admission): write the whole lane (its device values are a dead
          lane's, or an old rid's whose commits the snapshot discards);
        - only its table grew (funding ahead of a lane the device has
          advanced): rewrite the tables alone, since a whole-lane write
          would rewind last, seq and emitted behind the device.

        The first two bump the lane's epoch, so that commits in flight fold
        nothing stale into the new lane's mirror; a table patch does not:
        the lane's scalar state is the in-flight horizons' to report. On an
        empty pipeline the mirror is exact and the full diff runs."""
        if not self._inflight:
            self._sync_device_state()
            return
        tables_dirty = False
        for i, s in enumerate(self.slots):
            m = self._dev_mirror[i]
            if s is None or s.ingest_pos is not None:
                if m is not None and m["act"]:
                    self._patch_lane_act(i, False)
                    m["act"] = False
                    self._patch_epoch[i] += 1
                continue
            want = self._lane_want(i)
            if m == want:
                continue
            if m is not None and all(m[f] == want[f] for f in m if f != "table"):
                m["table"] = want["table"]
                tables_dirty = True
            else:
                self._patch_lane(i, want)
                self._dev_mirror[i] = want
                self._patch_epoch[i] += 1
        if tables_dirty:
            # one copy for every table grown this pass, from the mirrors (the
            # device never writes a table); a dead or ingesting lane's row
            # reads scratch, where an inactive lane writes anyway
            tab = np.full((self.pcfg.max_slots, self.pcfg.max_blocks_per_seq), SCRATCH_BLOCK,
                          np.int32)
            for i, s in self._decoding_slots():
                row = self._dev_mirror[i]["table"]
                tab[i, :len(row)] = row
            self._dev[:, LANE_TABLE:].copy_(self._pinned(tab), non_blocking=True)

    def _stamp_dev_idle(self) -> None:
        """Mark the decode pipeline empty, while decode work remains (queued
        or slotted requests): an idle engine's wait for its next workload is
        no host gap."""
        busy = self.pending or any(s is not None for s in self.slots)
        self._dev_idle_at = time.perf_counter() if busy else None

    def _note_dispatch_gap(self) -> None:
        """Book the time since the decode pipeline went empty into
        ``host_gap``: at depth 1 the whole host round trip between horizons,
        what the pipeline exists to hide (prefills inside it count: the
        decode pipeline sat empty through them)."""
        if self._dev_idle_at is None:
            return
        self.phase_seconds["host_gap"] += time.perf_counter() - self._dev_idle_at
        self._dev_idle_at = None


    # -- speculative decoding ----------------------------------------------

    def _draft_sync_step(self, horizon: int, out: torch.Tensor) -> GraphedStep:
        """The graphed draft catch-up after a plain horizon of this length
        (reading its output ``out`` and the lane state saved before it)."""
        step = self._hz_sync.get(horizon)
        if step is None:
            fn = functools.partial(_draft_sync_lanes, self.draft_params, self.dpools,
                                   dcfg=self.draft_cfg, pcfg=self.pcfg, H=horizon)
            step = self._hz_sync[horizon] = GraphedStep(fn, self._dev, self._pre, out)
        return step

    def _spec_rounds(self) -> int:
        """Draft + verify rounds a horizon, sized so that a well-accepting
        draft commits about one horizon's worth of tokens per host read."""
        return max(1, -(-self.decode_horizon // (self.spec_k + 1)))

    def _watched_spec_horizon(self) -> Optional[list[int]]:
        """The watchdog on a draft the guard kept: the realized speculative
        rate over rolling 512-token windows; the moment a full window runs
        below the guard's own plain rate, speculation is turned off for good
        (a wrong off loses a maybe-gain, a wrong on halves throughput)."""
        before = self._tokens_emitted
        t0 = time.perf_counter()
        done = self._spec_horizon_decode(self._spec_rounds())
        if done is None:
            return None
        self._watch_window(self._tokens_emitted - before, time.perf_counter() - t0)
        return done

    def _watch_window(self, tokens: int, seconds: float) -> None:
        """Add to the watchdog's window; when it holds 512 tokens, demote the
        draft for good if its realized rate is under the guard's plain
        rate, and start a new window."""
        w = self._spec_watch
        w[0] += tokens
        w[1] += seconds
        if w[0] >= 512 and w[1] > 0:
            realized = w[0] / w[1]
            floor = float(self.spec_guard_decision.get("plain_tok_s", 0.0))
            if realized < floor:
                self.spec_active = False
                self._retire_draft_scope()
                self.spec_guard_decision["demoted"] = {
                    "realized_spec_tok_s": round(realized, 1),
                    "plain_floor_tok_s": round(floor, 1), "window_tokens": int(w[0])}
            self._spec_watch = [0, 0.0]

    def _spec_horizon_fns(self, k: int, rounds: int) -> tuple:
        """The graphed draft and verify rounds of a speculative horizon of
        ``rounds`` rounds of ``k``, their output buffer and its free host
        buffers, made on first use."""
        fns = self._hz_spec.get((k, rounds))
        if fns is None:
            S = self.pcfg.max_slots
            props = torch.zeros((S, k + 1), dtype=torch.int32, device=self.device)
            out = torch.zeros((rounds + 1, S + 1, max(k + 2, LANE_BUDGET)), dtype=torch.int32,
                              device=self.device)
            draft = GraphedStep(functools.partial(
                _spec_draft_lanes, self.draft_params, self.dpools, dcfg=self.draft_cfg,
                pcfg=self.pcfg, k=k), self._dev, self._cov, props)
            verify = GraphedStep(functools.partial(
                _spec_verify_lanes, self.params, self.pools, loras=self.loras, cfg=self.cfg,
                pcfg=self.pcfg, k=k, lora_scale=self.lora_scale), self._dev, props, out,
                self._round)
            fns = self._hz_spec[k, rounds] = (draft, verify, out, [])
        return fns

    def _run_spec_rounds(self, draft: GraphedStep, verify: GraphedStep, cov: list[int],
                         rounds: int) -> None:
        """Enqueue a speculative horizon: its lanes' coverage, then
        ``rounds`` draft and verify rounds chained on the device. The host
        only enqueues, so the ``draft`` and ``verify`` seconds are enqueue
        time."""
        self._cov.copy_(self._pinned(cov), non_blocking=True)
        self._round.zero_()
        for _ in range(rounds):
            t0 = time.perf_counter()
            draft()
            t1 = time.perf_counter()
            verify()
            self.phase_seconds["draft"] += t1 - t0
            self.phase_seconds["verify"] += time.perf_counter() - t1
        self.phase_counts["spec_rounds"] += rounds
        self.phase_counts["horizons"] += 1

    def _spec_horizon_decode(self, rounds: int) -> Optional[list[int]]:
        """``rounds`` draft + verify rounds with the lane state on the
        device throughout (no host read between rounds); the host learns the
        commits once, at the end. Lanes that cannot speculate (sampled, a
        last-token budget, no coverage) commit their one token a round
        through the same verify. None when a lane's lookahead cannot be
        funded."""
        acts = self._decoding_slots()
        k = self.spec_k
        funded = self._fund_spec_lanes(acts, rounds, k)
        if funded is None:
            return None
        self._sync_device_state()
        draft, verify, out, free = self._spec_horizon_fns(k, rounds)
        self._note_dispatch_gap()
        self._run_spec_rounds(draft, verify, funded[0], rounds)
        t0 = time.perf_counter()
        rec = self._record_horizon({"kind": "spec", "k": k, "rounds": rounds}, out, free, acts,
                                   {})
        if rec["ready"] is not None:
            rec["ready"].synchronize()
        self.phase_seconds["host_sync"] += time.perf_counter() - t0
        return self._land_horizon(rec)[0]

    def _guarded_horizon(self) -> Optional[list[int]]:
        """The payoff guard at horizon granularity: one speculative horizon
        against one plain horizon of the full length (with the draft
        catch-up, whose own seconds are taken out of the plain sample), in
        turns, realized tokens/s sampled each way; the first sample of each
        mode (the graphs' capture) is discarded. Decides once both modes
        have half the guard's ticks (at least 2) of samples."""
        mode = ("spec" if len(self._guard_samples["spec"]) <= len(self._guard_samples["plain"])
                else "plain")
        before = self._tokens_emitted
        draft_before = self.phase_seconds["draft"]
        t0 = time.perf_counter()
        if mode == "spec":
            done = self._spec_horizon_decode(self._spec_rounds())
        else:
            done = self._plain_horizon_decode(self.decode_horizon, draft_sync=True)
        if done is None:
            return None  # unfundable: no sample, the classic tick decides
        dt = time.perf_counter() - t0
        if mode == "plain":
            # a draft-less engine never pays the catch-up
            dt = max(dt - (self.phase_seconds["draft"] - draft_before), 1e-9)
        emitted = self._tokens_emitted - before
        samples = self._guard_samples[mode]
        samples.append(emitted / dt if (samples and emitted and dt > 0) else -1.0)
        need = max(2, -(-self.spec_guard_ticks // 2))
        if all(len([x for x in self._guard_samples[m] if x > 0]) >= need
               for m in ("spec", "plain")):
            self._guard_decide()
        return done

    def _guarded_tick(self) -> list[int]:
        """One measured classic tick of the guard: speculative and plain
        (with the draft append) in turns; the first of each mode is
        discarded. A horizon engine lands here only when a horizon could not
        be funded: its tick is not sampled (another granularity)."""
        mode = ("spec" if len(self._guard_samples["spec"]) <= len(self._guard_samples["plain"])
                else "plain")
        before = self._tokens_emitted
        t0 = time.perf_counter()
        done = self._spec_decode_once() if mode == "spec" else self._plain_with_draft_sync()
        if self.decode_horizon > 1:
            return done
        dt = time.perf_counter() - t0
        emitted = self._tokens_emitted - before
        samples = self._guard_samples[mode]
        samples.append(emitted / dt if (samples and emitted and dt > 0) else -1.0)
        if all(len([x for x in self._guard_samples[m] if x > 0]) >= self.spec_guard_ticks
               for m in ("spec", "plain")):
            self._guard_decide()
        return done

    def _guard_decide(self) -> None:
        """Keep the draft when the median speculative rate beats the median
        plain rate by the margin; record the decision (JAX's fields)."""
        spec_rate = median([x for x in self._guard_samples["spec"] if x > 0])
        plain_rate = median([x for x in self._guard_samples["plain"] if x > 0])
        keep = spec_rate >= plain_rate * (1.0 + self.spec_guard_margin)
        self.spec_active = keep
        if not keep:
            self._retire_draft_scope()
        self.spec_guard_decision = {
            "active": keep,
            "spec_tok_s": round(spec_rate, 1),
            "plain_tok_s": round(plain_rate, 1),
            "accept_rate": round(self.spec_accepted / max(1, self.spec_drafted), 3),
            "spec_k": self.spec_k,
            # the plain arm ran with the draft catch-up, which understates the
            # draft-less plain path; the margin compensates
            "margin": self.spec_guard_margin,
            "plain_measured_via": "plain_with_draft_sync",
        }

    def _retire_draft_scope(self) -> None:
        """After the draft is retired (or re-armed) the engine serves as a
        draft-less (or draft) engine does: rescope prefix sharing, so that
        its exports land in, and its imports come from, that namespace, and
        draft-less payloads never squat the draft scope's publish-once
        keys."""
        if self.blocks.shared is not None:
            self._sharing_scope_cache = None
            self.blocks.rescope(self._sharing_scope())

    def _spec_coverage(self, slot: _SlotState, k: int) -> bool:
        """Cover the verify's writes through ``seq_len + k - 1`` without
        preemption; failure degrades this slot to plain decoding this
        tick."""
        need = self.pcfg.blocks_for(slot.seq_len + k)
        if need <= len(slot.blocks):
            return True
        if need > self.pcfg.max_blocks_per_seq or slot.seq_len + k > self.pcfg.capacity:
            return False
        got = self.blocks.alloc(need - len(slot.blocks))
        if got is None:
            return False
        slot.blocks.extend(got)
        return True

    def _spec_decode_once(self) -> list[int]:
        """A classic speculative tick: the draft proposes spec_k tokens a
        slot, one fused target step verifies them, and the speculative
        horizon's accept (:func:`.spec_decode._spec_accept`, on the device)
        picks the accept prefix and the correction (or bonus) token, cut by
        eos and the budget; the host records them. A sampled slot, a slot
        without coverage or with one token of budget left commits the
        position-0 token, the plain step's."""
        k = self.spec_k
        active_l = [s is not None and s.ingest_pos is None for s in self.slots]
        spec_ok_l = [active_l[i] and s.request.temperature == 0
                     and s.request.max_new_tokens - len(s.request.output) >= 2
                     and self._spec_coverage(s, k)
                     for i, s in enumerate(self.slots)]
        if not any(spec_ok_l):
            # nothing to speculate: the plain step commits the same tokens
            return self._plain_with_draft_sync()
        t0 = time.perf_counter()
        _, active, adapters, temps, rids = self._lane_arrays()
        reqs = [s.request if s is not None else None for s in self.slots]
        lanes = self._upload(
            [[s.seq_len if ok else 1 for s, ok in zip(self.slots, active_l)],
             [len(r.output) if r else 0 for r in reqs],
             [r.max_new_tokens if r else 0 for r in reqs],
             [r.eos_token if r and r.eos_token is not None else -1 for r in reqs]], torch.int32)
        seq_lens, emitted, budget, eos = lanes.unbind(0)
        spec_ok = self._upload(spec_ok_l, torch.bool)
        self.pools, self.dpools, props, choice = _spec_step(
            self.params, self.draft_params, self.pools, self.dpools,
            self._upload(self._last_tokens, torch.int32), seq_lens, active, spec_ok,
            self._block_tables(), self.loras, adapters,
            cfg=self.cfg, dcfg=self.draft_cfg, pcfg=self.pcfg, k=k, lora_scale=self.lora_scale,
            temps=temps, rids=rids, emitted=emitted if temps is not None else None)
        self.phase_seconds["decode_device"] += time.perf_counter() - t0
        self.phase_counts["spec_ticks"] += 1
        c_out, ncommit, _, stats = _spec_accept(props, choice, spec_ok, active, emitted, budget,
                                                eos, k=k)
        t0 = time.perf_counter()
        both = torch.cat([c_out, ncommit[:, None], stats[None].expand(len(reqs), 2)],
                         dim=1).tolist()
        self.phase_seconds["host_sync"] += time.perf_counter() - t0
        self.spec_drafted += both[0][k + 2]
        self.spec_accepted += both[0][k + 3]
        done: list[int] = []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.ingest_pos is not None:
                continue
            for tok in both[i][:both[i][k + 1]]:
                slot.seq_len += 1
                self._record(i, slot.request, tok)
            if slot.request.done:
                done.append(slot.request.rid)
                self._retire(i)
        return done

    def _plain_with_draft_sync(self) -> list[int]:
        """A plain tick on a draft engine: first the draft appends this
        tick's input token (the ``i == 0`` write of the speculative tick)
        for every greedy slot, or a slot that speculates on a later tick
        attends a hole at this position and the accept rate collapses. A
        sampled slot never speculates, so an all-sampled batch skips the
        draft."""
        greedy_l = [s is not None and s.ingest_pos is None and s.request.temperature == 0
                    for s in self.slots]
        if any(greedy_l):
            t0 = time.perf_counter()
            seq_lens = self._upload(
                [s.seq_len if ok else 1 for s, ok in zip(self.slots, greedy_l)], torch.int32)
            self.dpools = _draft_append(self.draft_params, self.dpools,
                                        self._upload(self._last_tokens, torch.int32), seq_lens,
                                        self._upload(greedy_l, torch.bool), self._block_tables(),
                                        dcfg=self.draft_cfg, pcfg=self.pcfg)
            self.phase_seconds["draft"] += time.perf_counter() - t0
            self.phase_counts["draft_appends"] += 1
        return self._plain_decode_once()


# ---------------------------------------------------------------------------
# device work
# ---------------------------------------------------------------------------


def _family_forward(params: dict[str, Any], tokens: torch.Tensor, cfg: Any,
                    cache: list[dict[str, Any]], positions: torch.Tensor, lora: Optional[Any],
                    lora_scale: float, is_moe: bool
                    ) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """Dense vs MoE forward behind one ``(logits, cache)`` signature (the
    MoE one without its aux loss, which serving drops)."""
    if is_moe:
        return routed_forward(params, tokens, cfg, cache, positions)
    return forward(params, tokens, cfg, cache=cache, positions=positions, lora=lora,
                   lora_scale=lora_scale)


@torch.no_grad()
def _prefill_plain(params: dict[str, Any], pools: dict[str, torch.Tensor],
                   tokens: torch.Tensor, block_ids: torch.Tensor, lora: Optional[Any] = None, *,
                   cfg: LlamaConfig, bucket: int, lora_scale: float = 1.0,
                   is_moe: bool = False):
    """Full-prompt prefill without a shared prefix: a fresh contiguous cache
    of exactly bucket capacity, the model forward (under one adapter's
    ``lora`` tree, or none), then its K/V scattered into the blocks.
    Returns ``(pools, logits [1, bucket, V])``."""
    cache = init_cache(cfg, 1, bucket, device=tokens.device)
    positions = torch.arange(bucket, device=tokens.device)[None, :]
    logits, cache = _family_forward(params, tokens, cfg, cache, positions, lora, lora_scale,
                                    is_moe)
    k = torch.stack([c["k"][0] for c in cache])
    v = torch.stack([c["v"][0] for c in cache])
    return write_prefill(pools, k, v, block_ids), logits


@torch.no_grad()
def _prefill_bucket(params: dict[str, Any], pools: dict[str, torch.Tensor],
                    suffix_tokens: torch.Tensor, prefix_table: torch.Tensor, prefix_len: int,
                    suffix_blocks: torch.Tensor, lora: Optional[Any] = None, *,
                    cfg: LlamaConfig, pcfg: PagedConfig, bucket: int,
                    lora_scale: float = 1.0, is_moe: bool = False):
    """The suffix forward against a contiguous cache seeded with the
    prefix's KV (:func:`~.paged_cache.init_cache_seed`); the suffix's K/V
    lands in the sequence's ``suffix_blocks``. The cursor is the host int
    ``prefix_len``, so each layer's attention is one flash launch over the
    ``prefix_len + bucket`` valid rows at ``q_offset = prefix_len``.
    Returns ``(pools, logits [1, bucket, V])``."""
    cache = init_cache_seed(pools, prefix_table, prefix_len, extra=bucket)
    positions = prefix_len + torch.arange(bucket, device=suffix_tokens.device)[None, :]
    logits, cache = _family_forward(params, suffix_tokens, cfg, cache, positions, lora,
                                    lora_scale, is_moe)
    # the suffix K/V sits at [prefix_len, prefix_len + bucket) (block-aligned:
    # shared prefixes are whole blocks)
    k = torch.stack([c["k"][0, prefix_len:prefix_len + bucket] for c in cache])
    v = torch.stack([c["v"][0, prefix_len:prefix_len + bucket] for c in cache])
    return write_prefill(pools, k, v, suffix_blocks), logits


@torch.no_grad()
def _decode_step(params: dict[str, Any], pools: dict[str, torch.Tensor],
                 tokens: torch.Tensor, seq_lens: torch.Tensor, active: torch.Tensor,
                 block_tables: torch.Tensor, loras: Optional[Any] = None,
                 adapter_idx: Optional[torch.Tensor] = None, *, cfg: LlamaConfig,
                 pcfg: PagedConfig, lora_scale: float = 1.0,
                 temps: Optional[torch.Tensor] = None, rids: Optional[torch.Tensor] = None,
                 emitted: Optional[torch.Tensor] = None, is_moe: bool = False):
    """One fused token step for every slot: the incoming token sits at
    position ``seq_len - 1``; its K/V is written into the pools before the
    layer's attention reads them. With a stacked ``loras`` tree each slot
    adds its own adapter's deltas (``adapter_idx`` [S] on the device,
    :func:`models.lora.lora_delta_slots`). The next token is
    :func:`~bobrapet_tpu_torch.ops.pick_tokens` of the logits: greedy
    without ``temps``, else keyed by ``rids`` and the token indices
    ``emitted`` (each [S] on the device). ``is_moe``: the routed MLP
    (:func:`models.moe.moe_mlp_block`), the slots one token batch; inactive
    slots are routed too, and at the no-drop capacity the engine requires
    they take no live slot's place. Returns ``(pools, next tokens [S]
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
        lora_layer = loras["layers"][layer_i] if loras is not None else None
        lora = (lora_layer, lora_scale, adapter_idx)
        x, q, k, v = _qkv(layer, x, delta, freqs, cfg, positions[:, None], *lora)
        pools = _write_layer(pools, layer_i, k, v, write_block, write_off)
        out = _paged_attention(q, pools, block_tables, seq_lens, layer_i, cfg)
        delta = _lora_mm(out.reshape(S, 1, cfg.dim), layer["attn"]["wo"], lora_layer, "wo",
                         lora_scale, adapter_idx)
        if is_moe:
            x, delta = moe_mlp_block(layer, x, delta, cfg)
        else:
            x, delta = _mlp_block(layer, x, delta, cfg, *lora)

    logits = _logits(params, x, delta, cfg)[:, 0]  # [S, V]
    return pools, pick_tokens(logits, temps, rids, emitted)


@torch.no_grad()
def _horizon_plain(params: dict[str, Any], pools: dict[str, torch.Tensor], lanes: torch.Tensor,
                   out: torch.Tensor, loras: Optional[Any] = None, *, cfg: LlamaConfig,
                   pcfg: PagedConfig, H: int, lora_scale: float = 1.0,
                   is_moe: bool = False) -> torch.Tensor:
    """H fused steps over the device lane state, no host read: each step is
    :func:`_decode_step` over every slot (each lane's token picked at its
    ``LANE_TEMP``, keyed by its ``LANE_RID`` and emitted count), then JAX's
    liveness (``bobrapet_tpu/serving/engine.py:_horizon_plain``): a lane that
    hits its eos or its budget is deactivated, and from then on writes only
    the scratch block and emits -1. With ``loras``, each lane's adapter is
    read from its ``LANE_ADAPTER`` column on the device. Every lane value is
    read from the device, so a new lane mix replays the same graph.

    ``lanes`` [S, LANE_TABLE + MB] int32 (columns ``LANE_*``); writes into
    ``out`` [H + 4, S] int32 the tokens of every step, then last, seq, act
    and emitted after the horizon, and writes those four back into
    ``lanes``. Pools are written in place. Returns ``out``."""
    last = lanes[:, LANE_LAST]
    seq = lanes[:, LANE_SEQ].contiguous()
    act = lanes[:, LANE_ACT] != 0
    emitted = lanes[:, LANE_EMITTED].contiguous()
    budget, eos = lanes[:, LANE_BUDGET], lanes[:, LANE_EOS]
    adapters = lanes[:, LANE_ADAPTER] if loras is not None else None
    temps = lanes[:, LANE_TEMP].contiguous().view(torch.float32)
    rids = lanes[:, LANE_RID].contiguous()
    tables = lanes[:, LANE_TABLE:].contiguous()
    for t in range(H):
        pools, tok = _decode_step(params, pools, last, seq, act, tables, loras, adapters,
                                  cfg=cfg, pcfg=pcfg, lora_scale=lora_scale, temps=temps,
                                  rids=rids, emitted=emitted, is_moe=is_moe)
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


@torch.no_grad()
def _spec_draft_lanes(draft_params: dict[str, Any], dpools: dict[str, torch.Tensor],
                      lanes: torch.Tensor, cov: torch.Tensor, props: torch.Tensor, *,
                      dcfg: LlamaConfig, pcfg: PagedConfig, k: int) -> torch.Tensor:
    """The draft half of a speculative horizon's round over the device lane
    state (:func:`.spec_decode._spec_draft`): writes the proposals into
    ``props[:, :k]`` and whether each lane speculates into ``props[:, k]``.
    Returns ``props``."""
    # a lane speculates when it is live, its coverage was funded (greedy
    # lanes only) and at least 2 tokens of budget remain
    act = lanes[:, LANE_ACT] != 0
    spec_ok = act & (cov != 0) & (lanes[:, LANE_BUDGET] - lanes[:, LANE_EMITTED] >= 2)
    dpools, proposals = _spec_draft(
        draft_params, dpools, lanes[:, LANE_LAST], lanes[:, LANE_SEQ], act, spec_ok,
        lanes[:, LANE_TABLE:].contiguous(), dcfg=dcfg, pcfg=pcfg, k=k)
    props[:, :k] = proposals
    props[:, k] = spec_ok.to(torch.int32)
    return props


@torch.no_grad()
def _spec_verify_lanes(params: dict[str, Any], pools: dict[str, torch.Tensor],
                       lanes: torch.Tensor, props: torch.Tensor, out: torch.Tensor,
                       round_idx: torch.Tensor, loras: Optional[Any] = None, *,
                       cfg: LlamaConfig, pcfg: PagedConfig, k: int,
                       lora_scale: float = 1.0) -> torch.Tensor:
    """The verify half of a speculative horizon's round
    (:func:`.spec_decode._spec_verify`) over the device lane state, a
    sampled lane's one token drawn at its ``LANE_TEMP``: advances
    last, seq, act and emitted in ``lanes``, and writes at round
    ``round_idx`` (on the device, then advanced) of ``out`` [R + 1, S + 1,
    W] the committed tokens (``[:S, :k + 1]``, -1 past the count), the
    counts (``[:S, k + 1]``) and (drafted, accepted) (``[S, :2]``); row R
    holds the lane state (last, seq, act, emitted) after the round. Returns
    ``out``."""
    S = lanes.shape[0]
    adapters = lanes[:, LANE_ADAPTER] if loras is not None else None
    (_, last, seq, act, emitted, c_out, ncommit, stats) = _spec_verify(
        params, pools, props[:, :k], props[:, k] != 0, lanes[:, LANE_LAST], lanes[:, LANE_SEQ],
        lanes[:, LANE_ACT] != 0, lanes[:, LANE_EMITTED].contiguous(), lanes[:, LANE_BUDGET],
        lanes[:, LANE_EOS], adapters, lanes[:, LANE_TABLE:].contiguous(), loras, cfg=cfg,
        pcfg=pcfg, k=k, lora_scale=lora_scale,
        temps=lanes[:, LANE_TEMP].contiguous().view(torch.float32),
        rids=lanes[:, LANE_RID].contiguous())
    block = torch.zeros(out.shape[1:], dtype=torch.int32, device=out.device)
    block[:S, :k + 1] = c_out
    block[:S, k + 1] = ncommit
    block[S, :2] = stats
    out.index_copy_(0, round_idx, block[None])
    round_idx.add_(1)
    state = torch.stack([last, seq, act.to(torch.int32), emitted], dim=1)
    out[-1, :S, :LANE_BUDGET] = state
    lanes[:, :LANE_BUDGET] = state
    return out


@torch.no_grad()
def _draft_sync_lanes(draft_params: dict[str, Any], dpools: dict[str, torch.Tensor],
                      lanes: torch.Tensor, pre: torch.Tensor, out: torch.Tensor, *,
                      dcfg: LlamaConfig, pcfg: PagedConfig, H: int) -> None:
    """The draft's catch-up on one plain horizon
    (:func:`.spec_decode._draft_sync_block`): the tokens ``out[:H]`` and the
    emitted counts ``out[H + 3]`` of :func:`_horizon_plain`, over the lane
    state ``pre`` [S, 4] saved before it."""
    _draft_sync_block(draft_params, dpools, out[:H], pre[:, LANE_LAST], pre[:, LANE_SEQ],
                      pre[:, LANE_EMITTED], out[H + LANE_EMITTED],
                      lanes[:, LANE_TABLE:].contiguous(), dcfg=dcfg, pcfg=pcfg, H=H)


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
