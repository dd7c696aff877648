"""The serving engram: a Story step that serves a model on the port.

The port's copy of ``bobrapet_tpu/serving/engram.py``. A streaming step
whose template entrypoint is this module's :func:`serve` becomes a
continuous-batching model server: prompts arrive on the step's input
stream, completions leave on its downstream targets, and everything else
comes from the step's ``with`` config, with the JAX engram's keys,
defaults and refusals:

```yaml
with:
  model: 8b                   # tiny | 1b | 8b | moe-tiny | mixtral-8x7b
  quant: int8                 # optional weight-only quantization
  checkpoint: runs/prod/llama # optional blob-store prefix
  lora: {rank: 8, alpha: 16, sites: [wq, wv],
         checkpoints: [runs/prod/lora-support]}   # or initSeeds: [1, 2]
  paging: {maxSlots: 8, blockSize: 16, numBlocks: 512,
           maxBlocksPerSeq: 64, prefillChunk: 256}
  draft: {selfInt8: true, specK: 4}   # optional speculative decoding
  decodeHorizon: 8                    # fused steps per host sync
  dispatchDepth: 2                    # horizons kept in flight
  prefixShared: true                  # cross-engine prefix sharing
  role: prefill                       # disaggregated pool role
  tenantWeights: {alice: 4, bob: 1}   # weighted-fair admission
  hub: bobravoz-hub.bobrapet-system.svc:50052
```

``decodeHorizon``/``dispatchDepth``/``prefixShared``/``role``/
``tenantWeights`` default to the last operator tuning pushed through
:func:`apply_tuning` (an object with ``ServingConfig``'s fields); pinning
one in the step config keeps it through later reloads.

Weights come from a checkpoint in the run's blob store (``checkpoint``:
:func:`~bobrapet_tpu_torch.sdk.checkpoint.restore_checkpoint` against a
template on the meta device, straight onto the card), saved by either
package. Without one, ``initSeed`` draws them with the port's own
``torch.Generator``: they are not the JAX engram's threefry weights for
the same seed, so parity with the JAX engram runs through checkpoints.

``ctx`` is duck-typed: ``config`` (the step's ``with`` mapping),
``storage.store`` (a blob store; ``storage`` None without one),
``open_output_streams()`` and ``open_input_stream(hub)``; the JAX
engram's ``step`` and ``trace_context`` feed its spans and metrics, which
wait for the port's observability slice. :func:`build_engine` and
:func:`serve` run on the card unless given ``device``.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import weakref
from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import llama, moe, quant
from ..models.lora import LoRAConfig, init_lora, stack_adapters, zero_lora
from .engine import ServingEngine
from .paged_cache import PagedConfig
from .service import StreamServer

_log = logging.getLogger(__name__)

#: engines this process is serving: the live-reload targets of
#: :func:`apply_tuning` (weak, so a drained server's engine does not outlive
#: its step)
_LIVE_ENGINES: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()
#: the last tuning applied: build-time defaults for engines whose step
#: config does not pin its own values
_TUNING: Optional[Any] = None


def apply_tuning(scfg: Any) -> None:
    """Apply the ``serving.*`` knobs of ``scfg`` (any object with
    ``ServingConfig``'s fields) to every live engine, and keep it as the
    default of later builds.

    Values a step pinned (``_engram_pinned``) survive. Engines sharing
    through a registry of their own are never moved onto the global one
    nor detached. A failure on one engine (``serving.prefix-cache-shared``
    on an engine without prefix caching) is logged and skipped."""
    from ..traffic.fairness import parse_tenant_weights
    from .prefix_cache import GLOBAL_SHARED_PREFIXES

    global _TUNING
    _TUNING = scfg
    try:
        weights: Optional[dict] = parse_tenant_weights(scfg.tenant_weights)
    except ValueError as e:
        _log.warning("serving.tenant-weights unparseable, keeping prior weights: %s", e)
        weights = None
    for eng in list(_LIVE_ENGINES):
        pinned = getattr(eng, "_engram_pinned", frozenset())
        try:
            if "decode_horizon" not in pinned:
                eng.set_decode_horizon(scfg.decode_horizon)
            if "dispatch_depth" not in pinned:
                eng.set_dispatch_depth(getattr(scfg, "dispatch_depth", 2))
            if "spec_k" not in pinned:
                eng.set_spec_k(scfg.spec_k)
            if "role" not in pinned:
                eng.set_role(scfg.role)
            if weights is not None and "tenant_weights" not in pinned:
                eng.set_tenant_weights(weights)
            if "prefix_shared" not in pinned:
                current = eng.blocks.shared
                if scfg.prefix_cache_shared:
                    if current is None:
                        eng.set_prefix_sharing(True)
                elif current is None or current is GLOBAL_SHARED_PREFIXES:
                    eng.set_prefix_sharing(False)
        except ValueError as e:
            _log.warning("serving.* reload skipped an engine: %s", e)
    # the router knobs retune live routers (once the router module is loaded)
    router_mod = sys.modules.get(f"{__package__}.router")
    if router_mod is not None:
        router_mod.apply_tuning(scfg)
    if scfg.role == "prefill" and not (router_mod is not None and len(router_mod._LIVE_ROUTERS)):
        _log.warning(
            "serving.role=prefill applied with no live ServingRouter in this process: "
            "requests will retire after their first token (wire completions carry "
            "\"prefilled\": true)")


def _moe_cfg(factory):
    """A serving-safe MoE config: the no-drop capacity the engine demands."""

    def make():
        cfg = factory()
        return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return make


_MODELS = {
    "tiny": llama.llama_tiny,
    "1b": llama.llama3_1b,
    "8b": llama.llama3_8b,
    "moe-tiny": _moe_cfg(moe.moe_tiny),
    "mixtral-8x7b": _moe_cfg(moe.mixtral_8x7b),
}


def _paged_config(raw: dict[str, Any]) -> PagedConfig:
    # None-sentinel defaults: an explicit 0 must reach PagedConfig
    return PagedConfig(
        max_slots=int(raw.get("maxSlots", 8)),
        block_size=int(raw.get("blockSize", 16)),
        num_blocks=int(raw.get("numBlocks", 256)),
        max_blocks_per_seq=int(raw.get("maxBlocksPerSeq", 32)),
        prefix_caching=bool(raw.get("prefixCaching", True)),
        prefill_chunk=(int(raw["prefillChunk"])
                       if raw.get("prefillChunk") is not None else None),
    )


def _restore(ctx, prefix: str, like: Any, device: torch.device) -> Any:
    from ..sdk.checkpoint import restore_checkpoint

    if ctx.storage is None:
        raise ValueError(
            f"config references checkpoint {prefix!r} but the context "
            "has no storage manager — serving random weights instead "
            "would be a silent correctness failure")
    restored, _ = restore_checkpoint(ctx.storage.store, prefix, like, device=device)
    return restored


def _generator(seed: Any, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed or 0))


def _build_loras(ctx, cfg, raw: dict[str, Any], device: torch.device):
    """The stacked adapter tree: blob-store checkpoints or initSeeds, with
    the zero (base) adapter at index 0."""
    lcfg = LoRAConfig(
        rank=int(raw.get("rank", 8)),
        alpha=float(raw.get("alpha", 16.0)),
        sites=tuple(raw.get("sites") or ("wq", "wv")),
    )
    adapters = [zero_lora(cfg, lcfg, device)]
    # one template gives every restore its structure (values never read)
    like = zero_lora(cfg, lcfg, "meta")
    for prefix in raw.get("checkpoints") or []:
        adapters.append(_restore(ctx, str(prefix), {"lora": like}, device)["lora"])
    for seed in raw.get("initSeeds") or []:
        adapters.append(init_lora(_generator(seed, device), cfg, lcfg, device))
    if len(adapters) == 1:
        raise ValueError("config.lora needs checkpoints or initSeeds "
                         "(an empty stack serves only the base model)")
    return stack_adapters(adapters), lcfg.scale


def build_engine(ctx, device: DeviceLike = None) -> ServingEngine:
    """The ServingEngine of the step's config and the run's blob store, on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    config = ctx.config
    model_name = str(config.get("model", "tiny"))
    if model_name not in _MODELS:
        raise ValueError(
            f"config.model {model_name!r} unknown; choose one of {sorted(_MODELS)}")
    cfg = _MODELS[model_name]()
    family = moe if hasattr(cfg, "n_experts") else llama
    if family is moe and (config.get("quant") or config.get("lora") or config.get("draft")):
        # before any restore: the engine would refuse these only after the
        # whole tree came out of the blob store
        raise ValueError("quant/lora/draft are dense-family only; remove "
                         f"them for model {model_name!r}")
    params = _load_params(ctx, family, cfg, config.get("checkpoint"), config.get("initSeed"),
                          dev)
    quant_mode = config.get("quant")
    if quant_mode == "int8":
        params = quant.quantize_params(params)
    elif quant_mode not in (None, ""):
        raise ValueError(f"config.quant {quant_mode!r} unsupported (supported: int8)")
    loras, lora_scale = (None, 1.0)
    if config.get("lora"):
        loras, lora_scale = _build_loras(ctx, cfg, config["lora"], dev)
    draft_params, draft_cfg, spec_k, spec_guard = _build_draft(ctx, config, cfg, params, dev)
    # the step config pins build-time values; otherwise the last tuning's
    # knobs are the defaults
    pcfg = _paged_config(config.get("paging") or {})
    tuning = _TUNING
    horizon = int(config.get("decodeHorizon", tuning.decode_horizon if tuning else 8))
    depth = int(config.get("dispatchDepth",
                           getattr(tuning, "dispatch_depth", 2) if tuning else 2))
    shared = bool(config.get("prefixShared", tuning.prefix_cache_shared if tuning else False))
    if (draft_params is not None and tuning is not None
            and "specK" not in (config.get("draft") or {})):
        spec_k = int(tuning.spec_k)
    if shared and not pcfg.prefix_caching:
        if "prefixShared" in config:
            raise ValueError("config.prefixShared requires paging.prefixCaching: true")
        # the global knob must not brick a step without prefix caching
        _log.warning("serving.prefix-cache-shared skipped: step disables prefix caching")
        shared = False
    role = str(config.get("role", tuning.role if tuning else "unified"))
    if role == "prefill" and not pcfg.prefix_caching:
        if "role" in config:
            raise ValueError("role: prefill requires paging.prefixCaching"
                             ": true (the KV handoff rides the prefix "
                             "cache)")
        _log.warning("serving.role=prefill skipped: step disables prefix caching")
        role = "unified"
    if role == "prefill" and not shared and "role" in config:
        raise ValueError("role: prefill requires prefix sharing "
                         "(prefixShared: true or the "
                         "serving.prefix-cache-shared knob) — the KV "
                         "handoff is exported through the shared "
                         "registry")
    engine = ServingEngine(params, cfg, pcfg, loras=loras, lora_scale=lora_scale,
                           draft_params=draft_params, draft_cfg=draft_cfg, spec_k=spec_k,
                           spec_guard=spec_guard, decode_horizon=horizon, dispatch_depth=depth,
                           prefix_shared=shared, role=role)
    tw = config.get("tenantWeights")
    if tw is not None:
        if not isinstance(tw, dict) or not tw:
            raise ValueError("config.tenantWeights must be a non-empty "
                             "mapping of tenant -> weight")
        weights = {str(k): float(v) for k, v in tw.items()}
        if any(w <= 0 for w in weights.values()):
            raise ValueError("config.tenantWeights weights must be > 0")
        engine.set_tenant_weights(weights)
    elif tuning is not None and getattr(tuning, "tenant_weights", ""):
        from ..traffic.fairness import parse_tenant_weights

        engine.set_tenant_weights(parse_tenant_weights(tuning.tenant_weights))
    # knobs the step pinned survive reloads (apply_tuning)
    engine._engram_pinned = frozenset(
        name for key, name in (("decodeHorizon", "decode_horizon"),
                               ("dispatchDepth", "dispatch_depth"),
                               ("prefixShared", "prefix_shared"),
                               ("role", "role"),
                               ("tenantWeights", "tenant_weights"))
        if key in config
    ) | (frozenset(["spec_k"]) if "specK" in (config.get("draft") or {}) else frozenset())
    _LIVE_ENGINES.add(engine)
    return engine


def _load_params(ctx, family, cfg, ckpt, seed, device: torch.device):
    """A checkpoint restore against a template on the meta device (no
    weights are made only to be thrown away), or a seeded init: one loader
    for the target and the draft."""
    if ckpt:
        like = family.init_params(cfg, torch.Generator(), "meta")
        return _restore(ctx, str(ckpt), {"params": like}, device)["params"]
    return family.init_params(cfg, _generator(seed, device), device)


def _build_draft(ctx, config, cfg, params, device: torch.device):
    """The speculative-decoding draft of ``config.draft``:

    - ``{selfInt8: true, specK: N}``: an int8 quantization of the target;
    - ``{model: tiny, checkpoint|initSeed: ..., specK: N}``: a small dense
      model sharing the tokenizer.

    ``guard`` (default true) keeps the engine's payoff guard;
    ``guard: false`` pins speculation on."""
    raw = config.get("draft")
    if not raw:
        return None, None, 4, True
    spec_k = int(raw.get("specK", 4))
    spec_guard = bool(raw.get("guard", True))
    if raw.get("selfInt8"):
        if raw.get("model") or raw.get("checkpoint") or raw.get("initSeed"):
            raise ValueError("config.draft: selfInt8 takes no model/"
                             "checkpoint/initSeed — it quantizes the "
                             "target")
        if config.get("quant") == "int8":
            raise ValueError("config.draft.selfInt8 with quant=int8 "
                             "drafts with the target itself; use a "
                             "named small draft model instead")
        return quant.quantize_params(params), cfg, spec_k, spec_guard
    dname = str(raw.get("model") or "")
    if dname not in _MODELS:
        raise ValueError(
            f"config.draft.model {dname!r} unknown; choose one of "
            f"{sorted(_MODELS)} or use selfInt8")
    dcfg = _MODELS[dname]()
    if hasattr(dcfg, "n_experts"):
        raise ValueError("config.draft.model must be a dense family "
                         "(the engine drafts dense only)")
    return (_load_params(ctx, llama, dcfg, raw.get("checkpoint"), raw.get("initSeed"), device),
            dcfg, spec_k, spec_guard)


class _Broadcast:
    """Fan a server's completion stream out to every downstream target (and
    close them all), so no consumer step waits for an EOS that went to a
    sibling."""

    def __init__(self, producers):
        self.producers = producers

    def send(self, payload, **kw) -> None:
        for p in self.producers:
            p.send(payload, **kw)

    def close(self) -> None:
        for p in self.producers:
            try:
                p.close()
            except Exception:  # noqa: BLE001 - close the rest regardless
                pass


def serve(ctx, device: DeviceLike = None) -> dict[str, Any]:
    """Engram entrypoint: serve the step's input stream until EOS; returns
    ``{"served": completions}``."""
    config = ctx.config
    hub = config.get("hub")
    if not hub:
        raise ValueError("serving engram needs config.hub (host:port of "
                         "the stream hub carrying this step's input)")
    # topology checks before the model build: a misconfigured step must not
    # pay for a checkpoint restore first
    producers = ctx.open_output_streams()
    if not producers:
        raise ValueError("serving engram has no downstream target to "
                         "emit completions to")
    broadcast = _Broadcast(producers)
    try:
        engine = build_engine(ctx, device)
        consumer = ctx.open_input_stream(str(hub))
    except BaseException:
        # downstream consumers must see EOS even when the build fails
        broadcast.close()
        raise
    return {"served": StreamServer(engine, consumer, broadcast).run()}
