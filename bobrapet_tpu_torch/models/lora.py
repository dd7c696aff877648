"""LoRA adapters: low-rank deltas over the Llama weight sites.

Counterpart of ``bobrapet_tpu/models/lora.py``. An adapter holds rank-r
factors (A ``[in, r]``, B ``[r, out]``) whose delta ``scale * (x @ A) @
B`` adds to a target matmul; the base weights (bf16 or int8) are never
touched, so many adapters ride one resident base model.

The layout mirrors the parameter tree: ``{"layers": [{site: {"a",
"b"}}]}`` with sites among wq/wk/wv/wo/w_gate/w_up/w_down. A stacked tree
adds a leading adapter axis to every leaf; the serving engine gathers each
slot's adapter inside the fused decode step (:func:`lora_delta_slots`), so
one step (one CUDA graph) serves any adapter mix. Index 0 is the base
adapter (zeros): a request without an adapter gets exactly the base model.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device

ATTN_SITES = ("wq", "wk", "wv", "wo")
MLP_SITES = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    #: which matmul sites carry adapters
    sites: tuple[str, ...] = ("wq", "wv")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _site_dims(cfg, site: str) -> tuple[int, int]:
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": (cfg.dim, cfg.dim),
        "wk": (cfg.dim, kv_dim),
        "wv": (cfg.dim, kv_dim),
        "wo": (cfg.dim, cfg.dim),
        "w_gate": (cfg.dim, cfg.ffn_hidden),
        "w_up": (cfg.dim, cfg.ffn_hidden),
        "w_down": (cfg.ffn_hidden, cfg.dim),
    }[site]


def init_lora(generator: torch.Generator, cfg, lcfg: LoRAConfig,
              device: DeviceLike = None) -> dict[str, Any]:
    """One adapter: A ~ N(0, 1/r), B = 0 (the delta starts at zero). The
    numbers come from ``generator`` (on ``device``), not JAX's; parity
    tests bridge JAX's trees over instead."""
    device = resolve_device(device)
    layers = []
    for _ in range(cfg.n_layers):
        layer: dict[str, Any] = {}
        for site in lcfg.sites:
            d_in, d_out = _site_dims(cfg, site)
            a = torch.randn((d_in, lcfg.rank), generator=generator, dtype=torch.float32,
                            device=device) / math.sqrt(lcfg.rank)
            layer[site] = {"a": a.to(cfg.dtype),
                           "b": torch.zeros((lcfg.rank, d_out), dtype=cfg.dtype, device=device)}
        layers.append(layer)
    return {"layers": layers}


def zero_lora(cfg, lcfg: LoRAConfig, device: DeviceLike = None) -> dict[str, Any]:
    """The identity adapter (an all-zero delta): stack index 0."""
    device = resolve_device(device)
    layers = []
    for _ in range(cfg.n_layers):
        layer: dict[str, Any] = {}
        for site in lcfg.sites:
            d_in, d_out = _site_dims(cfg, site)
            layer[site] = {"a": torch.zeros((d_in, lcfg.rank), dtype=cfg.dtype, device=device),
                           "b": torch.zeros((lcfg.rank, d_out), dtype=cfg.dtype, device=device)}
        layers.append(layer)
    return {"layers": layers}


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_tree_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def stack_adapters(adapters: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """[adapter trees] -> one tree with a leading adapter axis on every
    leaf (adapter 0 should be :func:`zero_lora`: the engine maps "no
    adapter" there)."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *adapters)


def select_adapter(stacked: dict[str, Any], index: int) -> dict[str, Any]:
    """One adapter's tree out of a stack."""
    return _tree_map(lambda leaf: leaf[index], stacked)


@functools.lru_cache(maxsize=16)
def _scale_in(scale: float, dtype: torch.dtype) -> float:
    """The scale as JAX multiplies by it: rounded to the activations' type."""
    return float(torch.tensor(scale, dtype=dtype))


def lora_delta(x: torch.Tensor, site_lora: Optional[dict[str, Any]],
               scale: float) -> torch.Tensor:
    """``scale * (x @ A) @ B``, two skinny matmuls in x's type; a zero
    scalar when the site has no adapter."""
    if site_lora is None:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    a = site_lora["a"].to(x.dtype)
    b = site_lora["b"].to(x.dtype)
    return ((x @ a) @ b) * _scale_in(scale, x.dtype)


def lora_delta_slots(h: torch.Tensor, site_stack: dict[str, Any], adapter_idx: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The per-slot delta of the fused decode step (the JAX engine's
    ``_lora_delta_slots``, ``bobrapet_tpu/serving/engine.py:2995``): each
    slot gathers its own adapter's factors from the stack by the int
    ``adapter_idx`` [S] on the device, then two batched skinny products.
    h: [S, T, in] -> [S, T, out]."""
    idx = adapter_idx.long()
    a = site_stack["a"][idx].to(h.dtype)  # [S, in, r]
    b = site_stack["b"][idx].to(h.dtype)  # [S, r, out]
    return torch.bmm(torch.bmm(h, a), b) * _scale_in(scale, h.dtype)


def merge_lora(params: dict[str, Any], adapter: dict[str, Any], scale: float) -> dict[str, Any]:
    """Base + delta as plain weights: the reference the serving tests hold
    an adapter's tokens against (serving never materialises this)."""
    out = _tree_map(lambda leaf: leaf, params)
    for layer, lora_layer in zip(out["layers"], adapter["layers"]):
        for site, ab in lora_layer.items():
            tgt = layer["attn"] if site in ATTN_SITES else layer["mlp"]
            w = tgt[site]
            delta = (ab["a"].float() @ ab["b"].float()) * scale
            tgt[site] = (w.float() + delta).to(w.dtype)
    return out
