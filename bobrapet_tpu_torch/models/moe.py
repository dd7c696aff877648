"""Mixtral-style sparse Mixture-of-Experts family in PyTorch.

Counterpart of ``bobrapet_tpu/models/moe.py``: the same config presets,
parameter tree and arithmetic. The attention blocks are the dense Llama
ones (:func:`models.llama._attention_block`, through :meth:`MoEConfig.as_llama`);
only the MLP of each layer is replaced by the routed block:

  router:   logits [T, E] = h @ w_router
  route:    top-k experts, gates and capacity slots (:func:`ops.moe_route`)
  gate/up:  act [E, C, F] = silu(x @ w_gate) * (x @ w_up), x each slot's
            token row of h (:func:`ops.moe_gate_up`: the dispatch folded in)
  down:     expert_out [E, C, D] = act @ w_down (:func:`ops.moe_down`)
  combine:  y [T, D] = sum_k gate * expert_out (:func:`ops.moe_combine`)

JAX keeps the routing as one-hot tensors ``[T, E, C]`` contracted with the
activations; the port keeps it as indices (see :mod:`ops.moe_dispatch`),
which on a card are the route, the two expert products and the combine
kernels. The values are JAX's: the rows the products read are h's rows
exactly, the products keep JAX's rounding points, and the combine sums the
same fp32 products. :func:`route_topk` rebuilds JAX's one-hot tensors from
the route for parity.

The forward carries the residual stream and the pending delta as
``models.llama.forward`` does: :func:`moe_mlp_block` takes the norm over
``x + delta`` in one :func:`ops.add_rmsnorm` and returns its own output as
the next delta. JAX's einsums multiply every capacity row, live or empty:
at the no-drop capacity serving requires (``capacity_factor =
n_experts``, C = T * k) that is E times the routed work. On a card the
expert kernels multiply each expert's live rows only (no ``[E, C, D]``
input buffer, no ``torch.bmm``); on the CPU the plain versions run the
dense sequence of JAX's einsums and give their bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.moe_dispatch import moe_aux, moe_combine, moe_route
from ..ops.moe_experts import moe_down, moe_gate_up
from ..ops.rmsnorm import add_rmsnorm
from . import llama
from .llama import LlamaConfig, _attention_block, _device_rows, _freqs_table, _logits


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25  # per-expert token budget multiplier
    max_seq_len: int = 8192
    rope_theta: float = 1_000_000.0
    #: Llama-3.1-style long-context RoPE remap (see llama.LlamaConfig)
    rope_scaling: Optional[tuple] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    #: not a field (JAX's config has none): the LM head is always its own
    #: weight, which the shared ``llama._logits`` reads here
    tie_embeddings = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def capacity(self, tokens: int) -> int:
        """Static per-expert capacity for a given token count."""
        cap = int(math.ceil(tokens * self.experts_per_token
                            * self.capacity_factor / self.n_experts))
        return max(cap, 1)

    def as_llama(self) -> LlamaConfig:
        """Attention-relevant view for reusing the dense attention block."""
        return LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            ffn_hidden=self.ffn_hidden, max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta, rope_scaling=self.rope_scaling,
            norm_eps=self.norm_eps, dtype=self.dtype,
        )


def mixtral_8x7b() -> MoEConfig:
    return MoEConfig()


def moe_tiny(vocab_size: int = 512, max_seq_len: int = 256) -> MoEConfig:
    """Tiny config for tests."""
    return MoEConfig(
        vocab_size=vocab_size, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_hidden=256, n_experts=4, experts_per_token=2,
        max_seq_len=max_seq_len, dtype=torch.float32,
    )


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict[str, Any]:
    """Random weights from ``generator`` (which must live on ``device``),
    in the JAX package's tree layout; expert weights are stacked on a
    leading E axis:

      layers[i].moe.w_router [D, E]
      layers[i].moe.{w_gate, w_up} [E, D, F]
      layers[i].moe.w_down [E, F, D]

    The numbers differ from JAX's (another generator); parity tests carry
    JAX's weights over with :func:`models.bridge.params_from_numpy`. Each
    weight is drawn in fp32 and cast on its own, so the largest transient
    is one fp32 expert stack."""
    device = resolve_device(device)
    std = 1.0 / math.sqrt(cfg.dim)

    def dense(shape, scale=std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(scale).to(cfg.dtype)

    def ones():
        return torch.ones((cfg.dim,), dtype=cfg.dtype, device=device)

    params: dict[str, Any] = {
        "embed": {"weight": dense((cfg.vocab_size, cfg.dim), 1.0)},
        "layers": [],
        "final_norm": {"weight": ones()},
        "lm_head": {"weight": dense((cfg.dim, cfg.vocab_size))},
    }
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    out_scale = std / math.sqrt(2 * cfg.n_layers)
    e, f = cfg.n_experts, cfg.ffn_hidden
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": {"weight": ones()},
            "attn": {
                "wq": dense((cfg.dim, cfg.dim)),
                "wk": dense((cfg.dim, kv_dim)),
                "wv": dense((cfg.dim, kv_dim)),
                "wo": dense((cfg.dim, cfg.dim), out_scale),
            },
            "mlp_norm": {"weight": ones()},
            "moe": {
                "w_router": dense((cfg.dim, e)),
                "w_gate": dense((e, cfg.dim, f)),
                "w_up": dense((e, cfg.dim, f)),
                "w_down": dense((e, f, cfg.dim), out_scale),
            },
        })
    return params


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route_topk(router_logits: torch.Tensor, cfg: MoEConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``route_topk``: ``(dispatch [T, E, C] bool, combine [T, E, C]
    fp32, aux)`` for T flattened tokens, built from :func:`ops.moe_route`
    (for parity; the model runs on the route's indices)."""
    t, e = router_logits.shape
    c = cfg.capacity(t)
    k = cfg.experts_per_token
    expert, slot, gate, _, counts, probsum = moe_route(router_logits, k, c)
    dispatch = torch.zeros((t, e, c), dtype=torch.bool, device=router_logits.device)
    combine = torch.zeros((t, e, c), dtype=torch.float32, device=router_logits.device)
    kept = slot < c
    tok = torch.arange(t, device=router_logits.device)[:, None].expand(t, k)[kept]
    ex, sl = expert.long()[kept], slot.long()[kept]
    dispatch[tok, ex, sl] = True
    combine[tok, ex, sl] = gate[kept]
    return dispatch, combine, moe_aux(counts, probsum, t, k)


def moe_mlp_block(layer: dict[str, Any], x: torch.Tensor, delta: torch.Tensor,
                  cfg: MoEConfig, stats: Optional[list] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed MLP in the delta form of ``llama._mlp_block``: the norm
    over ``x + delta`` (:func:`ops.add_rmsnorm`), route, the gate/up and
    down products over the live rows, combine. Returns ``(x + delta, the block's delta [B,
    S, D] in cfg.dtype)``; the next norm adds the delta. With ``stats`` (a
    list) the route's per-expert ``(counts, probsum, tokens)`` are appended
    for the load-balancing loss (:func:`forward`)."""
    b, s, d = x.shape
    x, h = add_rmsnorm(x, delta, layer["mlp_norm"]["weight"], cfg.norm_eps)
    flat = h.reshape(b * s, d)
    moe = layer["moe"]
    logits = flat @ moe["w_router"]  # [T, E]
    expert, slot, gate, src, counts, probsum = moe_route(
        logits, cfg.experts_per_token, cfg.capacity(b * s))
    if stats is not None:
        stats.append((counts, probsum, b * s))
    act = moe_gate_up(flat, src, counts, moe["w_gate"], moe["w_up"])  # [E, C, F]
    expert_out = moe_down(act, counts, moe["w_down"], b * s)  # [E, C, D]
    y = moe_combine(expert_out, expert, slot, gate)
    return x, y.view(b, s, d).to(cfg.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(
    params: dict[str, Any],
    tokens: torch.Tensor,
    cfg: MoEConfig,
    cache: Optional[list[dict[str, Any]]] = None,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[list[dict[str, Any]]], torch.Tensor]:
    """Token ids [B, S] -> (fp32 logits [B, S, V], cache, the layers'
    summed aux loss). The cache is consumed as ``models.llama.forward``
    consumes it (written in place, host or device cursor), so with a
    device cursor the call reads no host value and can be captured in a
    CUDA graph."""
    stats: list = []
    logits = _forward(params, tokens, cfg, cache, positions, stats)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for counts, probsum, t in stats:
        aux = aux + moe_aux(counts, probsum, t, cfg.experts_per_token)
    return logits, cache, aux


def _forward(params: dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig,
             cache: Optional[list[dict[str, Any]]], positions: Optional[torch.Tensor],
             stats: Optional[list]) -> torch.Tensor:
    """The layers and the LM head: fp32 logits; each layer's route sums go
    into ``stats`` unless it is None (no aux loss: no launches for it)."""
    lcfg = cfg.as_llama()
    freqs = _freqs_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling,
                         tokens.device)
    x = params["embed"]["weight"][tokens].to(cfg.dtype)
    cursor = cache[0]["cursor"] if cache is not None else None
    rows = _device_rows(cache, tokens.shape[1]) if isinstance(cursor, torch.Tensor) else None
    delta = None
    for i, layer in enumerate(params["layers"]):
        layer_cache = cache[i] if cache is not None else None
        x, delta = _attention_block(layer, x, delta, freqs, lcfg, layer_cache, positions, rows)
        x, delta = moe_mlp_block(layer, x, delta, cfg, stats)
    if rows is not None:
        cursor.add_(tokens.shape[1])
    return _logits(params, x, delta, lcfg)


# ---------------------------------------------------------------------------
# KV cache + generation
# ---------------------------------------------------------------------------


def init_cache(cfg: MoEConfig, batch: int, capacity: Optional[int] = None,
               device: DeviceLike = None) -> list[dict[str, Any]]:
    """Same attention-cache shape as the dense family (MoE replaces only
    the MLP)."""
    return llama.init_cache(cfg.as_llama(), batch, capacity, device=device)


def routed_forward(params: dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig,
                    cache: list[dict[str, Any]], positions: torch.Tensor
                    ) -> tuple[torch.Tensor, list[dict[str, Any]]]:
    """:func:`forward` behind llama's ``forward_fn`` signature, without the
    aux loss (which it drops)."""
    return _forward(params, tokens, cfg, cache, positions, None), cache


@torch.no_grad()
def greedy_generate(
    params: dict[str, Any],
    prompt: torch.Tensor,
    cfg: MoEConfig,
    max_new_tokens: int = 32,
    cache_capacity: Optional[int] = None,
    cuda_graph: bool = True,
) -> torch.Tensor:
    """Greedy decode for the MoE family: llama's prefill and decode loop
    (:func:`models.llama.greedy_generate`, one CUDA graph a step on a card)
    with the routed forward plugged in (no copied loop)."""
    return llama.greedy_generate(params, prompt, cfg, max_new_tokens=max_new_tokens,
                                 cache_capacity=cache_capacity, cuda_graph=cuda_graph,
                                 forward_fn=routed_forward)
