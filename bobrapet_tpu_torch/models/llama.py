"""Llama-3 model family in PyTorch.

Counterpart of ``bobrapet_tpu/models/llama.py``: the same config presets,
the same parameter tree (nested dicts and lists of tensors, so the bridge
carries JAX weights over one to one), the same forward arithmetic and
rounding points. Every attention, prefill and decode, goes through
:func:`ops.attention`. The layer loop carries the residual stream ``x``
and the pending delta of the block before (``x + delta`` not yet taken):
every norm but the first is :func:`ops.add_rmsnorm`, which takes that add
and the norm in one step, and the first is :func:`ops.rmsnorm`. On a card
these launch the port's CUDA kernels, on the CPU their plain versions,
which take the same two torch ops as ``x = x + delta`` then the norm.

The KV cache is updated in place, to save the copy JAX's
``dynamic_update_slice`` makes, and its cursor is advanced in the
caller's dicts. The cursor is a host int (a slice assignment at the
cursor, attention over the valid prefix: the prefill) or, after
:func:`device_cursor`, one int32 tensor [B] on the card shared by every
layer (an index write at each row's cursor, attention over the whole
capacity with device lengths, :func:`ops.cached_attention`): then no
launch of a decode step depends on a host value, and
:class:`GreedyDecoder` replays the step as one CUDA graph
(:mod:`bobrapet_tpu_torch.graphs`), the counterpart of the JAX loop's
``lax.scan``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..graphs import GraphedStep
from ..ops.attention import attention, cached_attention
from ..ops.rmsnorm import add_rmsnorm, rmsnorm
from ..ops.rope import apply_rope, rope_frequencies
from .quant import matmul as _mm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    #: Llama-3.1 long-context RoPE remap: (factor, low_freq_factor,
    #: high_freq_factor, original_max_position_embeddings) or None
    rope_scaling: Optional[tuple] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def param_count(self) -> int:
        emb = self.vocab_size * self.dim
        attn = self.dim * self.dim + 2 * self.dim * (self.n_kv_heads * self.head_dim) + self.dim * self.dim
        mlp = 3 * self.dim * self.ffn_hidden
        norms = 2 * self.dim
        out = 0 if self.tie_embeddings else self.vocab_size * self.dim
        return emb + self.n_layers * (attn + mlp + norms) + self.dim + out


def llama3_8b() -> LlamaConfig:
    """Llama-3-8B (the BASELINE flagship)."""
    return LlamaConfig()


def llama3_1b() -> LlamaConfig:
    """The JAX package's ~1B config, same widths."""
    return LlamaConfig(
        dim=2048, n_layers=16, n_heads=16, n_kv_heads=8, ffn_hidden=5632,
        max_seq_len=4096,
    )


def llama_tiny(vocab_size: int = 512, max_seq_len: int = 256) -> LlamaConfig:
    """Tiny config for tests."""
    return LlamaConfig(
        vocab_size=vocab_size,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        max_seq_len=max_seq_len,
        dtype=torch.float32,
    )


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict[str, Any]:
    """Random weights from ``generator`` (which must live on ``device``),
    in the JAX package's tree layout:

      embed.weight [V, D]
      layers[i].{attn_norm,mlp_norm}.weight [D]
      layers[i].attn.{wq [D, Hq*Dh], wk [D, Hkv*Dh], wv [D, Hkv*Dh], wo [Hq*Dh, D]}
      layers[i].mlp.{w_gate [D, F], w_up [D, F], w_down [F, D]}
      final_norm.weight [D]
      lm_head.weight [D, V] (absent when tie_embeddings)

    The numbers differ from JAX's (another generator); parity tests carry
    JAX's weights over with :func:`models.bridge.params_from_numpy`.
    """
    device = resolve_device(device)
    std = 1.0 / math.sqrt(cfg.dim)

    def dense(shape, scale=std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * scale).to(cfg.dtype)

    def ones():
        return torch.ones((cfg.dim,), dtype=cfg.dtype, device=device)

    params: dict[str, Any] = {
        "embed": {"weight": dense((cfg.vocab_size, cfg.dim), 1.0 / math.sqrt(cfg.dim))},
        "layers": [],
        "final_norm": {"weight": ones()},
    }
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    out_std = std / math.sqrt(2 * cfg.n_layers)
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": {"weight": ones()},
            "attn": {
                "wq": dense((cfg.dim, cfg.dim)),
                "wk": dense((cfg.dim, kv_dim)),
                "wv": dense((cfg.dim, kv_dim)),
                "wo": dense((cfg.dim, cfg.dim), out_std),
            },
            "mlp_norm": {"weight": ones()},
            "mlp": {
                "w_gate": dense((cfg.dim, cfg.ffn_hidden)),
                "w_up": dense((cfg.dim, cfg.ffn_hidden)),
                "w_down": dense((cfg.ffn_hidden, cfg.dim), out_std),
            },
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": dense((cfg.dim, cfg.vocab_size))}
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _freqs_table(head_dim: int, max_seq_len: int, theta: float,
                 scaling: Optional[tuple], device: torch.device) -> torch.Tensor:
    """One RoPE table per (config, device), built once; read-only."""
    return rope_frequencies(head_dim, max_seq_len, theta, scaling, device=device)


def _norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
          cfg: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x + delta, its norm)``; with no pending delta (layer 0's attention
    norm) ``(x, the norm of x)``."""
    if delta is None:
        return x, rmsnorm(x, weight, cfg.norm_eps)
    return add_rmsnorm(x, delta, weight, cfg.norm_eps)


def _qkv(layer: dict[str, Any], x: torch.Tensor, delta: Optional[torch.Tensor],
         freqs: torch.Tensor, cfg: LlamaConfig, positions: Optional[torch.Tensor],
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention norm over ``x + delta``, the q/k/v projections
    [B, S, H, Dh] and RoPE. Returns ``(x + delta, q, k, v)``: the residual
    stream with the pending delta added."""
    b, s, _ = x.shape
    x, h = _norm(x, delta, layer["attn_norm"]["weight"], cfg)
    q = _mm(h, layer["attn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = _mm(h, layer["attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = _mm(h, layer["attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return x, apply_rope(q, freqs, positions), apply_rope(k, freqs, positions), v


def _attention_block(
    layer: dict[str, Any],
    x: torch.Tensor,
    delta: Optional[torch.Tensor],
    freqs: torch.Tensor,
    cfg: LlamaConfig,
    cache: Optional[dict[str, Any]],
    positions: Optional[torch.Tensor],
    rows: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(x + delta, the block's own delta)``: the output
    projection is not yet added to the residual stream; the next norm
    adds it. ``rows`` (a cache with a device cursor): the batch and cache
    row of every new token and each row's valid length after the write,
    from :func:`_device_rows`."""
    b, s, _ = x.shape
    x, q, k, v = _qkv(layer, x, delta, freqs, cfg, positions)
    if rows is not None:
        # write k/v at each batch row's device cursor, attend over the
        # whole capacity up to each row's length
        batch, at, lens = rows
        cache["k"][batch, at] = k.to(cache["k"].dtype)
        cache["v"][batch, at] = v.to(cache["v"].dtype)
        out = cached_attention(q, cache["k"], cache["v"], lens)
    elif cache is not None:
        # write k/v at the cursor and advance it (in place), attend over
        # the valid prefix
        cursor = cache["cursor"]
        end = cursor + s
        if end > cache["k"].shape[1]:
            raise ValueError(f"cache write [{cursor}, {end}) exceeds capacity {cache['k'].shape[1]}")
        cache["k"][:, cursor:end] = k.to(cache["k"].dtype)
        cache["v"][:, cursor:end] = v.to(cache["v"].dtype)
        cache["cursor"] = end
        out = _cached_attention(q, cache["k"], cache["v"], end, cfg)
    else:
        out = attention(q, k, v, causal=True)
    out = out.reshape(b, s, cfg.dim)
    return x, _mm(out, layer["attn"]["wo"])


def _cached_attention(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                      valid_len: int, cfg: LlamaConfig) -> torch.Tensor:
    """Attention over the first ``valid_len`` cache rows.

    JAX masks ``k_pos <= q_pos & k_pos < valid_len`` over the whole cache;
    every masked key gets probability exactly 0 there, so this is causal
    attention over the cache sliced to ``valid_len`` with the queries at
    ``valid_len - s ...``: one flash-kernel launch on a card."""
    s = q.shape[1]
    return attention(q, k_all[:, :valid_len], v_all[:, :valid_len],
                     causal=True, q_offset=valid_len - s)


def _mlp_block(layer: dict[str, Any], x: torch.Tensor, delta: torch.Tensor,
               cfg: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The MLP norm over ``x + delta`` and the MLP. Returns ``(x + delta,
    the MLP's delta)``: its output is not yet added to the residual
    stream; the next norm adds it."""
    x, h = add_rmsnorm(x, delta, layer["mlp_norm"]["weight"], cfg.norm_eps)
    gate = F.silu(_mm(h, layer["mlp"]["w_gate"]).float())
    up = _mm(h, layer["mlp"]["w_up"]).float()
    return x, _mm((gate * up).to(cfg.dtype), layer["mlp"]["w_down"])


def forward(
    params: dict[str, Any],
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    cache: Optional[list[dict[str, Any]]] = None,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[list[dict[str, Any]]]]:
    """Token ids [B, S] -> fp32 logits [B, S, V] (+ the cache).

    Unlike the JAX forward, this one consumes ``cache``: each layer's k/v
    rows are written and its cursor advanced in place, and the same list
    is returned. A caller that needs the cache as it was must copy it
    first. With a device cursor (:func:`device_cursor`) the call reads no
    host value of the cache, so it can be captured in a CUDA graph."""
    freqs = _freqs_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                         cfg.rope_scaling, tokens.device)
    x = params["embed"]["weight"][tokens].to(cfg.dtype)
    cursor = cache[0]["cursor"] if cache is not None else None
    rows = _device_rows(cache, tokens.shape[1]) if isinstance(cursor, torch.Tensor) else None
    delta = None
    for i, layer in enumerate(params["layers"]):
        layer_cache = cache[i] if cache is not None else None
        x, delta = _attention_block(layer, x, delta, freqs, cfg, layer_cache, positions, rows)
        x, delta = _mlp_block(layer, x, delta, cfg)
    if rows is not None:
        cursor.add_(tokens.shape[1])  # the one tensor every layer holds
    return _logits(params, x, delta, cfg), cache


def _device_rows(cache: list[dict[str, Any]], s: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For a cache with a device cursor [B] and ``s`` new tokens a row:
    the batch index [B, 1] and cache row [B, s] of every new token, and
    each row's valid length after the write [B] (int32)."""
    cursor = cache[0]["cursor"]
    if any(c["cursor"] is not cursor for c in cache):
        raise ValueError("a device cursor must be one tensor shared by every layer "
                         "(models.llama.device_cursor)")
    if cursor.dtype != torch.int32 or tuple(cursor.shape) != (cache[0]["k"].shape[0],):
        raise ValueError(f"a device cursor is int32 [B], got {cursor.dtype} "
                         f"{tuple(cursor.shape)}")
    at = cursor.long()[:, None] + torch.arange(s, device=cursor.device)
    batch = torch.arange(cursor.shape[0], device=cursor.device)[:, None]
    return batch, at, cursor + s


def _logits(params: dict[str, Any], x: torch.Tensor, delta: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """The final norm over ``x + delta`` (the last block's pending delta)
    and the LM head: fp32 logits [B, S, V]."""
    _, x = add_rmsnorm(x, delta, params["final_norm"]["weight"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["weight"].T.to(cfg.dtype)
    else:
        logits = _mm(x, params["lm_head"]["weight"])
    return logits.float()


# ---------------------------------------------------------------------------
# KV cache + generation
# ---------------------------------------------------------------------------


def init_cache(cfg: LlamaConfig, batch: int, capacity: Optional[int] = None,
               device: DeviceLike = None) -> list[dict[str, Any]]:
    cap = capacity or cfg.max_seq_len
    device = resolve_device(device)
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return [
        {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "cursor": 0,
        }
        for _ in range(cfg.n_layers)
    ]


def device_cursor(cache: list[dict[str, Any]]) -> torch.Tensor:
    """Turn the cache's host cursor into one int32 tensor [B] on the
    cache's device, shared by every layer; returns it. From then on the
    forward writes and attends at each row's device cursor and advances
    it in place (one launch a forward)."""
    host = {c["cursor"] for c in cache}
    if len(host) != 1 or not isinstance(next(iter(host)), int):
        raise ValueError(f"device_cursor takes a cache with one host cursor, got {host}")
    k = cache[0]["k"]
    cursor = torch.full((k.shape[0],), host.pop(), dtype=torch.int32, device=k.device)
    for c in cache:
        c["cursor"] = cursor
    return cursor


class GreedyDecoder:
    """The decode loop of :func:`greedy_generate` over a prefilled cache.

    ``tok`` [B, 1] int32 holds the tokens to feed next and ``pos`` [B, 1]
    their positions; :meth:`step` runs one forward of ``tok`` and writes
    its argmax back into ``tok``, advancing ``pos`` and the cache's device
    cursor, all in place. So every step is the same launches on the same
    tensors: on a card (``cuda_graph``) the first step runs eagerly and is
    captured, and every later one is a replay of that CUDA graph; on the
    CPU, or with ``cuda_graph=False``, each step runs eagerly."""

    def __init__(self, params: dict[str, Any], cfg: LlamaConfig, cache: list[dict[str, Any]],
                 tok: torch.Tensor, pos: int, cuda_graph: bool = True):
        self.params, self.cfg, self.cache = params, cfg, cache
        device_cursor(cache)
        self.tok = tok.to(torch.int32).reshape(-1, 1).contiguous()
        self.pos = torch.full(self.tok.shape, pos, dtype=torch.long, device=tok.device)
        self._step = GraphedStep(self._forward, self.tok, self.pos, enabled=cuda_graph)

    @torch.no_grad()
    def _forward(self, tok: torch.Tensor, pos: torch.Tensor) -> None:
        logits, _ = forward(self.params, tok, self.cfg, cache=self.cache, positions=pos)
        tok.copy_(logits[:, -1:, :].argmax(dim=-1))
        pos.add_(1)

    def step(self) -> None:
        self._step()


@torch.no_grad()
def greedy_generate(
    params: dict[str, Any],
    prompt: torch.Tensor,
    cfg: LlamaConfig,
    max_new_tokens: int = 32,
    cache_capacity: Optional[int] = None,
    cuda_graph: bool = True,
) -> torch.Tensor:
    """Greedy decode with a KV cache: one prefill, then one forward per
    token, 1 + ``max_new_tokens`` forwards in all (the JAX scan's count;
    the last forward's token is dropped, as there). Returns int32 tokens
    [B, max_new_tokens], as JAX does. The prefill runs eagerly with the
    host cursor; the decode steps go through :class:`GreedyDecoder`, as
    one CUDA graph replayed per step on a card unless ``cuda_graph`` is
    False. Tokens stay on the prompt's device; nothing syncs with the
    host per step."""
    b, prompt_len = prompt.shape
    cap = cache_capacity or min(cfg.max_seq_len, prompt_len + max_new_tokens)
    if prompt_len + max_new_tokens > cap:
        raise ValueError(
            f"prompt_len({prompt_len}) + max_new_tokens({max_new_tokens}) "
            f"exceeds cache capacity {cap}"
        )
    device = prompt.device
    cache = init_cache(cfg, b, cap, device=device)

    positions = torch.arange(prompt_len, device=device).expand(b, prompt_len)
    logits, _ = forward(params, prompt, cfg, cache=cache, positions=positions)
    out = torch.empty((b, max_new_tokens), dtype=torch.int32, device=device)
    if max_new_tokens == 0:
        return out
    decoder = GreedyDecoder(params, cfg, cache, logits[:, -1:, :].argmax(dim=-1), prompt_len,
                            cuda_graph=cuda_graph)
    for i in range(max_new_tokens):
        out[:, i:i + 1].copy_(decoder.tok)
        decoder.step()
    return out
