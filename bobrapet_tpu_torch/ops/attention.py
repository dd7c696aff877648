"""Attention: hand-written CUDA flash kernel + plain PyTorch version.

Counterpart of ``bobrapet_tpu/ops/attention.py``. The kernel
(``csrc/flash_attention.cu``) replaces ``flash_attention`` and goes
further than the Pallas kernel: it takes ``q_offset`` and ragged lengths,
so it also carries cached prefill and decode, which the JAX model runs in
XLA (``models/llama.py:_cached_attention``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function

NEG_INF = -1e30
#: head widths the kernel is instantiated for: those of the presets
#: (llama_tiny 32; llama3_1b and llama3_8b 128)
KERNEL_HEAD_DIMS = (32, 128)

_ARGTYPES = (
    [ctypes.c_void_p] * 4                      # q, k, v, o
    + [ctypes.c_int] * 6                       # b, sq, sk, hq, group, d
    + [ctypes.c_longlong] * 8                  # batch/seq strides of q, k, v, o
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]  # causal, q_offset, scale, dtype
    + [ctypes.c_void_p]                        # stream
)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention with GQA, in fp32.

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]. Query token i sits at
    absolute position q_offset + i. kv_mask [B, Sk] marks valid keys
    (padding keys get the NEG_INF bias)."""
    _, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores, NEG_INF)
    if kv_mask is not None:
        scores = torch.where(kv_mask.bool()[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def _check_heads_packed(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 or t.stride(2) != t.shape[-1]:
        raise ValueError(
            f"flash_attention_cuda: {name} needs a contiguous last axis and "
            f"packed heads, got strides {t.stride()}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu``. q: [B, Sq, Hq, D]; k/v:
    [B, Sk, Hkv, D], fp32 or bf16, all on one CUDA device; scores are
    scaled by 1/sqrt(D).

    Batch and sequence strides are free (a KV cache sliced to its valid
    length goes in without a copy); heads must be packed. Raises on what
    the kernel does not take, including a tensor that is not on a card;
    it never computes the plain version instead."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention_cuda needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_cuda takes float32 or bfloat16 q, k, v of one "
            f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if isinstance(q_offset, torch.Tensor) or int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be a host int >= 0, got {q_offset!r}")
    if b * sq * sk * hq == 0:
        raise ValueError("flash_attention_cuda: empty input")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_packed(name, t)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = kernel_function("bobra_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, hq, hq // hkv, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 int(bool(causal)), int(q_offset), float(scale),
                 KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention", err)
    flash_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_cuda.launches = 0


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, the flash kernel
    otherwise (prefill and decode alike). A ``kv_mask`` or an ``sm_scale``
    on a card raises: no caller on the card needs them yet (the embedder,
    which takes a mask, is not ported)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, q_offset=q_offset,
                                   sm_scale=sm_scale, kv_mask=kv_mask)
    if kv_mask is not None or sm_scale is not None:
        raise NotImplementedError("the CUDA flash kernel takes no kv_mask and no sm_scale")
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
