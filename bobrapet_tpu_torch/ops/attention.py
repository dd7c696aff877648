"""Attention: hand-written CUDA flash kernel + plain PyTorch version.

Counterpart of ``bobrapet_tpu/ops/attention.py``. The kernel
(``csrc/flash_attention.cu``) replaces ``flash_attention`` and goes
further than the Pallas kernel: it takes ``q_offset`` and ragged lengths,
so it also carries cached prefill and decode, which the JAX model runs in
XLA (``models/llama.py:_cached_attention``). :func:`flash_route` and
:func:`kv_splits` decide, on the host and from shapes alone, which of its
kernels a call takes and how a decode's keys are split.

:func:`cached_attention` is that XLA function itself: attention over a
whole KV cache with each batch row's valid length in an int32 tensor on
the device. Its kernel (the C entry ``bobra_cached_attention`` of the same
source) takes no length from the host, so a CUDA graph can replay a
greedy decode step while the lengths move.
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
#: packed rows (queries x GQA group) that the decode kernel holds: one
#: m16 tile of the tensor cores
DECODE_ROWS = 16
#: keys of one shared-memory tile, and the most blocks of a thread-block
#: cluster that split one decode's keys
SPLIT_KEYS, MAX_SPLITS = 64, 8

_ARGTYPES = (
    [ctypes.c_void_p] * 4                      # q, k, v, o
    + [ctypes.c_int] * 6                       # b, sq, sk, hq, group, d
    + [ctypes.c_longlong] * 8                  # batch/seq strides of q, k, v, o
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float]  # causal, q_offset, scale
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # splits, dtype, stream
)
_CACHED_ARGTYPES = (
    [ctypes.c_void_p] * 5                      # q, k, v, o, lens
    + [ctypes.c_int] * 6                       # b, sq, cap, hq, group, d
    + [ctypes.c_longlong] * 8                  # batch/seq strides of q, k, v, o
    + [ctypes.c_float]                         # scale
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # splits, dtype, stream
)


def kv_splits(size: int) -> int:
    """Blocks of one thread-block cluster that share a decode's keys: the
    next power of two of ``size`` / 64, between 1 and 8. ``size`` is a
    static bound (Sk, or a block table's capacity), so the host never
    reads a length from the card."""
    tiles = max(1, -(-size // SPLIT_KEYS))
    return min(1 << (tiles - 1).bit_length(), MAX_SPLITS)


def flash_route(sq: int, group: int, dtype: torch.dtype) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that a call takes:
    ``"scalar"`` for fp32 (exact; the tensor cores would run it as TF32),
    ``"decode"`` for bf16 with at most 16 packed rows (Sq x group: one
    tile, keys split across a cluster), ``"rows"`` for bf16 otherwise (64
    packed rows per block)."""
    if dtype == torch.float32:
        return "scalar"
    return "decode" if sq * group <= DECODE_ROWS else "rows"


def check_aligned(name: str, t: torch.Tensor, strides: tuple) -> None:
    """The bf16 kernels copy rows with 16-byte cp.async: the tensor's
    address and the given strides must be multiples of 16 bytes."""
    if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in strides):
        raise ValueError(
            f"{name} needs a 16-byte aligned address and strides of whole 16-byte "
            f"chunks in bf16, got address {t.data_ptr():#x} and strides {t.stride()}")


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
    length goes in without a copy); heads must be packed, and in bf16 the
    addresses and strides 16-byte aligned. The route (:func:`flash_route`)
    and a decode's split (:func:`kv_splits` of Sk) are chosen here from
    shapes; one launch per call. Raises on what the kernel does not take,
    including a tensor that is not on a card; it never computes the plain
    version instead."""
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
    route = flash_route(sq, hq // hkv, q.dtype)
    if route != "scalar":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(f"flash_attention_cuda: {name}", t, (t.stride(0), t.stride(1)))
    splits = kv_splits(sk) if route == "decode" else 0
    scale = 1.0 / math.sqrt(d)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = kernel_function("bobra_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, hq, hq // hkv, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 int(bool(causal)), int(q_offset), float(scale), splits,
                 KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch("flash_attention", err)
    flash_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_cuda.launches = 0


def cached_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lens: torch.Tensor) -> torch.Tensor:
    """Plain attention over a whole cache with device lengths, in fp32: the
    mask of the JAX model's ``_cached_attention``, row by row.

    q: [B, Sq, Hq, D]; k/v: [B, cap, Hkv, D]; lens: [B] integer valid rows.
    Query i of row b sits at ``lens[b] - Sq + i``; a key gets NEG_INF when
    it is past the query or at or past ``lens[b]``. A query that sees no
    key gives zeros, as the kernel defines it."""
    _, sq, hq, d = q.shape
    cap, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float() * (1.0 / math.sqrt(d))
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    n = lens.long()[:, None]                                            # [B, 1]
    q_pos = n - sq + torch.arange(sq, device=q.device)[None, :]         # [B, Sq]
    k_pos = torch.arange(cap, device=q.device)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & (k_pos[None, None, :] < n[:, :, None])
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    seen = mask.any(dim=-1)[:, :, None, None]                           # [B, Sq, 1, 1]
    return torch.where(seen, out, 0.0).to(q.dtype)


def cached_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Launch ``bobra_cached_attention`` (``csrc/flash_attention.cu``): q
    [B, Sq, Hq, D] over a whole cache k/v [B, cap, Hkv, D] with int32
    ``lens [B]`` on the same card. The wrapper never reads ``lens``; in
    bf16 (at most 16 packed rows: the decode core) the keys are split by
    :func:`kv_splits` of the capacity, in fp32 the scalar kernel runs.
    Batch and sequence strides are free, heads packed. Counts into its
    own ``launches`` and into ``flash_attention_cuda.launches`` (a kernel
    of the same source). Raises on what the kernel does not take; it never
    computes the plain version instead."""
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, lens)):
        raise ValueError(
            f"cached_attention_cuda needs q, k, v and lens on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}, {lens.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"cached_attention_cuda takes float32 or bfloat16 q, k, v of one type, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise TypeError(f"cached_attention_cuda takes contiguous int32 lens, got {lens.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, cap, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if tuple(lens.shape) != (b,):
        raise ValueError(f"lens {tuple(lens.shape)} does not match {b} batch rows")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * sq * cap * hq == 0:
        raise ValueError("cached_attention_cuda: empty input")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_packed(name, t)
    route = flash_route(sq, hq // hkv, q.dtype)
    if route == "rows":
        raise ValueError(
            f"cached_attention_cuda takes at most {DECODE_ROWS} packed rows (Sq x group) in "
            f"bf16, got {sq} x {hq // hkv}")
    if route == "decode":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(f"cached_attention_cuda: {name}", t, (t.stride(0), t.stride(1)))
    splits = kv_splits(cap) if route == "decode" else 0
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = kernel_function("bobra_cached_attention", _CACHED_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lens.data_ptr(),
                 b, sq, cap, hq, hq // hkv, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 1.0 / math.sqrt(d), splits, KERNEL_DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    check_launch("cached_attention", err)
    cached_attention_cuda.launches += 1
    flash_attention_cuda.launches += 1
    return out


#: launches of the device-length entry since the count was last set to 0
cached_attention_cuda.launches = 0


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, the kernel otherwise."""
    if q.device.type == "cpu":
        return cached_attention_reference(q, k, v, lens)
    return cached_attention_cuda(q, k, v, lens)


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
