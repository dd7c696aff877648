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

Training: :func:`attention` on a card, with grad enabled and an input that
requires it, goes through an ``autograd.Function`` whose forward is
:func:`flash_attention_lse_cuda` (in bf16 a persistent warp-specialised
kernel that also writes each row's log-sum-exp, in the dq kernel's work
order: :func:`bwd_dq_items`, :func:`bwd_block_items`) and whose backward is
:func:`flash_attention_backward_cuda` (``csrc/flash_attention_bwd.cu``).
Without grad it calls :func:`flash_attention_cuda` as before.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch, refuse_grad
from .rmsnorm import wide

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


_LSE_ARGTYPES = (
    [ctypes.c_void_p] * 5                      # q, k, v, o, lse
    + [ctypes.c_int] * 6                       # b, sq, sk, hq, group, d
    + [ctypes.c_longlong] * 8                  # batch/seq strides of q, k, v, o
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float]  # causal, q_offset, scale
    + [ctypes.c_int, ctypes.c_void_p]          # dtype, stream
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10                     # q, k, v, o, do, lse, delta, dq, dk, dv
    + [ctypes.c_int] * 8                       # b, sq, sk, hq, group, d, causal, q_offset
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
)


#: the bf16 backward's tiles (``csrc/flash_attention_bwd.cu``): rows of one
#: consumer warpgroup (wgmma's M: keys in the dk/dv kernel, packed rows in
#: the dq kernel), consumer warpgroups a block, and rows of one tile of the
#: ring (wgmma's N: packed q rows in dk/dv, keys in dq)
BWD_WG_ROWS, BWD_CONSUMERS, BWD_TILE = 64, 2, 64
#: rows of one work item: two consumer warpgroups' worth
BWD_ITEM_ROWS = BWD_WG_ROWS * BWD_CONSUMERS


def bwd_tile_rows(group: int) -> int:
    """Packed rows a 64-row tile holds in the bf16 training kernels (the
    backward and the log-sum-exp forward): whole queries of ``group`` heads
    each (64 when the group divides 64)."""
    return BWD_TILE // group * group


def bwd_dkdv_items(b: int, sq: int, sk: int, hkv: int, group: int, causal: bool,
                   q_offset: int) -> list[tuple[tuple[int, int, int], int]]:
    """The dk/dv kernel's work items in the order its blocks take them:
    ``((batch, kv head, key tile of 128), q tiles it reads)``. Item ``i``
    is key tile ``i // (b hkv)``: under the causal mask an earlier key
    tile sees more rows, so the heaviest come first."""
    rows, tile = sq * group, bwd_tile_rows(group)
    n_tiles = -(-rows // tile)
    out = []
    for kt in range(-(-sk // BWD_ITEM_ROWS)):
        first = max(0, kt * BWD_ITEM_ROWS - q_offset) * group if causal else 0
        work = max(0, n_tiles - first // tile)
        out += [((i // hkv, i % hkv, kt), work) for i in range(b * hkv)]
    return out


def bwd_dq_items(b: int, sq: int, sk: int, hkv: int, group: int, causal: bool,
                 q_offset: int) -> list[tuple[tuple[int, int, int], int]]:
    """The dq kernel's work items in the order its blocks take them:
    ``((batch, kv head, row tile of two warpgroups), k/v tiles it reads)``.
    Item ``i`` is row tile ``n - 1 - i // (b hkv)``: under the causal mask
    a later row sees more keys, so the heaviest come first."""
    rows, tile = sq * group, bwd_tile_rows(group)
    n_rt = -(-rows // (BWD_CONSUMERS * tile))
    out = []
    for j in range(n_rt):
        rt = n_rt - 1 - j
        last = min(rows, (rt + 1) * BWD_CONSUMERS * tile) - 1
        kv_len = min(sk, q_offset + last // group + 1) if causal else sk
        out += [((i // hkv, i % hkv, rt), -(-kv_len // BWD_TILE)) for i in range(b * hkv)]
    return out


def bwd_block_items(n_items: int, grid: int) -> list[list[int]]:
    """The items each persistent block of the backward takes: round ``r``
    gives block ``s`` item ``r grid + s`` on even rounds and ``r grid +
    grid - 1 - s`` on odd ones, so a block that took a heavy item in one
    round takes a light one in the next (the items come heaviest first)."""
    out = [[] for _ in range(grid)]
    for r in range(-(-n_items // grid)):
        for s in range(grid):
            i = r * grid + (s if r % 2 == 0 else grid - 1 - s)
            if i < n_items:
                out[s].append(i)
    return out


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
    """Plain attention with GQA, in fp32 (float64 stays float64).

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]. Query token i sits at
    absolute position q_offset + i. kv_mask [B, Sk] marks valid keys
    (padding keys get the NEG_INF bias)."""
    _, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = wide(q) * scale
    kf = wide(k)
    vf = wide(v)
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


def _causal_scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Scaled scores ``[B, Hq, Sq, Sk]`` in fp32 (float64 stays), causally
    masked with NEG_INF; and k's heads repeated over the group."""
    _, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = wide(k).repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", wide(q) * (1.0 / math.sqrt(d)), kf)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores, NEG_INF)
    return scores, kf, group


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  causal: bool = True, q_offset: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: :func:`attention_reference`'s output and each row's
    log-sum-exp of its scaled, masked scores, fp32 ``[B, Hq, Sq]``: the
    plain version of :func:`flash_attention_lse_cuda`."""
    scores, _, _ = _causal_scores(q, k, causal, q_offset)
    return (attention_reference(q, k, v, causal=causal, q_offset=q_offset),
            torch.logsumexp(scores, dim=-1))


def flash_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                                       causal: bool = True, q_offset: int = 0
                                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal GQA attention, without autograd: the
    probabilities recomputed from ``lse`` (``exp(scores - lse)``), ``D =
    rowsum(do * o)``, ``dS = P * (do v^T - D)``; dk and dv of a kv head
    summed over its group's query heads; fp32 (float64 stays), outputs in
    the inputs' types. The plain version of
    :func:`flash_attention_backward_cuda`."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    scores, kf, group = _causal_scores(q, k, causal, q_offset)
    vf = wide(v).repeat_interleave(group, dim=2)
    dof = wide(do)
    p = torch.exp(scores - wide(lse)[..., None])                        # [B, Hq, Sq, Sk]
    delta = (dof * wide(o)).sum(dim=-1).transpose(1, 2)                 # [B, Hq, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, wide(q)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, hkv, group, d).sum(dim=3)
    dv = dv.reshape(b, sk, hkv, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    refuse_grad("flash_attention_cuda", q, k, v)
    dev = q.get_device()
    if not q.is_cuda or k.get_device() != dev or v.get_device() != dev:
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
    err = launch(fn, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, hq, hq // hkv, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 int(bool(causal)), int(q_offset), float(scale), splits, KERNEL_DTYPES[q.dtype])
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
    bf16 the decode core runs (the Sq x group packed rows in tiles of 16,
    one block a tile, so a multi-token verify takes it too) with the keys
    split by :func:`kv_splits` of the capacity, in fp32 the scalar kernel.
    Batch and sequence strides are free, heads packed. Counts into its
    own ``launches`` and into ``flash_attention_cuda.launches`` (a kernel
    of the same source). Raises on what the kernel does not take; it never
    computes the plain version instead."""
    refuse_grad("cached_attention_cuda", q, k, v)
    dev = q.get_device()
    if not q.is_cuda or any(t.get_device() != dev for t in (k, v, lens)):
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
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(f"cached_attention_cuda: {name}", t, (t.stride(0), t.stride(1)))
    splits = kv_splits(cap) if bf16 else 0
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = kernel_function("bobra_cached_attention", _CACHED_ARGTYPES)
    err = launch(fn, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lens.data_ptr(), b, sq, cap, hq, hq // hkv, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 1.0 / math.sqrt(d), splits, KERNEL_DTYPES[q.dtype])
    check_launch("cached_attention", err)
    cached_attention_cuda.launches += 1
    flash_attention_cuda.launches += 1
    return out


#: launches of the device-length entry since the count was last set to 0
cached_attention_cuda.launches = 0


def _check_train_inputs(name: str, q_offset: int, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, *more: torch.Tensor) -> tuple[int, int, int, int, int]:
    """The checks of the training entries (contiguous q, k, v and the
    rest on one card, one type, a kernel head width, a host ``q_offset``
    >= 0, in bf16 a group of at most 64 heads): ``(b, sq, sk, hq, hkv)``.
    Types first, then shapes, then the device."""
    tensors = (q, k, v) + more
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError(f"{name} takes float32 or bfloat16 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * sq * sk * hq == 0:
        raise ValueError(f"{name}: empty input")
    if isinstance(q_offset, torch.Tensor) or int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be a host int >= 0, got {q_offset!r}")
    if q.dtype == torch.bfloat16 and hq // hkv > BWD_TILE:
        raise ValueError(f"{name}: a GQA group of {hq // hkv} heads is above {BWD_TILE}: the "
                         f"bf16 kernels' {BWD_TILE}-row tiles hold whole queries")
    dev = q.get_device()
    if not q.is_cuda or any(t.get_device() != dev for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return b, sq, sk, hq, hkv


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, q_offset: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``bobra_flash_attention_lse`` (``csrc/flash_attention.cu``):
    ``(o, lse)``, the output of :func:`flash_attention_cuda` and each row's
    log-sum-exp of its scaled scores, fp32 ``[B, Hq, Sq]``. bf16 takes
    ``flash_fwd_lse_kernel`` (one launch at any number of packed rows, a
    GQA group of at most 64 heads), fp32 the scalar kernel. q, k, v
    contiguous on one card. Counts into its own ``launches`` only. Raises
    on what the kernel does not take; it never computes the plain version
    instead."""
    refuse_grad("flash_attention_lse_cuda", q, k, v)
    b, sq, sk, hq, hkv = _check_train_inputs("flash_attention_lse_cuda", q_offset, q, k, v)
    d = q.shape[-1]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = kernel_function("bobra_flash_attention_lse", _LSE_ARGTYPES)
    err = launch(fn, q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, sq, sk, hq, hq // hkv, d,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                 int(bool(causal)), int(q_offset), 1.0 / math.sqrt(d), KERNEL_DTYPES[q.dtype])
    check_launch("flash_attention_lse", err)
    flash_attention_lse_cuda.launches += 1
    return out, lse


#: launches of the log-sum-exp entry since the count was last set to 0
flash_attention_lse_cuda.launches = 0


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                                  causal: bool = True, q_offset: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention_bwd.cu``: ``(dq, dk, dv)`` from the
    forward's q, k, v, o, the output gradient ``do`` and ``lse`` of
    :func:`flash_attention_lse_cuda`. Every tensor contiguous on one card,
    q, k, v, o, do of one type, lse fp32. Three launches (D, dk/dv, dq),
    counted as one; deterministic. Raises on what the kernel does not take;
    it never computes the plain version instead."""
    name = "flash_attention_backward_cuda"
    refuse_grad(name, q, k, v, o, do)
    b, sq, sk, hq, hkv = _check_train_inputs(name, q_offset, q, k, v, o, do, lse)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"{name}: o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be fp32 {(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    d = q.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = kernel_function("bobra_flash_attention_backward", _BWD_ARGTYPES)
    err = launch(fn, q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, sq, sk, hq, hq // hkv, d, int(bool(causal)), int(q_offset),
                 1.0 / math.sqrt(d), KERNEL_DTYPES[q.dtype])
    check_launch("flash_attention_backward", err)
    flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


#: launches of the backward since the count was last set to 0
flash_attention_backward_cuda.launches = 0


def flash_backward_parts(parts: int = 0) -> int:
    """The form of P and dS in the bf16 backward's products on the card: 1
    (each rounded to one bf16 part) or 2 (hi + lo parts). Sets it when
    ``parts`` is 1 or 2; returns the form in force. A switch for measuring
    the two forms (``bobra_flash_attention_backward_parts``); launches
    nothing and counts nothing."""
    fn = kernel_function("bobra_flash_attention_backward_parts", [ctypes.c_int])
    return int(fn(int(parts)))


def flash_backward_launches(mask: int = 0) -> int:
    """Which of the bf16 backward's three launches run on the card: bit 0
    D, bit 1 dk/dv, bit 2 dq (7 unless a measurement times one alone; the
    outputs are the gradients only with 7). Sets it when ``mask`` is 1-7;
    returns the mask in force (``bobra_flash_attention_backward_launches``).
    Launches nothing and counts nothing."""
    fn = kernel_function("bobra_flash_attention_backward_launches", [ctypes.c_int])
    return int(fn(int(mask)))


class _FlashAttention(torch.autograd.Function):
    """Attention on a card under autograd: the log-sum-exp forward kernel,
    the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_lse_cuda(q, k, v, causal=causal, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(q, k, v, out, do.contiguous(), lse,
                                                   causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


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
    """Dispatch: the plain version for CPU tensors (autograd differentiates
    it), the flash kernel otherwise (prefill and decode alike): through its
    ``autograd.Function`` (the log-sum-exp forward and the backward kernel)
    when grad is enabled and an input requires it. A ``kv_mask`` or an
    ``sm_scale`` on a card raises: no caller on the card needs them yet
    (the embedder, which takes a mask, is not ported)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, q_offset=q_offset,
                                   sm_scale=sm_scale, kv_mask=kv_mask)
    if kv_mask is not None or sm_scale is not None:
        raise NotImplementedError("the CUDA flash kernel takes no kv_mask and no sm_scale")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
