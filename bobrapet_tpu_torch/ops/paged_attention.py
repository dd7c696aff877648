"""Paged decode attention: hand-written CUDA kernel + plain PyTorch version.

Counterpart of the serving engine's decode attention,
``bobrapet_tpu/serving/engine.py:_paged_attention``. The kernel
(``csrc/paged_attention.cu``) replaces ``_paged_attention_pallas`` (the
TPU's paged_attention kernel) but computes what ``_paged_attention``'s
einsum route computes, the route the JAX engine runs by default: q scaled
by 1/sqrt(D) in fp32 before the dot. The Pallas route passes q unscaled,
so the two JAX routes disagree; the port follows the default one.

Both versions read one layer's pool ``[N, B, Hkv, D]`` through int32
``block_tables [S, MB]`` and ``seq_lens [S]``; a lane with ``seq_len == 0``
gives a zero output.

:func:`paged_attention_multi` takes T queries a slot, q ``[S, T, Hq, D]``:
the counterpart of the speculative engine's XLA
``bobrapet_tpu/serving/spec_decode.py:_paged_attention_multi`` (a verify of
k + 1 tokens, a draft catch-up of a horizon's tokens). Query t of slot s
sits at ``pos0[s] + t`` and attends the cache positions up to its own; the
caller passes ``lens = pos0 + T``, the cached kernel's rule (query i at
``lens - T + i``). Its kernel is the C entry ``bobra_paged_attention_multi``
of the same source; at T = 1 it computes :func:`paged_attention`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch
from .attention import DECODE_ROWS, KERNEL_HEAD_DIMS, NEG_INF, check_aligned, kv_splits

#: q heads per kv head the kernel holds in one block (one tile of rows)
MAX_GROUP = DECODE_ROWS

_ARGTYPES = (
    [ctypes.c_void_p] * 6                      # q, k_pool, v_pool, tables, seq_lens, o
    + [ctypes.c_int] * 7                       # slots, hkv, group, d, block_size, max_blocks, num_blocks
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # scale, splits, dtype, stream
)
_MULTI_ARGTYPES = (
    [ctypes.c_void_p] * 6                      # q, k_pool, v_pool, tables, lens, o
    + [ctypes.c_int] * 8                       # slots, sq, hkv, group, d, block_size, max_blocks,
    #                                            num_blocks
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # scale, splits, dtype, stream
)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each sequence's cache view ``[S, MB * B, Hkv, D]`` of one layer's
    pool, materialised through its block table."""
    k = pool[block_tables.long()]  # [S, MB, B, Hkv, D]
    s, mb, b, h, d = k.shape
    return k.reshape(s, mb * b, h, d)


def paged_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """Plain paged attention, the JAX engine's einsum route.

    q: [S, Hq, D]; pools: [N, B, Hkv, D]; block_tables: [S, MB];
    seq_lens: [S]. Gathers every sequence's view, repeats the kv heads by
    the group, scales q in fp32, masks ``k_pos >= seq_len`` with NEG_INF,
    takes the softmax in fp32 and casts to q's type."""
    _, hq, d = q.shape
    group = hq // k_pool.shape[2]
    kf = gather_pages(k_pool, block_tables).float()
    vf = gather_pages(v_pool, block_tables).float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    qf = q.float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("shd,skhd->shk", qf, kf)
    lens = seq_lens.long()[:, None]
    mask = torch.arange(kf.shape[1], device=q.device)[None, :] < lens
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("shk,skhd->shd", probs, vf)
    # no key at all: zero, as the kernel defines it (JAX would average V)
    out = torch.where(lens[:, :, None] > 0, out, 0.0)
    return out.to(q.dtype)


def paged_attention_cuda(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on one layer's pools, in place.

    q: [S, Hq, D] and pools [N, B, Hkv, D], fp32 or bf16 of one type,
    contiguous; int32 ``block_tables [S, MB]`` and ``seq_lens [S]``, all
    on one CUDA device. The tables and lengths stay on the device: the
    wrapper never reads them, so a decode tick gets no host sync; in bf16
    a sequence's keys are split across a cluster of :func:`kv_splits` of
    the table's capacity blocks, one launch per call. Raises on what the
    kernel does not take, including a tensor that is not on a card; it
    never computes the plain version instead."""
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    dev = q.get_device()
    if not q.is_cuda or any(t.get_device() != dev for t in tensors):
        raise ValueError(
            "paged_attention_cuda needs q, pools, tables and lengths on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in KERNEL_DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_attention_cuda takes float32 or bfloat16 q and pools of one "
            f"type, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(
            f"paged_attention_cuda takes int32 tables and lengths, got "
            f"{block_tables.dtype} and {seq_lens.dtype}")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} {tuple(v_pool.shape)}")
    s, hq, d = q.shape
    n_blocks, block_size, hkv, _ = k_pool.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != s or tuple(seq_lens.shape) != (s,):
        raise ValueError(
            f"tables {tuple(block_tables.shape)} and lengths {tuple(seq_lens.shape)} "
            f"do not match {s} sequences")
    if k_pool.shape[3] != d or hkv == 0 or hq % hkv != 0 or hq // hkv > MAX_GROUP:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda needs contiguous q, pools, tables and lengths")
    if (k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged_attention_cuda needs 16-byte aligned pools")
    if q.dtype == torch.bfloat16:
        check_aligned("paged_attention_cuda: q", q, ())
    out = torch.empty_like(q)
    if s == 0 or block_tables.shape[1] == 0:
        return out.zero_()
    splits = kv_splits(block_tables.shape[1] * block_size) if q.dtype == torch.bfloat16 else 0
    fn = kernel_function("bobra_paged_attention", _ARGTYPES)
    err = launch(fn, dev, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), s, hkv, hq // hkv,
                 d, block_size, block_tables.shape[1], n_blocks, 1.0 / math.sqrt(d), splits,
                 KERNEL_DTYPES[q.dtype])
    check_launch("paged_attention", err)
    paged_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
paged_attention_cuda.launches = 0


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, the kernel otherwise."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables, seq_lens)
    return paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens)


def paged_attention_multi_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lens: torch.Tensor,
) -> torch.Tensor:
    """Plain T-query paged attention, in fp32: JAX's
    ``_paged_attention_multi`` (the einsum over every sequence's gathered
    view, keys past each query's position at NEG_INF).

    q: [S, T, Hq, D]; pools: [N, B, Hkv, D]; block_tables: [S, MB]; lens:
    [S] = pos0 + T, query t of slot s at ``lens[s] - T + t``. The callers'
    queries sit at positions >= 0 (``lens >= T``); a query before position
    0 sees no key and gets zeros here, where the kernel averages V over the
    lane's keys and JAX over the whole view: outside the contract."""
    _, t, hq, d = q.shape
    group = hq // k_pool.shape[2]
    kf = gather_pages(k_pool, block_tables).float()
    vf = gather_pages(v_pool, block_tables).float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    qf = q.float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("sthd,skhd->sthk", qf, kf)
    positions = lens.long()[:, None] - t + torch.arange(t, device=q.device)[None, :]   # [S, T]
    mask = torch.arange(kf.shape[1], device=q.device)[None, None, :] <= positions[:, :, None]
    scores = torch.where(mask[:, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("sthk,skhd->sthd", probs, vf)
    out = torch.where(mask.any(dim=-1)[:, :, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_multi_cuda(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lens: torch.Tensor,
) -> torch.Tensor:
    """Launch ``bobra_paged_attention_multi`` (``csrc/paged_attention.cu``):
    q [S, T, Hq, D] over one layer's pools [N, B, Hkv, D], in place, with
    int32 ``block_tables [S, MB]`` and ``lens [S]`` = pos0 + T on the same
    card; the same checks and split as :func:`paged_attention_cuda` (the
    group at most 16; in bf16 the T x group packed rows go in tiles of 16).
    The wrapper never reads the tables or lengths. Raises on what the
    kernel does not take; it never computes the plain version instead."""
    tensors = (q, k_pool, v_pool, block_tables, lens)
    dev = q.get_device()
    if not q.is_cuda or any(t.get_device() != dev for t in tensors):
        raise ValueError(
            "paged_attention_multi_cuda needs q, pools, tables and lengths on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in KERNEL_DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_attention_multi_cuda takes float32 or bfloat16 q and pools of one "
            f"type, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(
            f"paged_attention_multi_cuda takes int32 tables and lengths, got "
            f"{block_tables.dtype} and {lens.dtype}")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} {tuple(v_pool.shape)}")
    s, t, hq, d = q.shape
    n_blocks, block_size, hkv, _ = k_pool.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != s or tuple(lens.shape) != (s,):
        raise ValueError(
            f"tables {tuple(block_tables.shape)} and lengths {tuple(lens.shape)} "
            f"do not match {s} sequences")
    if k_pool.shape[3] != d or hkv == 0 or hq % hkv != 0 or hq // hkv > MAX_GROUP:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention_multi_cuda needs contiguous q, pools, tables and "
                         "lengths")
    if (k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged_attention_multi_cuda needs 16-byte aligned pools")
    if q.dtype == torch.bfloat16:
        check_aligned("paged_attention_multi_cuda: q", q, ())
    out = torch.empty_like(q)
    if s == 0 or t == 0 or block_tables.shape[1] == 0:
        return out.zero_()
    splits = kv_splits(block_tables.shape[1] * block_size) if q.dtype == torch.bfloat16 else 0
    fn = kernel_function("bobra_paged_attention_multi", _MULTI_ARGTYPES)
    err = launch(fn, dev, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(), s, t, hkv, hq // hkv,
                 d, block_size, block_tables.shape[1], n_blocks, 1.0 / math.sqrt(d), splits,
                 KERNEL_DTYPES[q.dtype])
    check_launch("paged_attention_multi", err)
    paged_attention_multi_cuda.launches += 1
    return out


#: launches of the T-query entry since the count was last set to 0
paged_attention_multi_cuda.launches = 0


def paged_attention_multi(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lens: torch.Tensor,
) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, the kernel otherwise."""
    if q.device.type == "cpu":
        return paged_attention_multi_reference(q, k_pool, v_pool, block_tables, lens)
    return paged_attention_multi_cuda(q, k_pool, v_pool, block_tables, lens)
