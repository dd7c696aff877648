"""Int8 weight-only matrix product: hand-written CUDA kernel + plain version.

Counterpart of the int8 branch of ``bobrapet_tpu/models/quant.py:matmul``:
``x @ (q * scale)`` with the per-column scale factored out of the
contraction, in the JAX order ``(x @ q.astype(x.dtype)) * scale`` (the
product rounded to x's type before the scale multiply). XLA fuses the
widening into the product, so the JAX package never writes a widened weight
to memory; the plain version here does (``q.to(x.dtype)`` is a full bf16
copy of the weight), and the kernel (``csrc/quant_matmul.cu``) does not: it
reads each int8 byte once and widens it in the SM. The dispatch between the
two is the model's hook, ``models/quant.py:matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch

#: output columns of a block of the bf16 kernel, the K rows of one warp's
#: stage, its warps, and the most blocks of a thread-block cluster that
#: split K
QMM_BN, QMM_BK, QMM_WARPS, QMM_MAX_SPLITS = 128, 32, 4, 8

_ARGTYPES = (
    [ctypes.c_void_p] * 4                      # x, q, scale, out
    + [ctypes.c_int] * 3                       # m, n, k
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # splits, dtype, stream
)


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain: ``(x @ q.to(x.dtype)) * scale.to(x.dtype)`` for x [..., K],
    int8 q [K, N] and scale [N]; writes the widened weight first."""
    out = x @ q.to(x.dtype)
    return out * scale.to(x.dtype)


def quant_rows(m: int) -> int:
    """Rows of x a block of the bf16 kernel takes: 16 or 32."""
    return 16 if m <= 16 else 32


def quant_splits(m: int, n: int, k: int, sms: int = 132) -> int:
    """Blocks of a thread-block cluster that split K in the bf16 kernel: 1,
    2, 4 or 8, the smallest that puts at least 0.9 blocks a streaming
    multiprocessor on the grid of (128-column, row) tiles, as long as each
    warp keeps at least two K stages of 32 rows. From the shapes alone.
    (A sweep of every split at the Llama-3-8B decode shapes on the H100
    found this choice the fastest at each; more splits shorten every warp's
    pipeline, fewer leave SMs idle.)"""
    blocks = -(-n // QMM_BN) * -(-m // quant_rows(m))
    k_tiles = -(-k // QMM_BK)
    splits = 1
    while (splits < QMM_MAX_SPLITS and blocks * splits * 10 < 9 * sms
           and k_tiles >= 2 * QMM_WARPS * splits * 2):
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def quant_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/quant_matmul.cu``: ``round(x @ q) * scale`` for x
    [..., K] (fp32 or bf16, contiguous), int8 q [K, N] and scale [N] of x's
    type, both contiguous, all on one CUDA device; K and N multiples of 16.
    Returns [..., N] in x's type. In bf16 the K range is split across a
    cluster of :func:`quant_splits` blocks; one launch per call. Raises on
    what the kernel does not take, including a tensor that is not on a
    card; it never computes the plain version instead."""
    dev = x.get_device()
    if not x.is_cuda or q.get_device() != dev or scale.get_device() != dev:
        raise ValueError(
            f"quant_matmul_cuda needs x, q and scale on one CUDA device, got {x.device}, "
            f"{q.device}, {scale.device}")
    if x.dtype not in KERNEL_DTYPES or scale.dtype != x.dtype or q.dtype != torch.int8:
        raise TypeError(
            f"quant_matmul_cuda takes float32 or bfloat16 x with a scale of its type and an "
            f"int8 weight, got {x.dtype}, {scale.dtype}, {q.dtype}")
    if q.dim() != 2 or x.dim() < 1 or x.shape[-1] != q.shape[0] or tuple(scale.shape) != (
            q.shape[1],):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)} q {tuple(q.shape)} scale {tuple(scale.shape)}")
    k, n = q.shape
    if k % 16 or n % 16:
        raise ValueError(f"quant_matmul_cuda needs K and N multiples of 16, got {k} and {n}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quant_matmul_cuda needs contiguous x, q and scale")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (x.data_ptr() | q.data_ptr()) % 16:
        raise ValueError("quant_matmul_cuda needs 16-byte aligned x and q in bf16")
    m = x.numel() // k if k else 0
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    splits = quant_splits(m, n, k, _sm_count(dev)) if bf16 else 0
    fn = kernel_function("bobra_quant_matmul", _ARGTYPES)
    err = launch(fn, dev, x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 m, n, k, splits, KERNEL_DTYPES[x.dtype])
    check_launch("quant_matmul", err)
    quant_matmul_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
quant_matmul_cuda.launches = 0
