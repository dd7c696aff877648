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

The kernel has three routes (:func:`quant_route`): D streams the weight
for small bf16 products (decode, verify, catch-up), P multiplies larger
bf16 products on wgmma tiles (prefill), F is the exact fp32 route (the
cross-checks).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch, refuse_grad

#: output columns of a block of the bf16 kernel, the K rows of one warp's
#: stage, its warps, and the most blocks of a thread-block cluster that
#: split K: the block grid :func:`quant_splits` counts with
QMM_BN, QMM_BK, QMM_WARPS, QMM_MAX_SPLITS = 128, 32, 4, 8
#: route codes of the C entry (``csrc/quant_matmul.cu``: kRouteF, kRouteD, kRouteP)
ROUTE_CODES = {"F": 0, "D": 1, "P": 2}
#: route D takes every bf16 product of up to QMM_DECODE_ROWS rows and
#: route P every one above QMM_CROSSOVER; between them route P takes the
#: products with enough tiles (:func:`quant_route`)
QMM_DECODE_ROWS, QMM_CROSSOVER = 32, 128
#: route P's rows of x a tile, and the weight columns of one of its
#: consumer warpgroups (a tile has one or two: :func:`prefill_tile`)
PREFILL_BM, PREFILL_COLS = 128, 128
#: route F's block: columns and rows of x
F32_COLS, F32_ROWS, F32_CHUNK = 256, 8, 128
#: the C entry's flag for programmatic dependent launch
FLAG_PDL = 1

_ARGTYPES = (
    [ctypes.c_void_p] * 4                      # x, q, scale, out
    + [ctypes.c_int] * 3                       # m, n, k
    + [ctypes.c_int] * 4                       # route, splits, tile, flags
    + [ctypes.c_int, ctypes.c_void_p]          # dtype, stream
)


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain: ``(x @ q.to(x.dtype)) * scale.to(x.dtype)`` for x [..., K],
    int8 q [K, N] and scale [N]; writes the widened weight first."""
    out = x @ q.to(x.dtype)
    return out * scale.to(x.dtype)


def quant_rows(m: int) -> int:
    """Rows of x one block tile counts for the cluster split rule: 16 or 32
    (route D's blocks take :func:`decode_rows`, at most as many)."""
    return 16 if m <= 16 else 32


def quant_splits(m: int, n: int, k: int, sms: int = 132) -> int:
    """Blocks of a thread-block cluster that split K in route D: 1, 2, 4 or
    8, the smallest that puts at least 0.9 blocks a streaming multiprocessor
    on the grid of (128-column, row) tiles, as long as each of four warps
    keeps at least two K stages of 32 rows. From the shapes alone. (A sweep
    of every split at the Llama-3-8B decode shapes on the H100 found this
    choice the fastest at each; more splits shorten every block's stream,
    fewer leave SMs idle.)"""
    blocks = -(-n // QMM_BN) * -(-m // quant_rows(m))
    k_tiles = -(-k // QMM_BK)
    splits = 1
    while (splits < QMM_MAX_SPLITS and blocks * splits * 10 < 9 * sms
           and k_tiles >= 2 * QMM_WARPS * splits * 2):
        splits *= 2
    return splits


def quant_route(m: int, n: int, dtype: torch.dtype, sms: int = 132) -> str:
    """The kernel's route for x [M, K] @ q [K, N]: "F" in float32; in bf16
    "D" up to :data:`QMM_DECODE_ROWS` rows, "P" above :data:`QMM_CROSSOVER`,
    and between them "P" where its tiles of 128 rows by 256 weight columns
    number at least 0.4 of the card's SMs, else "D". (The sweep on the
    H100, at 40 to 128 rows:
    route P takes w_gate's [4096, 14336] (56 tiles) in 63-65 us against
    route D's 65-120, and the LM head at 64 rows in 253 against 452; on
    wq's [4096, 4096] and w_down's [14336, 4096] (16 tiles) route D is
    faster up to 128 rows, 25-36 against 61-63 us.)"""
    if dtype == torch.float32:
        return "F"
    if m <= QMM_DECODE_ROWS:
        return "D"
    if m > QMM_CROSSOVER:
        return "P"
    tiles = -(-m // PREFILL_BM) * -(-n // (2 * PREFILL_COLS))
    return "P" if 5 * tiles >= 2 * sms else "D"


def decode_rows(m: int) -> int:
    """Route D's rows of x a block: 8, 16 or 32 (M = 8 is one n8 tile, no
    padding); above 32 the rows take tiles of 32 on the grid."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


def decode_grid(m: int, n: int, k: int, sms: int = 132) -> tuple[int, int, int]:
    """Route D's grid: (cluster split, row tiles, column tiles); the row
    tiles of one column tile are launched next to each other."""
    return quant_splits(m, n, k, sms), -(-m // decode_rows(m)), -(-n // QMM_BN)


def prefill_tile(m: int, n: int, sms: int = 132) -> int:
    """Route P's weight columns a tile: 256 (two consumer warpgroups, each
    int8 tile widened once for 128 rows and shared memory traffic halved
    for B) when that grid holds more than half a wave, else 128 (one
    warpgroup: twice the tiles on the card)."""
    tiles = -(-m // PREFILL_BM) * -(-n // (2 * PREFILL_COLS))
    return 2 * PREFILL_COLS if 2 * tiles > sms else PREFILL_COLS


def prefill_grid(m: int, n: int, sms: int = 132) -> tuple[int, int]:
    """Route P's grid: (row tiles, column tiles), the row tiles fastest, so
    the blocks that read one weight tile run together and the tile leaves
    device memory once."""
    return -(-m // PREFILL_BM), -(-n // prefill_tile(m, n, sms))


def f32_splits(m: int, n: int, k: int, sms: int = 132) -> int:
    """Route F's cluster split of K: 1, 2, 4 or 8, the smallest that puts at
    least 0.9 blocks an SM on the grid of (256-column, 8-row) tiles while
    each block keeps two chunks of 128 K rows."""
    blocks = -(-n // F32_COLS) * -(-m // F32_ROWS)
    chunks = -(-k // F32_CHUNK)
    splits = 1
    while splits < QMM_MAX_SPLITS and blocks * splits * 10 < 9 * sms and chunks >= 4 * splits:
        splits *= 2
    return splits


def route_args(route: str, m: int, n: int, k: int, sms: int = 132) -> tuple[int, int]:
    """(splits, tile) of the C entry for a route: D's cluster split and rows
    a block, P's 1 and weight columns a tile, F's cluster split and 0."""
    if route == "D":
        return quant_splits(m, n, k, sms), decode_rows(m)
    if route == "P":
        return 1, prefill_tile(m, n, sms)
    return f32_splits(m, n, k, sms), 0


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def quant_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/quant_matmul.cu``: ``round(x @ q) * scale`` for x
    [..., K] (fp32 or bf16, contiguous), int8 q [K, N] and scale [N] of x's
    type, both contiguous, all on one CUDA device; K and N multiples of 16,
    q 16-byte aligned (and x in bf16). Returns [..., N] in x's type. One
    launch per call, on the route :func:`quant_route` picks, counted in
    ``quant_matmul_cuda.launches`` and ``quant_matmul_cuda.routes``. Raises
    on what the kernel does not take, including a tensor that is not on a
    card; it never computes the plain version instead."""
    refuse_grad("quant_matmul_cuda", x, scale)
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
    if q.data_ptr() % 16 or (bf16 and x.data_ptr() % 16):
        raise ValueError("quant_matmul_cuda needs a 16-byte aligned q, and x in bf16")
    m = x.numel() // k if k else 0
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    sms = _sm_count(dev)
    route = quant_route(m, n, x.dtype, sms)
    splits, tile = route_args(route, m, n, k, sms)
    fn = kernel_function("bobra_quant_matmul", _ARGTYPES)
    err = launch(fn, dev, x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 m, n, k, ROUTE_CODES[route], splits, tile,
                 FLAG_PDL if quant_matmul_cuda.pdl else 0, KERNEL_DTYPES[x.dtype])
    check_launch("quant_matmul", err)
    quant_matmul_cuda.launches += 1
    quant_matmul_cuda.routes[route] += 1
    return out


#: launches of the kernel since the count was last set to 0, and of each route
quant_matmul_cuda.launches = 0
quant_matmul_cuda.routes = {"D": 0, "P": 0, "F": 0}
#: launch with programmatic dependent launch (the next product's weight
#: stream overlaps the end of the kernel before it)
quant_matmul_cuda.pdl = True
