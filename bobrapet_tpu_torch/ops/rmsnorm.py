"""RMSNorm: hand-written CUDA kernel + plain PyTorch version.

Counterpart of ``bobrapet_tpu/ops/rmsnorm.py``. The kernel
(``csrc/rmsnorm.cu``) replaces ``rmsnorm_pallas`` but rounds like
``rmsnorm_reference``, the function every model path calls: cast to
``x.dtype`` before the weight multiply. So the dispatcher can sit on the
model path without moving a bf16 greedy token.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float,    # rows, d, eps
    ctypes.c_int, ctypes.c_void_p,                      # dtype, stream
]


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * w computed in fp32, cast back to x.dtype before
    the weight multiply (the JAX reference's rounding)."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` over the last axis of a CUDA tensor.

    Takes fp32 or bf16 with a weight of the same type, rows contiguous.
    Raises on anything else, including a tensor that is not on a card;
    it never computes the plain version instead."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(
            f"rmsnorm_cuda needs x and weight on one CUDA device, got "
            f"{x.device} and {weight.device}")
    if x.dtype not in KERNEL_DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm_cuda takes float32 or bfloat16 x with a weight of the "
            f"same type, got {x.dtype} and {weight.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and weight")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    fn = kernel_function("bobra_rmsnorm", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), KERNEL_DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    check_launch("rmsnorm", err)
    rmsnorm_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Dispatch: the plain version for a CPU tensor, the kernel otherwise."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    return rmsnorm_cuda(x, weight, eps)
