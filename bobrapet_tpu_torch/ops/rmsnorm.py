"""RMSNorm, alone or fused with the residual add before it: one
hand-written CUDA kernel + plain PyTorch versions.

Counterpart of ``bobrapet_tpu/ops/rmsnorm.py``. The kernel
(``csrc/rmsnorm.cu``) replaces ``rmsnorm_pallas`` but rounds like
``rmsnorm_reference``, the function every model path calls: cast to
``x.dtype`` before the weight multiply. So the dispatcher can sit on the
model path without moving a bf16 greedy token.

Its add mode computes ``s = x + delta`` (rounded to x's type, as torch
rounds the add) and the norm of ``s`` in one launch, returning both: the
model's residual stream and the next block's input.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, delta, w
    ctypes.c_void_p, ctypes.c_void_p,                   # sum_out, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float,    # rows, d, eps
    ctypes.c_int, ctypes.c_void_p,                      # dtype, stream
]


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * w computed in fp32, cast back to x.dtype before
    the weight multiply (the JAX reference's rounding)."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def add_rmsnorm_reference(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                          eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm_reference(s))`` with ``s = x + delta``: the model's two
    steps as they were, so the CPU path keeps its bits."""
    s = x + delta
    return s, rmsnorm_reference(s, weight, eps)


def _launch(name: str, x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
            eps: float) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """Check, then launch ``csrc/rmsnorm.cu`` once: ``(s, y)``, ``s`` None
    in the plain mode. The C entry picks the kernel instance from the
    width and the pointers' alignment.

    Raises on anything the kernel does not take: types first, then shapes
    and aliasing, then the device (a CPU or meta tensor), then the
    layout. It never computes the plain version instead. The steps are
    few and cheap because the model's loops are bound by the host."""
    dt = x.dtype
    if dt not in KERNEL_DTYPES or weight.dtype != dt or (delta is not None and delta.dtype != dt):
        raise TypeError(
            f"{name} takes float32 or bfloat16 x with a weight (and delta) of the "
            f"same type, got {dt}, {weight.dtype}"
            + ("" if delta is None else f" and {delta.dtype}"))
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    dev = x.get_device()
    if delta is not None:
        if delta.shape != x.shape:
            raise ValueError(f"delta shape {tuple(delta.shape)} != x shape {tuple(x.shape)}")
        # same shape and type: overlapping bytes iff the starts are closer
        # than one tensor's size (meta tensors have no memory to share)
        if (delta.get_device() == dev and not x.is_meta and x.numel()
                and abs(x.data_ptr() - delta.data_ptr()) < x.numel() * x.element_size()):
            raise ValueError(f"{name}: x and delta alias (the kernel's pointers are restrict)")
    if not x.is_cuda or weight.get_device() != dev or (
            delta is not None and delta.get_device() != dev):
        raise ValueError(
            f"{name} needs every tensor on one CUDA device, got x on {x.device}, "
            f"weight on {weight.device}" + ("" if delta is None else f", delta on {delta.device}"))
    if not (x.is_contiguous() and weight.is_contiguous()
            and (delta is None or delta.is_contiguous())):
        raise ValueError(f"{name} needs contiguous tensors")

    out = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return s, out
    fn = kernel_function("bobra_rmsnorm", _ARGTYPES)
    # null delta and sum_out select the plain mode
    args = (x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(),
            None if s is None else s.data_ptr(), out.data_ptr(), rows, d, float(eps),
            KERNEL_DTYPES[dt])
    check_launch("rmsnorm", launch(fn, dev, *args))
    rmsnorm_cuda.launches += 1
    return s, out


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` over the last axis of a CUDA tensor.

    Takes fp32 or bf16 with a weight of the same type, rows contiguous.
    Raises on anything else, including a tensor that is not on a card;
    it never computes the plain version instead."""
    return _launch("rmsnorm_cuda", x, None, weight, eps)[1]


def add_rmsnorm_cuda(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's add mode: ``(s, y)`` with ``s = x + delta`` rounded to
    x's type and ``y`` the norm of ``s``, both fresh tensors, in one
    launch. x and delta: one type and shape, on one card, contiguous, not
    sharing memory. Counts into ``rmsnorm_cuda.launches`` (the same
    kernel) and into its own ``launches``."""
    s, y = _launch("add_rmsnorm_cuda", x, delta, weight, eps)
    add_rmsnorm_cuda.launches += 1
    return s, y


#: launches of the kernel (both modes) since the count was last set to 0
rmsnorm_cuda.launches = 0
#: launches of the add mode alone
add_rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Dispatch: the plain version for a CPU tensor, the kernel otherwise."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    return rmsnorm_cuda(x, weight, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: ``(x + delta, its norm)``, the plain version for a CPU
    tensor, the kernel's add mode otherwise."""
    if x.device.type == "cpu":
        return add_rmsnorm_reference(x, delta, weight, eps)
    return add_rmsnorm_cuda(x, delta, weight, eps)
