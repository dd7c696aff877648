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

The backward (``csrc/rmsnorm_bwd.cu``) is JAX's VJP of
``rmsnorm_reference``; :func:`rmsnorm` and :func:`add_rmsnorm` reach the
two kernels through ``torch.autograd.Function``s on a card when grad is
enabled and an input requires it, and call the forward kernel directly
otherwise, so serving pays no autograd cost.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch, refuse_grad

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, delta, w
    ctypes.c_void_p, ctypes.c_void_p,                   # sum_out, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float,    # rows, d, eps
    ctypes.c_int, ctypes.c_void_p,                      # dtype, stream
]
_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dy, x, w, ds
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                   # dx, dw, partial
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,      # rows, d, eps, blocks
    ctypes.c_int, ctypes.c_void_p,                                       # dtype, stream
]
#: rows of one block of the backward (each block's weight-gradient partial
#: sum covers a run of this many rows), and the most blocks
NORM_BWD_ROWS, NORM_BWD_MAX_BLOCKS = 16, 1024


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or in its own type where that is wider (float64, so
    that ``gradcheck`` can hold a plain backward against its forward)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * w computed in fp32 (float64 stays float64), cast
    back to x.dtype before the weight multiply (the JAX reference's
    rounding)."""
    xf = wide(x)
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def add_rmsnorm_reference(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                          eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm_reference(s))`` with ``s = x + delta``: the model's two
    steps as they were, so the CPU path keeps its bits."""
    s = x + delta
    return s, rmsnorm_reference(s, weight, eps)


def rmsnorm_backward_reference(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                               eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)``: JAX's VJP of :func:`rmsnorm_reference` at ``x`` for the
    output gradient ``dy``, without autograd. The norm is cast to x's type
    before the weight product, so the gradient passes through a product in
    x's type (``dy * w``, and ``dy * n`` for the weight, summed over every
    row in fp32) and through that cast."""
    xf = wide(x)
    d = x.shape[-1]
    ms = (xf * xf).mean(dim=-1, keepdim=True) + eps
    scale = torch.rsqrt(ms)
    n = (xf * scale).to(x.dtype)
    dn = wide(dy * weight)
    dw = wide(dy * n).reshape(-1, d).sum(dim=0).to(weight.dtype)
    c = (dn * xf).sum(dim=-1, keepdim=True)
    dsum = c * (-0.5 * (scale / ms)) / d
    return (dn * scale + 2.0 * dsum * xf).to(x.dtype), dw


def add_rmsnorm_backward_reference(ds: Optional[torch.Tensor], dy: torch.Tensor, s: torch.Tensor,
                                   weight: torch.Tensor, eps: float = 1e-5
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`add_rmsnorm_reference` from the gradients of
    its two outputs ``(s, norm(s))``: the norm's input gradient plus ``ds``
    (added in x's type), which is the gradient of both ``x`` and
    ``delta``. ``ds`` None: ``s`` was not used."""
    dx, dw = rmsnorm_backward_reference(dy, s, weight, eps)
    return (dx if ds is None else dx + ds), dw


def norm_backward_blocks(rows: int) -> int:
    """Blocks of the backward kernel for ``rows`` rows: one a run of
    ``NORM_BWD_ROWS``, at most ``NORM_BWD_MAX_BLOCKS``. From the rows alone,
    so the weight gradient's sums do not depend on the card."""
    return max(1, min(-(-rows // NORM_BWD_ROWS), NORM_BWD_MAX_BLOCKS))


def _launch(name: str, x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
            eps: float) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """Check, then launch ``csrc/rmsnorm.cu`` once: ``(s, y)``, ``s`` None
    in the plain mode. The C entry picks the kernel instance from the
    width and the pointers' alignment.

    Raises on anything the kernel does not take: types first, then shapes
    and aliasing, then the device (a CPU or meta tensor), then the
    layout. It never computes the plain version instead. The steps are
    few and cheap because the model's loops are bound by the host."""
    refuse_grad(name, x, delta, weight)
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


def rmsnorm_backward_cuda(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                          eps: float = 1e-5, ds: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/rmsnorm_bwd.cu``: ``(dx, dw)`` of the norm of ``x``
    (the forward's input; ``s`` in the add mode) for the output gradient
    ``dy``, plus ``ds`` when given (the add mode: the gradient of ``s``).
    Every tensor of one type (fp32 or bf16) on one card, contiguous. Two
    launches (the rows, the weight gradient's reduce), counted as one.
    Raises on anything else; it never computes the plain version instead."""
    name = "rmsnorm_backward_cuda"
    refuse_grad(name, dy, x, weight, ds)
    dt = x.dtype
    if (dt not in KERNEL_DTYPES or dy.dtype != dt or weight.dtype != dt
            or (ds is not None and ds.dtype != dt)):
        raise TypeError(f"{name} takes float32 or bfloat16 dy, x, weight (and ds) of one type, "
                        f"got {dy.dtype}, {dt}, {weight.dtype}"
                        + ("" if ds is None else f" and {ds.dtype}"))
    d = x.shape[-1]
    if weight.shape != (d,) or dy.shape != x.shape or (ds is not None and ds.shape != x.shape):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}" + ("" if ds is None else f", ds {tuple(ds.shape)}"))
    dev = x.get_device()
    if not x.is_cuda or any(t.get_device() != dev for t in (dy, weight) + (() if ds is None else (ds,))):
        raise ValueError(f"{name} needs every tensor on one CUDA device, got dy on {dy.device}, "
                         f"x on {x.device}, weight on {weight.device}")
    if not all(t.is_contiguous() for t in (dy, x, weight) + (() if ds is None else (ds,))):
        raise ValueError(f"{name} needs contiguous tensors")
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    blocks = norm_backward_blocks(rows)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    fn = kernel_function("bobra_rmsnorm_backward", _BWD_ARGTYPES)
    err = launch(fn, dev, dy.data_ptr(), x.data_ptr(), weight.data_ptr(),
                 None if ds is None else ds.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                 partial.data_ptr(), rows, d, float(eps), blocks, KERNEL_DTYPES[dt])
    check_launch("rmsnorm_backward", err)
    rmsnorm_backward_cuda.launches += 1
    return dx, dw


def add_rmsnorm_backward_cuda(ds: Optional[torch.Tensor], dy: torch.Tensor, s: torch.Tensor,
                              weight: torch.Tensor, eps: float = 1e-5
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The add mode's backward: ``(dx, dw)`` with ``dx`` the gradient of
    both ``x`` and ``delta``, from the gradients ``ds`` (None: ``s`` not
    used) and ``dy`` of the forward's two outputs and its ``s``. Counts into
    ``rmsnorm_backward_cuda.launches`` (the same kernel) and its own."""
    refuse_grad("add_rmsnorm_backward_cuda", ds, dy, s, weight)
    out = rmsnorm_backward_cuda(dy, s, weight, eps, ds=ds)
    add_rmsnorm_backward_cuda.launches += 1
    return out


#: launches of the backward (both modes) since the count was last set to 0
rmsnorm_backward_cuda.launches = 0
#: launches of the add mode's backward alone
add_rmsnorm_backward_cuda.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The plain mode on a card: the forward kernel, its backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_cuda(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_backward_cuda(dy.contiguous(), x, weight, ctx.eps)
        return dx, dw, None


class _AddRMSNorm(torch.autograd.Function):
    """The add mode on a card: ``(s, norm(s))`` from the forward kernel; the
    backward kernel gives ``x`` and ``delta`` the same gradient, the norm's
    plus that of ``s`` (None where ``s`` was not used: the final norm)."""

    @staticmethod
    def forward(ctx, x, delta, weight, eps):
        s, y = add_rmsnorm_cuda(x, delta, weight, eps)
        ctx.save_for_backward(s, weight)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, weight = ctx.saved_tensors
        if dy is None:
            return ds, ds, None, None
        dx, dw = add_rmsnorm_backward_cuda(None if ds is None else ds.contiguous(),
                                           dy.contiguous(), s, weight, ctx.eps)
        return dx, dx, dw, None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Dispatch: the plain version for a CPU tensor (autograd differentiates
    it); on a card the kernel, through its ``autograd.Function`` when grad
    is enabled and an input requires it."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    if _needs_grad(x, weight):
        return _RMSNorm.apply(x, weight, eps)
    return rmsnorm_cuda(x, weight, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: ``(x + delta, its norm)``, the plain version for a CPU
    tensor, the kernel's add mode otherwise (through its
    ``autograd.Function`` when grad is enabled and an input requires it)."""
    if x.device.type == "cpu":
        return add_rmsnorm_reference(x, delta, weight, eps)
    if _needs_grad(x, delta, weight):
        return _AddRMSNorm.apply(x, delta, weight, eps)
    return add_rmsnorm_cuda(x, delta, weight, eps)
