"""The sparse-MoE block's expert products over the live capacity rows: two
hand-written CUDA kernels (``csrc/moe_experts.cu``) and their plain
PyTorch versions.

Counterpart of the expert einsums of ``bobrapet_tpu/models/moe.py``'s
``moe_mlp_block`` (and of the dispatch einsum before them), which XLA
fuses; the JAX package has no Pallas kernel there. With the route's
``src [E, C]`` (the token in each capacity slot, -1 where empty) and
``counts [E]`` (:mod:`ops.moe_dispatch`), expert e's live rows are its slots
``0 .. n_e - 1``, ``n_e = min(counts[e], C)``:

- :func:`moe_gate_up`: ``act [E, C, F]``, row (e, c) ``bf16(silu(f32(g)) *
  f32(u))`` with ``g = bf16(x @ w_gate[e])``, ``u = bf16(x @ w_up[e])`` and
  x the token ``src[e, c]``'s row of ``h`` (JAX's rounding points; in fp32
  the casts are no-ops);
- :func:`moe_down`: ``out [E, C, D]``, row (e, c) ``act[e, c] @ w_down[e]``
  cast to the model's type.

The plain versions run the dense sequence the model ran before these
kernels (:func:`ops.moe_dispatch_reference`, ``torch.bmm`` over every
capacity row, the fp32 SiLU and product) and then zero the rows at or past
``n_e``, so on the CPU their live rows are those bits exactly. The kernels
multiply the live rows only and write nothing else: on a card the rows at
or past ``n_e`` are left as they were (the combine never reads them). The
bf16 kernels sum in another order than cuBLAS; fp32 runs exact FMAs, no
TF32.

On the card a wrapper launches its kernel or raises; on the CPU the
dispatchers run the plain versions. The C entries pick the kernel's route
from the capacity C (bf16: the operands swapped at C <= 16, else 128-row
tiles), never from ``counts``, so a launch reads nothing back and can be
captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch, refuse_grad
from .moe_dispatch import moe_dispatch_reference

_GATE_UP_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, src, counts
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w_gate, w_up, act
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # tokens, n_experts, capacity
    ctypes.c_int, ctypes.c_int,                         # d, f
    ctypes.c_int, ctypes.c_void_p,                      # dtype, stream
]
_DOWN_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # act, counts, w_down
    ctypes.c_void_p,                                    # out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # tokens, n_experts, capacity
    ctypes.c_int, ctypes.c_int,                         # f, d
    ctypes.c_int, ctypes.c_void_p,                      # dtype, stream
]
#: bf16 widths are multiples of one stage's K rows and one TMA box's
#: columns (``kBK``, ``kBoxCols``)
BF16_WIDTH_MULTIPLE = 64


def live_rows(counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """``[E, C]`` bool: slot c of expert e is live (``c < min(counts[e], C)``)."""
    slots = torch.arange(capacity, device=counts.device)
    return slots[None, :] < counts.clamp_max(capacity)[:, None]


def moe_gate_up_reference(h: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
                          w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """The plain gate/up product: ``act [E, C, F]`` in ``h``'s type, zeros at
    or past each expert's ``n_e``; see the module docstring."""
    expert_in = moe_dispatch_reference(h, src)  # [E, C, D]
    act = F.silu(torch.bmm(expert_in, w_gate).float())
    up = torch.bmm(expert_in, w_up).float()
    act = (act * up).to(h.dtype)
    act[~live_rows(counts, src.shape[1])] = 0
    return act


def moe_down_reference(act: torch.Tensor, counts: torch.Tensor, w_down: torch.Tensor,
                       tokens: int | None = None) -> torch.Tensor:
    """The plain down product: ``out [E, C, D]`` in ``act``'s type, zeros at
    or past each expert's ``n_e``. ``tokens`` (the route's T) only bounds
    the kernel's grid; the plain version multiplies every row."""
    out = torch.bmm(act, w_down)
    out[~live_rows(counts, act.shape[1])] = 0
    return out


def _check(name: str, tensors: dict, device: torch.device, dtype: torch.dtype) -> None:
    for what, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if what not in ("src", "counts") and t.dtype != dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, not {dtype}")


def _check_route(name: str, src, counts, e: int, c: int) -> None:
    if src is not None and (src.dtype != torch.int32 or tuple(src.shape) != (e, c)):
        raise ValueError(f"{name}: src must be int32 [{e}, {c}], got {src.dtype} "
                         f"{tuple(src.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (e,):
        raise ValueError(f"{name}: counts must be int32 [{e}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")


def _check_widths(name: str, dtype: torch.dtype, *widths: int) -> None:
    if dtype == torch.bfloat16 and any(w % BF16_WIDTH_MULTIPLE for w in widths):
        raise ValueError(f"{name}: bf16 widths must be multiples of {BF16_WIDTH_MULTIPLE}, "
                         f"got {widths}")


def moe_gate_up_cuda(h: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Launch the gate/up kernel: ``h [T, D]`` and ``w_gate``, ``w_up [E, D,
    F]`` of one type (fp32 or bf16; bf16 widths multiples of 64), the route's
    ``src [E, C]`` and ``counts [E]`` int32, all contiguous on one card;
    returns ``act [E, C, F]`` with only the live rows written. ``src``'s live
    entries must be rows of ``h``, each at most once an expert (the route's
    are: no expert has more than T live rows). Raises on anything else; it
    never computes the plain version instead."""
    refuse_grad("moe_gate_up_cuda", h, w_gate, w_up)
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_gate_up_cuda takes float32 or bfloat16 rows, got {h.dtype}")
    if (h.dim() != 2 or w_gate.dim() != 3 or w_up.shape != w_gate.shape or src.dim() != 2
            or w_gate.shape[1] != h.shape[1]):
        raise ValueError(f"moe_gate_up_cuda takes h [T, D], w_gate and w_up [E, D, F] and src "
                         f"[E, C], got {tuple(h.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)} and {tuple(src.shape)}")
    e, d, f = w_gate.shape
    c = src.shape[1]
    _check_route("moe_gate_up_cuda", src, counts, e, c)
    _check_widths("moe_gate_up_cuda", h.dtype, d, f)
    if not h.is_cuda:
        raise ValueError(f"moe_gate_up_cuda needs h on a CUDA device, got {h.device}")
    _check("moe_gate_up_cuda", {"h": h, "src": src, "counts": counts, "w_gate": w_gate,
                                "w_up": w_up}, h.device, h.dtype)
    act = torch.empty((e, c, f), dtype=h.dtype, device=h.device)
    if h.shape[0] == 0 or act.numel() == 0:
        return act
    fn = kernel_function("bobra_moe_gate_up", _GATE_UP_ARGTYPES)
    check_launch("moe_gate_up", launch(
        fn, h.get_device(), h.data_ptr(), src.data_ptr(), counts.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), act.data_ptr(), h.shape[0], e, c, d, f, KERNEL_DTYPES[h.dtype]))
    moe_gate_up_cuda.launches += 1
    return act


def moe_down_cuda(act: torch.Tensor, counts: torch.Tensor, w_down: torch.Tensor,
                  tokens: int | None = None) -> torch.Tensor:
    """Launch the down kernel: ``act [E, C, F]`` and ``w_down [E, F, D]`` of
    one type (fp32 or bf16; bf16 widths multiples of 64) and the route's
    ``counts [E]`` int32, contiguous on one card; returns ``out [E, C, D]``
    with only the live rows written. ``tokens``, the route's T (default C),
    bounds the live rows an expert can have and so the grid's row tiles.
    Raises on anything else."""
    refuse_grad("moe_down_cuda", act, w_down)
    if act.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_down_cuda takes float32 or bfloat16 rows, got {act.dtype}")
    if (act.dim() != 3 or w_down.dim() != 3 or w_down.shape[0] != act.shape[0]
            or w_down.shape[1] != act.shape[2]):
        raise ValueError(f"moe_down_cuda takes act [E, C, F] and w_down [E, F, D], got "
                         f"{tuple(act.shape)} and {tuple(w_down.shape)}")
    e, c, f = act.shape
    d = w_down.shape[2]
    _check_route("moe_down_cuda", None, counts, e, c)
    tokens = c if tokens is None else tokens
    if tokens < 1:
        raise ValueError(f"moe_down_cuda: tokens must be at least 1, got {tokens}")
    _check_widths("moe_down_cuda", act.dtype, f, d)
    if not act.is_cuda:
        raise ValueError(f"moe_down_cuda needs act on a CUDA device, got {act.device}")
    _check("moe_down_cuda", {"act": act, "counts": counts, "w_down": w_down}, act.device,
           act.dtype)
    out = torch.empty((e, c, d), dtype=act.dtype, device=act.device)
    if out.numel() == 0:
        return out
    fn = kernel_function("bobra_moe_down", _DOWN_ARGTYPES)
    check_launch("moe_down", launch(
        fn, act.get_device(), act.data_ptr(), counts.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), tokens, e, c, f, d, KERNEL_DTYPES[act.dtype]))
    moe_down_cuda.launches += 1
    return out


#: launches of each kernel since its count was last set to 0
moe_gate_up_cuda.launches = 0
moe_down_cuda.launches = 0


def moe_gate_up(h: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Dispatch: the plain version for CPU rows, the kernel otherwise."""
    if h.device.type == "cpu":
        return moe_gate_up_reference(h, src, counts, w_gate, w_up)
    return moe_gate_up_cuda(h, src, counts, w_gate, w_up)


def moe_down(act: torch.Tensor, counts: torch.Tensor, w_down: torch.Tensor,
             tokens: int | None = None) -> torch.Tensor:
    """Dispatch: the plain version for CPU rows, the kernel otherwise."""
    if act.device.type == "cpu":
        return moe_down_reference(act, counts, w_down, tokens)
    return moe_down_cuda(act, counts, w_down, tokens)
