"""Sparse-MoE routing, dispatch and combine: three hand-written CUDA kernels
(``csrc/moe_dispatch.cu``) and their plain PyTorch versions.

Counterpart of ``bobrapet_tpu/models/moe.py``'s ``route_topk`` and the
dispatch and combine einsums of ``moe_mlp_block``, which XLA fuses (the
JAX package has no Pallas kernel there). JAX keeps the routing as one-hot
tensors ``[T, E, C]``; here it is indices:

- :func:`moe_route` of router logits ``[T, E]``: ``expert``, ``slot`` int32
  and ``gate`` fp32 ``[T, K]``, the inverse map ``src`` int32 ``[E, C]``
  (the token in each capacity slot, -1 where empty), and per expert the
  ``counts`` of (t, k) routed to it (kept or not) and the fp32 ``probsum``
  of its probabilities over the tokens;
- :func:`moe_dispatch`: ``expert_in [E, C, D]``, row (e, c) the token
  ``src[e, c]``'s row of ``h``, zeros in an empty slot;
- :func:`moe_combine`: ``y [T, D]``, ``sum_k gate[t, k] *
  expert_out[expert[t, k], slot[t, k]]`` in fp32, k in order, a (t, k)
  past the capacity skipped, cast to the model's type.

JAX's rules, kept by both versions: fp32 softmax (max subtracted, the sum
in expert order); top-k with equal probabilities going to the lower expert
index (``lax.top_k``'s order; ``torch.topk`` orders ties otherwise, so the
plain version takes a stable descending sort); gates divided by their sum
(in k order) clipped at 1e-9; a (t, k)'s slot is its place in its expert's
queue in t-major, k-minor order, kept only when below the capacity C.

On the card a wrapper launches its kernel or raises; on the CPU the
dispatchers run the plain versions. The plain combine takes each product
and add rounded on its own, as the kernel does, so the two agree bit for
bit. The model runs the route and the combine; the gate/up product of
:mod:`ops.moe_experts` gathers its rows itself, so the dispatch runs only
inside the expert products' plain versions (and its kernel stands as the
counterpart of JAX's dispatch einsum).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import KERNEL_DTYPES, check_launch, kernel_function, launch, refuse_grad

_ROUTE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # logits, expert, slot
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # gate, src, counts
    ctypes.c_void_p,                                    # probsum
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # tokens, n_experts, top_k
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,        # capacity, dtype, stream
]
_DISPATCH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # h, src, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # rows, d, dtype
    ctypes.c_void_p,                                    # stream
]
_COMBINE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # expert_out, expert, slot
    ctypes.c_void_p, ctypes.c_void_p,                   # gate, y
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # tokens, d, top_k
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,        # capacity, dtype, stream
]
#: the route kernel's limits (``csrc/moe_dispatch.cu``: kMaxExperts, kMaxTopK)
MAX_EXPERTS = 32
MAX_TOP_K = 8
#: the least gate sum a token's gates are divided by (JAX's clip)
GATE_FLOOR = 1e-9

RouteOut = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def moe_route_reference(logits: torch.Tensor, top_k: int, capacity: int) -> RouteOut:
    """The plain route: ``(expert, slot, gate, src, counts, probsum)``, see
    the module docstring."""
    t, e = logits.shape
    x = logits.float()
    ex = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    s = ex[:, 0]
    for i in range(1, e):  # expert order, as the kernel sums
        s = s + ex[:, i]
    probs = ex / s[:, None]
    # a stable descending sort: equal probabilities keep the lower index first
    expert = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    chosen = probs.gather(1, expert)
    total = chosen[:, 0]
    for k in range(1, top_k):
        total = total + chosen[:, k]
    gate = chosen / total.clamp_min(GATE_FLOOR)[:, None]
    # a token's k experts are distinct, so its place in expert e's queue is
    # the count of earlier tokens that chose e
    onehot = torch.zeros((t, e), dtype=torch.int32, device=logits.device)
    onehot.scatter_(1, expert, 1)
    before = torch.cumsum(onehot, dim=0) - onehot
    slot = before.gather(1, expert)
    src = torch.full((e * capacity,), -1, dtype=torch.int32, device=logits.device)
    kept = slot < capacity
    tokens = torch.arange(t, dtype=torch.int32, device=logits.device)[:, None].expand(t, top_k)
    src[(expert * capacity + slot)[kept]] = tokens[kept]
    return (expert.to(torch.int32), slot.to(torch.int32), gate, src.view(e, capacity),
            onehot.sum(0, dtype=torch.int32), probs.sum(0))


def moe_dispatch_reference(h: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The plain dispatch: ``[E, C, D]``, row (e, c) ``h[src[e, c]]``, zeros
    where ``src`` is -1."""
    rows = src.reshape(-1).long()
    out = h[rows.clamp_min(0)]
    out[rows < 0] = 0
    return out.view(*src.shape, h.shape[-1])


def moe_combine_reference(expert_out: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                          gate: torch.Tensor) -> torch.Tensor:
    """The plain combine: ``[T, D]`` in ``expert_out``'s type, each product
    and each add in fp32 rounded on its own, k in order."""
    e, c, d = expert_out.shape
    t, top_k = expert.shape
    kept = slot < c
    rows = (expert.long() * c + slot.long().clamp_max(c - 1)).reshape(-1)
    picked = expert_out.reshape(e * c, d)[rows].view(t, top_k, d).float()
    acc = torch.zeros((t, d), dtype=torch.float32, device=expert_out.device)
    for k in range(top_k):
        term = gate[:, k, None] * picked[:, k]
        acc = acc + torch.where(kept[:, k, None], term, torch.zeros_like(term))
    return acc.to(expert_out.dtype)


def moe_aux(counts: torch.Tensor, probsum: torch.Tensor, tokens: int, top_k: int
            ) -> torch.Tensor:
    """JAX's load-balancing loss from the route's per-expert sums (Switch
    eq. 4-6): ``E * sum(counts / T * probsum / T) / K``."""
    e = counts.shape[0]
    return e * torch.sum(counts.float() / tokens * (probsum / tokens)) / top_k


def _check(name: str, tensors: dict, device: torch.device) -> None:
    for what, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def moe_route_cuda(logits: torch.Tensor, top_k: int, capacity: int) -> RouteOut:
    """Launch the route kernel on router logits ``[T, E]`` (fp32 or bf16,
    contiguous, on a card). Raises on anything else; it never computes the
    plain version instead."""
    refuse_grad("moe_route_cuda", logits)
    if logits.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_route_cuda takes float32 or bfloat16 logits, got {logits.dtype}")
    if logits.dim() != 2 or logits.shape[0] < 1 or not 1 <= logits.shape[1] <= MAX_EXPERTS:
        raise ValueError(f"moe_route_cuda takes logits [T, E] with T >= 1 and 1 <= E <= "
                         f"{MAX_EXPERTS}, got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= top_k <= min(MAX_TOP_K, e) or capacity < 1:
        raise ValueError(f"moe_route_cuda: top_k {top_k} must be in [1, min({MAX_TOP_K}, E)] "
                         f"and capacity {capacity} >= 1")
    if not logits.is_cuda:
        raise ValueError(f"moe_route_cuda needs logits on a CUDA device, got {logits.device}")
    _check("moe_route_cuda", {"logits": logits}, logits.device)
    dev = logits.device
    expert = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    slot = torch.empty_like(expert)
    gate = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    src = torch.empty((e, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((e,), dtype=torch.int32, device=dev)
    probsum = torch.empty((e,), dtype=torch.float32, device=dev)
    fn = kernel_function("bobra_moe_route", _ROUTE_ARGTYPES)
    check_launch("moe_route", launch(
        fn, logits.get_device(), logits.data_ptr(), expert.data_ptr(), slot.data_ptr(),
        gate.data_ptr(), src.data_ptr(), counts.data_ptr(), probsum.data_ptr(), t, e, top_k,
        capacity, KERNEL_DTYPES[logits.dtype]))
    moe_route_cuda.launches += 1
    return expert, slot, gate, src, counts, probsum


def moe_dispatch_cuda(h: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Launch the dispatch kernel: ``h [T, D]`` (fp32 or bf16) and the
    route's ``src [E, C]`` int32, both contiguous on one card; returns
    ``[E, C, D]``. ``src`` entries must be -1 or rows of ``h`` (the route's
    are). Raises on anything else."""
    refuse_grad("moe_dispatch_cuda", h, src)
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_dispatch_cuda takes float32 or bfloat16 rows, got {h.dtype}")
    if h.dim() != 2 or src.dim() != 2 or src.dtype != torch.int32 or h.shape[1] < 1:
        raise ValueError(f"moe_dispatch_cuda takes h [T, D] and int32 src [E, C], got "
                         f"{tuple(h.shape)} and {src.dtype} {tuple(src.shape)}")
    if not h.is_cuda:
        raise ValueError(f"moe_dispatch_cuda needs h on a CUDA device, got {h.device}")
    _check("moe_dispatch_cuda", {"h": h, "src": src}, h.device)
    out = torch.empty((*src.shape, h.shape[1]), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    fn = kernel_function("bobra_moe_dispatch", _DISPATCH_ARGTYPES)
    check_launch("moe_dispatch", launch(fn, h.get_device(), h.data_ptr(), src.data_ptr(),
                                        out.data_ptr(), src.numel(), h.shape[1],
                                        KERNEL_DTYPES[h.dtype]))
    moe_dispatch_cuda.launches += 1
    return out


def moe_combine_cuda(expert_out: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                     gate: torch.Tensor) -> torch.Tensor:
    """Launch the combine kernel: ``expert_out [E, C, D]`` (fp32 or bf16)
    and the route's ``expert``, ``slot`` int32 and ``gate`` fp32 ``[T, K]``,
    all contiguous on one card; returns ``[T, D]`` in ``expert_out``'s type.
    ``expert`` entries must lie in ``[0, E)`` (the route's do). Raises on
    anything else."""
    refuse_grad("moe_combine_cuda", expert_out, gate)
    if expert_out.dtype not in KERNEL_DTYPES:
        raise TypeError(f"moe_combine_cuda takes float32 or bfloat16 expert rows, got "
                        f"{expert_out.dtype}")
    if expert_out.dim() != 3 or expert.dim() != 2 or not 1 <= expert.shape[1] <= MAX_TOP_K:
        raise ValueError(f"moe_combine_cuda takes expert_out [E, C, D] and [T, K] maps with "
                         f"K <= {MAX_TOP_K}, got {tuple(expert_out.shape)} and "
                         f"{tuple(expert.shape)}")
    for name, t, dt in (("expert", expert, torch.int32), ("slot", slot, torch.int32),
                        ("gate", gate, torch.float32)):
        if t.dtype != dt or t.shape != expert.shape:
            raise ValueError(f"moe_combine_cuda: {name} must be {dt} {tuple(expert.shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not expert_out.is_cuda:
        raise ValueError(f"moe_combine_cuda needs expert rows on a CUDA device, got "
                         f"{expert_out.device}")
    _check("moe_combine_cuda", {"expert_out": expert_out, "expert": expert, "slot": slot,
                                "gate": gate}, expert_out.device)
    _, c, d = expert_out.shape
    t, top_k = expert.shape
    y = torch.empty((t, d), dtype=expert_out.dtype, device=expert_out.device)
    if y.numel() == 0:
        return y
    fn = kernel_function("bobra_moe_combine", _COMBINE_ARGTYPES)
    check_launch("moe_combine", launch(
        fn, expert_out.get_device(), expert_out.data_ptr(), expert.data_ptr(), slot.data_ptr(),
        gate.data_ptr(), y.data_ptr(), t, d, top_k, c, KERNEL_DTYPES[expert_out.dtype]))
    moe_combine_cuda.launches += 1
    return y


#: launches of each kernel since its count was last set to 0
moe_route_cuda.launches = 0
moe_dispatch_cuda.launches = 0
moe_combine_cuda.launches = 0


def moe_route(logits: torch.Tensor, top_k: int, capacity: int) -> RouteOut:
    """Dispatch: the plain version for CPU logits, the kernel otherwise."""
    if logits.device.type == "cpu":
        return moe_route_reference(logits, top_k, capacity)
    return moe_route_cuda(logits, top_k, capacity)


def moe_dispatch(h: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Dispatch: the plain version for CPU rows, the kernel otherwise."""
    if h.device.type == "cpu":
        return moe_dispatch_reference(h, src)
    return moe_dispatch_cuda(h, src)


def moe_combine(expert_out: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
                gate: torch.Tensor) -> torch.Tensor:
    """Dispatch: the plain version for CPU rows, the kernel otherwise."""
    if expert_out.device.type == "cpu":
        return moe_combine_reference(expert_out, expert, slot, gate)
    return moe_combine_cuda(expert_out, expert, slot, gate)
