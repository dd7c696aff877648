"""CUDA graphs: one replay launches a whole captured step.

The port's counterpart of what ``jax.jit`` gives the JAX package's decode
loops (``lax.scan`` in ``greedy_generate``, the engine's fused horizon):
a step whose ~1,300 launches the host would otherwise make one by one is
captured once and replayed, so the card no longer waits on the host
between kernels. There is no JAX function to hold it against: it changes
when work is launched, never what is computed.

:class:`GraphedStep` wraps ``fn(*inputs)``, where ``inputs`` are static
tensors that the caller updates in place between calls and ``fn`` reads
and writes nothing else that moves (weights, caches and pools are written
in place, never reallocated). Each call is one execution of ``fn``:

- on the CPU, or with ``enabled=False``, ``fn`` runs eagerly every time;
- on a card the first call runs ``fn`` eagerly on a side stream (the
  warm-up, whose work is real: it builds the kernels, fills first-use
  caches and sets kernel attributes outside the capture), then captures
  it into a ``torch.cuda.CUDAGraph``; every later call replays the graph
  on the current stream.

``fn`` returns its outputs; from the capture on, the tensors it returned
there are the graph's static outputs, rewritten by every replay, so a
caller reads (or copies) them before its next call. Nothing inside ``fn``
may read the host (``.tolist()``, ``int(t)``), record an event or keep
a tensor it allocates anywhere but in its return value: a capture that
fails raises.

The kernel wrappers' Python ``launches`` counters (and the int8 product's
``routes``) run only while ``fn``'s Python runs, that is during the
capture and not during a replay. So the capture's increase of each counter
is taken back and added again on every replay: a counter then counts the
kernels the card ran, eager or graphed.
"""

from __future__ import annotations

import gc
from typing import Any, Callable

import torch

from .ops.attention import cached_attention_cuda, flash_attention_cuda
from .ops.moe_dispatch import moe_combine_cuda, moe_dispatch_cuda, moe_route_cuda
from .ops.moe_experts import moe_down_cuda, moe_gate_up_cuda
from .ops.paged_attention import paged_attention_cuda, paged_attention_multi_cuda
from .ops.pick_tokens import pick_tokens_cuda
from .ops.quant_matmul import quant_matmul_cuda
from .ops.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda

#: every kernel wrapper with a ``launches`` counter
COUNTED = (rmsnorm_cuda, add_rmsnorm_cuda, flash_attention_cuda, cached_attention_cuda,
           paged_attention_cuda, paged_attention_multi_cuda, quant_matmul_cuda, pick_tokens_cuda,
           moe_route_cuda, moe_dispatch_cuda, moe_combine_cuda, moe_gate_up_cuda, moe_down_cuda)


class GraphedStep:
    """``fn(*inputs)`` once per call; on a card a CUDA graph from the
    second call on. See the module docstring."""

    def __init__(self, fn: Callable[..., Any], *inputs: torch.Tensor, enabled: bool = True):
        devices = {t.device for t in inputs}
        if len(devices) != 1:
            raise ValueError(f"a graphed step takes its inputs on one device, got {devices}")
        self.fn = fn
        self.inputs = inputs
        self.device = devices.pop()
        self.graphed = enabled and self.device.type == "cuda"
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Any = None
        #: (wrapper, launches of one execution, and by route where the
        #: wrapper counts routes) recorded at capture
        self.launches: list[tuple[Any, int, dict[str, int]]] = []
        #: replays since the capture
        self.replays = 0

    def __call__(self) -> Any:
        if not self.graphed:
            return self.fn(*self.inputs)
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        self.replays += 1
        for wrapper, n, routes in self.launches:
            wrapper.launches += n
            for route, c in routes.items():
                wrapper.routes[route] += c
        return self.outputs

    def _warm_up_and_capture(self) -> Any:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = self.fn(*self.inputs)
        current.wait_stream(side)
        before = [(w.launches, dict(getattr(w, "routes", {}))) for w in COUNTED]
        graph = torch.cuda.CUDAGraph()
        # no automatic collection while capturing: a graph kept alive only
        # by a reference cycle (a step holds its owner's bound method) and
        # freed by the collector mid-capture would end the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.outputs = self.fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
            # nothing ran while capturing: take the capture's counts back
            captured = []
            for w, (n, routes) in zip(COUNTED, before):
                captured.append((w.launches - n, {r: w.routes[r] - c for r, c in routes.items()}))
                w.launches = n
                if routes:
                    w.routes.update(routes)
        self.launches = [(w, n, routes) for w, (n, routes) in zip(COUNTED, captured) if n]
        self.graph = graph
        return warm
