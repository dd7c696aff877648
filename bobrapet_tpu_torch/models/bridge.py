"""Carry a parameter tree across from numpy into the port.

The JAX package's ``init_params`` / ``quantize_params`` build a tree of
dicts and lists; turned into numpy arrays leaf by leaf (``np.asarray``),
it comes here and leaves as the port's tree of tensors, with the same
structure and values bit for bit. bf16 arrays (``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` does not know) travel as their uint16 bits.
Nothing here imports jax: bf16 is recognised by its dtype's name.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    # np.array copies: the tensor owns writable memory of its own
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Dicts and lists keep their shape (int8 ``{"q", "scale"}`` leaves
    included); every array leaf becomes a tensor on ``device``."""
    device = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return tensor_from_numpy(node, device)

    return walk(tree)
