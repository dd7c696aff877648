"""Int8 weight-only quantization for decode.

Counterpart of ``bobrapet_tpu/models/quant.py``, same scheme and the same
rounding: every 2-D float matmul weight outside the skip list becomes
``{"q": int8, "scale": [out] in the weight's dtype}`` with a
per-output-column absmax scale; 1-D norm gains and the embedding table
stay as they are. A product with an int8 leaf runs the plain PyTorch
version on the CPU and the port's int8 kernel on a card
(:func:`~bobrapet_tpu_torch.ops.quant_matmul.quant_matmul_cuda`, which
never writes the widened weight, as XLA's fused product does not); a
product with a plain weight stays ``torch.matmul``, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.quant_matmul import quant_matmul_cuda, quant_matmul_reference

#: param-tree keys never quantized (gather tables + tied heads)
_SKIP_NAMES = {"embed"}


def is_quantized(leaf: Any) -> bool:
    """Exactly ``{"q": int8 tensor, "scale": tensor}``."""
    return (
        isinstance(leaf, dict)
        and set(leaf) == {"q", "scale"}
        and getattr(leaf["q"], "dtype", None) == torch.int8
    )


def quantize_array(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """One matmul weight [in, out] -> int8 + per-out-column scale.

    The scale is cast to the storage dtype first and that rounded scale
    divides ``w``, so quantize and dequantize agree exactly."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax)).to(w.dtype)
    # a tiny absmax can underflow to 0 in bf16; scale 1 maps such columns to 0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(wf / scale.float()), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize_array(leaf: dict[str, torch.Tensor]) -> torch.Tensor:
    scale = leaf["scale"]
    return (leaf["q"].float() * scale.float()).to(scale.dtype)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a plain tensor OR an int8 leaf.

    For the int8 leaf the per-column scale factors out of the contraction,
    in the JAX order: ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``, so the
    product is rounded to x's type before the scale multiply. On the CPU
    that is the plain version; on a card the int8 kernel, which refuses
    what it does not take (it never falls back to the plain version)."""
    if is_quantized(w):
        if x.device.type == "cpu":
            return quant_matmul_reference(x, w["q"], w["scale"])
        return quant_matmul_cuda(x, w["q"], w["scale"])
    return x @ w


def quantize_params(params: dict[str, Any]) -> dict[str, Any]:
    """Walk a param tree; every 2-D float weight outside the skip list
    becomes an int8 leaf. Structure is otherwise preserved."""

    def walk(node: Any, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if (
            isinstance(node, torch.Tensor)
            and node.dim() == 2
            and node.is_floating_point()
            and name not in _SKIP_NAMES
        ):
            return quantize_array(node)
        return node

    return {k: v if k in _SKIP_NAMES else walk(v, k) for k, v in params.items()}


def tree_bytes(params: Any) -> int:
    """Total tensor storage of a (possibly quantized) param tree."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return 0
