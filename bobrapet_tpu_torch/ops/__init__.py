"""Hot ops: hand-written CUDA kernels with plain PyTorch versions."""

from .attention import (
    attention,
    attention_reference,
    cached_attention,
    cached_attention_cuda,
    cached_attention_reference,
    flash_attention_cuda,
)
from .paged_attention import (
    paged_attention,
    paged_attention_cuda,
    paged_attention_multi,
    paged_attention_multi_cuda,
    paged_attention_multi_reference,
    paged_attention_reference,
)
from .quant_matmul import quant_matmul_cuda, quant_matmul_reference
from .rmsnorm import (
    add_rmsnorm,
    add_rmsnorm_cuda,
    add_rmsnorm_reference,
    rmsnorm,
    rmsnorm_cuda,
    rmsnorm_reference,
)
from .rope import apply_rope, rope_frequencies

__all__ = [
    "add_rmsnorm",
    "add_rmsnorm_cuda",
    "add_rmsnorm_reference",
    "attention",
    "attention_reference",
    "cached_attention",
    "cached_attention_cuda",
    "cached_attention_reference",
    "flash_attention_cuda",
    "paged_attention",
    "paged_attention_cuda",
    "paged_attention_multi",
    "paged_attention_multi_cuda",
    "paged_attention_multi_reference",
    "paged_attention_reference",
    "quant_matmul_cuda",
    "quant_matmul_reference",
    "rmsnorm",
    "rmsnorm_cuda",
    "rmsnorm_reference",
    "apply_rope",
    "rope_frequencies",
]
