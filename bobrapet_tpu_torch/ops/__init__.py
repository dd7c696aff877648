"""Hot ops: hand-written CUDA kernels with plain PyTorch versions."""

from .attention import (
    attention,
    attention_reference,
    cached_attention,
    cached_attention_cuda,
    cached_attention_reference,
    flash_attention_cuda,
)
from .moe_dispatch import (
    moe_aux,
    moe_combine,
    moe_combine_cuda,
    moe_combine_reference,
    moe_dispatch,
    moe_dispatch_cuda,
    moe_dispatch_reference,
    moe_route,
    moe_route_cuda,
    moe_route_reference,
)
from .moe_experts import (
    moe_down,
    moe_down_cuda,
    moe_down_reference,
    moe_gate_up,
    moe_gate_up_cuda,
    moe_gate_up_reference,
)
from .paged_attention import (
    paged_attention,
    paged_attention_cuda,
    paged_attention_multi,
    paged_attention_multi_cuda,
    paged_attention_multi_reference,
    paged_attention_reference,
)
from .pick_tokens import pick_tokens, pick_tokens_cuda, pick_tokens_reference
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
    "moe_aux",
    "moe_combine",
    "moe_combine_cuda",
    "moe_combine_reference",
    "moe_dispatch",
    "moe_dispatch_cuda",
    "moe_dispatch_reference",
    "moe_down",
    "moe_down_cuda",
    "moe_down_reference",
    "moe_gate_up",
    "moe_gate_up_cuda",
    "moe_gate_up_reference",
    "moe_route",
    "moe_route_cuda",
    "moe_route_reference",
    "paged_attention",
    "paged_attention_cuda",
    "paged_attention_multi",
    "paged_attention_multi_cuda",
    "paged_attention_multi_reference",
    "paged_attention_reference",
    "pick_tokens",
    "pick_tokens_cuda",
    "pick_tokens_reference",
    "quant_matmul_cuda",
    "quant_matmul_reference",
    "rmsnorm",
    "rmsnorm_cuda",
    "rmsnorm_reference",
    "apply_rope",
    "rope_frequencies",
]
