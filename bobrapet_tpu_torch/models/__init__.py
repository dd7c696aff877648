"""Model families in PyTorch (Llama, with LoRA adapters, and the sparse-MoE
family), and standalone speculative decoding."""

from . import lora, moe
from .bridge import params_from_numpy
from .llama import (
    LlamaConfig,
    forward,
    greedy_generate,
    init_cache,
    init_params,
    llama3_1b,
    llama3_8b,
    llama_tiny,
)
from .moe import MoEConfig, mixtral_8x7b, moe_tiny
from .quant import dequantize_params, init_quantized_params, quantize_params, tree_bytes
from .speculative import SpecResult, speculative_generate

__all__ = [
    "SpecResult",
    "speculative_generate",
    "LlamaConfig",
    "MoEConfig",
    "dequantize_params",
    "forward",
    "greedy_generate",
    "init_cache",
    "init_params",
    "init_quantized_params",
    "lora",
    "llama3_1b",
    "llama3_8b",
    "llama_tiny",
    "mixtral_8x7b",
    "moe",
    "moe_tiny",
    "params_from_numpy",
    "quantize_params",
    "tree_bytes",
]
