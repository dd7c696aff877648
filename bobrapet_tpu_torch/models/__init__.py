"""Model families in PyTorch (the Llama family so far, with LoRA adapters),
and standalone speculative decoding."""

from . import lora
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
from .quant import dequantize_params, init_quantized_params, quantize_params, tree_bytes
from .speculative import SpecResult, speculative_generate

__all__ = [
    "SpecResult",
    "speculative_generate",
    "LlamaConfig",
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
    "params_from_numpy",
    "quantize_params",
    "tree_bytes",
]
