"""Model families in PyTorch (the Llama family so far)."""

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
from .quant import quantize_params, tree_bytes

__all__ = [
    "LlamaConfig",
    "forward",
    "greedy_generate",
    "init_cache",
    "init_params",
    "llama3_1b",
    "llama3_8b",
    "llama_tiny",
    "params_from_numpy",
    "quantize_params",
    "tree_bytes",
]
