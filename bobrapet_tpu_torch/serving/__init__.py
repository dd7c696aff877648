"""Serving: continuous batching over a paged KV cache (engine.py,
paged_cache.py) with prefix caching (prefix_cache.py), chunked prefill
and multi-LoRA; greedy, at dispatch depth 1."""

from .engine import Request, ServingEngine
from .paged_cache import BlockAllocator, PagedConfig
from .prefix_cache import PrefixCache

__all__ = ["BlockAllocator", "PagedConfig", "PrefixCache", "Request", "ServingEngine"]
