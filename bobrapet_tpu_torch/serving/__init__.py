"""Serving: continuous batching over a paged KV cache (engine.py,
paged_cache.py), the single-step greedy engine so far."""

from .engine import Request, ServingEngine
from .paged_cache import BlockAllocator, PagedConfig

__all__ = ["BlockAllocator", "PagedConfig", "Request", "ServingEngine"]
