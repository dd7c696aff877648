"""Serving: continuous batching over a paged KV cache (engine.py,
paged_cache.py) with prefix caching and cross-engine sharing
(prefix_cache.py), chunked prefill, multi-LoRA and speculative decoding
(spec_decode.py); disaggregated prefill/decode pools behind a router
(router.py); the stream loop (service.py) and the Story step that builds
it all from its config (engram.py)."""

from .engine import Request, ServingEngine
from .paged_cache import BlockAllocator, PagedConfig
from .prefix_cache import GLOBAL_SHARED_PREFIXES, PrefixCache, SharedPrefixRegistry
from .router import DrainStatus, ServingRouter
from .service import StreamServer

__all__ = ["BlockAllocator", "DrainStatus", "GLOBAL_SHARED_PREFIXES", "PagedConfig",
           "PrefixCache", "Request", "ServingEngine", "ServingRouter", "SharedPrefixRegistry",
           "StreamServer"]
