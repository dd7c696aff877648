"""Paged KV cache: fixed block pools + per-sequence block tables.

Counterpart of ``bobrapet_tpu/serving/paged_cache.py`` in the parts the
engine runs:

- One pool per K and V, ``[layers, num_blocks, block_size, kv_heads,
  head_dim]``: a block id addresses the same slab in every layer.
- Block 0 is reserved scratch: the fused decode step still writes for
  inactive slots, into block 0, which is never allocated.
- Block tables are small ``[max_slots, max_blocks_per_seq]`` int32
  tensors kept by the engine's host-side allocator.

Where JAX donates the pools and gets new arrays back, the port writes
into the pools in place. Its horizon decodes over the pools themselves
(the paged kernel reads them in place, each step writes its token), so
JAX's ``gather_views`` / ``scatter_window`` round trip through contiguous
views has no counterpart here yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.llama import LlamaConfig
from ..ops.paged_attention import gather_pages

#: block id 0 is never allocated (masked writes land there)
SCRATCH_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    max_slots: int = 8          # concurrent sequences in the decode batch
    block_size: int = 16        # tokens per KV block
    num_blocks: int = 256       # pool size (incl. the scratch block)
    max_blocks_per_seq: int = 32
    #: content-addressed reuse of full prompt blocks (not ported yet: the
    #: engine raises unless this is False)
    prefix_caching: bool = True
    #: chunked prefill width (not ported yet: the engine raises unless None)
    prefill_chunk: Optional[int] = None

    @property
    def capacity(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))


def init_pools(cfg: LlamaConfig, pcfg: PagedConfig,
               device: DeviceLike = None) -> dict[str, torch.Tensor]:
    device = resolve_device(device)
    shape = (cfg.n_layers, pcfg.num_blocks, pcfg.block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def write_token(
    pools: dict[str, torch.Tensor],
    k: torch.Tensor,  # [L, S, Hkv, Dh]: one new token per slot, every layer
    v: torch.Tensor,
    block_ids: torch.Tensor,  # [S] physical block per slot (the scratch block when masked)
    offsets: torch.Tensor,    # [S] offset within the block
) -> dict[str, torch.Tensor]:
    """Scatter one decoded token's K/V of every slot and layer into the
    pools, in place: ``pool[:, block_ids, offsets]`` (adjacent advanced
    indices) selects ``[L, S, Hkv, Dh]``. Returns ``pools``."""
    pools["k"][:, block_ids, offsets] = k.to(pools["k"].dtype)
    pools["v"][:, block_ids, offsets] = v.to(pools["v"].dtype)
    return pools


def write_prefill(
    pools: dict[str, torch.Tensor],
    k: torch.Tensor,  # [L, P, Hkv, Dh] contiguous prompt K (P = padded bucket)
    v: torch.Tensor,
    block_ids: torch.Tensor,  # [n_blocks] physical blocks receiving the prompt
) -> dict[str, torch.Tensor]:
    """Scatter a contiguous prefill K/V run into this sequence's blocks, in
    place. P must equal ``len(block_ids) * block_size`` (the engine pads
    the bucket); positions past the true prompt hold garbage that the
    attention mask never reads. Returns ``pools``."""
    n_blocks = block_ids.shape[0]
    L, P, H, D = k.shape
    B = P // n_blocks
    pools["k"][:, block_ids] = k.reshape(L, n_blocks, B, H, D).to(pools["k"].dtype)
    pools["v"][:, block_ids] = v.reshape(L, n_blocks, B, H, D).to(pools["v"].dtype)
    return pools


def gather_kv(
    pools: dict[str, torch.Tensor],
    block_tables: torch.Tensor,  # [S, max_blocks_per_seq]
    layer: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slot's cache view ``[S, capacity, Hkv, Dh]`` for one layer: what
    the plain paged attention reads (the kernel reads the pool in place)."""
    return gather_pages(pools["k"][layer], block_tables), gather_pages(pools["v"][layer], block_tables)


class BlockAllocator:
    """Host-side free-list allocator over the pool's block ids, in the JAX
    package's order (the ids match one for one).

    Block 0 (scratch) is never handed out. The engine calls :meth:`alloc`
    as sequences grow and :meth:`free` on finish or preemption."""

    def __init__(self, num_blocks: int):
        self._free = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self.num_blocks = num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """n blocks or None (the caller waits or preempts), never a
        partial allocation."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError("scratch block cannot be freed")
            self._free.append(b)

