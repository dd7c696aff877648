"""Prefix caching: content-addressed sharing of full KV blocks.

Counterpart of ``bobrapet_tpu/serving/prefix_cache.py``, its local half.
Requests that share a prompt prefix (system prompts, few-shot headers,
conversation history) should not recompute or re-store its KV. Blocks are
content-addressed by a **chain hash**, ``H(parent chain, block tokens)``,
so a block's identity pins its whole left context, and two requests match
exactly when their token prefixes match block for block. The hash is the
JAX package's, byte for byte (blake2b, 16 bytes), so both packages name a
prompt's blocks alike.

Sharing is zero-copy: a matched block's id goes straight into the new
request's block table. Prefix blocks are read-only by construction (decode
writes only at positions at or past the request's own prompt length, which
land in its fresh suffix blocks).

Lifetime: a refcount per block counts live users. At zero the block
returns to the allocator's free list **with its hash registration
retained**: it stays matchable until the allocator hands it out again for
new content (lazy invalidation), and a match takes it back off the free
list (:meth:`BlockAllocator.reserve`).

Only full blocks are shared, and a match always leaves the final token out
(the sampler needs its logits), so a non-empty suffix prefill remains.

Cross-engine sharing and its disk spill (the JAX module's
``SharedPrefixRegistry``, ``enable_sharing`` and the block export and
import) are not ported: they come with the port's engram (ROADMAP Queue 1
item 7).
"""

from __future__ import annotations

import hashlib
from typing import Optional

from .paged_cache import BlockAllocator


def _chain_hash(parent: bytes, tokens: list[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(b",".join(str(t).encode() for t in tokens))
    return h.digest()


ROOT = b"root"


def chain_hashes(tokens: list[int], block_size: int, salt: int = 0) -> list[bytes]:
    """The chain hash of every full block of ``tokens`` under ``salt``, in
    order; the final token is left out as :meth:`PrefixCache.match_prefix`
    leaves it out."""
    limit = (len(tokens) - 1) // block_size
    parent = _chain_hash(ROOT, [salt])
    out: list[bytes] = []
    for i in range(limit):
        parent = _chain_hash(parent, tokens[i * block_size:(i + 1) * block_size])
        out.append(parent)
    return out


class PrefixCache:
    """Wraps a :class:`BlockAllocator` with content-addressed reuse. All
    allocation and free traffic goes through this wrapper, so lazy
    invalidation sees every reallocation."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._by_hash: dict[bytes, int] = {}
        self._hash_of: dict[int, bytes] = {}
        self._refs: dict[int, int] = {}
        self.hit_tokens = 0
        self.miss_tokens = 0

    # -- allocation (invalidating) ----------------------------------------

    def alloc(self, n: int) -> Optional[list[int]]:
        blocks = self.allocator.alloc(n)
        if blocks is None:
            return None
        for b in blocks:
            self._invalidate(b)
            self._refs[b] = 1
        return blocks

    def free(self, blocks: list[int]) -> None:
        """Release one user's claim; a block at refcount 0 returns to the
        free list with its hash registration kept."""
        for b in blocks:
            refs = self._refs.get(b)
            if refs is None:
                # a double free would hand one block to two sequences
                raise ValueError(f"free of block {b} with no refcount entry")
            if refs > 1:
                self._refs[b] = refs - 1
                continue
            del self._refs[b]
            self.allocator.free([b])

    def _invalidate(self, block: int) -> None:
        h = self._hash_of.pop(block, None)
        if h is not None and self._by_hash.get(h) == block:
            del self._by_hash[h]

    # -- content addressing ------------------------------------------------

    def register(self, tokens: list[int], blocks: list[int], salt: int = 0) -> None:
        """Record the chain hash of every full block of ``tokens`` held in
        ``blocks`` (block i holds ``tokens[i*B:(i+1)*B]``). ``salt`` scopes
        the chain: the engine passes the LoRA adapter, whose k/v deltas
        give the same tokens another cache content."""
        b = self.block_size
        parent = _chain_hash(ROOT, [salt])
        for i in range(len(tokens) // b):
            if i >= len(blocks):
                break
            parent = _chain_hash(parent, tokens[i * b:(i + 1) * b])
            blk = blocks[i]
            self._invalidate(blk)  # re-registration moves the hash
            self._by_hash[parent] = blk
            self._hash_of[blk] = parent

    def longest_local_match(self, tokens: list[int], salt: int = 0) -> int:
        """How many leading full blocks of ``tokens`` this cache addresses
        now (live, or still reservable off the free list). Read-only: no
        reference is claimed."""
        return self.longest_local_match_hashes(chain_hashes(tokens, self.block_size, salt))

    def longest_local_match_hashes(self, hashes: list[bytes]) -> int:
        """:meth:`longest_local_match` over a chain already hashed."""
        depth = 0
        for h in hashes:
            if h not in self._by_hash:
                break
            depth += 1
        return depth

    def match_prefix(self, tokens: list[int], salt: int = 0) -> tuple[list[int], int]:
        """The longest reusable block chain of ``tokens`` under ``salt``;
        claims a reference on every matched block. Returns ``(block ids,
        matched token count)``; the final token is never matched. The
        caller records the stats once the admission commits (a match
        refunded on an allocation failure must not count as a hit)."""
        b = self.block_size
        limit = (len(tokens) - 1) // b  # keep >= 1 token for the suffix
        parent = _chain_hash(ROOT, [salt])
        matched: list[int] = []
        for i in range(limit):
            parent = _chain_hash(parent, tokens[i * b:(i + 1) * b])
            blk = self._by_hash.get(parent)
            if blk is None:
                break
            if blk in self._refs:
                self._refs[blk] += 1
            else:
                # free-listed but still registered: reserve it back
                if not self.allocator.reserve(blk):
                    self._invalidate(blk)
                    break
                self._refs[blk] = 1
            matched.append(blk)
        return matched, len(matched) * b

    def record_stats(self, total_tokens: int, hit: int) -> None:
        self.hit_tokens += hit
        self.miss_tokens += total_tokens - hit
