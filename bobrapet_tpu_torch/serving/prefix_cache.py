"""Prefix caching: content-addressed sharing of full KV blocks.

Counterpart of ``bobrapet_tpu/serving/prefix_cache.py``.
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

**Cross-engine sharing**: a :class:`SharedPrefixRegistry` keeps exported
block payloads (a block's K/V across layers, plus the draft's for a
speculative engine) keyed by ``(scope, chain hash)``, where ``scope`` is
the engine's weights fingerprint (``ServingEngine._sharing_scope``). An
engine that misses locally but hits the registry allocates fresh blocks
and adopts the exported content with one copy a pool instead of running
the prefill forward: this is how a prefill-role engine hands a request's
KV to a decode-role engine. Different weights hash to different scopes and
never cross-hit; the per-adapter salt stays in the chain hash. The
registry can spill through a blob store (:meth:`~SharedPrefixRegistry.
attach_spill`, keys ``kv/<scope>/<chain hash>``), so a restarted engine
adopts from disk what a dead process exported. The scope is the port's
own (its dtype names differ from JAX's): the two packages never share a
registry entry. The JAX module's ``guarded_state`` decorator is a
declaration for its race detector with no effect at run time, and is left
out.
"""

from __future__ import annotations

import hashlib
import io
import logging
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import storage as _storage
from .paged_cache import BlockAllocator

_log = logging.getLogger(__name__)


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


def _encode_kv_payload(payload: dict) -> bytes:
    """An exported block payload (tensors on any device) as ``np.savez``
    bytes for the disk tier: bf16 travels as its uint16 bits under the
    name ``<key>.bfloat16``; nothing is pickled."""
    arrays = {}
    for k, v in payload.items():
        t = v.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            arrays[f"{k}.bfloat16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[k] = t.numpy()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode_kv_payload(data: bytes) -> dict:
    """:func:`_encode_kv_payload`'s bytes back as CPU tensors."""
    out = {}
    with np.load(io.BytesIO(data)) as z:
        for name in z.files:
            arr = np.array(z[name])  # a writable copy torch can own
            if name.endswith(".bfloat16"):
                out[name.removesuffix(".bfloat16")] = torch.from_numpy(
                    arr.view(np.int16)).view(torch.bfloat16)
            else:
                out[name] = torch.from_numpy(arr)
    return out


class SharedPrefixRegistry:
    """Process-wide ``(scope, chain hash) -> exported block payload`` map
    shared by engines: a bounded LRU, thread-safe.

    Payloads are device tensors of their own (the export copies the block
    out of the pools), so an entry stays valid however the exporting
    engine's pools change, at the cost of holding that memory until
    eviction: size ``max_entries`` for it (one entry = one block's K/V
    across every layer, target and draft).

    With a spill (:meth:`attach_spill`) every put writes through to the
    store under ``kv/<scope>/<chain hash>`` and a memory miss reads back
    from it, so an entry the LRU evicted, or one a dead process exported,
    stays adoptable until the store itself drops it."""

    def __init__(self, max_entries: int = 512, spill: Optional[_storage.Store] = None,
                 spill_prefix: str = "kv"):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[str, bytes], dict] = OrderedDict()
        self._spill = spill
        self._spill_prefix = spill_prefix.strip("/")

    def attach_spill(self, store: Optional[_storage.Store], prefix: str = "kv") -> None:
        """Write-through and read-through persistence via a blob store (the
        slice-local disk tier); ``None`` detaches."""
        with self._lock:
            self._spill = store
            self._spill_prefix = prefix.strip("/")

    def _spill_key(self, scope: str, h: bytes) -> str:
        return f"{self._spill_prefix}/{scope}/{h.hex()}"

    def _insert_locked(self, key: tuple[str, bytes], payload: dict) -> None:
        """Caller holds ``_lock``: insert as most recent, trim the LRU."""
        self._entries.pop(key, None)
        self._entries[key] = payload
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def put(self, scope: str, h: bytes, payload: dict) -> None:
        with self._lock:
            self._insert_locked((scope, h), payload)
            spill = self._spill
        if spill is not None:
            # the copy to the host stays outside the lock; a failed spill
            # (a full tier) leaves the entry in memory only
            try:
                spill.put(self._spill_key(scope, h), _encode_kv_payload(payload))
            except Exception as e:  # noqa: BLE001 - a tier hiccup
                _log.debug("prefix-KV spill write failed: %s", e)

    def get(self, scope: str, h: bytes) -> Optional[dict]:
        with self._lock:
            payload = self._entries.get((scope, h))
            if payload is not None:
                self._entries.move_to_end((scope, h))
                return payload
            spill = self._spill
        if spill is None:
            return None
        try:
            data = spill.get(self._spill_key(scope, h))
        except Exception:  # noqa: BLE001 - BlobNotFound, or a tier hiccup
            return None
        try:
            payload = _decode_kv_payload(data)
        except Exception as e:  # noqa: BLE001 - a torn or stale spill entry
            _log.debug("prefix-KV spill entry undecodable: %s", e)
            return None
        with self._lock:
            # back into the memory LRU, so a repeat adoption is cheap
            self._insert_locked((scope, h), payload)
        return payload

    def longest_match(self, scope: str, tokens: list[int], block_size: int,
                      salt: int = 0) -> int:
        """How many leading full blocks of ``tokens`` this registry holds in
        memory under ``scope`` (the router's prefix-affinity probe; a disk
        probe per block would put the tier's latency before every routing
        decision). Every hit is touched in the LRU."""
        return self.longest_match_hashes(scope, chain_hashes(tokens, block_size, salt))

    def longest_match_hashes(self, scope: str, hashes: list[bytes]) -> int:
        """:meth:`longest_match` over a chain already hashed."""
        depth = 0
        with self._lock:
            for h in hashes:
                key = (scope, h)
                if key not in self._entries:
                    break
                self._entries.move_to_end(key)
                depth += 1
        return depth

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: the registry of ``set_prefix_sharing(True)``: every engine of the process
#: that opts in shares through it
GLOBAL_SHARED_PREFIXES = SharedPrefixRegistry()


def _adopt_active_disk_tier() -> None:
    """Point the global registry's spill at the process's disk tier, if one
    was parked in :data:`bobrapet_tpu_torch.storage.ACTIVE_DISK_TIER`
    before this module loaded. A registry of one's own opts in with
    :meth:`SharedPrefixRegistry.attach_spill`."""
    tier = _storage.ACTIVE_DISK_TIER
    if tier is not None:
        GLOBAL_SHARED_PREFIXES.attach_spill(tier)


_adopt_active_disk_tier()


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
        # cross-engine sharing (off until enable_sharing): the registry and
        # the owning engine's export and import callbacks
        self._shared: Optional[SharedPrefixRegistry] = None
        self._scope: str = ""
        self._export: Optional[Callable[[int], dict]] = None
        self._import: Optional[Callable[[int, dict], bool]] = None
        self._import_many: Optional[Callable[[list[int], list[dict]], bool]] = None
        self.shared_hits = 0

    # -- cross-engine sharing ----------------------------------------------

    @property
    def shared(self) -> Optional[SharedPrefixRegistry]:
        """The registry this cache shares through (None: local only)."""
        return self._shared

    @property
    def scope(self) -> str:
        """The sharing namespace (the engine's weights fingerprint)."""
        return self._scope

    def enable_sharing(self, registry: SharedPrefixRegistry, scope: str,
                       export_cb: Callable[[int], dict],
                       import_cb: Callable[[int, dict], bool],
                       import_many_cb: Optional[Callable[[list[int], list[dict]], bool]] = None
                       ) -> None:
        """Join ``registry`` under ``scope``: registered full blocks are
        exported, and a local miss consults the registry before giving up,
        adopting a run of blocks through ``import_many_cb`` (one copy a
        pool) or block by block through ``import_cb``. Blocks registered
        before are not exported: enable sharing before serving."""
        self._shared = registry
        self._scope = scope
        self._export = export_cb
        self._import = import_cb
        self._import_many = import_many_cb

    def disable_sharing(self) -> None:
        self._shared = None
        self._export = None
        self._import = None
        self._import_many = None

    def rescope(self, scope: str) -> None:
        """Move later exports and imports to a new namespace (the engine's
        identity changed: a payoff guard retired its draft). Entries already
        in the registry stay under the old scope."""
        self._scope = scope

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
            # locals: a live reload may disable sharing from another thread
            shared, export = self._shared, self._export
            if shared is not None and export is not None:
                # publish once: the first engine to compute a chain block
                # exports it
                if shared.get(self._scope, parent) is None:
                    shared.put(self._scope, parent, export(blk))

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
        claims a reference on every matched block. A local miss on a
        sharing engine adopts the longest run the registry holds from there
        (:meth:`_adopt_shared_run`). Returns ``(block ids, matched token
        count)``; the final token is never matched. The caller records the
        stats once the admission commits (a match refunded on an allocation
        failure must not count as a hit)."""
        b = self.block_size
        limit = (len(tokens) - 1) // b  # keep >= 1 token for the suffix
        parent = _chain_hash(ROOT, [salt])
        hashes: list[bytes] = []

        def hash_through(n: int) -> None:
            # lazily: a local-only engine whose chain misses at block 0
            # must not hash the whole prompt on every admission retry
            nonlocal parent
            while len(hashes) < n:
                j = len(hashes)
                parent = _chain_hash(parent, tokens[j * b:(j + 1) * b])
                hashes.append(parent)

        matched: list[int] = []
        i = 0
        while i < limit:
            hash_through(i + 1)
            blk = self._by_hash.get(hashes[i])
            if blk is None:
                if self._shared is None or self._import is None:
                    break
                hash_through(limit)
                got = self._adopt_shared_run(hashes[i:])
                if not got:
                    break
                matched.extend(got)
                i += len(got)
                continue
            if blk in self._refs:
                self._refs[blk] += 1
            else:
                # free-listed but still registered: reserve it back
                if not self.allocator.reserve(blk):
                    self._invalidate(blk)
                    break
                self._refs[blk] = 1
            matched.append(blk)
            i += 1
        return matched, len(matched) * b

    def _adopt_shared_run(self, hashes: list[bytes]) -> list[int]:
        """A local miss: adopt the longest run of consecutive chain blocks
        the registry holds from ``hashes[0]`` on into freshly allocated
        blocks, in one import when the engine gives ``import_many_cb``.
        Returns the adopted block ids ([]: no entry, no memory, or the
        payload was refused)."""
        shared, importer = self._shared, self._import
        importer_many = self._import_many
        if shared is None or importer is None:
            return []
        payloads: list[dict] = []
        for h in hashes:
            if h in self._by_hash:
                # the chain resumes locally here: the caller reuses the
                # resident block
                break
            payload = shared.get(self._scope, h)
            if payload is None:
                break
            payloads.append(payload)
        if not payloads:
            return []
        blks = self.alloc(len(payloads))
        while blks is None and payloads:
            # memory pressure: a shorter run still skips that much prefill
            payloads.pop()
            blks = self.alloc(len(payloads)) if payloads else None
        if blks is None:
            return []
        if importer_many is not None and len(payloads) > 1:
            ok = importer_many(blks, payloads)
        else:
            ok = all(importer(blk, payload) for blk, payload in zip(blks, payloads))
        if not ok:
            self.free(blks)
            return []
        for blk, h in zip(blks, hashes):
            self._by_hash[h] = blk
            self._hash_of[blk] = h
        self.shared_hits += len(blks)
        return blks

    def record_stats(self, total_tokens: int, hit: int) -> None:
        self.hit_tokens += hit
        self.miss_tokens += total_tokens - hit
