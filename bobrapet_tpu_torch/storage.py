"""Blob stores: the port's copy of what serving needs from
``bobrapet_tpu/storage/store.py``.

A minimal blob API (put/get/delete/list/exists) behind which a directory,
a slice-local disk with a byte budget and an in-memory map all look alike.
The checkpoint (:mod:`bobrapet_tpu_torch.sdk.checkpoint`) writes through
it, and the shared prefix registry spills exported KV blocks through it
(:mod:`bobrapet_tpu_torch.serving.prefix_cache`). The keys and the bytes
on disk are the JAX package's, so either package reads what the other
wrote.

:data:`ACTIVE_DISK_TIER` is the process's slice-local disk tier, the
counterpart of ``storage/manager.py``'s slot of the same name: whoever
sets up the disk tier parks it here, and the global prefix registry
spills through it.

Not ported: ``S3Store`` and the storage manager (hydration, tiers,
retention).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional


class StorageError(Exception):
    pass


class BlobNotFound(StorageError):
    def __init__(self, key: str):
        super().__init__(f"blob {key!r} not found")
        self.key = key


class Store:
    """Abstract blob store."""

    #: provider name recorded inside storageRef markers
    provider = "abstract"

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def stat_mtime(self, key: str) -> float:
        """Last-modified time (for retention sweeps)."""
        raise NotImplementedError

    def pin_prefix(self, prefix: str) -> None:
        """Exempt keys under ``prefix`` from capacity eviction while a run
        is live. No-op for stores without an eviction budget."""

    def unpin_prefix(self, prefix: str) -> None:
        """Release a pin taken by :meth:`pin_prefix`."""


#: the process's slice-local disk tier, or None: the global shared prefix
#: registry spills exported KV blocks through it
ACTIVE_DISK_TIER: Optional[Store] = None


def _safe_rel(key: str) -> str:
    """Map a blob key to a safe relative path (no traversal, not absolute)."""
    parts = [p for p in key.split("/") if p not in ("", ".", "..")]
    if not parts:
        raise StorageError(f"invalid blob key {key!r}")
    return os.path.join(*parts)


class FileStore(Store):
    """Filesystem-backed store: one file a key under ``base_dir``, written
    to a temporary name and renamed into place."""

    provider = "file"

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.base_dir, _safe_rel(key))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise BlobNotFound(key) from None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list(self, prefix: str = "") -> list[str]:
        out = []
        for root, _, files in os.walk(self.base_dir):
            for fname in files:
                full = os.path.join(root, fname)
                key = os.path.relpath(full, self.base_dir).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def stat_mtime(self, key: str) -> float:
        try:
            return os.stat(self._path(key)).st_mtime
        except FileNotFoundError:
            raise BlobNotFound(key) from None


class SliceLocalSSDStore(FileStore):
    """A FileStore rooted at the slice-local disk, recording the slice
    identity.

    With ``capacity_bytes > 0`` it keeps a byte budget: access-order LRU
    (rebuilt in ``stat_mtime`` order on reopen, refreshed by put and get),
    pinned prefixes exempt (the budget yields to live-run data rather than
    evict it), and a blob larger than the whole budget refused. Eviction
    victims go to the optional ``on_evict`` callback. File IO happens
    outside the accounting lock."""

    provider = "slice-ssd"

    def __init__(self, base_dir: str, slice_id: str = "local", capacity_bytes: int = 0,
                 on_evict: Optional[Callable[[str], None]] = None):
        super().__init__(base_dir)
        self.slice_id = slice_id
        self.capacity_bytes = int(capacity_bytes or 0)
        self.on_evict = on_evict
        self._acct_lock = threading.Lock()
        #: key -> size, least to most recently used; rebuilt from on-disk
        #: mtimes so a reopened store evicts oldest first
        self._sizes: "OrderedDict[str, int]" = OrderedDict()
        self._used = 0
        #: pinned prefix -> refcount
        self._pins: dict[str, int] = {}
        self._rescan()

    def _rescan(self) -> None:
        entries: list[tuple[float, str, int]] = []
        for root, _, files in os.walk(self.base_dir):
            for fname in files:
                full = os.path.join(root, fname)
                if ".tmp." in fname:
                    continue  # a torn write's leftover, not a live blob
                try:
                    st = os.stat(full)
                except FileNotFoundError:  # pragma: no cover - race
                    continue
                key = os.path.relpath(full, self.base_dir).replace(os.sep, "/")
                entries.append((st.st_mtime, key, st.st_size))
        entries.sort()
        with self._acct_lock:
            self._sizes = OrderedDict((k, sz) for _, k, sz in entries)
            self._used = sum(sz for _, _, sz in entries)

    def _pinned(self, key: str) -> bool:
        """Caller holds ``_acct_lock``."""
        return any(n > 0 and key.startswith(p) for p, n in self._pins.items())

    def put(self, key: str, data: bytes) -> None:
        size = len(data)
        if self.capacity_bytes and size > self.capacity_bytes:
            raise StorageError(
                f"blob {key!r} ({size}B) exceeds slice-SSD capacity {self.capacity_bytes}B")
        super().put(key, data)
        victims: list[str] = []
        with self._acct_lock:
            old = self._sizes.pop(key, None)
            if old is not None:
                self._used -= old
            self._sizes[key] = size
            self._used += size
            if self.capacity_bytes and self._used > self.capacity_bytes:
                # LRU order, skipping pinned keys and the fresh write; when
                # only pinned entries remain the budget yields
                for k in list(self._sizes):
                    if self._used <= self.capacity_bytes:
                        break
                    if k == key or self._pinned(k):
                        continue
                    self._used -= self._sizes.pop(k)
                    victims.append(k)
        for k in victims:
            try:
                os.remove(self._path(k))
            except FileNotFoundError:
                pass
            if self.on_evict is not None:
                try:
                    self.on_evict(k)
                except Exception:  # noqa: BLE001 - a telemetry hook
                    pass

    def get(self, key: str) -> bytes:
        data = super().get(key)
        with self._acct_lock:
            if key in self._sizes:
                self._sizes.move_to_end(key)  # reads refresh recency
        return data

    def delete(self, key: str) -> None:
        with self._acct_lock:
            size = self._sizes.pop(key, None)
            if size is not None:
                self._used -= size
        super().delete(key)

    def used_bytes(self) -> int:
        with self._acct_lock:
            return self._used

    def pin_prefix(self, prefix: str) -> None:
        with self._acct_lock:
            self._pins[prefix] = self._pins.pop(prefix, 0) + 1

    def unpin_prefix(self, prefix: str) -> None:
        # unpinning a never-pinned prefix is tolerated
        with self._acct_lock:
            n = self._pins.pop(prefix, 0)
            if n > 1:
                self._pins[prefix] = n - 1


class MemoryStore(Store):
    """In-memory store, for tests."""

    provider = "memory"

    def __init__(self):
        self._blobs: dict[str, tuple[bytes, float]] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._blobs[key] = (bytes(data), time.time())

    def get(self, key: str) -> bytes:
        with self._lock:
            if key not in self._blobs:
                raise BlobNotFound(key)
            return self._blobs[key][0]

    def delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def stat_mtime(self, key: str) -> float:
        with self._lock:
            if key not in self._blobs:
                raise BlobNotFound(key)
            return self._blobs[key][1]
