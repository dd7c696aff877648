"""Model checkpoints in the blob store, in the JAX package's layout.

The port's copy of the save and restore half of
``bobrapet_tpu/sdk/checkpoint.py``: a tree of nested dicts, lists and
tuples (the port's parameter trees, int8 ``{"q", "scale"}`` leaves and
stacked LoRA trees included) is written leaf by leaf and read back, and a
checkpoint written by either package restores in the other bit for bit.

Layout under ``<prefix>/ckpt-<step:012d>/``:

- ``manifest-<process:05d>.json``: the step, the tree's structure string,
  and per leaf its path, index, shape, dtype and the shard keys saved;
- ``leaf-<i>/<shard-key>``: raw little-endian bytes of one shard, the key
  its index range (``0-4_0-8``; ``scalar`` for a 0-d leaf).

Leaf ``i`` is the i-th leaf in JAX's flatten order (dict keys sorted,
sequences in order, ``None`` no leaf) and its path JAX's ``keystr``
(``['layers'][0]['attn']['wq']``), built here without JAX. bf16 has no
numpy type: its bytes travel as int16 and the manifest says
``bfloat16``. The port saves each leaf whole (one shard, from its one
device); a restore stitches a leaf from every shard blob that covers it,
so a tree JAX saved sharded over a mesh restores whole onto the port's
device.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..storage import BlobNotFound, Store
from ..tree import flatten_with_path

MANIFEST_PREFIX = "manifest-"

_TORCH_DTYPES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.uint8: "uint8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}
_BY_NAME = {name: dt for dt, name in _TORCH_DTYPES.items()}


class StorageMismatch(Exception):
    """Checkpoint structure does not match the restore target."""


def _manifest_key(process: int) -> str:
    return f"{MANIFEST_PREFIX}{process:05d}.json"


def _structure(tree: Any) -> str:
    """JAX's ``str(treedef)`` body for the same tree."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(_structure(v) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _unflatten(like: Any, leaves: list[Any]) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _shard_key(ranges: list[tuple[int, int]]) -> str:
    """Canonical key of a shard's global index range: ``start-stop_...``."""
    return "_".join(f"{a}-{b}" for a, b in ranges) if ranges else "scalar"


def _parse_shard_key(key: str) -> list[tuple[int, int]]:
    if key == "scalar":
        return []
    return [tuple(int(x) for x in p.split("-")) for p in key.split("_")]


def _leaf_bytes(leaf: Any) -> tuple[tuple[int, ...], str, bytes]:
    """(shape, dtype name, raw little-endian bytes) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        name = _TORCH_DTYPES.get(leaf.dtype)
        if name is None:
            raise TypeError(f"no checkpoint dtype for {leaf.dtype}")
        host = leaf.detach().contiguous().cpu()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        return tuple(leaf.shape), name, host.numpy().tobytes()
    arr = np.asarray(leaf)  # tobytes() is C order whatever the strides
    return arr.shape, str(arr.dtype), arr.tobytes()


def save_checkpoint(store: Store, prefix: str, state: Any, step: int, keep: int = 2,
                    process: Optional[int] = None, world: Optional[int] = None) -> str:
    """Write one checkpoint; returns its key prefix. Every leaf goes whole,
    as one shard. ``process`` and ``world`` name this writer among a gang's
    (the port runs one process: 0 of 1 unless told): manifests of
    processes at or past ``world`` are removed (only when the world size is
    certain: not with an explicit ``process`` alone), and checkpoints
    beyond the newest ``keep`` are pruned."""
    process_explicit = process is not None
    if process is None:
        process = 0
    ckpt = f"{prefix}/ckpt-{step:012d}"
    manifest: dict[str, Any] = {"step": int(step), "treedef": f"PyTreeDef({_structure(state)})",
                                "leaves": []}
    for i, (path, leaf) in enumerate(flatten_with_path(state)):
        shape, dtype, data = _leaf_bytes(leaf)
        key = _shard_key([(0, d) for d in shape])
        store.put(f"{ckpt}/leaf-{i}/{key}", data)
        manifest["leaves"].append({"path": path, "index": i, "shape": list(shape),
                                   "dtype": dtype, "shards": [key]})
    store.put(f"{ckpt}/{_manifest_key(process)}",
              json.dumps(manifest, separators=(",", ":")).encode())
    if world is None and not process_explicit:
        world = 1
    if world is not None:
        for key in store.list(f"{ckpt}/{MANIFEST_PREFIX}"):
            idx = int(key.rsplit(MANIFEST_PREFIX, 1)[1].removesuffix(".json"))
            if idx >= max(world, process + 1):
                store.delete(key)
    if keep > 0:
        for old in sorted(checkpoint_steps(store, prefix))[:-keep]:
            delete_checkpoint(store, prefix, old)
    return ckpt


def _load_merged_manifest(store: Store, ckpt: str) -> dict[str, Any]:
    """Union of every process's manifest: same structure, shard lists merged."""
    keys = store.list(f"{ckpt}/{MANIFEST_PREFIX}")
    if not keys:
        raise BlobNotFound(f"{ckpt}/{MANIFEST_PREFIX}*")
    merged: Optional[dict[str, Any]] = None
    for key in keys:
        m = json.loads(store.get(key))
        if merged is None:
            merged = m
            continue
        if m["treedef"] != merged["treedef"] or len(m["leaves"]) != len(merged["leaves"]):
            raise StorageMismatch(f"{ckpt}: manifests disagree on checkpoint structure")
        for ours, theirs in zip(merged["leaves"], m["leaves"]):
            if ours["path"] != theirs["path"] or ours["shape"] != theirs["shape"]:
                raise StorageMismatch(f"{ckpt}: manifests disagree on leaf {ours['path']!r}")
            for shard in theirs["shards"]:
                if shard not in ours["shards"]:
                    ours["shards"].append(shard)
    return merged


def checkpoint_steps(store: Store, prefix: str) -> list[int]:
    """Steps with a manifest-bearing checkpoint, ascending."""
    steps = set()
    for key in store.list(f"{prefix}/ckpt-"):
        tail = key[len(prefix) + 1:]
        if f"/{MANIFEST_PREFIX}" in tail:
            steps.add(int(tail.split("/")[0].removeprefix("ckpt-")))
    return sorted(steps)


def latest_checkpoint_step(store: Store, prefix: str) -> Optional[int]:
    steps = checkpoint_steps(store, prefix)
    return steps[-1] if steps else None


def _manifest_covers(manifest: dict[str, Any]) -> bool:
    """Every leaf's shards cover its whole shape (shards are disjoint, so
    coverage is the sum of their volumes)."""
    for entry in manifest["leaves"]:
        total = int(np.prod(entry["shape"], dtype=np.int64))
        covered = 0
        for key in entry["shards"]:
            vol = 1
            for start, stop in _parse_shard_key(key):
                vol *= stop - start
            covered += vol
        if covered < total:
            return False
    return True


def latest_restorable_checkpoint_step(store: Store, prefix: str) -> Optional[int]:
    """The newest step whose merged manifests cover every leaf completely
    (a save cut short leaves the newest step partial). Reads manifests
    only."""
    for step in reversed(checkpoint_steps(store, prefix)):
        try:
            if _manifest_covers(_load_merged_manifest(store, f"{prefix}/ckpt-{step:012d}")):
                return step
        except (BlobNotFound, StorageMismatch, ValueError, KeyError):
            continue
    return None


def delete_checkpoint(store: Store, prefix: str, step: int) -> None:
    for key in store.list(f"{prefix}/ckpt-{step:012d}"):
        store.delete(key)


def _np_dtype(name: str) -> np.dtype:
    """The numpy type the bytes are stitched in: bf16 as int16 (same size)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _stitch(store: Store, ckpt: str, entry: dict[str, Any],
            want: list[tuple[int, int]]) -> np.ndarray:
    """The global index range ``want`` of one leaf, from its shard blobs."""
    dtype = _np_dtype(entry["dtype"])
    out_shape = tuple(stop - start for start, stop in want)
    i = entry["index"]
    exact = _shard_key(want)
    if exact in entry["shards"]:
        # a writable copy: the caller hands it to torch
        data = store.get(f"{ckpt}/leaf-{i}/{exact}")
        return np.frombuffer(bytearray(data), dtype=dtype).reshape(out_shape)
    out = np.empty(out_shape, dtype=dtype)
    filled = 0
    for key in entry["shards"]:
        ranges = _parse_shard_key(key)
        overlap = []
        for (ws, we), (ss, se) in zip(want, ranges):
            s, e = max(ws, ss), min(we, se)
            if s >= e:
                overlap = None
                break
            overlap.append((s, e, ss, ws))
        if overlap is None:
            continue
        shard = np.frombuffer(store.get(f"{ckpt}/leaf-{i}/{key}"), dtype=dtype).reshape(
            tuple(se - ss for ss, se in ranges))
        src = tuple(slice(s - ss, e - ss) for (s, e, ss, _ws) in overlap)
        dst = tuple(slice(s - ws, e - ws) for (s, e, _ss, ws) in overlap)
        out[dst] = shard[src]
        n = 1
        for s, e, _, _ in overlap:
            n *= e - s
        filled += n
    total = int(np.prod(out_shape, dtype=np.int64))
    if filled < total:
        raise BlobNotFound(
            f"{ckpt}/leaf-{i}: saved shards cover {filled}/{total} elements of requested "
            f"range {want} (shape {tuple(entry['shape'])})")
    return out


def _target_device(leaf: Any, device: Optional[torch.device]) -> torch.device:
    if device is not None:
        return device
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return resolve_device(None)


def restore_checkpoint(store: Store, prefix: str, like: Any, step: Optional[int] = None,
                       device: DeviceLike = None) -> tuple[Any, int]:
    """Load a checkpoint into the structure of ``like``; returns
    ``(state, step)``.

    ``like`` gives the structure only; its values are never read, so it may
    live on ``torch.device("meta")``. A tensor leaf comes back as a tensor
    of the saved dtype on ``device``, else on the template leaf's device,
    else (a meta or non-tensor template) on the card; a numpy leaf as a
    numpy array; a Python scalar as one. Without ``step`` the newest
    checkpoint that restores wins (a save cut short falls back to the one
    before). Raises ``BlobNotFound`` when there is none."""
    target = None if device is None else torch.device(device)
    if step is not None:
        return _restore_one(store, prefix, like, step, target)
    steps = checkpoint_steps(store, prefix)
    if not steps:
        raise BlobNotFound(f"{prefix}: no checkpoint found")
    last_err: Exception = BlobNotFound(f"{prefix}: no checkpoint found")
    for candidate in reversed(steps):
        try:
            return _restore_one(store, prefix, like, candidate, target)
        except (BlobNotFound, StorageMismatch, ValueError, KeyError) as e:
            last_err = e
    raise last_err


def _restore_one(store: Store, prefix: str, like: Any, step: int,
                 device: Optional[torch.device]) -> tuple[Any, int]:
    ckpt = f"{prefix}/ckpt-{step:012d}"
    manifest = _load_merged_manifest(store, ckpt)
    leaves = flatten_with_path(like)
    entries = manifest["leaves"]
    if len(entries) != len(leaves):
        raise StorageMismatch(f"{ckpt}: checkpoint has {len(entries)} leaves, target "
                              f"structure has {len(leaves)}")
    restored = []
    for (path, leaf), entry in zip(leaves, entries):
        if entry["path"] != path:
            raise StorageMismatch(f"{ckpt}: leaf order mismatch — saved {entry['path']!r}, "
                                  f"target {path!r}")
        data = _stitch(store, ckpt, entry, [(0, d) for d in entry["shape"]])
        bf16 = entry["dtype"] == "bfloat16"
        if isinstance(leaf, torch.Tensor):
            if entry["dtype"] not in _BY_NAME:
                raise StorageMismatch(f"{ckpt}: leaf {path!r} has dtype {entry['dtype']}, "
                                      "which torch does not hold")
            t = torch.from_numpy(data)
            restored.append((t.view(torch.bfloat16) if bf16 else t).to(
                _target_device(leaf, device)))
        elif bf16:
            # numpy has no bf16: such a leaf comes back as a CPU tensor
            restored.append(torch.from_numpy(data).view(torch.bfloat16))
        elif isinstance(leaf, np.ndarray) or entry["shape"]:
            restored.append(data)
        else:
            restored.append(data.reshape(()).item())
    return _unflatten(like, restored), int(manifest["step"])
