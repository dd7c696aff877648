"""Trees of nested dicts, lists and tuples, in JAX's order, without JAX."""

from __future__ import annotations

from typing import Any


def flatten_with_path(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """``[(keystr path, leaf)]`` in JAX's flatten order: dict keys sorted,
    sequences in order, ``None`` no leaf, and each path what
    ``jax.tree_util.keystr`` gives (``['layers'][0]['wq']``; a named
    tuple's fields by name in field order, ``[0].mu['embed']``, as optax's
    states flatten)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name in tree._fields
                for pair in flatten_with_path(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]
