"""AdamW with optax's state, order and casts, in PyTorch.

The JAX package trains with ``optax.adamw(learning_rate, b1=0.9, b2=0.999,
eps=1e-8, weight_decay=...)`` and calls nothing else of optax but
``apply_updates``. :func:`adamw` is that chain, ``scale_by_adam``, then
``add_decayed_weights``, then ``scale_by_learning_rate``, with optax's
state tree ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``,
so a state saved by the JAX package restores here leaf for leaf
(:func:`models.bridge.opt_state_from_numpy`) under the same checkpoint
paths (:func:`tree.flatten_with_path`). ``torch.optim.AdamW`` orders the
steps otherwise and keeps another state, so it is not used.

The moments stay in the parameter's type, as optax keeps them. Nothing is
written in place: every step returns new tensors, as optax's do.
:meth:`AdamW.step` is optax's ``update`` then ``apply_updates`` (``p + u``
cast to p's type) with the same arithmetic, a leaf at a time, releasing
each gradient once used, so a train step at Llama-3-8B width holds one
leaf's temporaries beside the trees and not a whole tree of updates.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32, 0-d
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    pass


#: the state classes by optax's names, for carrying a state across
NAMED_STATES = {"ScaleByAdamState": ScaleByAdamState, "EmptyState": EmptyState}


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts and lists and the leaves
    of ``rest`` at the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, in its own order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _walk3(fn: Callable[..., tuple], p: Any, g: Any, mu: Any, nu: Any) -> tuple[Any, Any, Any]:
    """Three new trees shaped like ``p`` from ``fn(g, mu, nu, p)`` at each
    leaf, walked by key; each gradient leaf is released from ``g`` once
    used."""
    if isinstance(p, dict):
        keys, a, b, c = list(p), {}, {}, {}
    else:
        keys, a, b, c = range(len(p)), [None] * len(p), [None] * len(p), [None] * len(p)
    for k in keys:
        if isinstance(p[k], (dict, list)):
            a[k], b[k], c[k] = _walk3(fn, p[k], g[k], mu[k], nu[k])
        else:
            a[k], b[k], c[k] = fn(g[k], mu[k], nu[k], p[k])
            g[k] = None
    return a, b, c


class AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`` with a
    constant learning rate and no mask: ``init`` as optax's, and
    :meth:`step` for optax's ``update`` and ``apply_updates``."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: Any) -> tuple:
        device = tree_leaves(params)[0].device
        return (ScaleByAdamState(torch.zeros((), dtype=torch.int32, device=device),
                                 tree_map(torch.zeros_like, params),
                                 tree_map(torch.zeros_like, params)),
                EmptyState(), EmptyState())

    def _bias_corrections(self, count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``1 - decay ** count`` in fp32 for both moments, as optax takes
        it; each moment divides by it cast to its own type."""
        def one(decay: float) -> torch.Tensor:
            base = torch.tensor(decay, dtype=torch.float32, device=count.device)
            return 1 - base ** count.to(torch.float32)

        return one(self.b1), one(self.b2)

    def _leaf(self, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, p: torch.Tensor,
              bc1: torch.Tensor, bc2: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``(u, mu, nu)`` of one leaf, each step in optax's order, in the
        leaf's type."""
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * g ** 2 + self.b2 * nu
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
        u = (u + self.weight_decay * p) * (-self.learning_rate)
        return u, mu, nu

    def step(self, grads: Any, state: tuple, params: Any) -> tuple[Any, tuple]:
        """optax's ``update`` then ``apply_updates``, a leaf at a time: ``(new
        params, new state)``. Each leaf of ``grads`` (a tree of dicts and
        lists shaped like ``params``) is released from it once used, so the
        caller that hands over its only reference frees the gradients as the
        step goes."""
        adam = state[0]
        count = adam.count + 1
        bc1, bc2 = self._bias_corrections(count)

        def leaf(g, m, n, p):
            u, m, n = self._leaf(g, m, n, p, bc1, bc2)
            return (p + u).to(p.dtype), m, n

        new_params, mu, nu = _walk3(leaf, params, grads, adam.mu, adam.nu)
        return new_params, (ScaleByAdamState(count, mu, nu), state[1], state[2])


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` (constant learning rate, no mask)."""
    return AdamW(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
