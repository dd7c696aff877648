"""The parameter and state check shared by the port's train-step tests.

Adam's update is ``-lr * m / (sqrt(v) + 1e-8)``. For a gradient far from
zero that is ``-lr * sign(g)`` up to rounding; for a gradient within
``GRAD_FLOOR`` of zero (but not 0) the quotient turns a ~1e-7 difference
between two frameworks' gradients (sums in another order) into up to
``2 lr``, since ``g / (|g| + eps)`` swings between -1 and 1 there. So the
parameters are held to 1e-5 except at those elements, which are held to
``2 lr`` a step and counted; the optax state (count, first and second
moments, which follow the gradients) is held to 1e-5 everywhere.
"""

import jax
import numpy as np

from bobrapet_tpu_torch.tree import flatten_with_path

#: below this |gradient| Adam's normalized step is ill-conditioned: 100x the
#: largest gradient difference measured between the port and JAX (llama_tiny)
GRAD_FLOOR = 1e-5
B1 = 0.9


def by_path(tree, torch_side: bool) -> dict:
    """``{keystr path: float64 numpy}`` of a port tree or a JAX tree."""
    if torch_side:
        return {p: leaf.detach().double().numpy() for p, leaf in flatten_with_path(tree)}
    return {jax.tree_util.keystr(p): np.asarray(leaf, dtype=np.float64)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def step_gradient(mu_before: dict, mu_after: dict) -> dict:
    """A step's gradient from JAX's first moments before and after it."""
    return {k: (mu_after[k] - B1 * mu_before[k]) / (1 - B1) for k in mu_after}


def assert_state_and_params(jparams, jstate, tparams, tstate, grads: list, lr: float) -> int:
    """optax state to 1e-5; parameters to 1e-5 where every step's gradient
    (``grads``, one dict a step) was 0 or at least GRAD_FLOOR, else to 2 lr
    a step. Returns how many elements took the looser bound."""
    js, ts = by_path(jstate, False), by_path(tstate, True)
    assert list(js) == list(ts)
    for path in js:
        np.testing.assert_allclose(ts[path], js[path], rtol=1e-5, atol=1e-5, err_msg=path)
    jp, tp = by_path(jparams, False), by_path(tparams, True)
    assert list(jp) == list(tp)
    ill = 0
    for path in jp:
        err = np.abs(tp[path] - jp[path])
        small = np.zeros(err.shape, dtype=bool)
        for g in grads:
            small |= (np.abs(g[path]) < GRAD_FLOOR) & (g[path] != 0)
        ill += int(small.sum())
        assert err[~small].max(initial=0.0) <= 1e-5, path
        assert err[small].max(initial=0.0) <= 2 * lr * len(grads) + 1e-5, path
    return ill
