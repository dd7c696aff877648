"""The rest of the port's int8 module against the JAX package, on the CPU:
``dequantize_params`` on bridged trees and ``init_quantized_params`` (the
tree ``bench.py`` builds for its int8 legs).

Tolerances: the widened tree is bit-identical (both sides multiply in fp32
and round once to the scale's dtype). The drawn tree matches JAX's in
structure, shapes, dtypes, skip list and scales exactly; its int8 values
are uniform in [-127, 127] (another generator: they cannot match JAX's
draws).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import quant as tquant
from bobrapet_tpu_torch.models.bridge import params_from_numpy


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _layout(tree):
    """Structure, shapes and dtype names of a tree (JAX's or the port's)."""
    def leaf(a):
        name = jnp.dtype(a.dtype).name if not isinstance(a, torch.Tensor) else str(
            a.dtype).split(".")[-1]
        return tuple(a.shape), name
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def configs(request):
    cfg_j = dataclasses.replace(jllama.llama_tiny(), dtype=getattr(jnp, request.param))
    cfg_t = dataclasses.replace(tllama.llama_tiny(), dtype=getattr(torch, request.param))
    return cfg_j, cfg_t


def test_dequantize_params_is_bit_identical_on_bridged_trees(configs):
    cfg_j, _ = configs
    qparams_j = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(3), cfg_j))
    want = jax.tree.map(np.asarray, jquant.dequantize_params(qparams_j))
    got = tquant.dequantize_params(_bridge(qparams_j))
    assert _layout(got) == _layout(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = params_from_numpy(w, "cpu")
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_dequantize_params_leaves_a_float_tree_alone(configs):
    _, cfg_t = configs
    params = tllama.init_params(cfg_t, torch.Generator().manual_seed(1), "cpu")
    out = tquant.dequantize_params(params)
    assert all(a is b for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(params)))


def test_init_quantized_params_has_the_jax_tree(configs):
    cfg_j, cfg_t = configs
    tree_j = jquant.init_quantized_params(jax.random.PRNGKey(0), cfg_j)
    tree_t = tquant.init_quantized_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    assert _layout(tree_t) == _layout(tree_j)
    # it is what quantize_params of a float tree looks like: the skip list
    # (the embedding) stays float, every other 2-D weight an int8 leaf
    assert _layout(tree_t) == _layout(tquant.quantize_params(
        tllama.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")))
    assert not tquant.is_quantized(tree_t["embed"]["weight"])
    leaves_j = [n for n in jax.tree.leaves(tree_j, is_leaf=jquant.is_quantized)
                if jquant.is_quantized(n)]
    leaves_t = [n for n in jax.tree.leaves(tree_t, is_leaf=tquant.is_quantized)
                if tquant.is_quantized(n)]
    assert len(leaves_t) == len(leaves_j) == 7 * cfg_t.n_layers + 1
    for lt, lj in zip(leaves_t, leaves_j):
        # the scales are JAX's, value for value
        assert torch.equal(lt["scale"], params_from_numpy(np.asarray(lj["scale"]), "cpu"))
        q = lt["q"]
        assert q.dtype == torch.int8 and int(q.min()) >= -127 and int(q.max()) <= 127
    # norms are ones, as JAX's
    assert torch.equal(tree_t["final_norm"]["weight"],
                       params_from_numpy(np.asarray(tree_j["final_norm"]["weight"]), "cpu"))


def test_init_quantized_params_draws_from_the_generator(configs):
    _, cfg_t = configs
    a = tquant.init_quantized_params(cfg_t, torch.Generator().manual_seed(7), "cpu")
    b = tquant.init_quantized_params(cfg_t, torch.Generator().manual_seed(7), "cpu")
    c = tquant.init_quantized_params(cfg_t, torch.Generator().manual_seed(8), "cpu")
    q = lambda t: t["layers"][1]["mlp"]["w_down"]["q"]  # noqa: E731
    assert torch.equal(q(a), q(b)) and not torch.equal(q(a), q(c))
    # the whole range is drawn: both ends of [-127, 127] appear in a large leaf
    lm = a["lm_head"]["weight"]["q"]
    assert int(lm.min()) == -127 and int(lm.max()) == 127


def test_init_quantized_params_runs_the_model_like_a_quantized_tree(configs):
    """The drawn tree goes through forward and greedy decode as any int8
    tree does (the plain products on the CPU)."""
    _, cfg_t = configs
    tree = tquant.init_quantized_params(cfg_t, torch.Generator().manual_seed(2), "cpu")
    prompt = torch.randint(0, cfg_t.vocab_size, (2, 5), generator=torch.Generator().manual_seed(3))
    logits, _ = tllama.forward(tree, prompt, cfg_t)
    assert logits.shape == (2, 5, cfg_t.vocab_size) and torch.isfinite(logits).all()
    toks = tllama.greedy_generate(tree, prompt, cfg_t, max_new_tokens=3, cuda_graph=False)
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
