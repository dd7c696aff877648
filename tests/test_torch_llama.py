"""The port's Llama model (bobrapet_tpu_torch.models) against the JAX
package, on the CPU, with JAX's weights carried over by the bridge.

Tolerances: fp32 logits within 2e-3 (as tests/test_compute.py holds the
JAX cached path to its own full forward); greedy tokens identical, for
the float tree and the int8 tree.
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


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, params_j, tllama.llama_tiny(), _bridge(params_j)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


class TestConfigAndParams:
    @pytest.mark.parametrize("preset", ["llama3_8b", "llama3_1b", "llama_tiny"])
    def test_presets_have_the_jax_widths(self, preset):
        cj = getattr(jllama, preset)()
        ct = getattr(tllama, preset)()
        fields = [f.name for f in dataclasses.fields(cj) if f.name != "dtype"]
        assert {f: getattr(ct, f) for f in fields} == {f: getattr(cj, f) for f in fields}
        assert str(ct.dtype).split(".")[-1] == jnp.dtype(cj.dtype).name
        assert ct.head_dim == cj.head_dim and ct.param_count == cj.param_count

    def test_init_params_has_the_jax_tree_layout(self, tiny):
        cfg_j, params_j, cfg_t, _ = tiny
        params_t = tllama.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
        shapes_j = jax.tree.map(lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name), params_j)
        shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                                params_t)
        assert shapes_t == shapes_j
        again = tllama.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
        assert torch.equal(again["layers"][1]["mlp"]["w_down"],
                           params_t["layers"][1]["mlp"]["w_down"])

    def test_bridge_keeps_bf16_bits_and_int8_leaves(self):
        w = jax.random.normal(jax.random.PRNGKey(3), (16, 8)).astype(jnp.bfloat16)
        tree = {"a": [w], "b": jquant.quantize_array(w)}
        out = _bridge(tree)
        assert out["a"][0].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["a"][0].view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
        assert tquant.is_quantized(out["b"])
        assert out["b"]["scale"].dtype == torch.bfloat16


class TestForward:
    def test_logits_match_jax(self, tiny):
        cfg_j, params_j, cfg_t, params_t = tiny
        toks = _tokens(1, (2, 16), cfg_j.vocab_size)
        ref, _ = jllama.forward(params_j, jnp.asarray(toks), cfg_j)
        out, cache = tllama.forward(params_t, torch.from_numpy(toks), cfg_t)
        assert cache is None and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)

    def test_cached_prefill_and_decode_match_jax(self, tiny):
        cfg_j, params_j, cfg_t, params_t = tiny
        toks = _tokens(2, (1, 12), cfg_j.vocab_size)
        full_j, _ = jllama.forward(params_j, jnp.asarray(toks), cfg_j)
        cache = tllama.init_cache(cfg_t, 1, capacity=32, device="cpu")
        pre, returned = tllama.forward(params_t, torch.from_numpy(toks[:, :8]), cfg_t,
                                       cache=cache, positions=torch.arange(8)[None, :])
        # the cache is consumed: written and advanced in place, and returned
        assert returned is cache
        assert [c["cursor"] for c in cache] == [8] * cfg_t.n_layers
        outs = [pre]
        for i in range(8, 12):
            step, cache = tllama.forward(params_t, torch.from_numpy(toks[:, i:i + 1]), cfg_t,
                                         cache=cache, positions=torch.tensor([[i]]))
            outs.append(step)
        np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), np.asarray(full_j),
                                   rtol=2e-3, atol=2e-3)

    def test_bf16_logits_match_jax(self):
        # bf16 activations round at the same points in both frameworks, but
        # the matmuls sum in another order, so a value may round to the
        # neighbouring bf16 number: allow two bf16 ulps of the largest
        # logit, and a mean error under 1e-3
        cfg_j = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.bfloat16)
        cfg_t = dataclasses.replace(tllama.llama_tiny(), dtype=torch.bfloat16)
        params_j = jllama.init_params(jax.random.PRNGKey(5), cfg_j)
        toks = _tokens(6, (2, 12), cfg_j.vocab_size)
        ref = np.asarray(jllama.forward(params_j, jnp.asarray(toks), cfg_j)[0])
        out = tllama.forward(_bridge(params_j), torch.from_numpy(toks), cfg_t)[0].numpy()
        err = np.abs(out - ref)
        assert err.max() <= 2 * 2.0 ** -7 * np.abs(ref).max()
        assert err.mean() < 1e-3


class TestGreedy:
    def test_tokens_identical_to_jax(self, tiny):
        cfg_j, params_j, cfg_t, params_t = tiny
        prompt = _tokens(3, (2, 8), cfg_j.vocab_size)
        ref = jllama.greedy_generate(params_j, jnp.asarray(prompt), cfg_j, max_new_tokens=10)
        out = tllama.greedy_generate(params_t, torch.from_numpy(prompt), cfg_t,
                                     max_new_tokens=10)
        assert out.shape == (2, 10)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    def test_int8_tree_tokens_identical_to_jax(self, tiny):
        cfg_j, params_j, cfg_t, params_t = tiny
        qparams_j = jquant.quantize_params(params_j)
        bridged = _bridge(qparams_j)
        # quantizing the bridged float tree gives JAX's int8 tree bit for bit
        local = tquant.quantize_params(params_t)
        assert torch.equal(local["lm_head"]["weight"]["q"], bridged["lm_head"]["weight"]["q"])
        assert torch.equal(local["layers"][0]["mlp"]["w_up"]["scale"],
                           bridged["layers"][0]["mlp"]["w_up"]["scale"])
        assert tquant.tree_bytes(bridged) == jquant.tree_bytes(qparams_j)
        prompt = _tokens(4, (2, 8), cfg_j.vocab_size)
        ref = jllama.greedy_generate(qparams_j, jnp.asarray(prompt), cfg_j, max_new_tokens=10)
        out = tllama.greedy_generate(bridged, torch.from_numpy(prompt), cfg_t,
                                     max_new_tokens=10)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    def test_runs_one_prefill_and_one_forward_per_token(self, tiny, monkeypatch):
        _, _, cfg_t, params_t = tiny
        calls = []
        forward = tllama.forward

        def counting_forward(p, t, c, **kw):
            calls.append(t.shape[1])
            return forward(p, t, c, **kw)

        monkeypatch.setattr(tllama, "forward", counting_forward)
        tllama.greedy_generate(params_t, torch.zeros(1, 5, dtype=torch.long), cfg_t,
                               max_new_tokens=4)
        assert calls == [5, 1, 1, 1, 1]

    def test_every_token_goes_through_the_pick(self, tiny, monkeypatch):
        """1 + max_new_tokens picks (the prefill's row, then one a decode
        step), each over contiguous all-greedy rows, and JAX's tokens."""
        cfg_j, params_j, cfg_t, params_t = tiny
        calls = []
        pick = tllama.pick_tokens

        def counting_pick(logits, *keyed):
            assert logits.is_contiguous() and not keyed
            calls.append(tuple(logits.shape))
            return pick(logits, *keyed)

        monkeypatch.setattr(tllama, "pick_tokens", counting_pick)
        prompt = _tokens(7, (3, 6), cfg_j.vocab_size)
        out = tllama.greedy_generate(params_t, torch.from_numpy(prompt), cfg_t, max_new_tokens=5)
        assert calls == [(3, cfg_t.vocab_size)] * (1 + 5)
        ref = jllama.greedy_generate(params_j, jnp.asarray(prompt), cfg_j, max_new_tokens=5)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    def test_capacity_error(self, tiny):
        _, _, cfg_t, params_t = tiny
        with pytest.raises(ValueError, match="exceeds cache capacity"):
            tllama.greedy_generate(params_t, torch.zeros(1, 8, dtype=torch.long), cfg_t,
                                   max_new_tokens=8, cache_capacity=12)
