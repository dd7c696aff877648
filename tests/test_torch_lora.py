"""The port's multi-LoRA (bobrapet_tpu_torch.models.lora, ``forward(lora=)``
and the serving engine's adapters) against the JAX package, on the CPU.

Adapters are made by JAX (``init_lora`` with B filled with small random
values, as tests/test_serving.py::TestMultiLoRA makes them) and carried
over with the bridge, stacked trees included. Tolerances: the LoRA
functions and fp32 logits within 2e-3 (the fp32 model tolerance of
test_torch_llama.py), bf16 logits within two bf16 ulps of the largest
logit (a matmul sums in another order); greedy tokens identical; the
stacking, selection and zero adapter bit for bit. Engines are stepped in
lockstep with JAX's at H = 1, 2 and 8 on TestMultiLoRA's scenarios (see
tests/torch_lockstep.py), and adapter 0 gives the LoRA-free engine's
tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import lora as jlora
from bobrapet_tpu.serving import engine as jengine
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import lora as tlora
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from tests.torch_lockstep import bridge, engines, outputs, prompt, run_lockstep

LCFG = dict(rank=4, alpha=8.0, sites=("wq", "wv"))


def _adapters(cfg_j, lcfg, seeds=(1, 2)):
    """The zero adapter, then one per seed with B given content."""
    out = [jlora.zero_lora(cfg_j, lcfg)]
    for seed in seeds:
        a = jlora.init_lora(jax.random.PRNGKey(seed), cfg_j, lcfg)
        out.append(jax.tree_util.tree_map(
            lambda leaf: leaf + 0.05 * jax.random.normal(
                jax.random.PRNGKey(seed + 10), leaf.shape, leaf.dtype), a))
    return out


@pytest.fixture(scope="module")
def setup():
    cfg_j = jllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    lcfg = jlora.LoRAConfig(**LCFG)
    adapters = _adapters(cfg_j, lcfg)
    stacked = jlora.stack_adapters(adapters)
    return {"cfg_j": cfg_j, "cfg_t": tllama.llama_tiny(), "params": (params_j, bridge(params_j)),
            "lcfg": lcfg, "adapters": adapters, "stacked": (stacked, bridge(stacked))}


@pytest.fixture(autouse=True)
def _einsum_route(monkeypatch):
    # JAX's default paged route; the Pallas route would need a TPU anyway
    monkeypatch.delenv("BOBRA_PALLAS_PAGED", raising=False)


def _shapes(tree, torch_side):
    if torch_side:
        return jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    return jax.tree.map(lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name), tree)


class TestLoRAFunctions:
    def test_config_matches_jax(self):
        for kw in ({}, LCFG):
            cj, ct = jlora.LoRAConfig(**kw), tlora.LoRAConfig(**kw)
            assert dataclasses.asdict(cj) == dataclasses.asdict(ct) and cj.scale == ct.scale
        assert tlora.ATTN_SITES == jlora.ATTN_SITES and tlora.MLP_SITES == jlora.MLP_SITES

    @pytest.mark.parametrize("sites", [("wq", "wv"), jlora.ATTN_SITES + jlora.MLP_SITES])
    def test_init_and_zero_have_the_jax_layout(self, setup, sites):
        lcfg_j = jlora.LoRAConfig(rank=4, sites=sites)
        lcfg_t = tlora.LoRAConfig(rank=4, sites=sites)
        cfg_t = setup["cfg_t"]
        made = tlora.init_lora(torch.Generator().manual_seed(0), cfg_t, lcfg_t, "cpu")
        want = jlora.init_lora(jax.random.PRNGKey(0), setup["cfg_j"], lcfg_j)
        assert _shapes(made, True) == _shapes(want, False)
        for layer in made["layers"]:
            for site in sites:
                assert not layer[site]["b"].any() and layer[site]["a"].std() > 0.1
        zero = tlora.zero_lora(cfg_t, lcfg_t, "cpu")
        assert _shapes(zero, True) == _shapes(jlora.zero_lora(setup["cfg_j"], lcfg_j), False)
        assert all(not leaf.any() for leaf in jax.tree.leaves(zero))

    def test_stack_select_and_bridge_are_bit_identical(self, setup):
        """A stacked JAX tree crosses by the bridge as it is; stacking the
        bridged adapters in the port gives the same tensors, and selecting
        gives each adapter back."""
        stacked_j, stacked_t = setup["stacked"]
        restacked = tlora.stack_adapters([bridge(a) for a in setup["adapters"]])
        assert jax.tree.structure(restacked) == jax.tree.structure(stacked_t)
        for a, b in zip(jax.tree.leaves(restacked), jax.tree.leaves(stacked_t)):
            assert torch.equal(a, b)
        for i, adapter in enumerate(setup["adapters"]):
            got = tlora.select_adapter(stacked_t, i)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(adapter)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(jax.tree.leaves(got),
                            jax.tree.leaves(jlora.select_adapter(stacked_j, i))):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_lora_delta_and_slots_match_jax(self, setup, dtype):
        rng = np.random.default_rng(3)
        jdt = jnp.dtype(dtype)
        stacked_j, _ = setup["stacked"]
        site_j = jax.tree.map(lambda a: a.astype(jdt), stacked_j["layers"][1]["wv"])
        site_t = bridge(site_j)
        x = jnp.asarray(rng.standard_normal((3, 5, 128), dtype=np.float32)).astype(jdt)
        xt = bridge(x)
        tol = 2e-3 if dtype == "float32" else None
        for i in range(3):
            want = np.asarray(jlora.lora_delta(x, jlora.select_adapter(site_j, i), 2.0),
                              np.float32)
            got = tlora.lora_delta(xt, tlora.select_adapter(site_t, i), 2.0).float().numpy()
            self._close(got, want, tol)
        idx = np.asarray([2, 0, 1], np.int32)
        want = np.asarray(jengine._lora_delta_slots(x, site_j, jnp.asarray(idx), 2.0), np.float32)
        got = tlora.lora_delta_slots(xt, site_t, torch.from_numpy(idx), 2.0).float().numpy()
        self._close(got, want, tol)
        assert not got[1].any()  # the zero adapter adds exact zeros
        assert tlora.lora_delta(xt, None, 2.0).shape == ()

    @staticmethod
    def _close(got, want, tol):
        if tol is not None:
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        else:  # two bf16 ulps of the largest value
            assert np.abs(got - want).max() <= 2 * 2.0 ** -7 * np.abs(want).max()

    def test_merge_lora_matches_jax(self, setup):
        params_j, params_t = setup["params"]
        adapter = setup["adapters"][1]
        want = jlora.merge_lora(params_j, adapter, 2.0)
        got = tlora.merge_lora(params_t, bridge(adapter), 2.0)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
        # the base tree is left as it was
        assert torch.equal(params_t["layers"][0]["attn"]["wq"],
                           bridge(params_j)["layers"][0]["attn"]["wq"])


class TestForwardWithLoRA:
    @pytest.mark.parametrize("adapter", [0, 1, 2])
    def test_fp32_logits_and_tokens_match_jax(self, setup, adapter):
        params_j, params_t = setup["params"]
        cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
        toks = np.random.default_rng(adapter).integers(0, cfg_j.vocab_size, (2, 14))
        lora_j = setup["adapters"][adapter]
        ref = np.asarray(jllama.forward(params_j, jnp.asarray(toks), cfg_j, lora=lora_j,
                                        lora_scale=2.0)[0])
        out = tllama.forward(params_t, torch.from_numpy(toks), cfg_t, lora=bridge(lora_j),
                             lora_scale=2.0)[0].numpy()
        np.testing.assert_allclose(out, ref, atol=2e-3, rtol=2e-3)
        np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
        base = tllama.forward(params_t, torch.from_numpy(toks), cfg_t)[0].numpy()
        if adapter == 0:
            np.testing.assert_array_equal(out, base)  # zeros add nothing
        else:
            assert np.abs(out - base).max() > 1e-3

    def test_every_site_and_the_cache_match_jax(self, setup):
        """All seven sites, through a cached prefill and one decode step."""
        params_j, params_t = setup["params"]
        cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
        lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, sites=jlora.ATTN_SITES + jlora.MLP_SITES)
        lora_j = _adapters(cfg_j, lcfg, seeds=(3,))[1]
        toks = np.random.default_rng(9).integers(0, cfg_j.vocab_size, (1, 9))
        ref = np.asarray(jllama.forward(params_j, jnp.asarray(toks), cfg_j, lora=lora_j,
                                        lora_scale=2.0)[0])
        cache = tllama.init_cache(cfg_t, 1, 16, device="cpu")
        lora_t = bridge(lora_j)
        pre = tllama.forward(params_t, torch.from_numpy(toks[:, :8]), cfg_t, cache=cache,
                             positions=torch.arange(8)[None], lora=lora_t, lora_scale=2.0)[0]
        last = tllama.forward(params_t, torch.from_numpy(toks[:, 8:]), cfg_t, cache=cache,
                              positions=torch.tensor([[8]]), lora=lora_t, lora_scale=2.0)[0]
        got = torch.cat([pre, last], dim=1).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)

    def test_bf16_logits_match_jax(self, setup):
        cfg_j = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.bfloat16)
        cfg_t = dataclasses.replace(tllama.llama_tiny(), dtype=torch.bfloat16)
        params_j = jllama.init_params(jax.random.PRNGKey(5), cfg_j)
        lora_j = jax.tree.map(lambda a: a.astype(jnp.bfloat16), setup["adapters"][2])
        toks = np.random.default_rng(6).integers(0, cfg_j.vocab_size, (2, 12))
        ref = np.asarray(jllama.forward(params_j, jnp.asarray(toks), cfg_j, lora=lora_j,
                                        lora_scale=2.0)[0])
        out = tllama.forward(bridge(params_j), torch.from_numpy(toks), cfg_t,
                             lora=bridge(lora_j), lora_scale=2.0)[0].numpy()
        err = np.abs(out - ref)
        assert err.max() <= 2 * 2.0 ** -7 * np.abs(ref).max()
        assert err.mean() < 1e-3


def _waves_each_adapter(vocab):
    p = prompt(np.random.default_rng(70), 11, vocab)
    return [([(p, 5, {"adapter": i}) for i in range(3)], None)]


def _waves_mixed(vocab):
    rng = np.random.default_rng(71)
    prompts = [prompt(rng, 7 + 3 * i, vocab) for i in range(3)]
    return [([(p, 4, {"adapter": i}) for i, p in enumerate(prompts)], None)]


def _waves_adapter_scoped_prefix(vocab):
    system = prompt(np.random.default_rng(72), 16, vocab)
    return [([(system + [1], 2, {"adapter": 1}), (system + [2], 2, {"adapter": 2}),
              (system + [3], 2, {"adapter": 1})], None)]


def _waves_chunked_mix(vocab):
    """Chunked ingest under an adapter beside decoding slots of others,
    the base request submitted with no adapter at all."""
    rng = np.random.default_rng(73)
    system = prompt(rng, 16, vocab)
    return [([(system + prompt(rng, 30, vocab), 4, {"adapter": 2}),
              (prompt(rng, 6, vocab), 9, {"adapter": 1}), (prompt(rng, 9, vocab), 7, {})], None),
            ([(system + prompt(rng, 20, vocab), 3, {"adapter": 2})], None)]


SCENARIOS = {
    "each_adapter": (_waves_each_adapter, {}),
    "mixed_adapters_decode_fused": (_waves_mixed, {}),
    "prefix_cache_is_adapter_scoped": (_waves_adapter_scoped_prefix, {}),
    "chunked_prefix_and_adapters": (_waves_chunked_mix, {"prefill_chunk": 16,
                                                         "max_blocks_per_seq": 8}),
}


def _pcfg(**kw):
    return {**dict(max_slots=3, block_size=8, num_blocks=64, max_blocks_per_seq=6), **kw}


class TestEngineLockstep:
    @pytest.mark.parametrize("horizon", [1, 2, 8])
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_same_state_and_tokens_as_jax(self, setup, name, horizon):
        build, pc = SCENARIOS[name]
        params_j, params_t = setup["params"]
        jeng, teng = engines(params_j, params_t, setup["cfg_j"], setup["cfg_t"], _pcfg(**pc),
                             horizon, loras=setup["stacked"], lora_scale=setup["lcfg"].scale)
        assert teng.n_adapters == jeng.n_adapters == 3
        run_lockstep(jeng, teng, build(setup["cfg_t"].vocab_size))
        out = outputs(teng)
        if name == "each_adapter":
            assert out[1] != out[0] and out[2] != out[0]
        if name == "prefix_cache_is_adapter_scoped":
            # only the same-adapter pair shared the 16-token system prompt
            assert teng.blocks.hit_tokens == 16
        if name == "chunked_prefix_and_adapters":
            assert teng.blocks.hit_tokens == 16 and teng.phase_counts["chunks"] > 0

    def test_adapters_match_the_merged_weights(self, setup):
        """Each adapter's tokens are the LoRA-free engine's over the merged
        weights (JAX's reference for TestMultiLoRA), and adapter 0's are the
        LoRA-free engine's over the base weights, exactly."""
        _, params_t = setup["params"]
        cfg_t = setup["cfg_t"]
        p = prompt(np.random.default_rng(70), 11, cfg_t.vocab_size)
        merged = [params_t] + [tlora.merge_lora(params_t, bridge(a), 2.0)
                               for a in setup["adapters"][1:]]
        eng = ServingEngine(params_t, cfg_t, PagedConfig(**_pcfg()), loras=setup["stacked"][1],
                            lora_scale=2.0, decode_horizon=8, dispatch_depth=1)
        rids = [eng.submit(p, 6, adapter=i) for i in range(3)]
        eng.run()
        got = outputs(eng)
        for i, rid in enumerate(rids):
            ref = ServingEngine(merged[i], cfg_t, PagedConfig(**_pcfg()), decode_horizon=8,
                                dispatch_depth=1)
            ref.submit(p, 6)
            assert got[rid] == ref.run()[0].output, f"adapter {i}"

    def test_out_of_range_adapter_rejected(self, setup):
        _, params_t = setup["params"]
        eng = ServingEngine(params_t, setup["cfg_t"], PagedConfig(**_pcfg()),
                            loras=setup["stacked"][1], decode_horizon=1, dispatch_depth=1)
        for bad in (7, 3, -1):
            with pytest.raises(ValueError, match="adapter"):
                eng.submit([1, 2, 3], max_new_tokens=2, adapter=bad)
        plain = ServingEngine(params_t, setup["cfg_t"], PagedConfig(**_pcfg()),
                              decode_horizon=1, dispatch_depth=1)
        assert plain.n_adapters == 1
        with pytest.raises(ValueError, match="adapter"):
            plain.submit([1, 2, 3], max_new_tokens=2, adapter=1)

    def test_unstacked_tree_rejected(self, setup):
        _, params_t = setup["params"]
        with pytest.raises(ValueError, match="stacked"):
            ServingEngine(params_t, setup["cfg_t"], PagedConfig(**_pcfg()),
                          loras=bridge(setup["adapters"][1]), decode_horizon=1,
                          dispatch_depth=1)

    def test_adapters_off_the_weights_device_rejected(self, setup):
        _, params_t = setup["params"]
        meta = jax.tree.map(lambda t: t.to("meta"), setup["stacked"][1])
        with pytest.raises(ValueError, match="adapters must live with the weights"):
            ServingEngine(params_t, setup["cfg_t"], PagedConfig(**_pcfg()), loras=meta,
                          decode_horizon=1, dispatch_depth=1)
