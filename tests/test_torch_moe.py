"""The port's sparse-MoE family against the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX's weights are carried over with the
bridge. Held here:

- ``MoEConfig``: JAX's fields in JAX's order, the presets, ``capacity``;
- the bridged tree: JAX's ``init_params`` tree unchanged (structure, shapes
  and bits), and the port's ``init_params`` in the same layout;
- ``route_topk``: dispatch bit for bit, ties included (rows of bf16 logits
  with equal maxima, which ``torch.topk`` may order otherwise), at a
  droppy and at the no-drop capacity. Combine bit for bit on every row
  where XLA's fp32 ``exp`` and torch's give the same bits for the row's
  centred logits; XLA's CPU ``exp`` is not correctly rounded and differs
  from torch's on ~8% of values, so on the other rows combine is held
  within 2 fp32 ulps (rtol 2^-22). aux within 1e-6 relative;
- the plain route, dispatch and combine against their definitions (JAX's
  one-hot algorithm written out in numpy; the einsums), the plain combine
  against JAX's fp32 einsum within 1 fp32 ulp of the terms' magnitude
  before the cast (XLA may contract a product and an add into one FMA,
  which skips one product's rounding);
- ``moe_mlp_block`` and ``forward`` (logits within 2e-3, the port's fp32
  model tolerance of tests/test_torch_llama.py; aux within 1e-5 relative);
- ``greedy_generate`` tokens identical to JAX's, and the dense
  ``greedy_generate`` through the ``forward_fn`` hook identical to its
  default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import moe as jmoe
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import moe as tmoe
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.ops import (
    moe_combine_reference,
    moe_dispatch_reference,
    moe_route_reference,
)

#: fp32 ulps of the route's combine where XLA's exp and torch's differ
ROUTE_RTOL = 2.0 ** -22


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one torch thread a test worker: the default pools slow six workers down
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jmoe.moe_tiny()
    params_j = jmoe.init_params(jax.random.PRNGKey(0), cfg_j)
    return {"cfg_j": cfg_j, "cfg_t": tmoe.moe_tiny(), "params": (params_j, _bridge(params_j))}


def _route_logits(seed: int, t: int, e: int, ties: bool) -> np.ndarray:
    """fp32 router logits; with ``ties`` rounded through bf16 at a coarse
    scale, so equal maxima (and equal probabilities) are common."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4
        x[::3, 1] = x[::3, 2] = x[::3].max(axis=1) + 0.25  # top-2 tied at 1 and 2
        x[1::5, :] = x[1::5, :1]                           # a whole row equal
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _rows_with_same_exp(x: np.ndarray) -> np.ndarray:
    """Rows whose centred logits XLA's and torch's fp32 exp round alike."""
    centred = x - x.max(axis=1, keepdims=True)
    ej = np.asarray(jnp.exp(jnp.asarray(centred)))
    et = torch.exp(torch.from_numpy(centred)).numpy()
    return (ej == et).all(axis=1)


class TestConfig:
    def test_fields_are_jax_fields_in_jax_order(self):
        fj = [f.name for f in dataclasses.fields(jmoe.MoEConfig)]
        assert [f.name for f in dataclasses.fields(tmoe.MoEConfig)] == fj
        # tie_embeddings is a class attribute the shared LM head reads, not a field
        assert tmoe.MoEConfig.tie_embeddings is False

    @pytest.mark.parametrize("preset", ["mixtral_8x7b", "moe_tiny"])
    def test_presets_match(self, preset):
        cj, ct = getattr(jmoe, preset)(), getattr(tmoe, preset)()
        for f in dataclasses.fields(cj):
            if f.name != "dtype":
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert str(ct.dtype).split(".")[-1] == jnp.dtype(cj.dtype).name
        assert ct.head_dim == cj.head_dim
        lj, lt = cj.as_llama(), ct.as_llama()
        for f in dataclasses.fields(lj):
            if f.name != "dtype":
                assert getattr(lt, f.name) == getattr(lj, f.name), f.name
        assert lt.tie_embeddings is False

    @pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 8.0])
    def test_capacity_matches(self, factor):
        cj = dataclasses.replace(jmoe.mixtral_8x7b(), capacity_factor=factor)
        ct = dataclasses.replace(tmoe.mixtral_8x7b(), capacity_factor=factor)
        for t in (1, 3, 8, 16, 64, 100, 1024):
            assert ct.capacity(t) == cj.capacity(t)


class TestTree:
    def test_bridged_tree_is_jax_tree_unchanged(self, tiny):
        params_j, params_t = tiny["params"]
        assert jax.tree.structure(params_t) == jax.tree.structure(params_j)
        assert set(params_t["layers"][0]["moe"]) == {"w_router", "w_gate", "w_up", "w_down"}
        for leaf_t, leaf_j in zip(jax.tree.leaves(params_t), jax.tree.leaves(params_j)):
            assert tuple(leaf_t.shape) == leaf_j.shape
            np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))

    def test_port_init_params_has_jax_layout(self):
        cfg_t = tmoe.moe_tiny()
        params_t = tmoe.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
        params_j = jmoe.init_params(jax.random.PRNGKey(0), jmoe.moe_tiny())
        shapes_j = jax.tree.map(lambda a: a.shape, params_j)
        shapes_t = jax.tree.map(lambda a: tuple(a.shape), params_t)
        assert shapes_t == shapes_j
        assert all(leaf.dtype == torch.float32 for leaf in jax.tree.leaves(params_t))


class TestRoute:
    @pytest.mark.parametrize("t,e,k", [(8, 4, 2), (64, 8, 2), (100, 8, 2), (33, 4, 1),
                                       (40, 8, 3)])
    @pytest.mark.parametrize("ties", [False, True])
    @pytest.mark.parametrize("factor", [1.25, None])
    def test_route_topk_matches_jax(self, t, e, k, ties, factor):
        cj = dataclasses.replace(jmoe.moe_tiny(), n_experts=e, experts_per_token=k,
                                 capacity_factor=factor or float(e))
        ct = dataclasses.replace(tmoe.moe_tiny(), n_experts=e, experts_per_token=k,
                                 capacity_factor=factor or float(e))
        x = _route_logits(t * 31 + e, t, e, ties)
        dj, cmb_j, aux_j = jmoe.route_topk(jnp.asarray(x), cj)
        dt, cmb_t, aux_t = tmoe.route_topk(torch.from_numpy(x), ct)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        cmb_j, cmb_t = np.asarray(cmb_j), cmb_t.numpy()
        same = _rows_with_same_exp(x)
        assert same.mean() > 0.3  # the exact hold covers many rows
        np.testing.assert_array_equal(cmb_t[same], cmb_j[same])
        np.testing.assert_allclose(cmb_t, cmb_j, rtol=ROUTE_RTOL, atol=0)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)

    def test_ties_go_to_the_lower_index_as_lax_top_k(self):
        row = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0, 0.1, 0.3]], np.float32)
        _, want = jax.lax.top_k(jnp.asarray(row), 2)
        expert, *_ = moe_route_reference(torch.from_numpy(row), 2, 4)
        assert expert.tolist() == np.asarray(want).tolist() == [[1, 2]]

    def test_bf16_router_logits_route_as_their_fp32_values(self):
        x = _route_logits(5, 64, 8, ties=True)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = moe_route_reference(xb, 2, 16)
        want = moe_route_reference(torch.from_numpy(x), 2, 16)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _onehot_route(x: np.ndarray, k: int, c: int):
    """JAX's route_topk written out in numpy (float64 softmax, then every
    step as there): (expert, slot, kept) from the one-hot cumsum."""
    t, e = x.shape
    z = np.exp(x.astype(np.float64) - x.max(1, keepdims=True))
    probs = z / z.sum(1, keepdims=True)
    expert = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    onehot = np.eye(e, dtype=np.int64)[expert]              # [T, K, E]
    flat = onehot.reshape(t * k, e)
    pos = (np.cumsum(flat, 0) - flat).reshape(t, k, e)
    slot = (pos * onehot).sum(-1)
    return expert, slot, slot < c


class TestPlainDefinitions:
    @pytest.mark.parametrize("t,e,k,c", [(16, 4, 2, 10), (64, 8, 2, 128), (50, 8, 2, 12),
                                         (20, 4, 1, 3)])
    def test_route_against_the_onehot_algorithm(self, t, e, k, c):
        x = _route_logits(t + c, t, e, ties=True)
        expert, slot, gate, src, counts, probsum = moe_route_reference(torch.from_numpy(x), k, c)
        want_e, want_s, kept = _onehot_route(x, k, c)
        np.testing.assert_array_equal(expert.numpy(), want_e)
        np.testing.assert_array_equal(slot.numpy(), want_s)
        src_want = np.full((e, c), -1)
        for ti in range(t):
            for ki in range(k):
                if kept[ti, ki]:
                    src_want[want_e[ti, ki], want_s[ti, ki]] = ti
        np.testing.assert_array_equal(src.numpy(), src_want)
        np.testing.assert_array_equal(counts.numpy(), np.bincount(want_e.ravel(), minlength=e))
        probs = torch.softmax(torch.from_numpy(x), -1)
        np.testing.assert_allclose(probsum.numpy(), probs.sum(0).numpy(), rtol=1e-6)
        chosen = probs.gather(1, expert.long())
        np.testing.assert_allclose(gate.numpy(), (chosen / chosen.sum(1, keepdim=True)).numpy(),
                                   rtol=2.0 ** -21)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dispatch_is_the_onehot_einsum(self, dtype):
        t, e, k, c, d = 24, 4, 2, 10, 16
        x = _route_logits(7, t, e, ties=False)
        expert, slot, _, src, *_ = moe_route_reference(torch.from_numpy(x), k, c)
        h = torch.from_numpy(np.random.default_rng(8).standard_normal((t, d))).to(dtype)
        onehot = torch.zeros((t, e, c))
        kept = slot < c
        tok = torch.arange(t)[:, None].expand(t, k)[kept]
        onehot[tok, expert.long()[kept], slot.long()[kept]] = 1
        want = torch.einsum("tec,td->ecd", onehot, h.float()).to(dtype)
        got = moe_dispatch_reference(h, src)
        assert got.dtype == dtype and torch.equal(got, want)
        assert kept.sum() < t * k  # the capacity dropped some (t, k)

    @pytest.mark.parametrize("factor", [1.25, None])
    def test_combine_is_the_onehot_einsum(self, factor):
        t, e, k, d = 40, 4, 2, 32
        cj = dataclasses.replace(jmoe.moe_tiny(), n_experts=e, capacity_factor=factor or 4.0)
        c = cj.capacity(t)
        x = _route_logits(9, t, e, ties=True)
        expert, slot, gate, *_ = moe_route_reference(torch.from_numpy(x), k, c)
        out = torch.from_numpy(np.random.default_rng(10).standard_normal((e, c, d))
                               .astype(np.float32))
        got = moe_combine_reference(out, expert, slot, gate)
        # the definition with each product and add rounded on its own
        want = torch.zeros((t, d))
        for ti in range(t):
            for ki in range(k):
                if slot[ti, ki] < c:
                    want[ti] = want[ti] + gate[ti, ki] * out[expert[ti, ki], slot[ti, ki]]
        assert torch.equal(got, want)
        # JAX's fp32 einsum over the one-hot combine: an FMA skips the
        # rounding of one product, so within 1 ulp of the terms' magnitude
        _, cmb, _ = tmoe.route_topk(torch.from_numpy(x), dataclasses.replace(
            tmoe.moe_tiny(), n_experts=e, capacity_factor=factor or 4.0))
        ref = np.asarray(jnp.einsum("tec,ecd->td", jnp.asarray(cmb.numpy()),
                                    jnp.asarray(out.numpy())))
        terms = torch.einsum("tec,ecd->td", cmb.abs(), out.abs()).numpy()
        assert (np.abs(got.numpy() - ref) <= 2.0 ** -23 * terms).all()

    def test_combine_casts_once_to_the_rows_type(self):
        t, e, k, c, d = 12, 4, 2, 6, 24
        x = _route_logits(11, t, e, ties=False)
        expert, slot, gate, *_ = moe_route_reference(torch.from_numpy(x), k, c)
        out = torch.from_numpy(np.random.default_rng(12).standard_normal((e, c, d))
                               .astype(np.float32))
        got = moe_combine_reference(out.to(torch.bfloat16), expert, slot, gate)
        want = moe_combine_reference(out.to(torch.bfloat16).float(), expert, slot, gate)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))


class TestModel:
    def test_moe_mlp_block_matches_jax(self, tiny):
        params_j, params_t = tiny["params"]
        rng = np.random.default_rng(20)
        x = rng.standard_normal((2, 9, 128)).astype(np.float32)
        delta = rng.standard_normal((2, 9, 128)).astype(np.float32) * 0.1
        layer_j, layer_t = params_j["layers"][1], params_t["layers"][1]
        want, _ = jmoe.moe_mlp_block(layer_j, jnp.asarray(x) + jnp.asarray(delta),
                                     tiny["cfg_j"])
        s, y = tmoe.moe_mlp_block(layer_t, torch.from_numpy(x), torch.from_numpy(delta),
                                  tiny["cfg_t"])
        np.testing.assert_array_equal(s.numpy(), x + delta)
        np.testing.assert_allclose((s + y).numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
        assert y.dtype == torch.float32 and tuple(y.shape) == x.shape

    @pytest.mark.parametrize("b,s", [(1, 7), (2, 16), (3, 5)])
    def test_forward_matches_jax(self, tiny, b, s):
        params_j, params_t = tiny["params"]
        toks = np.random.default_rng(21 + s).integers(0, 512, (b, s))
        lj, _, aux_j = jmoe.forward(params_j, jnp.asarray(toks), tiny["cfg_j"])
        lt, cache, aux_t = tmoe.forward(params_t, torch.from_numpy(toks), tiny["cfg_t"])
        assert cache is None and lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)

    def test_forward_with_cache_matches_jax(self, tiny):
        params_j, params_t = tiny["params"]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        toks = np.random.default_rng(22).integers(0, 512, (2, 10))
        cj = jmoe.init_cache(cfg_j, 2, 16)
        pos = np.broadcast_to(np.arange(10), (2, 10))
        lj, cj, _ = jmoe.forward(params_j, jnp.asarray(toks), cfg_j, cache=cj,
                                 positions=jnp.asarray(pos))
        ct = tmoe.init_cache(cfg_t, 2, 16, device="cpu")
        lt, ct, _ = tmoe.forward(params_t, torch.from_numpy(toks), cfg_t, cache=ct,
                                 positions=torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-3, atol=2e-3)
        for layer_j, layer_t in zip(cj, ct):
            assert layer_t["cursor"] == int(layer_j["cursor"]) == 10
            np.testing.assert_allclose(layer_t["k"].numpy(), np.asarray(layer_j["k"]),
                                       rtol=2e-3, atol=2e-3)

    @pytest.mark.parametrize("b,prompt,new", [(1, 7, 6), (2, 12, 8), (3, 20, 5)])
    def test_greedy_generate_tokens_identical(self, tiny, b, prompt, new):
        params_j, params_t = tiny["params"]
        toks = np.random.default_rng(23 + prompt).integers(0, 512, (b, prompt))
        want = jmoe.greedy_generate(params_j, jnp.asarray(toks, jnp.int32), tiny["cfg_j"],
                                    max_new_tokens=new)
        got = tmoe.greedy_generate(params_t, torch.from_numpy(toks), tiny["cfg_t"],
                                   max_new_tokens=new)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(want).tolist()

    def test_greedy_generate_no_drop_tokens_identical(self, tiny):
        params_j, params_t = tiny["params"]
        cj = dataclasses.replace(tiny["cfg_j"], capacity_factor=4.0)
        ct = dataclasses.replace(tiny["cfg_t"], capacity_factor=4.0)
        toks = np.random.default_rng(24).integers(0, 512, (2, 15))
        want = jmoe.greedy_generate(params_j, jnp.asarray(toks, jnp.int32), cj, max_new_tokens=6)
        got = tmoe.greedy_generate(params_t, torch.from_numpy(toks), ct, max_new_tokens=6)
        assert got.tolist() == np.asarray(want).tolist()

    def test_dense_greedy_through_the_hook_is_the_default(self):
        cfg_j = jllama.llama_tiny()
        params_t = _bridge(jllama.init_params(jax.random.PRNGKey(1), cfg_j))
        cfg_t = tllama.llama_tiny()
        prompt = torch.from_numpy(np.random.default_rng(25).integers(0, 512, (2, 9)))

        def fwd(p, t, c, cache, pos):
            return tllama.forward(p, t, c, cache=cache, positions=pos)

        base = tllama.greedy_generate(params_t, prompt, cfg_t, max_new_tokens=6)
        hooked = tllama.greedy_generate(params_t, prompt, cfg_t, max_new_tokens=6,
                                        forward_fn=fwd)
        assert torch.equal(base, hooked)
