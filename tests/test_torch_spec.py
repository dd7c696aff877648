"""Speculative decoding in the port (serving/spec_decode.py, the engine's
draft path, models/speculative.py) against the JAX package, on the CPU.

Inputs come from numpy seeds and JAX's weights are carried over with the
bridge. Two drafts: the target's own int8 tree (``quantize_params`` on each
side from the same weights, bit-identical: a draft that mostly agrees), and
a separate random one-layer model (a draft that mostly disagrees). Held:

- ``ops.paged_attention_multi_reference`` within 2e-4 of JAX's
  ``_paged_attention_multi`` (the JAX package's attention tolerance) at
  T = 1, 2, 5, 8, with lanes at block edges;
- ``_model_append``, ``_spec_step``, ``_draft_append`` and
  ``_draft_sync_block`` against JAX's on the same pools: identical tokens,
  proposals and choices, logits and written K/V within 2e-3 (the fp32 model
  tolerance of test_torch_llama.py), every other pool row untouched;
- ``speculative_generate`` against JAX's: identical tokens, rounds, drafted
  and accepted, and ``greedy_generate``'s tokens;
- ``ServingEngine`` with a draft stepped in lockstep with JAX's
  (``spec_guard=False``, ``dispatch_depth=1``) at H = 1, 2, 8 on
  tests/test_serving.py's TestSpeculativeServing scenarios and requests
  that fill their tables (tests/torch_lockstep.py: slots, blocks, free
  list, queue, prefix cache, outputs, drafted and accepted, horizons
  after every step), and every speculative engine's outputs equal to the
  draft-less engine's;
- the payoff guard's decision on injected samples equal to JAX's, a guarded
  engine reaching a decision with exact tokens, and the constructor's
  refusals (JAX's checks and messages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import lora as jlora
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu.models import speculative as jspec
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu.serving import spec_decode as jsd
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import quant as tquant
from bobrapet_tpu_torch.models import speculative_generate
from bobrapet_tpu_torch.ops import paged_attention_multi_reference, paged_attention_reference
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from bobrapet_tpu_torch.serving import spec_decode as tsd
from tests.torch_lockstep import (
    assert_same_state,
    bridge,
    engines,
    outputs,
    prompt,
    run_lockstep,
)

ATTN_TOL, MODEL_TOL = 2e-4, 2e-3


def _draft_cfgs(vocab, max_seq_len):
    """The random one-layer draft of tests/test_serving.py::spec_models."""
    common = dict(vocab_size=vocab, dim=64, n_layers=1, n_heads=2, n_kv_heads=2,
                  ffn_hidden=128, max_seq_len=max_seq_len)
    return (jllama.LlamaConfig(**common, dtype=jnp.float32),
            tllama.LlamaConfig(**common, dtype=torch.float32))


@pytest.fixture(scope="module")
def models():
    cfg_j = jllama.llama_tiny()
    cfg_t = tllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge(params_j)
    dcfg_j, dcfg_t = _draft_cfgs(cfg_j.vocab_size, cfg_j.max_seq_len)
    dparams_j = jllama.init_params(jax.random.PRNGKey(7), dcfg_j)
    qparams_j = jquant.quantize_params(params_j)
    return {
        "cfg": (cfg_j, cfg_t), "params": (params_j, params_t),
        "drafts": {
            # (JAX tree, port tree, JAX config, port config)
            "self_int8": (qparams_j, tquant.quantize_params(params_t), cfg_j, cfg_t),
            "tiny": (dparams_j, bridge(dparams_j), dcfg_j, dcfg_t),
            "perfect": (params_j, params_t, cfg_j, cfg_t),
        },
        "qparams_bridged": bridge(qparams_j),
    }


@pytest.fixture(autouse=True)
def _einsum_route(monkeypatch):
    # JAX's default paged route; the Pallas route would need a TPU anyway
    monkeypatch.delenv("BOBRA_PALLAS_PAGED", raising=False)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_self_int8_draft_is_bit_identical_on_both_sides(models):
    port, bridged = models["drafts"]["self_int8"][1], models["qparams_bridged"]
    assert all(torch.equal(a, b) for a, b in zip(_leaves(port), _leaves(bridged)))
    assert any(x.dtype == torch.int8 for x in _leaves(port))


# ---------------------------------------------------------------------------
# T-query paged attention
# ---------------------------------------------------------------------------


def _paged_state(rng, n_layers, hkv, d, slots=4, n_blocks=24, block=8, mb=4):
    """Random pools [L, N, B, Hkv, D] and tables of distinct live blocks
    (lane 0 all scratch: an inactive lane)."""
    kp = rng.standard_normal((n_layers, n_blocks, block, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_layers, n_blocks, block, hkv, d)).astype(np.float32)
    ids = rng.permutation(n_blocks - 1) + 1
    tables = np.zeros((slots, mb), np.int32)
    tables[1:] = ids[:(slots - 1) * mb].reshape(slots - 1, mb)
    return kp, vp, tables


@pytest.mark.parametrize("t", [1, 2, 5, 8])
def test_paged_multi_reference_matches_jax(models, t):
    rng = np.random.default_rng(t)
    hq, hkv, d, block = 4, 2, 32, 8
    kp, vp, tables = _paged_state(rng, 2, hkv, d, block=block)
    # queries from position 0, ending on a block's last row, starting one
    # past a block edge, and crossing a block edge
    pos0 = np.array([0, block - t if t < block else 0, block, 2 * block - 1], np.int32)
    q = rng.standard_normal((4, t, hq, d)).astype(np.float32)
    positions = pos0[:, None] + np.arange(t)[None, :]
    ref = jsd._paged_attention_multi(
        jnp.asarray(q), {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}, jnp.asarray(tables),
        jnp.asarray(positions), 1, models["cfg"][0])
    lens = torch.from_numpy(pos0 + t)
    got = paged_attention_multi_reference(torch.from_numpy(q), torch.from_numpy(kp[1]),
                                          torch.from_numpy(vp[1]), torch.from_numpy(tables), lens)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATTN_TOL, rtol=0)
    if t == 1:  # one query a slot: the one-query version
        one = paged_attention_reference(torch.from_numpy(q[:, 0]), torch.from_numpy(kp[1]),
                                        torch.from_numpy(vp[1]), torch.from_numpy(tables), lens)
        np.testing.assert_allclose(got[:, 0].numpy(), one.numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the device functions of spec_decode.py against JAX's
# ---------------------------------------------------------------------------


def _pools(kp, vp):
    return ({"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
            {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())})


def _written(pos0, write_ok, tables, block):
    """{(block id, offset)} of the live writes (scratch block 0 excluded)."""
    out = set()
    for s in range(write_ok.shape[0]):
        for t in range(write_ok.shape[1]):
            if write_ok[s, t]:
                p = int(pos0[s]) + t
                out.add((int(tables[s, p // block]), p % block))
    return out


def _check_pools(jpools, tpools, init, written):
    """Written rows within MODEL_TOL of JAX's; every other row of every
    block but the scratch block bit-identical to the initial pools."""
    for name in ("k", "v"):
        got, want, before = tpools[name].numpy(), np.asarray(jpools[name]), init[name]
        mask = np.zeros(got.shape[1:3], bool)
        for blk, off in written:
            mask[blk, off] = True
        mask[0] = False
        np.testing.assert_allclose(got[:, mask], want[:, mask], atol=MODEL_TOL, rtol=0)
        untouched = ~mask
        untouched[0] = False
        assert np.array_equal(got[:, untouched], before[:, untouched])


def _pcfg(slots, **kw):
    base = dict(max_slots=slots, block_size=8, num_blocks=24, max_blocks_per_seq=4)
    return JPagedConfig(**base, **kw), PagedConfig(**base, **kw)


@pytest.mark.parametrize("t", [1, 3])
def test_model_append_matches_jax(models, t):
    cfg_j, cfg_t = models["cfg"]
    params_j, params_t = models["params"]
    rng = np.random.default_rng(10 + t)
    kp, vp, tables = _paged_state(rng, cfg_t.n_layers, cfg_t.n_kv_heads, cfg_t.head_dim)
    jp, tp = _pools(kp, vp)
    pos0 = np.array([0, 5, 8, 20], np.int32)
    tokens = rng.integers(0, cfg_t.vocab_size, (4, t)).astype(np.int32)
    write_ok = np.ones((4, t), bool)
    write_ok[0] = False          # an inactive lane
    write_ok[2, t - 1] = False   # a masked token of a live lane
    pj, pt = _pcfg(4)
    jpools, jlogits = jsd._model_append(
        params_j, jp, jnp.asarray(tokens), jnp.asarray(pos0), jnp.asarray(write_ok),
        jnp.asarray(tables), cfg=cfg_j, pcfg=pj, T=t)
    tpools, tlogits = tsd._model_append(
        params_t, tp, torch.from_numpy(tokens), torch.from_numpy(pos0),
        torch.from_numpy(write_ok), torch.from_numpy(tables), cfg=cfg_t, pcfg=pt, T=t)
    live = write_ok.any(axis=1)
    np.testing.assert_allclose(tlogits.numpy()[live], np.asarray(jlogits)[live], atol=MODEL_TOL,
                               rtol=0)
    assert np.array_equal(tlogits.numpy()[live].argmax(-1), np.asarray(jlogits)[live].argmax(-1))
    _check_pools(jpools, tpools, {"k": kp, "v": vp}, _written(pos0, write_ok, tables, 8))


@pytest.mark.parametrize("draft", ["self_int8", "tiny"])
@pytest.mark.parametrize("k", [1, 4])
def test_spec_step_matches_jax(models, draft, k):
    cfg_j, cfg_t = models["cfg"]
    params_j, params_t = models["params"]
    dj, dt, dcfg_j, dcfg_t = models["drafts"][draft]
    rng = np.random.default_rng(20 + k)
    kp, vp, tables = _paged_state(rng, cfg_t.n_layers, cfg_t.n_kv_heads, cfg_t.head_dim)
    dkp, dvp, _ = _paged_state(rng, dcfg_t.n_layers, dcfg_t.n_kv_heads, dcfg_t.head_dim)
    jp, tp = _pools(kp, vp)
    jdp, tdp = _pools(dkp, dvp)
    seq = np.array([1, 6, 9, 17], np.int32)
    last = rng.integers(0, cfg_t.vocab_size, 4).astype(np.int32)
    active = np.array([False, True, True, True])
    spec_ok = np.array([False, True, False, True])  # lane 2 commits the plain token
    pj, pt = _pcfg(4)
    jpools, jdpools, jprops, jchoice, _ = jsd._spec_step(
        params_j, dj, jp, jdp, jnp.asarray(last), jnp.asarray(seq), jnp.asarray(active),
        jnp.asarray(spec_ok), jnp.asarray(tables), jnp.zeros(4, jnp.float32),
        jax.random.PRNGKey(0), jnp.zeros(4, jnp.int32), jnp.arange(4, dtype=jnp.int32), None,
        jnp.zeros(4, jnp.int32), cfg=cfg_j, dcfg=dcfg_j, pcfg=pj, k=k)
    tpools, tdpools, tprops, tchoice = tsd._spec_step(
        params_t, dt, tp, tdp, torch.from_numpy(last), torch.from_numpy(seq),
        torch.from_numpy(active), torch.from_numpy(spec_ok), torch.from_numpy(tables),
        cfg=cfg_t, dcfg=dcfg_t, pcfg=pt, k=k)
    assert tprops.dtype == tchoice.dtype == torch.int32
    assert np.array_equal(tprops.numpy()[active], np.asarray(jprops)[active])
    assert np.array_equal(tchoice.numpy()[active], np.asarray(jchoice)[active])
    pos0 = seq - 1
    verify_ok = active[:, None] & (spec_ok[:, None] | (np.arange(k + 1) == 0)[None, :])
    _check_pools(jpools, tpools, {"k": kp, "v": vp}, _written(pos0, verify_ok, tables, 8))
    draft_ok = active[:, None] & (spec_ok[:, None] | (np.arange(k + 1) == 0)[None, :])
    _check_pools(jdpools, tdpools, {"k": dkp, "v": dvp}, _written(pos0, draft_ok, tables, 8))


def test_draft_append_matches_jax(models):
    dj, dt, dcfg_j, dcfg_t = models["drafts"]["tiny"]
    rng = np.random.default_rng(30)
    kp, vp, tables = _paged_state(rng, dcfg_t.n_layers, dcfg_t.n_kv_heads, dcfg_t.head_dim)
    jp, tp = _pools(kp, vp)
    seq = np.array([1, 8, 9, 32], np.int32)
    last = rng.integers(0, dcfg_t.vocab_size, 4).astype(np.int32)
    active = np.array([False, True, True, True])
    pj, pt = _pcfg(4)
    jpools = jsd._draft_append(dj, jp, jnp.asarray(last), jnp.asarray(seq), jnp.asarray(active),
                               jnp.asarray(tables), dcfg=dcfg_j, pcfg=pj)
    tpools = tsd._draft_append(dt, tp, torch.from_numpy(last), torch.from_numpy(seq),
                               torch.from_numpy(active), torch.from_numpy(tables), dcfg=dcfg_t,
                               pcfg=pt)
    _check_pools(jpools, tpools, {"k": kp, "v": vp},
                 _written(seq - 1, active[:, None], tables, 8))


@pytest.mark.parametrize("h", [2, 8])
def test_draft_sync_block_matches_jax(models, h):
    dj, dt, dcfg_j, dcfg_t = models["drafts"]["self_int8"]
    rng = np.random.default_rng(40 + h)
    kp, vp, tables = _paged_state(rng, dcfg_t.n_layers, dcfg_t.n_kv_heads, dcfg_t.head_dim)
    jp, tp = _pools(kp, vp)
    seq0 = np.array([1, 3, 8, 15], np.int32)
    last0 = rng.integers(0, dcfg_t.vocab_size, 4).astype(np.int32)
    toks = rng.integers(0, dcfg_t.vocab_size, (h, 4)).astype(np.int32)
    em0 = np.array([0, 2, 5, 1], np.int32)
    em1 = em0 + np.array([0, h, h // 2, 1], np.int32)  # lanes that took 0, all, some, 1 steps
    pj, pt = _pcfg(4)
    jpools = jsd._draft_sync_block(dj, jp, jnp.asarray(toks), jnp.asarray(last0),
                                   jnp.asarray(seq0), jnp.asarray(em0), jnp.asarray(em1),
                                   jnp.asarray(tables), dcfg=dcfg_j, pcfg=pj, H=h)
    tpools = tsd._draft_sync_block(dt, tp, torch.from_numpy(toks), torch.from_numpy(last0),
                                   torch.from_numpy(seq0), torch.from_numpy(em0),
                                   torch.from_numpy(em1), torch.from_numpy(tables), dcfg=dcfg_t,
                                   pcfg=pt, H=h)
    taken = np.arange(h)[None, :] < (em1 - em0)[:, None]
    _check_pools(jpools, tpools, {"k": kp, "v": vp}, _written(seq0 - 1, taken, tables, 8))


# ---------------------------------------------------------------------------
# standalone speculative decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["self_int8", "tiny", "perfect"])
@pytest.mark.parametrize("k", [1, 4])
def test_speculative_generate_matches_jax_and_greedy(models, draft, k):
    cfg_j, cfg_t = models["cfg"]
    params_j, params_t = models["params"]
    dj, dt, dcfg_j, dcfg_t = models["drafts"][draft]
    p = prompt(np.random.default_rng(50 + k), 9, cfg_t.vocab_size)
    n = 14
    want = jspec.speculative_generate(params_j, dj, jnp.asarray([p], jnp.int32), cfg_j, dcfg_j,
                                      max_new_tokens=n, k=k)
    got = speculative_generate(params_t, dt, torch.tensor([p]), cfg_t, dcfg_t, max_new_tokens=n,
                               k=k)
    assert got.tokens.dtype == torch.int32 and got.tokens.shape == (n,)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert (got.rounds, got.drafted, got.accepted) == (
        int(want.rounds), int(want.drafted), int(want.accepted))
    greedy = tllama.greedy_generate(params_t, torch.tensor([p]), cfg_t, max_new_tokens=n)
    assert got.tokens.tolist() == greedy[0].tolist()
    if draft == "perfect":
        # every proposal matches: k + 1 tokens a round until the budget
        assert got.rounds == -(-(n - 1) // (k + 1))


def test_speculative_generate_refuses_a_batch_and_an_overlong_request(models):
    _, cfg_t = models["cfg"]
    _, params_t = models["params"]
    with pytest.raises(ValueError, match="single-sequence"):
        speculative_generate(params_t, params_t, torch.zeros((2, 4), dtype=torch.long), cfg_t,
                             cfg_t)
    with pytest.raises(ValueError, match="exceeds capacity"):
        speculative_generate(params_t, params_t, torch.zeros((1, 4), dtype=torch.long), cfg_t,
                             cfg_t, max_new_tokens=8, cache_capacity=12)


# ---------------------------------------------------------------------------
# the engine in lockstep with JAX's
# ---------------------------------------------------------------------------


def _w_token_identical(vocab):
    return {}, [([([1, 2, 3, 4, 5], 12, {}), ([9, 8, 7], 12, {}),
                  (list(range(11, 18)), 12, {})], None)]


def _w_eos_in_accept_window(vocab, eos):
    return {}, [([([5, 6, 7], 16, {"eos_token": eos}), ([4, 4, 2, 9], 16, {})], None)]


def _w_commit_jump(vocab):
    # prompt of 11: seq_len 12 after the prefill; a full accept jumps to 17
    return {}, [([(list(range(1, 12)), 7, {})], None)]


def _w_block_exhaustion(vocab):
    return ({"max_slots": 2, "num_blocks": 8, "max_blocks_per_seq": 4},
            [([([1, 2, 3, 4, 5, 6], 8, {}), ([9, 8, 7, 6, 5], 8, {})], None)])


def _w_prefix_chunked(vocab):
    # the second request comes after the first registered its blocks
    long = list(range(1, 41))
    return ({"max_slots": 2, "prefill_chunk": 16},
            [([(list(long), 6, {})], None), ([(long[:24] + [49, 50], 6, {})], None)])


def _w_fills_its_table(vocab):
    # prompt + budget == capacity (32): the last rounds' verify rows run past
    # the table, and their K/V must not land on the slot's committed positions
    return ({"max_slots": 3, "max_blocks_per_seq": 4},
            [([(list(range(1, 21)), 12, {}), (list(range(30, 55)), 7, {}),
               (list(range(60, 89)), 3, {})], None)])


SCENARIOS = {
    "token_identical": _w_token_identical,
    "eos_inside_accept_window": None,   # built from the plain engine's tokens
    "commit_jump_over_block_boundary": _w_commit_jump,
    "block_exhaustion_degrades_to_plain": _w_block_exhaustion,
    "prefix_cache_with_chunked_prefill": _w_prefix_chunked,
    "request_fills_its_table": _w_fills_its_table,
}
BASE_PCFG = dict(max_slots=4, block_size=8, num_blocks=64, max_blocks_per_seq=8)


def _plain_outputs(params_t, cfg_t, pcfg, waves, horizon, **kw):
    """The draft-less port engine's outputs on the same waves."""
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**pcfg), pipeline_decode=False,
                        decode_horizon=horizon, dispatch_depth=1, **kw)
    for requests, _ in waves:
        for p, budget, skw in requests:
            eng.submit(p, budget, **skw)
        eng.run()
    return outputs(eng)


def _eos_waves(models, vocab):
    _, params_t = models["params"]
    _, cfg_t = models["cfg"]
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**BASE_PCFG), decode_horizon=1,
                        dispatch_depth=1)
    eng.submit([5, 6, 7], 16)
    return _w_eos_in_accept_window(vocab, eng.run()[0].output[4])


class TestEngineLockstep:
    @pytest.mark.parametrize("horizon", [1, 2, 8])
    @pytest.mark.parametrize("draft", ["self_int8", "tiny"])
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_same_state_and_tokens_as_jax(self, models, name, draft, horizon):
        cfg_j, cfg_t = models["cfg"]
        params_j, params_t = models["params"]
        vocab = cfg_t.vocab_size
        pc, waves = (_eos_waves(models, vocab) if name == "eos_inside_accept_window"
                     else SCENARIOS[name](vocab))
        pcfg = {**BASE_PCFG, **pc}
        jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, pcfg, horizon,
                             draft=models["drafts"][draft], spec_k=4, spec_guard=False)
        run_lockstep(jeng, teng, waves)
        assert teng.spec_drafted > 0  # speculation ran
        assert outputs(teng) == _plain_outputs(params_t, cfg_t, pcfg, waves, horizon)
        if horizon > 1:
            assert teng.phase_counts["spec_rounds"] > 0
        if name == "prefix_cache_with_chunked_prefill":
            assert teng.blocks.hit_tokens > 0 and teng.phase_counts["chunks"] > 0
            assert teng.phase_counts["draft_prefills"] == teng.phase_counts["prefills"]
        if name == "eos_inside_accept_window":
            assert outputs(teng)[0][-1] == waves[0][0][0][2]["eos_token"]

    @pytest.mark.parametrize("horizon", [1, 2, 8])
    @pytest.mark.parametrize("draft", ["self_int8", "tiny"])
    def test_multi_lora_in_the_verify(self, models, draft, horizon):
        cfg_j, cfg_t = models["cfg"]
        params_j, params_t = models["params"]
        lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, sites=("wq", "wv"))
        adapters = [jlora.zero_lora(cfg_j, lcfg)]
        for seed in (1, 2):
            a = jlora.init_lora(jax.random.PRNGKey(seed), cfg_j, lcfg)
            adapters.append(jax.tree_util.tree_map(
                lambda leaf, s=seed: leaf + 0.05 * jax.random.normal(
                    jax.random.PRNGKey(s + 10), leaf.shape, leaf.dtype), a))
        stacked = jlora.stack_adapters(adapters)
        rng = np.random.default_rng(60)
        waves = [([(prompt(rng, 7 + 3 * i, cfg_t.vocab_size), 9, {"adapter": i})
                   for i in range(3)], None)]
        pcfg = dict(max_slots=3, block_size=8, num_blocks=64, max_blocks_per_seq=6)
        jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, pcfg, horizon,
                             loras=(stacked, bridge(stacked)), lora_scale=lcfg.scale,
                             draft=models["drafts"][draft], spec_guard=False)
        run_lockstep(jeng, teng, waves)
        assert teng.spec_drafted > 0
        assert outputs(teng) == _plain_outputs(params_t, cfg_t, pcfg, waves, horizon,
                                               loras=bridge(stacked), lora_scale=lcfg.scale)

    @pytest.mark.parametrize("horizon", [1, 2, 8])
    @pytest.mark.parametrize("draft", ["self_int8", "tiny"])
    def test_set_spec_k_at_runtime(self, models, draft, horizon):
        cfg_j, cfg_t = models["cfg"]
        params_j, params_t = models["params"]
        jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, BASE_PCFG, horizon,
                             draft=models["drafts"][draft], spec_k=4, spec_guard=False)
        rng = np.random.default_rng(61)
        requests = [(prompt(rng, n, cfg_t.vocab_size), 20) for n in (5, 9, 13)]
        for p, budget in requests:
            assert jeng.submit(p, budget) == teng.submit(p, budget)
        for step in range(12):
            if step in (2, 5):
                k = 2 if step == 2 else 3
                jeng.set_spec_k(k)
                teng.set_spec_k(k)
                assert teng.spec_k == jeng.spec_k == k
            if not (jeng.pending or any(jeng.slots)):
                break
            assert jeng.step() == teng.step()
            assert_same_state(jeng, teng)
        jeng.run()
        teng.run()
        assert outputs(teng) == outputs(jeng)
        assert (teng.spec_drafted, teng.spec_accepted) == (jeng.spec_drafted,
                                                             jeng.spec_accepted)
        waves = [([(p, b, {}) for p, b in requests], None)]
        assert outputs(teng) == _plain_outputs(params_t, cfg_t, BASE_PCFG, waves, horizon)

    def test_perfect_draft_accepts_everything(self, models):
        _, cfg_t = models["cfg"]
        _, params_t = models["params"]
        eng = ServingEngine(params_t, cfg_t, PagedConfig(max_slots=2, block_size=8,
                                                         num_blocks=64, max_blocks_per_seq=8),
                            draft_params=params_t, draft_cfg=cfg_t, spec_k=3, spec_guard=False,
                            decode_horizon=1, dispatch_depth=1)
        eng.submit([1, 2, 3, 4], 13)
        (r,) = eng.run()
        assert r.output == _plain_outputs(params_t, cfg_t, dict(
            max_slots=2, block_size=8, num_blocks=64, max_blocks_per_seq=8),
            [([([1, 2, 3, 4], 13, {})], None)], 1)[0]
        assert eng.spec_accepted == eng.spec_drafted > 0


# ---------------------------------------------------------------------------
# the payoff guard and the constructor
# ---------------------------------------------------------------------------


GUARD_PCFG = dict(max_slots=2, block_size=8, num_blocks=64, max_blocks_per_seq=8)


@pytest.mark.parametrize("spec,plain", [
    ([-1.0, 50.0, 52.0, 48.0], [-1.0, 100.0, 104.0, 98.0]),    # unprofitable
    ([-1.0, 300.0, 290.0, 310.0], [-1.0, 100.0, 110.0, 90.0]),  # profitable
    ([-1.0, 104.0, 105.0], [-1.0, 100.0, 100.0]),               # inside the margin
])
def test_guard_decision_matches_jax(models, spec, plain):
    (cfg_j, cfg_t), (params_j, params_t) = models["cfg"], models["params"]
    dj, dt, dcfg_j, dcfg_t = models["drafts"]["tiny"]
    jeng = JServingEngine(params_j, cfg_j, JPagedConfig(**GUARD_PCFG), draft_params=dj,
                          draft_cfg=dcfg_j)
    teng = ServingEngine(params_t, cfg_t, PagedConfig(**GUARD_PCFG), draft_params=dt,
                         draft_cfg=dcfg_t, dispatch_depth=1)
    for eng in (jeng, teng):
        eng._guard_samples["spec"] = list(spec)
        eng._guard_samples["plain"] = list(plain)
        eng._guard_decide()
    assert teng.spec_guard_decision == jeng.spec_guard_decision
    assert teng.spec_active == jeng.spec_active == teng.spec_guard_decision["active"]


@pytest.mark.parametrize("horizon", [1, 8])
def test_guard_reaches_a_decision_with_exact_tokens(models, horizon):
    _, cfg_t = models["cfg"]
    _, params_t = models["params"]
    _, dt, _, dcfg_t = models["drafts"]["tiny"]
    p = [5, 4, 3, 2, 1, 6, 7]
    want = _plain_outputs(params_t, cfg_t, GUARD_PCFG, [([(p, 40, {})], None)], horizon)[0]
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**GUARD_PCFG), draft_params=dt,
                        draft_cfg=dcfg_t, spec_guard_ticks=2, decode_horizon=horizon,
                        dispatch_depth=1)
    eng.submit(p, 40)
    assert eng.run()[0].output == want
    d = eng.spec_guard_decision
    assert d is not None and set(d) >= {"active", "spec_tok_s", "plain_tok_s", "accept_rate",
                                        "spec_k"}
    assert d["spec_tok_s"] > 0 and d["plain_tok_s"] > 0
    assert eng.spec_drafted > 0


def test_disabled_guard_pins_speculation_on(models):
    _, cfg_t = models["cfg"]
    _, params_t = models["params"]
    _, dt, _, dcfg_t = models["drafts"]["tiny"]
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**GUARD_PCFG), draft_params=dt,
                        draft_cfg=dcfg_t, spec_guard=False, decode_horizon=1, dispatch_depth=1)
    eng.submit([1, 2, 3], 20)
    eng.run()
    assert eng.spec_guard_decision is None and eng.spec_active and eng.spec_drafted > 0


@pytest.mark.parametrize("horizon", [1, 8])
def test_retired_draft_does_no_more_draft_work(models, horizon):
    """After the guard turned speculation off no tick drafts, no prefill is
    mirrored, and the tokens are the draft-less engine's."""
    _, cfg_t = models["cfg"]
    _, params_t = models["params"]
    _, dt, _, dcfg_t = models["drafts"]["tiny"]
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**GUARD_PCFG), draft_params=dt,
                        draft_cfg=dcfg_t, decode_horizon=horizon, dispatch_depth=1)
    eng._guard_samples = {"spec": [-1.0, 1.0, 1.0], "plain": [-1.0, 9.0, 9.0]}
    eng._guard_decide()
    assert eng.spec_active is False
    p = [9, 8, 7, 6]
    eng.submit(p, 10)
    got = eng.run()[0].output
    assert got == _plain_outputs(params_t, cfg_t, GUARD_PCFG, [([(p, 10, {})], None)],
                                 horizon)[0]
    pc = eng.phase_counts
    assert eng.spec_drafted == 0 and pc["draft_prefills"] == pc["draft_appends"] == 0
    assert pc["draft_syncs"] == pc["spec_rounds"] == pc["spec_ticks"] == 0
    # a new horizon re-arms the guard: the draft gets a fresh shot
    eng.set_decode_horizon(horizon + 1)
    assert eng.spec_active and eng.spec_guard_decision is None


class _MoEConfig(tllama.LlamaConfig):
    """A config with experts: the engine checks for ``n_experts``."""

    n_experts = 4


@pytest.mark.parametrize("case,match", [
    ("vocab", "share the tokenizer"),
    ("short_context", "draft must cover"),
    ("moe_draft", "must be dense"),
    ("moe_target", "dense-target only"),
    ("spec_k", "spec_k must be >= 1"),
    ("no_cfg", "requires draft_cfg"),
])
def test_constructor_refuses_what_jax_refuses(models, case, match):
    _, cfg_t = models["cfg"]
    _, params_t = models["params"]
    _, dt, _, dcfg_t = models["drafts"]["tiny"]
    cfg, kw = cfg_t, {"draft_params": dt, "draft_cfg": dcfg_t}
    if case == "vocab":
        kw["draft_cfg"] = dataclasses.replace(dcfg_t, vocab_size=cfg_t.vocab_size // 2)
    elif case == "short_context":
        kw["draft_cfg"] = dataclasses.replace(dcfg_t, max_seq_len=cfg_t.max_seq_len // 2)
    elif case == "moe_draft":
        kw["draft_cfg"] = _MoEConfig(**dataclasses.asdict(dcfg_t))
    elif case == "moe_target":
        cfg = _MoEConfig(**dataclasses.asdict(cfg_t))
    elif case == "spec_k":
        kw["spec_k"] = 0
    else:
        kw["draft_cfg"] = None
    with pytest.raises(ValueError, match=match):
        ServingEngine(params_t, cfg, PagedConfig(**GUARD_PCFG), dispatch_depth=1, **kw)


@pytest.mark.parametrize("case", ["vocab", "short_context", "spec_k"])
def test_jax_refuses_the_same(models, case):
    """The refusals above are JAX's: the same inputs to JAX's engine."""
    cfg_j, _ = models["cfg"]
    params_j, _ = models["params"]
    dj, _, dcfg_j, _ = models["drafts"]["tiny"]
    kw = {"draft_params": dj, "draft_cfg": dcfg_j}
    match = {"vocab": "share the tokenizer", "short_context": "draft must cover",
             "spec_k": "spec_k must be >= 1"}[case]
    if case == "vocab":
        kw["draft_cfg"] = dataclasses.replace(dcfg_j, vocab_size=cfg_j.vocab_size // 2)
    elif case == "short_context":
        kw["draft_cfg"] = dataclasses.replace(dcfg_j, max_seq_len=cfg_j.max_seq_len // 2)
    else:
        kw["spec_k"] = 0
    with pytest.raises(ValueError, match=match):
        JServingEngine(params_j, cfg_j, JPagedConfig(**GUARD_PCFG), **kw)


def test_sampling_and_depth_still_raise_on_a_draft_engine(models):
    _, cfg_t = models["cfg"]
    _, params_t = models["params"]
    _, dt, _, dcfg_t = models["drafts"]["tiny"]
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**GUARD_PCFG), draft_params=dt,
                        draft_cfg=dcfg_t, dispatch_depth=1)
    with pytest.raises(NotImplementedError, match="item 12"):
        eng.submit([1, 2, 3], 4, temperature=0.7)
    with pytest.raises(NotImplementedError, match="dispatch_depth=1"):
        ServingEngine(params_t, cfg_t, PagedConfig(**GUARD_PCFG), draft_params=dt,
                      draft_cfg=dcfg_t, dispatch_depth=2)


def test_int8_product_off_the_cpu_takes_the_kernel_and_never_the_plain_version(monkeypatch):
    """The repaired fault: ``models.quant.matmul`` on a tensor that is not
    on the CPU launches the int8 kernel (which never widens the weight in
    memory) and never the plain ``x @ q.to(x.dtype)``; the kernel's wrapper
    refuses a tensor that is not on a card."""
    calls = []
    leaf = {"q": torch.zeros((32, 16), dtype=torch.int8, device="meta"),
            "scale": torch.ones((16,), device="meta")}
    x = torch.zeros((4, 32), device="meta")
    monkeypatch.setattr(tquant, "quant_matmul_reference",
                        lambda *a: pytest.fail("the plain version ran off the CPU"))
    monkeypatch.setattr(tquant, "quant_matmul_cuda", lambda *a: calls.append(a) or "kernel")
    assert tquant.matmul(x, leaf) == "kernel" and len(calls) == 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA device"):
        tquant.matmul(x, leaf)
    # on the CPU: the plain version, JAX's order (the product rounded to x's
    # type, then the scale)
    xc = torch.randn((3, 32), dtype=torch.bfloat16)
    lc = tquant.quantize_array(torch.randn((32, 16), dtype=torch.bfloat16))
    want = (xc @ lc["q"].to(torch.bfloat16)) * lc["scale"]
    assert torch.equal(tquant.matmul(xc, lc), want)


def test_int8_kernel_split_rule_at_the_8b_shapes():
    """The host's choice of the int8 kernel's cluster split and row tile at
    the draft's decode shapes (wq/wo, wk/wv, w_gate/w_up, w_down, lm_head),
    a verify's rows and a prefill bucket's."""
    from bobrapet_tpu_torch.ops.quant_matmul import quant_rows, quant_splits

    shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
    assert [quant_splits(8, n, k) for k, n in shapes] == [4, 8, 2, 4, 1]
    assert quant_splits(40, 4096, 4096) == 2 and quant_splits(128, 14336, 4096) == 1
    assert (quant_rows(8), quant_rows(16), quant_rows(17), quant_rows(1024)) == (16, 16, 32, 32)
    # a short K keeps every warp at least two stages of 32 rows
    assert quant_splits(8, 1024, 128) == 1
