"""Cross-engine prefix sharing on the port against the JAX package's, on the
CPU: the shared registry, its disk codec, two engines sharing through one
registry in lockstep with two JAX engines, and tests/
test_serving_kv_persistence.py's scenarios (resume from disk, scope
isolation across the disk hop, LRU eviction recovered from disk,
memory-only when detached) on port engines over JAX's llama_tiny weights
(fp32, 2 layers, bridged).
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu.serving.prefix_cache import SharedPrefixRegistry as JRegistry
from bobrapet_tpu_torch import storage as tstore
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from bobrapet_tpu_torch.serving import prefix_cache as tprefix
from bobrapet_tpu_torch.serving.prefix_cache import SharedPrefixRegistry
from tests.torch_lockstep import assert_same_state, outputs

PCFG = dict(max_slots=4, block_size=16, num_blocks=128, max_blocks_per_seq=8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the cores, and contended thread pools slow every step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg_j = jllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    return {"cfg_j": cfg_j, "params_j": params_j, "cfg_t": tllama.llama_tiny(),
            "params_t": params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")}


def _prompt(seed=40, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, 48).tolist() + rng.integers(0, vocab, 9).tolist()


def _serve_once(params, cfg, reg, prompt, max_new=8):
    eng = ServingEngine(params, cfg, PagedConfig(**PCFG), prefix_shared=reg)
    eng.submit(list(prompt), max_new)
    return eng, eng.run()[0].output


# -- the registry -----------------------------------------------------------

_OPS = st.lists(st.tuples(st.sampled_from(["put", "get", "match"]),
                          st.sampled_from(["s1", "s2"]),
                          st.lists(st.integers(0, 5), min_size=1, max_size=4)),
                min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, cap=st.integers(1, 5))
def test_registry_against_jax_under_random_sequences(ops, cap):
    """Same hits, misses, match depths and LRU order as JAX's registry."""
    t, j = SharedPrefixRegistry(max_entries=cap), JRegistry(max_entries=cap)
    for op, scope, keys in ops:
        hashes = [bytes([k]) for k in keys]
        if op == "put":
            t.put(scope, hashes[0], {"k": torch.zeros(1)})
            j.put(scope, hashes[0], {"k": np.zeros(1)})
        elif op == "get":
            assert (t.get(scope, hashes[0]) is None) == (j.get(scope, hashes[0]) is None)
        else:
            assert t.longest_match_hashes(scope, hashes) == j.longest_match_hashes(scope, hashes)
        assert list(t._entries) == list(j._entries)
    assert len(t) == len(j)


def test_registry_refuses_an_empty_bound():
    with pytest.raises(ValueError, match="max_entries"):
        SharedPrefixRegistry(max_entries=0)


def test_longest_match_walks_the_chain_as_jax():
    tokens = np.random.default_rng(1).integers(0, 512, 53).tolist()
    t, j = SharedPrefixRegistry(), JRegistry()
    for h in tprefix.chain_hashes(tokens, 16)[:2]:
        t.put("s", h, {"k": torch.zeros(1)})
        j.put("s", h, {"k": np.zeros(1)})
    for salt in (0, 1):
        assert t.longest_match("s", tokens, 16, salt) == j.longest_match("s", tokens, 16, salt)
    assert t.longest_match("s", tokens, 16) == 2


# -- the codec --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kv_payload_round_trip_exact(dtype):
    g = torch.Generator().manual_seed(0)
    payload = {"k": torch.randn(2, 3, 4, generator=g).to(dtype),
               "v": torch.randn(2, 3, 4, generator=g).to(dtype),
               "dk": torch.randn(1, 3, 4, generator=g).to(dtype)}
    back = tprefix._decode_kv_payload(tprefix._encode_kv_payload(payload))
    assert set(back) == set(payload)
    for name, want in payload.items():
        got = back[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16) if dtype != torch.float32 else got,
                           want.view(torch.int16) if dtype != torch.float32 else want)
        got.add_(1)  # the decoded tensors own writable memory


def test_kv_payload_writes_no_pickle():
    data = tprefix._encode_kv_payload({"k": torch.ones(2, dtype=torch.bfloat16)})
    with np.load(__import__("io").BytesIO(data), allow_pickle=False) as z:
        assert z.files == ["k.bfloat16"] and z["k.bfloat16"].dtype == np.uint16


def test_fp32_payload_decodes_in_jax():
    """An fp32 spill entry the port wrote decodes in JAX's codec to the same
    arrays (the bf16 one carries its own name: the two packages never share
    a scope anyway)."""
    from bobrapet_tpu.serving.prefix_cache import _decode_kv_payload

    payload = {"k": torch.arange(6.0).reshape(2, 3)}
    back = _decode_kv_payload(tprefix._encode_kv_payload(payload))
    np.testing.assert_array_equal(back["k"], payload["k"].numpy())


def test_active_disk_tier_is_adopted_at_import(tmp_path, monkeypatch):
    tier = tstore.SliceLocalSSDStore(str(tmp_path))
    monkeypatch.setattr(tstore, "ACTIVE_DISK_TIER", tier)
    reg = tprefix.GLOBAL_SHARED_PREFIXES
    before = reg._spill
    try:
        tprefix._adopt_active_disk_tier()
        assert reg._spill is tier
    finally:
        reg.attach_spill(before)


# -- two engines sharing, against JAX ----------------------------------------

@pytest.mark.parametrize("horizon,depth", [(1, 1), (8, 2)])
def test_two_engines_share_in_lockstep_with_jax(model, horizon, depth):
    """Engine A computes a system prompt's blocks and exports them; engine B
    adopts them for its own requests. Every step, each port engine's slots,
    blocks, free list, prefix maps and outputs equal its JAX twin's, and so
    do the shared hits and the registry's chain order."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, 512, 48).tolist()
    waves = [[system + rng.integers(0, 512, 5 + i).tolist() for i in range(2)],
             [system + rng.integers(0, 512, 3 + i).tolist() for i in range(3)]]
    kw = dict(pipeline_decode=False, decode_horizon=horizon, dispatch_depth=depth)
    jreg, treg = JRegistry(), SharedPrefixRegistry()
    pairs = [(JServingEngine(model["params_j"], model["cfg_j"], JPagedConfig(**PCFG),
                             prefix_shared=jreg, **kw),
              ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG),
                            prefix_shared=treg, **kw)) for _ in range(2)]
    for (jeng, teng), prompts in zip(pairs, waves):
        for p in prompts:
            assert jeng.submit(list(p), 6) == teng.submit(list(p), 6)
        while jeng.pending or any(jeng.slots):
            assert jeng.step() == teng.step()
            assert_same_state(jeng, teng)
            assert teng.blocks.shared_hits == jeng.blocks.shared_hits
        jeng.run()
        teng.run()
        assert outputs(teng) == outputs(jeng)
    assert [h for _, h in treg._entries] == [h for _, h in jreg._entries]
    assert pairs[1][1].blocks.shared_hits == pairs[1][0].blocks.shared_hits >= 3


def test_export_is_a_copy_of_the_block(model):
    """A payload must not change when the pools do: an index of a pool is a
    view in torch."""
    eng = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG),
                        prefix_shared=SharedPrefixRegistry())
    eng.submit(_prompt(), 4)
    eng.run()
    blk = next(iter(eng.blocks._hash_of))
    payload = eng._export_block(blk)
    before = payload["k"].clone()
    eng.pools["k"][:, blk] += 1
    assert torch.equal(payload["k"], before)
    assert payload["k"].untyped_storage().data_ptr() != eng.pools["k"].untyped_storage().data_ptr()


def test_import_blocks_equals_block_by_block(model):
    eng = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG))
    g = torch.Generator().manual_seed(3)
    shape = eng.pools["k"][:, 0].shape
    payloads = [{"k": torch.randn(shape, generator=g), "v": torch.randn(shape, generator=g)}
                for _ in range(3)]
    assert eng._import_blocks([5, 2, 9], payloads)
    one = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG))
    for blk, p in zip([5, 2, 9], payloads):
        assert one._import_block(blk, p)
    assert torch.equal(eng.pools["k"], one.pools["k"])
    assert torch.equal(eng.pools["v"], one.pools["v"])
    assert torch.equal(eng.pools["k"][:, 2], payloads[1]["k"])


def test_spec_engine_refuses_payloads_without_draft_kv(model):
    eng = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG),
                        draft_params=model["params_t"], draft_cfg=model["cfg_t"],
                        spec_guard=False)
    shape = eng.pools["k"][:, 0].shape
    p = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    assert not eng._import_blocks([3, 4], [p, p]) and not eng._import_block(3, p)
    assert eng._import_block(3, {**p, "dk": torch.zeros(shape), "dv": torch.zeros(shape)})


def test_scope_moves_with_the_draft(model):
    """A retired draft moves the engine into the draft-less scope; the
    scope depends on the weights and the config, not on the engine."""
    reg = SharedPrefixRegistry()
    plain = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG),
                          prefix_shared=reg)
    other = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG),
                          prefix_shared=reg)
    spec = ServingEngine(model["params_t"], model["cfg_t"], PagedConfig(**PCFG),
                         draft_params=model["params_t"], draft_cfg=model["cfg_t"],
                         prefix_shared=reg)
    assert plain.blocks.scope == other.blocks.scope != spec.blocks.scope
    spec.spec_active = False
    spec._retire_draft_scope()
    assert spec.blocks.scope == plain.blocks.scope
    spec._rearm_spec_guard()
    assert spec.spec_active and spec.blocks.scope != plain.blocks.scope


# -- the kv-persistence scenarios ---------------------------------------------

def test_restarted_engine_readopts_prefix_state_from_disk(model, tmp_path):
    cfg, params = model["cfg_t"], model["params_t"]
    tier = tstore.SliceLocalSSDStore(str(tmp_path / "tier"))
    prompt = _prompt()
    reg1 = SharedPrefixRegistry()
    reg1.attach_spill(tier)
    eng1, out_before = _serve_once(params, cfg, reg1, prompt)
    assert len(reg1) >= 3 and len(tier.list("kv/")) >= 3
    del eng1, reg1  # the preemption: memory state is gone
    reg2 = SharedPrefixRegistry()
    reg2.attach_spill(tier)
    assert len(reg2) == 0
    eng2, out_after = _serve_once(params, cfg, reg2, prompt)
    assert eng2.blocks.shared_hits >= 3 and out_after == out_before
    plain = ServingEngine(params, cfg, PagedConfig(**PCFG))
    plain.submit(list(prompt), 8)
    assert plain.run()[0].output == out_after
    # and JAX's engine on the same weights gives the same tokens
    jeng = JServingEngine(model["params_j"], model["cfg_j"], JPagedConfig(**PCFG))
    jeng.submit(list(prompt), 8)
    assert jeng.run()[0].output == out_after


def test_scope_isolation_survives_the_disk_hop(model, tmp_path):
    cfg = model["cfg_t"]
    tier = tstore.SliceLocalSSDStore(str(tmp_path / "tier"))
    prompt = _prompt(seed=41)
    reg1 = SharedPrefixRegistry()
    reg1.attach_spill(tier)
    _serve_once(model["params_t"], cfg, reg1, prompt, max_new=6)
    other = tllama.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    reg2 = SharedPrefixRegistry()
    reg2.attach_spill(tier)
    eng2, _ = _serve_once(other, cfg, reg2, prompt, max_new=6)
    assert eng2.blocks.shared_hits == 0


def test_memory_lru_eviction_recovers_from_disk(model, tmp_path):
    cfg, params = model["cfg_t"], model["params_t"]
    tier = tstore.SliceLocalSSDStore(str(tmp_path / "tier"))
    prompt = _prompt(seed=42)
    reg = SharedPrefixRegistry(max_entries=1)
    reg.attach_spill(tier)
    _eng, out_a = _serve_once(params, cfg, reg, prompt)
    assert len(reg) == 1
    eng2, out_b = _serve_once(params, cfg, reg, prompt)
    assert eng2.blocks.shared_hits >= 3 and out_b == out_a


def test_detached_spill_is_memory_only(model, tmp_path):
    tier = tstore.SliceLocalSSDStore(str(tmp_path / "tier"))
    reg = SharedPrefixRegistry()
    reg.attach_spill(tier)
    reg.attach_spill(None)
    _serve_once(model["params_t"], model["cfg_t"], reg, _prompt(seed=43))
    assert tier.list("kv/") == []


def test_torn_spill_entry_is_a_miss(model, tmp_path):
    tier = tstore.SliceLocalSSDStore(str(tmp_path / "tier"))
    reg = SharedPrefixRegistry()
    reg.attach_spill(tier)
    tier.put("kv/s/00", b"not an npz")
    assert reg.get("s", b"\x00") is None and reg.get("s", b"\x01") is None
