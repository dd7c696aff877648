"""Disaggregated prefill/decode serving on the port: roles, the router and
the KV handoff, against the port's unified engine and the JAX package's
router, on the CPU.

The scenarios are tests/test_serving_router.py's, on port engines over
JAX's llama_tiny weights carried across with the bridge (fp32, 2 layers).
The bar everywhere: a prefill-role engine handing its requests to a
decode-role engine through a shared prefix registry (in memory, or through
the slice-local disk tier) gives the unified port engine's tokens exactly,
greedy and sampled; greedy tokens equal JAX's router's; and the port's
router places every request where JAX's does.
"""

import jax
import numpy as np
import pytest
import torch

from bobrapet_tpu.config.operator import ServingConfig
from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu.serving import ServingRouter as JServingRouter
from bobrapet_tpu.serving import SharedPrefixRegistry as JRegistry
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.serving import (
    DrainStatus,
    PagedConfig,
    ServingEngine,
    ServingRouter,
    SharedPrefixRegistry,
)
from bobrapet_tpu_torch.storage import SliceLocalSSDStore

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
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return {"cfg_j": cfg_j, "params_j": params_j, "cfg_t": tllama.llama_tiny(),
            "params_t": params_t}


def _pcfg(**over):
    return PagedConfig(**{**PCFG, **over})


def _prompts(vocab, n=6, seed=0, shared_blocks=3, tail=9):
    """``n`` prompts sharing a ``shared_blocks``-block system prefix, with
    tails of their own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 16 * shared_blocks).tolist()
    return [system + rng.integers(0, vocab, tail + i).tolist() for i in range(n)]


def _unified(model, prompts, max_new=8, temps=None):
    eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg())
    for i, p in enumerate(prompts):
        eng.submit(list(p), max_new, temperature=temps[i] if temps else 0.0)
    return {r.rid: r.output for r in eng.run()}


def _disagg(model, reg, n_decode=1, prefill_threshold=0, **pf_over):
    cfg, params = model["cfg_t"], model["params_t"]
    pf = ServingEngine(params, cfg, _pcfg(**pf_over), prefix_shared=reg, role="prefill")
    decs = {f"d{i}": ServingEngine(params, cfg, _pcfg(), prefix_shared=reg, role="decode")
            for i in range(n_decode)}
    return ServingRouter({"pf": pf, **decs}, registry=reg,
                         prefill_threshold=prefill_threshold), pf, decs


def _jax_disagg(model, n_decode=1, prefill_threshold=0):
    cfg, params = model["cfg_j"], model["params_j"]
    reg = JRegistry()
    pcfg = JPagedConfig(**PCFG)
    pf = JServingEngine(params, cfg, pcfg, prefix_shared=reg, role="prefill")
    decs = {f"d{i}": JServingEngine(params, cfg, pcfg, prefix_shared=reg, role="decode")
            for i in range(n_decode)}
    return JServingRouter({"pf": pf, **decs}, registry=reg,
                          prefill_threshold=prefill_threshold), pf, decs


def _placement(decs) -> dict:
    """rid -> the decode engine that finished it."""
    return {r.rid: name for name, eng in decs.items() for r in eng.finished}


class TestEngineRoles:
    def test_prefill_role_retires_at_first_token(self, model):
        reg = SharedPrefixRegistry()
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg(), prefix_shared=reg,
                            role="prefill")
        eng.submit(_prompts(512, n=1)[0], 8)
        done = eng.run()
        assert len(done) == 1 and done[0].prefilled and len(done[0].output) == 1
        assert len(reg) >= 3  # the full prompt blocks, exported

    def test_prefill_role_eos_and_budget_complete_normally(self, model):
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg(), role="prefill")
        eng.submit(_prompts(512, n=1)[0], 1)  # the budget ends at t0
        req = eng.run()[0]
        assert req.done and not req.prefilled

    def test_prefill_role_requires_prefix_caching(self, model):
        with pytest.raises(ValueError, match="prefix_caching"):
            ServingEngine(model["params_t"], model["cfg_t"], _pcfg(prefix_caching=False),
                          role="prefill")
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg(prefix_caching=False))
        with pytest.raises(ValueError, match="prefix_caching"):
            eng.set_role("prefill")

    def test_bad_role_rejected(self, model):
        with pytest.raises(ValueError, match="role"):
            ServingEngine(model["params_t"], model["cfg_t"], _pcfg(), role="verifier")
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg())
        with pytest.raises(ValueError, match="role"):
            eng.set_role("verifier")

    def test_submit_handoff_contract_validation(self, model):
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg())
        with pytest.raises(ValueError, match="preseeded"):
            eng.submit([1, 2, 3], max_new_tokens=2, output=[5, 6])
        with pytest.raises(ValueError, match="rid"):
            eng.submit([1, 2, 3], max_new_tokens=2, rid=-1)
        assert eng.submit([1, 2, 3], max_new_tokens=2, rid=7) == 7
        assert eng.submit([1, 2, 3], max_new_tokens=2) == 8

    def test_live_promotion_retires_at_the_next_token(self, model):
        """A decoding request on an engine promoted to prefill retires at its
        next committed token, prefilled, with no token past it."""
        reg = SharedPrefixRegistry()
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg(), prefix_shared=reg,
                            decode_horizon=4, dispatch_depth=1)
        eng.submit(_prompts(512, n=1)[0], 20)
        eng.step()
        eng.step()
        had = len(eng.slots[0].request.output)
        eng.set_role("prefill")
        req = eng.run()[0]
        assert req.prefilled and len(req.output) == had + 1


class TestRouterPolicy:
    def test_prefix_hit_routes_to_deepest_chain_engine(self, model):
        """The engine already holding the chain wins over load; direct
        traffic under a foreign rid is never harvested."""
        reg = SharedPrefixRegistry()
        router, _pf, decs = _disagg(model, reg, n_decode=2, prefill_threshold=10_000)
        prompts = _prompts(512, n=3)
        r0 = router.submit(list(prompts[0]), 4)
        router.run()
        owner = next(n for n, e in decs.items() if e.blocks.longest_local_match(prompts[1]) > 0)
        other = next(n for n in decs if n != owner)
        decs[other].submit(np.random.default_rng(9).integers(0, 512, 8).tolist(), 64, rid=999)
        r1 = router.submit(list(prompts[1]), 64)
        router.step()
        assert router.outcomes[r1] == "prefix-hit"
        assert any(s is not None and s.request.rid == r1 for s in decs[owner].slots) or any(
            q.rid == r1 for q in decs[owner].pending)
        router.run()
        assert router.outcomes[r0] == "miss"
        assert all(r.rid != 999 for r in router.finished)

    @pytest.mark.parametrize("scenario", ["affinity", "least_loaded", "affinity_off"])
    def test_same_engine_picked_as_jax_router(self, model, scenario):
        """Each submit lands on the engine JAX's router picks, with the same
        outcome, and the completions are JAX's tokens."""
        threshold = 32 if scenario == "affinity" else 10_000
        if scenario == "least_loaded":
            rng = np.random.default_rng(3)
            prompts = [rng.integers(0, 512, 8).tolist() for _ in range(6)]
        else:
            prompts = _prompts(512, n=6, seed=4)
        out = {}
        for side, build in (("jax", _jax_disagg), ("port", None)):
            if build is None:
                router, _pf, decs = _disagg(model, SharedPrefixRegistry(), n_decode=2,
                                            prefill_threshold=threshold)
            else:
                router, _pf, decs = build(model, n_decode=2, prefill_threshold=threshold)
            if scenario == "affinity_off":
                router.set_prefix_affinity(False)
            for p in prompts[:3]:
                router.submit(list(p), 6)
            router.step()
            for p in prompts[3:]:
                router.submit(list(p), 6)
            fin = router.run()
            out[side] = (dict(router.outcomes), _placement(decs),
                         {r.rid: r.output for r in fin})
        assert out["port"] == out["jax"]
        if scenario == "affinity_off":
            assert set(out["port"][0].values()) == {"miss"}
        if scenario == "least_loaded":
            assert set(out["port"][1].values()) == {"d0", "d1"}

    def test_hit_rate_floor_on_prefix_heavy_leg(self, model):
        reg = SharedPrefixRegistry()
        router, _pf, _decs = _disagg(model, reg, prefill_threshold=32)
        for p in _prompts(512, n=6):
            router.submit(list(p), 4)
        fin = router.run()
        assert len(fin) == 6 and all(r.kv_handoff_s is not None for r in fin)
        assert router.hit_rate >= 0.5

    def test_tenant_weights_reorder_the_router_queue(self, model):
        """Weighted-fair order on the router's pools, as JAX's router
        serves it."""
        order = {}
        weights = {"a": 4.0, "b": 1.0}
        for side in ("jax", "port"):
            if side == "jax":
                router, _pf, decs = _jax_disagg(model, prefill_threshold=10_000)
            else:
                router, _pf, decs = _disagg(model, SharedPrefixRegistry(),
                                            prefill_threshold=10_000)
            router.set_tenant_weights(weights)
            rng = np.random.default_rng(5)
            for i in range(10):
                router.submit(rng.integers(0, 512, 6).tolist(), 3,
                              tenant="b" if i < 6 else "a")
            order[side] = [r.rid for r in router.run()]
        assert order["port"] == order["jax"]


class TestHandoffParity:
    def test_greedy_handoff_byte_identical(self, model):
        prompts = _prompts(512, n=6, seed=11)
        ref = _unified(model, prompts)
        router, _pf, decs = _disagg(model, SharedPrefixRegistry())
        for p in prompts:
            router.submit(list(p), 8)
        assert {r.rid: r.output for r in router.run()} == ref
        assert sum(d.blocks.shared_hits for d in decs.values()) >= 3

    def test_greedy_handoff_equals_jax_router(self, model):
        prompts = _prompts(512, n=4, seed=17)
        jrouter, _jpf, _jdecs = _jax_disagg(model)
        router, _pf, _decs = _disagg(model, SharedPrefixRegistry())
        for p in prompts:
            assert jrouter.submit(list(p), 8) == router.submit(list(p), 8)
        want = {r.rid: r.output for r in jrouter.run()}
        assert {r.rid: r.output for r in router.run()} == want

    def test_sampled_handoff_byte_identical(self, model):
        prompts = _prompts(512, n=4, seed=12)
        temps = [0.0, 0.8, 1.1, 0.7]
        ref = _unified(model, prompts, temps=temps)
        router, _pf, _decs = _disagg(model, SharedPrefixRegistry())
        for i, p in enumerate(prompts):
            router.submit(list(p), 8, temperature=temps[i])
        assert {r.rid: r.output for r in router.run()} == ref

    def test_handoff_through_ssd_tier_byte_identical(self, model, tmp_path):
        prompts = _prompts(512, n=4, seed=13)
        ref = _unified(model, prompts)
        tier = SliceLocalSSDStore(str(tmp_path / "tier"))
        reg = SharedPrefixRegistry(max_entries=1)  # the chain must come from disk
        reg.attach_spill(tier)
        router, _pf, _decs = _disagg(model, reg)
        for p in prompts:
            router.submit(list(p), 8)
        fin = router.run()
        assert {r.rid: r.output for r in fin} == ref
        assert len(tier.list("kv/")) >= 3
        assert all(r.kv_handoff_s is not None and r.kv_handoff_s >= 0 for r in fin)

    @pytest.mark.parametrize("temperature", [0.0, 0.9])
    def test_handoff_fast_path_skips_suffix_prefill(self, model, temperature):
        """A block-aligned prompt needs no prefill dispatch on the decode
        side: the adopted chain covers every cached position and the first
        token is the next decode input."""
        prompt = np.random.default_rng(5).integers(0, 512, 64).tolist()  # 4 blocks
        ref = _unified(model, [prompt], temps=[temperature])
        router, _pf, decs = _disagg(model, SharedPrefixRegistry())
        router.submit(list(prompt), 8, temperature=temperature)
        fin = router.run()
        dec = decs["d0"]
        assert dec.phase_counts["prefills"] == 0 and dec.phase_seconds["prefill"] == 0.0
        assert dec.blocks.shared_hits == 4
        assert {r.rid: r.output for r in fin} == ref


class TestRoleReload:
    def test_demoted_prefill_engine_drains_unified(self, model):
        prompts = _prompts(512, n=4, seed=14)
        ref = _unified(model, prompts)
        router, pf, _decs = _disagg(model, SharedPrefixRegistry())
        for p in prompts:
            router.submit(list(p), 8)
        router.step()
        pf.set_role("unified")
        fin = router.run()
        assert {r.rid: r.output for r in fin} == ref and len(fin) == 4

    def test_empty_prefill_pool_reroutes_queued_work(self, model):
        prompts = _prompts(512, n=3, seed=15)
        ref = _unified(model, prompts)
        router, pf, _decs = _disagg(model, SharedPrefixRegistry())
        for p in prompts:
            router.submit(list(p), 8)
        pf.set_role("unified")
        assert {r.rid: r.output for r in router.run()} == ref

    def test_router_set_role_waits_for_the_drain(self, model):
        """The router's set_role drains the engine under its old role, then
        flips it: nothing in flight is truncated."""
        prompts = _prompts(512, n=3, seed=18)
        ref = _unified(model, prompts, max_new=24)
        router, _pf, decs = _disagg(model, SharedPrefixRegistry())
        dec = decs["d0"]
        for p in prompts:
            router.submit(list(p), 24)
        while not any(dec.slots):
            router.step()
        router.set_role("d0", "unified")
        assert dec.role == "decode" and router.drain_status("d0").draining
        fin = router.run()
        assert dec.role == "unified" and not dec.draining
        assert {r.rid: r.output for r in fin} == ref

    def test_apply_tuning_applies_role_and_router_knobs(self, model):
        from bobrapet_tpu_torch.serving import engram

        reg = SharedPrefixRegistry()
        eng = ServingEngine(model["params_t"], model["cfg_t"], _pcfg(), prefix_shared=reg)
        pinned = ServingEngine(model["params_t"], model["cfg_t"], _pcfg(), prefix_shared=reg,
                               role="prefill")
        pinned._engram_pinned = frozenset(["role"])
        router = ServingRouter({"a": eng, "b": pinned}, registry=reg)
        engram._LIVE_ENGINES.add(eng)
        engram._LIVE_ENGINES.add(pinned)
        try:
            engram.apply_tuning(ServingConfig(role="decode", router_prefill_threshold=128,
                                              router_prefix_affinity=False))
            assert eng.role == "decode" and pinned.role == "prefill"
            assert router.prefill_threshold == 128 and router.prefix_affinity is False
        finally:
            engram.apply_tuning(ServingConfig())
            engram._TUNING = None
        assert eng.role == "unified" and router.prefill_threshold == 0


class TestDrainContract:
    def test_drain_remove_and_evict(self, model):
        """drain/undrain/remove_engine/evict_engine: an evicted replica's
        requests finish elsewhere with the unified engine's tokens."""
        prompts = _prompts(512, n=4, seed=19)
        ref = _unified(model, prompts)
        router, _pf, decs = _disagg(model, SharedPrefixRegistry(), n_decode=2,
                                    prefill_threshold=10_000)
        status = router.drain("d1")
        assert status == DrainStatus("d1", True, 0) and status.empty
        for p in prompts:
            router.submit(list(p), 8)
        router.step()
        assert all(s is None for s in decs["d1"].slots)  # a draining engine takes no work
        router.undrain("d1")
        with pytest.raises(ValueError, match="drain it first"):
            router.remove_engine("d0")
        requeued = router.evict_engine("d0")
        assert requeued >= 1 and "d0" not in router.engines
        fin = router.run()
        assert {r.rid: r.output for r in fin} == ref
        router.drain("d1")
        assert router.remove_engine("d1") is decs["d1"]
        assert router.drain_status("d1") is None

    def test_stream_server_drives_the_router(self, model):
        from bobrapet_tpu_torch.serving import StreamServer

        prompts = _prompts(512, n=3, seed=16)
        ref = _unified(model, prompts)
        router, _pf, _decs = _disagg(model, SharedPrefixRegistry())
        out = []

        class Producer:
            def send(self, payload, **kw):
                out.append(payload)

            def close(self):
                pass

        msgs = [{"id": i, "prompt": p, "maxNewTokens": 8} for i, p in enumerate(prompts)]
        server = StreamServer(router, iter(msgs), Producer())
        assert server.run() == 3
        assert {m["id"]: m["tokens"] for m in out} == {i: ref[i] for i in range(3)}
