"""The port's depth-N dispatch pipeline (``ServingEngine(dispatch_depth=N)``)
against the JAX package's, and against its own depth 1, on the CPU.

Inputs come from numpy seeds and JAX's weights are carried over with the
bridge. Held here:

- lockstep with JAX at depth 2 and 3 and H = 2 and 8 on the horizon
  scenarios of tests/test_torch_horizon.py (eos and budgets inside a
  horizon, pool exhaustion, a live ``set_decode_horizon``), and on a live
  ``set_dispatch_depth``: after every ``step()`` the same finished rids,
  slots, blocks, free list, queue, horizon and host-sync counts, horizons in
  flight and outputs (greedy tokens are held, not bits: JAX attends over
  gathered views in an fp32 einsum, the port over the pools);
- lockstep with JAX on mixed-temperature batches without eos or
  preemption, where the schedule does not depend on the tokens: the same
  state after every step, the greedy requests' tokens JAX's and every
  sampled request's token count JAX's (the two draw from different bits);
- the port's own contract, the cases of tests/test_serving_pipeline.py:
  depth 2 and 3 give the streams of depth 1 (the same horizon), greedy,
  sampled and mixed, with eos inside a horizon, preemption mid-flight,
  admission while horizons are in flight, a live ``set_dispatch_depth``
  and a draft engine (bit-identical tokens: one function computes every
  step at every depth);
- the pipeline's bookkeeping: host work overlapped a horizon, nothing is
  left in flight after ``run()``, ``reset_phase_stats`` clears the idle
  stamp, and a depth below 1 is refused.
"""

import jax
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import quant as tquant
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from tests.test_torch_horizon import SCENARIOS as HORIZON_SCENARIOS
from tests.torch_lockstep import assert_same_state, bridge, engines, outputs, slot_view


@pytest.fixture(scope="module")
def tiny():
    """llama_tiny (fp32, 2 layers): JAX config, JAX float and int8 trees,
    and the port's config and bridged trees."""
    cfg_j = jllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    qparams_j = jquant.quantize_params(params_j)
    return {"cfg_j": cfg_j, "cfg_t": tllama.llama_tiny(),
            "float": (params_j, bridge(params_j)), "int8": (qparams_j, bridge(qparams_j))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the cores, and contended thread pools slow every step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _einsum_route(monkeypatch):
    # JAX's default paged route; the Pallas route would need a TPU anyway
    monkeypatch.delenv("BOBRA_PALLAS_PAGED", raising=False)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def _paging(pcfg: tuple) -> dict:
    slots, block, blocks, per_seq = pcfg
    return dict(max_slots=slots, block_size=block, num_blocks=blocks,
                max_blocks_per_seq=per_seq, prefix_caching=False)


def _step_together(jeng, teng, live_horizon=None, live_depth=None, compare=assert_same_state):
    """Step both engines until JAX's is idle, applying the live changes
    ``{step: value}`` to both before that step; returns the steps taken."""
    steps = 0
    while jeng.pending or any(jeng.slots):
        for live, setter in ((live_horizon, "set_decode_horizon"),
                             (live_depth, "set_dispatch_depth")):
            if live and steps in live:
                getattr(jeng, setter)(live[steps])
                getattr(teng, setter)(live[steps])
        assert jeng.step() == teng.step()
        compare(jeng, teng)
        steps += 1
    assert not (teng.pending or any(teng.slots))
    jeng.run()
    teng.run()
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert [r.preemptions for r in teng.finished] == [r.preemptions for r in jeng.finished]
    assert not teng._inflight
    return steps


class TestLockstepWithJax:
    @pytest.mark.parametrize("horizon", [2, 8])
    @pytest.mark.parametrize("depth", [2, 3])
    @pytest.mark.parametrize("name", list(HORIZON_SCENARIOS))
    def test_same_state_after_every_step(self, tiny, name, depth, horizon):
        pcfg, prompts, budgets, eos_at, tree, _, live = HORIZON_SCENARIOS[name]
        params_j, params_t = tiny[tree]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        prompts = [_prompt(seed, n, cfg_j.vocab_size) for seed, n in prompts]
        eos = None
        if eos_at is not None:
            probe = ServingEngine(params_t, cfg_t, PagedConfig(**_paging(pcfg)),
                                  decode_horizon=1, dispatch_depth=1)
            probe.submit(prompts[0], budgets[0])
            eos = probe.run()[0].output[eos_at]
        jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, _paging(pcfg), horizon,
                             depth=depth)
        for p, b in zip(prompts, budgets):
            assert jeng.submit(p, b, eos_token=eos) == teng.submit(p, b, eos_token=eos)
        deepest = [0]

        def compare(jeng, teng):
            assert_same_state(jeng, teng)
            deepest[0] = max(deepest[0], len(teng._inflight))

        _step_together(jeng, teng, live_horizon=live, compare=compare)
        assert outputs(teng) == outputs(jeng)
        assert teng.allocator.free_blocks == pcfg[2] - 1
        # the pipeline ran: horizons were in flight between steps (but for
        # three lanes of H = 8 over 9 blocks, where every tick's lookahead
        # is unfundable and drains to the classic tick)
        assert deepest[0] >= 1 or (name, horizon) == ("h8_pool_exhaustion_preempts", 8)
        if name == "h8_pool_exhaustion_preempts":
            assert sum(r.preemptions for r in teng.finished) >= 1

    @pytest.mark.parametrize("horizon", [2, 8])
    def test_a_live_depth_change(self, tiny, horizon):
        params_j, params_t = tiny["float"]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        pcfg = _paging((3, 8, 64, 8))
        jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, pcfg, horizon, depth=2)
        for i in range(5):
            p = _prompt(80 + i, 4 + 5 * i, cfg_j.vocab_size)
            assert jeng.submit(p, 9 + 4 * i) == teng.submit(p, 9 + 4 * i)
        _step_together(jeng, teng, live_depth={1: 3, 2: 1, 4: 2, 5: 3})
        assert outputs(teng) == outputs(jeng)


def _masked_view(eng, sampled):
    """slot_view with a sampled request's output replaced by its length."""
    return [v if v is None or v[0] not in sampled else (*v[:5], len(v[5]))
            for v in slot_view(eng)]


@pytest.mark.parametrize("horizon,depth", [(1, 1), (2, 2), (8, 2), (8, 3)])
@pytest.mark.parametrize("name", ["h2_mixed_lengths", "h4_more_requests_than_slots",
                                  "h8_int8_mixed"])
def test_mixed_temperatures_in_lockstep(tiny, name, horizon, depth):
    """No eos and no preemption: the schedule is the same as JAX's whatever
    the tokens, and the greedy requests' tokens are JAX's."""
    pcfg, prompts, budgets, eos_at, tree, _, _ = HORIZON_SCENARIOS[name]
    assert eos_at is None
    params_j, params_t = tiny[tree]
    cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
    temps = [(0.0, 0.7, 1.0, 0.0, 1.3)[i % 5] for i in range(len(prompts))]
    sampled = {rid for rid, t in enumerate(temps) if t > 0}
    jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, _paging(pcfg), horizon, depth=depth)
    for (seed, n), b, t in zip(prompts, budgets, temps):
        p = _prompt(seed, n, cfg_j.vocab_size)
        assert jeng.submit(p, b, temperature=t) == teng.submit(p, b, temperature=t)

    def compare(jeng, teng):
        assert _masked_view(teng, sampled) == _masked_view(jeng, sampled)
        assert teng.allocator._free == jeng.allocator._free
        assert [r.rid for r in teng.pending] == [r.rid for r in jeng.pending]
        for key in ("horizons", "host_syncs"):
            assert teng.phase_counts[key] == jeng.phase_counts[key], key
        assert len(teng._inflight) == len(jeng._inflight)

    _step_together(jeng, teng, compare=compare)
    got, want = outputs(teng), outputs(jeng)
    assert {r: o for r, o in got.items() if r not in sampled} == \
        {r: o for r, o in want.items() if r not in sampled}
    assert {r: len(o) for r, o in got.items()} == {r: len(o) for r, o in want.items()}
    assert all(0 <= t < cfg_t.vocab_size for r in sampled for t in got[r])
    # a draw is not the argmax every time
    assert any(got[r] != want[r] for r in sampled)


# ---------------------------------------------------------------------------
# the port's own contract: depth N gives depth 1's streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port(tiny):
    return tiny["cfg_t"], tiny["float"][1]


@pytest.fixture(scope="module")
def draft(port):
    return tquant.quantize_params(port[1])


def _pcfg(**over):
    return PagedConfig(**{**dict(max_slots=4, block_size=16, num_blocks=128,
                                 max_blocks_per_seq=8), **over})


def _prompts(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, 8 + (i % 5) * 7).tolist() for i in range(n)]


def _drain(engine, prompts, *, max_new=12, temps=None, eos=None):
    for i, p in enumerate(prompts):
        engine.submit(list(p), max_new_tokens=max_new,
                      temperature=(temps[i] if temps else 0.0), eos_token=eos)
    return {r.rid: r.output for r in engine.run()}


SAMPLED = [0.7, 1.1, 0.9, 1.3, 0.8, 1.0, 0.6, 1.2]
MIXED = [0.0, 0.8, 0.0, 1.2, 0.0, 0.0, 0.9, 0.0]


class TestDepthParity:
    """Each case: the pipelined engine against the depth-1 engine on the
    same horizon of 8, so only the pipelining moves."""

    def _pair(self, port, depth=2, pc=None, **kw):
        cfg, params = port
        return (ServingEngine(params, cfg, pc or _pcfg(), decode_horizon=8, dispatch_depth=1,
                              **kw),
                ServingEngine(params, cfg, pc or _pcfg(), decode_horizon=8,
                              dispatch_depth=depth, **kw))

    @pytest.mark.parametrize("depth", [2, 3])
    @pytest.mark.parametrize("temps", [None, SAMPLED, MIXED], ids=["greedy", "sampled", "mixed"])
    def test_same_streams(self, port, depth, temps):
        prompts = _prompts(port[0], seed=depth)
        ref, pipe = self._pair(port, depth)
        assert _drain(ref, prompts, temps=temps) == _drain(pipe, prompts, temps=temps)
        assert pipe.phase_counts["horizons"] > 0 and not pipe._inflight
        assert pipe.phase_seconds["host_overlap"] > 0

    @pytest.mark.parametrize("temps", [None, MIXED], ids=["greedy", "mixed"])
    def test_eos_fires_inside_a_horizon(self, port, temps):
        prompts = _prompts(port[0], seed=5)
        ref, _ = self._pair(port)
        base = _drain(ref, prompts, max_new=16, temps=temps)
        eos = next(t for out in base.values() for t in out[3:10])
        ref2, pipe2 = self._pair(port)
        a = _drain(ref2, prompts, max_new=16, temps=temps, eos=eos)
        b = _drain(pipe2, prompts, max_new=16, temps=temps, eos=eos)
        assert a == b
        assert any(len(v) < 16 for v in a.values())

    @pytest.mark.parametrize("depth", [1, 2])
    def test_a_draft_gives_the_plain_streams(self, port, draft, depth):
        cfg, params = port
        prompts = _prompts(cfg, seed=6)
        for temps in (None, MIXED):
            base = _drain(self._pair(port)[0], prompts, max_new=14, temps=temps)
            spec = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=depth,
                                 draft_params=draft, draft_cfg=cfg, spec_k=4, spec_guard=False)
            assert _drain(spec, prompts, max_new=14, temps=temps) == base
            assert spec.spec_drafted > 0

    def test_preemption_mid_flight(self, port, draft):
        """A tight pool: the lookahead becomes unfundable while horizons
        are in flight, the pipeline drains to the classic tick, which
        preempts, and the recompute keeps every stream."""
        cfg, params = port
        rng = np.random.default_rng(8)
        prompts = [rng.integers(0, cfg.vocab_size, 10 + (i % 3) * 9).tolist() for i in range(6)]
        pc = PagedConfig(max_slots=4, block_size=8, num_blocks=18, max_blocks_per_seq=8,
                         prefix_caching=False)

        def run(depth, spec=False, temps=None):
            kw = dict(draft_params=draft, draft_cfg=cfg, spec_k=4,
                      spec_guard=False) if spec else {}
            eng = ServingEngine(params, cfg, pc, decode_horizon=8, dispatch_depth=depth, **kw)
            for i, p in enumerate(prompts):
                eng.submit(list(p), 24, temperature=temps[i] if temps else 0.0)
            done = eng.run()
            return {r.rid: r.output for r in done}, sum(r.preemptions for r in done)

        base, pre_ref = run(1)
        pipe, pre_pipe = run(2)
        spec_pipe, _ = run(2, spec=True)
        assert pre_ref > 0 and pre_pipe > 0
        assert base == pipe == spec_pipe
        assert run(1, temps=SAMPLED)[0] == run(3, temps=SAMPLED)[0]

    def test_live_depth_changes(self, port):
        cfg, params = port
        prompts = _prompts(cfg, seed=9)
        ref, _ = self._pair(port)
        base = _drain(ref, prompts, max_new=16, temps=MIXED)
        eng = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=2)
        for i, p in enumerate(prompts):
            eng.submit(list(p), 16, temperature=MIXED[i])
        for depth in (2, 1, 3, 2):
            eng.set_dispatch_depth(depth)
            eng.step()
        assert {r.rid: r.output for r in eng.run()} == base

    def test_admission_while_horizons_are_in_flight(self, port):
        cfg, params = port
        prompts = _prompts(cfg, n=8, seed=12)
        ref, _ = self._pair(port)
        base = _drain(ref, prompts, max_new=16, temps=MIXED)
        eng = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=2)
        for i, p in enumerate(prompts[:4]):
            eng.submit(list(p), 16, temperature=MIXED[i])
        eng.step()
        assert eng._inflight  # horizons in flight
        for i, p in enumerate(prompts[4:], start=4):
            eng.submit(list(p), 16, temperature=MIXED[i])
        assert {r.rid: r.output for r in eng.run()} == base

    def test_depth_below_one_is_refused(self, port):
        cfg, params = port
        with pytest.raises(ValueError, match="dispatch_depth"):
            ServingEngine(params, cfg, _pcfg(), dispatch_depth=0)
        eng = ServingEngine(params, cfg, _pcfg())
        with pytest.raises(ValueError, match="dispatch_depth"):
            eng.set_dispatch_depth(0)


class TestBookkeeping:
    def test_phase_keys_and_reset(self, port):
        cfg, params = port
        eng = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=2)
        assert {"host_gap", "host_overlap"} <= set(eng.phase_seconds)
        _drain(eng, _prompts(cfg, n=4, seed=15), max_new=10)
        eng.reset_phase_stats()
        assert eng.phase_seconds["host_gap"] == eng.phase_seconds["host_overlap"] == 0.0
        assert eng._dev_idle_at is None

    def test_depth_one_books_the_gap_and_depth_two_keeps_one_wave_busy(self, port):
        cfg, params = port
        prompts = _prompts(cfg, n=8, seed=16)
        ref = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=1)
        _drain(ref, prompts, max_new=10)
        assert ref.phase_seconds["host_gap"] > 0 and ref.phase_seconds["host_overlap"] == 0
        eng = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=2)
        _drain(eng, prompts[:4], max_new=10)
        # one wave: the pipeline never goes empty with work left
        assert eng.phase_seconds["host_gap"] == 0 and eng.phase_seconds["host_overlap"] > 0
        assert not eng._inflight

    def test_each_horizon_in_flight_reads_back_through_its_own_buffer(self, port):
        cfg, params = port
        eng = ServingEngine(params, cfg, _pcfg(), decode_horizon=8, dispatch_depth=3)
        for p in _prompts(cfg, n=4, seed=17):
            eng.submit(p, 30)
        eng.step()
        hosts = [rec["host"] for rec in eng._inflight]
        assert len(hosts) == 3 and len({h.data_ptr() for h in hosts}) == 3
        eng.run()
        # every buffer is free again, for the next horizons
        assert len(eng._hz[8][1]) == 3
