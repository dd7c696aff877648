"""The port's fused decode horizon and its device-length greedy step against
the JAX package, on the CPU.

Inputs come from numpy seeds and JAX's weights are carried over with the
bridge. Held here:

- ``ServingEngine(decode_horizon=H, dispatch_depth=1)`` stepped in
  lockstep with JAX's at H = 2, 4 and 8, float and int8: after every step
  the same finished rids, slots, blocks, free list, queue, horizon and
  host-sync counts and outputs (JAX's horizon attends over gathered views
  in an fp32 einsum, the port's over the pools through the paged
  attention, so tokens are held, not bits);
- the port's horizon identical to its own classic tick (H = 1), since each
  horizon step is the same function;
- one horizon (``_horizon_plain``) against JAX's on the same lane state:
  identical tokens and lane state, the written K/V within 2e-3 (the fp32
  model tolerance of test_torch_llama.py);
- ``paged_cache.write_token`` bit-identical to JAX's;
- the plain device-length attention within 2e-4 of JAX's
  ``_cached_attention`` (the JAX package's attention tolerance);
- two faults repaired: ``greedy_generate`` returns int32 tokens, and an
  int32 ``(B, 0)`` array at ``max_new_tokens=0``; ``Request`` has JAX's
  fields in JAX's order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu.serving import engine as jengine
from bobrapet_tpu.serving import paged_cache as jpaged
from bobrapet_tpu_torch.graphs import GraphedStep
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.ops import cached_attention, cached_attention_reference
from bobrapet_tpu_torch.serving import PagedConfig, Request, ServingEngine
from bobrapet_tpu_torch.serving import engine as tengine
from bobrapet_tpu_torch.serving import paged_cache as tpaged


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def tiny():
    """llama_tiny (fp32, 2 layers): JAX config, JAX float and int8 trees,
    and the port's config and bridged trees."""
    cfg_j = jllama.llama_tiny()
    params_j = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    qparams_j = jquant.quantize_params(params_j)
    return {
        "cfg_j": cfg_j, "cfg_t": tllama.llama_tiny(),
        "float": (params_j, _bridge(params_j)), "int8": (qparams_j, _bridge(qparams_j)),
    }


@pytest.fixture(autouse=True)
def _einsum_route(monkeypatch):
    # JAX's default paged route; the Pallas route would need a TPU anyway
    monkeypatch.delenv("BOBRA_PALLAS_PAGED", raising=False)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def _port_engine(params, cfg, pcfg, horizon, pipeline=False):
    return ServingEngine(params, cfg, PagedConfig(*pcfg, prefix_caching=False),
                         pipeline_decode=pipeline, decode_horizon=horizon, dispatch_depth=1)


def _slot_view(eng):
    return [(s.request.rid, list(s.blocks), s.seq_len, list(s.request.output))
            if s is not None else None for s in eng.slots]


def _outputs(eng):
    return {r.rid: r.output for r in eng.finished}


#: (pcfg (slots, block, blocks, blocks per seq), [(prompt seed, len)],
#: budgets, eos index into a probe run's output of request 0 or None,
#: tree, H, {step: new H} set live on both engines)
SCENARIOS = {
    "h2_mixed_lengths": ((4, 8, 64, 8), [(1, 5), (2, 17), (3, 9), (4, 26)], [5, 8, 3, 7],
                         None, "float", 2, {}),
    "h2_int8": ((2, 8, 16, 4), [(5, 10), (6, 4)], [6, 3], None, "int8", 2, {}),
    "h4_more_requests_than_slots": ((2, 8, 32, 4), [(10 + i, 6 + i) for i in range(6)],
                                    [5, 6, 7, 3, 9, 4], None, "float", 4, {}),
    "h4_eos_inside_horizon": ((2, 8, 16, 4), [(3, 8)], [8], 2, "float", 4, {}),
    "h4_int8_budgets_mid_horizon": ((4, 8, 64, 8), [(1, 5), (2, 17), (3, 9), (4, 26)],
                                    [9, 4, 11, 6], None, "int8", 4, {}),
    "h8_pool_exhaustion_preempts": ((3, 8, 10, 4), [(20 + i, 14) for i in range(3)],
                                    [12, 12, 12], None, "float", 8, {}),
    "h8_eos_inside_horizon": ((2, 8, 32, 8), [(40, 7), (41, 12)], [20, 13], 5, "float", 8, {}),
    "h8_int8_mixed": ((4, 8, 64, 8), [(1, 5), (2, 17), (3, 9), (4, 26)], [12, 3, 9, 20],
                      None, "int8", 8, {}),
    "h8_budget_one_and_eos_on_prefill": ((3, 8, 24, 4), [(31, 9), (30, 9), (32, 6)],
                                         [8, 1, 10], 0, "float", 8, {}),
    "set_decode_horizon_mid_drain": ((3, 8, 64, 8), [(50 + i, 5 + 3 * i) for i in range(5)],
                                     [14, 20, 9, 17, 11], None, "float", 8, {1: 1, 3: 4, 4: 2}),
}


class TestHorizonLockstep:
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_same_slots_blocks_and_tokens_as_jax(self, tiny, name):
        pcfg, prompts, budgets, eos_at, tree, horizon, live = SCENARIOS[name]
        params_j, params_t = tiny[tree]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        prompts = [_prompt(seed, n, cfg_j.vocab_size) for seed, n in prompts]
        eos = None
        if eos_at is not None:
            probe = _port_engine(params_t, cfg_t, pcfg, 1)
            probe.submit(prompts[0], budgets[0])
            eos = probe.run()[0].output[eos_at]
        jeng = JServingEngine(params_j, cfg_j, JPagedConfig(*pcfg, prefix_caching=False),
                              pipeline_decode=False, decode_horizon=horizon, dispatch_depth=1)
        teng = _port_engine(params_t, cfg_t, pcfg, horizon)
        for p, b in zip(prompts, budgets):
            assert jeng.submit(p, b, eos_token=eos) == teng.submit(p, b, eos_token=eos)
        steps = 0
        while jeng.pending or any(jeng.slots):
            if steps in live:
                jeng.set_decode_horizon(live[steps])
                teng.set_decode_horizon(live[steps])
            assert jeng.step() == teng.step()
            assert _slot_view(teng) == _slot_view(jeng)
            assert teng.allocator.free_blocks == jeng.allocator.free_blocks
            assert teng.allocator._free == jeng.allocator._free
            assert len(teng.pending) == len(jeng.pending)
            assert _outputs(teng) == _outputs(jeng)
            # (the port's device_steps also counts classic ticks; JAX's
            # counts only horizon steps)
            for key in ("horizons", "host_syncs"):
                assert teng.phase_counts[key] == jeng.phase_counts[key], key
            steps += 1
        assert not (teng.pending or any(teng.slots))
        assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
        assert [r.preemptions for r in teng.finished] == [r.preemptions for r in jeng.finished]
        assert teng.allocator.free_blocks == pcfg[2] - 1
        assert teng.phase_counts["horizons"] >= 1
        by_rid = {r.rid: r for r in teng.finished}
        for rid, budget in enumerate(budgets):
            out = by_rid[rid].output
            if eos is None or eos not in out:
                assert len(out) == budget
        if name == "h8_pool_exhaustion_preempts":
            # funding failed and the classic tick ran, preempting
            assert sum(r.preemptions for r in teng.finished) >= 1
            assert teng.phase_counts["device_steps"] > 8 * teng.phase_counts["horizons"]
        if "budgets_mid_horizon" in name or name == "h2_mixed_lengths":
            assert any((b - 1) % horizon for b in budgets)
        if "eos_inside_horizon" in name:
            out = by_rid[0].output
            assert out[-1] == eos and out.index(eos) == len(out) - 1 < budgets[0] - 1
            assert (len(out) - 1) % horizon  # not at a horizon's edge
        if name == "h8_budget_one_and_eos_on_prefill":
            assert by_rid[0].output == [eos] and len(by_rid[1].output) == 1
        if live:
            assert max(live) < steps and teng.decode_horizon == live[max(live)]
        for r in teng.finished:
            assert r.ttft_seconds is not None and r.ttft_seconds >= 0
            assert (r.tpot_seconds is None) == (len(r.output) < 2)


class TestHorizonIsTheClassicTick:
    @pytest.mark.parametrize("tree", ["float", "int8"])
    def test_h8_gives_the_tokens_of_h1(self, tiny, tree):
        _, params_t = tiny[tree]
        cfg = tiny["cfg_t"]
        pcfg = (3, 8, 40, 8)
        prompts = [_prompt(60 + i, 4 + 5 * i, cfg.vocab_size) for i in range(6)]
        outs = {}
        for horizon, pipeline in ((1, False), (1, True), (8, False), (8, True)):
            eng = _port_engine(params_t, cfg, pcfg, horizon, pipeline)
            for i, p in enumerate(prompts):
                eng.submit(p, 5 + 4 * i)
            eng.run()
            outs[horizon, pipeline] = _outputs(eng)
            assert eng.allocator.free_blocks == pcfg[2] - 1
            assert (eng.phase_counts["horizons"] > 0) == (horizon > 1)
        assert outs[1, False] == outs[1, True] == outs[8, False] == outs[8, True]


def _lane_inputs(rng, cfg, S, block, mb, n_blocks):
    """A lane state: lane 0 free (inactive, all scratch), the others live
    at distinct lengths with room for 8 more tokens, one ending on its
    budget and one on an eos mid-horizon."""
    seq = np.asarray([1, 3, 9, 16, 20][:S], np.int32)
    act = np.asarray([False] + [True] * (S - 1))
    emitted = np.asarray([0, 1, 2, 1, 5][:S], np.int32)
    budget = np.asarray([0, 6, 5, 12, 30][:S], np.int32)
    eos = np.full(S, -1, np.int32)
    tables = np.zeros((S, mb), np.int32)
    ids = rng.permutation(np.arange(1, n_blocks))
    used = 0
    for s in range(1, S):
        k = -(-(seq[s] + 8) // block)
        tables[s, :k] = ids[used:used + k]
        used += k
    last = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    return last, seq, act, emitted, budget, eos, tables


class TestHorizonStep:
    @pytest.mark.parametrize("tree", ["float", "int8"])
    def test_one_horizon_matches_jax(self, tiny, tree):
        params_j, params_t = tiny[tree]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        S, block, mb, n_blocks, H = 5, 8, 4, 32, 8
        rng = np.random.default_rng(21)
        pools = {n: rng.standard_normal((2, n_blocks, block, 2, 32), dtype=np.float32)
                 for n in ("k", "v")}
        last, seq, act, emitted, budget, eos, tables = _lane_inputs(rng, cfg_j, S, block, mb,
                                                                   n_blocks)
        pcfg_kw = dict(max_slots=S, block_size=block, num_blocks=n_blocks, max_blocks_per_seq=mb)
        # a probe horizon finds a token that lane 3 emits mid-horizon: its eos
        args_j = lambda e: (  # noqa: E731
            params_j, {n: jnp.asarray(a) for n, a in pools.items()}, jnp.asarray(last),
            jnp.asarray(seq), jnp.asarray(act), jnp.asarray(emitted), jnp.asarray(budget),
            jnp.asarray(e), jnp.zeros(S, jnp.float32), jnp.zeros(S, jnp.int32),
            jnp.zeros(S, jnp.int32), jnp.asarray(tables), jax.random.PRNGKey(0), None)
        _, _, probe = jengine._horizon_plain(*args_j(eos), cfg=cfg_j,
                                             pcfg=JPagedConfig(**pcfg_kw), H=H)
        eos[3] = int(np.asarray(probe)[4, 3])
        jpools, (jlast, jseq, jact, jem), jtoks = jengine._horizon_plain(
            *args_j(eos), cfg=cfg_j, pcfg=JPagedConfig(**pcfg_kw), H=H)

        lanes = np.zeros((S, tengine.LANE_TABLE + mb), np.int32)
        for col, a in enumerate((last, seq, act, emitted, budget, eos)):
            lanes[:, col] = a
        lanes[:, tengine.LANE_TABLE:] = tables
        lanes_t = torch.from_numpy(lanes.copy())
        tpools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
        out = torch.zeros((H + 4, S), dtype=torch.int32)
        got = tengine._horizon_plain(params_t, tpools, lanes_t, out, cfg=cfg_t,
                                     pcfg=PagedConfig(**pcfg_kw), H=H)
        assert got is out
        toks = np.asarray(jtoks)
        np.testing.assert_array_equal(out[:H].numpy(), toks)
        want_state = np.stack([np.asarray(a).astype(np.int32) for a in (jlast, jseq, jact, jem)])
        np.testing.assert_array_equal(out[H:].numpy(), want_state)
        np.testing.assert_array_equal(lanes_t[:, :4].numpy(), want_state.T)
        np.testing.assert_array_equal(lanes_t[:, 4:].numpy(), lanes[:, 4:])
        # liveness: the free lane emitted nothing, lane 1 stopped on its
        # budget and lane 3 on its eos, both inside the horizon
        assert (toks[:, 0] == -1).all()
        assert (toks[:, 1] >= 0).sum() == budget[1] - emitted[1] < H
        assert toks[4, 3] == eos[3] and (toks[5:, 3] == -1).all()
        # every live position written within the model tolerance; nothing
        # else moved but the scratch block (dead lanes' garbage, which
        # differs between the two)
        written = np.zeros((n_blocks, block), bool)
        for s in range(1, S):
            for t in range(int(want_state[3, s] - emitted[s])):
                pos = seq[s] - 1 + t
                written[tables[s, pos // block], pos % block] = True
        kept = ~written
        kept[tpaged.SCRATCH_BLOCK] = False
        for n in ("k", "v"):
            want, have = np.asarray(jpools[n]), tpools[n].numpy()
            np.testing.assert_allclose(have[:, written], want[:, written], atol=2e-3)
            assert not np.array_equal(have[:, written], pools[n][:, written])
            np.testing.assert_array_equal(have[:, kept], pools[n][:, kept])
            np.testing.assert_array_equal(want[:, kept], pools[n][:, kept])


class TestWriteToken:
    def test_bit_identical_to_jax(self):
        rng = np.random.default_rng(4)
        pools = {n: rng.standard_normal((3, 12, 4, 2, 32), dtype=np.float32) for n in ("k", "v")}
        k = rng.standard_normal((3, 5, 2, 32), dtype=np.float32)
        v = rng.standard_normal((3, 5, 2, 32), dtype=np.float32)
        # four live slots at distinct positions and one masked into scratch
        blocks = np.asarray([7, tpaged.SCRATCH_BLOCK, 2, 11, 7], np.int32)
        offs = np.asarray([1, 0, 3, 0, 2], np.int32)
        jp = jpaged.write_token({n: jnp.asarray(a) for n, a in pools.items()}, jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(blocks), jnp.asarray(offs))
        tp = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
        assert tpaged.write_token(tp, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(blocks).long(),
                                  torch.from_numpy(offs).long()) is tp
        for n in ("k", "v"):
            np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]))


class TestCachedAttention:
    @pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (8, 2)], ids=["g1", "g2", "g4"])
    @pytest.mark.parametrize("sq", [1, 3])
    def test_reference_matches_jax_cached_attention(self, hq, hkv, sq):
        d, cap = 32, 24
        rng = np.random.default_rng(hq + 10 * sq)
        # lengths: one row (or Sq), mid capacity, full capacity
        lens = np.asarray([sq, 11, cap], np.int32)
        q = rng.standard_normal((3, sq, hq, d), dtype=np.float32)
        k = rng.standard_normal((3, cap, hkv, d), dtype=np.float32)
        v = rng.standard_normal((3, cap, hkv, d), dtype=np.float32)
        cfg = dataclasses.replace(jllama.llama_tiny(), n_heads=hq, n_kv_heads=hkv, dim=hq * d)
        got = cached_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), torch.from_numpy(lens))
        assert got.shape == q.shape
        for b, n in enumerate(lens):
            want = jllama._cached_attention(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                            jnp.asarray(v[b:b + 1]), int(n), cfg)
            np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                       atol=2e-4, rtol=2e-4)

    def test_dispatcher_takes_the_plain_version_and_keys_past_the_length_count_nothing(self):
        rng = np.random.default_rng(3)
        q = torch.from_numpy(rng.standard_normal((2, 1, 4, 32), dtype=np.float32))
        k = torch.from_numpy(rng.standard_normal((2, 16, 2, 32), dtype=np.float32))
        v = torch.from_numpy(rng.standard_normal((2, 16, 2, 32), dtype=np.float32))
        lens = torch.tensor([5, 16], dtype=torch.int32)
        out = cached_attention(q, k, v, lens)
        assert torch.equal(out, cached_attention_reference(q, k, v, lens))
        v2 = v.clone()
        v2[0, 5:] = 1e6
        assert torch.equal(cached_attention(q, k, v2, lens), out)
        # a row with no key gives zeros, as the kernel defines it
        empty = cached_attention(q, k, v, torch.tensor([0, 16], dtype=torch.int32))
        assert torch.equal(empty[0], torch.zeros_like(empty[0]))

    def test_the_device_cursor_step_matches_the_host_cursor_step(self, tiny):
        _, params_t = tiny["float"]
        cfg = tiny["cfg_t"]
        toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12)))
        logits = {}
        for mode in ("host", "device"):
            cache = tllama.init_cache(cfg, 2, capacity=20, device="cpu")
            tllama.forward(params_t, toks[:, :9], cfg, cache=cache,
                           positions=torch.arange(9).expand(2, 9))
            if mode == "device":
                cursor = tllama.device_cursor(cache)
                assert all(c["cursor"] is cursor for c in cache)
            steps = []
            for i in range(9, 12):
                out, _ = tllama.forward(params_t, toks[:, i:i + 1], cfg, cache=cache,
                                        positions=torch.full((2, 1), i))
                steps.append(out)
            logits[mode] = torch.cat(steps, dim=1)
            assert (torch.as_tensor(cache[0]["cursor"]) == 12).all()
        np.testing.assert_allclose(logits["device"].numpy(), logits["host"].numpy(),
                                   atol=1e-5, rtol=1e-5)

    def test_a_device_cursor_must_be_shared(self, tiny):
        _, params_t = tiny["float"]
        cfg = tiny["cfg_t"]
        cache = tllama.init_cache(cfg, 1, capacity=8, device="cpu")
        for c in cache:
            c["cursor"] = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="shared by every layer"):
            tllama.forward(params_t, torch.zeros(1, 1, dtype=torch.long), cfg, cache=cache,
                           positions=torch.zeros(1, 1, dtype=torch.long))


class TestGraphedStepOnTheCpu:
    def test_every_call_runs_the_function(self):
        calls = []
        x = torch.zeros(3)

        def fn(t):
            t.add_(1)
            calls.append(1)
            return t * 2

        step = GraphedStep(fn, x)
        assert not step.graphed
        for i in range(4):
            assert torch.equal(step(), torch.full((3,), 2.0 * (i + 1)))
        assert len(calls) == 4 and step.graph is None and step.replays == 0

    def test_inputs_on_two_devices_raise(self):
        with pytest.raises(ValueError, match="one device"):
            GraphedStep(lambda a, b: a, torch.zeros(1), torch.zeros(1, device="meta"))


class TestFaults:
    def test_greedy_generate_returns_int32_and_an_empty_array_at_zero_tokens(self, tiny):
        cfg_j, params_j = tiny["cfg_j"], tiny["float"][0]
        _, params_t = tiny["float"]
        prompt = np.asarray([[1, 2, 3, 4]])
        want = jllama.greedy_generate(params_j, jnp.asarray(prompt), cfg_j, max_new_tokens=0)
        got = tllama.greedy_generate(params_t, torch.from_numpy(prompt), tiny["cfg_t"],
                                     max_new_tokens=0)
        assert tuple(got.shape) == want.shape == (1, 0)
        assert got.dtype == torch.int32 and want.dtype == jnp.int32
        some = tllama.greedy_generate(params_t, torch.from_numpy(prompt), tiny["cfg_t"],
                                      max_new_tokens=3)
        assert some.dtype == torch.int32 and tuple(some.shape) == (1, 3)

    def test_request_has_the_jax_fields_in_order(self):
        names = [f.name for f in dataclasses.fields(Request)]
        assert names == [f.name for f in dataclasses.fields(jengine.Request)]
        for f, g in zip(dataclasses.fields(Request), dataclasses.fields(jengine.Request)):
            if f.default is not dataclasses.MISSING:
                assert f.default == g.default, f.name
        # a positional temperature is a temperature, not an eos
        req = Request(0, [1, 2], 4, 0.0)
        assert req.temperature == 0.0 and req.eos_token is None
        assert (req.adapter, req.tenant, req.trace) == (0, "", None)

    def test_submit_fills_the_request_as_jax_does(self, tiny):
        _, params_t = tiny["float"]
        eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 16, 4), 1)
        rid = eng.submit([1, 2, 3], 4, 0.0, 7)
        req = eng.pending[0]
        assert (req.rid, req.temperature, req.eos_token, req.max_new_tokens) == (rid, 0.0, 7, 4)
        assert req.submitted_at > 0 and req.submitted_wall > 0
        assert req.preseeded == 0 and req.output == []


class TestChipSmokeArithmetic:
    """chip_smoke.py's counts and bounds of this slice's paths (its
    helpers load without a card: the script imports torch only in main)."""

    @pytest.fixture(scope="class")
    def smoke(self):
        import importlib.util
        from pathlib import Path

        path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke_horizon", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def test_greedy_launches_count_every_forward_and_replay(self, smoke):
        # 1 + 64 forwards of 32 layers: 65 norms each, 64 of them in the
        # add mode; the prefill's attention plus 64 decode steps' through
        # the device-length entry, which the flash counter also counts
        assert smoke.greedy_launches(32) == {
            "rmsnorm": 65 * 65, "add_rmsnorm": 65 * 64, "flash_attention": 65 * 32,
            "cached_attention": 64 * 32, "paged_attention": 0}
        assert smoke.GREEDY_RUNS == (False, True, True, False)

    def test_cached_decode_bound_and_split(self, smoke):
        from bobrapet_tpu_torch.ops.attention import kv_splits

        assert smoke.CACHE_ROWS == 192 and kv_splits(smoke.CACHE_ROWS) == 4
        # q [8,1,32,128] + out, 8 x 160 valid K/V rows of [8,128], bf16,
        # and the 8 lengths
        nbytes = (2 * 8 * 160 * 8 * 128 + 2 * 8 * 32 * 128) * 2 + 4 * 8
        assert round(nbytes / 1e6, 2) == 5.37
        pairs = 8 * smoke.attention_pairs(1, 160, True, 159)
        ms, by = smoke.bound(nbytes, 4 * 128 * 32 * pairs, "bfloat16")
        assert by == "bytes" and round(ms * 1e3, 2) == 1.6

    def test_serving_modes_alternate_and_the_cross_check_fits(self, smoke):
        order = smoke.SERVE_ORDER
        assert set(order) == set(smoke.SERVE_MODES) and order == order[::-1]
        assert smoke.SERVE_MODES["h8"] == (False, 8)
        # the fp32 cross-check's longest prompt plus budget fits a slot of
        # 4 blocks of 16, and the classic run is a prefix of the horizon's
        assert max(smoke.CROSS_BUDGET.values()) + 30 <= 64
        assert smoke.CROSS_BUDGET[1] < smoke.CROSS_BUDGET[8]
