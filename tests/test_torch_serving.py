"""The port's serving slice (bobrapet_tpu_torch.serving and the plain paged
attention) against the JAX package, on the CPU.

Inputs come from numpy seeds and JAX's weights are carried over with the
bridge, so both sides see the same numbers. Tolerances: the plain paged
attention within 2e-4 of JAX's einsum route (fp32, the JAX package's
attention tolerance); the pool writes bit-identical; one decode step's
written K/V within 2e-3 (the fp32 model tolerance of test_torch_llama.py)
and its tokens identical; whole engines in lockstep, with the same slots,
blocks and free list after every step, and identical outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu.serving import BlockAllocator as JBlockAllocator
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu.serving import engine as jengine
from bobrapet_tpu.serving import paged_cache as jpaged
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.ops import paged_attention, paged_attention_reference
from bobrapet_tpu_torch.serving import BlockAllocator, PagedConfig, ServingEngine
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
    # JAX's default route; the Pallas route would need a TPU anyway
    monkeypatch.delenv("BOBRA_PALLAS_PAGED", raising=False)


def _pools(rng, shape):
    return {"k": rng.standard_normal(shape, dtype=np.float32),
            "v": rng.standard_normal(shape, dtype=np.float32)}


def _tables(rng, lens, mb, n_blocks, block):
    """Distinct random live blocks per sequence; a length-1 lane with an
    all-scratch row stands for an inactive slot (seq_lens[0])."""
    ids = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((len(lens), mb), np.int32)
    used = 0
    for s, n in enumerate(lens):
        if s == 0:
            continue  # inactive lane: all scratch
        k = -(-n // block)
        tables[s, :k] = ids[used:used + k]
        used += k
    return tables


class TestPagedAttention:
    # seq_lens: the inactive lane, 1, block boundaries (4, 5, 8, 9), full
    LENS = [1, 1, 4, 5, 8, 9, 16]

    @pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (8, 2)], ids=["g1", "g2", "g4"])
    @pytest.mark.parametrize("layer", [0, 1])
    def test_reference_matches_jax_einsum_route(self, hq, hkv, layer):
        rng = np.random.default_rng(hq * 10 + layer)
        d, block, mb, n_blocks = 32, 4, 4, 32
        pools = _pools(rng, (2, n_blocks, block, hkv, d))
        tables = _tables(rng, self.LENS, mb, n_blocks, block)
        lens = np.asarray(self.LENS, np.int32)
        q = rng.standard_normal((len(lens), 1, hq, d), dtype=np.float32)
        want = jengine._paged_attention(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in pools.items()},
            jnp.asarray(tables), jnp.asarray(lens), layer,
            dataclasses.replace(jllama.llama_tiny(), n_heads=hq, n_kv_heads=hkv, dim=hq * d))
        got = paged_attention_reference(
            torch.from_numpy(q[:, 0]), torch.from_numpy(pools["k"][layer]),
            torch.from_numpy(pools["v"][layer]), torch.from_numpy(tables),
            torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], atol=2e-4, rtol=2e-4)

    def test_dispatcher_takes_the_plain_version_on_the_cpu(self):
        rng = np.random.default_rng(7)
        pools = _pools(rng, (12, 4, 2, 32))
        tables = torch.from_numpy(_tables(rng, [1, 6, 9], 3, 12, 4))
        lens = torch.tensor([1, 6, 9], dtype=torch.int32)
        q = torch.from_numpy(rng.standard_normal((3, 4, 32), dtype=np.float32))
        k, v = torch.from_numpy(pools["k"]), torch.from_numpy(pools["v"])
        assert torch.equal(paged_attention(q, k, v, tables, lens),
                           paged_attention_reference(q, k, v, tables, lens))

    def test_zero_length_gives_zero_and_masked_keys_count_nothing(self):
        rng = np.random.default_rng(8)
        k = torch.from_numpy(rng.standard_normal((8, 4, 1, 32), dtype=np.float32))
        v = torch.from_numpy(rng.standard_normal((8, 4, 1, 32), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((2, 2, 32), dtype=np.float32))
        tables = torch.tensor([[3, 5], [3, 5]], dtype=torch.int32)
        out = paged_attention_reference(q, k, v, tables, torch.tensor([0, 5], dtype=torch.int32))
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        # keys past seq_len (the rest of block 5) do not move the output
        v2 = v.clone()
        v2[5, 1:] = 1e6
        again = paged_attention_reference(q, k, v2, tables, torch.tensor([0, 5], dtype=torch.int32))
        assert torch.equal(out, again)


class TestPagedCache:
    def test_paged_config_matches_jax(self):
        assert [f.name for f in dataclasses.fields(PagedConfig)] == \
            [f.name for f in dataclasses.fields(JPagedConfig)]
        for kw in ({}, {"block_size": 8, "max_blocks_per_seq": 4}):
            pj, pt = JPagedConfig(**kw), PagedConfig(**kw)
            assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
            assert pj.capacity == pt.capacity
            assert [pj.blocks_for(n) for n in range(40)] == [pt.blocks_for(n) for n in range(40)]

    def test_init_pools_shape_and_type(self, tiny):
        pt = PagedConfig(num_blocks=10, block_size=4)
        pj = jpaged.init_pools(tiny["cfg_j"], JPagedConfig(num_blocks=10, block_size=4))
        pools = tpaged.init_pools(tiny["cfg_t"], pt, "cpu")
        assert tuple(pools["k"].shape) == pj["k"].shape == (2, 10, 4, 2, 32)
        assert pools["v"].dtype == torch.float32 and not pools["k"].any()

    def test_write_prefill_and_gather_kv_are_bit_identical(self):
        rng = np.random.default_rng(3)
        shape = (2, 16, 4, 2, 32)
        pools = _pools(rng, shape)
        k = rng.standard_normal((2, 12, 2, 32), dtype=np.float32)
        v = rng.standard_normal((2, 12, 2, 32), dtype=np.float32)
        ids = np.asarray([7, 2, 11], np.int32)
        jp = jpaged.write_prefill({n: jnp.asarray(a) for n, a in pools.items()},
                                  jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids))
        tp = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
        assert tpaged.write_prefill(tp, torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(ids).long()) is tp
        for n in ("k", "v"):
            np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]))
        tables = _tables(rng, [1, 5, 12], 3, 16, 4)
        tables[2, :3] = ids
        for layer in (0, 1):
            jk, jv = jpaged.gather_kv(jp, jnp.asarray(tables), layer)
            tk, tv = tpaged.gather_kv(tp, torch.from_numpy(tables), layer)
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    def test_block_allocator_hands_out_jax_ids(self):
        ops = [("alloc", 3), ("alloc", 2), ("free", [2, 1]), ("alloc", 4), ("alloc", 9),
               ("free", [5]), ("alloc", 1), ("alloc", 3)]
        a, b = JBlockAllocator(12), BlockAllocator(12)
        for op, arg in ops:
            if op == "alloc":
                assert a.alloc(arg) == b.alloc(arg)
            else:
                a.free(arg)
                b.free(arg)
            assert a.free_blocks == b.free_blocks

    def test_scratch_never_allocated(self):
        a = BlockAllocator(8)
        got = a.alloc(7)
        assert got is not None and tpaged.SCRATCH_BLOCK not in got
        assert a.alloc(1) is None  # pool exhausted (block 0 reserved)
        a.free(got[:3])
        assert a.free_blocks == 3
        with pytest.raises(ValueError):
            a.free([tpaged.SCRATCH_BLOCK])

    def test_all_or_nothing(self):
        a = BlockAllocator(4)
        assert a.alloc(5) is None
        assert a.free_blocks == 3  # nothing was consumed


class TestDecodeStep:
    @pytest.mark.parametrize("tree", ["float", "int8"])
    def test_matches_jax_decode_step(self, tiny, tree):
        params_j, params_t = tiny[tree]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        rng = np.random.default_rng(11)
        block, mb, n_blocks = 8, 4, 24
        pools = _pools(rng, (2, n_blocks, block, 2, 32))
        lens = np.asarray([1, 1, 9, 17, 24, 32], np.int32)  # lane 0 inactive
        active = np.asarray([False, True, True, True, True, True])
        tables = _tables(rng, lens, mb, n_blocks, block)
        tokens = rng.integers(0, cfg_j.vocab_size, len(lens)).astype(np.int32)
        S = len(lens)
        pcfg_kw = dict(max_slots=S, block_size=block, num_blocks=n_blocks, max_blocks_per_seq=mb)
        jpools, jtok = jengine._decode_step(
            params_j, {n: jnp.asarray(a) for n, a in pools.items()}, jnp.asarray(tokens),
            jnp.asarray(lens), jnp.asarray(active), jnp.asarray(tables),
            jnp.zeros(S, jnp.float32), jax.random.PRNGKey(0), jnp.zeros(S, jnp.int32),
            jnp.zeros(S, jnp.int32), None, jnp.zeros(S, jnp.int32),
            cfg=cfg_j, pcfg=JPagedConfig(**pcfg_kw))
        tpools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
        tpools, ttok = tengine._decode_step(
            params_t, tpools, torch.from_numpy(tokens), torch.from_numpy(lens),
            torch.from_numpy(active), torch.from_numpy(tables),
            cfg=cfg_t, pcfg=PagedConfig(**pcfg_kw))
        assert ttok.dtype == torch.int32 and ttok.tolist() == np.asarray(jtok).tolist()
        written = np.zeros((n_blocks, block), bool)
        written[tpaged.SCRATCH_BLOCK] = True  # the inactive lane's write
        for n in ("k", "v"):
            want, got = np.asarray(jpools[n]), tpools[n].numpy()
            for s in np.flatnonzero(active):
                pos = lens[s] - 1
                blk, off = tables[s, pos // block], pos % block
                written[blk, off] = True
                assert not np.array_equal(got[:, blk, off], pools[n][:, blk, off])
                np.testing.assert_allclose(got[:, blk, off], want[:, blk, off], atol=2e-3)
            # every other position is untouched
            np.testing.assert_array_equal(got[:, ~written], pools[n][:, ~written])
            np.testing.assert_array_equal(want[:, ~written], pools[n][:, ~written])


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


#: TestEngineCorrectness / TestReviewRegressions scenarios of
#: tests/test_serving.py, greedy ones: (pcfg, [(prompt seed, len)],
#: budget, eos index into a probe run's output or None, tree,
#: free blocks at the end or None)
SCENARIOS = {
    "single_request": ((4, 8, 64, 8), [(0, 12)], 6, None, "float", 63),
    "mixed_lengths": ((4, 8, 64, 8), [(1, 5), (2, 17), (3, 9), (4, 26)], 8, None, "float", 63),
    "more_requests_than_slots": ((2, 8, 32, 4), [(10 + i, 6 + i) for i in range(6)], 5, None,
                                 "float", 31),
    "eos_retires_early": ((2, 8, 16, 4), [(3, 8)], 8, 2, "float", 15),
    "preemption_recompute": ((3, 8, 10, 4), [(20 + i, 14) for i in range(3)], 12, None,
                             "float", 9),
    "budget_one": ((2, 8, 16, 4), [(30, 9)], 1, None, "float", 15),
    "eos_on_prefill_token": ((2, 8, 16, 4), [(31, 9)], 8, 0, "float", 15),
    "int8_weights": ((2, 8, 16, 4), [(5, 10)], 5, None, "int8", 15),
}


def _slot_view(eng):
    return [(s.request.rid, list(s.blocks), s.seq_len) if s is not None else None
            for s in eng.slots]


def _outputs(eng):
    return {r.rid: r.output for r in eng.finished}


def _port_engine(params, cfg, pcfg_t, pipeline=False):
    return ServingEngine(params, cfg, PagedConfig(*pcfg_t, prefix_caching=False),
                         pipeline_decode=pipeline, decode_horizon=1, dispatch_depth=1)


class TestEngineLockstep:
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_same_slots_blocks_and_tokens_as_jax(self, tiny, name):
        pcfg_t, prompts, budget, eos_at, tree, free_end = SCENARIOS[name]
        params_j, params_t = tiny[tree]
        cfg_j, cfg_t = tiny["cfg_j"], tiny["cfg_t"]
        prompts = [_prompt(seed, n, cfg_j.vocab_size) for seed, n in prompts]
        eos = None
        if eos_at is not None:
            probe = _port_engine(params_t, cfg_t, pcfg_t)
            probe.submit(prompts[0], budget)
            eos = probe.run()[0].output[eos_at]
        jeng = JServingEngine(params_j, cfg_j, JPagedConfig(*pcfg_t, prefix_caching=False),
                              pipeline_decode=False, decode_horizon=1, dispatch_depth=1)
        teng = _port_engine(params_t, cfg_t, pcfg_t)
        for p in prompts:
            assert jeng.submit(p, budget, eos_token=eos) == teng.submit(p, budget, eos_token=eos)
        steps = 0
        while jeng.pending or any(jeng.slots):
            assert jeng.step() == teng.step()
            assert _slot_view(teng) == _slot_view(jeng)
            assert teng.allocator.free_blocks == jeng.allocator.free_blocks
            assert len(teng.pending) == len(jeng.pending)
            steps += 1
        assert not (teng.pending or any(teng.slots))
        jeng.run()
        teng.run()
        assert _outputs(teng) == _outputs(jeng)
        assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
        assert [r.preemptions for r in teng.finished] == [r.preemptions for r in jeng.finished]
        assert teng.allocator.free_blocks == free_end
        assert teng.phase_counts["device_steps"] <= steps
        if name == "preemption_recompute":
            assert sum(r.preemptions for r in teng.finished) >= 1
        if eos is not None:
            out = teng.finished[0].output
            assert out[-1] == eos and out.index(eos) == len(out) - 1
        if name == "budget_one":
            assert len(teng.finished[0].output) == 1
        for r in teng.finished:
            assert r.ttft_seconds is not None and r.ttft_seconds >= 0
            assert (r.tpot_seconds is None) == (len(r.output) < 2)

    def test_zero_budget_rejected(self, tiny):
        _, params_t = tiny["float"]
        eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 16, 4))
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit([1, 2, 3], max_new_tokens=0)
        with pytest.raises(ValueError, match="capacity"):
            eng.submit([1, 2, 3], max_new_tokens=30)
        with pytest.raises(ValueError, match="at least one token"):
            eng.submit([], max_new_tokens=3)


class TestPipelinedDecode:
    """Tick N+1 dispatched before tick N's read-back: invisible to the
    tokens."""

    def test_pipelined_equals_synchronous(self, tiny):
        _, params_t = tiny["float"]
        pc = (4, 8, 64, 8)
        prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [11, 12, 13], [4, 4, 4, 4]]
        outs, ahead = {}, False
        for pipeline in (False, True):
            eng = _port_engine(params_t, tiny["cfg_t"], pc, pipeline)
            for i, pr in enumerate(prompts):
                eng.submit(list(pr), 8 + i)
            while eng.pending or any(eng.slots):
                eng.step()
                ahead |= eng._pending_tick is not None
            eng.run()
            outs[pipeline] = _outputs(eng)
        assert ahead  # the pipelined engine did dispatch ahead
        assert outs[True] == outs[False]

    def test_eos_lag_does_not_leak_tokens(self, tiny):
        _, params_t = tiny["float"]
        pc = (2, 8, 32, 8)
        probe = _port_engine(params_t, tiny["cfg_t"], pc)
        probe.submit([5, 6, 7], 16)
        (p,) = probe.run()
        eos = p.output[5]
        for pipeline in (False, True):
            eng = _port_engine(params_t, tiny["cfg_t"], pc, pipeline)
            eng.submit([5, 6, 7], 16, eos_token=eos)
            (r,) = eng.run()
            assert r.output == p.output[:p.output.index(eos) + 1], pipeline
            assert eng.allocator.free_blocks == 31

    def test_late_admission_flushes_cleanly(self, tiny):
        _, params_t = tiny["float"]
        outs = {}
        for pipeline in (False, True):
            eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 64, 8), pipeline)
            eng.submit([1, 2, 3], 10)
            for _ in range(4):
                eng.step()
            eng.submit([7, 8, 9, 10], 10)  # arrives mid-decode
            eng.run()
            outs[pipeline] = _outputs(eng)
        assert outs[True] == outs[False]

    def test_block_tables_cached_between_structural_changes(self, tiny):
        _, params_t = tiny["float"]
        eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 32, 8))
        eng.submit(list(range(1, 6)), 6)
        eng.step()
        t1 = eng._block_tables()
        assert eng._block_tables() is t1 and t1.dtype == torch.int32
        assert t1[0, :len(eng.slots[0].blocks)].tolist() == eng.slots[0].blocks


class TestEngineSurface:
    def test_drain_contract(self, tiny):
        _, params_t = tiny["float"]
        eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 16, 4))
        eng.submit([1, 2, 3], 3)
        eng.drain()
        assert eng.in_flight == 1 and not eng.drained
        with pytest.raises(ValueError, match="draining"):
            eng.submit([4, 5], 2)
        eng.run()
        assert eng.drained and eng.active_slots == 0
        eng.undrain()
        eng.submit([4, 5], 2)
        assert eng.in_flight == 1

    @pytest.mark.parametrize("kwargs,pcfg_kw,match", [
        ({"decode_horizon": 8, "dispatch_depth": 2}, {}, "dispatch_depth=1"),
        ({"dispatch_depth": 2}, {}, "dispatch_depth=1"),
        ({}, {"prefix_caching": True}, "prefix_caching=False"),
        ({}, {"prefill_chunk": 32}, "prefill_chunk=None"),
        ({"loras": {"layers": []}}, {}, "loras=None"),
        ({"draft_params": {}}, {}, "draft_params=None"),
        ({"role": "prefill"}, {}, "role='unified'"),
        ({"role": "decode"}, {}, "role='unified'"),
        ({"moe": True}, {}, "dense LlamaConfig"),
    ], ids=["horizon_depth", "depth", "prefix", "chunk", "lora", "draft", "prefill", "decode", "moe"])
    def test_unported_paths_raise(self, tiny, kwargs, pcfg_kw, match):
        _, params_t = tiny["float"]
        cfg = tiny["cfg_t"]
        kw = {"decode_horizon": 1, "dispatch_depth": 1, **kwargs}
        if kw.pop("moe", False):
            cfg = _MoEConfig(**dataclasses.asdict(cfg), n_experts=4)
        pcfg = PagedConfig(**{"prefix_caching": False, **pcfg_kw})
        with pytest.raises(NotImplementedError, match=match.replace("(", r"\(")):
            ServingEngine(params_t, cfg, pcfg, **kw)

    def test_defaults_ask_for_the_unported_depth(self, tiny):
        _, params_t = tiny["float"]
        with pytest.raises(NotImplementedError, match="dispatch_depth=1"):
            ServingEngine(params_t, tiny["cfg_t"])

    def test_sampled_requests_raise(self, tiny):
        _, params_t = tiny["float"]
        eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 16, 4))
        with pytest.raises(NotImplementedError, match="temperature=0"):
            eng.submit([1, 2, 3], 4, temperature=0.7)

    @pytest.mark.parametrize("kwargs", [{"decode_horizon": 0}, {"dispatch_depth": 0},
                                        {"role": "router"}])
    def test_bad_values_raise_value_error(self, tiny, kwargs):
        _, params_t = tiny["float"]
        kw = {"decode_horizon": 1, "dispatch_depth": 1, **kwargs}
        with pytest.raises(ValueError):
            ServingEngine(params_t, tiny["cfg_t"], PagedConfig(prefix_caching=False), **kw)

    def test_weights_on_two_devices_raise(self, tiny):
        _, params_t = tiny["float"]
        split = {**params_t, "final_norm": {"weight": params_t["final_norm"]["weight"].to("meta")}}
        with pytest.raises(ValueError, match="one device"):
            _port_engine(split, tiny["cfg_t"], (2, 8, 16, 4))

    def test_pools_live_with_the_weights(self, tiny):
        _, params_t = tiny["float"]
        eng = _port_engine(params_t, tiny["cfg_t"], (2, 8, 16, 4))
        assert eng.device == torch.device("cpu")
        assert tuple(eng.pools["k"].shape) == (2, 16, 8, 2, 32)

    def test_bucket_matches_jax(self):
        assert [tengine._bucket(n) for n in range(1, 300)] == \
            [jengine._bucket(n) for n in range(1, 300)]


@dataclasses.dataclass(frozen=True)
class _MoEConfig(tllama.LlamaConfig):
    n_experts: int = 4
