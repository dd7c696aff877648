"""Sampled decoding in the port: the token pick (``ops.pick_tokens``) and
the engine's sampled streams, on the CPU.

JAX's ``jax.random.categorical`` draws from threefry bits that torch cannot
reproduce, so the port fixes its own draw (Philox4x32-10 keyed by (rid,
token index), Gumbel-max; ``ops/pick_tokens.py``). Held here:

- Philox4x32-10 against Random123's known answers, bit for bit;
- the Gumbel transform against float64 within 2 fp32 ulps, and finite at
  both ends of u;
- at T = 0 (and T < 0) the pick is ``torch.argmax`` and ``jnp.argmax`` on
  the same logits, ties to the lowest index included;
- the draws of one row (16 logits, T = 0.7, 20,000 token indices) pass a
  chi-square test against ``softmax(l / T)``, the distribution of
  ``jax.random.categorical``, and against JAX's own 20,000 draws (two
  samples): the statistic under the 0.001 critical value (37.70 at 15
  degrees of freedom, 37.70 again for the two-sample test's 15);
- a draw depends on (rid, token index) alone, never on the row it sits in;
- the engine's sampled and mixed streams are the same across H = 1, 2, 8,
  dispatch depth 1, 2, 3, slot count, prefix caching, chunked prefill,
  preemption and speculation (bit-identical tokens: the same key and the
  same logits up to the float rounding of the forms of a forward, which
  the seeds here never bring near a tie);
- the wrapper's contract: the kernel's C signature, the cluster split, the
  clusters a row takes (``pick_chunks``, the C entry's ``chunks_for``), the
  flags the entry's ``vec`` carries, and a CPU tensor refused by
  ``pick_tokens_cuda``;
- the temperature's floor (JAX's ``jnp.maximum(t, 1e-6)``): a subnormal or
  tiny T picks as T = 1e-6 does, the argmax on well-separated logits, in
  the op and in the prefill's ``_sample_host``.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import quant as tquant
from bobrapet_tpu_torch.ops import pick_tokens, pick_tokens_cuda, pick_tokens_reference
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from tests.torch_lockstep import bridge

# the module (the package exports a function of the same name)
pick_ops = importlib.import_module("bobrapet_tpu_torch.ops.pick_tokens")
CSRC = Path(pick_ops.__file__).resolve().parent.parent / "csrc"

#: chi-square critical value at p = 0.001, 15 degrees of freedom
CHI2_15_P001 = 37.697


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny models: the test workers share
    the cores, and contended thread pools slow every step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Philox and the Gumbel transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_gives_random123s_known_answers(counter, key, want):
    got = pick_ops.philox4x32(torch.tensor([counter], dtype=torch.long), key)
    assert tuple(got[0].tolist()) == want


def test_mulhilo_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    a[:3] = [0, 1, 2 ** 32 - 1]
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = pick_ops._mulhilo(torch.from_numpy(a.astype(np.int64)), m)
        full = [int(x) * m for x in a]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]


def test_the_gumbel_transform_keeps_every_bit_of_u():
    # the words at both ends and around the middle of (0, 1)
    x = np.array([0, 1, 2 ** 22, 2 ** 23 - 1, 2 ** 23, 2 ** 23 + 1, 2 ** 24 - 2, 2 ** 24 - 1])
    w = torch.from_numpy((x << 8) | 0x5A)
    g = pick_ops.gumbel_from_words(w)
    u = (x + 0.5) * 2.0 ** -24
    want = -np.log(-np.log(u))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), want.astype(np.float32), rtol=2 * 2.0 ** -23)
    # distinct words near 1 give distinct noise (u there needs 25 bits)
    assert len(set(g[-3:].tolist())) == 3


def test_the_noise_is_gumbel():
    g = pick_ops.gumbel_noise(torch.arange(4, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32), 50_000)
    assert abs(float(g.mean()) - 0.5772157) < 0.01          # Euler-Mascheroni
    assert abs(float(g.std()) - np.pi / np.sqrt(6)) < 0.01


# ---------------------------------------------------------------------------
# the pick
# ---------------------------------------------------------------------------


def test_greedy_is_the_argmax_of_torch_and_jax_ties_included():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 300)).astype(np.float32)
    logits[::3, 17] = logits[::3, 200] = 9.0   # a tie: the lower index wins
    logits[1::7, :] = 0.0                       # a whole row tied
    t = torch.from_numpy(logits)
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    zero = torch.zeros(64)
    minus = torch.full((64,), -1.0)
    ids = torch.arange(64, dtype=torch.int32)
    for temps in (None, zero, minus):
        keyed = () if temps is None else (temps, ids, ids)
        got = pick_tokens_reference(t, *keyed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), t.argmax(-1).numpy())
    tied = [r for r in range(0, 64, 3) if r % 7 != 1]   # (the zero rows overwrote the rest)
    assert (want[tied] == 17).all() and (want[1::7] == 0).all()
    # bf16 logits are picked over their float values
    b = t.to(torch.bfloat16)
    np.testing.assert_array_equal(pick_tokens_reference(b).numpy(), b.float().argmax(-1).numpy())


def _chi2(counts, expected):
    return float(((counts - expected) ** 2 / expected).sum())


def test_draws_follow_softmax_of_logits_over_t():
    rng = np.random.default_rng(2)
    row = rng.standard_normal(16).astype(np.float32) * 1.5
    n, temp = 20_000, 0.7
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    draws = pick_tokens_reference(logits, torch.full((n,), temp),
                                  torch.full((n,), 7, dtype=torch.int32),
                                  torch.arange(n, dtype=torch.int32))
    counts = np.bincount(draws.numpy(), minlength=16)
    p = np.exp(row / temp - (row / temp).max())
    p /= p.sum()
    assert _chi2(counts, n * p) < CHI2_15_P001
    # JAX's categorical on the same row: the two samples, one distribution
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    jdraws = np.asarray(jax.vmap(lambda k: jax.random.categorical(k, jnp.asarray(row) / temp))(
        keys))
    jcounts = np.bincount(jdraws, minlength=16)
    pooled = (counts + jcounts) / (2 * n)
    stat = _chi2(counts, n * pooled) + _chi2(jcounts, n * pooled)
    assert stat < CHI2_15_P001


def test_a_draw_is_keyed_by_rid_and_token_index_alone():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((6, 500)).astype(np.float32))
    temps = torch.tensor([0.8, 1.0, 0.0, 1.3, 0.7, 1.0])
    rids = torch.tensor([3, 3, 5, 9, 11, 3], dtype=torch.int32)
    index = torch.tensor([0, 1, 4, 2, 2, 0], dtype=torch.int32)
    base = pick_tokens(logits, temps, rids, index)
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    assert pick_tokens(logits[perm], temps[perm], rids[perm], index[perm]).tolist() == \
        base[perm].tolist()
    # rows 0 and 5: one key, one row of logits at the same temperature
    logits[5] = logits[0]
    temps[5] = temps[0]
    got = pick_tokens(logits, temps, rids, index)
    assert got[0] == got[5]
    # another index of the same request draws anew (over 64 indices the
    # draws of a flat row cover most of its 500 tokens)
    flat = torch.zeros((64, 500))
    many = pick_tokens(flat, torch.ones(64), torch.full((64,), 3, dtype=torch.int32),
                       torch.arange(64, dtype=torch.int32))
    assert len(set(many.tolist())) > 50


#: fp32 [4, 128256] = torch.randn * 3 at seed 0: each row's argmax
FLOOR_ROWS_ARGMAX = [36885, 62653, 15810, 102285]


def _floor_rows():
    return torch.randn(4, 128_256, generator=torch.Generator().manual_seed(0)) * 3


@pytest.mark.parametrize("temp", [1e-39, 1e-37])
def test_a_tiny_temperature_is_floored_at_1e_6(temp):
    logits = _floor_rows()
    rids = torch.arange(4, dtype=torch.int32) * 7 + 1
    index = torch.arange(4, dtype=torch.int32)
    got = pick_tokens(logits, torch.full((4,), temp), rids, index)
    assert got.tolist() == FLOOR_ROWS_ARGMAX == logits.argmax(-1).tolist()
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist()
    # the same draw as at the floor itself: one rule, T = max(T, 1e-6)
    at_floor = pick_tokens(logits, torch.full((4,), 1e-6), rids, index)
    assert torch.equal(got, at_floor)
    # the fp32 floor, as jnp.maximum sees it, divides
    scores = logits / np.float32(1e-6) + pick_ops.gumbel_noise(rids, index, logits.shape[1])
    assert got.tolist() == scores.argmax(-1).tolist()


def test_pick_splits_the_row_over_a_cluster_of_up_to_8():
    assert pick_ops.pick_splits(128_256) == 8
    per = 4 * pick_ops._GROUPS_PER_BLOCK   # the logits one block takes
    assert [pick_ops.pick_splits(v) for v in (1, 512, per, per + 1, 2 * per, 2 * per + 1,
                                              4 * per, 4 * per + 1)] == [1, 1, 1, 2, 2, 4, 4, 8]
    assert pick_ops.pick_splits(10 ** 7) == pick_ops.MAX_SPLITS == 8


def test_pick_chunks_fills_the_card_with_a_rows_clusters():
    sms = 132  # the H100's
    # an engine step's rows, a verify's, one row (the standalone draft),
    # a flood of rows, and rows too short for a second cluster
    assert [pick_ops.pick_chunks(r, 128_256, sms) for r in (8, 40, 1, 1024)] == [8, 2, 15, 1]
    assert [pick_ops.pick_chunks(8, v, sms) for v in (1, 3, 5, 512, 4097)] == [1, 1, 1, 1, 4]
    for rows in (1, 2, 3, 8, 17, 40, 100, 500, 1024, 65535):
        for v in (1, 3, 5, 4097, 32_000, 128_256, 10 ** 6):
            c = pick_ops.pick_chunks(rows, v, sms)
            splits = pick_ops.pick_splits(v)
            assert 1 <= c <= pick_ops.MAX_CHUNKS
            if c > 1:
                # a partial slot a cluster; a group of 4 a thread at least;
                # about BLOCKS_PER_SM blocks an SM, never twice that
                assert rows * c <= pick_ops.MAX_PARTIALS
                assert -(-v // 4) >= c * splits * pick_ops.BLOCK_THREADS
                assert rows * splits * c <= 2 * sms * pick_ops.BLOCKS_PER_SM
    # the split of a row covers each group once: contiguous parts
    v, rows = 128_256, 8
    parts = pick_ops.pick_splits(v) * pick_ops.pick_chunks(rows, v, sms)
    groups = -(-v // 4)
    per = -(-groups // parts)
    spans = [(per * b, min(per * (b + 1), groups)) for b in range(parts)]
    assert spans[0][0] == 0 and spans[-1][1] == groups
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_the_c_entry_point_and_its_constants():
    text = (CSRC / "pick_tokens.cu").read_text()
    sig = re.search(r'extern "C" int bobra_pick_tokens\((.*?)\)', text, re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params == ["logits", "temps", "rids", "index", "out", "rows", "v", "splits", "vec",
                      "dtype", "stream"]
    assert len(params) == len(pick_ops._ARGTYPES)
    assert int(re.search(r"constexpr int kMaxSplits = (\d+);", text).group(1)) == 8
    assert int(re.search(r"constexpr int kThreads = (\d+);", text).group(1)) * 4 == \
        pick_ops._GROUPS_PER_BLOCK
    # the Philox constants of the plain version
    for c in (*pick_ops._PHILOX_M, *pick_ops._PHILOX_W):
        assert f"0x{c:08X}u" in text


def test_the_c_entry_mirrors_the_chunk_rule_flags_and_floor():
    text = (CSRC / "pick_tokens.cu").read_text()

    def const(name):
        return re.search(rf"constexpr (?:int|float) {name} = ([0-9.e-]+)f?;", text).group(1)

    assert int(const("kBlockThreads")) == pick_ops.BLOCK_THREADS
    assert int(const("kBlocksPerSm")) == pick_ops.BLOCKS_PER_SM
    assert int(const("kThreads")) == pick_ops.BLOCK_THREADS * pick_ops.BLOCKS_PER_SM
    assert int(const("kMaxChunks")) == pick_ops.MAX_CHUNKS
    assert int(const("kMaxPartials")) == pick_ops.MAX_PARTIALS
    assert int(const("kFlagVec")) == pick_ops.FLAG_VEC == 1
    assert int(const("kFlagPdl")) == pick_ops.FLAG_PDL == 2
    assert float(const("kTempFloor")) == pick_ops.TEMP_FLOOR == 1e-6
    # the entry derives the clusters of a row from the card's SMs
    assert "chunks_for(rows, v, splits, sms)" in text
    assert "cudaDevAttrMultiProcessorCount" in text
    # the entry refuses any other bit of vec
    assert "vec & ~(pick::kFlagVec | pick::kFlagPdl)" in text
    # programmatic dependent launch is on unless a measurement turns it off
    assert pick_tokens_cuda.pdl is True


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        pick_tokens_cuda(torch.zeros(2, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pick_tokens_cuda(torch.zeros(2, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="together"):
        pick_tokens_cuda(torch.zeros(2, 8), torch.zeros(2))
    with pytest.raises(ValueError, match=r"\[R, V\]"):
        pick_tokens_cuda(torch.zeros(8))
    assert pick_tokens_cuda.launches == 0


# ---------------------------------------------------------------------------
# the engine's sampled streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port():
    params_j = jllama.init_params(jax.random.PRNGKey(0), jllama.llama_tiny())
    params = bridge(params_j)
    return tllama.llama_tiny(), params, tquant.quantize_params(params)


SYSTEM = list(range(100, 132))   # a shared 32-token prefix (two blocks of 16)
TEMPS = (0.7, 0.0, 1.0, 1.3, 0.9, 0.0)


def _workload(vocab):
    rng = np.random.default_rng(9)
    return [SYSTEM + rng.integers(0, vocab, 5 + 9 * i).tolist() for i in range(6)]


def _serve(port, pcfg, horizon=8, depth=1, spec=False, temps=TEMPS):
    """The workload in two waves (the second finds the first's prefix
    blocks), temperatures cycling through ``temps``; returns the engine
    and {rid: output}."""
    cfg, params, draft = port
    kw = dict(draft_params=draft, draft_cfg=cfg, spec_k=3, spec_guard=False) if spec else {}
    eng = ServingEngine(params, cfg, pcfg, decode_horizon=horizon, dispatch_depth=depth, **kw)
    prompts = _workload(cfg.vocab_size)
    for wave in (range(3), range(3, 6)):
        for i in wave:
            eng.submit(prompts[i], 10 + 3 * i, temperature=temps[i % len(temps)])
        eng.run()
    assert eng.phase_counts["prefill_picks"] >= len(prompts)
    return eng, {r.rid: r.output for r in eng.finished}


BASE = dict(max_slots=4, block_size=16, num_blocks=64, max_blocks_per_seq=8,
            prefix_caching=False)


@pytest.mark.parametrize("variant", [
    dict(horizon=1), dict(horizon=2), dict(horizon=2, depth=3), dict(depth=2),
    dict(paging={"max_slots": 2}), dict(paging={"max_slots": 6}),
    dict(paging={"prefix_caching": True}),
    dict(paging={"prefix_caching": True, "prefill_chunk": 16}),
    dict(paging={"num_blocks": 14}),                       # preempts
    dict(spec=True), dict(spec=True, horizon=1), dict(spec=True, depth=2),
], ids=["h1", "h2", "h2_depth3", "depth2", "two_slots", "six_slots", "prefix", "chunked",
        "preempting", "spec", "spec_h1", "spec_depth2"])
def test_sampled_streams_do_not_depend_on_the_schedule(port, variant):
    _, base = _serve(port, PagedConfig(**BASE))
    paging = {**BASE, **variant.get("paging", {})}
    eng, got = _serve(port, PagedConfig(**paging), horizon=variant.get("horizon", 8),
                      depth=variant.get("depth", 1), spec=variant.get("spec", False))
    assert got == base
    if variant.get("spec"):
        assert eng.spec_drafted > 0
    if paging["num_blocks"] < BASE["num_blocks"]:
        assert sum(r.preemptions for r in eng.finished) > 0
    if paging["prefix_caching"]:
        assert eng.blocks.hit_tokens > 0
    if paging.get("prefill_chunk"):
        assert eng.phase_counts["chunks"] > 0


def test_a_subnormal_temperature_in_the_engine_is_floored(port):
    """The prefill's first token (``_sample_host``) and the fused picks
    after it: T = 1e-39 draws what T = 1e-6 draws (the same rids), and on
    these logits that is the greedy stream."""
    _, tiny = _serve(port, PagedConfig(**BASE), temps=(1e-39,))
    eng, floor = _serve(port, PagedConfig(**BASE), temps=(1e-6,))
    _, greedy = _serve(port, PagedConfig(**BASE), temps=(0.0,))
    assert eng.phase_counts["prefill_picks"] >= 6
    assert tiny == floor == greedy


def test_sampled_requests_draw_and_greedy_ones_do_not(port):
    _, mixed = _serve(port, PagedConfig(**BASE))
    _, greedy = _serve(port, PagedConfig(**BASE), temps=(0.0,))
    for rid, out in mixed.items():
        if TEMPS[rid % len(TEMPS)] == 0:
            assert out == greedy[rid]
    assert all(mixed[rid] != greedy[rid] for rid in mixed if TEMPS[rid % len(TEMPS)] > 0)
