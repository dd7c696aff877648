"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips (the decision is
taken in a fixture, never at import). Run them on the H100 with
``python -m pytest -m gpu tests/test_torch_kernels.py``.

Tolerances. fp32: 1e-5 (RMSNorm) and 2e-4 (attention), the JAX package's
own. bf16: both sides compute in fp32 from the same bf16 inputs and round
the result once, but sum in another order, so a value may round to the
neighbouring bf16 number. Attention is allowed one bf16 ulp of the plain
value (rtol 2^-7) plus 1e-3; RMSNorm two ulps (rtol 2^-6), one for the
normalised value and one carried through the weight product. That
tolerance cannot tell RMSNorm's two bf16 roundings apart (the reference
casts before the weight multiply, the TPU kernel once after), so in bf16
the kernel must also match the plain version bit for bit on at least 99%
of elements: only the fp32 sum order differs.
"""

import importlib

import pytest
import torch

from bobrapet_tpu_torch.kernels import kernel_function
from bobrapet_tpu_torch.models import llama
from bobrapet_tpu_torch.ops import (
    add_rmsnorm_cuda,
    attention,
    attention_reference,
    flash_attention_cuda,
    paged_attention,
    paged_attention_cuda,
    paged_attention_reference,
    rmsnorm_cuda,
    rmsnorm_reference,
)
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine

norm_ops = importlib.import_module("bobrapet_tpu_torch.ops.rmsnorm")
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_kernels.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def _close(out, ref, dtype, rtol_bf16, atol_bf16, tol_fp32):
    out, ref = out.float(), ref.float()
    if dtype == torch.bfloat16:
        bound = atol_bf16 + rtol_bf16 * ref.abs()
    else:
        bound = tol_fp32 + tol_fp32 * ref.abs()
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1024, 4096), (8, 4096), (3, 7, 128), (5, 100), (2, 99)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    x = _randn(shape, dtype, cuda, 0) * 3
    w = (_randn(shape[-1:], torch.float32, cuda, 1) * 0.1 + 1.0).to(dtype)
    before = rmsnorm_cuda.launches
    out = rmsnorm_cuda(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert out.shape == x.shape and out.dtype == dtype
    ref = rmsnorm_reference(x, w, 1e-5)
    _close(out, ref, dtype, 2.0 ** -6, 1e-6, 1e-5)
    if dtype == torch.bfloat16:
        xf = x.float()
        tpu = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5) * w.float()).to(dtype)
        assert _bit_share(out, ref) >= 0.99
        assert _bit_share(ref, tpu) < 0.9  # the check can see the other rounding


def _bit_share(a, b):
    return float((a.view(torch.int16) == b.view(torch.int16)).float().mean())


FLASH_CASES = [
    # b, sq, sk, hq, hkv, d, causal, q_offset; packed rows = sq * hq / hkv
    (8, 128, 128, 32, 8, 128, True, 0),     # the model's prefill
    (8, 1, 160, 32, 8, 128, True, 159),     # a decode step: 4 rows, 4 blocks a cluster
    (2, 100, 100, 8, 2, 128, True, 0),      # ragged
    (2, 7, 45, 4, 4, 128, True, 38),        # ragged chunk after a prefix
    (2, 64, 96, 4, 1, 32, False, 0),        # non-causal, group 4
    (1, 33, 33, 2, 2, 32, True, 0),
    (1, 64, 64, 32, 8, 128, True, 0),       # the engine's largest prefill bucket
    (2, 15, 63, 1, 1, 128, True, 48),       # 15 rows, group 1, Sk 63
    (2, 2, 64, 16, 2, 128, True, 62),       # 16 rows, group 8, Sk 64: one block
    (1, 17, 65, 4, 4, 32, True, 48),        # 17 rows: the rows kernel, Sk 65
    (2, 4, 65, 32, 2, 128, True, 61),       # 64 rows, group 16
    (1, 65, 100, 2, 2, 128, False, 0),      # 65 rows, non-causal
    (2, 8, 80, 4, 2, 32, True, 72),         # 16 rows, group 2
    (2, 1, 2048, 32, 8, 128, True, 2047),   # long decode: 8 blocks, 4 tiles each
    (1, 1, 2048, 16, 1, 32, True, 2047),    # group 16 over a long cache
    (3, 1, 64, 8, 1, 128, True, 63),        # group 8, Sk 64: one block
    (1, 64, 200, 32, 8, 128, True, 136),    # a chunk after a cached prefix
    (2, 1, 1, 4, 1, 32, True, 0),           # one key
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    b, sq, sk, hq, hkv, d, causal, q_offset = case
    q = _randn((b, sq, hq, d), dtype, cuda, 2)
    k = _randn((b, sk, hkv, d), dtype, cuda, 3)
    v = _randn((b, sk, hkv, d), dtype, cuda, 4)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    ref = attention_reference(q, k, v, causal=causal, q_offset=q_offset)
    _close(out, ref, dtype, 2.0 ** -7, 1e-3, 2e-4)


def test_flash_kernel_reads_a_sliced_cache_in_place(cuda):
    cache_k = _randn((2, 64, 2, 32), torch.bfloat16, cuda, 5)
    cache_v = _randn((2, 64, 2, 32), torch.bfloat16, cuda, 6)
    q = _randn((2, 3, 4, 32), torch.bfloat16, cuda, 7)
    n = 40
    out = flash_attention_cuda(q, cache_k[:, :n], cache_v[:, :n], q_offset=n - 3)
    packed = flash_attention_cuda(q, cache_k[:, :n].contiguous(),
                                  cache_v[:, :n].contiguous(), q_offset=n - 3)
    assert torch.equal(out, packed)


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[1], FLASH_CASES[13]], ids=str)
def test_flash_kernel_gives_the_same_bits_twice(cuda, case):
    # the decode kernel combines its cluster in a fixed order: no atomics
    b, sq, sk, hq, hkv, d, causal, q_offset = case
    q = _randn((b, sq, hq, d), torch.bfloat16, cuda, 8)
    k = _randn((b, sk, hkv, d), torch.bfloat16, cuda, 9)
    v = _randn((b, sk, hkv, d), torch.bfloat16, cuda, 10)
    first = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    assert torch.equal(first, flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset))


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 4, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*[torch.zeros(1, 4, 2, 64, device=cuda)] * 3)
    q = torch.zeros(1, 4, 2, 32, device=cuda)
    with pytest.raises(NotImplementedError):
        attention(q, q, q, kv_mask=torch.ones(1, 4, device=cuda))
    with pytest.raises(NotImplementedError):
        attention(q, q, q, sm_scale=0.3)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), q.half(), q.half())
    # bf16 rows are copied 16 bytes at a time
    kv = torch.zeros(1, 4, 2, 33, dtype=torch.bfloat16, device=cuda)[..., 1:]
    qb = torch.zeros(1, 4, 2, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="packed heads"):
        flash_attention_cuda(qb, kv, kv)
    flat = torch.zeros(4 * 2 * 32 + 4, dtype=torch.bfloat16, device=cuda)
    shifted = flat[4:].view(1, 4, 2, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(qb, shifted, shifted)


def test_tiny_model_on_the_card_matches_the_cpu(cuda):
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = _to(params, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
    out = llama.greedy_generate(params_gpu, prompt.to(cuda), cfg, max_new_tokens=6)
    torch.cuda.synchronize()
    forwards = 1 + 6
    assert flash_attention_cuda.launches == cfg.n_layers * forwards
    assert rmsnorm_cuda.launches == (2 * cfg.n_layers + 1) * forwards
    ref = llama.greedy_generate(params, prompt, cfg, max_new_tokens=6)
    assert torch.equal(out.cpu(), ref)


PAGED_CASES = [
    # slots, hq, hkv, d, block, blocks in the pool, blocks per table, seq_lens
    (8, 32, 8, 128, 16, 256, 8, (1, 9, 16, 17, 50, 64, 100, 128)),  # chip_smoke's main case
    (4, 8, 2, 32, 8, 40, 4, (1, 8, 9, 32)),                          # llama_tiny widths
    (3, 4, 4, 128, 4, 20, 5, (1, 4, 5)),                              # group 1
    (2, 16, 1, 32, 16, 6, 2, (32, 17)),                               # group 16, the most
    # capacity 1024: 8 blocks a cluster, 2 tiles each
    (8, 32, 8, 128, 16, 520, 64, (1, 100, 255, 256, 511, 700, 1000, 1024)),
    (4, 16, 2, 128, 16, 40, 8, (3, 64, 65, 128)),                     # group 8
    (3, 4, 2, 32, 16, 20, 4, (1, 33, 63)),                            # group 2
]


def _paged_inputs(case, dtype, cuda, seed=0):
    slots, hq, hkv, d, block, n_blocks, mb, lens = case
    q = _randn((slots, hq, d), dtype, cuda, seed)
    k = _randn((n_blocks, block, hkv, d), dtype, cuda, seed + 1)
    v = _randn((n_blocks, block, hkv, d), dtype, cuda, seed + 2)
    g = torch.Generator().manual_seed(seed)
    ids = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros((slots, mb), dtype=torch.int32)
    for s, n in enumerate(lens):
        if s == 0:
            continue  # an inactive lane: length 1, all scratch
        used = -(-n // block)
        tables[s, :used] = torch.tensor(ids[:used], dtype=torch.int32)
        ids = ids[used:]
    return q, k, v, tables.to(cuda), torch.tensor(lens, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_kernel_matches_plain(cuda, dtype, case):
    q, k, v, tables, lens = _paged_inputs(case, dtype, cuda)
    before = paged_attention_cuda.launches
    out = paged_attention_cuda(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _close(out, paged_attention_reference(q, k, v, tables, lens), dtype, 2.0 ** -7, 1e-3, 2e-4)
    assert torch.equal(paged_attention(q, k, v, tables, lens), out)


def test_paged_kernel_reads_a_layer_of_the_pools_in_place(cuda):
    q, k, v, tables, lens = _paged_inputs(PAGED_CASES[1], torch.bfloat16, cuda)
    pools = torch.stack([torch.zeros_like(k), k]), torch.stack([torch.zeros_like(v), v])
    out = paged_attention_cuda(q, pools[0][1], pools[1][1], tables, lens)
    assert torch.equal(out, paged_attention_cuda(q, k, v, tables, lens))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_zero_length_and_masked_keys(cuda, dtype):
    q, k, v, tables, lens = _paged_inputs(PAGED_CASES[1], dtype, cuda)
    lens[0] = 0
    out = paged_attention_cuda(q, k, v, tables, lens)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    # keys past seq_len in a covered page, and pages past the covered
    # ones, do not move the output
    v2 = v.clone()
    blk = int(tables[2, 1])  # seq_len 9 at block 8: one key in this page
    v2[blk, 1:] = float("nan")
    tables2 = tables.clone()
    tables2[2, 2:] = 10 ** 6  # never read
    assert torch.equal(paged_attention_cuda(q, k, v2, tables2, lens), out)


def test_paged_kernel_bad_page_gives_nan_and_long_lengths_count_as_capacity(cuda):
    q, k, v, tables, lens = _paged_inputs(PAGED_CASES[1], torch.bfloat16, cuda)
    out = paged_attention_cuda(q, k, v, tables, lens)
    bad = tables.clone()
    bad[2, 0] = 10 ** 6  # a covered page outside the pool
    out_bad = paged_attention_cuda(q, k, v, bad, lens)
    assert bool(torch.isnan(out_bad[2].float()).all())
    assert torch.equal(out_bad[3], out[3])
    long = lens.clone()
    long[3] = 10 ** 6  # past the table's capacity of 4 blocks of 8
    cap = lens.clone()
    cap[3] = 32
    assert torch.equal(paged_attention_cuda(q, k, v, tables, long),
                       paged_attention_cuda(q, k, v, tables, cap))


@pytest.mark.parametrize("case", [PAGED_CASES[0], PAGED_CASES[4]], ids=str)
def test_paged_kernel_gives_the_same_bits_twice(cuda, case):
    q, k, v, tables, lens = _paged_inputs(case, torch.bfloat16, cuda, seed=3)
    first = paged_attention_cuda(q, k, v, tables, lens)
    assert torch.equal(first, paged_attention_cuda(q, k, v, tables, lens))


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, lens = _paged_inputs(PAGED_CASES[1], torch.float32, cuda)
    with pytest.raises(TypeError):
        paged_attention_cuda(q, k, v, tables.long(), lens)
    with pytest.raises(TypeError):
        paged_attention_cuda(q, k, v, tables, lens.long())
    with pytest.raises(TypeError):
        paged_attention_cuda(q.half(), k.half(), v.half(), tables, lens)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention_cuda(q[..., :16].contiguous(), k[..., :16].contiguous(),
                             v[..., :16].contiguous(), tables, lens)
    with pytest.raises(ValueError):
        paged_attention_cuda(q, k, v, tables.cpu(), lens)


def test_tiny_engine_on_the_card_matches_the_cpu(cuda):
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = PagedConfig(max_slots=3, block_size=8, num_blocks=24, max_blocks_per_seq=4,
                       prefix_caching=False)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 12, 9, 3)]
    outs = {}
    for name, tree in (("cpu", params), ("card", _to(params, cuda))):
        for pipeline in (False, True):
            eng = ServingEngine(tree, cfg, pcfg, pipeline_decode=pipeline,
                                decode_horizon=1, dispatch_depth=1)
            for p in prompts:
                eng.submit(p, 10)
            paged_attention_cuda.launches = 0
            eng.run()
            ticks = eng.phase_counts["device_steps"]
            assert paged_attention_cuda.launches == (ticks * cfg.n_layers if name == "card" else 0)
            outs[name, pipeline] = {r.rid: r.output for r in eng.finished}
    assert outs["card", False] == outs["card", True] == outs["cpu", False] == outs["cpu", True]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# RMSNorm's add mode: s = x + delta (rounded once), y = rmsnorm(s)
# ---------------------------------------------------------------------------


NORM_SHAPES = [(1024, 4096), (8, 4096), (3, 7, 128), (5, 100), (2, 99), (4, 2048)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_add_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    x = _randn(shape, dtype, cuda, 0) * 3
    delta = _randn(shape, dtype, cuda, 11)
    w = (_randn(shape[-1:], torch.float32, cuda, 1) * 0.1 + 1.0).to(dtype)
    before, before_add = rmsnorm_cuda.launches, add_rmsnorm_cuda.launches
    s, y = add_rmsnorm_cuda(x, delta, w, 1e-5)
    torch.cuda.synchronize()
    # one launch of the one kernel, counted in both counts
    assert (rmsnorm_cuda.launches, add_rmsnorm_cuda.launches) == (before + 1, before_add + 1)
    assert s.shape == y.shape == x.shape and s.dtype == y.dtype == dtype
    assert torch.equal(s, x + delta)  # the card's own add, bit for bit
    ref = rmsnorm_reference(s, w, 1e-5)
    _close(y, ref, dtype, 2.0 ** -6, 1e-6, 1e-5)
    if dtype == torch.bfloat16:
        assert _bit_share(y, ref) >= 0.99


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("shape", [(1024, 4096), (8, 4096), (3, 7, 128)])
def test_rmsnorm_kernel_gives_the_same_bits_twice(cuda, add, shape):
    x = _randn(shape, torch.bfloat16, cuda, 12)
    delta = _randn(shape, torch.bfloat16, cuda, 13)
    w = _randn(shape[-1:], torch.bfloat16, cuda, 14)
    if add:
        first, again = add_rmsnorm_cuda(x, delta, w), add_rmsnorm_cuda(x, delta, w)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    else:
        assert torch.equal(rmsnorm_cuda(x, w), rmsnorm_cuda(x, w))


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("d", [4096, 2048, 128])
def test_rmsnorm_kernel_unaligned_rows_take_the_generic_loop(cuda, add, d):
    # a view 2 bytes past a 16-byte boundary, at a width that has a
    # one-pass instance: no 16-byte loads, so the C entry takes the loop
    flat = _randn((8 * d + 1,), torch.bfloat16, cuda, 18)
    x = flat[1:].view(8, d)
    assert x.data_ptr() % 16 != 0
    w = _randn((d,), torch.bfloat16, cuda, 19)
    if add:
        delta = _randn((8, d), torch.bfloat16, cuda, 20)
        s, y = add_rmsnorm_cuda(x, delta, w)
        assert torch.equal(s, x + delta)
        ref = rmsnorm_reference(x + delta, w)
    else:
        y, ref = rmsnorm_cuda(x, w), rmsnorm_reference(x, w)
    _close(y, ref, torch.bfloat16, 2.0 ** -6, 1e-6, 1e-5)
    assert _bit_share(y, ref) >= 0.99


def test_rmsnorm_c_entry_refuses_overlapping_pointers(cuda):
    fn = kernel_function("bobra_rmsnorm", norm_ops._ARGTYPES)
    x, delta, out = (_randn((8, 4096), torch.bfloat16, cuda, i) for i in (21, 22, 23))
    s, w = torch.empty_like(x), _randn((4096,), torch.bfloat16, cuda, 24)
    stream = torch.cuda.current_stream().cuda_stream

    def call(x_, d_, s_, o_):
        return fn(x_, d_, w.data_ptr(), s_, o_, 8, 4096, 1e-5, 1, stream)

    p = {n: t.data_ptr() for n, t in (("x", x), ("delta", delta), ("s", s), ("out", out))}
    assert call(p["x"], p["delta"], p["s"], p["out"]) == 0
    assert call(p["x"], p["delta"], p["x"], p["out"]) != 0      # x as sum_out
    assert call(p["x"], p["delta"], p["s"], p["delta"]) != 0    # delta as out
    assert call(p["x"], p["delta"], p["s"], p["x"] + 2) != 0    # overlapping rows
    assert call(p["x"], None, p["s"], p["out"]) != 0            # sum_out without delta
    assert call(p["x"], None, None, p["out"]) == 0              # the plain mode
    torch.cuda.synchronize()


def test_add_rmsnorm_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 128, device=cuda)
    w = torch.ones(128, device=cuda)
    with pytest.raises(TypeError):
        add_rmsnorm_cuda(x, x.to(torch.bfloat16), w)
    with pytest.raises(ValueError, match="alias"):
        add_rmsnorm_cuda(x, x, w)
    with pytest.raises(ValueError, match="contiguous"):
        add_rmsnorm_cuda(x, torch.zeros(128, 4, device=cuda).T, w)
    with pytest.raises(ValueError, match="CUDA"):
        add_rmsnorm_cuda(x, x.cpu(), w)


def test_tiny_model_fuses_every_norm_after_a_residual_add(cuda):
    cfg = llama.llama_tiny()
    params = _to(llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    rmsnorm_cuda.launches = add_rmsnorm_cuda.launches = 0
    llama.greedy_generate(params, prompt.to(cuda), cfg, max_new_tokens=6)
    torch.cuda.synchronize()
    forwards = 1 + 6
    assert rmsnorm_cuda.launches == (2 * cfg.n_layers + 1) * forwards
    assert add_rmsnorm_cuda.launches == 2 * cfg.n_layers * forwards
