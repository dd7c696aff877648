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
of elements: only the fp32 sum order differs. The MoE kernels: dispatch
and combine bit for bit (a copy; the same roundings), the route's integer
outputs bit for bit and its gates within 2 fp32 ulps; the expert products
on the live rows in bf16 bit for bit on at least 99% of elements and none
more than 2 bf16 ulps apart (the fp32 sums run in another order than
cuBLAS's), in fp32 within 1e-5 of the rows' largest magnitude.
"""

import importlib

import pytest
import torch

from bobrapet_tpu_torch.kernels import kernel_function
from bobrapet_tpu_torch.models import llama
from bobrapet_tpu_torch.models import quant
from bobrapet_tpu_torch.ops import (
    add_rmsnorm_cuda,
    attention,
    attention_reference,
    cached_attention_cuda,
    cached_attention_reference,
    flash_attention_cuda,
    moe_combine_cuda,
    moe_combine_reference,
    moe_dispatch_cuda,
    moe_dispatch_reference,
    moe_down_cuda,
    moe_down_reference,
    moe_gate_up_cuda,
    moe_gate_up_reference,
    moe_route_cuda,
    moe_route_reference,
    paged_attention,
    paged_attention_cuda,
    paged_attention_multi,
    paged_attention_multi_cuda,
    paged_attention_multi_reference,
    paged_attention_reference,
    pick_tokens_cuda,
    pick_tokens_reference,
    quant_matmul_cuda,
    quant_matmul_reference,
    rmsnorm_cuda,
    rmsnorm_reference,
)
from bobrapet_tpu_torch.ops.moe_experts import live_rows
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine

norm_ops = importlib.import_module("bobrapet_tpu_torch.ops.rmsnorm")
pick_ops = importlib.import_module("bobrapet_tpu_torch.ops.pick_tokens")
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
    (1, 128, 256, 32, 8, 128, True, 128),   # a prefill chunk after a 128-token prefix
    (1, 128, 640, 32, 8, 128, True, 512),   # the last chunk of a 640-token prompt
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


# ---------------------------------------------------------------------------
# the speculative path's kernels: T-query paged attention, the cached entry
# above 16 packed rows, the int8 weight-only product
# ---------------------------------------------------------------------------


def _multi_inputs(case, t, dtype, cuda, seed=0):
    """``case`` of PAGED_CASES with T queries a slot: every lane's ``lens``
    (pos0 + T) is its seq_len, so query t sits at seq_len - T + t."""
    q1, k, v, tables, lens = _paged_inputs(case, dtype, cuda, seed)
    slots, hq, _, d = case[0], case[1], case[2], case[3]
    q = _randn((slots, t, hq, d), dtype, cuda, seed + 7)
    return q, k, v, tables, torch.clamp(lens, min=t)


@pytest.mark.parametrize("t", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [PAGED_CASES[0], PAGED_CASES[1], PAGED_CASES[3], PAGED_CASES[4]],
                         ids=str)
def test_paged_multi_kernel_matches_plain(cuda, dtype, case, t):
    q, k, v, tables, lens = _multi_inputs(case, t, dtype, cuda)
    before = paged_attention_multi_cuda.launches
    out = paged_attention_multi_cuda(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert paged_attention_multi_cuda.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _close(out, paged_attention_multi_reference(q, k, v, tables, lens), dtype, 2.0 ** -7, 1e-3,
           2e-4)
    assert torch.equal(paged_attention_multi(q, k, v, tables, lens), out)
    assert torch.equal(paged_attention_multi_cuda(q, k, v, tables, lens), out)  # same bits twice
    if t == 1:  # the one-query kernel, bit for bit
        assert torch.equal(out[:, 0], paged_attention_cuda(q[:, 0].contiguous(), k, v, tables,
                                                           lens))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_multi_kernel_reads_no_key_past_its_query(cuda, dtype):
    # keys past each lane's last query (pos0 + T - 1) never move the output,
    # and query t sees its own key and nothing after it
    q, k, v, tables, lens = _multi_inputs(PAGED_CASES[0], 5, dtype, cuda, seed=4)
    out = paged_attention_multi_cuda(q, k, v, tables, lens)
    k2, v2 = k.clone(), v.clone()
    block = k.shape[1]
    for s, n in enumerate(lens.tolist()):
        for pos in range(n, tables.shape[1] * block):
            blk = int(tables[s, pos // block])
            if blk:
                k2[blk, pos % block] = float("nan")
                v2[blk, pos % block] = float("nan")
    assert torch.equal(paged_attention_multi_cuda(q, k2, v2, tables, lens), out)
    # a lane whose queries sit before every key of the table but its first
    lens1 = lens.clone()
    lens1[3] = 5  # queries at 0..4
    got = paged_attention_multi_cuda(q, k, v, tables, lens1)
    _close(got, paged_attention_multi_reference(q, k, v, tables, lens1), dtype, 2.0 ** -7, 1e-3,
           2e-4)


def test_paged_multi_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, lens = _multi_inputs(PAGED_CASES[1], 2, torch.float32, cuda)
    with pytest.raises(TypeError):
        paged_attention_multi_cuda(q, k, v, tables, lens.long())
    with pytest.raises(ValueError, match="bad shapes"):
        paged_attention_multi_cuda(q[:, 0], k, v, tables, lens)
    with pytest.raises(ValueError):
        paged_attention_multi_cuda(q, k, v, tables.cpu(), lens)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    # b, sq, cap, hq, hkv, d, lens; packed rows = sq * hq / hkv
    (1, 5, 96, 32, 8, 128, (69,)),                   # the standalone verify: 20 rows
    (2, 8, 192, 32, 8, 128, (100, 192)),             # 32 rows: two tiles
    (3, 5, 64, 8, 2, 32, (5, 33, 64)),               # 20 rows, llama_tiny widths
    (2, 3, 2048, 32, 8, 128, (7, 2048)),             # 12 rows over a long cache
], ids=str)
def test_cached_kernel_above_sixteen_rows_matches_plain(cuda, dtype, case):
    b, sq, cap, hq, hkv, d, lens = case
    q = _randn((b, sq, hq, d), dtype, cuda, 21)
    k = _randn((b, cap, hkv, d), dtype, cuda, 22)
    v = _randn((b, cap, hkv, d), dtype, cuda, 23)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = cached_attention_cuda.launches
    out = cached_attention_cuda(q, k, v, n)
    torch.cuda.synchronize()
    assert cached_attention_cuda.launches == before + 1
    _close(out, cached_attention_reference(q, k, v, n), dtype, 2.0 ** -7, 1e-3, 2e-4)
    assert torch.equal(cached_attention_cuda(q, k, v, n), out)


#: (K, N) of every int8 product of a Llama-3-8B forward: wq and wo, wk and
#: wv, w_gate and w_up, w_down, lm_head
QUANT_SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


def _quant_close(out, ref, dtype):
    """bf16: the product is rounded to bf16, then scaled and rounded again,
    so a sum in another order may move it by one ulp before the scale: 2^-6
    of |plain|, plus 1e-4 of the largest |plain| for fp32 sums of opposite
    terms that nearly cancel. fp32: 1e-5 of the largest |plain| (TF32, with
    10 mantissa bits, would miss by ~1e-3)."""
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    big = float(ref.abs().max())
    if dtype == torch.bfloat16:
        bound = 1e-4 * big + 2.0 ** -6 * ref.abs()
    else:
        bound = torch.full_like(ref, 1e-5 * big)
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())


@pytest.mark.parametrize("m", [8, 40, 64, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kn", QUANT_SHAPES_8B, ids=str)
def test_quant_matmul_kernel_matches_plain(cuda, dtype, kn, m):
    k, n = kn
    leaf = quant.quantize_array(_randn((k, n), dtype, cuda, 31) * (1.0 / 64))
    x = _randn((m, k), dtype, cuda, 32)
    before = quant_matmul_cuda.launches
    out = quant_matmul_cuda(x, leaf["q"], leaf["scale"])
    torch.cuda.synchronize()
    assert quant_matmul_cuda.launches == before + 1
    assert out.shape == (m, n) and out.dtype == dtype
    _quant_close(out, quant_matmul_reference(x, leaf["q"], leaf["scale"]), dtype)
    assert torch.equal(quant_matmul_cuda(x, leaf["q"], leaf["scale"]), out)  # same bits twice
    assert torch.equal(quant.matmul(x, leaf), out)  # the model's hook takes the kernel


@pytest.mark.parametrize("shape", [(3, 5, 128), (2, 1, 64), (7, 48)])
def test_quant_matmul_kernel_ragged_rows_and_narrow_widths(cuda, shape):
    # batch dims are folded into the rows; M, K and N off the tiles' sizes
    k, n = shape[-1], 80
    leaf = quant.quantize_array(_randn((k, n), torch.bfloat16, cuda, 33))
    x = _randn(shape, torch.bfloat16, cuda, 34)
    out = quant_matmul_cuda(x, leaf["q"], leaf["scale"])
    assert out.shape == (*shape[:-1], n)
    _quant_close(out, quant_matmul_reference(x, leaf["q"], leaf["scale"]), torch.bfloat16)


def test_quant_matmul_refuses_what_it_does_not_take(cuda):
    leaf = quant.quantize_array(_randn((64, 64), torch.bfloat16, cuda, 35))
    x = _randn((4, 64), torch.bfloat16, cuda, 36)
    with pytest.raises(TypeError):
        quant_matmul_cuda(x.float(), leaf["q"], leaf["scale"])  # the scale is bf16
    with pytest.raises(TypeError):
        quant_matmul_cuda(x, leaf["q"].to(torch.int16), leaf["scale"])
    with pytest.raises(ValueError, match="multiples of 16"):
        quant_matmul_cuda(x[:, :40].contiguous(), leaf["q"][:40], leaf["scale"])
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul_cuda(_randn((64, 4), torch.bfloat16, cuda, 37).T, leaf["q"], leaf["scale"])
    with pytest.raises(ValueError):
        quant_matmul_cuda(x, leaf["q"].cpu(), leaf["scale"])


@pytest.mark.parametrize("horizon", [1, 4])
def test_tiny_spec_engine_on_the_card_matches_the_cpu(cuda, horizon):
    """A draft engine (the target's own int8 tree as the draft: the fp32
    int8 kernel, the T-query paged kernel) gives the CPU's tokens and the
    draft-less engine's, every verify through the T-query entry."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = PagedConfig(max_slots=3, block_size=8, num_blocks=40, max_blocks_per_seq=6,
                       prefix_caching=False)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 12, 9)]
    outs = {}
    for name, tree in (("cpu", params), ("card", _to(params, cuda))):
        for spec in (False, True):
            kw = dict(draft_params=quant.quantize_params(tree), draft_cfg=cfg, spec_k=3,
                      spec_guard=False) if spec else {}
            eng = ServingEngine(tree, cfg, pcfg, decode_horizon=horizon, dispatch_depth=1, **kw)
            for p in prompts:
                eng.submit(p, 14)
            paged_attention_multi_cuda.launches = quant_matmul_cuda.launches = 0
            eng.run()
            outs[name, spec] = {r.rid: r.output for r in eng.finished}
            pc = eng.phase_counts
            verifies = pc["spec_rounds"] + pc["spec_ticks"]
            if name == "card" and spec:
                assert eng.spec_drafted > 0 and verifies > 0
                assert paged_attention_multi_cuda.launches == cfg.n_layers * (
                    verifies + pc["draft_syncs"])
                drafts = (pc["draft_prefills"] + verifies * 4 + pc["draft_syncs"]
                          + pc["draft_appends"])
                assert quant_matmul_cuda.launches == drafts * (7 * cfg.n_layers + 1)
    assert outs["card", True] == outs["card", False] == outs["cpu", True] == outs["cpu", False]


# ---------------------------------------------------------------------------
# the token pick (csrc/pick_tokens.cu). Greedy rows: bit for bit (the same
# comparisons in the same type). Sampled rows: the noise goes through logf
# and log1pf on the card and the CPU's or the card's log in the plain
# version, an ulp apart at most, so a row may pick another token where the
# plain version's top two scores lie within 1e-5 * max(1, |top|); every
# other row agrees, and at least 99.9% of rows agree.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,v", [(8, 128256), (40, 128256), (1, 128256), (8, 512),
                                    (3, 1001), (5, 8193), (2, 3)])
def test_pick_tokens_greedy_rows_bit_for_bit(cuda, rows, v, dtype):
    logits = _randn((rows, v), dtype, cuda, 60 + v % 97)
    logits[0, v // 2] = logits[0, v - 1] = logits[0].max() + 1   # a tie: the lower wins
    if rows > 2:
        logits[1] = 0.0                                          # a flat row: index 0
        logits[2, v // 3] = float("nan")                         # a NaN wins
    want = pick_tokens_reference(logits)
    zero = torch.zeros(rows, device=cuda)
    ids = torch.arange(rows, dtype=torch.int32, device=cuda)
    before = pick_tokens_cuda.launches
    for keyed in ((), (zero, ids, ids)):
        got = pick_tokens_cuda(logits, *keyed)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert pick_tokens_cuda.launches == before + 2
    assert int(want[0]) == v // 2
    if rows > 2:
        assert int(want[1]) == 0 and int(want[2]) == v // 3


def _sampled_scores(logits, temps, rids, index):
    """The plain version's scores of sampled rows: logits / T + noise."""
    return logits.float() / temps[:, None] + pick_ops.gumbel_noise(rids, index, logits.shape[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pick_tokens_sampled_rows_agree_up_to_near_ties(cuda, dtype):
    rows, v, chunk = 4096, 128256, 256
    temps_cycle = torch.tensor([0.7, 1.0, 1.3, 0.4], device=cuda)
    agree = 0
    for c0 in range(0, rows, chunk):
        logits = _randn((chunk, v), dtype, cuda, 700 + c0) * 3
        temps = temps_cycle.repeat(chunk // 4)
        rids = torch.arange(c0, c0 + chunk, dtype=torch.int32, device=cuda) * 7919
        index = torch.arange(chunk, dtype=torch.int32, device=cuda) % 97
        got = pick_tokens_cuda(logits, temps, rids, index)
        want = pick_tokens_reference(logits, temps, rids, index)
        scores = _sampled_scores(logits, temps, rids, index)
        top = scores.topk(2, dim=-1).values
        near = (top[:, 0] - top[:, 1]) <= 1e-5 * top[:, 0].abs().clamp(min=1.0)
        same = got == want
        assert bool((same | near).all())
        agree += int(same.sum())
        # the kernel's token scores the plain version's best up to a near tie
        picked = scores.gather(1, got.long()[:, None])[:, 0]
        assert bool(((top[:, 0] - picked) <= 1e-5 * top[:, 0].abs().clamp(min=1.0)).all())
    assert agree >= 0.999 * rows


def test_pick_tokens_kernel_draws_follow_softmax(cuda):
    n, temp = 20_000, 0.7
    row = torch.randn(16, generator=torch.Generator().manual_seed(2)) * 1.5
    logits = row.to(cuda).repeat(n, 1)
    draws = pick_tokens_cuda(logits, torch.full((n,), temp, device=cuda),
                             torch.full((n,), 7, dtype=torch.int32, device=cuda),
                             torch.arange(n, dtype=torch.int32, device=cuda))
    counts = torch.bincount(draws.long(), minlength=16).cpu().double()
    p = torch.softmax(row.double() / temp, dim=0)
    assert float(((counts - n * p) ** 2 / (n * p)).sum()) < 37.697   # p = 0.001, 15 dof


def test_pick_tokens_refuses_what_it_does_not_take(cuda):
    logits = torch.zeros(4, 64, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pick_tokens_cuda(logits[:, ::2])
    with pytest.raises(ValueError, match="temps must be"):
        pick_tokens_cuda(logits, torch.zeros(4, dtype=torch.float64, device=cuda), ids, ids)
    with pytest.raises(ValueError, match="rids must be contiguous"):
        pick_tokens_cuda(logits, torch.zeros(4, device=cuda), ids.cpu(), ids)


# the redesigned pick: a row over several clusters (csrc/pick_tokens.cu,
# ops.pick_tokens.pick_chunks), combined through the last cluster's ticket


def _hold_pick(logits, temps, rids, index, got):
    """Greedy rows (temps <= 0) bit for bit; a sampled row agrees, or the
    plain version's top two lie within 1e-5 * max(1, |top|) and the kernel's
    token scores that close to the best."""
    want = pick_tokens_reference(logits, temps, rids, index)
    greedy = temps <= 0
    assert torch.equal(got[greedy], want[greedy])
    s_rows = (~greedy).nonzero()[:, 0]
    if len(s_rows):
        t = temps[s_rows].clamp_min(pick_ops.TEMP_FLOOR)
        scores = _sampled_scores(logits[s_rows], t, rids[s_rows], index[s_rows])
        top = scores.topk(min(2, logits.shape[1]), dim=-1).values
        allowed = 1e-5 * top[:, 0].abs().clamp(min=1.0)
        picked = scores.gather(1, got[s_rows].long()[:, None])[:, 0]
        assert bool(((top[:, 0] - picked) <= allowed).all())


def _keys(rows, device, every=4, temp=0.9):
    """Every ``every``-th row sampled at ``temp``, the rest greedy."""
    temps = torch.where(torch.arange(rows, device=device) % every == 0, temp, 0.0)
    rids = torch.arange(rows, dtype=torch.int32, device=device) * 31 + 3
    index = torch.arange(rows, dtype=torch.int32, device=device) % 13
    return temps.float(), rids, index


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("v", [1, 3, 5, 4097, 128256])
@pytest.mark.parametrize("rows", [1, 8, 40, 1024])
def test_pick_tokens_over_every_cluster_count(cuda, rows, v, aligned):
    dtype = torch.float32 if (rows + v) % 2 else torch.bfloat16
    flat = _randn((rows * v + 1,), dtype, cuda, rows * 7 + v) * 3
    logits = (flat[:rows * v] if aligned else flat[1:]).view(rows, v)
    assert (logits.data_ptr() % 16 == 0) == aligned
    temps, rids, index = _keys(rows, cuda)
    before = pick_tokens_cuda.launches
    greedy = pick_tokens_cuda(logits)
    got = pick_tokens_cuda(logits, temps, rids, index)
    torch.cuda.synchronize()
    assert pick_tokens_cuda.launches == before + 2
    assert torch.equal(greedy, pick_tokens_reference(logits))
    _hold_pick(logits, temps, rids, index, got)
    # the same bits again, whatever order the clusters end in
    for _ in range(3):
        assert torch.equal(pick_tokens_cuda(logits, temps, rids, index), got)


@pytest.mark.parametrize("rows", [1, 8])
def test_pick_tokens_equal_maxima_in_two_clusters_take_the_lower_index(cuda, rows):
    v = 128256
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = pick_ops.pick_chunks(rows, v, sms)
    assert chunks > 1
    parts = pick_ops.pick_splits(v) * chunks
    per_cluster = 4 * pick_ops.pick_splits(v) * -(-(-(-v // 4)) // parts)   # its logits
    logits = _randn((rows, v), torch.float32, cuda, 90 + rows)
    lo, hi = 37, (chunks - 1) * per_cluster + 11   # the first and the last cluster
    assert hi < v - 5
    logits[:, hi] = logits[:, lo] = 100.0
    assert pick_tokens_cuda(logits).tolist() == [lo] * rows
    # two NaNs: the first wins; one NaN in the last cluster beats any score
    nan = logits.clone()
    nan[:, v - 3] = float("nan")
    assert pick_tokens_cuda(nan).tolist() == [v - 3] * rows
    nan[:, hi - 5] = float("nan")
    assert pick_tokens_cuda(nan).tolist() == [hi - 5] * rows
    temps = torch.full((rows,), 0.7, device=cuda)
    ids = torch.arange(rows, dtype=torch.int32, device=cuda)
    assert pick_tokens_cuda(nan, temps, ids, ids).tolist() == [hi - 5] * rows


def test_pick_tokens_floors_a_subnormal_temperature(cuda):
    logits = (torch.randn(4, 128256, generator=torch.Generator().manual_seed(0)) * 3).to(cuda)
    rids = torch.arange(4, dtype=torch.int32, device=cuda) * 7 + 1
    index = torch.arange(4, dtype=torch.int32, device=cuda)
    for temp in (1e-39, 1e-37, 1e-6):
        got = pick_tokens_cuda(logits, torch.full((4,), temp, device=cuda), rids, index)
        assert got.tolist() == [36885, 62653, 15810, 102285]


@pytest.mark.parametrize("pdl", [True, False])
def test_pick_tokens_graph_replays_reset_the_ticket(cuda, pdl):
    """100 replays of one captured pick of a row split over several
    clusters: each replay writes its own tokens (the static output is
    cleared before, the logits alternate), so a ticket left behind shows."""
    rows, v = 8, 128256
    a = _randn((rows, v), torch.float32, cuda, 5)
    b = _randn((rows, v), torch.float32, cuda, 6)
    temps, rids, index = _keys(rows, cuda, every=2)
    logits = a.clone()
    assert not torch.equal(pick_tokens_reference(a, temps, rids, index),
                           pick_tokens_reference(b, temps, rids, index))
    old = pick_tokens_cuda.pdl
    pick_tokens_cuda.pdl = pdl
    try:
        pick_tokens_cuda(logits, temps, rids, index)   # built and loaded outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = pick_tokens_cuda(logits, temps, rids, index)
        first = {}
        for n in range(100):
            logits.copy_(a if n % 2 == 0 else b)
            out.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            if n < 2:
                _hold_pick(logits, temps, rids, index, out)
                first[n] = out.clone()
            assert torch.equal(out, first[n % 2])
    finally:
        pick_tokens_cuda.pdl = old


def test_greedy_and_speculative_loops_pick_every_token_on_the_card(cuda):
    from bobrapet_tpu_torch.models import speculative_generate

    cfg = llama.llama_tiny()
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = _to(params_cpu, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), generator=torch.Generator().manual_seed(1))
    for graph in (False, True):
        pick_tokens_cuda.launches = 0
        out = llama.greedy_generate(params, prompt.to(cuda), cfg, max_new_tokens=7,
                                    cuda_graph=graph)
        torch.cuda.synchronize()
        assert pick_tokens_cuda.launches == 1 + 7
        assert torch.equal(out.cpu(), llama.greedy_generate(params_cpu, prompt, cfg,
                                                            max_new_tokens=7))
    k = 3
    pick_tokens_cuda.launches = 0
    res = speculative_generate(params, params, prompt[:1].to(cuda), cfg, cfg, max_new_tokens=10,
                               k=k)
    torch.cuda.synchronize()
    assert pick_tokens_cuda.launches == 1 + res.rounds * (k + 2)
    want = speculative_generate(params_cpu, params_cpu, prompt[:1], cfg, cfg, max_new_tokens=10,
                                k=k)
    assert res.tokens.cpu().tolist() == want.tokens.tolist()


# ---------------------------------------------------------------------------
# sparse MoE: route, dispatch, combine (csrc/moe_dispatch.cu)
# ---------------------------------------------------------------------------


def _router_logits(t, e, dtype, device, seed, ties=False):
    x = _randn((t, e), torch.float32, device, seed)
    if ties:
        # coarse values, the top two of every third row equal, every fifth
        # row all equal: equal probabilities go to the lower expert index
        x = torch.round(x * 4) / 4
        x[::3, 1] = x[::3, 2] = x[::3].max(dim=1).values + 0.25
        x[1::5] = x[1::5, :1]
    return x.to(dtype).contiguous()


MOE_ROUTE_CASES = [(8, 8, 2, 16), (64, 8, 2, 128), (1024, 8, 2, 2048), (300, 8, 2, 40),
                   (33, 4, 2, 17), (5, 4, 1, 2), (40, 16, 4, 20)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,e,k,c", MOE_ROUTE_CASES)
def test_moe_route_kernel_matches_plain(cuda, dtype, ties, t, e, k, c):
    """Experts, slots, src and counts bit for bit; gates within 2 fp32 ulps
    (the two exp implementations), exact where a row's chosen experts tie;
    the probability sums within 1e-5 (another sum order)."""
    logits = _router_logits(t, e, dtype, cuda, t + e, ties)
    moe_route_cuda.launches = 0
    got = moe_route_cuda(logits, k, c)
    torch.cuda.synchronize()
    assert moe_route_cuda.launches == 1
    want = moe_route_reference(logits, k, c)
    for name, a, b in zip(("expert", "slot", "gate", "src", "counts", "probsum"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
    expert, slot, gate, src, counts, probsum = got
    for a, b in ((expert, want[0]), (slot, want[1]), (src, want[3]), (counts, want[4])):
        assert torch.equal(a, b)
    torch.testing.assert_close(gate, want[2], rtol=2.0 ** -22, atol=0)
    torch.testing.assert_close(probsum, want[5], rtol=1e-5, atol=1e-6)
    if ties:
        tied = torch.zeros(t, dtype=torch.bool, device=cuda)
        tied[::3] = True
        tied[1::5] = True
        assert torch.equal(gate[tied], want[2][tied])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,c,offset", [(8, 4096, 16, 0), (64, 4096, 128, 0),
                                          (1024, 4096, 2048, 0), (20, 100, 7, 0),
                                          (16, 4096, 32, 1)])
def test_moe_dispatch_kernel_matches_plain(cuda, dtype, t, d, c, offset):
    """A copy: bit for bit, empty slots zero, on the 16-byte path and on the
    element path (an odd width, a row start off 16 bytes)."""
    logits = _router_logits(t, 8, dtype, cuda, t + d)
    _, _, _, src, _, _ = moe_route_reference(logits, 2, c)
    base = _randn((t * d + offset,), dtype, cuda, 3)
    h = base[offset:].view(t, d)
    out = moe_dispatch_cuda(h, src)
    torch.cuda.synchronize()
    assert torch.equal(out, moe_dispatch_reference(h, src))
    assert (out[src < 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,c", [(8, 4096, 16), (64, 4096, 128), (1024, 4096, 2048),
                                   (24, 4096, 5), (9, 100, 18)])
def test_moe_combine_kernel_matches_plain(cuda, dtype, t, d, c):
    """Each product and add rounded on its own on both sides: bit for bit,
    a (t, k) past its expert's capacity (c = 5) skipped."""
    logits = _router_logits(t, 8, dtype, cuda, t + c)
    expert, slot, gate, _, _, _ = moe_route_reference(logits, 2, c)
    out_e = _randn((8, c, d), dtype, cuda, 4)
    got = moe_combine_cuda(out_e, expert, slot, gate)
    torch.cuda.synchronize()
    assert torch.equal(got, moe_combine_reference(out_e, expert, slot, gate))


def test_moe_kernels_refuse_what_they_do_not_take(cuda):
    logits = _router_logits(8, 8, torch.float32, cuda, 0)
    expert, slot, gate, src, _, _ = moe_route_cuda(logits, 2, 16)
    with pytest.raises(ValueError):
        moe_route_cuda(logits.cpu(), 2, 16)
    with pytest.raises(TypeError):
        moe_route_cuda(logits.half(), 2, 16)
    with pytest.raises(ValueError):
        moe_route_cuda(_router_logits(8, 64, torch.float32, cuda, 0), 2, 16)
    with pytest.raises(ValueError):
        moe_route_cuda(logits, 9, 16)
    h = _randn((8, 64), torch.float32, cuda, 1)
    with pytest.raises(ValueError):
        moe_dispatch_cuda(h, src.long())
    with pytest.raises(ValueError):
        moe_dispatch_cuda(h.t(), src)
    out_e = moe_dispatch_cuda(h, src)
    with pytest.raises(ValueError):
        moe_combine_cuda(out_e, expert, slot, gate.double())
    with pytest.raises(ValueError):
        moe_combine_cuda(out_e, expert.cpu(), slot, gate)


def test_tiny_moe_on_the_card_matches_the_cpu(cuda):
    """moe_tiny in fp32: greedy_generate eager and graphed and the engine at
    H = 1 and 8, card = CPU token for token, one route, dispatch and
    combine a layer a forward."""
    import dataclasses

    from bobrapet_tpu_torch.models import moe

    cfg = dataclasses.replace(moe.moe_tiny(), capacity_factor=4.0)
    params_cpu = moe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = _to(params_cpu, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), generator=torch.Generator().manual_seed(1))
    want = moe.greedy_generate(params_cpu, prompt, cfg, max_new_tokens=7)
    counted = (moe_route_cuda, moe_gate_up_cuda, moe_down_cuda, moe_combine_cuda)
    for graph in (False, True):
        for fn in counted + (moe_dispatch_cuda,):
            fn.launches = 0
        out = moe.greedy_generate(params, prompt.to(cuda), cfg, max_new_tokens=7,
                                  cuda_graph=graph)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)
        for fn in counted:
            assert fn.launches == (1 + 7) * cfg.n_layers
        assert moe_dispatch_cuda.launches == 0  # the gate/up product gathers its rows
    pcfg = PagedConfig(max_slots=3, block_size=8, num_blocks=24, max_blocks_per_seq=4)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 12, 9)]
    outs = []
    for tree in (params_cpu, params):
        for h in (1, 8):
            eng = ServingEngine(tree, cfg, pcfg, decode_horizon=h, dispatch_depth=1)
            moe_route_cuda.launches = 0
            for p in prompts:
                eng.submit(p, 10)
            eng.run()
            if tree is params:
                pc = eng.phase_counts
                assert moe_route_cuda.launches == (pc["prefills"] + pc["device_steps"]) * 2
            outs.append({r.rid: r.output for r in eng.finished})
    assert all(o == outs[0] for o in outs)


# ---------------------------------------------------------------------------
# sparse MoE: the expert products over the live rows (csrc/moe_experts.cu)
# ---------------------------------------------------------------------------

#: widths off the wide route's 128 (gate/up) and 256 (down) column tiles
EXPERT_D, EXPERT_F = 320, 448


def _bf16_ulps(a, b):
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -32768 - bits, bits)
    return (ordered(a) - ordered(b)).abs()


def _expert_close(got, want, live, dtype):
    g, w = got[live], want[live]
    assert torch.isfinite(g.float()).all()
    if dtype == torch.bfloat16:
        ulps = _bf16_ulps(g, w)
        assert float((ulps == 0).float().mean()) >= 0.99 and int(ulps.max()) <= 2
    else:
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def _expert_weights(e, d, f, dtype, device, seed):
    return (_randn((e, d, f), dtype, device, seed) * d ** -0.5,
            _randn((e, d, f), dtype, device, seed + 1) * d ** -0.5,
            _randn((e, f, d), dtype, device, seed + 2) * f ** -0.5)


def _expert_route(t, e, c, case, device, seed):
    logits = _router_logits(t, e, torch.float32, device, seed, ties=case == "ties")
    if case == "empty":
        logits[:, 0] = -30.0  # expert 0: no token
    elif case == "droppy":
        logits[:, 1] = 30.0   # expert 1: every token, past the capacity
    return moe_route_reference(logits.to(torch.bfloat16), 2, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,c,case", [(8, 16, "random"), (4, 8, "random"), (8, 16, "empty"),
                                      (8, 6, "droppy"), (64, 128, "ties"),
                                      (64, 40, "droppy"), (1024, 2048, "random"),
                                      (300, 600, "empty")])
def test_moe_expert_kernels_match_plain(cuda, dtype, t, c, case):
    """gate/up then down against their plain versions on the live rows, at
    the narrow route (C <= 16, one 16-row instance) and the wide route's
    tiles; an empty expert, tied logits, a droppy capacity (counts past C),
    n_e off every tile; rows past n_e are never written. The down product's
    grid bounded by the route's T gives the bits of one bounded by C."""
    e = 8
    _, _, _, src, counts, _ = _expert_route(t, e, c, case, cuda, t + c)
    w_gate, w_up, w_down = _expert_weights(e, EXPERT_D, EXPERT_F, dtype, cuda, 5)
    h = _randn((t, EXPERT_D), dtype, cuda, 9)
    live = live_rows(counts, c)
    if case == "empty":
        assert counts[0] == 0
    if case == "droppy":
        assert (counts > c).any()
    moe_gate_up_cuda.launches = moe_down_cuda.launches = 0
    act = moe_gate_up_cuda(h, src, counts, w_gate, w_up)
    out_k = moe_down_cuda(act, counts, w_down, t)
    torch.cuda.synchronize()
    assert moe_gate_up_cuda.launches == moe_down_cuda.launches == 1
    _expert_close(act, moe_gate_up_reference(h, src, counts, w_gate, w_up), live, dtype)
    _expert_close(out_k, moe_down_reference(act, counts, w_down), live, dtype)
    # no row past n_e is written: a down product over a marked buffer
    marked = act.clone()
    marked[~live] = float("nan")
    out = moe_down_cuda(marked, counts, w_down)
    torch.cuda.synchronize()
    assert torch.isfinite(out[live].float()).all()
    assert torch.equal(out[live], out_k[live])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_expert_kernels_give_the_same_bits_every_run(cuda, dtype):
    """Thirty runs of gate/up then down back to back, each launch overlapping
    the one before (programmatic dependent launch): the same bits every run,
    so no ring slot is read before it lands or written while read."""
    t, c, e = 64, 128, 8
    _, _, _, src, counts, _ = _expert_route(t, e, c, "random", cuda, 3)
    w_gate, w_up, w_down = _expert_weights(e, EXPERT_D, EXPERT_F, dtype, cuda, 6)
    h = _randn((t, EXPERT_D), dtype, cuda, 10)
    live = live_rows(counts, c)
    outs = [moe_down_cuda(moe_gate_up_cuda(h, src, counts, w_gate, w_up), counts, w_down)[live]
            for _ in range(30)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_moe_expert_graph_replays_follow_the_counts(cuda):
    """One CUDA graph of route, gate/up, down and combine replayed over
    routes with other counts (an expert emptied, one filled): every replay
    equals the eager kernels on its own route, so no tile is skipped or run
    on a stale count."""
    dtype, t, e = torch.bfloat16, 8, 8
    c = 2 * t
    w_gate, w_up, w_down = _expert_weights(e, EXPERT_D, EXPERT_F, dtype, cuda, 7)
    logits = torch.zeros((t, e), dtype=dtype, device=cuda)
    h = torch.zeros((t, EXPERT_D), dtype=dtype, device=cuda)

    def step():
        expert, slot, gate, src, counts, _ = moe_route_cuda(logits, 2, c)
        act = moe_gate_up_cuda(h, src, counts, w_gate, w_up)
        return moe_combine_cuda(moe_down_cuda(act, counts, w_down), expert, slot, gate)

    logits.copy_(_router_logits(t, e, dtype, cuda, 1))
    h.copy_(_randn((t, EXPERT_D), dtype, cuda, 2))
    step()  # build, set attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = step()
    for i in range(6):
        x = _router_logits(t, e, torch.float32, cuda, 10 + i)
        if i % 3 == 1:
            x[:, 2] = -30.0  # expert 2 empty
        elif i % 3 == 2:
            x[:, 5] = 30.0   # expert 5 takes every token
        logits.copy_(x.to(dtype))
        h.copy_(_randn((t, EXPERT_D), dtype, cuda, 20 + i))
        graph.replay()
        want = step()
        torch.cuda.synchronize()
        assert torch.equal(y, want)


@pytest.mark.parametrize("t,e,k,c,d", [(8, 16, 8, 64, 4096), (8, 16, 8, 20, 4096),
                                       (7, 8, 3, 9, 100), (1000, 8, 2, 2000, 4096)])
def test_moe_combine_redesign_holds_every_top_k(cuda, t, e, k, c, d):
    """The combine's column chunks and its loads issued before its sums:
    bit for bit the plain version up to k = 8, with drops, on the 16-byte
    and the element path."""
    logits = _router_logits(t, e, torch.float32, cuda, t + k)
    expert, slot, gate, _, _, _ = moe_route_reference(logits, k, c)
    out_e = _randn((e, c, d), torch.bfloat16, cuda, 11)
    got = moe_combine_cuda(out_e, expert, slot, gate)
    torch.cuda.synchronize()
    assert torch.equal(got, moe_combine_reference(out_e, expert, slot, gate))


def test_moe_expert_entries_refuse_what_they_do_not_take(cuda):
    import ctypes

    from bobrapet_tpu_torch.ops import moe_experts as mx

    e, t, c = 4, 8, 32
    _, _, _, src, counts, _ = _expert_route(t, e, c, "random", cuda, 4)
    w_gate, w_up, w_down = _expert_weights(e, 64, 128, torch.bfloat16, cuda, 8)
    h = _randn((t, 64), torch.bfloat16, cuda, 12)
    act = torch.empty((e, c, 128), dtype=torch.bfloat16, device=cuda)
    fn = kernel_function("bobra_moe_gate_up", mx._GATE_UP_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    args = [h.data_ptr(), src.data_ptr(), counts.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), act.data_ptr()]
    # no token, an unknown type, a bf16 width off 64
    for sizes in ((0, e, c, 64, 128, 1), (t, e, c, 64, 128, 7), (t, e, c, 48, 128, 1)):
        assert fn(*args, *sizes, ctypes.c_void_p(stream)) != 0
    assert fn(*args, t, e, c, 64, 128, 1, ctypes.c_void_p(stream)) == 0
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        moe_gate_up_cuda(h[:, :48].contiguous(), src, counts, w_gate[:, :48].contiguous(),
                         w_up[:, :48].contiguous())
    with pytest.raises(ValueError):
        moe_down_cuda(act, counts.cpu(), w_down)
    with pytest.raises(TypeError):
        moe_gate_up_cuda(h, src, counts, w_gate.float(), w_up)


# ---------------------------------------------------------------------------
# training: the log-sum-exp forward, the attention and RMSNorm backwards
#
# Tolerances. fp32 (scalar kernels): 2e-4 of |plain| plus 2e-4, the
# forward's. bf16: the plain versions compute in fp32 from the same bf16
# inputs; the kernels feed P and dS to the tensor cores as two bf16 parts
# (~16 bits) and sum in another order, then round once: one bf16 ulp of
# |plain| (2^-7) plus 1e-2 (the gradients here are of order 1-10, so 1e-2
# is a fraction of an ulp of the large ones and covers the small ones'
# cancellations). The norm backward: two bf16 ulps plus 1e-3, of |plain|
# and in the add mode also of the norm's own gradient (it rounds that,
# adds ds and rounds again, so an ulp of the first outlives a
# cancellation); fp32 1e-5 of |plain| plus 1e-5 of the largest value (the
# weight gradient sums every row in another order).

TRAIN_FLASH_CASES = [
    # (b, sq, hq, hkv, d): causal, sq = sk, q_offset 0
    (8, 512, 32, 8, 128),   # the train step's shape
    (2, 100, 32, 8, 128),   # ragged, group 4
    (1, 130, 4, 4, 32),     # ragged, group 1, narrow heads
    (2, 77, 8, 8, 128),     # group 1
    (1, 1, 4, 1, 32),       # one token
]


def _train_inputs(case, dtype, device):
    b, sq, hq, hkv, d = case
    q = _randn((b, sq, hq, d), dtype, device, 31)
    k = _randn((b, sq, hkv, d), dtype, device, 32)
    v = _randn((b, sq, hkv, d), dtype, device, 33)
    do = _randn((b, sq, hq, d), dtype, device, 34)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", TRAIN_FLASH_CASES, ids=str)
def test_flash_lse_kernel_matches_plain(cuda, dtype, case):
    from bobrapet_tpu_torch.ops import flash_attention_lse_cuda, flash_attention_lse_reference

    q, k, v, _ = _train_inputs(case, dtype, cuda)
    before = (flash_attention_lse_cuda.launches, flash_attention_cuda.launches)
    out, lse = flash_attention_lse_cuda(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention_lse_cuda.launches, flash_attention_cuda.launches) == (
        before[0] + 1, before[1])
    ref, ref_lse = flash_attention_lse_reference(q, k, v)
    _close(out, ref, dtype, 2.0 ** -7, 1e-3, 2e-4)
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    if dtype == torch.bfloat16:
        # the serving entry's kernels on the same inputs: within the forward's
        # bf16 tolerance of them too (another kernel, another summing order)
        _close(out, flash_attention_cuda(q, k, v), dtype, 2.0 ** -7, 1e-3, 2e-4)


@pytest.mark.parametrize("case", TRAIN_FLASH_CASES, ids=str)
def test_flash_lse_kernel_gives_the_same_bits_twice(cuda, case):
    from bobrapet_tpu_torch.ops import flash_attention_lse_cuda

    q, k, v, _ = _train_inputs(case, torch.bfloat16, cuda)
    first = flash_attention_lse_cuda(q, k, v)
    # another allocation of the outputs between the runs
    pad = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
    again = flash_attention_lse_cuda(q, k, v)
    torch.cuda.synchronize()
    del pad
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# chip_smoke.py's TRAIN_BWD_CASES: (name, b, sq, sk, hq, hkv, d, causal, q_offset)
TRAIN_BWD_CASES = [
    ("ragged group 8", 2, 100, 100, 64, 8, 128, True, 0),
    ("S 77 group 4", 2, 77, 77, 32, 8, 128, True, 0),
    ("S 77 group 8", 2, 77, 77, 64, 8, 128, True, 0),
    ("q_offset 64 Sk 164", 2, 100, 164, 32, 8, 128, True, 64),
    ("Sk 200 no mask", 1, 128, 200, 32, 8, 128, False, 0),
    ("head dim 32", 2, 100, 100, 8, 2, 32, True, 0),
    ("group 8 train width", 4, 512, 512, 64, 8, 128, True, 0),
]


@pytest.mark.parametrize("case", TRAIN_BWD_CASES, ids=[c[0] for c in TRAIN_BWD_CASES])
def test_flash_lse_kernel_feeds_the_backward(cuda, case):
    """The log-sum-exp forward at phase 10b's backward cases: its output
    and lse against the plain version, and the backward fed with them
    within phase 10b's TRAIN_TOL (1e-2 + 2^-7 |plain|)."""
    from bobrapet_tpu_torch.ops import (
        flash_attention_backward_cuda,
        flash_attention_backward_reference,
        flash_attention_lse_cuda,
        flash_attention_lse_reference,
    )

    _, b, sq, sk, hq, hkv, d, causal, q_offset = case
    dt = torch.bfloat16
    q, do = _randn((b, sq, hq, d), dt, cuda, 51), _randn((b, sq, hq, d), dt, cuda, 52)
    k, v = _randn((b, sk, hkv, d), dt, cuda, 53), _randn((b, sk, hkv, d), dt, cuda, 54)
    kw = {"causal": causal, "q_offset": q_offset}
    out, lse = flash_attention_lse_cuda(q, k, v, **kw)
    ref, ref_lse = flash_attention_lse_reference(q, k, v, **kw)
    _close(out, ref, dt, 2.0 ** -7, 1e-3, 2e-4)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    got = flash_attention_backward_cuda(q, k, v, out, do, lse, **kw)
    want = flash_attention_backward_reference(q, k, v, out, do, lse, **kw)
    for g, w in zip(got, want):
        _close(g, w, dt, 2.0 ** -7, 1e-2, 2e-4)


def test_flash_lse_kernel_refuses_a_group_above_64(cuda):
    from bobrapet_tpu_torch.ops import flash_attention_lse_cuda

    attn_ops = importlib.import_module("bobrapet_tpu_torch.ops.attention")
    q = torch.zeros((1, 4, 65, 32), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 4, 1, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="group of 65 heads is above 64"):
        flash_attention_lse_cuda(q, k, k)
    # the C entry refuses it too
    o = torch.empty_like(q)
    lse = torch.empty((1, 65, 4), dtype=torch.float32, device=cuda)
    fn = kernel_function("bobra_flash_attention_lse", attn_ops._LSE_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(), lse.data_ptr(),
             1, 4, 4, 65, 65, 32, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             k.stride(0), k.stride(1), o.stride(0), o.stride(1), 1, 0, 32 ** -0.5, 1,
             torch.cuda.current_stream().cuda_stream)
    assert err != 0
    # fp32 takes the scalar kernel at any group
    out, _ = flash_attention_lse_cuda(q.float(), k.float(), k.float())
    torch.cuda.synchronize()
    assert out.shape == q.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", TRAIN_FLASH_CASES, ids=str)
def test_flash_backward_kernel_matches_plain(cuda, dtype, case):
    from bobrapet_tpu_torch.ops import (
        flash_attention_backward_cuda,
        flash_attention_backward_reference,
        flash_attention_lse_cuda,
    )

    q, k, v, do = _train_inputs(case, dtype, cuda)
    out, lse = flash_attention_lse_cuda(q, k, v)
    before = flash_attention_backward_cuda.launches
    got = flash_attention_backward_cuda(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    assert flash_attention_backward_cuda.launches == before + 1
    want = flash_attention_backward_reference(q, k, v, out, do, lse)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w, dtype, 2.0 ** -7, 1e-2, 2e-4)
    # the same bits again: no atomics
    again = flash_attention_backward_cuda(q, k, v, out, do, lse)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4096, 4096), (8, 4096), (1024, 2048), (3, 7, 128),
                                   (5, 100)])
def test_rmsnorm_backward_kernel_matches_plain(cuda, dtype, shape, add):
    from bobrapet_tpu_torch.ops import (
        add_rmsnorm_backward_cuda,
        add_rmsnorm_backward_reference,
        rmsnorm_backward_cuda,
        rmsnorm_backward_reference,
    )

    x = _randn(shape, dtype, cuda, 41)
    w = (_randn(shape[-1:], torch.float32, cuda, 42) * 0.1 + 1).to(dtype)
    dy = _randn(shape, dtype, cuda, 43)
    ds = _randn(shape, dtype, cuda, 44)
    if add:
        got = add_rmsnorm_backward_cuda(ds, dy, x, w, 1e-5)
        want = add_rmsnorm_backward_reference(ds, dy, x, w, 1e-5)
    else:
        got = rmsnorm_backward_cuda(dy, x, w, 1e-5)
        want = rmsnorm_backward_reference(dy, x, w, 1e-5)
    torch.cuda.synchronize()
    # the add mode rounds the norm's gradient, then adds ds and rounds
    # again: an ulp of the first can outlive a cancellation, so its bound
    # scales with |norm's gradient| + |result|
    dxn = rmsnorm_backward_reference(dy, x, w, 1e-5)[0].float().abs() if add else 0.0
    for g, ref, mag in zip(got, want, (dxn, 0.0)):
        assert g.dtype == dtype and g.shape == ref.shape
        scale = float(ref.float().abs().max())
        bound_ref = ref.float().abs() + mag
        if dtype == torch.bfloat16:
            bound = 1e-3 + 2.0 ** -6 * bound_ref
        else:
            bound = 1e-5 * max(1.0, scale) * (1 + bound_ref)
        assert torch.isfinite(g).all()
        assert bool(((g.float() - ref.float()).abs() <= bound).all()), float(
            (g.float() - ref.float()).abs().max())
    again = (add_rmsnorm_backward_cuda(ds, dy, x, w, 1e-5) if add
             else rmsnorm_backward_cuda(dy, x, w, 1e-5))
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_tiny_model_gradients_on_the_card_match_the_cpu(cuda):
    """llama_tiny in fp32 (the scalar routes): the gradients of the loss
    through the kernels' Functions equal the CPU's plain path, and every
    attention and norm of the forward and backward went through a kernel."""
    from bobrapet_tpu_torch import ops
    from bobrapet_tpu_torch.parallel.train import cross_entropy_loss

    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))

    def grads(device):
        leaves = {}

        def live(t):
            leaves[len(leaves)] = t.to(device).requires_grad_(True)
            return leaves[len(leaves) - 1]

        p = {"embed": {"weight": live(params["embed"]["weight"])},
             "final_norm": {"weight": live(params["final_norm"]["weight"])},
             "lm_head": {"weight": live(params["lm_head"]["weight"])},
             "layers": [{k: {n: live(t) for n, t in v.items()} for k, v in layer.items()}
                        for layer in params["layers"]]}
        t = tokens.to(device)
        logits, _ = llama.forward(p, t[:, :-1], cfg)
        loss = cross_entropy_loss(logits, t[:, 1:])
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    counters = (ops.flash_attention_lse_cuda, ops.flash_attention_backward_cuda,
                ops.rmsnorm_cuda, ops.rmsnorm_backward_cuda)
    before = [c.launches for c in counters]
    loss, got = grads(cuda)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    n = cfg.n_layers
    assert launched == [n, n, 2 * n + 1, 2 * n + 1]
    want_loss, want = grads("cpu")
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()), rel=1e-5)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(scale, 1e-3)
