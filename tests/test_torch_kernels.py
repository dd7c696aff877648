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

import pytest
import torch

from bobrapet_tpu_torch.models import llama
from bobrapet_tpu_torch.ops import (
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
    # b, sq, sk, hq, hkv, d, causal, q_offset
    (8, 128, 128, 32, 8, 128, True, 0),     # the model's prefill
    (8, 1, 160, 32, 8, 128, True, 159),     # a decode step
    (2, 100, 100, 8, 2, 128, True, 0),      # ragged
    (2, 7, 45, 4, 4, 128, True, 38),        # ragged chunk after a prefix
    (2, 64, 96, 4, 1, 32, False, 0),        # non-causal, group 4
    (1, 33, 33, 2, 2, 32, True, 0),
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


def test_paged_kernel_zero_length_and_masked_keys(cuda):
    q, k, v, tables, lens = _paged_inputs(PAGED_CASES[1], torch.float32, cuda)
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
