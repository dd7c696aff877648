"""The device-length attention kernel and the CUDA-graphed decode loops, on
the card.

Marked ``gpu``: without a CUDA card every test here skips (the decision is
taken in a fixture, never at import). Run them on the H100 with
``python -m pytest --noconftest -m gpu tests/test_torch_graphs.py``.

Tolerances as in test_torch_kernels.py: attention in bf16 one ulp of the
plain value (rtol 2^-7) plus 1e-3, in fp32 2e-4. A graph replays the very
launches its capture recorded, so graphed and eager runs must give the
same tokens, and the launch counters the same counts.
"""

import dataclasses

import pytest
import torch

from bobrapet_tpu_torch.graphs import GraphedStep
from bobrapet_tpu_torch.models import llama, lora
from bobrapet_tpu_torch.ops import (
    add_rmsnorm_cuda,
    cached_attention_cuda,
    cached_attention_reference,
    flash_attention_cuda,
    paged_attention_cuda,
    rmsnorm_cuda,
)
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_graphs.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def _close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    bound = (1e-3 + 2.0 ** -7 * ref.abs()) if dtype == torch.bfloat16 else 2e-4 + 2e-4 * ref.abs()
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


CACHED_CASES = [
    # b, sq, cap, hq, hkv, d, lens
    (8, 1, 192, 32, 8, 128, (129, 140, 150, 160, 170, 180, 191, 192)),  # greedy decode
    (2, 1, 2048, 32, 8, 128, (1, 2048)),                                 # 8 blocks a cluster
    (3, 1, 64, 4, 2, 32, (1, 33, 64)),                                   # llama_tiny widths
    (2, 4, 80, 8, 2, 32, (4, 80)),                                       # 16 rows, causal
    (2, 1, 100, 16, 1, 128, (37, 100)),                                  # group 16
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CACHED_CASES, ids=str)
def test_cached_attention_kernel_matches_plain(cuda, dtype, case):
    b, sq, cap, hq, hkv, d, lens = case
    q = _randn((b, sq, hq, d), dtype, cuda, 1)
    k = _randn((b, cap, hkv, d), dtype, cuda, 2)
    v = _randn((b, cap, hkv, d), dtype, cuda, 3)
    n = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (cached_attention_cuda.launches, flash_attention_cuda.launches)
    out = cached_attention_cuda(q, k, v, n)
    torch.cuda.synchronize()
    assert (cached_attention_cuda.launches, flash_attention_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    _close(out, cached_attention_reference(q, k, v, n), dtype)
    # keys past the lengths are never read
    k2, v2 = k.clone(), v.clone()
    for row, length in enumerate(lens):
        k2[row, length:] = float("nan")
        v2[row, length:] = float("nan")
    assert torch.equal(cached_attention_cuda(q, k2, v2, n), out)
    assert torch.equal(cached_attention_cuda(q, k, v, n), out)  # the same bits twice


def test_cached_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 5, 4, 32, dtype=torch.bfloat16, device=cuda)  # 20 packed rows: taken
    kv = torch.zeros(1, 16, 1, 32, dtype=torch.bfloat16, device=cuda)
    n = torch.tensor([16], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        cached_attention_cuda(*[torch.zeros(1, 5, 4, 48, dtype=torch.bfloat16, device=cuda)] * 3, n)
    with pytest.raises(TypeError, match="int32"):
        cached_attention_cuda(q[:, :1], kv, kv, n.long())
    with pytest.raises(ValueError):
        cached_attention_cuda(q[:, :1], kv, kv, n.cpu())


def test_graphed_step_counts_every_replay(cuda):
    x = _randn((8, 4096), torch.bfloat16, cuda, 4)
    d = _randn((8, 4096), torch.bfloat16, cuda, 5)
    w = _randn((4096,), torch.bfloat16, cuda, 6)

    def fn(x, d):
        s, y = add_rmsnorm_cuda(x, d, w)
        x.copy_(y)
        return s

    eager_x = x.clone()
    for _ in range(5):
        s_eager, y = add_rmsnorm_cuda(eager_x, d, w)
        eager_x.copy_(y)
    rmsnorm_cuda.launches = add_rmsnorm_cuda.launches = 0
    step = GraphedStep(fn, x, d)
    for _ in range(5):
        s = step()
    torch.cuda.synchronize()
    assert step.graph is not None and step.replays == 4
    assert rmsnorm_cuda.launches == add_rmsnorm_cuda.launches == 5
    assert torch.equal(x, eager_x) and torch.equal(s, s_eager)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_generate_graphed_equals_eager(cuda, dtype):
    cfg = dataclasses.replace(llama.llama_tiny(), dtype=dtype)
    params = _to(llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cuda)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), generator=torch.Generator().manual_seed(1))
    runs = {}
    for graph in (False, True, True, False):
        rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
        cached_attention_cuda.launches = 0
        out = llama.greedy_generate(params, prompt.to(cuda), cfg, max_new_tokens=7,
                                    cuda_graph=graph)
        torch.cuda.synchronize()
        counts = (rmsnorm_cuda.launches, flash_attention_cuda.launches,
                  cached_attention_cuda.launches)
        assert counts == ((2 * cfg.n_layers + 1) * 8, cfg.n_layers * 8, cfg.n_layers * 7)
        runs.setdefault(graph, []).append(out)
    assert all(torch.equal(o, runs[False][0]) for o in runs[False] + runs[True])
    assert runs[True][0].dtype == torch.int32 and runs[True][0].shape == (3, 7)


def test_tiny_engine_horizon_graph_equals_eager_and_cpu(cuda):
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pcfg = PagedConfig(max_slots=3, block_size=8, num_blocks=24, max_blocks_per_seq=4,
                       prefix_caching=False)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (5, 12, 9, 3, 7)]
    outs = {}
    for name, tree, horizon in (("cpu", params, 4), ("card", _to(params, cuda), 1),
                                ("card", _to(params, cuda), 4)):
        eng = ServingEngine(tree, cfg, pcfg, pipeline_decode=False, decode_horizon=horizon,
                            dispatch_depth=1)
        for i, p in enumerate(prompts):
            eng.submit(p, 6 + 3 * i)
        paged_attention_cuda.launches = rmsnorm_cuda.launches = 0
        eng.run()
        steps = eng.phase_counts["device_steps"]
        if name == "card":
            assert paged_attention_cuda.launches == steps * cfg.n_layers
            assert rmsnorm_cuda.launches == (len(prompts) + steps) * (2 * cfg.n_layers + 1)
        if horizon > 1 and name == "card":
            step, _ = eng._hz[horizon]
            assert step.graph is not None and step.replays == eng.phase_counts["horizons"] - 1
        outs[name, horizon] = {r.rid: r.output for r in eng.finished}
    assert outs["card", 4] == outs["card", 1] == outs["cpu", 4]


def test_tiny_engine_prefix_chunk_lora_graph_equals_classic_and_cpu(cuda):
    """Prefix caching, chunked prefill and three adapters over the zero one:
    the horizon of 4 as a graph, the classic tick and the CPU give the same
    tokens, and every prefill (one-shot, seeded or chunk) and every decode
    step went through the kernels."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, sites=("wq", "wv", "w_down"))
    gen = torch.Generator().manual_seed(3)
    adapters = [lora.zero_lora(cfg, lcfg, "cpu")]
    for _ in range(3):
        a = lora.init_lora(gen, cfg, lcfg, "cpu")
        adapters.append(lora._tree_map(
            lambda leaf: leaf + 0.05 * torch.randn(leaf.shape, generator=gen), a))
    stacked = lora.stack_adapters(adapters)
    pcfg = PagedConfig(max_slots=3, block_size=8, num_blocks=48, max_blocks_per_seq=8,
                       prefix_caching=True, prefill_chunk=16)
    g = torch.Generator().manual_seed(2)
    system = torch.randint(0, cfg.vocab_size, (16,), generator=g).tolist()
    waves = [[(system + torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist(), a)
              for n, a in ((30, 1), (5, 0), (12, 2))] for _ in range(2)]
    waves[1].append((torch.randint(0, cfg.vocab_size, (6,), generator=g).tolist(), 3))
    outs = {}
    for name, dev, horizon in (("cpu", "cpu", 4), ("card", cuda, 1), ("card", cuda, 4)):
        eng = ServingEngine(_to(params, dev), cfg, pcfg, loras=_to(stacked, dev),
                            lora_scale=lcfg.scale, pipeline_decode=False,
                            decode_horizon=horizon, dispatch_depth=1)
        paged_attention_cuda.launches = rmsnorm_cuda.launches = 0
        flash_attention_cuda.launches = 0
        for wave in waves:
            for i, (p, adapter) in enumerate(wave):
                eng.submit(p, 5 + 2 * i, adapter=adapter)
            eng.run()
        steps, prefills = eng.phase_counts["device_steps"], eng.phase_counts["prefills"]
        assert eng.blocks.hit_tokens >= 16 and eng.phase_counts["chunks"] > 0
        if name == "card":
            assert flash_attention_cuda.launches == prefills * cfg.n_layers
            assert paged_attention_cuda.launches == steps * cfg.n_layers
            assert rmsnorm_cuda.launches == (prefills + steps) * (2 * cfg.n_layers + 1)
        if horizon > 1 and name == "card":
            step, _ = eng._hz[horizon]
            assert step.graph is not None and step.replays == eng.phase_counts["horizons"] - 1
        outs[name, horizon] = {r.rid: r.output for r in eng.finished}
    assert outs["card", 4] == outs["card", 1] == outs["cpu", 4]


def test_the_jax_default_paged_config_serves_on_the_card(cuda):
    """PagedConfig() as JAX defaults it (prefix caching on) at H = 8: the
    card's tokens are the CPU's, and a repeated prompt hits the cache."""
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist() for n in (40, 9, 23)]
    outs = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(_to(params, dev), cfg, PagedConfig(), decode_horizon=8,
                            dispatch_depth=1)
        for wave in (prompts, prompts[:1]):
            for p in wave:
                eng.submit(p, 12)
            eng.run()
        assert eng.blocks.hit_tokens == 32
        outs[str(dev)] = {r.rid: r.output for r in eng.finished}
    assert outs["cpu"] == outs[str(cuda)]
