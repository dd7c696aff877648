"""RMSNorm fused with the residual add before it, on the CPU.

``ops.add_rmsnorm`` returns ``(x + delta, rmsnorm(x + delta))``; on a card
it is one launch of ``csrc/rmsnorm.cu``'s add mode, on the CPU the two
torch ops the model took before. Held here: the plain version against
the JAX package (``x + delta`` bit for bit, the norm at
``test_torch_ops.py::TestRMSNorm``'s tolerances: 1e-5 in fp32, one bf16
ulp with the bits equal on at least 99% of elements); the model's and the
decode step's norm sites (2L add-mode norms and one plain norm per
forward); the CUDA wrappers' refusals; the C entry's signature and its
one kernel template; ``step_profile.py``'s helpers and imports. Which
instance runs at which width is the C entry's choice, held on the card in
``test_torch_kernels.py``.
"""

import ast
import importlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.ops.rmsnorm import rmsnorm_reference as jrmsnorm_reference
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.ops import (
    add_rmsnorm,
    add_rmsnorm_cuda,
    add_rmsnorm_reference,
    rmsnorm_cuda,
    rmsnorm_reference,
)
from bobrapet_tpu_torch.serving import PagedConfig
from bobrapet_tpu_torch.serving import engine as tengine

norm_ops = importlib.import_module("bobrapet_tpu_torch.ops.rmsnorm")
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "bobrapet_tpu_torch" / "csrc"


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    delta = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    return x, delta, w


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


class TestPlainVersionAgainstJax:
    @pytest.mark.parametrize("shape", [(2, 7, 64), (5, 128)])
    def test_fp32(self, shape):
        x, delta, w = _inputs(0, shape)
        s, y = add_rmsnorm(*(torch.from_numpy(a) for a in (x, delta, w)))
        sj = jnp.asarray(x) + jnp.asarray(delta)
        np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(sj).view(np.int32))
        yj = np.asarray(jrmsnorm_reference(sj, jnp.asarray(w)))
        np.testing.assert_allclose(y.numpy(), yj, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape", [(2, 7, 64), (5, 128)])
    def test_bf16(self, shape):
        x, delta, w = _inputs(1, shape)
        xt, dt, wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, delta, w))
        s, y = add_rmsnorm(xt, dt, wt)
        assert s.dtype == y.dtype == torch.bfloat16
        xj, dj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, delta, w))
        sj = xj + dj
        np.testing.assert_array_equal(s.view(torch.int16).numpy(), np.asarray(sj).view(np.int16))
        yj = jrmsnorm_reference(sj, wj)
        ref = np.asarray(yj.astype(jnp.float32))
        assert np.all(np.abs(y.float().numpy() - ref) <= _bf16_ulp(ref))
        assert np.mean(y.view(torch.int16).numpy() == np.asarray(yj).view(np.int16)) >= 0.99

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_is_the_two_steps_the_model_took(self, dtype):
        # the add rounded to x's type, then the norm of the rounded sum
        x, delta, w = (torch.from_numpy(a).to(dtype) for a in _inputs(2, (3, 5, 128)))
        s, y = add_rmsnorm(x, delta, w, 1e-6)
        assert torch.equal(s, x + delta)
        assert torch.equal(y, rmsnorm_reference(x + delta, w, 1e-6))
        s2, y2 = add_rmsnorm_reference(x, delta, w, 1e-6)
        assert torch.equal(s, s2) and torch.equal(y, y2)


class _Counting:
    """Counts the calls of a norm dispatcher and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def counted(monkeypatch):
    """The model's two norm dispatchers, counted (the engine's decode step
    reaches them through the model's blocks)."""
    add, plain = _Counting(tllama.add_rmsnorm), _Counting(tllama.rmsnorm)
    monkeypatch.setattr(tllama, "add_rmsnorm", add)
    monkeypatch.setattr(tllama, "rmsnorm", plain)
    return add, plain


@pytest.fixture(scope="module")
def tiny():
    cfg = tllama.llama_tiny()
    return cfg, tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


class TestNormSites:
    def test_forward_fuses_every_norm_but_the_first(self, tiny, counted):
        cfg, params = tiny
        add, plain = counted
        toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)))
        logits, _ = tllama.forward(params, toks, cfg)
        assert (add.calls, plain.calls) == (2 * cfg.n_layers, 1)
        assert logits.shape == (2, 6, cfg.vocab_size)

    def test_greedy_generate_fuses_in_every_forward(self, tiny, counted):
        cfg, params = tiny
        add, plain = counted
        prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 5)))
        tllama.greedy_generate(params, prompt, cfg, max_new_tokens=3)
        forwards = 1 + 3
        assert (add.calls, plain.calls) == (2 * cfg.n_layers * forwards, forwards)

    def test_decode_step_fuses_every_norm_but_the_first(self, tiny, counted):
        cfg, params = tiny
        add, plain = counted
        rng = np.random.default_rng(5)
        pcfg = PagedConfig(max_slots=3, block_size=4, num_blocks=8, max_blocks_per_seq=2)
        shape = (cfg.n_layers, pcfg.num_blocks, pcfg.block_size, cfg.n_kv_heads, cfg.head_dim)
        pools = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for n in ("k", "v")}
        lens = torch.tensor([1, 3, 6], dtype=torch.int32)
        tables = torch.tensor([[0, 0], [1, 0], [2, 3]], dtype=torch.int32)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, 3).astype(np.int32))
        active = torch.tensor([False, True, True])
        _, tok = tengine._decode_step(params, pools, tokens, lens, active, tables,
                                      cfg=cfg, pcfg=pcfg)
        assert (add.calls, plain.calls) == (2 * cfg.n_layers, 1)
        assert tok.shape == (3,) and tok.dtype == torch.int32


def _meta(*shape):
    return torch.empty(shape, device="meta")


class TestWrappersRefuse:
    def test_cpu_tensors(self):
        x = torch.ones(2, 32)
        with pytest.raises(ValueError, match="CUDA"):
            add_rmsnorm_cuda(x, torch.ones(2, 32), torch.ones(32))

    @pytest.mark.parametrize("fn", [add_rmsnorm, add_rmsnorm_cuda])
    def test_meta_tensors(self, fn):
        with pytest.raises(ValueError):
            fn(_meta(4, 32), _meta(4, 32), _meta(32))

    @pytest.mark.parametrize("dtypes", [
        (torch.float32, torch.bfloat16, torch.float32),   # delta
        (torch.bfloat16, torch.bfloat16, torch.float32),  # weight
        (torch.float16, torch.float16, torch.float16),    # a type the kernel lacks
    ])
    def test_mixed_or_unknown_dtypes(self, dtypes):
        x, delta, w = (torch.ones(s, dtype=t) for s, t in zip(((2, 32), (2, 32), (32,)), dtypes))
        with pytest.raises(TypeError):
            add_rmsnorm_cuda(x, delta, w)

    def test_mixed_dtypes_in_the_plain_mode(self):
        with pytest.raises(TypeError):
            rmsnorm_cuda(torch.ones(2, 32), torch.ones(32, dtype=torch.bfloat16))

    def test_other_shapes(self):
        with pytest.raises(ValueError, match="delta shape"):
            add_rmsnorm_cuda(torch.ones(2, 32), torch.ones(1, 32), torch.ones(32))
        with pytest.raises(ValueError, match="weight shape"):
            add_rmsnorm_cuda(torch.ones(2, 32), torch.ones(2, 32), torch.ones(16))

    def test_aliased_inputs(self):
        x = torch.ones(2, 32)
        with pytest.raises(ValueError, match="alias"):
            add_rmsnorm_cuda(x, x, torch.ones(32))
        base = torch.ones(5, 32)
        with pytest.raises(ValueError, match="alias"):
            add_rmsnorm_cuda(base[0:4], base[1:5], torch.ones(32))
        # disjoint rows of one buffer do not alias: refused only for the device
        with pytest.raises(ValueError, match="CUDA"):
            add_rmsnorm_cuda(base[0:2], base[2:4], torch.ones(32))


class TestCSource:
    def test_the_c_entry_takes_both_modes(self):
        text = (CSRC / "rmsnorm.cu").read_text()
        sig = re.search(r'extern "C" int bobra_rmsnorm\((.*?)\)', text, re.S).group(1)
        params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
        assert len(params) == len(norm_ops._ARGTYPES)
        assert params[:5] == ["x", "delta", "w", "sum_out", "out"]
        assert params[5:] == ["rows", "d", "eps", "dtype", "stream"]

    def test_one_kernel_template_serves_both_modes(self):
        text = (CSRC / "rmsnorm.cu").read_text()
        assert len(re.findall(r"__global__ void", text)) == 1
        assert re.search(r"template <typename T, bool kAdd, int kWidth, int kRowThreads>\s*"
                         r"__global__ void[^\n]*\nrmsnorm_kernel\(", text)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestChipSmokeArithmetic:
    def test_add_mode_bounds_of_the_main_path_shapes(self, smoke):
        # x and delta read, s and y written, w read: 33.6 MB at prefill
        nbytes = smoke.rmsnorm_bytes(1024, 4096, 2, add=True)
        assert nbytes == 4 * 1024 * 4096 * 2 + 4096 * 2
        ms, by = smoke.bound(nbytes, smoke.rmsnorm_flops(1024, 4096, add=True), "bfloat16")
        assert by == "bytes" and round(ms * 1e3, 1) == 10.0
        ms, by = smoke.bound(smoke.rmsnorm_bytes(8, 4096, 2, add=True),
                             smoke.rmsnorm_flops(8, 4096, add=True), "bfloat16")
        assert by == "bytes" and round(ms * 1e6) == 81
        # the plain mode keeps its bound
        assert smoke.rmsnorm_bytes(1024, 4096, 2, add=False) == 2 * 1024 * 4096 * 2 + 4096 * 2

    def test_every_norm_kernel_instance_is_checked_for_spills(self, smoke):
        log = """== rmsnorm.cu
ptxas info    : Compiling entry function '_ZN5bobra14rmsnorm_kernelI13__nv_bfloat16Lb1ELi4096ELi256EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN5bobra14rmsnorm_kernelI13__nv_bfloat16Lb1ELi4096ELi256EEEvPKT_
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 32 bytes smem, 400 bytes cmem[0]
"""
        instances = smoke.ptxas_instances(log)
        assert [smoke.spills_in(instances, k) for k in ("attn", "rmsnorm_kernel")] == [
            [], ["_ZN5bobra14rmsnorm_kernelI13__nv_bfloat16Lb1ELi4096ELi256EEEvPKT_"]]

    def test_launch_counts_split_the_add_mode(self, smoke):
        assert smoke.norm_launches(forwards=65, n_layers=32) == {
            "rmsnorm": 65 * 65, "add_rmsnorm": 65 * 64}


class TestStepProfile:
    """``step_profile.py`` counts any checkout's kernels by this checkout's
    ``chip_smoke.py`` filters, and imports nothing of JAX."""

    @pytest.fixture(scope="class")
    def step_profile(self):
        spec = importlib.util.spec_from_file_location("step_profile", ROOT / "step_profile.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def test_the_helpers_are_this_checkouts(self, step_profile):
        helpers = step_profile.smoke_helpers()
        assert Path(helpers.__file__) == ROOT / "chip_smoke.py"
        for name in ("request_split", "tick_profile", "elementwise_share", "serve_prompts"):
            assert callable(getattr(helpers, name))

    def test_imports_no_jax(self):
        tree = ast.parse((ROOT / "step_profile.py").read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert "torch" in names
        assert [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "bobrapet_tpu")] == []
