"""The port's ops (bobrapet_tpu_torch.ops, models.quant) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
On a CPU tensor every port dispatcher takes its kernel's plain version,
so this holds the plain versions (what the CUDA kernels are held to on
the card) against the JAX references and the Pallas kernels run in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu.ops.attention import attention_reference as jattention_reference
from bobrapet_tpu.ops.attention import flash_attention as jflash_attention
from bobrapet_tpu.ops.rmsnorm import rmsnorm_pallas as jrmsnorm_pallas
from bobrapet_tpu.ops.rmsnorm import rmsnorm_reference as jrmsnorm_reference
from bobrapet_tpu.ops.rope import apply_rope as japply_rope
from bobrapet_tpu.ops.rope import rope_frequencies as jrope_frequencies
from bobrapet_tpu_torch.models import quant as tquant
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.ops import (
    apply_rope,
    attention,
    attention_reference,
    rmsnorm,
    rmsnorm_reference,
    rope_frequencies,
)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


class TestRMSNorm:
    @pytest.mark.parametrize("shape", [(4, 64, 128), (3, 7, 128), (5, 96)])
    def test_fp32_matches_jax_reference_and_pallas(self, shape):
        rng = np.random.default_rng(0)
        x = rng.standard_normal(shape).astype(np.float32)
        w = (rng.standard_normal(shape[-1:]) * 0.1 + 1.0).astype(np.float32)
        out = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
        ref = jrmsnorm_reference(jnp.asarray(x), jnp.asarray(w))
        pallas = jrmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(out), _np(pallas), rtol=1e-5, atol=1e-5)

    def test_bf16_within_one_ulp_of_jax_reference(self):
        # same bf16 inputs; the fp32 mean is summed in another order, so a
        # value may round to the neighbouring bf16 number, never further.
        # One ulp also covers the Pallas kernel's rounding (one cast after
        # the weight product), so the bits must match the reference on
        # nearly every element, and visibly not the Pallas kernel's.
        rng = np.random.default_rng(1)
        x = rng.standard_normal((8, 33, 256)).astype(np.float32)
        w = (rng.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        wt = torch.from_numpy(w).to(torch.bfloat16)
        out = rmsnorm(xt, wt)
        assert out.dtype == torch.bfloat16
        xb, wb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
        ref_bf16 = jrmsnorm_reference(xb, wb)
        ref = _np(ref_bf16)
        assert np.all(np.abs(_np(out) - ref) <= _bf16_ulp(ref))
        bits = out.view(torch.int16).numpy()
        assert np.mean(bits == np.asarray(ref_bf16).view(np.int16)) >= 0.99
        pallas = np.asarray(jrmsnorm_pallas(xb, wb, interpret=True)).view(np.int16)
        assert np.mean(bits == pallas) < 0.9

    def test_dispatcher_on_cpu_is_the_plain_version(self):
        g = torch.Generator().manual_seed(0)
        x = torch.randn(4, 64, generator=g)
        w = torch.randn(64, generator=g)
        assert torch.equal(rmsnorm(x, w, 1e-6), rmsnorm_reference(x, w, 1e-6))


class TestRope:
    @pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 64)])
    def test_frequencies_match_jax(self, scaling):
        out = rope_frequencies(64, 256, 500_000.0, scaling, device="cpu")
        ref = jrope_frequencies(64, 256, 500_000.0, scaling)
        assert out.shape == (256, 32, 2)
        # the fp32 angle t * inv_freq (up to 255 rad here) is rounded once
        # in each framework, at another point under XLA's fusion: one fp32
        # ulp of the largest angle is 1.5e-5, so allow two
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=3.1e-5)

    def test_scaling_remaps_long_wavelengths_only(self):
        plain = rope_frequencies(64, 256, device="cpu")
        scaled = rope_frequencies(64, 256, scaling=(8.0, 1.0, 4.0, 64), device="cpu")
        assert torch.equal(plain[:, 0], scaled[:, 0])  # shortest wavelength stays
        assert not torch.allclose(plain[:, -1], scaled[:, -1])

    @pytest.mark.parametrize("with_positions", [False, True])
    def test_apply_matches_jax(self, with_positions):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 6, 4, 64)).astype(np.float32)
        pos = rng.integers(0, 128, (2, 6)) if with_positions else None
        freqs_t = rope_frequencies(64, 128, device="cpu")
        freqs_j = jrope_frequencies(64, 128)
        out = apply_rope(torch.from_numpy(x), freqs_t,
                         None if pos is None else torch.from_numpy(pos))
        ref = japply_rope(jnp.asarray(x), freqs_j, None if pos is None else jnp.asarray(pos))
        # the tables differ by up to two fp32 ulps of the angle (see above);
        # each output mixes two inputs through them
        atol = 2 * 2.0 ** -23 * 127 * 2 * np.abs(x).max()
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=max(atol, 1e-5))

    def test_bf16_rotates_in_fp32_and_casts_back(self):
        x = torch.randn(1, 4, 2, 32, generator=torch.Generator().manual_seed(3))
        freqs = rope_frequencies(32, 16, device="cpu")
        out = apply_rope(x.to(torch.bfloat16), freqs)
        assert out.dtype == torch.bfloat16
        expect = apply_rope(x.to(torch.bfloat16).float(), freqs).to(torch.bfloat16)
        assert torch.equal(out, expect)


def _qkv(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestAttention:
    @pytest.mark.parametrize("group", [1, 2, 4])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_jax_reference_and_flash(self, group, causal):
        q, k, v = _qkv(4, 2, 64, 64, 4, 4 // group, 32)
        out = attention(*_t(q, k, v), causal=causal)
        ref = jattention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
        flash = jflash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 block_q=32, block_k=32, interpret=True)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(_np(out), _np(flash), rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("sq,sk,q_offset", [(1, 20, 19), (4, 20, 16), (3, 9, 2)])
    def test_q_offset_matches_jax(self, sq, sk, q_offset):
        q, k, v = _qkv(5, 2, sq, sk, 8, 2, 32)
        out = attention(*_t(q, k, v), causal=True, q_offset=q_offset)
        ref = jattention_reference(*map(jnp.asarray, (q, k, v)), causal=True, q_offset=q_offset)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)

    def test_ragged_length_matches_jax_flash(self):
        # 50 does not tile by 32: the Pallas entry point takes its XLA path
        q, k, v = _qkv(6, 1, 50, 50, 4, 2, 32)
        out = attention(*_t(q, k, v), causal=True)
        flash = jflash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 block_q=32, block_k=32, interpret=True)
        np.testing.assert_allclose(_np(out), _np(flash), rtol=2e-4, atol=2e-4)

    def test_kv_mask_and_sm_scale_match_jax(self):
        q, k, v = _qkv(7, 2, 8, 8, 4, 2, 32)
        mask = np.ones((2, 8), np.int32)
        mask[1, 5:] = 0
        out = attention(*_t(q, k, v), causal=False, sm_scale=0.3,
                        kv_mask=torch.from_numpy(mask))
        ref = jattention_reference(*map(jnp.asarray, (q, k, v)), causal=False, sm_scale=0.3,
                                   kv_mask=jnp.asarray(mask))
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)

    def test_bf16_output_type(self):
        q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(8, 1, 4, 4, 2, 1, 32)))
        assert attention_reference(q, k, v).dtype == torch.bfloat16


class TestQuant:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_quantize_array_bit_identical_to_jax(self, dtype):
        rng = np.random.default_rng(9)
        w = rng.standard_normal((48, 40)).astype(np.float32) * 0.05
        w[:, 3] = 0.0  # an all-zero column takes scale 1
        jw = jnp.asarray(w).astype(getattr(jnp, dtype))
        tw = torch.from_numpy(w).to(getattr(torch, dtype))
        jleaf = jquant.quantize_array(jw)
        tleaf = tquant.quantize_array(tw)
        assert tquant.is_quantized(tleaf)
        np.testing.assert_array_equal(tleaf["q"].numpy(), np.asarray(jleaf["q"]))
        np.testing.assert_array_equal(_np(tleaf["scale"]), _np(jleaf["scale"]))
        np.testing.assert_array_equal(_np(tquant.dequantize_array(tleaf)),
                                      _np(jquant.dequantize_array(jleaf)))

    def test_matmul_and_tree_bytes_match_jax(self):
        rng = np.random.default_rng(10)
        x = rng.standard_normal((3, 48)).astype(np.float32)
        w = rng.standard_normal((48, 40)).astype(np.float32)
        tree_j = {"embed": {"weight": jnp.asarray(w)}, "mlp": {"w_up": jnp.asarray(w),
                                                              "norm": jnp.ones(40)}}
        qj = jquant.quantize_params(tree_j)
        qt = tquant.quantize_params(params_from_numpy(jax.tree.map(np.asarray, tree_j), "cpu"))
        assert not tquant.is_quantized(qt["embed"])  # the gather table is skipped
        assert torch.equal(qt["mlp"]["norm"], torch.ones(40))
        assert tquant.tree_bytes(qt) == jquant.tree_bytes(qj)
        out = tquant.matmul(torch.from_numpy(x), qt["mlp"]["w_up"])
        ref = jquant.matmul(jnp.asarray(x), qj["mlp"]["w_up"])
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
        assert torch.equal(tquant.matmul(torch.from_numpy(x), torch.from_numpy(w)),
                           torch.from_numpy(x) @ torch.from_numpy(w))
