"""The backward kernels' plain versions and the autograd guard, on the CPU.

``flash_attention_backward_reference`` and the two RMSNorm backward
references are the plain versions the card's backward kernels are held to
(``chip_smoke.py`` phase 3; ``tests/test_torch_kernels.py``). Here they are
held to JAX's VJPs of the functions the JAX train step differentiates
(``attention_reference``, ``rmsnorm_reference``; fp32, to 1e-5), and to
autograd of the port's own plain forwards with ``gradcheck`` in float64.

The guard: every kernel wrapper that autograd cannot see refuses a tensor
that requires grad while grad is enabled, before it looks at the device,
so a forward under autograd never returns an output without a gradient.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu_torch import ops

jattn = importlib.import_module("bobrapet_tpu.ops.attention")
jnorm = importlib.import_module("bobrapet_tpu.ops.rmsnorm")
tnorm = importlib.import_module("bobrapet_tpu_torch.ops.rmsnorm")
tattn = importlib.import_module("bobrapet_tpu_torch.ops.attention")

HEADS = 4  # query heads of the attention cases


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 2, 17, 64, 65, 130])
def test_attention_backward_matches_jax_vjp(group, s):
    rng = np.random.default_rng(100 * group + s)
    q = rng.standard_normal((2, s, HEADS, 32)).astype(np.float32)
    k = rng.standard_normal((2, s, HEADS // group, 32)).astype(np.float32)
    v = rng.standard_normal((2, s, HEADS // group, 32)).astype(np.float32)
    do = rng.standard_normal((2, s, HEADS, 32)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattn.attention_reference(a, b, c, causal=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = ops.flash_attention_lse_reference(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    assert lse.shape == (2, HEADS, s) and lse.dtype == torch.float32
    got = ops.flash_attention_backward_reference(_t(q), _t(k), _t(v), o, _t(do), lse)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


def test_attention_lse_is_the_logsumexp_of_the_scaled_masked_scores():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 5, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 1, 32)).astype(np.float32))
    _, lse = ops.flash_attention_lse_reference(q, k, k, causal=True, q_offset=3)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double().expand(1, 8, 2, 32))
    scores = scores / np.sqrt(32)
    for i in range(5):
        want = torch.logsumexp(scores[0, :, i, :3 + i + 1], dim=-1)
        np.testing.assert_allclose(lse[0, :, i].numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128)])
def test_rmsnorm_backward_matches_jax_vjp(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32) * 2
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jnorm.rmsnorm_reference(a, b, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    dx, dw = ops.rmsnorm_backward_reference(_t(dy), _t(x), _t(w), 1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_ds", [True, False], ids=["residual-used", "final-norm"])
def test_add_rmsnorm_backward_matches_jax_vjp(with_ds):
    """The add mode: the VJP of ``s = x + d; (s, rmsnorm(s))``; without a
    gradient for ``s`` (the final norm), the norm's alone."""
    rng = np.random.default_rng(3)
    x, d, dy, ds = (rng.standard_normal((6, 128)).astype(np.float32) for _ in range(4))
    w = (rng.standard_normal(128) * 0.1 + 1).astype(np.float32)

    def fn(a, b, c):
        s = a + b
        return s, jnorm.rmsnorm_reference(s, c, 1e-5)

    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(d), jnp.asarray(w))
    ds_j = jnp.asarray(ds) if with_ds else jnp.zeros_like(jnp.asarray(ds))
    want_dx, want_dd, want_dw = vjp((ds_j, jnp.asarray(dy)))
    s = _t(x) + _t(d)
    dx, dw = ops.add_rmsnorm_backward_reference(_t(ds) if with_ds else None, _t(dy), s, _t(w))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-5, atol=1e-5)


class _PlainAttention(torch.autograd.Function):
    """The plain forward with the plain backward: what gradcheck holds."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset):
        o, lse = ops.flash_attention_lse_reference(q, k, v, causal=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.q_offset = q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ops.flash_attention_backward_reference(q, k, v, o, do, lse, causal=True,
                                                        q_offset=ctx.q_offset), None)


class _PlainNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return ops.rmsnorm_reference(x, w, 1e-5)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return ops.rmsnorm_backward_reference(dy, x, w, 1e-5)


class _PlainAddNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, w):
        s, y = ops.add_rmsnorm_reference(x, d, w, 1e-5)
        ctx.save_for_backward(s, w)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, w = ctx.saved_tensors
        dx, dw = ops.add_rmsnorm_backward_reference(ds, dy, s, w, 1e-5)
        return dx, dx, dw


def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("group,q_offset", [(1, 0), (2, 0), (4, 3)])
def test_attention_backward_gradcheck(group, q_offset):
    q = _f64(1, 5, 4, 32, seed=1)
    k, v = _f64(1, 5 + q_offset, 4 // group, 32, seed=2), _f64(1, 5 + q_offset, 4 // group, 32,
                                                                seed=3)
    assert torch.autograd.gradcheck(lambda a, b, c: _PlainAttention.apply(a, b, c, q_offset),
                                    (q, k, v))
    # and equal to autograd of the plain forward itself
    do = torch.randn(q.shape, dtype=torch.float64)
    o = ops.attention_reference(q, k, v, causal=True, q_offset=q_offset)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = torch.autograd.grad(_PlainAttention.apply(q, k, v, q_offset), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_rmsnorm_backward_gradcheck():
    x, w = _f64(3, 64, seed=4), _f64(64, seed=5)
    assert torch.autograd.gradcheck(_PlainNorm.apply, (x, w))
    x2, d, w2 = _f64(3, 64, seed=6), _f64(3, 64, seed=7), _f64(64, seed=8)
    assert torch.autograd.gradcheck(_PlainAddNorm.apply, (x2, d, w2))


# ---------------------------------------------------------------------------
# the guard


def _rg(*shape):
    return torch.ones(shape, requires_grad=True)


def _guarded_calls():
    """Every kernel wrapper autograd cannot see, called with a first input
    that requires grad (the rest are placeholders: the guard comes first)."""
    z = torch.zeros(2, dtype=torch.int32)
    f = torch.ones(2, 4)
    return {
        "rmsnorm_cuda": lambda: ops.rmsnorm_cuda(_rg(2, 32), torch.ones(32)),
        "add_rmsnorm_cuda": lambda: ops.add_rmsnorm_cuda(_rg(2, 32), f, torch.ones(32)),
        "flash_attention_cuda": lambda: ops.flash_attention_cuda(_rg(1, 4, 2, 32), f, f),
        "flash_attention_lse_cuda": lambda: ops.flash_attention_lse_cuda(_rg(1, 4, 2, 32), f, f),
        "flash_attention_backward_cuda": lambda: ops.flash_attention_backward_cuda(
            _rg(1, 4, 2, 32), f, f, f, f, f),
        "rmsnorm_backward_cuda": lambda: ops.rmsnorm_backward_cuda(_rg(2, 32), f, f),
        "add_rmsnorm_backward_cuda": lambda: ops.add_rmsnorm_backward_cuda(_rg(2, 32), f, f, f),
        "cached_attention_cuda": lambda: ops.cached_attention_cuda(_rg(1, 1, 2, 32), f, f, z),
        "paged_attention_cuda": lambda: ops.paged_attention_cuda(_rg(2, 4, 32), f, f, z, z),
        "paged_attention_multi_cuda": lambda: ops.paged_attention_multi_cuda(
            _rg(2, 1, 4, 32), f, f, z, z),
        "quant_matmul_cuda": lambda: ops.quant_matmul_cuda(_rg(2, 16), z, f),
        "pick_tokens_cuda": lambda: ops.pick_tokens_cuda(_rg(2, 16)),
        "moe_route_cuda": lambda: ops.moe_route_cuda(_rg(4, 8), 2, 4),
        "moe_dispatch_cuda": lambda: ops.moe_dispatch_cuda(_rg(4, 16), z),
        "moe_combine_cuda": lambda: ops.moe_combine_cuda(_rg(8, 4, 16), z, z, f),
        "moe_gate_up_cuda": lambda: ops.moe_gate_up_cuda(_rg(4, 64), z, z, f, f),
        "moe_down_cuda": lambda: ops.moe_down_cuda(_rg(8, 4, 64), z, f),
    }


@pytest.mark.parametrize("name", sorted(_guarded_calls()))
def test_every_kernel_wrapper_refuses_a_tensor_that_requires_grad(name):
    with pytest.raises(RuntimeError, match=f"^{name}: an input requires grad"):
        _guarded_calls()[name]()
    # without grad the same call passes the guard (and then refuses the CPU)
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        _guarded_calls()[name]()


def test_the_guard_covers_every_cuda_wrapper_of_ops():
    wrappers = {n for n in ops.__all__ if n.endswith("_cuda")}
    assert wrappers == set(_guarded_calls())


def test_the_dispatchers_stay_differentiable_on_the_cpu():
    """On the CPU the dispatchers take the plain versions, which autograd
    differentiates itself: no guard, a real gradient."""
    x, w = _rg(2, 32), torch.ones(32, requires_grad=True)
    s, y = ops.add_rmsnorm(x, torch.ones(2, 32), w)
    (ops.rmsnorm(y, w).sum() + s.sum()).backward()
    assert x.grad is not None and w.grad is not None
    q = torch.randn(1, 4, 2, 32, requires_grad=True)
    ops.attention(q, q[:, :, :1].detach(), q[:, :, :1].detach()).sum().backward()
    assert q.grad is not None


def test_the_training_entries_count_their_own_launches():
    """The log-sum-exp forward and the backward have counters of their own;
    the serving entries' counters are left alone."""
    for fn in (ops.flash_attention_lse_cuda, ops.flash_attention_backward_cuda,
               ops.rmsnorm_backward_cuda, ops.add_rmsnorm_backward_cuda):
        assert fn.launches == 0
    assert tnorm.norm_backward_blocks(4096) == 256
    assert tnorm.norm_backward_blocks(8) == 1
    assert tnorm.norm_backward_blocks(1 << 20) == tnorm.NORM_BWD_MAX_BLOCKS


def test_the_functions_route_gradients_like_autograd(monkeypatch):
    """The card's autograd Functions, with the plain versions standing in
    for the kernels (on the CPU): the same gradients as autograd of the
    plain forwards, including an add-mode ``s`` that nothing reads (the
    final norm) and GQA."""
    monkeypatch.setattr(tattn, "flash_attention_lse_cuda", ops.flash_attention_lse_reference)
    monkeypatch.setattr(tattn, "flash_attention_backward_cuda",
                        ops.flash_attention_backward_reference)
    monkeypatch.setattr(tnorm, "rmsnorm_cuda", ops.rmsnorm_reference)
    monkeypatch.setattr(tnorm, "add_rmsnorm_cuda", ops.add_rmsnorm_reference)
    monkeypatch.setattr(tnorm, "rmsnorm_backward_cuda",
                        lambda dy, x, w, eps, ds=None: ops.add_rmsnorm_backward_reference(
                            ds, dy, x, w, eps))
    monkeypatch.setattr(tnorm, "add_rmsnorm_backward_cuda", ops.add_rmsnorm_backward_reference)
    g = torch.Generator().manual_seed(9)
    x, d = (torch.randn(3, 5, 32, generator=g, requires_grad=True) for _ in range(2))
    w = torch.randn(32, generator=g).requires_grad_(True)
    q = torch.randn(3, 5, 4, 32, generator=g, requires_grad=True)
    k, v = (torch.randn(3, 5, 2, 32, generator=g, requires_grad=True) for _ in range(2))

    def loss(norm, add_norm, attn):
        s, y = add_norm(x, d, w, 1e-5)
        _, y2 = add_norm(s, y, w, 1e-5)  # the final norm: its s is not read
        return (norm(y2, w, 1e-5) * 1.5).sum() + (s * y).sum() + attn(q, k, v).square().sum()

    want = torch.autograd.grad(loss(ops.rmsnorm_reference, ops.add_rmsnorm_reference,
                                    ops.attention_reference), (x, d, w, q, k, v))
    got = torch.autograd.grad(loss(tnorm._RMSNorm.apply, tnorm._AddRMSNorm.apply,
                                   lambda a, b, c: tattn._FlashAttention.apply(a, b, c, True, 0)),
                              (x, d, w, q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
