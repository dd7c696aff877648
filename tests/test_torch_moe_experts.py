"""The MoE expert products over the live capacity rows, on the CPU.

Held here:

- the plain ``moe_gate_up_reference`` and ``moe_down_reference`` against
  JAX's dispatch and expert einsums (``bobrapet_tpu/models/moe.py``
  ``moe_mlp_block``) on bridged ``moe_tiny`` weights, on the live rows:
  fp32 within 1e-5 of the rows' largest magnitude (XLA's and torch's CPU
  products sum in other orders); rows at or past an expert's ``n_e`` are
  zeros. Routes: the no-drop capacity, a droppy one, tied router logits,
  an expert no token chose, an expert every token chose;
- ``moe_mlp_block`` bit for bit equal to the dense sequence the model ran
  before the expert kernels (kept below as ``_dense_block``), fp32 and
  bf16, at the no-drop and a droppy capacity;
- the C entries' parameter lists and constants as the wrappers mirror them,
  the route picked in the entry from the capacity, and the wrappers'
  refusals (CPU tensors, wrong types and shapes) without a card;
- chip_smoke.py's new arithmetic: launches per forward, the expert
  products' bounds, routed FLOPs and live weight bytes at Mixtral's shapes.
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bobrapet_tpu.models import moe as jmoe
from bobrapet_tpu_torch import ops
from bobrapet_tpu_torch.models import moe as tmoe
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.ops import moe_experts as mx
from bobrapet_tpu_torch.ops.moe_dispatch import (
    _COMBINE_ARGTYPES,
    moe_dispatch,
    moe_route_reference,
)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "bobrapet_tpu_torch" / "csrc"
#: fp32 products of XLA and torch on the CPU, of the rows' largest magnitude
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one torch thread a test worker: the default pools slow six workers down
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jmoe.moe_tiny()
    params_j = jmoe.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, params_j, params_t


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logits(case: str, t: int, e: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    if case == "ties":
        x = np.round(x * 4) / 4
        x[::3, 1] = x[::3, 2] = x[::3].max(axis=1) + 0.25  # top-2 tied at 1 and 2
        x[1::5, :] = x[1::5, :1]                           # a whole row equal
    elif case == "empty_expert":
        x[:, 0] = -30.0                                    # expert 0: no token
    elif case == "full_expert":
        x[:, 1] = 30.0                                     # expert 1: every token
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _jax_products(params_j, logits, h, cfg_j):
    """JAX's dispatch and expert einsums (moe.py:197-208), layer 0."""
    moe = params_j["layers"][0]["moe"]
    dispatch, _, _ = jmoe.route_topk(jnp.asarray(logits), cfg_j)
    expert_in = jnp.einsum("tec,td->ecd", dispatch, jnp.asarray(h).astype(jnp.float32))
    expert_in = expert_in.astype(cfg_j.dtype)
    gate = jax.nn.silu(jnp.einsum("ecd,edf->ecf", expert_in, moe["w_gate"]).astype(jnp.float32))
    up = jnp.einsum("ecd,edf->ecf", expert_in, moe["w_up"]).astype(jnp.float32)
    act = (gate * up).astype(cfg_j.dtype)
    out = jnp.einsum("ecf,efd->ecd", act, moe["w_down"])
    return np.asarray(act), np.asarray(out)


@pytest.mark.parametrize("case,factor", [("no_drop", None), ("droppy", 1.0), ("ties", None),
                                         ("empty_expert", None), ("full_expert", None),
                                         ("full_expert", 1.0)])
def test_plain_products_are_jax_einsums_on_live_rows(tiny, case, factor):
    cfg_j, params_j, params_t = tiny
    e, k = cfg_j.n_experts, cfg_j.experts_per_token
    cfg_j = dataclasses.replace(cfg_j, capacity_factor=float(factor or e))
    t = 24
    c = cfg_j.capacity(t)
    logits = _logits(case, t, e, 5)
    h = np.random.default_rng(6).standard_normal((t, cfg_j.dim)).astype(np.float32)
    want_act, want_out = _jax_products(params_j, logits, h, cfg_j)

    moe = params_t["layers"][0]["moe"]
    _, _, _, src, counts, _ = moe_route_reference(torch.from_numpy(logits), k, c)
    act = mx.moe_gate_up_reference(torch.from_numpy(h), src, counts, moe["w_gate"], moe["w_up"])
    out = mx.moe_down_reference(act, counts, moe["w_down"])
    live = mx.live_rows(counts, c)
    assert act.shape == (e, c, cfg_j.ffn_hidden) and out.shape == (e, c, cfg_j.dim)
    for got, want in ((act, want_act), (out, want_out)):
        got_live, want_live = got[live].numpy(), want[live.numpy()]
        scale = np.abs(want_live).max()
        np.testing.assert_allclose(got_live, want_live, rtol=0, atol=F32_TOL * scale)
        assert (got[~live] == 0).all()
        # JAX's empty slots hold zero rows too
        assert (want[~live.numpy()] == 0).all()
    n = counts.clamp_max(c)
    if case == "empty_expert":
        assert counts[0] == 0 and not live[0].any()
    if case == "full_expert":
        assert counts[1] == t and int(n[1]) == min(t, c)
    if factor is not None:
        assert (counts > c).any()  # the capacity dropped some (t, k)
    else:
        assert int(live.sum()) == t * k


def _dense_block(layer, x, delta, cfg):
    """moe_mlp_block as the model ran it before the expert kernels: the
    dispatch into [E, C, D] and three torch.bmm over every capacity row."""
    b, s, d = x.shape
    x, h = ops.add_rmsnorm(x, delta, layer["mlp_norm"]["weight"], cfg.norm_eps)
    flat = h.reshape(b * s, d)
    moe = layer["moe"]
    logits = flat @ moe["w_router"]
    expert, slot, gate, src, counts, probsum = ops.moe_route(
        logits, cfg.experts_per_token, cfg.capacity(b * s))
    expert_in = moe_dispatch(flat, src)
    act = F.silu(torch.bmm(expert_in, moe["w_gate"]).float())
    up = torch.bmm(expert_in, moe["w_up"]).float()
    expert_out = torch.bmm((act * up).to(cfg.dtype), moe["w_down"])
    y = ops.moe_combine(expert_out, expert, slot, gate)
    return x, y.view(b, s, d).to(cfg.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor", [1.25, 4.0])
def test_moe_mlp_block_is_the_dense_sequence_bit_for_bit(tiny, dtype, factor):
    _, _, params_t = tiny
    cfg = dataclasses.replace(tmoe.moe_tiny(), capacity_factor=factor, dtype=dtype)
    layer = {name: {k: v.to(dtype) for k, v in sub.items()}
             for name, sub in params_t["layers"][1].items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 11, cfg.dim)).astype(np.float32)).to(dtype)
    delta = torch.from_numpy(rng.standard_normal((3, 11, cfg.dim)).astype(np.float32) * 0.1
                             ).to(dtype)
    stats = []
    got_x, got_y = tmoe.moe_mlp_block(layer, x, delta, cfg, stats)
    want_x, want_y = _dense_block(layer, x, delta, cfg)
    assert got_y.dtype == dtype and torch.equal(got_x, want_x) and torch.equal(got_y, want_y)
    assert len(stats) == 1 and stats[0][2] == 33


def test_live_rows_are_the_first_n_e_slots():
    counts = torch.tensor([0, 3, 9, 5], dtype=torch.int32)
    live = mx.live_rows(counts, 5)
    assert live.tolist() == [[False] * 5, [True] * 3 + [False] * 2, [True] * 5, [True] * 5]


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _params(text: str, entry: str) -> list:
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', text, re.S).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


def test_the_c_entries_match_their_wrappers():
    text = (CSRC / "moe_experts.cu").read_text()
    up = _params(text, "bobra_moe_gate_up")
    assert up == ["h", "src", "counts", "w_gate", "w_up", "act", "tokens", "n_experts",
                  "capacity", "d", "f", "dtype", "stream"]
    assert len(up) == len(mx._GATE_UP_ARGTYPES)
    down = _params(text, "bobra_moe_down")
    assert down == ["act", "counts", "w_down", "out", "tokens", "n_experts", "capacity", "f",
                    "d", "dtype", "stream"]
    assert len(down) == len(mx._DOWN_ARGTYPES)
    assert _constant(text, "kBK") == _constant(text, "kBoxCols") == mx.BF16_WIDTH_MULTIPLE
    # the combine keeps its parameter list through its redesign
    combine = _params((CSRC / "moe_dispatch.cu").read_text(), "bobra_moe_combine")
    assert combine == ["expert_out", "expert", "slot", "gate", "y", "tokens", "d", "top_k",
                       "capacity", "dtype", "stream"]
    assert len(combine) == len(_COMBINE_ARGTYPES)


def test_the_kernels_gather_with_cp_async_and_multiply_with_wgmma():
    text = (CSRC / "moe_experts.cu").read_text()
    wide = text[text.index("moe_wide_kernel("):text.index("struct Narrow")]
    narrow = text[text.index("moe_narrow_kernel("):text.index("moe_f32_kernel(")]
    # the dispatch folded into the A loads: 16-byte cp.async through src
    assert "attn::cp_async16(" in wide and "attn::cp_async16(" in narrow
    assert "wgmma_m64n128k16_ss<0, 1>(" in wide and "wgmma_m64n16k16_ss<1, 0>(" in narrow
    # a tile with no live row leaves before any load
    for body in (wide, narrow):
        assert body.index("return;") < body.index("tma_load_2d(")
    hopper = (CSRC / "hopper.cuh").read_text()
    for n in (128, 16):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in hopper


def test_the_entries_pick_the_route_from_the_capacity():
    """bf16 swaps the operands at C <= 16 (one 16-row instance) and takes
    128-row tiles above; both entries bound the row tiles by min(C, T)."""
    text = (CSRC / "moe_experts.cu").read_text()
    assert _constant(text, "kNarrowMaxRows") == 16 and _constant(text, "kWideRows") == 128
    launch = text[text.index("cudaError_t launch_bf16("):text.index("cudaError_t launch_f32(")]
    assert "const bool narrow = capacity <= kNarrowMaxRows;" in launch
    assert "template <bool kUp>\nstruct Narrow" in text
    for entry in ("bobra_moe_gate_up", "bobra_moe_down"):
        body = text[text.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert "const int rows = capacity < tokens ? capacity : tokens;" in body
        # declared, then passed to the fp32 and to the bf16 launch
        assert len(re.findall(r"\brows\b", body)) == 3


def _inputs(dtype=torch.bfloat16, e=4, t=6, c=12, d=64, f=128):
    h = torch.zeros((t, d), dtype=dtype)
    src = torch.full((e, c), -1, dtype=torch.int32)
    counts = torch.zeros((e,), dtype=torch.int32)
    w = torch.zeros((e, d, f), dtype=dtype)
    return h, src, counts, w, w.clone(), torch.zeros((e, f, d), dtype=dtype)


def test_the_wrappers_refuse_what_they_do_not_take():
    h, src, counts, wg, wu, wd = _inputs()
    act = torch.zeros((4, 12, 128), dtype=torch.bfloat16)
    # CPU tensors: the wrappers launch or raise, never the plain version
    with pytest.raises(ValueError, match="CUDA"):
        mx.moe_gate_up_cuda(h, src, counts, wg, wu)
    with pytest.raises(ValueError, match="CUDA"):
        mx.moe_down_cuda(act, counts, wd)
    with pytest.raises(TypeError):
        mx.moe_gate_up_cuda(h.half(), src, counts, wg.half(), wu.half())
    with pytest.raises(TypeError):
        mx.moe_down_cuda(act.double(), counts, wd.double())
    with pytest.raises(ValueError):
        mx.moe_gate_up_cuda(h, src.long(), counts, wg, wu)
    with pytest.raises(ValueError):
        mx.moe_gate_up_cuda(h, src, counts[:3], wg, wu)
    with pytest.raises(ValueError):
        mx.moe_gate_up_cuda(h[:, :32], src, counts, wg, wu)  # D differs from the weights'
    with pytest.raises(ValueError):
        mx.moe_gate_up_cuda(h, src, counts, wg, wu[:, :, :64])
    with pytest.raises(ValueError):
        mx.moe_down_cuda(act, counts.long(), wd)
    with pytest.raises(ValueError):
        mx.moe_down_cuda(act[:, :, :64], counts, wd)
    with pytest.raises(ValueError, match="tokens"):
        mx.moe_down_cuda(act, counts, wd, 0)
    # bf16 widths off 64
    h2, src2, counts2, wg2, wu2, wd2 = _inputs(d=96, f=128)
    with pytest.raises(ValueError, match="multiples of 64"):
        mx.moe_gate_up_cuda(h2, src2, counts2, wg2, wu2)
    with pytest.raises(ValueError, match="multiples of 64"):
        mx.moe_down_cuda(torch.zeros((4, 12, 128), dtype=torch.bfloat16), counts2, wd2)


def test_the_dispatchers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(4)
    e, t, k, c, d, f = 4, 10, 2, 6, 64, 128
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    _, _, _, src, counts, _ = moe_route_reference(logits, k, c)
    h = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    wg, wu = (torch.from_numpy(rng.standard_normal((e, d, f)).astype(np.float32))
              for _ in range(2))
    wd = torch.from_numpy(rng.standard_normal((e, f, d)).astype(np.float32))
    before = mx.moe_gate_up_cuda.launches, mx.moe_down_cuda.launches
    act = ops.moe_gate_up(h, src, counts, wg, wu)
    assert torch.equal(act, mx.moe_gate_up_reference(h, src, counts, wg, wu))
    assert torch.equal(ops.moe_down(act, counts, wd), mx.moe_down_reference(act, counts, wd))
    # the route's T bounds only the kernel's grid: the plain version's bits
    # do not depend on it
    assert torch.equal(ops.moe_down(act, counts, wd, t), mx.moe_down_reference(act, counts, wd))
    assert (mx.moe_gate_up_cuda.launches, mx.moe_down_cuda.launches) == before


def test_graph_replays_count_the_expert_kernels():
    from bobrapet_tpu_torch import graphs

    assert mx.moe_gate_up_cuda in graphs.COUNTED and mx.moe_down_cuda in graphs.COUNTED


def test_chip_smoke_launches_a_forward(smoke):
    assert smoke.moe_launches(1, 16) == {"moe_route": 16, "moe_dispatch": 0, "moe_gate_up": 16,
                                         "moe_down": 16, "moe_combine": 16}
    names = {name for name, _ in smoke.MOE_PORT_KERNELS}
    assert {"moe_gate_up", "moe_down"} <= names


def test_chip_smoke_expert_bounds_at_mixtral_shapes(smoke):
    d, f, e = smoke.MOE_DIM, smoke.MOE_FFN, smoke.MOE_EXPERTS
    # the greedy prefill: 1,024 tokens, 2,048 live rows over 8 experts. At
    # ~256 rows an expert the products do ~256 operations a weight byte, under
    # the card's ~295: the live experts' weights bound both (gate/up 1.88 GB
    # and 481 GFLOP: 0.581 ms against 0.486 ms at 989 TFLOP/s)
    t, rows = 1024, 2048
    flops = smoke.moe_product_flops(rows, d, f, "gate_up")
    assert flops == 2 * 2 * 2048 * 4096 * 14336 and round(flops / 1e9, 1) == 481.0
    nbytes = smoke.moe_product_bytes(t, rows, e, e, 2 * t, d, f, "gate_up", 2)
    ms, by = smoke.bound(nbytes, flops, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.5810, abs=1e-4)
    ms, by = smoke.bound(smoke.moe_product_bytes(t, rows, e, e, 2 * t, d, f, "down", 2),
                         smoke.moe_product_flops(rows, d, f, "down"), "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.3029, abs=1e-4)
    # a decode step: 16 live rows; every live expert's weights once (8 x 235
    # MB for gate/up): bounded by bytes
    live_weights = 8 * 2 * d * f * 2
    assert round(live_weights / 1e9, 3) == 1.879
    nbytes = smoke.moe_product_bytes(8, 16, 8, e, 16, d, f, "gate_up", 2)
    assert live_weights < nbytes < live_weights * 1.001
    ms, by = smoke.bound(nbytes, smoke.moe_product_flops(16, d, f, "gate_up"), "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.5610, abs=1e-3)
    # an expert with no row moves none of its weights
    assert (smoke.moe_product_bytes(8, 16, 7, e, 16, d, f, "down", 2)
            < smoke.moe_product_bytes(8, 16, 8, e, 16, d, f, "down", 2) - d * f * 2 + 1)


def test_chip_smoke_runs_only_the_routed_flops(smoke):
    cfg = smoke.moe_cfg(tmoe, smoke.MOE_LAYERS)
    run = smoke.moe_live_expert_flops(smoke.BATCH * smoke.PROMPT, cfg)
    assert run == smoke.moe_expert_flops(smoke.BATCH * smoke.PROMPT, cfg)["routed"]
    assert run / 989e12 * 1e3 == pytest.approx(11.7, abs=0.1)
    assert smoke.moe_live_expert_flops(smoke.BATCH, cfg) * 8 == pytest.approx(
        smoke.moe_expert_flops(smoke.BATCH, cfg)["dense"])


@pytest.mark.parametrize("a,b,ulps", [(1.0, 1.0, 0), (1.0, 1.0078125, 1), (-0.0, 0.0, 0),
                                      (-1.0, -1.015625, 2), (2.0 ** -133, -(2.0 ** -133), 2)])
def test_chip_smoke_counts_bf16_ulps(smoke, a, b, ulps):
    x = torch.tensor([a], dtype=torch.bfloat16)
    y = torch.tensor([b], dtype=torch.bfloat16)
    assert int(smoke.bf16_ulps(torch, x, y)[0]) == ulps
