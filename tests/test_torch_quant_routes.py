"""The int8 product's routes (ops/quant_matmul.py, csrc/quant_matmul.cu).

On the CPU: the route, tile and raster rules the host applies, the C
entry's signature and constants against the Python side, and the launch
and bound arithmetic chip_smoke.py holds the main path to. Marked ``gpu``
(skipped without a card, decided in a fixture): each route against the
plain version at its boundary rows, ragged K and N, folded batch
dimensions, fp32, the route counts, the same bits twice, and a graphed
greedy decode over an int8 tiny model equal to the eager one (which holds
programmatic dependent launch under CUDA-graph capture). Run those on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_quant_routes.py``.

Tolerances (gpu): bf16 rounds the product to bf16, then the scale product
again, and a sum in another order may move the first rounding by one ulp:
2^-6 of |plain| plus 1e-4 of the largest |plain|; fp32 1e-5 of the largest
|plain| (TF32 would miss by ~1e-3).
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from bobrapet_tpu_torch.kernels import KERNEL_DTYPES, check_launch, kernel_function, launch
from bobrapet_tpu_torch.models import llama, quant
from bobrapet_tpu_torch.ops import quant_matmul as qm

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "bobrapet_tpu_torch" / "csrc"
#: (K, N) of the five int8 products of a Llama-3-8B forward
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# CPU: the rules


@pytest.mark.parametrize("m,n,route", [
    (1, 128256, "D"), (8, 14336, "D"), (32, 14336, "D"),     # up to 32 rows: the stream
    (33, 14336, "P"), (64, 14336, "P"), (128, 128256, "P"),  # 56 / 501 tiles are enough
    (64, 4096, "D"), (128, 4096, "D"), (64, 1024, "D"),      # 16 / 4 tiles are not
    (128, 13312, "D"), (128, 13568, "P"),                    # 52 and 53 tiles: 0.4 of 132 SMs
    (129, 1024, "P"), (1024, 4096, "P"),                     # above 128 rows: always P
])
def test_bf16_route_by_rows_and_tiles(m, n, route):
    assert qm.quant_route(m, n, torch.bfloat16) == route
    assert qm.quant_route(m, n, torch.float32) == "F"  # fp32 always takes the exact route


def test_the_crossover_at_the_8b_shapes():
    # the int8 greedy prefill (8 x 128 rows) multiplies on route P, its decode
    # steps (8 rows) stream on route D; a draft catch-up at H = 8 over 8
    # slots (64 rows) streams wq/wo, wk/wv and w_down and multiplies
    # w_gate/w_up and the LM head
    assert (qm.QMM_DECODE_ROWS, qm.QMM_CROSSOVER) == (32, 128)
    assert {qm.quant_route(1024, n, torch.bfloat16) for _, n in SHAPES_8B} == {"P"}
    assert {qm.quant_route(8, n, torch.bfloat16) for _, n in SHAPES_8B} == {"D"}
    assert [qm.quant_route(64, n, torch.bfloat16) for _, n in SHAPES_8B] == [
        "D", "D", "P", "D", "P"]
    # on a card with more SMs the same product may stay on route D
    assert qm.quant_route(64, 14336, torch.bfloat16, sms=160) == "D"


@pytest.mark.parametrize("m,rows", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (40, 32),
                                    (64, 32)])
def test_decode_rows_pad_no_decode_step(m, rows):
    assert qm.decode_rows(m) == rows


def test_decode_grid_at_the_8b_shapes():
    # (cluster split, row tiles, column tiles of 128): the split is
    # quant_splits', unchanged
    got = [qm.decode_grid(8, n, k) for k, n in SHAPES_8B]
    assert got == [(4, 1, 32), (8, 1, 8), (2, 1, 112), (4, 1, 32), (1, 1, 1002)]
    assert [qm.quant_splits(8, n, k) for k, n in SHAPES_8B] == [g[0] for g in got]
    # a catch-up's 64 rows: two row tiles of 32 next to each other on the grid
    assert qm.decode_grid(64, 4096, 4096) == (2, 2, 32)
    assert qm.decode_grid(40, 14336, 4096) == (1, 2, 112)


def test_prefill_grid_puts_the_row_tiles_first():
    # M = 1024: 8 row tiles of 128 share each column tile's int8 weight
    assert qm.prefill_grid(1024, 14336) == (8, 56)
    assert qm.prefill_grid(1024, 128256) == (8, 501)
    assert qm.prefill_grid(200, 208) == (2, 2)
    assert (qm.PREFILL_BM, qm.PREFILL_COLS) == (128, 128)


@pytest.mark.parametrize("m,n,tile", [
    (1024, 14336, 256), (1024, 4096, 256), (1024, 128256, 256), (64, 128256, 256),
    (1024, 1024, 128),   # 32 tiles of 256 would leave most SMs idle: 64 of 128
    (128, 14336, 128),   # the 128-row bucket: 112 tiles of 128 against 56
    (65, 4096, 128), (264, 5888, 256), (264, 5632, 128),  # 69 and 66 tiles of 256
])
def test_prefill_tile_fills_the_card(m, n, tile):
    assert qm.prefill_tile(m, n) == tile
    assert qm.prefill_grid(m, n)[1] == -(-n // tile)


@pytest.mark.parametrize("m,n,k,splits", [
    (8, 4096, 4096, 8),        # wq/wo at the cross-check: 16 blocks split 8 ways
    (8, 1024, 4096, 8),
    (8, 128256, 4096, 1),      # 501 blocks fill the card alone
    (40, 4096, 4096, 2),
    (1024, 4096, 4096, 1),
    (8, 4096, 256, 1),         # two chunks of 128 K rows: no split
    (8, 4096, 1024, 4),        # 8 chunks: each of 4 blocks keeps two
])
def test_f32_splits(m, n, k, splits):
    assert qm.f32_splits(m, n, k) == splits


def test_route_args():
    assert qm.route_args("D", 8, 4096, 4096) == (4, 8)
    assert qm.route_args("D", 40, 4096, 4096) == (qm.quant_splits(40, 4096, 4096), 32)
    assert qm.route_args("P", 1024, 4096, 4096) == (1, 256)
    assert qm.route_args("P", 128, 14336, 4096) == (1, 128)
    assert qm.route_args("F", 8, 4096, 4096) == (8, 0)


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_cuda_source_holds_the_same_constants():
    text = (CSRC / "quant_matmul.cu").read_text()
    assert {r: _constant(text, f"kRoute{r}") for r in "FDP"} == qm.ROUTE_CODES
    assert _constant(text, "kFlagPdl") == qm.FLAG_PDL
    assert _constant(text, "kDCols") == qm.QMM_BN
    assert _constant(text, "kMaxSplits") == qm.QMM_MAX_SPLITS
    tile = re.search(r"constexpr int kPBM = (\d+), kPBK = (\d+);", text)
    assert int(tile.group(1)) == qm.PREFILL_BM and _constant(text, "kPQBox") == qm.PREFILL_COLS
    assert _constant(text, "kFRows") == qm.F32_ROWS
    assert _constant(text, "kFChunk") == qm.F32_CHUNK
    assert _constant(text, "kFColThreads") * 16 == qm.F32_COLS


def test_the_c_entry_takes_route_splits_tile_and_flags():
    text = (CSRC / "quant_matmul.cu").read_text()
    sig = re.search(r'extern "C" int bobra_quant_matmul\((.*?)\)', text, re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert len(params) == len(qm._ARGTYPES)
    assert params == ["x", "q", "scale", "out", "m", "n", "k", "route", "splits", "tile",
                      "flags", "dtype", "stream"]


def test_route_d_writes_no_widened_weight_and_route_p_uses_wgmma():
    text = (CSRC / "quant_matmul.cu").read_text()
    decode = text[text.index("quant_decode_kernel("):text.index("quant_prefill_kernel(")]
    # route D: the weight goes from the TMA ring into registers, and the only
    # shared-memory stores are the fp32 partials after the K loop
    loop = decode[:decode.index("__syncthreads();  // every stage is consumed")]
    assert "mma_bf16(" in loop and "widen_pairs(" in loop
    assert not re.search(r"\*reinterpret_cast<uint4\*>\(", loop)
    prefill = text[text.index("quant_prefill_kernel("):text.index("quant_f32_kernel(")]
    assert "wgmma_m64n128k16_rs(" in prefill and "mma_bf16(" not in prefill
    # route P widens into wgmma's A registers: no 16-byte store to shared memory
    assert not re.search(r"\*reinterpret_cast<uint4\*>\(", prefill)
    hopper = (CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in hopper


def test_int8_greedy_leg_launches(smoke):
    got = smoke.int8_launches(32)
    assert got == {"rmsnorm": 65 * 65, "add_rmsnorm": 65 * 64, "flash_attention": 65 * 32,
                   "cached_attention": 64 * 32, "paged_attention": 0, "pick_tokens": 65,
                   "quant_matmul": 65 * 225, "routes": {"D": 64 * 225, "P": 225, "F": 0}}
    # the prefill's products run on route P, the decode steps' on route D
    for _, n in SHAPES_8B:
        assert qm.quant_route(smoke.BATCH * smoke.PROMPT, n, torch.bfloat16) == "P"
        assert qm.quant_route(smoke.BATCH, n, torch.bfloat16) == "D"
    # phase 6's int8 hold: 8 x 24 rows, above the crossover at every width
    assert smoke.BATCH * smoke.INT8_CHECK_TOKENS > qm.QMM_CROSSOVER


def test_phase_3_cases_cover_every_route(smoke):
    names = [c[0] for c in smoke.QUANT_CASES]
    assert names[:5] == ["quant wq/wo decode", "quant wk/wv decode",
                         "quant w_gate/w_up decode", "quant w_down decode",
                         "quant lm_head decode"]
    def routes(cases):
        return [qm.quant_route(m, n, torch.bfloat16) for _, m, _, n in cases]

    assert set(routes(smoke.QUANT_CASES[:5])) == {"D"}
    assert routes(smoke.QUANT_CASES[5:]) == ["P"]  # the 128-row bucket of w_gate
    assert routes(smoke.QUANT_CATCHUP_CASES) == ["D", "D", "P"]
    assert [(m, k, n) for _, m, k, n in smoke.QUANT_PREFILL_CASES] == [
        (1024, k, n) for k, n in SHAPES_8B]
    assert set(routes(smoke.QUANT_PREFILL_CASES)) == {"P"}


@pytest.mark.parametrize("k,n,by", [(4096, 14336, "operations"), (4096, 128256, "operations"),
                                    (14336, 4096, "operations"), (4096, 1024, "operations")])
def test_prefill_bounds_are_the_flops(smoke, k, n, by):
    # M = 1024: 2 M K N operations at 989 TFLOP/s exceed the bytes at 3.35 TB/s
    ms, got = smoke.bound(smoke.quant_bytes(1024, k, n, 2), 2 * 1024 * k * n, "bfloat16")
    assert got == by and ms == pytest.approx(2 * 1024 * k * n / 989e12 * 1e3)


def test_catch_up_and_decode_bounds_are_the_bytes(smoke):
    ms, by = smoke.bound(smoke.quant_bytes(64, 4096, 4096, 2), 2 * 64 * 4096 * 4096, "bfloat16")
    assert by == "bytes" and round(ms * 1e3, 2) == 5.32
    # the int8 decode step's products: 2.25 ms at 3.35 TB/s
    assert round(smoke.int8_step_bound_ms(32), 2) == 2.25


def test_int8_prefill_flops(smoke):
    # the int8 greedy prefill: 32 layers of 7 products and the head at 1024
    # rows, ~15.4 TFLOP, ~15.5 ms at 989 TFLOP/s
    per = {c[0].split()[1]: 2 * c[1] * c[2] * c[3] for c in smoke.QUANT_PREFILL_CASES}
    total = 32 * (2 * per["wq/wo"] + 2 * per["wk/wv"] + 2 * per["w_gate/w_up"]
                  + per["w_down"]) + per["lm_head"]
    assert round(total / 1e12, 1) == 15.4 and round(total / 989e12 * 1e3, 1) == 15.5


def test_graphed_step_keeps_the_collector_off_while_capturing(monkeypatch):
    """A captured graph held only by a reference cycle (a decoder's step
    holds its bound method) and freed by the garbage collector during
    another capture ends that capture; GraphedStep captures with automatic
    collection off, restores it after, and replays the route counts. The
    card's stream and graph objects are stood in for on the CPU."""
    import contextlib
    import gc

    from bobrapet_tpu_torch import graphs

    seen = []

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def capture(graph, capture_error_mode):
        seen.append(gc.isenabled())
        yield

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)

    def fn(x):
        qm.quant_matmul_cuda.launches += 1
        qm.quant_matmul_cuda.routes["D"] += 1
        return x

    step = graphs.GraphedStep(fn, torch.zeros(1, device="meta"))
    step.graphed = True
    launches, routes = qm.quant_matmul_cuda.launches, dict(qm.quant_matmul_cuda.routes)
    assert gc.isenabled()
    step()   # the eager warm-up (counted) and the capture (taken back)
    step()   # a replay adds the capture's counts
    assert seen == [False] and gc.isenabled()
    assert qm.quant_matmul_cuda.launches - launches == 2
    assert qm.quant_matmul_cuda.routes["D"] - routes["D"] == 2


# ---------------------------------------------------------------------------
# the card

BOUNDARY_ROWS = [1, 8, 9, 16, 17, 40, 63, 64, 65, 128, 1024]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_quant_routes.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _leaf(k, n, dtype, device, seed):
    return quant.quantize_array(_randn((k, n), dtype, device, seed) * (1.0 / 64))


def _close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    big = float(ref.abs().max())
    if dtype == torch.bfloat16:
        bound = 1e-4 * big + 2.0 ** -6 * ref.abs()
    else:
        bound = torch.full_like(ref, 1e-5 * big)
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())


def _forced(x, leaf, route, splits, tile):
    """The C entry on one route, bypassing the wrapper's rules."""
    m, k = x.shape
    n = leaf["q"].shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = kernel_function("bobra_quant_matmul", qm._ARGTYPES)
    err = launch(fn, x.device.index or 0, x.data_ptr(), leaf["q"].data_ptr(),
                 leaf["scale"].data_ptr(), out.data_ptr(), m, n, k, qm.ROUTE_CODES[route],
                 splits, tile, qm.FLAG_PDL, KERNEL_DTYPES[x.dtype])
    check_launch("quant_matmul", err)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("m", BOUNDARY_ROWS)
def test_each_route_at_its_boundary_rows(cuda, m):
    k, n = 1024, 1536
    leaf = _leaf(k, n, torch.bfloat16, cuda, 40)
    x = _randn((m, k), torch.bfloat16, cuda, 41)
    ref = qm.quant_matmul_reference(x, leaf["q"], leaf["scale"])
    route = qm.quant_route(m, n, torch.bfloat16, qm._sm_count(0))
    before = dict(qm.quant_matmul_cuda.routes)
    out = qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"])
    torch.cuda.synchronize()
    assert qm.quant_matmul_cuda.routes[route] == before[route] + 1
    _close(out, ref, torch.bfloat16)
    # both bf16 routes, forced, agree with the plain version at every row count
    for splits in (1, qm.quant_splits(m, n, k), 8):
        _close(_forced(x, leaf, "D", splits, qm.decode_rows(m)), ref, torch.bfloat16)
    for tile in (128, 256):
        _close(_forced(x, leaf, "P", 1, tile), ref, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("kn", [(80, 208), (1040, 144), (48, 80), (4112, 1040)], ids=str)
@pytest.mark.parametrize("m", [3, 8, 40, 200])
def test_ragged_k_and_n(cuda, kn, m):
    # K and N multiples of 16 but not of the 64-row stages or 128-column tiles
    k, n = kn
    leaf = _leaf(k, n, torch.bfloat16, cuda, 42)
    x = _randn((m, k), torch.bfloat16, cuda, 43)
    ref = qm.quant_matmul_reference(x, leaf["q"], leaf["scale"])
    _close(qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"]), ref, torch.bfloat16)
    _close(_forced(x, leaf, "D", 2, qm.decode_rows(m)), ref, torch.bfloat16)
    for tile in (128, 256):
        _close(_forced(x, leaf, "P", 1, tile), ref, torch.bfloat16)
    xf = x.float()
    leaf_f = {"q": leaf["q"], "scale": leaf["scale"].float()}
    _close(qm.quant_matmul_cuda(xf, leaf_f["q"], leaf_f["scale"]),
           qm.quant_matmul_reference(xf, leaf_f["q"], leaf_f["scale"]), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 512), (4, 50, 512), (1, 1, 1, 512)], ids=str)
def test_batch_dimensions_fold_into_rows(cuda, shape):
    leaf = _leaf(512, 384, torch.bfloat16, cuda, 44)
    x = _randn(shape, torch.bfloat16, cuda, 45)
    out = qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"])
    assert out.shape == (*shape[:-1], 384)
    _close(out, qm.quant_matmul_reference(x, leaf["q"], leaf["scale"]), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("kn", [(4096, 4096), (512, 208)], ids=str)
def test_fp32_route(cuda, m, kn):
    k, n = kn
    leaf = _leaf(k, n, torch.float32, cuda, 46)
    x = _randn((m, k), torch.float32, cuda, 47)
    before = qm.quant_matmul_cuda.routes["F"]
    out = qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"])
    torch.cuda.synchronize()
    assert qm.quant_matmul_cuda.routes["F"] == before + 1
    _close(out, qm.quant_matmul_reference(x, leaf["q"], leaf["scale"]), torch.float32)
    assert torch.equal(qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"]), out)


@pytest.mark.gpu
def test_route_counts_and_one_launch_a_call(cuda):
    leaf = _leaf(512, 256, torch.bfloat16, cuda, 48)
    leaf_f = {"q": leaf["q"], "scale": leaf["scale"].float()}
    launches, routes = qm.quant_matmul_cuda.launches, dict(qm.quant_matmul_cuda.routes)
    for m in (8, 32, 129, 1024):
        qm.quant_matmul_cuda(_randn((m, 512), torch.bfloat16, cuda, m), leaf["q"], leaf["scale"])
    qm.quant_matmul_cuda(_randn((8, 512), torch.float32, cuda, 1), leaf_f["q"], leaf_f["scale"])
    torch.cuda.synchronize()
    assert qm.quant_matmul_cuda.launches == launches + 5
    assert {r: qm.quant_matmul_cuda.routes[r] - routes[r] for r in routes} == {
        "D": 2, "P": 2, "F": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 64, 128, 1024])
def test_same_bits_twice(cuda, m):
    # twenty calls: a race between the rings' loads and their refills
    # shows as a rare differing run
    k, n = SHAPES_8B[2]
    leaf = _leaf(k, n, torch.bfloat16, cuda, 49)
    x = _randn((m, k), torch.bfloat16, cuda, 50)
    out = qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"])
    for _ in range(20):
        assert torch.equal(qm.quant_matmul_cuda(x, leaf["q"], leaf["scale"]), out)


@pytest.mark.gpu
@pytest.mark.parametrize("pdl", [True, False])
def test_graphed_int8_greedy_equals_eager(cuda, pdl):
    """A bf16 int8 tiny model: the prefill's products on route P (8 x 80
    rows), every decode step's on route D; the CUDA-graphed decode (the
    products captured with programmatic dependent launch, or without) gives
    the eager tokens."""
    cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.bfloat16)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    qparams = quant.quantize_params(params)
    prompt = torch.randint(0, cfg.vocab_size, (8, 80), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    old = qm.quant_matmul_cuda.pdl
    qm.quant_matmul_cuda.pdl = pdl
    try:
        runs = {}
        for graph in (False, True):
            routes = dict(qm.quant_matmul_cuda.routes)
            runs[graph] = llama.greedy_generate(qparams, prompt, cfg, max_new_tokens=12,
                                                cuda_graph=graph)
            torch.cuda.synchronize()
            per = 7 * cfg.n_layers + 1
            assert {r: qm.quant_matmul_cuda.routes[r] - routes[r] for r in routes} == {
                "D": 12 * per, "P": per, "F": 0}
    finally:
        qm.quant_matmul_cuda.pdl = old
    assert torch.equal(runs[True], runs[False])
