"""The attention backward's bf16 kernels (``csrc/flash_attention_bwd.cu``).

On the CPU: the Python mirror of the kernels' persistent work order
(``ops.attention.bwd_dkdv_items``, ``bwd_dq_items``, ``bwd_block_items``)
takes every work item once, heaviest first, and the CUDA source holds the
mirror's tile constants. Pure arithmetic on shapes: these run in
milliseconds.

On the card (marked ``gpu``; the decision is taken in a fixture, never at
import): dq, dk and dv against ``flash_attention_backward_reference`` at
the train step's shapes, ragged lengths at groups 1, 4 and 8, a
``q_offset``, keys not a multiple of 64, no causal mask and head dim 32,
under phase 10b's tolerance; and two runs give the same bits. Run them on
the H100 with ``python -m pytest --noconftest -m gpu
tests/test_torch_attention_bwd.py``.

Tolerance (bf16; ``chip_smoke.TRAIN_TOL["attention_bwd", "bfloat16"]``):
the plain version computes in fp32 from the same bf16 inputs; the kernels
feed P and dS to the tensor cores as two bf16 parts (~16 bits) and sum in
another order, then round once: one bf16 ulp of |plain| (2^-7) plus 1e-2
for the cancellations of gradients of order 1-10.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

attn_ops = importlib.import_module("bobrapet_tpu_torch.ops.attention")

CSRC = Path(__file__).resolve().parents[1] / "bobrapet_tpu_torch" / "csrc"
BWD_ATOL, BWD_RTOL = 1e-2, 2.0 ** -7
H100_SMS = 132

# (b, sq, sk, hq, hkv, d, causal, q_offset)
ORDER_SHAPES = [
    (8, 512, 512, 32, 8, 128, True, 0),     # the train step
    (2, 100, 100, 32, 8, 128, True, 0),     # ragged, group 4
    (2, 77, 77, 8, 8, 128, True, 0),        # ragged, group 1
    (2, 100, 100, 64, 8, 128, True, 0),     # ragged, group 8
    (2, 96, 160, 32, 8, 128, True, 64),     # q_offset 64, Sk not a multiple of 64
    (2, 96, 200, 32, 8, 128, False, 0),     # no causal mask
    (1, 50, 50, 12, 4, 128, True, 0),       # group 3: tiles of 63 packed rows
    (1, 1, 1, 4, 1, 32, True, 0),           # one token
]


def _order_ids(shape):
    return "b{}_sq{}_sk{}_hq{}_hkv{}_d{}_{}_off{}".format(
        *shape[:6], "causal" if shape[6] else "full", shape[7])


@pytest.mark.parametrize("shape", ORDER_SHAPES, ids=_order_ids)
@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
def test_the_work_order_takes_each_item_once_heaviest_first(kernel, shape):
    b, sq, sk, hq, hkv, _, causal, q_offset = shape
    group = hq // hkv
    items = (attn_ops.bwd_dkdv_items if kernel == "dkdv" else attn_ops.bwd_dq_items)(
        b, sq, sk, hkv, group, causal, q_offset)
    keys = [k for k, _ in items]
    if kernel == "dkdv":
        n_tiles = -(-sk // attn_ops.BWD_ITEM_ROWS)
    else:
        n_tiles = -(-(sq * group) // (attn_ops.BWD_CONSUMERS * attn_ops.bwd_tile_rows(group)))
    want = {(i, h, t) for i in range(b) for h in range(hkv) for t in range(n_tiles)}
    assert len(keys) == len(set(keys)) and set(keys) == want
    work = [w for _, w in items]
    assert all(x >= y for x, y in zip(work, work[1:]))
    assert work[0] > 0
    # every block takes every item of the order at most once, and all of them together
    grid = min(len(items), H100_SMS)
    blocks = attn_ops.bwd_block_items(len(items), grid)
    taken = [i for blk in blocks for i in blk]
    assert sorted(taken) == list(range(len(items)))
    assert all(blk == sorted(blk) for blk in blocks)


@pytest.mark.parametrize("kernel", ["dkdv", "dq"])
def test_the_alternating_rounds_balance_the_train_step_at_least_as_well_as_striding(kernel):
    b, sq, sk, hq, hkv = 8, 512, 512, 32, 8
    items = (attn_ops.bwd_dkdv_items if kernel == "dkdv" else attn_ops.bwd_dq_items)(
        b, sq, sk, hkv, hq // hkv, True, 0)
    work = [w for _, w in items]
    snake = max(sum(work[i] for i in blk) for blk in attn_ops.bwd_block_items(len(work), H100_SMS))
    stride = max(sum(work[s::H100_SMS]) for s in range(H100_SMS))
    assert snake <= stride
    # within one heaviest item of a perfect split
    assert snake <= sum(work) / H100_SMS + work[0]


@pytest.mark.parametrize("group,rows", [(1, 64), (2, 64), (3, 63), (4, 64), (8, 64), (12, 60),
                                        (64, 64)])
def test_a_tile_holds_whole_queries(group, rows):
    assert attn_ops.bwd_tile_rows(group) == rows


def test_the_dkdv_items_skip_the_rows_before_the_diagonal():
    # group 4, causal, 512 queries: key tile kt of 128 keys is seen from
    # packed row 512 kt on, so it reads 32 - 8 kt tiles of 64 rows
    items = attn_ops.bwd_dkdv_items(1, 512, 512, 1, 4, True, 0)
    assert [w for _, w in items] == [32, 24, 16, 8]
    # q_offset 64: keys 0-127 are seen from the first row on, keys 128-159
    # from query 64 (packed row 256: tile 4 of 6) on
    items = attn_ops.bwd_dkdv_items(1, 96, 160, 1, 4, True, 64)
    assert [w for _, w in items] == [6, 2]
    # no mask: every key tile reads every row
    assert [w for _, w in attn_ops.bwd_dkdv_items(1, 96, 200, 1, 4, False, 0)] == [6, 6]
    # the dq items: the last row tile first, each up to its diagonal
    items = attn_ops.bwd_dq_items(1, 512, 512, 1, 4, True, 0)
    assert [k[2] for k, _ in items][:2] == [15, 14]
    assert [w for _, w in items] == [8, 8, 7, 7, 6, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1]


def _constants(text: str) -> dict:
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}


def test_the_cuda_source_holds_the_mirror_constants():
    # the tiles and the order live in the header the forward shares
    text = (CSRC / "attention_wgmma.cuh").read_text()
    assert '#include "attention_wgmma.cuh"' in (CSRC / "flash_attention_bwd.cu").read_text()
    c = _constants(text)
    assert c["kBwdWgRows"] == attn_ops.BWD_WG_ROWS
    assert c["kBwdConsumers"] == attn_ops.BWD_CONSUMERS
    assert c["kBwdTile"] == attn_ops.BWD_TILE
    assert "constexpr int kBwdItemRows = kBwdWgRows * kBwdConsumers;" in text
    # the registers the two consumers take and the producer gives back fit one SM's 64K
    assert 128 * c["kBwdProducerRegs"] + c["kBwdConsumers"] * 128 * c["kBwdConsumerRegs"] \
        <= 65536
    assert c["kBwdConsumerRegs"] % 8 == 0 and c["kBwdProducerRegs"] % 8 == 0
    # the persistent order of the mirror: alternating rounds
    assert "r * grid + ((r & 1) ? grid - 1 - blk : blk)" in text


def test_the_bf16_kernels_are_warp_specialised_wgmma_fed_by_tma():
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for kernel, nxt in (("flash_bwd_dkdv_kernel(", "flash_bwd_dq_kernel("),
                        ("flash_bwd_dq_kernel(", "static int bwd_parts")):
        body = text[text.index(kernel):text.index(nxt)]
        assert "setmaxnreg_dec<kBwdProducerRegs>" in body
        assert "setmaxnreg_inc<kBwdConsumerRegs>" in body
        assert "tma_load_4d(" in body and "mbar_expect_tx(" in body
        assert "two_score_products<D>(" in body and "accumulate_rs<D, PARTS>(" in body
        assert "mma_bf16(" not in body and "cp_async16(" not in body
    hopper = (CSRC / "hopper.cuh").read_text()
    for shape in ("m64n64k16", "m64n32k16", "m64n128k16"):
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.bf16.bf16" in hopper
    assert "cp.async.bulk.tensor.4d" in hopper


def test_the_c_entry_keeps_its_parameters_and_the_switches_are_their_own():
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    sig = re.search(r'extern "C" int bobra_flash_attention_backward\((.*?)\)', text,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params == ["q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv", "b", "sq",
                      "sk", "hq", "group", "d", "causal", "q_offset", "scale", "dtype",
                      "stream"]
    assert len(params) == len(attn_ops._BWD_ARGTYPES)
    assert re.search(r'extern "C" int bobra_flash_attention_backward_parts\(int parts\)', text)
    assert re.search(r'extern "C" int bobra_flash_attention_backward_launches\(int mask\)', text)
    # two parts and all three launches unless a measurement sets otherwise
    assert "static int bwd_parts = 2;" in text and "static int bwd_launches = 7;" in text


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_attention_bwd.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


CARD_CASES = [
    # (b, sq, sk, hq, hkv, d, causal, q_offset)
    (8, 512, 512, 32, 8, 128, True, 0),     # the train step
    (2, 100, 100, 8, 8, 128, True, 0),      # ragged S 100, group 1
    (2, 100, 100, 32, 8, 128, True, 0),     # group 4
    (2, 100, 100, 64, 8, 128, True, 0),     # group 8
    (2, 77, 77, 8, 8, 128, True, 0),        # ragged S 77, group 1
    (2, 77, 77, 32, 8, 128, True, 0),       # group 4
    (2, 77, 77, 64, 8, 128, True, 0),       # group 8
    (2, 96, 160, 32, 8, 128, True, 64),     # q_offset 64 (a prefix), Sk 160
    (2, 100, 164, 32, 8, 128, True, 64),    # q_offset, ragged Sq and Sk
    (1, 128, 200, 32, 8, 128, False, 0),    # no causal mask, Sk 200
    (2, 77, 77, 32, 8, 32, True, 0),        # head dim 32
    (1, 50, 50, 12, 4, 128, True, 0),       # group 3: tiles of 63 packed rows
]


def _inputs(case, device, seed=7):
    b, sq, sk, hq, hkv, d, causal, q_offset = case
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    q, k, v, do = randn(b, sq, hq, d), randn(b, sk, hkv, d), randn(b, sk, hkv, d), \
        randn(b, sq, hq, d)
    o, lse = attn_ops.flash_attention_lse_reference(q, k, v, causal=causal, q_offset=q_offset)
    return q, k, v, o.contiguous(), do, lse


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=_order_ids)
def test_the_bf16_backward_matches_plain(cuda, case):
    causal, q_offset = case[6], case[7]
    q, k, v, o, do, lse = _inputs(case, cuda)
    got = attn_ops.flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal,
                                                 q_offset=q_offset)
    torch.cuda.synchronize()
    want = attn_ops.flash_attention_backward_reference(q, k, v, o, do, lse, causal=causal,
                                                       q_offset=q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), name
        excess = float(((g - w).abs() - BWD_RTOL * w.abs()).max())
        assert excess <= BWD_ATOL, (name, excess)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [CARD_CASES[0], CARD_CASES[3], CARD_CASES[7], CARD_CASES[10]],
                         ids=_order_ids)
def test_the_bf16_backward_gives_the_same_bits_twice(cuda, case):
    causal, q_offset = case[6], case[7]
    q, k, v, o, do, lse = _inputs(case, cuda, seed=11)
    first = attn_ops.flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal,
                                                   q_offset=q_offset)
    # another allocation of the outputs and scratch between the runs
    pad = torch.empty(1 << 20, dtype=torch.uint8, device=cuda)
    again = attn_ops.flash_attention_backward_cuda(q, k, v, o, do, lse, causal=causal,
                                                   q_offset=q_offset)
    torch.cuda.synchronize()
    del pad
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_the_bf16_backward_refuses_a_group_above_64(cuda):
    q = torch.zeros((1, 4, 128, 32), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 4, 1, 32), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((1, 128, 4), dtype=torch.float32, device=cuda)
    with pytest.raises(Exception, match="flash_attention_backward"):
        attn_ops.flash_attention_backward_cuda(q, k, k, q, q, lse)


def test_the_ab_tool_imports_no_jax_and_each_variant_changes_the_source():
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    text = (root / "attention_bwd_ab.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|bobrapet_tpu)\b", text, re.M)
    spec = importlib.util.spec_from_file_location("attention_bwd_ab", root / "attention_bwd_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    source = (CSRC / ab.SOURCE).read_text()
    assert ab.variant_source("base", source) == source
    for name in ab.VARIANTS:
        if name != "base":
            assert ab.variant_source(name, source) != source, name
