"""The train step's log-sum-exp attention forward (``bobra_flash_attention_lse``
in ``csrc/flash_attention.cu``; ``ops.flash_attention_lse_cuda`` and its
plain version ``ops.flash_attention_lse_reference``), on the CPU.

(a) The plain version against the JAX package at the bf16 kernel's edge
cases (group sizes, ragged lengths, a ``q_offset``, no causal mask, head
dim 32, one token): the output against the Pallas kernel in interpret mode
where its blocks divide the lengths, else against JAX's
``attention_reference``; each row's log-sum-exp against
``jax.nn.logsumexp`` of JAX's scaled, masked scores. Inputs from numpy with
a seed, in fp32; both sides compute in fp32 and differ only in the order
of their sums: within 1e-5.

(b) The CUDA source, read as text: the bf16 forward is a warp-specialised,
TMA-fed wgmma kernel with the dq kernel's work order and constants, the
serving entry's rows kernel keeps no log-sum-exp branch, and the C entry
keeps the parameters the wrapper declares. The wrapper refuses a GQA group
above 64 in bf16 before it looks for a card.

The kernel itself is held on the card by ``tests/test_torch_kernels.py``
(``-m gpu``) and by ``chip_smoke.py`` phase 10b.
"""

import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bobrapet_tpu.ops.attention import NEG_INF as JNEG_INF
from bobrapet_tpu.ops.attention import attention_reference as jattention_reference
from bobrapet_tpu.ops.attention import flash_attention as jflash_attention

# the module (bobrapet_tpu_torch.ops exports a function of the same name)
attn_ops = importlib.import_module("bobrapet_tpu_torch.ops.attention")

CSRC = Path(__file__).resolve().parents[1] / "bobrapet_tpu_torch" / "csrc"
TOL = 1e-5

# (name, b, sq, sk, hq, hkv, d, causal, q_offset)
CASES = [
    ("S256_group1", 1, 256, 256, 2, 2, 128, True, 0),
    ("S256_group4", 1, 256, 256, 8, 2, 128, True, 0),
    ("S256_group8", 1, 256, 256, 8, 1, 128, True, 0),
    ("ragged_S100", 2, 100, 100, 8, 2, 128, True, 0),
    ("ragged_S77", 2, 77, 77, 4, 4, 128, True, 0),
    ("q_offset64_Sk164", 2, 100, 164, 8, 2, 128, True, 64),
    ("no_mask_Sk200", 1, 128, 200, 8, 2, 128, False, 0),
    ("head_dim32", 2, 100, 100, 8, 2, 32, True, 0),
    ("one_token", 1, 1, 1, 4, 1, 32, True, 0),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test worker: under six workers the default
    thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(case, seed=0):
    _, b, sq, sk, hq, hkv, d, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


def _jax_output(q, k, v, causal, q_offset):
    """The Pallas kernel (interpret mode) where it applies: no offset, and
    blocks of 128 or the whole length dividing both lengths; JAX's
    reference otherwise."""
    sq, sk = q.shape[1], k.shape[1]
    bq, bk = min(128, sq), min(128, sk)
    if q_offset == 0 and (sq == sk or not causal) and sq % bq == 0 and sk % bk == 0:
        return jflash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=bq,
                                block_k=bk, interpret=True)
    return jattention_reference(*map(jnp.asarray, (q, k, v)), causal=causal, q_offset=q_offset)


def _jax_lse(q, k, causal, q_offset):
    """jax.nn.logsumexp over the keys of JAX's scaled scores, causally
    masked with NEG_INF as attention_reference masks them: [B, Hq, Sq]."""
    _, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = jnp.asarray(q) * (1.0 / math.sqrt(d))
    kf = jnp.repeat(jnp.asarray(k), hq // hkv, axis=2)
    scores = jnp.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        mask = (q_offset + jnp.arange(sq))[:, None] >= jnp.arange(sk)[None, :]
        scores = jnp.where(mask[None, None], scores, JNEG_INF)
    return jax.nn.logsumexp(scores, axis=-1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_plain_output_matches_jax(case):
    causal, q_offset = case[7], case[8]
    q, k, v = _inputs(case)
    out, _ = attn_ops.flash_attention_lse_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=q_offset)
    want = np.asarray(_jax_output(q, k, v, causal, q_offset))
    assert out.dtype == torch.float32 and out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_plain_lse_matches_jax(case):
    causal, q_offset = case[7], case[8]
    q, k, v = _inputs(case, seed=1)
    _, lse = attn_ops.flash_attention_lse_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=q_offset)
    want = np.asarray(_jax_lse(q, k, causal, q_offset))
    b, sq, hq = q.shape[:3]
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, hq, sq) == want.shape
    np.testing.assert_allclose(lse.numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the CUDA source


def _body(text: str, start: str, end: str) -> str:
    return text[text.index(start):text.index(end, text.index(start))]


def _constants(text: str) -> dict:
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}


def test_the_bf16_forward_is_warp_specialised_tma_fed_and_uses_wgmma():
    text = (CSRC / "flash_attention.cu").read_text()
    body = _body(text, "flash_fwd_lse_kernel(const __grid_constant__", "\n}\n")
    assert "setmaxnreg_dec<kBwdProducerRegs>" in body
    assert "setmaxnreg_inc<kBwdConsumerRegs>" in body
    assert "tma_load_4d(" in body and "mbar_expect_tx(" in body and "mbar_wait(" in body
    assert "issue_scores<D>(" in body and "issue_pv<D>(" in body
    assert "cp_async16(" not in body and "mma_bf16(" not in body and "ldmatrix" not in body
    # the two products are wgmma: scores from shared memory, P V with P in registers
    scores = _body(text, "issue_scores(float", "\n}\n")
    pv = _body(text, "issue_pv(float", "\n}\n")
    assert "mma_ss(" in scores and "wgmma_commit()" in scores
    assert "accumulate_rs<D, 2>(" in pv and "wgmma_commit()" in pv
    shared = (CSRC / "attention_wgmma.cuh").read_text()
    assert "wgmma_m64n64k16_ss" in shared and "wgmma_m64n128k16_rs_tb<1>" in shared
    assert "wgmma_m64n32k16_rs_tb<1>" in shared


def test_the_bf16_entry_launches_only_the_new_kernel():
    text = (CSRC / "flash_attention.cu").read_text()
    launch = _body(text, "int launch_flash_lse_bf16(", "\n}\n")
    assert re.findall(r"(\w+)<D><<<", launch) == ["flash_fwd_lse_kernel"]
    entry = _body(text, 'extern "C" int bobra_flash_attention_lse(', "\n}\n")
    assert "attn::launch_flash_lse_bf16<32>(" in entry
    assert "attn::launch_flash_lse_bf16<128>(" in entry
    assert "launch_rows" not in entry and "launch_flash_bf16" not in entry
    # a group above 64 is refused, as the backward's entry refuses it
    assert "group > attn::kBwdTile" in entry


def test_the_rows_kernel_keeps_no_lse_branch():
    text = (CSRC / "flash_attention.cu").read_text()
    assert "kLse" not in _body(text, "namespace attn {", "// bf16 training forward")
    rows = _body(text, "flash_rows_kernel(const DensePolicy<D> P", "\n}\n")
    assert not re.search(r"\blse\b", rows)
    assert "flash_rows_kernel(const DensePolicy<D> P) {" in text
    launch = _body(text, "int launch_rows(", "\n}\n")
    assert not re.search(r"\blse\b", launch)


def test_the_c_entry_keeps_its_parameters():
    text = (CSRC / "flash_attention.cu").read_text()
    sig = re.search(r'extern "C" int bobra_flash_attention_lse\((.*?)\)', text, re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params == ["q", "k", "v", "o", "lse", "b", "sq", "sk", "hq", "group", "d", "q_sb",
                      "q_ss", "k_sb", "k_ss", "v_sb", "v_ss", "o_sb", "o_ss", "causal",
                      "q_offset", "scale", "dtype", "stream"]
    assert len(params) == len(attn_ops._LSE_ARGTYPES)


def test_the_forward_takes_the_dq_kernels_order_and_tiles():
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    f_body = _body(fwd, "flash_fwd_lse_kernel(const __grid_constant__", "\n}\n")
    q_body = _body(bwd, "flash_bwd_dq_kernel(const __grid_constant__", "\n}\n")
    # the item of round r, its row tile heaviest first, and the keys it sees
    for line in ("const int item = bwd_item(r, items);",
                 "const int row0 = (n_rt - 1 - item / bh) * item_rows, b = item % bh / hkv, "
                 "h = item % hkv;",
                 "const int item_rows = kBwdConsumers * tile_rows;",
                 "const int items = n_rt * bh;"):
        assert line in f_body and line in q_body, line
    assert "kBwdTile / A.group * A.group" in f_body
    assert "kBwdTile / S.group * S.group" in q_body
    # the mirror's constants, in the header both kernels include
    c = _constants((CSRC / "attention_wgmma.cuh").read_text())
    assert (c["kBwdWgRows"], c["kBwdConsumers"], c["kBwdTile"]) == (
        attn_ops.BWD_WG_ROWS, attn_ops.BWD_CONSUMERS, attn_ops.BWD_TILE)
    assert '#include "attention_wgmma.cuh"' in fwd
    # a persistent grid of one block an SM, or one an item
    assert "hopper::sm_count()" in _body(fwd, "int launch_flash_lse_bf16(", "\n}\n")


@pytest.mark.parametrize("shape", [(8, 512, 512, 8, 4, True, 0), (2, 100, 164, 8, 4, True, 64),
                                   (1, 50, 50, 4, 3, True, 0), (1, 128, 200, 8, 4, False, 0)])
def test_the_forward_order_covers_every_row_once(shape):
    """The forward's items are the dq kernel's (bwd_dq_items): every packed
    row of every (batch, kv head) in exactly one item, heaviest first."""
    b, sq, sk, hkv, group, causal, q_offset = shape
    items = attn_ops.bwd_dq_items(b, sq, sk, hkv, group, causal, q_offset)
    item_rows = attn_ops.BWD_CONSUMERS * attn_ops.bwd_tile_rows(group)
    covered = {}
    for (bi, h, rt), tiles in items:
        rows = range(rt * item_rows, min(sq * group, (rt + 1) * item_rows))
        for r in rows:
            covered[(bi, h, r)] = covered.get((bi, h, r), 0) + 1
        # an item reads the key tiles up to its last row's diagonal
        last = rows[-1]
        assert tiles == -(-(min(sk, q_offset + last // group + 1) if causal else sk) // 64)
    assert set(covered.values()) == {1}
    assert len(covered) == b * hkv * sq * group
    work = [w for _, w in items]
    assert work == sorted(work, reverse=True)
    blocks = attn_ops.bwd_block_items(len(items), min(len(items), 132))
    assert sorted(i for blk in blocks for i in blk) == list(range(len(items)))


def test_the_wrapper_refuses_a_group_above_64_in_bf16_before_the_device():
    q = torch.zeros((1, 2, 65, 32), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 1, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="group of 65 heads is above 64"):
        attn_ops.flash_attention_lse_cuda(q, k, k)
    # 64 passes the check and stops at the device
    q64 = torch.zeros((1, 2, 64, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs every tensor on one CUDA device"):
        attn_ops.flash_attention_lse_cuda(q64, k, k)
    # fp32 takes the scalar kernel, which takes any group
    with pytest.raises(ValueError, match="needs every tensor on one CUDA device"):
        attn_ops.flash_attention_lse_cuda(q.float(), k.float(), k.float())


def _load(path: Path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_ab_tool_builds_each_forward_variant_from_the_source():
    root = Path(__file__).resolve().parents[1]
    ab = _load(root / "attention_bwd_ab.py", "attention_bwd_ab")
    source = (CSRC / ab.FWD_SOURCE).read_text()
    assert ab.variant_source("base", source, forward=True) == source
    for name in ab.FWD_VARIANTS:
        if name != "base":
            assert ab.variant_source(name, source, forward=True) != source, name


def test_the_card_tests_take_phase_10bs_backward_cases():
    root = Path(__file__).resolve().parents[1]
    smoke = _load(root / "chip_smoke.py", "chip_smoke_cases")
    kernels = _load(root / "tests" / "test_torch_kernels.py", "test_torch_kernels_cases")
    assert [tuple(c) for c in kernels.TRAIN_BWD_CASES] == list(smoke.TRAIN_BWD_CASES)
