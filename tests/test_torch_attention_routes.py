"""The host-side choices of the port's attention kernels, on the CPU.

``ops.attention.flash_route`` picks the kernel of ``csrc/flash_attention.cu``
from the packed row count Sq x group and the dtype; ``ops.attention.kv_splits``
picks how many blocks of a thread-block cluster split one decode's keys,
from a static size (Sk, or a block table's capacity), so the wrappers never
read a length from the card. The CUDA sources hold the same constants;
this file pins both.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

from bobrapet_tpu_torch.ops.attention import flash_route, kv_splits

# the modules (the package exports functions of the same names)
attn_ops = importlib.import_module("bobrapet_tpu_torch.ops.attention")
paged_ops = importlib.import_module("bobrapet_tpu_torch.ops.paged_attention")

CSRC = Path(attn_ops.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("size,splits", [
    (1, 1), (64, 1), (65, 2), (128, 2), (160, 4), (256, 4), (257, 8), (1024, 8),
    (2048, 8), (4096, 8),
])
def test_kv_splits_is_the_next_power_of_two_of_64_key_tiles_up_to_8(size, splits):
    assert kv_splits(size) == splits


def test_kv_splits_of_the_main_paths():
    # greedy decode over a 160-row cache; the engine's table of 8 pages of 16
    assert kv_splits(160) == 4
    assert kv_splits(8 * 16) == 2


@pytest.mark.parametrize("sq,group,dtype,route", [
    (1, 4, torch.bfloat16, "decode"),     # greedy decode: 4 rows
    (4, 4, torch.bfloat16, "decode"),     # 16 rows: one tile
    (1, 16, torch.bfloat16, "decode"),    # the largest group
    (17, 1, torch.bfloat16, "rows"),      # 17 rows
    (5, 4, torch.bfloat16, "rows"),       # 20 rows
    (128, 4, torch.bfloat16, "rows"),     # the model's prefill
    (64, 4, torch.bfloat16, "rows"),      # the engine's prefill bucket
    (1, 4, torch.float32, "scalar"),      # fp32 stays exact
    (128, 4, torch.float32, "scalar"),
])
def test_flash_route_follows_the_packed_rows_and_the_dtype(sq, group, dtype, route):
    assert flash_route(sq, group, dtype) == route


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_cuda_sources_hold_the_same_constants():
    core = (CSRC / "attention_core.cuh").read_text()
    assert _constant(core, "kDecodeRows") == attn_ops.DECODE_ROWS == paged_ops.MAX_GROUP
    assert _constant(core, "kTileKeys") == attn_ops.SPLIT_KEYS
    assert _constant(core, "kMaxSplits") == attn_ops.MAX_SPLITS


def test_the_c_entry_points_take_the_split():
    # one argument more than before each dtype code: the split, set by the host
    for src, name, args in (("flash_attention.cu", "bobra_flash_attention",
                             attn_ops._ARGTYPES),
                            ("paged_attention.cu", "bobra_paged_attention",
                             paged_ops._ARGTYPES)):
        text = (CSRC / src).read_text()
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
        params = [p.split()[-1] for p in sig.split(",")]
        assert len(params) == len(args)
        assert params[-3:] == ["splits", "dtype", "stream"]
