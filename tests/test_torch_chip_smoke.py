"""chip_smoke.py's arithmetic, and its refusal to report without the card
or outside the repo. Runs on the CPU (the script imports torch only in
main(), so its helpers load anywhere)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sq,sk,causal,q_offset,pairs", [
    (4, 4, True, 0, 10),
    (1, 160, True, 159, 160),
    (3, 5, False, 0, 15),
    (2, 9, True, 3, 4 + 5),
])
def test_attention_pairs_counts_the_unmasked_keys(smoke, sq, sk, causal, q_offset, pairs):
    assert smoke.attention_pairs(sq, sk, causal, q_offset) == pairs


def test_bounds_of_the_main_path_shapes(smoke):
    # flash prefill: q [8,128,32,128] + out, k/v [8,128,8,128], bf16
    nbytes = (2 * 8 * 128 * 32 * 128 + 2 * 8 * 128 * 8 * 128) * 2
    flops = 4 * 128 * smoke.attention_pairs(128, 128, True, 0) * 8 * 32
    assert round(nbytes / 1e6, 1) == 21.0 and round(flops / 1e9, 2) == 1.08
    ms, by = smoke.bound(nbytes, flops, "bfloat16")
    assert by == "bytes" and round(ms * 1e3, 1) == 6.3
    # RMSNorm [1024, 4096] bf16: x read, y written, w read
    ms, by = smoke.bound(2 * 1024 * 4096 * 2 + 4096 * 2, 4 * 1024 * 4096, "bfloat16")
    assert by == "bytes" and round(ms * 1e3, 1) == 5.0
    # exact fp32 work outside the tensor cores is bounded by operations
    assert smoke.bound(1e6, 1e9, "float32")[1] == "operations"


def test_paged_bound_of_the_main_case(smoke):
    # q [8,32,128] + out, 385 valid K/V rows of [8,128], bf16; 28 table
    # entries and 8 lengths
    lens = smoke.PAGED_LENS
    assert sum(lens) == 385 and sum(-(-n // 16) for n in lens) == 28
    nbytes = (2 * 385 * 8 * 128 + 2 * 8 * 32 * 128) * 2 + 4 * (28 + 8)
    assert round(nbytes / 1e6, 2) == 1.71
    ms, by = smoke.bound(nbytes, 4 * 128 * 385 * 32, "bfloat16")
    assert by == "bytes" and round(ms * 1e3, 2) == 0.51


def test_serving_traffic_is_config_6(smoke):
    lens = [smoke.serve_prompt_len(i) for i in range(smoke.SERVE_REQUESTS)]
    budgets = [smoke.serve_budget(i) for i in range(smoke.SERVE_REQUESTS)]
    assert smoke.SERVE_REQUESTS == 16 and sum(budgets) == 785
    assert (min(lens), max(lens), min(budgets), max(budgets)) == (8, 36, 32, 64)
    paging = smoke.SERVE_PAGING
    block, cap = paging["block_size"], paging["block_size"] * paging["max_blocks_per_seq"]
    assert max(n + b for n, b in zip(lens, budgets)) <= cap
    # every slot at its longest never exhausts the pool: no preemption,
    # so exactly one prefill per request
    most = max(-(-(n + b) // block) for n, b in zip(lens, budgets))
    assert paging["max_slots"] * most <= paging["num_blocks"] - 1
    assert paging["prefix_caching"] is False


def test_tolerances_cover_every_kernel_and_type(smoke):
    assert set(smoke.TOL) == {(k, t) for k in ("attention", "rmsnorm")
                              for t in ("bfloat16", "float32")}


def test_refuses_to_report_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    with pytest.raises(json.JSONDecodeError):
        json.loads(lines[-1] if lines else "")
