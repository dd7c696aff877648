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


PTXAS_LOG = """== flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5bobra4attn17flash_rows_kernelILi128EEEvNS0_11DensePolicyIXT_EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN5bobra4attn17flash_rows_kernelILi128EEEvNS0_11DensePolicyIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5bobra22flash_attention_kernelIfLi32EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN5bobra22flash_attention_kernelIfLi32EEEvPKT_
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 22784 bytes smem, 456 bytes cmem[0]
"""


def test_ptxas_instances_reads_registers_smem_and_spills(smoke):
    rows, scalar = smoke.ptxas_instances(PTXAS_LOG)
    assert rows == {"name": "_ZN5bobra4attn17flash_rows_kernelILi128EEEvNS0_11DensePolicyIXT_EEE",
                    "registers": 168, "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0}
    assert (scalar["registers"], scalar["smem_bytes"]) == (90, 22784)
    assert (scalar["spill_stores"], scalar["spill_loads"]) == (4, 8)
    assert smoke.ptxas_instances("== rmsnorm.cu\n") == []


def test_long_cache_cases_split_across_whole_clusters(smoke):
    from bobrapet_tpu_torch.ops.attention import kv_splits

    assert kv_splits(smoke.LONG_KV) == 8
    cap = 16 * smoke.LONG_KV_PAGES
    assert cap == 1024 and max(smoke.LONG_PAGED_LENS) == cap and kv_splits(cap) == 8
    # the live lanes' pages fit the pool beside the scratch block
    pages = sum(-(-n // 16) for n in smoke.LONG_PAGED_LENS[1:])
    assert pages <= smoke.LONG_PAGED_BLOCKS - 1


def test_port_kernel_shares_sorts_instances_by_kernel(smoke):
    from types import SimpleNamespace as E

    events = [
        E(key="void bobra::attn::decode_attention_kernel<bobra::attn::PagedPolicy<128> >(...)",
          self_device_time_total=400.0, count=64),
        E(key="void bobra::attn::decode_attention_kernel<bobra::attn::DensePolicy<128> >(...)",
          self_device_time_total=200.0, count=64),
        E(key="void bobra::attn::flash_rows_kernel<128>(...)", self_device_time_total=100.0, count=2),
        E(key="void bobra::rmsnorm_kernel<__nv_bfloat16, false>(...)", self_device_time_total=60.0,
          count=130),
        E(key="nvjet_tst_192x8_64x8_4x1_v_bz_NNT", self_device_time_total=9000.0, count=128),
    ]
    shares = smoke.port_kernel_shares(events, 2)
    assert shares == {"paged_attention": {"ms_per_step": pytest.approx(0.2), "calls_per_step": 32.0},
                      "flash_attention": {"ms_per_step": pytest.approx(0.15), "calls_per_step": 33.0},
                      "rmsnorm": {"ms_per_step": pytest.approx(0.03), "calls_per_step": 65.0}}
