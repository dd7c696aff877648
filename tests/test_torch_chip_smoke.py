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
        E(key="void bobra::pick::pick_tokens_kernel<float, true>(...)",
          self_device_time_total=12.0, count=2),
    ]
    shares = smoke.port_kernel_shares(events, 2)
    assert shares == {"paged_attention": {"ms_per_step": pytest.approx(0.2), "calls_per_step": 32.0},
                      "flash_attention": {"ms_per_step": pytest.approx(0.15), "calls_per_step": 33.0},
                      "rmsnorm": {"ms_per_step": pytest.approx(0.03), "calls_per_step": 65.0},
                      "pick_tokens": {"ms_per_step": pytest.approx(0.006), "calls_per_step": 1.0}}


def test_in_horizon_pick_is_per_tick_and_per_pick(smoke):
    # an H-8 tick: one horizon of 8 picks, 0.042 ms of the pick in all
    pick = smoke.in_horizon_pick({"ms_per_step": 0.042, "calls_per_step": 8.0})
    assert pick == {"ms_per_tick": 0.042, "picks_per_tick": 8.0,
                    "ms_per_pick": pytest.approx(0.00525)}
    assert smoke.in_horizon_pick({"ms_per_step": 0.0, "calls_per_step": 0.0})["ms_per_pick"] is None


def test_prefix_traffic_is_the_unified_leg_of_config_14(smoke):
    import torch

    from bobrapet_tpu_torch.models.llama import llama_tiny

    cfg = llama_tiny()
    work = smoke.mixed_workload(torch, cfg, 0, 1, "cpu")
    kinds = "".join(k[0] for _, _, k in work)
    # two long requests, then one short, as bench.py interleaves them
    assert kinds == "LLSLLSLLSLLSLLSLLSSS".lower()
    longs = [p for p, _, k in work if k == "long"]
    shorts = [p for p, _, k in work if k == "short"]
    assert len(longs) == 12 and len(shorts) == 8
    assert all(len(p) == 640 and p[:128] == longs[0][:128] for p in longs)
    assert len({tuple(p[128:]) for p in longs}) == 12
    assert sorted(len(p) for p in shorts) == [8, 8, 9, 9, 10, 10, 11, 11]
    assert sum(n for _, n, _ in work) == 12 * 8 + 8 * 64 == 608
    # the warm requests share the measured system prompt, not the tails
    warm = smoke.mixed_workload(torch, cfg, 0, 2, "cpu", n_long=2, n_short=1)
    assert [k for _, _, k in warm] == ["long", "long", "short"]
    assert warm[0][0][:128] == longs[0][:128] and warm[0][0][128:] != longs[0][128:]


def test_prefix_paging_fits_without_preemption(smoke):
    from bobrapet_tpu_torch.ops.attention import kv_splits
    from bobrapet_tpu_torch.serving import PagedConfig

    a = PagedConfig(**smoke.PREFIX_PAGING)
    b = PagedConfig(**smoke.ONESHOT_PAGING)
    assert (a.prefix_caching, a.prefill_chunk) == (True, 128)
    assert (b.prefix_caching, b.prefill_chunk) == (False, None)
    long_total = smoke.SYSTEM_TOKENS + smoke.TAIL_TOKENS + smoke.LONG_NEW
    assert long_total <= a.capacity == 656 and a.blocks_for(long_total) <= a.max_blocks_per_seq
    # every slot holding a long request still leaves the pool room
    assert a.max_slots * a.max_blocks_per_seq <= a.num_blocks - 1
    # the chunks after a matched system prompt start at 128 .. 512
    starts = list(range(smoke.SYSTEM_TOKENS, smoke.SYSTEM_TOKENS + smoke.TAIL_TOKENS,
                        a.prefill_chunk))
    assert starts == [128, 256, 384, 512] and starts[-1] == smoke.CHUNK_Q_OFFSET
    # the decode tick's case: 41-block tables, lanes up to the longest request
    assert max(smoke.PREFIX_PAGED_LENS) == long_total
    assert kv_splits(a.capacity) == 8
    pages = sum(-(-n // 16) for n in smoke.PREFIX_PAGED_LENS[1:])
    assert pages <= a.num_blocks - 1


def test_engine_launches_count_prefills_and_steps(smoke):
    assert smoke.engine_launches(56, 100, 32) == {
        "rmsnorm": 156 * 65, "add_rmsnorm": 156 * 64, "flash_attention": 56 * 32,
        "cached_attention": 0, "paged_attention": 100 * 32}
    assert smoke.PREFIX_ORDER == ("A", "B", "B", "A")


def test_chunk_case_bound(smoke):
    # q [1,128,32,128] + out, k/v [1,640,8,128], bf16; queries at 512..639
    pairs = smoke.attention_pairs(128, 640, True, 512)
    assert pairs == 128 * 512 + 128 * 129 // 2
    nbytes = (2 * 128 * 32 * 128 + 2 * 640 * 8 * 128) * 2
    flops = 4 * 128 * pairs * 32
    assert round(nbytes / 1e6, 2) == 4.72 and round(flops / 1e9, 2) == 1.21
    ms, by = smoke.bound(nbytes, flops, "bfloat16")
    assert by == "bytes" and round(ms * 1e3, 2) == 1.41


def test_pctl_is_the_nearest_rank(smoke):
    assert smoke.pctl([3, 1, 2, 4], 0.5) == 3 and smoke.pctl(range(20), 0.95) == 19
    assert smoke.pctl([5], 0.95) == 5


def test_spec_engine_launches_count_each_forward(smoke):
    # one prefill mirrored, one spec round of k = 4, one plain tick with its
    # draft append, one plain horizon of 8 with its catch-up; 32 layers each
    pc = {"prefills": 1, "draft_prefills": 1, "device_steps": 1 + 8, "spec_rounds": 1,
          "spec_ticks": 0, "draft_syncs": 1, "draft_appends": 1}
    got = smoke.spec_engine_launches(pc, 4, 32, 32)
    target = 1 + 9 + 1                 # prefill, nine one-token steps, one verify
    draft = 1 + 5 + 1 + 1              # mirror, five steps, catch-up, append
    assert got == {"rmsnorm": (target + draft) * 65, "add_rmsnorm": (target + draft) * 64,
                   "flash_attention": 2 * 32, "cached_attention": 0,
                   "paged_attention": (9 + 5 + 1) * 32, "paged_attention_multi": 2 * 32,
                   "quant_matmul": draft * 225}
    # an int8 target's products count too; a bf16 draft's do not
    both = smoke.spec_engine_launches(pc, 4, 32, 32, target_int8=True, draft_int8=False)
    assert both["quant_matmul"] == target * 225


def test_a_spec_round_and_a_catch_up_at_8b_widths(smoke):
    # what phase 8 reports a round launches: k + 1 draft steps, one verify
    round_pc = {"prefills": 0, "draft_prefills": 0, "device_steps": 0, "spec_rounds": 1,
                "spec_ticks": 0, "draft_syncs": 0, "draft_appends": 0}
    got = smoke.spec_engine_launches(round_pc, smoke.SPEC_K, 32, 32)
    assert (got["paged_attention"], got["paged_attention_multi"], got["quant_matmul"]) == (
        160, 32, 1125)
    sync_pc = {**round_pc, "spec_rounds": 0, "draft_syncs": 1}
    got = smoke.spec_engine_launches(sync_pc, smoke.SPEC_K, 32, 32)
    assert (got["paged_attention_multi"], got["quant_matmul"], got["paged_attention"]) == (
        32, 225, 0)


def test_the_graphed_pick_timer_finds_every_launch_cold(smoke):
    # 16 or more launches, over copies of the logits that together exceed
    # the H100's 50 MB L2
    import torch

    for _, rows, temps, dt in smoke.PICK_CASES:
        logits, keyed = smoke.pick_inputs(torch, rows, 64, temps, getattr(torch, dt),
                                          torch.Generator().manual_seed(0), "cpu")
        assert len(keyed) == (0 if temps is None else 3)
        nbytes = rows * smoke.VOCAB * logits.element_size()
        n = max(smoke.PICK_GRAPH_CALLS, -(-smoke.PICK_GRAPH_BYTES // nbytes))
        assert n >= 16 and n * nbytes > 50e6
    copies = smoke.pick_copies(torch.zeros(1 << 20))   # 4 MiB: 16 copies, 64 MiB
    assert len(copies) == 16 and len({c.data_ptr() for c in copies}) == 16
    assert smoke.greedy_launches(32)["pick_tokens"] == 1 + smoke.NEW_TOKENS


def test_pick_case_runs_on_the_plain_version(smoke, monkeypatch):
    """pick_case's bookkeeping on the CPU: the kernel's wrapper stood in
    for by the plain version, the card's timers by zeros."""
    import types

    import torch

    from bobrapet_tpu_torch.ops import pick_tokens_reference

    ops = types.SimpleNamespace(pick_tokens_cuda=pick_tokens_reference,
                                pick_tokens_reference=pick_tokens_reference)
    monkeypatch.setattr(smoke, "time_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(smoke, "graphed_ms", lambda torch, calls: float(len(calls)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for name, rows, temps, dt in smoke.PICK_CASES:
        case = smoke.pick_case(torch, ops, None, name, rows, 1000, temps, getattr(torch, dt),
                               torch.Generator().manual_seed(0), "cpu")
        assert case["rows_agreeing"] == rows and case["max_abs_err"] == 0.0
        assert case["graph_launches"] >= smoke.PICK_GRAPH_CALLS
        assert case["graphed_ms"] == case["library_graphed_ms"] == case["graph_launches"]
        assert case["bound_by"] == "bytes"


def test_standalone_launches(smoke):
    got = smoke.standalone_launches(13, 4, 32, 2)
    cached = 13 * (32 + 5 * 2)
    # picks: the first token, then per round 5 draft steps and one verify
    assert got == {"rmsnorm": 14 * 65 + 66 * 5, "add_rmsnorm": 14 * 64 + 66 * 4,
                   "flash_attention": 34 + cached, "cached_attention": cached,
                   "paged_attention": 0, "paged_attention_multi": 0, "quant_matmul": 0,
                   "pick_tokens": 1 + 13 * 6}


def test_quant_bounds_are_the_int8_bytes(smoke):
    # decode M = 8: the int8 weight dominates; bounded by bytes
    nbytes = smoke.quant_bytes(8, 4096, 4096, 2)
    assert nbytes == 4096 * 4096 + (8 * 4096 + 4096 + 8 * 4096) * 2
    ms, by = smoke.bound(nbytes, 2 * 8 * 4096 * 4096, "bfloat16")
    assert by == "bytes" and round(ms * 1e3, 2) == 5.05
    # the LM head: 525 MB of int8, 157 us at 3.35 TB/s
    ms, by = smoke.bound(smoke.quant_bytes(8, 4096, 128256, 2), 2 * 8 * 4096 * 128256,
                         "bfloat16")
    assert by == "bytes" and round(ms, 3) == 0.158
    # the int8 draft's decode step: 32 layers of 7 products and the head
    cases = [{"case": name, "ms": 1.0} for name, *_ in smoke.QUANT_CASES]
    assert smoke.quant_step_ms(cases, 32, "ms") == 32 * 7 + 1


def test_multi_pairs_and_the_verify_bound(smoke):
    # query i of a lane at lens - T + i sees lens - T + i + 1 keys
    assert smoke.multi_pairs((5,), 5) == 1 + 2 + 3 + 4 + 5
    assert smoke.multi_pairs((1, 3), 2) == (0 + 1) + (2 + 3)
    lens, t = smoke.MULTI_LENS, smoke.SPEC_K + 1
    pages = sum(-(-n // 16) for n in lens)
    nbytes = (2 * sum(lens) * 8 * 128 + 2 * 8 * t * 32 * 128) * 2 + 4 * (pages + 8)
    ms, by = smoke.bound(nbytes, 4 * 128 * 32 * smoke.multi_pairs(lens, t), "bfloat16")
    assert sum(lens) == 756  # valid K/V rows
    assert by == "bytes" and round(nbytes / 1e6, 2) == 3.75 and round(ms * 1e3, 2) == 1.12
    # every lane fits the 16-block tables of phase 8's pools
    assert max(lens) <= 16 * 16 and smoke.SPEC_PAGING["max_blocks_per_seq"] == 16


def test_spec_traffic_is_the_serving_child(smoke):
    paging = smoke.SPEC_PAGING
    lens = [32 + (i % 4) * 32 for i in range(smoke.SPEC_REQUESTS)]
    assert smoke.SPEC_REQUESTS == 16 and smoke.SPEC_NEW == 32 and smoke.SPEC_K == 4
    assert (paging["max_slots"], paging["block_size"], paging["num_blocks"],
            paging["max_blocks_per_seq"]) == (8, 16, 256, 16)
    # a speculative horizon funds up to rounds * (k + 1) = 10 tokens past the
    # budget's end: every lane still fits its table and all 8 the pool
    rounds = -(-smoke.SPEC_HORIZON // (smoke.SPEC_K + 1))
    most = max(-(-(n + smoke.SPEC_NEW + rounds * (smoke.SPEC_K + 1)) // 16) for n in lens)
    assert most <= paging["max_blocks_per_seq"]
    assert paging["max_slots"] * most <= paging["num_blocks"] - 1
    assert smoke.STANDALONE_CAP == 64 + 64 + 5


def test_cached_verify_bound(smoke):
    # the standalone verify: q [1,5,32,128] + out, 125 valid K/V rows of
    # [8,128] in a 133-row cache, bf16; queries at 120..124
    lens, sq = (smoke.STANDALONE_CAP - 8,), smoke.SPEC_K + 1
    assert lens == (125,) and sq == 5
    pairs = smoke.attention_pairs(sq, lens[0], True, lens[0] - sq)
    assert pairs == 121 + 122 + 123 + 124 + 125
    nbytes = (2 * 125 * 8 * 128 + 2 * 5 * 32 * 128) * 2 + 4
    ms, by = smoke.bound(nbytes, 4 * 128 * 32 * pairs, "bfloat16")
    assert by == "bytes" and round(ms * 1e6, 1) == 177.3


@pytest.mark.parametrize("n_fed,first,width,windows", [
    (7, 2, 5, [(0, 2), (2, 5)]),
    (1, 3, 5, [(0, 1)]),
    (4, 1, 1, [(0, 1), (1, 1), (2, 1), (3, 1)]),
    (12, 5, 5, [(0, 5), (5, 5), (10, 2)]),
])
def test_feed_windows_cover_every_fed_token_once(smoke, n_fed, first, width, windows):
    assert smoke.feed_windows(n_fed, first, width) == windows


@pytest.mark.parametrize("runner", ["paged", "contiguous"])
def test_divergence_check_tells_a_near_tie_from_a_fault(smoke, runner):
    # fp32 on the CPU: the one-token and verify forms agree to rounding, so
    # the true next token passes and a token far below it fails
    import torch

    from bobrapet_tpu_torch.models import llama

    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, 21), generator=torch.Generator().manual_seed(1))
    fed = llama.greedy_generate(params, prompt, cfg, max_new_tokens=7, cuda_graph=False)[0]
    fed = fed.tolist()
    if runner == "paged":
        run = smoke.paged_runner(torch, params, cfg, prompt[0].tolist(), fed[:6], "cpu")
    else:
        run = smoke.contiguous_runner(torch, llama, params, cfg, prompt, fed[:6], "cpu")
    step = run(smoke.feed_windows(6, 1, 1), 1)
    worst = int(step.argmin())
    ok = smoke.divergence_check(run, 6, smoke.SPEC_K, fed[6], fed[6])
    assert ok["recomputed_argmax"] == fed[6] and ok["margin"] == 0.0
    assert 0.0 <= ok["max_abs_logit_err"] < 1e-3
    bad = smoke.divergence_check(run, 6, smoke.SPEC_K, fed[6], worst)
    assert bad["margin"] > 2 * bad["max_abs_logit_err"]
    with pytest.raises(SystemExit):
        smoke.check_divergences([bad], "test")
    smoke.check_divergences([ok], "test")


def test_the_pick_bound_is_the_logits_bytes(smoke):
    # [8, 128256] fp32 logits read once, temperatures, rids and token
    # indices read once, 8 tokens written: 1.225 us at 3.35 TB/s
    nbytes = smoke.pick_bytes(8, smoke.VOCAB, 4, True)
    assert nbytes == 8 * 128256 * 4 + 8 * 12 + 8 * 4
    ms, by = smoke.bound(nbytes, smoke.pick_flops(smoke.VOCAB, smoke.PICK_ROW_TEMPS), "float32")
    assert by == "bytes" and abs(ms * 1e3 - 1.225) < 1e-3
    # six of the eight rows sample: 4 more operations an element each
    assert smoke.pick_flops(10, (0.0, 0.7, 1.0)) == 3 * 10 + 2 * 10 * 4


def test_pick_launches_count_every_picked_token(smoke):
    # a prefill's first token, nine one-token steps, a spec round and a
    # classic spec tick of k = 4: four draft proposals and a verify each
    pc = {"device_steps": 9, "prefill_picks": 2, "spec_rounds": 1, "spec_ticks": 1}
    assert smoke.pick_launches(pc, 4) == 9 + 2 + 2 * 5
    assert smoke.pick_launches({**pc, "spec_rounds": 0, "spec_ticks": 0}, 4) == 11


def test_with_picks_fails_when_a_token_skipped_the_kernel(smoke):
    from types import SimpleNamespace as NS

    pc = {"device_steps": 16, "prefill_picks": 3, "spec_rounds": 0, "spec_ticks": 0}
    eng = NS(phase_counts=pc, spec_k=4)
    ops = NS(pick_tokens_cuda=NS(launches=19))
    assert smoke.with_picks(ops, eng, {"rmsnorm": 1}, "test") == {"rmsnorm": 1,
                                                                  "pick_tokens": 19}
    ops.pick_tokens_cuda.launches = 18
    with pytest.raises(SystemExit):
        smoke.with_picks(ops, eng, {}, "test")


def test_phase_5_holds_the_defaults_and_the_sampled_modes(smoke):
    assert smoke.SERVE_MODES["default"] is None and smoke.SERVE_ORDER.count("default") == 2
    order = smoke.SAMPLED_ORDER
    assert set(order) == set(smoke.SAMPLED_MODES) and order == order[::-1]
    # (H, depth): the classic tick, the horizon at depth 1 and at depth 2
    assert sorted(smoke.SAMPLED_MODES.values()) == [(1, 1), (8, 1), (8, 2)]
    assert smoke.SERVE_TEMPS == (0.0, 0.7, 1.0, 1.3)
    # the verify's pick: a lane's temperature at its position 0 only
    k1 = smoke.SPEC_K + 1
    temps = smoke.PICK_VERIFY_TEMPS
    assert len(temps) == 8 * k1 and temps[::k1] == smoke.PICK_ROW_TEMPS
    assert all(t == 0 for i, t in enumerate(temps) if i % k1)


def test_phase_8_drains_depth_1_and_2_in_turns(smoke):
    order = smoke.SPEC_ORDER
    assert order == order[::-1] and {"plain", "spec", "spec_d2"} == set(order)
    text = (ROOT / "chip_smoke.py").read_text()
    # the kernels line names the pick with its source and the site it replaces
    assert '"pick_tokens", "bobrapet_tpu_torch/csrc/pick_tokens.cu"' in text
    assert '"bobrapet_tpu/serving/engine.py:2916"' in text


def test_moe_bounds_of_the_greedy_prefill(smoke):
    # T = 1024 tokens, Mixtral's 8 experts, top 2, no-drop C = 2048, d = 4096 bf16
    t, d = smoke.BATCH * smoke.PROMPT, 4096
    ms, by = smoke.bound(smoke.moe_dispatch_bytes(t, 8, 2 * t, d, 2), 0, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.0426, rel=0.01)
    ms, by = smoke.bound(smoke.moe_combine_bytes(t, 2, d, 2), 2 * t * 2 * d, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.0075, rel=0.01)
    # a route, a gate/up, a down and a combine a layer a forward, and no
    # dispatch: the gate/up product gathers its rows itself
    assert smoke.moe_launches(1 + smoke.NEW_TOKENS, 16) == {
        "moe_route": 1040, "moe_dispatch": 0, "moe_gate_up": 1040, "moe_down": 1040,
        "moe_combine": 1040}


def test_moe_phase_is_mixtral_at_half_depth(smoke):
    from bobrapet_tpu_torch.models import moe

    cfg = smoke.moe_cfg(moe, smoke.MOE_LAYERS)
    assert (cfg.n_layers, cfg.dim, cfg.ffn_hidden, cfg.n_experts) == (16, 4096, 14336, 8)
    assert cfg.capacity(smoke.BATCH * smoke.PROMPT) == 2048 and cfg.capacity(smoke.BATCH) == 16
    layer = (2 * cfg.dim * cfg.dim + 2 * cfg.dim * 1024 + 2 * cfg.dim + cfg.dim * 8
             + 3 * 8 * cfg.dim * cfg.ffn_hidden)
    embed = cfg.vocab_size * cfg.dim
    tree = 2 * (2 * embed + cfg.n_layers * layer + cfg.dim)
    assert tree / 1e9 == pytest.approx(46.97, abs=0.01)
    # a decode step reads every weight but the embedding table: 13.94 ms
    assert (tree - 2 * embed) / smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(13.94, abs=0.01)
    flops = smoke.moe_expert_flops(smoke.BATCH * smoke.PROMPT, cfg)
    assert flops["dense"] == pytest.approx(92.4e12, rel=1e-3)
    assert flops["dense_bound_ms"] == pytest.approx(93.4, abs=0.1)
    assert flops["routed_bound_ms"] == pytest.approx(11.7, abs=0.1)
    assert flops["wasted_share"] == pytest.approx(7 / 8)
    # the two engine modes drained in turns
    assert smoke.MOE_SERVE_ORDER == ("classic", "default", "default", "classic")
    assert set(smoke.MOE_SERVE_MODES) == set(smoke.MOE_SERVE_ORDER)


def test_phase_list_ends_with_the_engram_then_the_result(smoke):
    doc = smoke.__doc__
    assert "\n10. the serving engram at Llama-3-8B width and depth" in doc
    assert "\n11. one JSON line of kernels, the card line, and last" in doc
    text = (ROOT / "chip_smoke.py").read_text()
    assert 'phase_mark(t_start, "10")' in text and 'phase_mark(t_start, "11")' in text


def test_phase_10_traffic_is_config_6_over_block_aligned_prompts(smoke):
    lens = [smoke.disagg_prompt_len(i) for i in range(smoke.SERVE_REQUESTS)]
    budgets = [smoke.serve_budget(i) for i in range(smoke.SERVE_REQUESTS)]
    assert set(lens) == {16, 32, 48} and all(n % 16 == 0 for n in lens)
    paging = smoke.ENGRAM_PAGING
    block = paging["blockSize"]
    cap = block * paging["maxBlocksPerSeq"]
    assert max(n + b for n, b in zip(lens, budgets)) <= cap
    # every slot at its longest never exhausts the pool: no preemption
    most = max(-(-(n + b + 1) // block) for n, b in zip(lens, budgets))
    assert paging["maxSlots"] * most <= paging["numBlocks"] - 1
    # a handoff adopts every prompt block: 31 a drain, 2 MiB of K/V each
    # at Llama-3-8B (32 layers x 16 rows x 8 heads x 128, bf16, K and V)
    assert sum(n // block for n in lens) == 31
    assert 31 * 2 * 32 * 16 * 8 * 128 * 2 == 65_011_712
    assert smoke.ENGRAM_CONFIG["model"] == "8b" and smoke.ENGRAM_DIR.startswith("build/")
    assert (smoke.ENGRAM_CONFIG["decodeHorizon"], smoke.ENGRAM_CONFIG["dispatchDepth"]) == (8, 2)


def test_engine_counts_is_exact_against_the_phase_counts(smoke):
    from types import SimpleNamespace as NS

    pc = {"prefills": 16, "device_steps": 0, "prefill_picks": 16, "spec_rounds": 0,
          "spec_ticks": 0}
    pc2 = {**pc, "prefills": 0, "device_steps": 144, "prefill_picks": 0}
    engines = [NS(phase_counts=pc, cfg=NS(n_layers=32)), NS(phase_counts=pc2)]
    ops = NS(**{name: NS(launches=0) for name in (
        "rmsnorm_cuda", "add_rmsnorm_cuda", "flash_attention_cuda", "cached_attention_cuda",
        "paged_attention_cuda", "pick_tokens_cuda")})
    ops.rmsnorm_cuda.launches = 160 * 65
    ops.add_rmsnorm_cuda.launches = 160 * 64
    ops.flash_attention_cuda.launches = 16 * 32
    ops.paged_attention_cuda.launches = 144 * 32
    ops.pick_tokens_cuda.launches = 160
    got = smoke.engine_counts(ops, engines, "test")
    assert got == {"rmsnorm": 10400, "add_rmsnorm": 10240, "flash_attention": 512,
                   "cached_attention": 0, "paged_attention": 4608, "pick_tokens": 160}
    ops.flash_attention_cuda.launches += 32  # a prefill on the decode engine
    with pytest.raises(SystemExit):
        smoke.engine_counts(ops, engines, "test")


def test_phase_10_runs_on_the_cpu_at_tiny_size(smoke, monkeypatch, tmp_path):
    """The whole of phase 10 at llama_tiny size on the CPU (plain versions,
    so no launch is counted): the wire JSON through serve(ctx) carries the
    tokens of a plain engine's drain, serve's own engine is the one counted,
    the prefill engine only prefills, the decode engine never does over
    block-aligned prompts and prefills each suffix once over config 6's own,
    and the resumed engine adopts all 31 prompt blocks from disk."""
    import torch

    from bobrapet_tpu_torch import ops, serving
    from bobrapet_tpu_torch.models import llama

    def fail(msg):
        raise AssertionError(msg)

    seen = []

    def counts(_ops, engines, what):
        seen.append((what, [(e.phase_counts["prefills"], e.phase_counts["device_steps"])
                            for e in engines]))
        return {}

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "fail", fail)
    monkeypatch.setattr(smoke, "engine_counts", counts)
    monkeypatch.setattr(smoke, "ENGRAM_CONFIG", {**smoke.ENGRAM_CONFIG, "model": "tiny"})
    monkeypatch.setattr(smoke, "ENGRAM_DIR", str(tmp_path / "engram"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, dev = llama.llama_tiny(), torch.device("cpu")
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**smoke.SERVE_PAGING))
        prompts = smoke.serve_prompts(torch, cfg, 11, dev)
        rids = [eng.submit(p, smoke.serve_budget(i)) for i, p in enumerate(prompts)]
        by_rid = {r.rid: r.output for r in eng.run()}
        out = smoke.engram_phase(torch, ops, serving, llama, cfg, 0, dev, "cpu",
                                 [by_rid[r] for r in rids])
    finally:
        torch.set_num_threads(n)
    assert out["checkpoint"]["bit_for_bit"] and out["serve"]["served"] == 16
    assert out["resume"] == {**out["resume"], "blocks_adopted_from_disk": 31,
                             "greedy_tokens": True}
    whats = dict(seen)
    assert whats["serve(ctx)"][0][0] == 16
    for name in ("greedy", "sampled"):
        (pf_prefills, pf_steps), (dec_prefills, dec_steps) = whats[f"the {name} router drain"]
        assert (pf_prefills, pf_steps, dec_prefills) == (16, 0, 0) and dec_steps > 0
        leg = out["disaggregated"][name]
        assert leg["identical_to_unified"] and leg["block_aligned"]
        assert leg["disaggregated"]["registry_hits"] == 31
        assert leg["disaggregated"]["spill_writes"] == 31
    # config 6's own prompts (8-36 tokens): the decode engine adopts their
    # 12 full blocks and prefills every request's suffix once over them
    lens = [smoke.serve_prompt_len(i) for i in range(smoke.SERVE_REQUESTS)]
    assert all(n % 16 for n in lens) and sum(n // 16 for n in lens) == 12
    (pf_prefills, pf_steps), (dec_prefills, dec_steps) = whats["the config6_prompts router drain"]
    assert (pf_prefills, pf_steps, dec_prefills) == (16, 0, 16) and dec_steps > 0
    leg = out["disaggregated"]["config6_prompts"]
    assert leg["identical_to_unified"] and not leg["block_aligned"]
    assert leg["disaggregated"]["registry_hits"] == 12
    assert leg["disaggregated"]["decode_prefills"] == 16
    assert leg["disaggregated"]["replay_h1_depth1_identical"]
    assert leg["disaggregated"]["identical_token_share"] == 1.0
    # the prefill engine's 12, and the block each 15-token prompt fills
    # with its first token on the decode engine (3 such prompts)
    assert sum(n % 16 == 15 for n in lens) == 3
    assert leg["disaggregated"]["spill_writes"] == 15
    assert whats["the resume from disk"][0][0] == 0
    assert not (tmp_path / "engram").exists()


def test_phase_10_handoff_tie_check_recomputes_both_paths(smoke):
    """The near-tie check of a handed-off greedy stream: None where the
    tokens agree; at a divergence, token j's logits through the unified
    path (its argmax the engine's greedy token) and the handed-off path,
    equal in fp32 up to rounding."""
    import torch

    from bobrapet_tpu_torch import serving
    from bobrapet_tpu_torch.models import llama

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, dev = llama.llama_tiny(), torch.device("cpu")
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**smoke.SERVE_PAGING))
        prompt = smoke.serve_prompts(torch, cfg, 11, dev)[4]
        assert len(prompt) % 16 and len(prompt) > 16
        eng.submit(prompt, 6)
        uni = eng.run()[0].output
        cap = eng.pcfg.capacity
        assert smoke.handoff_tie_check(torch, llama, params, cfg, prompt, uni, list(uni), 16,
                                       cap, dev) is None
        dis = uni[:3] + [(uni[3] + 1) % cfg.vocab_size] + uni[4:]
        c = smoke.handoff_tie_check(torch, llama, params, cfg, prompt, uni, dis, 16, cap, dev)
    finally:
        torch.set_num_threads(n)
    assert c["position"] == 3 and (c["unified"], c["handed_off"]) == (uni[3], dis[3])
    assert c["recomputed_argmax"] == [uni[3], uni[3]]
    assert c["margin"] > 0 and c["max_abs_logit_err"] < 1e-3


def test_phase_10b_sits_between_the_engram_and_the_result(smoke):
    doc = smoke.__doc__
    i10, i10b, i11 = (doc.index(s) for s in (
        "\n10. the serving engram", "\n10b. the train step", "\n11. one JSON line"))
    assert i10 < i10b < i11
    text = (ROOT / "chip_smoke.py").read_text()
    m10, m10b, m11 = (text.index(f'phase_mark(t_start, "{p}")') for p in ("10", "10b", "11"))
    assert m10 < m10b < m11
    # it runs after phase 10 frees its trees
    assert text.index("del engram_out") < m10b


def test_phase_10b_bounds_of_the_training_kernels(smoke):
    # attention backward at the step's shapes: 5 products over the causal
    # pairs (2.5x the forward), q, k, v, o, do, dq, dk, dv and lse once
    pairs = 512 * 513 // 2
    flops = smoke.attention_bwd_flops(8, 512, 512, 32, 128)
    assert flops == 10 * 128 * pairs * 8 * 32 == 2.5 * 4 * 128 * pairs * 8 * 32
    assert flops / 1e9 == pytest.approx(43.03, abs=0.01)
    nbytes = smoke.attention_bwd_bytes(8, 512, 512, 32, 8, 128, 2)
    assert nbytes == 4 * (8 * 512 * 32 * 128 + 8 * 512 * 8 * 128) * 2 + 4 * 8 * 32 * 512
    assert nbytes / 1e6 == pytest.approx(168.3, abs=0.1)
    ms, by = smoke.bound(nbytes, flops, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.0502, abs=1e-4)
    assert flops / smoke.PEAK_FLOPS["bfloat16"] * 1e3 == pytest.approx(0.0435, abs=1e-4)
    # the norm backward at the step's 4,096 rows: dy, x (ds) in, dx out
    add = smoke.rmsnorm_bwd_bytes(smoke.TRAIN_NORM_ROWS, 4096, 2, True)
    plain = smoke.rmsnorm_bwd_bytes(smoke.TRAIN_NORM_ROWS, 4096, 2, False)
    assert add == 4 * 4096 * 4096 * 2 + 2 * 4096 * 2 and plain == add - 4096 * 4096 * 2
    assert smoke.bound(add, smoke.rmsnorm_bwd_flops(4096, 4096, True), "bfloat16") == (
        pytest.approx(0.04007, abs=1e-5), "bytes")
    assert smoke.TRAIN_ATTN_CASES[0][1:] == (8, 512, 32, 8, "bfloat16")
    assert {c[-1] for c in smoke.TRAIN_ATTN_CASES} == {"bfloat16", "float32"}
    assert {c[3] // c[4] for c in smoke.TRAIN_ATTN_CASES} == {4, 1}
    assert all(c[2] % 64 for c in smoke.TRAIN_ATTN_CASES[1:])


def test_phase_10b_mfu_arithmetic(smoke):
    from bobrapet_tpu_torch.models import llama

    cfg = llama.LlamaConfig(n_layers=smoke.TRAIN_LAYERS)
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336 + 2 * 4096
    n = smoke.train_nonembed_params(cfg)
    assert n == cfg.n_layers * layer + 4096 + 4096 * 128256  # layers, final norm, LM head
    assert cfg.param_count / 1e9 == pytest.approx(4.54, abs=0.01)
    f = smoke.train_step_flops(cfg, smoke.TRAIN_BATCH, smoke.TRAIN_SEQ)
    assert f["tokens"] == 4096 and f["dense"] == 6 * n * 4096
    assert f["attention"] == 12 * 128 * (512 * 513 // 2) * 8 * 32 * cfg.n_layers
    assert f["total"] / 1e12 == pytest.approx(99.5, abs=0.1)
    # 100% of the bf16 peak would take ~100.6 ms a step
    assert smoke.train_mfu(f["total"], f["total"] / 989e12) == pytest.approx(1.0)
    # params, grads and bf16 moments: 8 bytes a parameter
    assert 8 * cfg.param_count / 1e9 == pytest.approx(36.3, abs=0.1)
    assert 8 * llama.LlamaConfig().param_count / 1e9 == pytest.approx(64.2, abs=0.1)


@pytest.mark.parametrize("layers", [2, 16])
def test_phase_10b_launch_arithmetic(smoke, layers):
    plain = smoke.train_launches(layers)
    assert (plain["flash_attention_lse"], plain["flash_attention_backward"]) == (layers, layers)
    assert plain["rmsnorm"] == plain["rmsnorm_backward"] == 2 * layers + 1
    assert plain["add_rmsnorm"] == plain["add_rmsnorm_backward"] == 2 * layers
    assert plain["flash_attention"] == plain["cached_attention"] == plain["paged_attention"] == 0
    remat = smoke.train_launches(layers, remat=True)
    assert remat["flash_attention_lse"] == 2 * layers and remat["rmsnorm"] == 2 * (2 * layers + 1)
    assert remat["flash_attention_backward"] == layers
    assert remat["rmsnorm_backward"] == 2 * layers + 1


def test_phase_10b_runs_on_the_cpu_at_tiny_size(smoke, monkeypatch):
    """Phase 10b's steps at a tiny config on the CPU (plain versions, so
    the launch counts are fed as the card would give them, and the kernel
    cases, which need the card, are left out): ten steps whose losses fall,
    remat and the span-env mesh bit for bit, the plain path's steps (here
    the same path), fp32 card against CPU."""
    import torch

    from bobrapet_tpu_torch import ops
    from bobrapet_tpu_torch.models import llama

    def fail(msg):
        raise AssertionError(msg)

    class Event:
        def __init__(self, **_):
            pass

        def record(self):
            pass

        def elapsed_time(self, _):
            return 1.0

    class Profile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def key_averages(self):
            return []

    layers = 2
    none = dict.fromkeys(smoke.train_launches(layers), 0)
    counts = iter([smoke.train_launches(layers)] * smoke.TRAIN_STEPS
                  + [smoke.train_launches(layers, remat=True), none,
                     smoke.train_launches(layers)])
    tiny = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=layers, n_heads=4, n_kv_heads=2,
                             ffn_hidden=256, max_seq_len=256, dtype=torch.bfloat16)
    monkeypatch.setattr(smoke, "fail", fail)
    monkeypatch.setattr(smoke, "read_train_counts", lambda _ops: next(counts))
    monkeypatch.setattr(smoke, "train_kernel_cases", lambda *a: [])
    monkeypatch.setattr(smoke, "TRAIN_LAYERS", layers)
    monkeypatch.setattr(smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 16)
    monkeypatch.setattr(smoke, "TRAIN_CROSS_SEQ", 8)
    monkeypatch.setattr(llama, "llama3_8b", lambda: tiny)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.train_phase(torch, torch.nn.functional, ops, llama, 0,
                                torch.device("cpu"), "cpu")
    finally:
        torch.set_num_threads(n)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    step = out["step"]
    assert len(step["losses"]) == smoke.TRAIN_STEPS and step["remat_same_bits"]
    assert step["span_env_mesh_same_bits"] and step["n_layers"] == layers
    assert step["launches"]["flash_attention_backward"] == layers * smoke.TRAIN_STEPS
    assert step["plain_path_max_rel_gap"] == 0.0
    assert llama.attention is importlib.import_module("bobrapet_tpu_torch.ops.attention").attention
    assert out["cross"]["loss_rel_err"] <= smoke.TRAIN_CROSS_LOSS_RTOL
