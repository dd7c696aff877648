#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bobrapet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (exit 1, and no result line):

1. the card: its name and power limit (nvidia-smi); no card, no run;
2. build every kernel in bobrapet_tpu_torch/csrc with nvcc for sm_90a,
   and print each kernel instance's ptxas line (registers, static shared
   memory, spills); a spill in a tensor-core attention kernel or in an
   RMSNorm instance fails the run;
3. each kernel against its plain PyTorch version on the card, in bf16 at
   the main paths' shapes (greedy prefill and decode, the greedy decode
   with device lengths over the whole 192-row cache, RMSNorm alone and
   fused with the residual add, the engine's largest prefill bucket, an
   engine decode tick) plus long-cache decodes (dense over 2048 rows,
   paged up to 1024), ragged, fp32 and narrow-head cases: max abs error
   against a stated tolerance, and the times (CUDA events, median of 50
   launches, L2 flushed before each) of the kernel, the plain version and
   one PyTorch library call for the same function (a yardstick only; the
   port never calls it), beside the least time the card could take (for
   RMSNorm also its time with the L2 left warm, and a PyTorch copy that
   moves the same bytes under the flushed timer); then the host's
   microseconds per call of each kernel wrapper against torch.add;
4. the greedy path: Llama-3-8B at full width and depth (bf16, random
   weights from --seed) serves one request through greedy_generate (a
   batch of 8 prompts of 128 tokens, 64 new tokens) four times in turns,
   the decode steps eager, as CUDA graphs, as graphs, eager; the tokens
   must be identical, and the kernels' launch counts, set to 0 just
   before each run, must show that every norm and every attention of it
   went through the kernels (graph replays counted), every norm but the
   first of a forward through the add mode and every decode attention
   through the device-length entry; then prefill ms, decode step ms and
   the card's busy share of a step, eager and graphed in turns;
5. the serving path on the same weights: the continuous-batching engine
   (8 slots over a paged cache of 256 blocks of 16) streams 16 requests
   (prompts of 8-36 tokens, budgets of 32-64, 785 new tokens) with the
   classic tick, dispatch-ahead off and on, and with the fused horizon of
   8 steps as one CUDA graph, a warm drain each, then measured drains in
   turns (off, on, H8, H8, on, off); every request gets exactly its
   budget, every drain the same tokens, and the launch counts of all
   three kernels are exact in each drain; then each engine's steady tick
   under the profiler;
6. a 2-layer model at the 8B widths, the same seeded weights on the card
   (kernels) and on the CPU (plain versions): bf16 prefill logits must
   agree, and in fp32 the serving engine must give identical tokens,
   classic and at a horizon of 8;
7. one JSON line of kernels, the card line, and last
   {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s for the type the work is done in (bf16 tensor cores; fp32 outside
# them, which is what an exact fp32 kernel can use).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BATCH, PROMPT, NEW_TOKENS = 8, 128, 64
# the greedy runs: decode steps eager or as CUDA graphs, in turns
GREEDY_RUNS = (False, True, True, False)
DECODE_KV = 160  # a mid-request decode step: the cache holds 129..192 rows
CACHE_ROWS = PROMPT + NEW_TOKENS  # the greedy cache's capacity
# the engine's modes, measured in turns: (pipeline_decode, decode_horizon)
SERVE_MODES = {"off": (False, 1), "on": (True, 1), "h8": (False, 8)}
SERVE_ORDER = ("off", "on", "h8", "h8", "on", "off")
# the fp32 engine cross-check's budget per horizon (capacity 64, prompts
# up to 30): the classic tick, and three horizons of 8
CROSS_BUDGET = {1: 10, 8: 24}

# The serving path: BASELINE config 6's traffic (bench.py:627-653), 16
# requests with staggered budgets streaming through 8 slots, no eos.
SERVE_REQUESTS = 16
SERVE_PAGING = dict(max_slots=8, block_size=16, num_blocks=256, max_blocks_per_seq=8,
                    prefix_caching=False)
# one decode tick's paged attention: the inactive lane (length 1, an
# all-scratch table row) and live lanes at block edges and inside blocks
PAGED_LENS = (1, 9, 16, 17, 50, 64, 100, 128)
# long caches: a greedy decode over 2048 rows, and a tick whose tables
# hold 64 pages of 16 (capacity 1024) with lanes up to full
LONG_KV = 2048
LONG_KV_PAGES, LONG_PAGED_BLOCKS = 64, 520
LONG_PAGED_LENS = (1, 100, 255, 256, 511, 700, 1000, 1024)


def serve_prompt_len(i: int) -> int:
    return 8 + (i % 5) * 7


def serve_budget(i: int) -> int:
    return 32 + (i * 13) % 33

# bf16: both sides compute in fp32 from the same bf16 inputs and round
# once, summing in another order, so a value may take the neighbouring
# bf16 number: attention gets one ulp of the plain value (rtol 2^-7) + 1e-3;
# RMSNorm two ulps (rtol 2^-6: the normalised value, then the weight
# product). fp32: the JAX package's own 2e-4 (attention), 1e-5 (RMSNorm).
# The tolerance cannot tell RMSNorm's two bf16 roundings apart (the
# reference casts before the weight multiply, the TPU kernel once after),
# so in bf16 the kernel must also match the plain version bit for bit on
# at least this share of elements: only the fp32 sum order differs, so
# nearly all match, where the TPU kernel's rounding differs on about a
# quarter of them.
RMSNORM_BIT_SHARE = 0.99
TOL = {
    ("attention", "bfloat16"): (1e-3, 2.0 ** -7),
    ("attention", "float32"): (2e-4, 2e-4),
    ("rmsnorm", "bfloat16"): (1e-6, 2.0 ** -6),
    ("rmsnorm", "float32"): (1e-5, 1e-5),
}
# whole-path check, bf16 logits of a 2-layer 8B-width model, card vs CPU:
# every matmul output is rounded to bf16 after sums taken in another order
# (cuBLAS vs the CPU), so 1-ulp flips carry through two layers into
# logits of magnitude ~5; a kernel fault shows as errors of order 1.
LOGIT_MAX_ERR, LOGIT_MEAN_ERR = 0.25, 0.02


def ptxas_instances(log: str) -> list[dict]:
    """Each kernel instance in nvcc's ``-Xptxas -v`` output: its (mangled)
    name, registers, static shared memory and spill bytes."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"name": m.group(1), "registers": None, "smem_bytes": 0,
                        "spill_stores": 0, "spill_loads": 0})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def demangle(names: list[str]) -> list[str]:
    """C++ names through c++filt where the machine has it (for printing)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return names
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, L2 flushed before each.

    A spin of ~0.25 ms on the card before each start event lets the host
    enqueue the whole call first, so the events time the device's work
    and not the host's launch overhead (which the decode step shows)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(500_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, kind, name, out, ref, dtype_name) -> float:
    atol, rtol = TOL[(kind, dtype_name)]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        fail(f"{name}: kernel output not finite")
    err = (out - ref).abs()
    worst = float((err - rtol * ref.abs()).max())
    max_err = float(err.max())
    print(f"  {name}: max_abs_err {max_err:.3e} (tolerance {atol:g} + {rtol:.4g}*|plain|)",
          flush=True)
    if worst > atol:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


def bit_share(torch, a, b) -> float:
    """Share of elements whose bits are equal."""
    return float((a.view(torch.int16) == b.view(torch.int16)).float().mean())


def rmsnorm_bytes(rows: int, d: int, es: int, add: bool) -> int:
    """x (and delta) read once, y (and s) written once, the weight once."""
    return (4 if add else 2) * rows * d * es + d * es


def rmsnorm_flops(rows: int, d: int, add: bool) -> int:
    """Square and sum, scale, weight product per element (and the add)."""
    return (5 if add else 4) * rows * d


def rmsnorm_case(torch, F, ops, flush, name, rows, d, dtype, gen, dev, add=False):
    """The plain mode, or (``add``) the add mode: ``s`` must be the card's
    own ``x + delta`` bit for bit, and ``y`` the plain norm of it. Beside
    the kernel's time: the same with nothing flushed (the L2 left warm),
    and under the flushed timer one PyTorch copy that moves the kernel's
    bytes without the weight (``x.clone()``; ``torch.cat((x, delta))``)."""
    x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1 + 1.0).to(dtype)
    dn = str(dtype).split(".")[-1]
    extra = {}
    if add:
        delta = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        s, out = ops.add_rmsnorm_cuda(x, delta, w, 1e-5)
        normed = x + delta
        if not torch.equal(s, normed):
            fail(f"{name}: s is not bit-identical to the card's x + delta")
        print(f"  {name}: s bit-identical to the card's x + delta", flush=True)
        kernel = lambda: ops.add_rmsnorm_cuda(x, delta, w, 1e-5)  # noqa: E731
        plain = lambda: ops.add_rmsnorm_reference(x, delta, w, 1e-5)  # noqa: E731
        library = lambda: F.rms_norm(x + delta, (d,), w, 1e-5)  # noqa: E731
        copy = lambda: torch.cat((x, delta))  # noqa: E731
        extra = {"s_bit_identical": True, "library": "x + delta, then F.rms_norm (two calls)"}
    else:
        out, normed = ops.rmsnorm_cuda(x, w, 1e-5), x
        kernel = lambda: ops.rmsnorm_cuda(x, w, 1e-5)  # noqa: E731
        plain = lambda: ops.rmsnorm_reference(x, w, 1e-5)  # noqa: E731
        library = lambda: F.rms_norm(x, (d,), w, 1e-5)  # noqa: E731
        copy = x.clone
    ref = ops.rmsnorm_reference(normed, w, 1e-5)
    err = compare(torch, "rmsnorm", name, out, ref, dn)
    shares = {}
    if dtype == torch.bfloat16:
        # the TPU kernel's rounding: the weight product in fp32, one cast
        xf = normed.float()
        tpu = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5) * w.float()).to(dtype)
        shares = {"bit_identical_share": bit_share(torch, out, ref),
                  "tpu_rounding_share": bit_share(torch, out, tpu)}
        print(f"  {name}: bit-identical to the plain version on "
              f"{shares['bit_identical_share']:.6f} of elements (at least {RMSNORM_BIT_SHARE}), "
              f"to the TPU kernel's rounding on {shares['tpu_rounding_share']:.6f}", flush=True)
        if shares["bit_identical_share"] < RMSNORM_BIT_SHARE:
            fail(f"{name}: kernel does not round like the plain version")
    b_ms, b_by = bound(rmsnorm_bytes(rows, d, x.element_size(), add), rmsnorm_flops(rows, d, add),
                       dn)
    return {
        "case": name, "mode": "add" if add else "plain", "shape": [rows, d], "dtype": dn,
        "max_abs_err": err, **shares, **extra,
        "ms": time_ms(torch, kernel, flush),
        "warm_ms": time_ms(torch, kernel, torch.empty(16, dtype=torch.uint8, device=dev)),
        "copy_same_bytes_ms": time_ms(torch, copy, flush),
        "plain_ms": time_ms(torch, plain, flush),
        "library_ms": time_ms(torch, library, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def host_us_per_call(torch, fn, calls: int = 200, repeats: int = 5) -> float:
    """Host microseconds per call of ``fn`` (the enqueue, not the device's
    work), over ``calls`` calls started with the stream idle; the median
    of ``repeats``."""
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[len(runs) // 2]


def wrapper_host_costs(torch, ops, gen, dev) -> dict:
    """Each kernel wrapper's host cost per call at its decode shape, beside
    torch.add on its first tensor (one eager PyTorch launch)."""
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    x, delta, w = randn(BATCH, 4096), randn(BATCH, 4096), randn(4096)
    q = randn(BATCH, 1, 32, 128)
    k, v = randn(BATCH, DECODE_KV, 8, 128), randn(BATCH, DECODE_KV, 8, 128)
    pq, pool = randn(8, 32, 128), randn(256, 16, 8, 128)
    tables = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(8, 8)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    kv_lens = torch.full((BATCH,), DECODE_KV, dtype=torch.int32, device=dev)
    calls = {
        "rmsnorm_cuda": (lambda: ops.rmsnorm_cuda(x, w, 1e-5), x),
        "add_rmsnorm_cuda": (lambda: ops.add_rmsnorm_cuda(x, delta, w, 1e-5), x),
        "flash_attention_cuda": (lambda: ops.flash_attention_cuda(
            q, k, v, causal=True, q_offset=DECODE_KV - 1), q),
        "cached_attention_cuda": (lambda: ops.cached_attention_cuda(q, k, v, kv_lens), q),
        "paged_attention_cuda": (lambda: ops.paged_attention_cuda(
            pq, pool, pool, tables, lens), pq),
    }
    out = {}
    for name, (fn, first) in calls.items():
        out[name] = {"wrapper_us": host_us_per_call(torch, fn),
                     "torch_add_us": host_us_per_call(torch, lambda: torch.add(first, first))}
    # the two calls the add mode replaced on the model's path
    out["add_rmsnorm_cuda"]["add_then_rmsnorm_cuda_us"] = host_us_per_call(
        torch, lambda: ops.rmsnorm_cuda(x + delta, w, 1e-5))
    print(f"  host us per call (200 calls, stream idle at the start): {json.dumps(out)}",
          flush=True)
    return out


def attention_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


def flash_case(torch, F, ops, flush, name, b, sq, sk, hq, hkv, d, dtype, q_offset, gen, dev):
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, d), generator=gen, device=dev).to(dtype)
    dn = str(dtype).split(".")[-1]
    err = compare(torch, "attention", name,
                  ops.flash_attention_cuda(q, k, v, causal=True, q_offset=q_offset),
                  ops.attention_reference(q, k, v, causal=True, q_offset=q_offset), dn)
    es = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
    flops = 4 * d * attention_pairs(sq, sk, True, q_offset) * b * hq
    b_ms, b_by = bound(nbytes, flops, dn)
    # SDPA's is_causal aligns the mask top-left: the same function as ours
    # when sq == sk (q_offset 0), or for one query that sees every key
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if sq == sk and q_offset == 0:
        lib_causal = True
    elif sq == 1 and q_offset == sk - 1:
        lib_causal = False
    else:
        fail(f"{name}: no library call computes this case")
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=lib_causal, enable_gqa=True)
    return {
        "case": name, "q": [b, sq, hq, d], "kv": [b, sk, hkv, d], "q_offset": q_offset,
        "dtype": dn, "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.flash_attention_cuda(
            q, k, v, causal=True, q_offset=q_offset), flush),
        "plain_ms": time_ms(torch, lambda: ops.attention_reference(
            q, k, v, causal=True, q_offset=q_offset), flush),
        "library_ms": time_ms(torch, lib, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def cached_case(torch, F, ops, flush, name, lens, cap, hq, hkv, d, dtype, gen, dev, sq=1):
    """One greedy decode step's attention with device lengths: q [B, Sq,
    Hq, D] over a whole cache [B, cap, Hkv, D], row b valid to lens[b]."""
    b = len(lens)
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, cap, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, cap, hkv, d), generator=gen, device=dev).to(dtype)
    n = torch.tensor(lens, dtype=torch.int32, device=dev)
    dn = str(dtype).split(".")[-1]
    err = compare(torch, "attention", name, ops.cached_attention_cuda(q, k, v, n),
                  ops.cached_attention_reference(q, k, v, n), dn)
    es = q.element_size()
    # the valid K/V rows, q and the output once, and the lengths
    nbytes = (2 * sum(lens) * hkv * d + 2 * q.numel()) * es + 4 * b
    pairs = sum(attention_pairs(sq, length, True, length - sq) for length in lens)
    b_ms, b_by = bound(nbytes, 4 * d * hq * pairs, dn)
    # yardstick: SDPA over the whole cache with the same mask as a boolean
    k_pos = torch.arange(cap, device=dev)
    q_pos = n[:, None].long() - sq + torch.arange(sq, device=dev)[None, :]
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < n[:, None, None].long()))[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return {
        "case": name, "q": [b, sq, hq, d], "kv": [b, cap, hkv, d], "lens": list(lens),
        "dtype": dn, "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.cached_attention_cuda(q, k, v, n), flush),
        "plain_ms": time_ms(torch, lambda: ops.cached_attention_reference(q, k, v, n), flush),
        "library_ms": time_ms(torch, lib, flush),
        "library": "scaled_dot_product_attention over the whole cache with a boolean mask",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def paged_case(torch, F, ops, flush, name, hq, hkv, d, dtype, gen, dev, block=16,
               n_blocks=256, mb=8, lens=PAGED_LENS):
    """One decode tick's paged attention: q [S, Hq, D] over one layer's
    pools [N, B, Hkv, D] through tables of distinct random live blocks."""
    slots = len(lens)
    q = torch.randn((slots, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((n_blocks, block, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((n_blocks, block, hkv, d), generator=gen, device=dev).to(dtype)
    ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((slots, mb), dtype=torch.int32)
    pages = 0
    for s, n in enumerate(lens):
        used = -(-n // block)
        pages += used
        if s > 0:  # lane 0 stays all scratch: the inactive slot
            tables[s, :used] = torch.tensor(ids[:used], dtype=torch.int32)
            ids = ids[used:]
    tables = tables.to(dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    dn = str(dtype).split(".")[-1]
    args = (q, k, v, tables, seq_lens)
    err = compare(torch, "attention", name, ops.paged_attention_cuda(*args),
                  ops.paged_attention_reference(*args), dn)
    es = q.element_size()
    valid = sum(lens)
    # each valid K/V row, q and the output once, and the table entries of
    # the covered pages and the lengths
    nbytes = (2 * valid * hkv * d + 2 * q.numel()) * es + 4 * (pages + slots)
    b_ms, b_by = bound(nbytes, 4 * d * valid * hq, dn)
    # yardstick: SDPA over the cache already gathered through the tables
    # (the gather is excluded from its time; no PyTorch call reads KV
    # through a block table)
    cap = mb * block
    kg = k[tables.long()].reshape(slots, cap, hkv, d).transpose(1, 2)
    vg = v[tables.long()].reshape(slots, cap, hkv, d).transpose(1, 2)
    mask = (torch.arange(cap, device=dev)[None, :] < seq_lens[:, None].long())[:, None, None, :]
    qt = q[:, :, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kg, vg, attn_mask=mask, enable_gqa=True)
    return {
        "case": name, "q": [slots, hq, d], "pool": [n_blocks, block, hkv, d],
        "tables": [slots, mb], "seq_lens": list(lens), "dtype": dn, "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.paged_attention_cuda(*args), flush),
        "plain_ms": time_ms(torch, lambda: ops.paged_attention_reference(*args), flush),
        "library_ms": time_ms(torch, lib, flush),
        "library": "scaled_dot_product_attention over the gathered cache, gather excluded",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def request_split(torch, llama, params, prompt, cfg, dev, cuda_graph: bool = True,
                  steps: int = 16, profiled: int = 4) -> dict:
    """Prefill ms, decode step ms (host clock, synchronised) and the
    device's busy share of a decode step, for the steps of
    ``greedy_generate``'s decoder (eager, or one CUDA graph replayed per
    step): kernel time per step from torch.profiler over ``profiled``
    steps, over the unprofiled step time. The first two steps (with the
    graph's capture) are not timed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, s = prompt.shape
    cache = llama.init_cache(cfg, b, s + 2 + steps + profiled, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = llama.forward(params, prompt, cfg, cache=cache,
                                  positions=torch.arange(s, device=dev).expand(b, s))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(logits[:, -1]).all():
            fail("non-finite prefill logits")
        decoder = llama.GreedyDecoder(params, cfg, cache, logits[:, -1:].argmax(-1), s,
                                      cuda_graph=cuda_graph)

        def decode(n):
            for _ in range(n):
                decoder.step()

        t0 = time.perf_counter()
        decode(2)
        torch.cuda.synchronize()
        first_two_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        decode(steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode(profiled)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / profiled
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "cuda_graph": cuda_graph, "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "first_two_steps_ms": first_two_ms,
        "decode_elementwise": elementwise_share(kernels, profiled),
        # None: the profiler saw no device time here ("not measured")
        "decode_step_device_ms": device_ms or None,
        "decode_device_busy_share": (device_ms / step_ms) if device_ms else None,
        "decode_kernels_per_step": sum(e.count for e in kernels) / profiled,
        "decode_port_kernels": port_kernel_shares(kernels, profiled),
        "decode_top_kernels": [
            {"name": e.key[:70], "ms_per_step": e.self_device_time_total / 1e3 / profiled,
             "calls_per_step": e.count / profiled} for e in top],
    }


# the port's kernels by the names the profiler gives their instances
PORT_KERNELS = (("paged_attention", ("PagedPolicy", "paged_attention_kernel")),
                ("flash_attention", ("flash_rows_kernel", "DensePolicy", "CachedPolicy",
                                     "flash_attention_kernel")),
                ("rmsnorm", ("rmsnorm_kernel",)))


def port_kernel_shares(kernels, steps: int) -> dict:
    """Device ms and calls per step of each port kernel, from the
    profiler's per-kernel averages over ``steps`` steps."""
    out = {name: {"ms_per_step": 0.0, "calls_per_step": 0.0} for name, _ in PORT_KERNELS}
    for e in kernels:
        for name, marks in PORT_KERNELS:
            if any(mark in e.key for mark in marks):
                out[name]["ms_per_step"] += e.self_device_time_total / 1e3 / steps
                out[name]["calls_per_step"] += e.count / steps
                break
    return out


def elementwise_share(kernels, steps: int) -> dict:
    """Device ms and calls per step of PyTorch's elementwise kernels (adds,
    casts, copies, activations: names with ``elementwise_kernel``)."""
    hits = [e for e in kernels if "elementwise_kernel" in e.key]
    return {"ms_per_step": sum(e.self_device_time_total for e in hits) / 1e3 / steps,
            "calls_per_step": sum(e.count for e in hits) / steps}


def serve_prompts(torch, cfg, seed: int, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (serve_prompt_len(i),), generator=gen,
                          device=dev).tolist() for i in range(SERVE_REQUESTS)]


def p50(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def zero_counts(ops) -> None:
    for fn in (ops.rmsnorm_cuda, ops.add_rmsnorm_cuda, ops.flash_attention_cuda,
               ops.cached_attention_cuda, ops.paged_attention_cuda):
        fn.launches = 0


def read_counts(ops) -> dict:
    """The wrappers' counters. ``flash_attention`` counts both entries of
    csrc/flash_attention.cu, ``cached_attention`` the device-length one."""
    return {"rmsnorm": ops.rmsnorm_cuda.launches,
            "add_rmsnorm": ops.add_rmsnorm_cuda.launches,
            "flash_attention": ops.flash_attention_cuda.launches,
            "cached_attention": ops.cached_attention_cuda.launches,
            "paged_attention": ops.paged_attention_cuda.launches}


def greedy_launches(n_layers: int) -> dict:
    """Launch counts of one greedy_generate request: 1 + NEW_TOKENS
    forwards, the prefill's attention through the flash entry and every
    decode step's through the device-length entry (which the flash
    counter also counts)."""
    forwards = 1 + NEW_TOKENS
    return {**norm_launches(forwards, n_layers), "flash_attention": forwards * n_layers,
            "cached_attention": NEW_TOKENS * n_layers, "paged_attention": 0}


def norm_launches(forwards: int, n_layers: int) -> dict:
    """RMSNorm launches of ``forwards`` model forwards: 2L + 1 each, of
    which 2L (every norm after a residual add) in the add mode."""
    return {"rmsnorm": forwards * (2 * n_layers + 1), "add_rmsnorm": forwards * 2 * n_layers}


def spills_in(instances: list, mark: str) -> list:
    """Names of the kernel instances with ``mark`` in their name that spill."""
    return [i["name"] for i in instances
            if mark in i["name"] and (i["spill_stores"] or i["spill_loads"])]


def serve_drain(torch, ops, eng, prompts) -> dict:
    """One measured drain of the config-6 traffic: the counts set to 0
    just before, read just after; every request must end with exactly
    its budget of in-range tokens."""
    budgets = [serve_budget(i) for i in range(SERVE_REQUESTS)]
    eng.reset_phase_stats()
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = read_counts(ops)
    by_rid = {r.rid: r for r in eng.finished}
    reqs = [by_rid.get(rid) for rid in rids]
    for req, budget in zip(reqs, budgets):
        if req is None or len(req.output) != budget or min(req.output) < 0 \
                or max(req.output) >= eng.cfg.vocab_size:
            fail(f"serving: a request did not end with its budget of {budget} in-range tokens")
    ticks = eng.phase_counts["device_steps"]  # decode steps: H per horizon
    prefills = SERVE_REQUESTS  # 8 slots x 7 blocks never exhaust 255 blocks: no preemption
    expected = {**norm_launches(prefills + ticks, eng.cfg.n_layers),
                "flash_attention": prefills * eng.cfg.n_layers, "cached_attention": 0,
                "paged_attention": ticks * eng.cfg.n_layers}
    print(f"  serving (pipeline_decode={eng.pipeline_decode}, decode_horizon="
          f"{eng.decode_horizon}) launches {launches}, expected {expected}", flush=True)
    if launches != expected:
        fail("the serving path did not run every norm and attention through the kernels")
    tokens = sum(budgets)
    ph = eng.phase_seconds
    return {
        "pipeline_decode": eng.pipeline_decode, "decode_horizon": eng.decode_horizon,
        "requests": SERVE_REQUESTS, "new_tokens": tokens, "drain_s": drain_s,
        "tok_per_s": tokens / drain_s, "ticks": ticks, "prefills": prefills,
        "horizons": eng.phase_counts["horizons"],
        "decode_tick_ms": (ph["decode_device"] + ph["host_sync"]) / ticks * 1e3,
        "tick_enqueue_ms": ph["decode_device"] / ticks * 1e3,
        "prefill_ms": ph["prefill"] / prefills * 1e3,
        "host_sync_share": ph["host_sync"] / drain_s,
        "ttft_ms_p50": p50(r.ttft_seconds for r in reqs) * 1e3,
        "tpot_ms_p50": p50(r.tpot_seconds for r in reqs) * 1e3,
        "launches": launches, "outputs": [r.output for r in reqs],
    }


def tick_profile(torch, eng, prompts, steps: int = 8, profiled: int = 4,
                 warm: int = 3) -> dict:
    """Steady decode ticks of a full engine (a tick is one horizon when
    the engine has one): host ms per step() over ``steps``
    (synchronised), and the device's busy share of a step from
    torch.profiler's kernel time over ``profiled`` more steps, after
    ``warm`` steps (admission and the first ticks). Every slot's budget
    of 64 lasts the whole stretch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if (warm + steps + profiled) * eng.decode_horizon >= 64:
        fail("tick_profile: the budgets would end inside the measured ticks")
    for p in prompts[:eng.pcfg.max_slots]:
        eng.submit(p, 64)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / profiled
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "step_ms": step_ms, "tokens_per_step_per_slot": eng.decode_horizon,
        "elementwise": elementwise_share(kernels, profiled),
        # None: the profiler saw no device time here ("not measured")
        "step_device_ms": device_ms or None,
        "device_busy_share": (device_ms / step_ms) if device_ms else None,
        "kernels_per_step": sum(e.count for e in kernels) / profiled,
        "port_kernels": port_kernel_shares(kernels, profiled),
        "top_kernels": [
            {"name": e.key[:70], "ms_per_step": e.self_device_time_total / 1e3 / profiled,
             "calls_per_step": e.count / profiled} for e in top],
    }


def serving_phase(torch, ops, serving, params, cfg, seed: int, dev, card: str) -> dict:
    """The continuous-batching engine at full width in its three modes
    (the classic tick with dispatch-ahead off and on, and the fused
    horizon of 8 steps replayed as one CUDA graph): one warm drain each,
    then measured drains in turns (SERVE_ORDER) so that host-clock drift
    between the modes cancels, then a profiled stretch of steady ticks."""
    warm = serve_prompts(torch, cfg, seed + 10, dev)
    prompts = serve_prompts(torch, cfg, seed + 11, dev)
    torch.cuda.reset_peak_memory_stats()
    engines = {}
    for mode, (pipeline, horizon) in SERVE_MODES.items():
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**SERVE_PAGING),
                                    pipeline_decode=pipeline, decode_horizon=horizon,
                                    dispatch_depth=1)
        for i, p in enumerate(warm):
            eng.submit(p, serve_budget(i))
        eng.run()
        engines[mode] = eng
    drains = {mode: [] for mode in SERVE_MODES}
    for mode in SERVE_ORDER:
        drains[mode].append(serve_drain(torch, ops, engines[mode], prompts))
    outputs = [d.pop("outputs") for runs in drains.values() for d in runs]
    if any(o != outputs[0] for o in outputs):
        fail("serving: the engine's modes gave different tokens")
    out = {"model": "llama3_8b", "dtype": "bfloat16", "paging": SERVE_PAGING,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
           "identical_tokens": True, "order": ", ".join(SERVE_ORDER)}
    for mode, eng in engines.items():
        runs = drains[mode]
        h = eng.decode_horizon
        out[mode] = {
            "pipeline_decode": eng.pipeline_decode, "decode_horizon": h,
            "drains": runs,
            "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
            "profile": tick_profile(torch, eng, warm, *((8, 4, 3) if h == 1 else (2, 2, 1))),
        }
    return out


def engine_cross_check(torch, ops, llama, serving, cfg, seed: int, dev) -> dict:
    """fp32, 2 layers at the 8B widths (TF32 off): the same seeded
    weights served by the engine on the card (kernels, the horizon as a
    CUDA graph) and on the CPU (plain versions), with the classic tick and
    with a horizon of 8, must give identical tokens, and the horizon's
    first tokens must be the classic tick's."""
    cfg3 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = llama.init_params(cfg3, torch.Generator(device=dev).manual_seed(seed + 4), dev)
    params_cpu = tree_to(params, "cpu")
    gen = torch.Generator().manual_seed(seed + 5)
    prompts = [torch.randint(0, cfg3.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 12, 17, 30)]
    pcfg = serving.PagedConfig(max_slots=4, block_size=16, num_blocks=32, max_blocks_per_seq=4,
                               prefix_caching=False)
    outs, launches = {}, {}
    t0 = time.perf_counter()
    for horizon in (1, 8):
        for side, tree in (("card", params), ("cpu", params_cpu)):
            eng = serving.ServingEngine(tree, cfg3, pcfg, pipeline_decode=True,
                                        decode_horizon=horizon, dispatch_depth=1)
            for p in prompts:
                eng.submit(p, CROSS_BUDGET[horizon])
            start = ops.paged_attention_cuda.launches
            eng.run()
            outs[side, horizon] = [r.output for r in sorted(eng.finished, key=lambda r: r.rid)]
            if side == "card":
                launches[horizon] = ops.paged_attention_cuda.launches - start
                if launches[horizon] != eng.phase_counts["device_steps"] * cfg3.n_layers:
                    fail("engine cross-check did not run the paged kernel on every step")
                if horizon > 1 and eng.phase_counts["horizons"] == 0:
                    fail("engine cross-check ran no horizon")
    del params
    same = all(outs["card", h] == outs["cpu", h] for h in (1, 8))
    # the horizon's first tokens are the classic engine's
    prefix = all(a[:CROSS_BUDGET[1]] == b for a, b in zip(outs["card", 8], outs["card", 1]))
    result = {"requests": len(prompts), "new_tokens": CROSS_BUDGET,
              "identical_tokens": same, "horizon_extends_classic": prefix,
              "card_paged_launches": {f"h{h}": n for h, n in launches.items()},
              "seconds": time.perf_counter() - t0}
    for h in (1, 8):
        if outs["card", h] == outs["cpu", h]:
            continue
        for p, a, b in zip(prompts, outs["card", h], outs["cpu", h]):
            if a != b:
                j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                with torch.no_grad():
                    logits, _ = llama.forward(params_cpu, torch.tensor([p + b[:j]]), cfg3)
                top = logits[0, -1].topk(2).values
                result["first_divergence"] = {"horizon": h, "prompt_len": len(p), "token": j,
                                              "card": a[j], "cpu": b[j],
                                              "top_two_gap": float(top[0] - top[1])}
                break
        break
    print("engine (2 layers, 8B widths, fp32, card vs CPU): " + json.dumps(result), flush=True)
    if not prefix:
        fail("the fp32 engine's horizon of 8 disagrees with its classic tick")
    if not result["identical_tokens"]:
        fail("the engine on the card and on the CPU gave different tokens")
    return result


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    # ---- 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    # exact fp32 everywhere the comparisons run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    try:
        from bobrapet_tpu_torch import ops, serving
        from bobrapet_tpu_torch.kernels import build as kbuild
        from bobrapet_tpu_torch.models import llama, tree_bytes
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from the root of the repo")

    # ---- 2. build
    t0 = time.perf_counter()
    kbuild.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s, sources {[p.name for p in kbuild.sources()]}", flush=True)
    instances = ptxas_instances(kbuild.build_log)
    for inst, name in zip(instances, demangle([i["name"] for i in instances])):
        inst["name"] = name
        print(f"  ptxas {name}: {inst['registers']} registers, {inst['smem_bytes']} bytes "
              f"static smem, spill stores {inst['spill_stores']} B, spill loads "
              f"{inst['spill_loads']} B", flush=True)
    if kbuild.build_log and not instances:
        fail("the build log shows no ptxas line")
    # the tensor-core attention kernels (namespace bobra::attn) and the
    # RMSNorm instances (the row held in registers) must not spill; the
    # older scalar attention kernels are reported as they are
    if spills_in(instances, "attn"):
        fail("a tensor-core attention kernel spills registers")
    if spills_in(instances, "rmsnorm_kernel"):
        fail(f"an RMSNorm instance spills registers: {spills_in(instances, 'rmsnorm_kernel')}")

    # ---- 3. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    bf16, f32 = torch.bfloat16, torch.float32
    d, hq, hkv, hd = 4096, 32, 8, 128
    print("kernels vs plain versions:", flush=True)
    rms_cases = [
        rmsnorm_case(torch, F, ops, flush, "rmsnorm prefill", BATCH * PROMPT, d, bf16, gen, dev),
        rmsnorm_case(torch, F, ops, flush, "rmsnorm decode", BATCH, d, bf16, gen, dev),
        rmsnorm_case(torch, F, ops, flush, "rmsnorm prefill fp32", BATCH * PROMPT, d, f32,
                     gen, dev),
        rmsnorm_case(torch, F, ops, flush, "add_rmsnorm prefill", BATCH * PROMPT, d, bf16, gen,
                     dev, add=True),
        rmsnorm_case(torch, F, ops, flush, "add_rmsnorm decode", BATCH, d, bf16, gen, dev,
                     add=True),
        rmsnorm_case(torch, F, ops, flush, "add_rmsnorm prefill fp32", BATCH * PROMPT, d, f32,
                     gen, dev, add=True),
    ]
    cached_cases = [
        cached_case(torch, F, ops, flush, "cached decode", (DECODE_KV,) * BATCH, CACHE_ROWS,
                    hq, hkv, hd, bf16, gen, dev),
        cached_case(torch, F, ops, flush, "cached decode ragged",
                    tuple(PROMPT + 1 + 9 * i for i in range(BATCH - 1)) + (CACHE_ROWS,),
                    CACHE_ROWS, hq, hkv, hd, bf16, gen, dev),
        cached_case(torch, F, ops, flush, "cached decode fp32", (1, DECODE_KV), CACHE_ROWS,
                    hq, hkv, hd, f32, gen, dev),
        cached_case(torch, F, ops, flush, "cached decode D=32", (1, 33, 64), 64, 4, 2, 32, bf16,
                    gen, dev),
    ]
    flash_cases = [
        flash_case(torch, F, ops, flush, "flash prefill", BATCH, PROMPT, PROMPT, hq, hkv, hd,
                   bf16, 0, gen, dev),
        flash_case(torch, F, ops, flush, "flash decode", BATCH, 1, DECODE_KV, hq, hkv, hd,
                   bf16, DECODE_KV - 1, gen, dev),
        flash_case(torch, F, ops, flush, "flash engine prefill", 1, 64, 64, hq, hkv, hd, bf16,
                   0, gen, dev),
        flash_case(torch, F, ops, flush, "flash long decode", BATCH, 1, LONG_KV, hq, hkv, hd,
                   bf16, LONG_KV - 1, gen, dev),
        flash_case(torch, F, ops, flush, "flash ragged", 2, 100, 100, hq, hkv, hd, bf16, 0,
                   gen, dev),
        flash_case(torch, F, ops, flush, "flash prefill fp32", 2, PROMPT, PROMPT, hq, hkv, hd,
                   f32, 0, gen, dev),
    ]
    paged_cases = [
        paged_case(torch, F, ops, flush, "paged decode", hq, hkv, hd, bf16, gen, dev),
        paged_case(torch, F, ops, flush, "paged long decode", hq, hkv, hd, bf16, gen, dev,
                   n_blocks=LONG_PAGED_BLOCKS, mb=LONG_KV_PAGES, lens=LONG_PAGED_LENS),
        paged_case(torch, F, ops, flush, "paged decode fp32", hq, hkv, hd, f32, gen, dev),
        paged_case(torch, F, ops, flush, "paged decode D=32", 4, 2, 32, bf16, gen, dev,
                   block=8, n_blocks=64, lens=(1, 8, 9, 17, 24, 31, 32, 2), mb=4),
    ]
    for c in rms_cases + flash_cases + cached_cases + paged_cases:
        print(f"  {c['case']}: kernel {c['ms']:.5f} ms, plain {c['plain_ms']:.5f} ms, "
              f"library {c['library_ms']:.5f} ms, bound {c['bound_ms']:.6f} ms "
              f"({c['bound_by']})", flush=True)
    host_costs = wrapper_host_costs(torch, ops, gen, dev)
    del flush

    # ---- 4. the greedy path: Llama-3-8B, one request four times, eager and graphed in turns
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    print(f"llama3_8b: {cfg.n_layers} layers, dim {cfg.dim}, {weight_bytes / 1e9:.2f} GB of "
          f"bf16 weights, made in {time.perf_counter() - t0:.1f} s", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expected = greedy_launches(cfg.n_layers)
    runs, outputs = [], []
    for graph in GREEDY_RUNS:
        zero_counts(ops)
        t0 = time.perf_counter()
        toks = llama.greedy_generate(params, prompt, cfg, max_new_tokens=NEW_TOKENS,
                                     cuda_graph=graph)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(ops)
        print(f"greedy path (cuda_graph={graph}) launches {launches}, expected {expected}",
              flush=True)
        if launches != expected:
            fail("the main path did not run every norm and attention through the kernels")
        if (tuple(toks.shape) != (BATCH, NEW_TOKENS) or toks.dtype != torch.int32
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
            fail(f"bad generated tokens: {toks.dtype} {tuple(toks.shape)}")
        outputs.append(toks)
        runs.append({"cuda_graph": graph, "request_s": seconds,
                     "tok_per_s": BATCH * NEW_TOKENS / seconds, "launches": launches})
    if any(not torch.equal(o, outputs[0]) for o in outputs):
        fail("greedy path: the CUDA-graphed decode changed the tokens")
    launches = {k: sum(r["launches"][k] for r in runs) for k in expected}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the parts of a request, after the counted runs: one prefill, then
    # decode steps timed alone and a few under the profiler, in turns
    splits = [request_split(torch, llama, params, prompt, cfg, dev, cuda_graph=graph)
              for graph in GREEDY_RUNS]
    decode_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    main = {
        "model": "llama3_8b", "dtype": "bfloat16", "batch": BATCH, "prompt": PROMPT,
        "new_tokens": NEW_TOKENS, "order": "eager, graph, graph, eager",
        "identical_tokens": True, "runs": runs,
        "splits": [{**sp, "decode_tok_per_s": BATCH / sp["decode_step_ms"] * 1e3}
                   for sp in splits],
        "decode_step_bound_ms": decode_bound_ms, "weight_bytes": weight_bytes,
        "peak_memory_gb": peak_gb, "launches": launches, "card": card,
    }
    print("greedy path: " + json.dumps(main), flush=True)

    # ---- 5. the serving path on the same weights
    served = serving_phase(torch, ops, serving, params, cfg, args.seed, dev, card)
    print("serving path: " + json.dumps(served), flush=True)
    del params
    launches_by_path = {"greedy": launches,
                        **{f"serving_{mode}": served[mode]["launches"] for mode in SERVE_MODES}}

    # ---- 6. whole path and engine, card vs CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = llama.init_params(cfg2, torch.Generator(device=dev).manual_seed(args.seed + 2), dev)
    toks = torch.randint(0, cfg2.vocab_size, (2, 16), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(args.seed + 3))
    pos = torch.arange(16, device=dev).expand(2, 16)
    with torch.no_grad():
        before = ops.flash_attention_cuda.launches
        gpu_logits, _ = llama.forward(params2, toks, cfg2,
                                      cache=llama.init_cache(cfg2, 2, 16, device=dev),
                                      positions=pos)
        if ops.flash_attention_cuda.launches != before + cfg2.n_layers:
            fail("whole-path check did not run the kernels")
        params_cpu = tree_to(params2, "cpu")
        del params2
        t0 = time.perf_counter()
        cpu_logits, _ = llama.forward(params_cpu, toks.cpu(), cfg2,
                                      cache=llama.init_cache(cfg2, 2, 16, device="cpu"),
                                      positions=pos.cpu())
        cpu_s = time.perf_counter() - t0
    err = (gpu_logits.cpu() - cpu_logits).abs()
    whole = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
             "max_abs_logit": float(cpu_logits.abs().max()),
             "tolerance": [LOGIT_MAX_ERR, LOGIT_MEAN_ERR],
             "argmax_agree": float((gpu_logits.cpu().argmax(-1) == cpu_logits.argmax(-1))
                                   .float().mean()), "cpu_s": cpu_s}
    print("whole path (2 layers, 8B widths, card vs CPU): " + json.dumps(whole), flush=True)
    if not torch.isfinite(gpu_logits).all():
        fail("non-finite logits on the card")
    if whole["max_abs_err"] > LOGIT_MAX_ERR or whole["mean_abs_err"] > LOGIT_MEAN_ERR:
        fail("card and CPU logits disagree")
    del params_cpu, gpu_logits
    engine_cross_check(torch, ops, llama, serving, cfg, args.seed, dev)

    # ---- 7. result
    # each kernel's own launches: the flash counter also counts the
    # device-length entry's
    own = {k: {**path, "flash_attention": path["flash_attention"] - path["cached_attention"]}
           for k, path in launches_by_path.items()}

    def entry(name, source, replaces, cases, main_case):
        top = next(c for c in cases if c["case"] == main_case)
        main_errs = [c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(path[name] for path in own.values()),
            "launches_by_path": {k: path[name] for k, path in own.items()},
            "max_abs_err": max(main_errs),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"], "cases": cases,
        }

    rms_entry = entry("rmsnorm", "bobrapet_tpu_torch/csrc/rmsnorm.cu",
                      "bobrapet_tpu/ops/rmsnorm.py:33", rms_cases, "rmsnorm decode")
    rms_entry["launches_add_mode"] = sum(path["add_rmsnorm"] for path in own.values())
    kernels = {"kernels": [
        rms_entry,
        entry("flash_attention", "bobrapet_tpu_torch/csrc/flash_attention.cu",
              "bobrapet_tpu/ops/attention.py:117", flash_cases, "flash decode"),
        entry("cached_attention", "bobrapet_tpu_torch/csrc/flash_attention.cu",
              "bobrapet_tpu/ops/attention.py:117", cached_cases, "cached decode"),
        entry("paged_attention", "bobrapet_tpu_torch/csrc/paged_attention.cu",
              "bobrapet_tpu/serving/engine.py:3106", paged_cases, "paged decode"),
    ], "build_s": build_s, "host_us_per_call": host_costs}
    print(json.dumps(kernels), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
