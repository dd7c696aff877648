#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bobrapet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--quant-sweep]

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
   engine decode tick, phase 7's prefill chunk at q_offset 512 and its
   decode tick over 41-block tables, phase 8's int8 products at the draft's
   decode and prefill shapes, its T-query verify and draft catch-up over
   the paged cache, and the standalone verify's 20 packed rows through the
   cached entry) plus long-cache decodes (dense over 2048 rows, paged up to
   1024), ragged, fp32 and narrow-head cases: max abs error
   against a stated tolerance, and the times (CUDA events, median of 50
   launches, L2 flushed before each) of the kernel, the plain version and
   one PyTorch library call for the same function (a yardstick only; the
   port never calls it), beside the least time the card could take (for
   RMSNorm also its time with the L2 left warm, and a PyTorch copy that
   moves the same bytes under the flushed timer); then the host's
   microseconds per call of each kernel wrapper against torch.add; with
   --quant-sweep also the bf16 int8 kernel's time at each forced cluster
   split (1, 2, 4, 8) beside the split its rule picks;
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
   classic and at a horizon of 8, both plain and with prefix caching,
   chunked prefill and four LoRA adapters (card against CPU, and chunked
   with prefixes against one-shot prefill on the card), and with a draft
   (speculative decoding: card against CPU, and against the draft-less
   engine);
7. prefix caching, chunked prefill and multi-LoRA at full width: Llama-3-8B
   again, 8 slots over 512 blocks of 16 (41 a sequence), the unified leg
   of bench.py's config 14 (12 requests of a shared 128-token system
   prompt and a 512-token tail, 8 new tokens each, interleaved 2:1 with 8
   of 8-11 tokens and 64 new, closed loop, window 14) through the engine
   with prefix caching and chunks of 128 (A) and with one-shot prefill and
   no cache (B), drained A, B, B, A at a horizon of 8: drain s, tok/s,
   TTFT and TPOT percentiles, hit and miss tokens, chunks, phase seconds
   and peak memory, exact launch counts, the same tokens from both drains
   of an engine, and A's first tokens against B's wherever B's top-2
   margin exceeds the logit error between the two prefills; then config
   6's 16 requests over four stacked adapters (the zero one and three of
   rank 8 on wq/wv), adapter i % 4: the zero adapter's requests give the
   LoRA-free engine's tokens bit for bit, every other adapter changes some
   request, and the horizon's ms with and without LoRA;
8. speculative decoding at full width: Llama-3-8B on the same weights,
   bench.py's serving-child traffic (16 requests of 32-128 tokens, 32 new
   each, 8 slots over 256 blocks of 16, 16 a sequence, a horizon of 8):
   the draft-less engine and the engine with the target's int8 tree as
   its draft (spec_k 4, the payoff guard off, so the speculative horizon
   is what runs) drained in turns (plain, spec, spec, plain), then an
   engine with the guard warmed until it decides; tok/s, accept rate,
   phase seconds, TTFT and TPOT, peak memory, the share of positions where
   the speculative tokens equal the plain ones, and exact launch counts
   (every verify through the T-query paged kernel, every int8 product
   through the int8 kernel); at each request's first divergence from the
   plain engine, the plain one-token step's logit of its token less that
   of the speculative token must stay within twice the logit error between
   the one-token and verify forms of the same context (recomputed through
   the engine's own append, every alignment of verifies); then standalone
   speculative_generate (the 8B target, a llama_tiny draft of its
   vocabulary, a [1, 64] prompt, 64 new tokens, k 4) against
   greedy_generate, its first divergence held the same way;
9. one JSON line of kernels, the card line, and last
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


# phase 7: the unified leg of bench.py's config 14 (bench.py:1096-1140) at
# full width, prefix caching with chunks of 128 (A) against one-shot prefill
# with no cache (B), drained in turns
PREFIX_PAGING = dict(max_slots=8, block_size=16, num_blocks=512, max_blocks_per_seq=41,
                     prefix_caching=True, prefill_chunk=128)
ONESHOT_PAGING = {**PREFIX_PAGING, "prefix_caching": False, "prefill_chunk": None}
PREFIX_HORIZON = 8
N_LONG, N_SHORT, LONG_NEW, SHORT_NEW, WINDOW = 12, 8, 8, 64, 14
SYSTEM_TOKENS, TAIL_TOKENS = 128, 512
PREFIX_ORDER = ("A", "B", "B", "A")
# the chunk attention of a long request after its matched system prompt,
# and a decode tick over 41-block tables, lanes from 9 to 648 rows
CHUNK_Q_OFFSET = 512
PREFIX_PAGED_LENS = (9, 90, 180, 270, 360, 450, 540, 648)
# multi-LoRA: the zero adapter and three of LoRAConfig()'s defaults (rank 8,
# alpha 16, wq and wv), B given content
N_ADAPTERS = 4
# the fp32 engine cross-check with prefix caching, chunks and LoRA: a
# shared 32-token system prompt, chunks of 16, two waves
CROSS_PREFIX_PAGING = dict(max_slots=4, block_size=16, num_blocks=48, max_blocks_per_seq=6,
                           prefix_caching=True, prefill_chunk=16)
CROSS_TAILS = ((5, 25, 40, 9), (30, 2))

# phase 8: bench.py's serving child (bench.py:2386-2392) at full width, the
# target's int8 tree as the draft. No prefix cache: the drains repeat the
# same prompts, and a cache would turn the later drains into cache hits.
SPEC_PAGING = dict(max_slots=8, block_size=16, num_blocks=256, max_blocks_per_seq=16,
                   prefix_caching=False)
SPEC_REQUESTS, SPEC_NEW, SPEC_K, SPEC_HORIZON = 16, 32, 4, 8
SPEC_ORDER = ("plain", "spec", "spec", "plain")
# the guarded engine's warm drains until the guard decides (bench.py's 4)
GUARD_WARM_DRAINS = 4
# the standalone speculative decode (bench.py:2509-2531)
STANDALONE_PROMPT, STANDALONE_NEW = 64, 64
# phase 3's int8 products: (name, M, K, N) at the draft's decode shapes
# (8 slots) and at a prefill bucket of 128 rows
QUANT_CASES = (("quant wq/wo decode", 8, 4096, 4096), ("quant wk/wv decode", 8, 4096, 1024),
               ("quant w_gate/w_up decode", 8, 4096, 14336),
               ("quant w_down decode", 8, 14336, 4096),
               ("quant lm_head decode", 8, 4096, 128256),
               ("quant w_gate prefill", 128, 4096, 14336))
# --quant-sweep: the forced splits, and two products at a verify's rows
# (8 slots x k + 1 = 5)
QUANT_SPLITS = (1, 2, 4, 8)
QUANT_VERIFY_CASES = (("quant wq/wo verify", 40, 4096, 4096),
                      ("quant w_gate/w_up verify", 40, 4096, 14336))
# how often each decode shape runs in one forward of a 32-layer model
QUANT_PER_LAYER = {"quant wq/wo decode": 2, "quant wk/wv decode": 2,
                   "quant w_gate/w_up decode": 2, "quant w_down decode": 1}
# phase 3's T-query cases over phase 8's pools: a verify of k + 1 = 5
# tokens and a draft catch-up of H = 8, lanes at lens = pos0 + T
MULTI_LENS = (5, 37, 64, 69, 100, 129, 160, 192)
# the standalone verify: 5 queries at the end of a 133-row cache
STANDALONE_CAP = STANDALONE_PROMPT + STANDALONE_NEW + SPEC_K + 1


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
# the int8 product: bf16 rounds the product to bf16, then the scale product
# again, and a sum in another order may move the first rounding by one ulp:
# 2^-6 of |plain| plus 1e-3 (its values are ~1); fp32 sums in another
# order: 1e-5 of |plain| plus 1e-4 (TF32's 10-bit mantissa would miss by
# ~5e-4)
QUANT_TOL = {"bfloat16": (1e-3, 2.0 ** -6), "float32": (1e-4, 1e-5)}


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
    atol, rtol = QUANT_TOL[dtype_name] if kind == "quant" else TOL[(kind, dtype_name)]
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
    extra = {}
    if sq == sk and q_offset == 0:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    elif sq == 1 and q_offset == sk - 1:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True)
    else:
        # queries after a cached prefix: the causal mask as a boolean
        q_pos = q_offset + torch.arange(sq, device=dev)
        mask = torch.arange(sk, device=dev)[None, :] <= q_pos[:, None]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        extra = {"library": "scaled_dot_product_attention with the causal mask as a boolean"}
    return {**extra,
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


def quant_bytes(m: int, k: int, n: int, es: int) -> int:
    """The int8 product's bytes: the int8 weight, x and the scale read once,
    the output written once."""
    return k * n + (m * k + n + m * n) * es


def quant_case(torch, ops, quant, flush, name, m, k, n, dtype, gen, dev):
    """One int8 product x [M, K] @ q [K, N] * scale [N] against the plain
    version (which widens the weight to x's type first). The yardstick is
    torch.matmul on the weight dequantized ahead of time (its widening not
    timed)."""
    leaf = quant.quantize_array(
        (torch.randn((k, n), generator=gen, device=dev) * (1.0 / 64)).to(dtype))
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    q, scale = leaf["q"], leaf["scale"]
    dn = str(dtype).split(".")[-1]
    err = compare(torch, "quant", name, ops.quant_matmul_cuda(x, q, scale),
                  ops.quant_matmul_reference(x, q, scale), dn)
    w = quant.dequantize_array(leaf)
    b_ms, b_by = bound(quant_bytes(m, k, n, x.element_size()), 2 * m * k * n, dn)
    return {
        "case": name, "x": [m, k], "q": [k, n], "dtype": dn, "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.quant_matmul_cuda(x, q, scale), flush),
        "plain_ms": time_ms(torch, lambda: ops.quant_matmul_reference(x, q, scale), flush),
        "library_ms": time_ms(torch, lambda: torch.matmul(x, w), flush),
        "library": "torch.matmul on the weight dequantized ahead of time",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def multi_pairs(lens, t: int) -> int:
    """Keys the queries of a T-query call see: query i of a lane sits at
    lens - T + i and sees every key up to it."""
    return sum(max(0, n - t + i + 1) for n in lens for i in range(t))


def paged_multi_case(torch, F, ops, flush, name, t, hq, hkv, d, dtype, gen, dev, block=16,
                     n_blocks=256, mb=16, lens=MULTI_LENS):
    """T queries a slot over one layer's pools through tables of distinct
    random live blocks, query i of slot s at lens[s] - T + i (a lane's
    lens is at least T: the engine's first query sits at pos0 >= 0)."""
    lens = tuple(max(n, t) for n in lens)
    slots = len(lens)
    q = torch.randn((slots, t, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((n_blocks, block, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((n_blocks, block, hkv, d), generator=gen, device=dev).to(dtype)
    ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((slots, mb), dtype=torch.int32)
    pages = 0
    for s_, n in enumerate(lens):
        used = -(-n // block)
        pages += used
        tables[s_, :used] = torch.tensor(ids[:used], dtype=torch.int32)
        ids = ids[used:]
    tables = tables.to(dev)
    n_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    dn = str(dtype).split(".")[-1]
    args = (q, k, v, tables, n_t)
    err = compare(torch, "attention", name, ops.paged_attention_multi_cuda(*args),
                  ops.paged_attention_multi_reference(*args), dn)
    es = q.element_size()
    nbytes = (2 * sum(lens) * hkv * d + 2 * q.numel()) * es + 4 * (pages + slots)
    b_ms, b_by = bound(nbytes, 4 * d * hq * multi_pairs(lens, t), dn)
    cap = mb * block
    kg = k[tables.long()].reshape(slots, cap, hkv, d).transpose(1, 2)
    vg = v[tables.long()].reshape(slots, cap, hkv, d).transpose(1, 2)
    q_pos = n_t[:, None].long() - t + torch.arange(t, device=dev)[None, :]
    mask = (torch.arange(cap, device=dev)[None, None, :] <= q_pos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kg, vg, attn_mask=mask, enable_gqa=True)
    return {
        "case": name, "q": [slots, t, hq, d], "pool": [n_blocks, block, hkv, d],
        "tables": [slots, mb], "lens": list(lens), "dtype": dn, "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.paged_attention_multi_cuda(*args), flush),
        "plain_ms": time_ms(torch, lambda: ops.paged_attention_multi_reference(*args), flush),
        "library_ms": time_ms(torch, lib, flush),
        "library": "scaled_dot_product_attention over the gathered cache with a boolean mask, "
                   "gather excluded",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def quant_step_ms(cases: list, n_layers: int, key: str) -> float:
    """One decode step's int8 products of an n_layers model from the M = 8
    cases: each layer's seven products and the LM head."""
    by = {c["case"]: c[key] for c in cases}
    return (n_layers * sum(by[name] * times for name, times in QUANT_PER_LAYER.items())
            + by["quant lm_head decode"])


def quant_sweep(torch, quant, flush, gen, dev) -> dict:
    """``--quant-sweep``: the bf16 int8 kernel forced to each cluster split
    of ``QUANT_SPLITS`` in turn (through its C entry, bypassing
    ``ops.quant_matmul.quant_splits``) on the int8 cases and two products
    at a verify's rows, each split held against the plain version and
    timed, beside the split the rule picks and the bound."""
    from bobrapet_tpu_torch.kernels import KERNEL_DTYPES, check_launch, kernel_function, launch
    from bobrapet_tpu_torch.ops import quant_matmul as qm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    fn = kernel_function("bobra_quant_matmul", qm._ARGTYPES)
    cases = {}
    for name, m, k, n in QUANT_CASES + QUANT_VERIFY_CASES:
        leaf = quant.quantize_array(
            (torch.randn((k, n), generator=gen, device=dev) * (1.0 / 64)).to(bf16))
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        out = torch.empty((m, n), dtype=bf16, device=dev)
        ref = qm.quant_matmul_reference(x, leaf["q"], leaf["scale"])
        times = {}
        for splits in QUANT_SPLITS:
            def call(splits=splits):
                return launch(fn, dev.index or 0, x.data_ptr(), leaf["q"].data_ptr(),
                              leaf["scale"].data_ptr(), out.data_ptr(), m, n, k, splits,
                              KERNEL_DTYPES[bf16])
            check_launch("quant_matmul", call())
            compare(torch, "quant", f"{name} splits {splits}", out, ref, "bfloat16")
            times[splits] = time_ms(torch, call, flush)
        b_ms, _ = bound(quant_bytes(m, k, n, 2), 2 * m * k * n, "bfloat16")
        cases[name] = {"x": [m, k], "q": [k, n], "ms_by_splits": times,
                       "rule": qm.quant_splits(m, n, k, sms), "bound_ms": b_ms}
    return cases


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


def marked_share(kernels, steps: int, mark: str) -> dict:
    """Device ms and calls per step of the kernel instances with ``mark`` in
    their name (``qmm``: the int8 product's)."""
    hits = [e for e in kernels if mark in e.key]
    return {"ms_per_step": sum(e.self_device_time_total for e in hits) / 1e3 / steps,
            "calls_per_step": sum(e.count for e in hits) / steps}


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
               ops.cached_attention_cuda, ops.paged_attention_cuda,
               ops.paged_attention_multi_cuda, ops.quant_matmul_cuda):
        fn.launches = 0


def read_counts(ops) -> dict:
    """The wrappers' counters. ``flash_attention`` counts both entries of
    csrc/flash_attention.cu, ``cached_attention`` the device-length one."""
    return {"rmsnorm": ops.rmsnorm_cuda.launches,
            "add_rmsnorm": ops.add_rmsnorm_cuda.launches,
            "flash_attention": ops.flash_attention_cuda.launches,
            "cached_attention": ops.cached_attention_cuda.launches,
            "paged_attention": ops.paged_attention_cuda.launches}


def read_all_counts(ops) -> dict:
    """:func:`read_counts` and the speculative path's two kernels: the
    T-query paged entry and the int8 product."""
    return {**read_counts(ops), "paged_attention_multi": ops.paged_attention_multi_cuda.launches,
            "quant_matmul": ops.quant_matmul_cuda.launches}


def spec_engine_launches(pc: dict, k: int, n_layers: int, draft_layers: int,
                         target_int8: bool = False, draft_int8: bool = True) -> dict:
    """The kernels of a draft engine's run, from its phase counts: the
    target's forwards (prefills, one-token steps, and a ``k + 1``-token
    verify per speculative round or tick) and the draft's (the mirror of
    each prefill, ``k + 1`` one-token steps per round or tick, a T = H
    catch-up after each plain horizon, a one-token append before each plain
    tick). 2L + 1 norms a forward; one flash launch a layer a prefill; the
    paged kernel on every one-token step, the T-query entry on every verify
    and catch-up; 7L + 1 int8 products a forward of an int8 tree."""
    spec = pc["spec_rounds"] + pc["spec_ticks"]
    target = pc["prefills"] + pc["device_steps"] + spec
    draft = pc["draft_prefills"] + spec * (k + 1) + pc["draft_syncs"] + pc["draft_appends"]
    norms = target * (2 * n_layers + 1) + draft * (2 * draft_layers + 1)
    return {
        "rmsnorm": norms, "add_rmsnorm": target * 2 * n_layers + draft * 2 * draft_layers,
        "flash_attention": pc["prefills"] * n_layers + pc["draft_prefills"] * draft_layers,
        "cached_attention": 0,
        "paged_attention": (pc["device_steps"] * n_layers
                            + (spec * (k + 1) + pc["draft_appends"]) * draft_layers),
        "paged_attention_multi": spec * n_layers + pc["draft_syncs"] * draft_layers,
        "quant_matmul": ((target * (7 * n_layers + 1) if target_int8 else 0)
                         + (draft * (7 * draft_layers + 1) if draft_int8 else 0)),
    }


def standalone_launches(rounds: int, k: int, n_layers: int, draft_layers: int) -> dict:
    """The kernels of one speculative_generate run: the two prefills (one
    flash launch a layer each), then per round k + 1 draft steps and one
    verify, each attention through the device-length cached entry (which
    the flash counter also counts); 2L + 1 norms a forward."""
    t_fwd, d_fwd = 1 + rounds, 1 + rounds * (k + 1)
    cached = rounds * (n_layers + (k + 1) * draft_layers)
    return {"rmsnorm": t_fwd * (2 * n_layers + 1) + d_fwd * (2 * draft_layers + 1),
            "add_rmsnorm": t_fwd * 2 * n_layers + d_fwd * 2 * draft_layers,
            "flash_attention": n_layers + draft_layers + cached, "cached_attention": cached,
            "paged_attention": 0, "paged_attention_multi": 0, "quant_matmul": 0}


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
        "int8_products": marked_share(kernels, profiled, "qmm"),
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


def prefix_cross_check(torch, ops, llama, serving, lora_mod, cfg, seed: int, dev) -> dict:
    """fp32, 2 layers at the 8B widths (TF32 off): the engine with prefix
    caching, chunks of 16 and four stacked adapters (request i under
    adapter i % 4), classic and at a horizon of 8, on the card and on the
    CPU, and on the card with one-shot prefill and no cache: every run must
    give the same tokens, the horizon's first tokens the classic tick's,
    and on the card every prefill and decode step must run the kernels."""
    cfg3 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = llama.init_params(cfg3, torch.Generator(device=dev).manual_seed(seed + 4), dev)
    stacked, lcfg = make_loras(torch, lora_mod, cfg3, N_ADAPTERS, seed + 6, dev)
    trees = {"card": (params, stacked), "cpu": (tree_to(params, "cpu"), tree_to(stacked, "cpu"))}
    gen = torch.Generator().manual_seed(seed + 7)
    system = torch.randint(0, cfg3.vocab_size, (32,), generator=gen).tolist()
    waves = [[system + torch.randint(0, cfg3.vocab_size, (n,), generator=gen).tolist()
              for n in tails] for tails in CROSS_TAILS]
    oneshot = {**CROSS_PREFIX_PAGING, "prefix_caching": False, "prefill_chunk": None}
    outs, stats = {}, {}
    t0 = time.perf_counter()
    for horizon in (1, 8):
        for side, name, paging in (("card", "prefix", CROSS_PREFIX_PAGING),
                                   ("cpu", "prefix", CROSS_PREFIX_PAGING),
                                   ("card", "oneshot", oneshot)):
            tree, loras = trees[side]
            eng = serving.ServingEngine(tree, cfg3, serving.PagedConfig(**paging), loras=loras,
                                        lora_scale=lcfg.scale, pipeline_decode=True,
                                        decode_horizon=horizon, dispatch_depth=1)
            zero_counts(ops)
            n = 0
            for wave in waves:
                for p in wave:
                    eng.submit(p, CROSS_BUDGET[horizon], adapter=n % N_ADAPTERS)
                    n += 1
                eng.run()
            pc = eng.phase_counts
            if side == "card" and read_counts(ops) != engine_launches(
                    pc["prefills"], pc["device_steps"], cfg3.n_layers):
                fail("the prefix/chunk/LoRA cross-check did not run the kernels on every "
                     "prefill and step")
            if name == "prefix" and not (eng.blocks.hit_tokens and pc["chunks"]):
                fail("the prefix/chunk/LoRA cross-check matched no prefix or ran no chunk")
            if horizon > 1 and pc["horizons"] == 0:
                fail("the prefix/chunk/LoRA cross-check ran no horizon")
            outs[side, name, horizon] = [r.output for r in sorted(eng.finished,
                                                                  key=lambda r: r.rid)]
            stats[f"{side}_{name}_h{horizon}"] = {
                "hit_tokens": eng.blocks.hit_tokens, "chunks": pc["chunks"],
                "prefills": pc["prefills"], "decode_steps": pc["device_steps"]}
    checks = {
        "card_equals_cpu": all(outs["card", "prefix", h] == outs["cpu", "prefix", h]
                               for h in (1, 8)),
        "chunked_equals_oneshot": all(outs["card", "prefix", h] == outs["card", "oneshot", h]
                                      for h in (1, 8)),
        "horizon_extends_classic": all(
            a[:CROSS_BUDGET[1]] == b
            for a, b in zip(outs["card", "prefix", 8], outs["card", "prefix", 1])),
    }
    result = {"requests": sum(map(len, waves)), "new_tokens": CROSS_BUDGET,
              "paging": CROSS_PREFIX_PAGING, "adapters": N_ADAPTERS, **checks, "runs": stats,
              "seconds": time.perf_counter() - t0}
    print("engine with prefix caching, chunks and LoRA (2 layers, 8B widths, fp32): "
          + json.dumps(result), flush=True)
    for name, ok in checks.items():
        if not ok:
            fail(f"prefix/chunk/LoRA cross-check: {name} does not hold")
    return result


def spec_cross_check(torch, ops, llama, quant, serving, cfg, seed: int, dev) -> dict:
    """fp32, 2 layers at the 8B widths (TF32 off): the engine with a draft
    (a llama_tiny of the target's vocabulary, the guard off), classic and at
    a horizon of 8, on the card and on the CPU, must give the same tokens,
    and the draft-less engine's; on the card with exact launch counts. Then
    on the card the target's own int8 tree as the draft (the fp32 int8
    kernel inside the engine) at the horizon of 8: the same tokens again."""
    cfg3 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    dcfg = llama.llama_tiny(vocab_size=cfg3.vocab_size, max_seq_len=cfg3.max_seq_len)
    params = llama.init_params(cfg3, torch.Generator(device=dev).manual_seed(seed + 4), dev)
    draft = llama.init_params(dcfg, torch.Generator(device=dev).manual_seed(seed + 8), dev)
    trees = {"card": (params, draft), "cpu": (tree_to(params, "cpu"), tree_to(draft, "cpu"))}
    gen = torch.Generator().manual_seed(seed + 5)
    prompts = [torch.randint(0, cfg3.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 12, 17, 30)]
    pcfg = serving.PagedConfig(max_slots=4, block_size=16, num_blocks=32, max_blocks_per_seq=4,
                               prefix_caching=False)
    outs, counts = {}, {}
    t0 = time.perf_counter()
    runs = [(side, name, h) for h in (1, 8) for side, name in
            (("card", "plain"), ("card", "spec"), ("cpu", "spec"))] + [("card", "int8", 8)]
    for side, name, horizon in runs:
        tree, dtree = trees[side]
        kw = {}
        if name == "spec":
            kw = dict(draft_params=dtree, draft_cfg=dcfg, spec_k=SPEC_K, spec_guard=False)
        elif name == "int8":
            kw = dict(draft_params=quant.quantize_params(tree), draft_cfg=cfg3, spec_k=SPEC_K,
                      spec_guard=False)
        eng = serving.ServingEngine(tree, cfg3, pcfg, pipeline_decode=True,
                                    decode_horizon=horizon, dispatch_depth=1, **kw)
        for p in prompts:
            eng.submit(p, CROSS_BUDGET[horizon])
        zero_counts(ops)
        eng.run()
        outs[side, name, horizon] = [r.output for r in sorted(eng.finished, key=lambda r: r.rid)]
        if side == "card" and name != "plain":
            got = read_all_counts(ops)
            want = spec_engine_launches(eng.phase_counts, SPEC_K, cfg3.n_layers,
                                        cfg3.n_layers if name == "int8" else dcfg.n_layers,
                                        draft_int8=name == "int8")
            if got != want:
                fail(f"the fp32 draft engine ({name}, H={horizon}) did not run the kernels "
                     f"exactly: {got}, expected {want}")
            if eng.spec_drafted == 0:
                fail(f"the fp32 draft engine ({name}, H={horizon}) never speculated")
            counts[f"{name}_h{horizon}"] = {**got, "spec_rounds": eng.phase_counts["spec_rounds"],
                                            "spec_ticks": eng.phase_counts["spec_ticks"],
                                            "drafted": eng.spec_drafted,
                                            "accepted": eng.spec_accepted}
    del params, draft, trees
    checks = {
        "card_equals_cpu": all(outs["card", "spec", h] == outs["cpu", "spec", h] for h in (1, 8)),
        "spec_equals_draftless": all(outs["card", "spec", h] == outs["card", "plain", h]
                                     for h in (1, 8)),
        "int8_draft_equals_draftless": outs["card", "int8", 8] == outs["card", "plain", 8],
    }
    result = {"requests": len(prompts), "new_tokens": CROSS_BUDGET, "spec_k": SPEC_K,
              "draft": "llama_tiny(vocab_size=128256)", **checks, "card_counts": counts,
              "seconds": time.perf_counter() - t0}
    print("engine with a draft (2 layers, 8B widths, fp32, card vs CPU): " + json.dumps(result),
          flush=True)
    for name, ok in checks.items():
        if not ok:
            fail(f"the fp32 speculative cross-check: {name} does not hold")
    return result


def spec_prompts(torch, cfg, seed: int, dev) -> list:
    """bench.py's serving-child prompts: 32 + (i % 4) * 32 tokens."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (32 + (i % 4) * 32,), generator=gen,
                          device=dev).tolist() for i in range(SPEC_REQUESTS)]


def spec_drain(torch, ops, eng, prompts, draft_int8: bool = True) -> dict:
    """One measured drain of phase 8's traffic: counts set to 0 just before
    and read just after, exact against the engine's phase counts; every
    request ends with its SPEC_NEW in-range tokens."""
    eng.reset_phase_stats()
    drafted0, accepted0 = eng.spec_drafted, eng.spec_accepted
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    rids = [eng.submit(p, SPEC_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    got = read_all_counts(ops)
    pc = dict(eng.phase_counts)
    if eng.draft_params is None:
        want = {**engine_launches(pc["prefills"], pc["device_steps"], eng.cfg.n_layers),
                "paged_attention_multi": 0, "quant_matmul": 0}
    else:
        want = spec_engine_launches(pc, eng.spec_k, eng.cfg.n_layers, eng.draft_cfg.n_layers,
                                    draft_int8=draft_int8)
    print(f"  spec phase drain (draft={eng.draft_params is not None}, guard="
          f"{eng.spec_guard}) launches {got}, expected {want}", flush=True)
    if got != want:
        fail("a phase-8 drain did not run every kernel of its path exactly")
    by_rid = {r.rid: r for r in eng.finished}
    reqs = [by_rid[rid] for rid in rids]
    for req in reqs:
        if len(req.output) != SPEC_NEW or min(req.output) < 0 \
                or max(req.output) >= eng.cfg.vocab_size:
            fail(f"phase 8: a request did not end with its {SPEC_NEW} in-range tokens")
    tokens = SPEC_REQUESTS * SPEC_NEW
    drafted, accepted = eng.spec_drafted - drafted0, eng.spec_accepted - accepted0
    ph = eng.phase_seconds
    return {
        "drain_s": drain_s, "new_tokens": tokens, "tok_per_s": tokens / drain_s,
        "drafted": drafted, "accepted": accepted,
        "accept_rate": accepted / drafted if drafted else None,
        "phase_seconds": dict(ph), "phase_counts": pc,
        "horizon_ms": ((ph["decode_device"] + ph["host_sync"] + ph["draft"] + ph["verify"])
                       / pc["horizons"] * 1e3) if pc["horizons"] else None,
        "ttft_ms_p50": p50(r.ttft_seconds for r in reqs) * 1e3,
        "tpot_ms_p50": p50(r.tpot_seconds for r in reqs) * 1e3,
        "launches": got, "outputs": [r.output for r in reqs],
    }


def feed_windows(n_fed: int, first: int, width: int) -> list:
    """Cut ``n_fed`` fed tokens into forwards of ``width`` rows, the first
    holding ``first`` real tokens: ``(start, real)`` per forward, the last
    holding what remains (its other rows are filler)."""
    out, start, real = [], 0, min(first, n_fed)
    while start < n_fed:
        out.append((start, real))
        start += real
        real = min(width, n_fed - start)
    return out


def divergence_check(run, n_fed: int, k: int, want: int, got: int) -> dict:
    """Is a first divergence (the one-token decode chose ``want`` after
    ``n_fed`` fed tokens, the speculative path ``got``) a near-tie? ``run
    (windows, T)`` feeds the tokens in those forwards of T rows from the
    same prompt state and returns the last fed token's fp32 logits [V].
    The one-token form feeds one a forward; each of the k + 1 alignments of
    (k + 1)-token verifies feeds them as a verify does, the history's K/V
    included. Each logit of the two forms may differ by the largest error
    between them, so a divergence that rounding explains has ``margin``
    (the one-token logit of ``want`` less that of ``got``) at most twice
    that error."""
    step = run(feed_windows(n_fed, 1, 1), 1)
    err = max(float((run(feed_windows(n_fed, first, k + 1), k + 1) - step).abs().max())
              for first in range(1, k + 2))
    top = step.topk(2).values
    return {"position": n_fed, "plain": want, "spec": got, "recomputed_argmax": int(step.argmax()),
            "top2_margin": float(top[0] - top[1]), "margin": float(step[want] - step[got]),
            "max_abs_logit_err": err}


def paged_runner(torch, params, cfg, prompt: list, fed: list, dev):
    """``run`` for :func:`divergence_check` through the engine's own append
    (``spec_decode._model_append``) over fresh pools of phase 8's slots and
    block size: lane 0 holds the request and the other lanes idle on the
    scratch block, so every product has the engine's shape, and the tables
    have the engine's width, so the kernel splits the keys as there. The
    prompt is written once, in appends of 16, and each form starts from a
    copy."""
    from bobrapet_tpu_torch.serving import paged_cache, spec_decode

    slots, bs = SPEC_PAGING["max_slots"], SPEC_PAGING["block_size"]
    seq = list(prompt) + list(fed)
    nb = SPEC_PAGING["max_blocks_per_seq"]
    paging = paged_cache.PagedConfig(max_slots=slots, block_size=bs, num_blocks=nb + 1,
                                     max_blocks_per_seq=nb, prefix_caching=False)
    tables = torch.full((slots, nb), paged_cache.SCRATCH_BLOCK, dtype=torch.int32, device=dev)
    tables[0] = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)

    def append(pools, start: int, real: int, t: int):
        toks = torch.zeros((slots, t), dtype=torch.int32, device=dev)
        toks[0, :real] = torch.tensor(seq[start:start + real], dtype=torch.int32, device=dev)
        pos0 = torch.zeros((slots,), dtype=torch.int32, device=dev)
        pos0[0] = start
        wok = torch.zeros((slots, t), dtype=torch.bool, device=dev)
        wok[0, :real] = True
        _, logits = spec_decode._model_append(params, pools, toks, pos0, wok, tables, cfg=cfg,
                                              pcfg=paging, T=t)
        return logits[0, real - 1]

    base = paged_cache.init_pools(cfg, paging, dev)
    for start, real in feed_windows(len(prompt), 16, 16):
        append(base, start, real, 16)

    def run(windows, t: int):
        pools = {name: pool.clone() for name, pool in base.items()}
        for start, real in windows:
            last = append(pools, len(prompt) + start, real, t)
        return last

    return run


def contiguous_runner(torch, llama, params, cfg, prompt, fed: list, dev):
    """``run`` for :func:`divergence_check` through ``llama.forward`` over
    the contiguous cache with a device cursor, as ``greedy_generate`` and
    ``speculative_generate`` run, each at its own capacity (the kernel
    splits the keys by it): a prefill of the prompt, then the fed tokens,
    the cursor set to each forward's first position."""
    plen = prompt.shape[1]
    seq = list(fed)

    def run(windows, t: int):
        cap = STANDALONE_PROMPT + STANDALONE_NEW if t == 1 else STANDALONE_CAP
        cache = llama.init_cache(cfg, 1, cap, device=dev)
        llama.forward(params, prompt, cfg, cache=cache,
                      positions=torch.arange(plen, device=dev)[None, :])
        cursor = llama.device_cursor(cache)
        for start, real in windows:
            toks = torch.zeros((1, t), dtype=torch.int32, device=dev)
            toks[0, :real] = torch.tensor(seq[start:start + real], dtype=torch.int32, device=dev)
            cursor.fill_(plen + start)
            pos = plen + start + torch.arange(t, device=dev)[None, :]
            logits, _ = llama.forward(params, toks, cfg, cache=cache, positions=pos)
        return logits[0, real - 1]

    return run


def check_divergences(checks: list, what: str) -> None:
    for c in checks:
        if c["margin"] > 2 * c["max_abs_logit_err"]:
            fail(f"{what}: at position {c['position']} of request {c.get('request', 0)} the "
                 f"speculative token trails the one-token step's by {c['margin']}, beyond twice "
                 f"the logit error {c['max_abs_logit_err']} between the two forms")


def spec_phase(torch, ops, serving, llama, quant, params, cfg, seed: int, dev, card: str) -> dict:
    """Phase 8: the draft-less engine against the engine with the target's
    int8 tree as its draft (guard off), drained in turns, then the guarded
    engine warmed until it decides, then standalone speculative_generate."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    draft = quant.quantize_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    warm = spec_prompts(torch, cfg, seed + 40, dev)
    prompts = spec_prompts(torch, cfg, seed + 41, dev)
    torch.cuda.reset_peak_memory_stats()
    paging = serving.PagedConfig(**SPEC_PAGING)
    common = dict(decode_horizon=SPEC_HORIZON, dispatch_depth=1)
    engines = {"plain": serving.ServingEngine(params, cfg, paging, **common),
               "spec": serving.ServingEngine(params, cfg, paging, draft_params=draft,
                                             draft_cfg=cfg, spec_k=SPEC_K, spec_guard=False,
                                             **common)}
    for eng in engines.values():
        for p in warm:
            eng.submit(p, SPEC_NEW)
        eng.run()
    drains = {name: [] for name in engines}
    for name in SPEC_ORDER:
        drains[name].append(spec_drain(torch, ops, engines[name], prompts))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, runs in drains.items():
        if runs[0]["outputs"] != runs[1]["outputs"]:
            fail(f"phase 8: the {name} engine's two drains gave different tokens")
    # each engine's steady horizon under the profiler (8 slots, budgets of
    # 64: the speculative horizon commits up to rounds * (k + 1) = 10 a lane)
    profiles = {name: tick_profile(torch, eng, warm, 2, 2, 1) for name, eng in engines.items()}
    out_p, out_s = drains["plain"][0]["outputs"], drains["spec"][0]["outputs"]
    if any(a[0] != b[0] for a, b in zip(out_p, out_s)):
        fail("phase 8: a first token (the same prefill) differs with the draft")
    same = sum(x == y for a, b in zip(out_p, out_s) for x, y in zip(a, b))
    divergence = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                  for a, b in zip(out_p, out_s)]
    for runs in drains.values():
        for d in runs:
            d.pop("outputs")
    del engines
    # every first divergence must be a near-tie of the one-token step
    div_checks = []
    for i, j in enumerate(divergence):
        if j:
            run = paged_runner(torch, params, cfg, prompts[i], out_p[i][:j], dev)
            div_checks.append({"request": i, **divergence_check(run, j, SPEC_K, out_p[i][j],
                                                                out_s[i][j])})
    print("spec phase, first divergences: " + json.dumps(div_checks), flush=True)
    check_divergences(div_checks, "phase 8")

    # the guarded engine, warmed until the guard decides (bench.py's loop)
    guard = serving.ServingEngine(params, cfg, paging, draft_params=draft, draft_cfg=cfg,
                                  spec_k=SPEC_K, **common)
    warm_drains = 0
    for attempt in range(GUARD_WARM_DRAINS):
        for p in spec_prompts(torch, cfg, seed + 50 + attempt, dev):
            guard.submit(p, SPEC_NEW)
        guard.run()
        warm_drains += 1
        if guard.spec_guard_decision is not None:
            break
    if guard.spec_guard_decision is None:
        fail(f"phase 8: the payoff guard did not decide in {GUARD_WARM_DRAINS} drains")
    guarded = spec_drain(torch, ops, guard, prompts)
    guarded_same = sum(x == y for a, b in zip(out_p, guarded.pop("outputs"))
                       for x, y in zip(a, b))
    decision = dict(guard.spec_guard_decision)
    del guard, draft
    L = cfg.n_layers
    result = {
        "model": "llama3_8b", "dtype": "bfloat16", "draft": "quantize_params(target), int8",
        "card": card, "paging": SPEC_PAGING, "decode_horizon": SPEC_HORIZON, "spec_k": SPEC_K,
        "rounds_per_horizon": max(1, -(-SPEC_HORIZON // (SPEC_K + 1))),
        "requests": SPEC_REQUESTS, "new_tokens": SPEC_NEW, "order": ", ".join(SPEC_ORDER),
        "quantize_s": quant_s, "peak_memory_gb": peak_gb, "drains": drains,
        "profiles": profiles,
        "spec_equals_plain_token_share": same / (SPEC_REQUESTS * SPEC_NEW),
        "first_divergence": divergence, "divergence_checks": div_checks,
        "guard": {"warm_drains": warm_drains, "decision": decision, "drain": guarded,
                  "equals_plain_token_share": guarded_same / (SPEC_REQUESTS * SPEC_NEW)},
        # what one round and one catch-up launch at these widths
        "launches_per_spec_round": {"paged_attention": (SPEC_K + 1) * L,
                                    "paged_attention_multi": L,
                                    "quant_matmul": (SPEC_K + 1) * (7 * L + 1)},
        "launches_per_draft_sync": {"paged_attention_multi": L, "quant_matmul": 7 * L + 1},
    }
    print("spec phase, serving: " + json.dumps(result), flush=True)
    result["standalone"] = standalone_spec(torch, ops, llama, params, cfg, seed, dev)
    result["seconds"] = time.perf_counter() - t_phase
    print("spec phase: " + json.dumps(result), flush=True)
    return result


def standalone_spec(torch, ops, llama, params, cfg, seed: int, dev) -> dict:
    """speculative_generate of bench.py:2509-2531: the 8B target, a
    llama_tiny draft of its vocabulary (random, fp32), a [1, 64] prompt, 64
    new tokens, k 4; one warm run (the graphs' capture), one timed with the
    counts exact; its tokens against greedy_generate's."""
    from bobrapet_tpu_torch.models import speculative_generate

    dcfg = llama.llama_tiny(vocab_size=cfg.vocab_size)
    draft = llama.init_params(dcfg, torch.Generator(device=dev).manual_seed(seed + 7), dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, STANDALONE_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed + 9))
    speculative_generate(params, draft, prompt, cfg, dcfg, max_new_tokens=STANDALONE_NEW,
                         k=SPEC_K)
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    res = speculative_generate(params, draft, prompt, cfg, dcfg, max_new_tokens=STANDALONE_NEW,
                               k=SPEC_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_all_counts(ops)
    want = standalone_launches(res.rounds, SPEC_K, cfg.n_layers, dcfg.n_layers)
    print(f"  standalone speculative_generate launches {got}, expected {want}", flush=True)
    if got != want:
        fail("standalone speculative decoding did not run every kernel of its path exactly")
    toks = res.tokens.tolist()
    if len(toks) != STANDALONE_NEW or min(toks) < 0 or max(toks) >= cfg.vocab_size:
        fail("standalone speculative decoding gave bad tokens")
    greedy = llama.greedy_generate(params, prompt, cfg, max_new_tokens=STANDALONE_NEW)[0].tolist()
    if toks[0] != greedy[0]:
        fail("standalone speculative decoding: the first token (the same prefill) differs")
    j = next((j for j, (a, b) in enumerate(zip(toks, greedy)) if a != b), None)
    check = None
    if j:
        check = divergence_check(contiguous_runner(torch, llama, params, cfg, prompt,
                                                   greedy[:j], dev),
                                 j, SPEC_K, greedy[j], toks[j])
        print("  standalone first divergence: " + json.dumps(check), flush=True)
        check_divergences([check], "standalone speculative decoding")
    out = {"k": SPEC_K, "prompt": STANDALONE_PROMPT, "new_tokens": STANDALONE_NEW,
           "draft": "llama_tiny(vocab_size=128256), fp32, random", "wall_s": wall,
           "tok_per_s": STANDALONE_NEW / wall, "rounds": res.rounds, "drafted": res.drafted,
           "accepted": res.accepted, "accept_rate": res.accepted / max(1, res.drafted),
           "launches": got,
           "equals_greedy_token_share": sum(a == b for a, b in zip(toks, greedy)) / len(toks),
           "first_divergence_from_greedy": j, "divergence_check": check}
    print("  standalone speculative decoding: " + json.dumps(out), flush=True)
    return out


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def pctl(values, q: float) -> float:
    """The q-quantile (nearest rank) of ``values``."""
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


def mixed_workload(torch, cfg, system_seed: int, seed: int, dev, n_long: int = N_LONG,
                   n_short: int = N_SHORT) -> list:
    """bench.py's config-14 traffic: (prompt, new tokens, kind) for long
    requests (the 128-token system prompt of ``system_seed`` and a
    512-token tail) interleaved 2:1 with short ones (8-11 tokens)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def toks(n, g=gen):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g, device=dev).tolist()

    system = toks(SYSTEM_TOKENS, torch.Generator(device=dev).manual_seed(system_seed))
    longs = [(system + toks(TAIL_TOKENS), LONG_NEW, "long") for _ in range(n_long)]
    shorts = [(toks(8 + i % 4), SHORT_NEW, "short") for i in range(n_short)]
    return interleave(longs, shorts)


def interleave(longs: list, shorts: list) -> list:
    """Two long requests, then one short, until both run out."""
    out, li, si = [], 0, 0
    while li < len(longs) or si < len(shorts):
        for _ in range(2):
            if li < len(longs):
                out.append(longs[li])
                li += 1
        if si < len(shorts):
            out.append(shorts[si])
            si += 1
    return out


def engine_launches(prefills: int, steps: int, n_layers: int) -> dict:
    """The kernels of an engine's run: every prefill dispatch (one-shot,
    seeded or chunk) one flash launch a layer, every decode step one paged
    launch a layer, and 2L + 1 norms per forward of either."""
    return {**norm_launches(prefills + steps, n_layers), "flash_attention": prefills * n_layers,
            "cached_attention": 0, "paged_attention": steps * n_layers}


def closed_drain(torch, ops, eng, workload, adapters=None, window: int = WINDOW) -> dict:
    """One closed-loop drain (at most ``window`` requests in flight, a new
    one submitted as one finishes; request i under ``adapters[i]``), the
    counts set to 0 just before and read just after; the launch counts must
    be exact."""
    eng.reset_phase_stats()
    hit0, miss0 = eng.blocks.hit_tokens, eng.blocks.miss_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ops)
    base = len(eng.finished)
    rids = []

    def submit():
        prompt, new, _kind = workload[len(rids)]
        rids.append(eng.submit(prompt, new,
                               adapter=None if adapters is None else adapters[len(rids)]))

    t0 = time.perf_counter()
    while len(rids) < min(window, len(workload)):
        submit()
    while len(eng.finished) - base < len(workload):
        eng.step()
        while len(rids) < len(workload) and len(rids) - (len(eng.finished) - base) < window:
            submit()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = read_counts(ops)
    prefills, steps = eng.phase_counts["prefills"], eng.phase_counts["device_steps"]
    expected = engine_launches(prefills, steps, eng.cfg.n_layers)
    if launches != expected:
        fail(f"an engine drain did not run every norm and attention through the kernels: "
             f"{launches}, expected {expected}")
    by_rid = {r.rid: r for r in eng.finished[base:]}
    reqs = [by_rid[rid] for rid in rids]
    for req, (_, new, _) in zip(reqs, workload):
        if len(req.output) != new or min(req.output) < 0 or max(req.output) >= eng.cfg.vocab_size:
            fail(f"a request did not end with its budget of {new} in-range tokens")
    kinds = [kind for _, _, kind in workload]
    tokens = sum(new for _, new, _ in workload)

    def ms(values, q):
        return pctl(values, q) * 1e3

    ttft = {k: [r.ttft_seconds for r, kk in zip(reqs, kinds) if kk == k] for k in set(kinds)}
    tpot = [r.tpot_seconds for r, k in zip(reqs, kinds) if k == "short"]
    ph = eng.phase_seconds
    return {
        "drain_s": drain_s, "new_tokens": tokens, "tok_per_s": tokens / drain_s,
        **{f"ttft_ms_{k}_p{int(q * 100)}": ms(v, q) for k, v in sorted(ttft.items())
           for q in (0.5, 0.95)},
        **({f"tpot_ms_short_p{int(q * 100)}": ms(tpot, q) for q in (0.5, 0.95)} if tpot else {}),
        "hit_tokens": eng.blocks.hit_tokens - hit0, "miss_tokens": eng.blocks.miss_tokens - miss0,
        "prefills": prefills, "chunks": eng.phase_counts["chunks"], "decode_steps": steps,
        "horizons": eng.phase_counts["horizons"],
        "prefill_s": ph["prefill"], "decode_device_s": ph["decode_device"],
        "host_sync_s": ph["host_sync"],
        # host ms per decode step launched and waited for (classic ticks and
        # horizon steps alike), and per horizon where only horizons ran
        "decode_step_ms": (ph["decode_device"] + ph["host_sync"]) / steps * 1e3,
        "horizon_ms": ((ph["decode_device"] + ph["host_sync"]) / eng.phase_counts["horizons"]
                       * 1e3) if steps == eng.phase_counts["horizons"] * eng.decode_horizon
        else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "outputs": [r.output for r in reqs],
    }


def first_logits(torch, llama, params, cfg, eng, prompt, chunk) -> "torch.Tensor":
    """The logits of ``prompt``'s first new token as engine ``eng``
    computes them from scratch: one bucket-wide prefill (``chunk`` None),
    or chunks of ``chunk``, each over the cache the chunks before it wrote
    (the engine's seeded prefill attends over the same valid rows and runs
    the same launches on the same values)."""
    p, cap = len(prompt), eng.pcfg.capacity
    dev = params["embed"]["weight"].device
    cache = llama.init_cache(cfg, 1, cap, device=dev)
    start = 0
    with torch.no_grad():
        while True:
            end = min(start + (chunk or p), p)
            # a middle chunk is exactly one bucket: the forward's cursor
            # lands on ``end``
            bucket = eng._whole_block_bucket(end - start, cap - start)
            toks = torch.tensor([prompt[start:end] + [0] * (bucket - (end - start))], device=dev)
            logits, _ = llama.forward(params, toks, cfg, cache=cache,
                                      positions=start + torch.arange(bucket, device=dev)[None])
            if end == p:
                return logits[0, p - 1 - start].float()
            start = end


def make_loras(torch, lora_mod, cfg, n: int, seed: int, dev, lcfg=None):
    """The zero adapter, then n - 1 of ``lcfg`` (LoRAConfig()'s defaults)
    from ``seed``, every leaf given 0.05 x a normal sample so that B is
    not zero; stacked."""
    lcfg = lcfg or lora_mod.LoRAConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    adapters = [lora_mod.zero_lora(cfg, lcfg, dev)]
    for _ in range(n - 1):
        a = lora_mod.init_lora(gen, cfg, lcfg, dev)
        adapters.append(lora_mod._tree_map(
            lambda leaf: (leaf.float() + 0.05 * torch.randn(
                leaf.shape, generator=gen, device=dev)).to(leaf.dtype), a))
    return lora_mod.stack_adapters(adapters), lcfg


def prefix_phase(torch, ops, serving, llama, lora_mod, params, cfg, seed: int, dev,
                 card: str) -> dict:
    """Phase 7: engines A (prefix caching, chunks of 128) and B (one-shot,
    no cache) on config 14's unified leg, drained A, B, B, A. Each drain
    gets an engine of its own, warmed by three requests of the same system
    prompt (the kernels' first use, the horizon's capture, and for A the
    system prompt registered, as in a deployment that serves it all day),
    so both drains of an engine start from the same cache. Then config 6's
    traffic over four stacked adapters against the LoRA-free engine."""
    t_phase = time.perf_counter()
    pagings = {"A": PREFIX_PAGING, "B": ONESHOT_PAGING}
    warm = mixed_workload(torch, cfg, seed + 20, seed + 21, dev, n_long=2, n_short=1)
    workload = mixed_workload(torch, cfg, seed + 20, seed + 22, dev)
    drains = {name: [] for name in pagings}
    engines = {}
    for name in PREFIX_ORDER:
        engines.pop(name, None)
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**pagings[name]),
                                    decode_horizon=PREFIX_HORIZON, dispatch_depth=1)
        for prompt, new, _ in warm:
            eng.submit(prompt, new)
        eng.run()
        drains[name].append(closed_drain(torch, ops, eng, workload))
        engines[name] = eng
    for name, runs in drains.items():
        if runs[0]["outputs"] != runs[1]["outputs"]:
            fail(f"engine {name}: two drains gave different tokens")
    if min(d["hit_tokens"] for d in drains["A"]) < (N_LONG - 1) * SYSTEM_TOKENS:
        fail("engine A did not serve the system prompt from its cache")
    if any(d["hit_tokens"] or d["chunks"] for d in drains["B"]):
        fail("engine B matched a prefix or chunked a prefill")
    out_a, out_b = drains["A"][0]["outputs"], drains["B"][0]["outputs"]
    same = sum(x == y for a, b in zip(out_a, out_b) for x, y in zip(a, b))
    divergence = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                  for a, b in zip(out_a, out_b)]
    first_checks = []
    for i, (prompt, _, kind) in enumerate(workload):
        if divergence[i] != 0:
            continue
        # the first tokens differ: fair only for a near-tie of B's logits
        la = first_logits(torch, llama, params, cfg, engines["A"], prompt,
                          engines["A"]._chunk_size())
        lb = first_logits(torch, llama, params, cfg, engines["B"], prompt, None)
        top = lb.topk(2).values
        first_checks.append({
            "request": i, "kind": kind, "A": out_a[i][0], "B": out_b[i][0],
            "recomputed_argmax": [int(la.argmax()), int(lb.argmax())],
            "top2_margin_B": float(top[0] - top[1]),
            "max_abs_logit_err": float((la - lb).abs().max())})
    comparison = {"identical_token_share": same / sum(len(a) for a in out_a),
                  "first_divergence": divergence, "first_token_checks": first_checks}
    print("prefix phase, A against B: " + json.dumps(comparison), flush=True)
    for check in first_checks:
        if check["top2_margin_B"] > check["max_abs_logit_err"]:
            fail(f"request {check['request']}: A's first token differs from B's beyond "
                 "the logit error of the two prefills")
    for runs in drains.values():
        for d in runs:
            d.pop("outputs")
    result = {"model": "llama3_8b", "dtype": "bfloat16", "card": card,
              "paging": {"A": PREFIX_PAGING, "B": ONESHOT_PAGING},
              "decode_horizon": PREFIX_HORIZON, "order": ", ".join(PREFIX_ORDER),
              "workload": {"long": [N_LONG, SYSTEM_TOKENS, TAIL_TOKENS, LONG_NEW],
                           "short": [N_SHORT, "8-11", SHORT_NEW], "window": WINDOW},
              "drains": drains, "comparison": comparison}
    del engines
    result["lora"] = lora_drains(torch, ops, serving, lora_mod, params, cfg, seed, dev)
    result["seconds"] = time.perf_counter() - t_phase
    print("prefix phase: " + json.dumps(result), flush=True)
    return result


def lora_drains(torch, ops, serving, lora_mod, params, cfg, seed: int, dev) -> dict:
    """Config 6's 16 requests (submitted at once) at adapter i % 4 through an
    engine with four stacked adapters, and the same requests through the
    LoRA-free engine; launch counts exact in both."""
    stacked, lcfg = make_loras(torch, lora_mod, cfg, N_ADAPTERS, seed + 30, dev)
    paging = {**SERVE_PAGING, "prefix_caching": True}
    prompts = serve_prompts(torch, cfg, seed + 11, dev)
    workload = [(p, serve_budget(i), "short") for i, p in enumerate(prompts)]
    adapters = [i % N_ADAPTERS for i in range(SERVE_REQUESTS)]
    runs = {}
    for name, loras in (("base", None), ("lora", stacked)):
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**paging), loras=loras,
                                    lora_scale=lcfg.scale, decode_horizon=PREFIX_HORIZON,
                                    dispatch_depth=1)
        eng.submit(prompts[0], 4, adapter=None if loras is None else 1)  # the capture
        eng.run()
        runs[name] = closed_drain(torch, ops, eng, workload,
                                  adapters=None if loras is None else adapters,
                                  window=SERVE_REQUESTS)
        del eng
    base, tuned = runs["base"].pop("outputs"), runs["lora"].pop("outputs")
    zero_same = all(tuned[i] == base[i] for i in range(SERVE_REQUESTS) if adapters[i] == 0)
    changed = {a: any(tuned[i] != base[i] for i in range(SERVE_REQUESTS) if adapters[i] == a)
               for a in range(1, N_ADAPTERS)}
    result = {"adapters": N_ADAPTERS, "rank": lcfg.rank, "alpha": lcfg.alpha,
              "sites": list(lcfg.sites), "paging": paging,
              "zero_adapter_bit_identical": zero_same, "adapter_changes_output": changed,
              "horizon_ms": {name: run["horizon_ms"] for name, run in runs.items()},
              "drains": runs}
    print("multi-LoRA: " + json.dumps(result), flush=True)
    if not zero_same:
        fail("the zero adapter's requests differ from the LoRA-free engine's")
    if not all(changed.values()):
        fail(f"an adapter changed no request's output: {changed}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant-sweep", action="store_true",
                    help="also time the int8 kernel at every forced cluster split (phase 3)")
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
        from bobrapet_tpu_torch.models import lora as lora_mod
        from bobrapet_tpu_torch.models import quant
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
    if spills_in(instances, "qmm"):
        fail(f"an int8 product instance spills registers: {spills_in(instances, 'qmm')}")

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
        # the standalone verify: k + 1 = 5 queries x group 4 = 20 packed rows
        cached_case(torch, F, ops, flush, "cached verify 20 rows", (STANDALONE_CAP - 8,),
                    STANDALONE_CAP, hq, hkv, hd, bf16, gen, dev, sq=SPEC_K + 1),
        cached_case(torch, F, ops, flush, "cached verify 20 rows fp32", (STANDALONE_CAP - 8,),
                    STANDALONE_CAP, hq, hkv, hd, f32, gen, dev, sq=SPEC_K + 1),
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
        flash_case(torch, F, ops, flush, "flash prefill chunk", 1, PREFIX_PAGING["prefill_chunk"],
                   PREFIX_PAGING["prefill_chunk"] + CHUNK_Q_OFFSET, hq, hkv, hd, bf16,
                   CHUNK_Q_OFFSET, gen, dev),
    ]
    paged_cases = [
        paged_case(torch, F, ops, flush, "paged decode", hq, hkv, hd, bf16, gen, dev),
        paged_case(torch, F, ops, flush, "paged long decode", hq, hkv, hd, bf16, gen, dev,
                   n_blocks=LONG_PAGED_BLOCKS, mb=LONG_KV_PAGES, lens=LONG_PAGED_LENS),
        paged_case(torch, F, ops, flush, "paged decode fp32", hq, hkv, hd, f32, gen, dev),
        paged_case(torch, F, ops, flush, "paged decode D=32", 4, 2, 32, bf16, gen, dev,
                   block=8, n_blocks=64, lens=(1, 8, 9, 17, 24, 31, 32, 2), mb=4),
        paged_case(torch, F, ops, flush, "paged decode 41 blocks", hq, hkv, hd, bf16, gen, dev,
                   n_blocks=PREFIX_PAGING["num_blocks"], mb=PREFIX_PAGING["max_blocks_per_seq"],
                   lens=PREFIX_PAGED_LENS),
    ]
    multi_cases = [
        paged_multi_case(torch, F, ops, flush, "paged multi verify", SPEC_K + 1, hq, hkv, hd,
                         bf16, gen, dev),
        paged_multi_case(torch, F, ops, flush, "paged multi draft sync", SPEC_HORIZON, hq, hkv,
                         hd, bf16, gen, dev),
        paged_multi_case(torch, F, ops, flush, "paged multi verify fp32", SPEC_K + 1, hq, hkv,
                         hd, f32, gen, dev),
    ]
    quant_cases = [quant_case(torch, ops, quant, flush, name, m, k, n, bf16, gen, dev)
                   for name, m, k, n in QUANT_CASES]
    quant_cases.append(quant_case(torch, ops, quant, flush, "quant wq/wo decode fp32", 8, 4096,
                                  4096, f32, gen, dev))
    for c in rms_cases + flash_cases + cached_cases + paged_cases + multi_cases + quant_cases:
        print(f"  {c['case']}: kernel {c['ms']:.5f} ms, plain {c['plain_ms']:.5f} ms, "
              f"library {c['library_ms']:.5f} ms, bound {c['bound_ms']:.6f} ms "
              f"({c['bound_by']})", flush=True)
    # the int8 draft's decode step (M = 8): the 7 products of 32 layers and
    # the LM head, kernel against the plain version (the repair's after and
    # before), and the bound
    quant_step = {key: quant_step_ms(quant_cases, 32, key)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print("  int8 draft decode step's products (32 layers, M = 8), the sum of the per-shape "
          f"medians (isolated launches, L2 flushed; not a step's time): {json.dumps(quant_step)}",
          flush=True)
    if args.quant_sweep:
        print("quant sweep: " + json.dumps(quant_sweep(torch, quant, flush, gen, dev)),
              flush=True)
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
    prefix_cross_check(torch, ops, llama, serving, lora_mod, cfg, args.seed, dev)
    spec_cross_check(torch, ops, llama, quant, serving, cfg, args.seed, dev)

    # ---- 7. prefix caching, chunked prefill and multi-LoRA at full width
    # (the weights of phases 4 and 5 again, from the same seed)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prefixed = prefix_phase(torch, ops, serving, llama, lora_mod, params, cfg, args.seed, dev,
                            card)
    for name, runs in prefixed["drains"].items():
        launches_by_path[f"prefix_{name}"] = {
            k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    for name, run in prefixed["lora"]["drains"].items():
        launches_by_path[f"multi_lora_{name}"] = run["launches"]

    # ---- 8. speculative decoding at full width (the same weights)
    spec = spec_phase(torch, ops, serving, llama, quant, params, cfg, args.seed, dev, card)
    del params
    for name, runs in spec["drains"].items():
        launches_by_path[f"spec_{name}"] = {
            k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    launches_by_path["spec_guarded"] = spec["guard"]["drain"]["launches"]
    launches_by_path["spec_standalone"] = spec["standalone"]["launches"]

    # ---- 9. result
    # each kernel's own launches: the flash counter also counts the
    # device-length entry's
    own = {k: {**path, "flash_attention": path["flash_attention"] - path["cached_attention"]}
           for k, path in launches_by_path.items()}

    def entry(name, source, replaces, cases, main_case):
        top = next(c for c in cases if c["case"] == main_case)
        main_errs = [c["max_abs_err"] for c in cases if c["dtype"] == "bfloat16"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(path.get(name, 0) for path in own.values()),
            "launches_by_path": {k: path.get(name, 0) for k, path in own.items()},
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
        entry("paged_attention_multi", "bobrapet_tpu_torch/csrc/paged_attention.cu",
              "bobrapet_tpu/serving/spec_decode.py:47", multi_cases, "paged multi verify"),
        entry("quant_matmul", "bobrapet_tpu_torch/csrc/quant_matmul.cu",
              "bobrapet_tpu/models/quant.py:70", quant_cases, "quant wq/wo decode"),
    ], "build_s": build_s, "host_us_per_call": host_costs}
    print(json.dumps(kernels), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
