#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bobrapet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--quant-sweep]

Phases, each fatal on failure (exit 1, and no result line):

1. the card: its name and power limit (nvidia-smi); no card, no run;
2. build every kernel in bobrapet_tpu_torch/csrc with nvcc for sm_90a,
   and print each kernel instance's ptxas line (registers, static shared
   memory, spills); a spill in a tensor-core attention kernel, an
   RMSNorm, int8, pick or MoE instance fails the run;
3. each kernel against its plain PyTorch version on the card, in bf16 at
   the main paths' shapes (greedy prefill and decode, the greedy decode
   with device lengths over the whole 192-row cache, RMSNorm alone and
   fused with the residual add, the engine's largest prefill bucket, an
   engine decode tick, phase 7's prefill chunk at q_offset 512 and its
   decode tick over 41-block tables, phase 8's int8 products at the draft's
   decode shapes (route D), a draft catch-up's 64 rows, a prefill bucket
   of 128 rows and the int8 greedy prefill's 1024 on the five Llama-3-8B
   shapes (route P), its T-query verify and draft catch-up over the paged
   cache, the standalone verify's 20 packed rows through the cached
   entry, and the token pick over Llama-3's 128,256 logits: an engine
   step's 8 rows at temperatures 0, 0.7, 1.0, 1.3, the draft's all-greedy
   rows, a verify's 40 and the 8 rows in bf16, greedy rows bit for bit and
   sampled ones up to near-ties, each also timed as a CUDA graph of 16 or
   more launches over as many copies of its logits, over 50 MB together,
   so that each launch finds its logits cold: the time the engine's graphs
   see, free of the single launch's floor; and the temperature floor:
   4 rows at T = 1e-39 pick their argmax; the MoE route, dispatch,
   gate/up and down expert products and combine over Mixtral's 8 experts
   (d 4096, f 14336), top 2, at the no-drop capacity, at 8 tokens (a
   decode), 64 (the engine's largest config-6 bucket) and 1,024 (the
   greedy prefill), the expert products at a decode with an empty expert,
   and the route of 1,024 tokens whose every row ties: route, dispatch and
   combine bit for bit, the expert products on the live rows bits equal on
   99% and within 2 bf16 ulps, timed beside the parent's dispatch, bmm and
   elementwise sequence) plus long-cache decodes (dense over 2048
   rows, paged up to 1024), ragged, fp32 and narrow-head cases: max abs
   error against a stated tolerance, and the times (CUDA events, median of 50
   launches, L2 flushed before each) of the kernel, the plain version and
   one PyTorch library call for the same function (a yardstick only; the
   port never calls it), beside the least time the card could take (for
   RMSNorm also its time with the L2 left warm, and a PyTorch copy that
   moves the same bytes under the flushed timer); then the host's
   microseconds per call of each kernel wrapper against torch.add; with
   --quant-sweep also the bf16 int8 kernel's time on route D at each forced
   cluster split (1, 2, 4, 8) and on route P at each tile (128 or 256
   weight columns), each held against the plain version, beside the route,
   split and tile its rules pick (what the crossover was set from);
4. the greedy path: Llama-3-8B at full width and depth (bf16, random
   weights from --seed) serves one request through greedy_generate (a
   batch of 8 prompts of 128 tokens, 64 new tokens) four times in turns,
   the decode steps eager, as CUDA graphs, as graphs, eager; the tokens
   must be identical, and the kernels' launch counts, set to 0 just
   before each run, must show that every norm and every attention of it
   went through the kernels (graph replays counted), every norm but the
   first of a forward through the add mode and every decode attention
   through the device-length entry, and every token through the pick (1 +
   64 picks a request); then prefill ms, decode step ms and the card's busy
   share of a step, eager and graphed in turns;
5. the serving path on the same weights: the continuous-batching engine
   (8 slots over a paged cache of 256 blocks of 16) streams 16 requests
   (prompts of 8-36 tokens, budgets of 32-64, 785 new tokens) with the
   classic tick, dispatch-ahead off and on, with the fused horizon of 8
   steps as one CUDA graph, and as ServingEngine(params, cfg, paging)
   builds it (a horizon of 8 at dispatch depth 2), a warm drain each, then
   measured drains in turns (off, on, H8, default, default, H8, on, off);
   every request gets exactly its budget, every drain the same tokens, and
   the launch counts of all four kernels are exact in each drain; then the
   same traffic sampled (temperatures 0, 0.7, 1.0, 1.3 in turn) at (H,
   depth) (1, 1), (8, 1), (8, 2), drained in turns: the same streams in
   every mode; tok/s, TTFT and TPOT p50, host overlap and gap seconds,
   peak memory and, from a profiled drain, the busy share of each mode;
   then each greedy engine's steady tick under the profiler, and the
   sampled horizon's (the pick's kernel time inside a horizon);
6. a 2-layer model at the 8B widths, the same seeded weights on the card
   (kernels) and on the CPU (plain versions): bf16 prefill logits must
   agree, and so must its int8 tree's prefill logits (8 x 24 rows: every
   product on route P) and next decode step's (8 rows: route D); in fp32
   the serving engine must give identical tokens,
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
8. the int8 tree at full width: quantize_params of the same weights, built
   once; first the int8 greedy leg (bench.py's BENCH_QUANT=int8 generate
   step: phase 4's traffic through greedy_generate, eager, graphed,
   graphed, eager): identical tokens, exact launch counts (every prefill
   product on route P, every decode product on route D), then prefill ms,
   step ms, busy share and the int8 products' device ms of a step; then
   speculative decoding: Llama-3-8B on the same weights, bench.py's
   serving-child traffic (16 requests of 32-128 tokens, 32 new each, 8
   slots over 256 blocks of 16, 16 a sequence, a horizon of 8): the
   draft-less engine and the engine with that int8 tree as its draft
   (spec_k 4, the payoff guard off, so the speculative horizon is what
   runs) at dispatch depth 1 and 2, drained in turns (plain, spec,
   spec_d2, spec_d2, spec, plain), then an engine with the guard warmed
   until it decides; depth 2's tokens must be depth 1's up to near-ties
   (held as below, either token the lower); tok/s, accept rate,
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
   greedy_generate, its first divergence held the same way, its picks
   counted (1 + rounds x (k + 2));
9. the sparse-MoE family at Mixtral-8x7B width, 16 of its 32 layers
   (bf16, random weights from --seed made on the card after phase 8's
   trees are freed): (a) greedy_generate of phase 4's traffic, eager,
   graphed, graphed, eager: identical tokens, exact launch counts (one
   route, gate/up, down and combine a layer a forward beside every norm,
   attention and pick, and no dispatch), prefill ms, step ms and busy
   share, the step against its bound (every weight but the embedding read
   once), the parts of a prefill and a step by op and kernel (the expert
   products' kernels, and bmm, which should read 0), and the bf16 prefill
   logits and greedy tokens against the plain path's on the same tree; (b)
   config 6's 16
   requests through the engine, the classic tick (H 1, depth 1) and its
   defaults (H 8, depth 2), greedy then sampled (0, 0.7, 1.0, 1.3), each
   drained in turns: the same tokens or streams in both modes, exact
   launch counts, tok/s, TTFT and TPOT p50, peak memory, busy share; (c)
   one layer at Mixtral's widths in fp32, card against CPU: prefill
   logits within 1e-3, and the engine's tokens identical at H 1 and 8
   with prefix caching and chunks of 16;
10. the serving engram at Llama-3-8B width and depth (phase 4's weights
   again, made after phase 9's trees are freed): (a) the tree saved with
   the port's save_checkpoint into a FileStore under build/, (b) restored
   by serve(ctx)'s build_engine (config 6's paging, a horizon of 8, depth
   2), every leaf bit for bit, save and restore GB/s, and config 6's 16
   requests as wire JSON through it: phase 5's tokens, exact launch
   counts; (c) a prefill-role and a decode-role engine on the engram's
   parameter tensors under the port's ServingRouter, sharing one
   SharedPrefixRegistry that spills to a SliceLocalSSDStore under build/:
   config 6's budgets over block-aligned prompts (16-48 tokens), greedy and
   sampled (0, 0.7, 1.0, 1.3), each request's tokens the unified engram
   engine's, the decode engine with no prefill dispatch (its flash
   launches 0) and every decode attention through the paged kernel; then
   config 6's own prompts, sampled, where the decode engine adopts the
   full blocks and prefills each request's suffix once over them (flash
   launches = all prefills x layers): the unified engine's first tokens,
   the streams of a replay through fresh engines at H 1, depth 1 bit for
   bit, and each greedy divergence from the unified engine a near-tie;
   kv_handoff_s p50/p95, TTFT and TPOT p50 unified and disaggregated,
   tok/s, registry hits, bytes spilled, ms per spill write; (d) a fresh
   registry on the same spill directory and a fresh decode engine adopt
   the prompt blocks from disk and give (c)'s greedy tokens with no
   prefill forward;
10b. the train step (phase 10's trees freed): (a) the training kernels
   against their plain versions, timed beside the bound and SDPA's or
   F.rms_norm's forward and backward: the attention forward with
   log-sum-exp and its backward at the step's shapes (q [8, 512, 32, 128],
   k/v [8, 512, 8, 128], causal, bf16), ragged S of 100 and 77 at group
   sizes 4 and 1 in bf16 and fp32, the RMSNorm backward in plain and add
   mode at [4096, 4096] in bf16 and fp32 (each twice, the same bits; the
   bf16 forward also timed beside the serving entry's rows kernel on its
   inputs); the bf16 attention backward also at TRAIN_BWD_CASES (group 8,
   a q_offset, keys not a multiple of 64, no mask, head dim 32), fed the
   log-sum-exp forward held to its plain version there too, with each bf16
   case's D, dk/dv and dq launches timed apart (each run alone), P and dS
   in one bf16 part against two (each form's error, whether it holds
   TRAIN_TOL, its times; the kernels' two parts restored), and the ptxas
   registers and spills and the SASS's HGMMA / UTMALDG / SYNCS counts of
   every instance of the bf16 forward and backward kernels; (b)
   the port's make_train_step at Llama-3-8B width, 16 of its 32 layers,
   bf16, on a one-rank mesh: 10 steps of adamw(3e-4, weight_decay=0.1) on
   make_token_batch's 8 x 513 tokens, every loss finite, the first near
   ln(V), the fifth and the last lower, the same steps with attention and
   the norms on their plain versions within 2% each, exact launch counts
   every step (L
   log-sum-exp forwards and attention backwards, 2L + 1 norm forwards and
   backwards); ms a step split into forward, backward and optimizer,
   tokens/s, MFU, peak memory and a profiled step's busy share; the last
   step again with remat=True and (d) on the mesh build_mesh_from_env
   builds (initialize_distributed a no-op without a span): the same loss
   and parameters bit for bit; (c) two layers at the 8B widths in fp32,
   one step on the card and on the CPU: losses within 1e-5, gradients and
   parameters within the stated tolerances;
11. one JSON line of kernels, the card line, and last
   {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import re
import subprocess
import sys
import time
import types

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
# the engine's modes, measured in turns: (pipeline_decode, decode_horizon) at
# dispatch depth 1, or None: the constructor's own defaults (a horizon of 8,
# depth 2, dispatch-ahead on)
SERVE_MODES = {"off": (False, 1), "on": (True, 1), "h8": (False, 8), "default": None}
SERVE_ORDER = ("off", "on", "h8", "default", "default", "h8", "on", "off")
# the sampled drains of the same traffic: (decode_horizon, dispatch_depth),
# request i at SERVE_TEMPS[i % 4]
SAMPLED_MODES = {"s_h1": (1, 1), "s_h8": (8, 1), "s_h8_d2": (8, 2)}
SAMPLED_ORDER = ("s_h1", "s_h8", "s_h8_d2", "s_h8_d2", "s_h8", "s_h1")
SERVE_TEMPS = (0.0, 0.7, 1.0, 1.3)
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
# the draft engine at dispatch depth 1 (spec) and 2 (spec_d2), in turns
SPEC_ORDER = ("plain", "spec", "spec_d2", "spec_d2", "spec", "plain")
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
# (K, N) of the five int8 products of a Llama-3-8B forward
QUANT_SHAPES = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024), ("w_gate/w_up", 4096, 14336),
                ("w_down", 14336, 4096), ("lm_head", 4096, 128256))
# the products at a draft catch-up's rows (8 slots x H = 8; route D) and at
# the int8 greedy prefill's (8 x 128; route P)
QUANT_CATCHUP_CASES = tuple((f"quant {w} catch-up", 64, k, n) for w, k, n in QUANT_SHAPES[:3])
QUANT_PREFILL_CASES = tuple((f"quant {w} prefill 1024", BATCH * PROMPT, k, n)
                            for w, k, n in QUANT_SHAPES)
# --quant-sweep: route D's forced splits and route P's tiles (weight
# columns), and two products at a verify's rows (8 slots x k + 1 = 5)
QUANT_SPLITS = (1, 2, 4, 8)
QUANT_TILES = (128, 256)
QUANT_VERIFY_CASES = (("quant wq/wo verify", 40, 4096, 4096),
                      ("quant w_gate/w_up verify", 40, 4096, 14336))
# phase 6's int8 hold: a prefill of 8 x 24 tokens (192 rows, above the
# crossover: every product on route P), then one decode step (route D)
INT8_CHECK_TOKENS = 24
# how often each decode shape runs in one forward of a 32-layer model
QUANT_PER_LAYER = {"quant wq/wo decode": 2, "quant wk/wv decode": 2,
                   "quant w_gate/w_up decode": 2, "quant w_down decode": 1}
# phase 3's T-query cases over phase 8's pools: a verify of k + 1 = 5
# tokens and a draft catch-up of H = 8, lanes at lens = pos0 + T
MULTI_LENS = (5, 37, 64, 69, 100, 129, 160, 192)
# the standalone verify: 5 queries at the end of a 133-row cache
STANDALONE_CAP = STANDALONE_PROMPT + STANDALONE_NEW + SPEC_K + 1
# phase 3's token picks over Llama-3's vocabulary: an engine step's 8 rows
# (temperatures 0, 0.7, 1.0, 1.3 twice over), the draft's all-greedy rows,
# and a verify's 8 x (k + 1) rows (a lane's temperature at its position 0)
VOCAB = 128256
PICK_ROW_TEMPS = SERVE_TEMPS * 2
# every row drawing (a chat front end where no request is greedy)
PICK_ALL_TEMPS = tuple(SERVE_TEMPS[1 + i % 3] for i in range(BATCH))
PICK_VERIFY_TEMPS = tuple(t if j == 0 else 0.0 for t in PICK_ROW_TEMPS for j in range(SPEC_K + 1))
# (name, rows, temperatures (None: all greedy), logits type)
PICK_CASES = (("pick decode", BATCH, PICK_ROW_TEMPS, "float32"),
              ("pick decode greedy", BATCH, None, "float32"),
              ("pick decode all sampled", BATCH, PICK_ALL_TEMPS, "float32"),
              ("pick verify", len(PICK_VERIFY_TEMPS), PICK_VERIFY_TEMPS, "float32"),
              ("pick decode bf16", BATCH, PICK_ROW_TEMPS, "bfloat16"))
# the graphed pick timer: at least this many launches over at least this
# many bytes of logits copies (over the 50 MB L2)
PICK_GRAPH_CALLS, PICK_GRAPH_BYTES = 16, 64 << 20
# a sampled row may pick another token than the plain version where the
# plain version's top two scores lie within this share of max(1, |top|):
# the noise goes through logf / log1pf on the card and torch's log in the
# plain version, an ulp apart at most
PICK_NEAR_TIE = 1e-5

# phase 3's MoE cases: Mixtral's 8 experts, top 2, at the no-drop capacity
# (C = 2T) over the tokens of a decode (8 slots), the engine's largest
# config-6 prefill bucket and greedy_generate's prefill (8 x 128)
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_TOKENS = (("decode", BATCH), ("engine prefill", 64), ("greedy prefill", BATCH * PROMPT))
# phase 9: Mixtral-8x7B at full width, 16 of its 32 layers (the full tree,
# 93.4 GB in bf16, exceeds the card's 80 GB); the engine's classic tick and
# its defaults (a horizon of 8, depth 2), drained in turns
MOE_LAYERS = 16
MOE_SERVE_MODES = {"classic": {"decode_horizon": 1, "dispatch_depth": 1}, "default": {}}
MOE_SERVE_ORDER = ("classic", "default", "default", "classic")
# the fp32 card-vs-CPU engine at one Mixtral-width layer: the CPU's expert
# products read 5.6 GB of fp32 weights a step, so budgets are kept short
MOE_CROSS_BUDGET = {1: 6, 8: 16}
# fp32 prefill logits of that layer, card vs CPU: the products sum in
# another order (cuBLAS, TF32 off, against the CPU's), ~1e-5 on logits of
# order 1; a kernel fault shows as errors of order 0.1 and more
MOE_CROSS_TOL = 1e-3
# phase 3's expert products at Mixtral's widths, bf16, each kernel against
# its plain version on the live rows: the fp32 sums run in another order
# than cuBLAS's, so a value may round to a neighbouring bf16 number; bits
# equal on at least this share of the live elements, none further apart
# than this many bf16 ulps
MOE_EXPERT_BIT_SHARE = 0.99
MOE_EXPERT_ULPS = 2
MOE_DIM, MOE_FFN = 4096, 14336


def serve_prompt_len(i: int) -> int:
    return 8 + (i % 5) * 7


def serve_budget(i: int) -> int:
    return 32 + (i * 13) % 33


# phase 10: the serving engram at Llama-3-8B width and depth. The tree is
# saved into a FileStore under build/ and restored by the engram; config
# 6's paging (PagedConfig(8, 16, 256, 8), the engram's default prefix
# caching on) at its default horizon and depth
ENGRAM_DIR = "build/engram"
ENGRAM_PREFIX = "runs/smoke/llama3-8b"
ENGRAM_PAGING = {"maxSlots": 8, "blockSize": 16, "numBlocks": 256, "maxBlocksPerSeq": 8}
ENGRAM_CONFIG = {"model": "8b", "checkpoint": ENGRAM_PREFIX, "paging": ENGRAM_PAGING,
                 "decodeHorizon": 8, "dispatchDepth": 2}
ENGRAM_HUB = "inproc"

# phase 10b: the train step (bobrapet_tpu/parallel/train.py:36) at
# Llama-3-8B width. Params, grads and optax's bf16 moments take 8 bytes a
# parameter, so the 8.03B of the full depth (64 GB) leave no room for the
# activations: 16 of the 32 layers (4.54B parameters), the measured peak
# under 70 GB. Traffic: make_token_batch's 8 x (512 + 1) tokens (S a
# multiple of 128, the JAX package's flash condition), 10 steps of
# adamw(3e-4, weight_decay=0.1) (JAX's default) on one repeated batch.
TRAIN_LAYERS = 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
TRAIN_LR, TRAIN_WD = 3e-4, 0.1
# the loss after this many steps must be below the first, and the last
# below it. Not every step: AdamW at 3e-4 without warmup moves every random
# weight by ~2% a step at these widths and overshoots once (the loss rises
# at step 2 on the plain path as on the kernels)
TRAIN_FALLING = 5
# the same steps with attention and the norms on their plain versions
# (autograd differentiates them): each loss within this share of the
# kernels' (bf16 rounding in another order, carried through the steps;
# 0.32% at most in the first A/B on the card)
TRAIN_PLAIN_RTOL = 0.02
# the first loss against ln(V): random weights give logits of unit
# variance, which adds about 1/2 to ln(V); a broken forward or head lands
# far from it
TRAIN_FIRST_LOSS_TOL = 1.0
# the card against the CPU in fp32: two layers at the 8B widths, 2 x (64 +
# 1) tokens, the scalar kernels against the plain versions
TRAIN_CROSS_LAYERS, TRAIN_CROSS_BATCH, TRAIN_CROSS_SEQ = 2, 2, 64
# losses of the fp32 card and CPU steps: sums in another order, ~1e-7
TRAIN_CROSS_LOSS_RTOL = 1e-5
# each leaf's gradient (10 x Adam's first moment after one step), card vs
# CPU, within this share of the leaf's largest gradient: fp32 sums in
# another order give ~1e-6; a kernel fault gives errors of order 1
TRAIN_CROSS_GRAD_RTOL = 1e-4
# parameters after the step, within this of the CPU's (of 1 + |p|).
# Adam's update -lr g / (|g| + 1e-8) is the same up to rounding wherever
# |g| exceeds 1000x the leaf's largest gradient difference; within that
# of zero (but not 0) the quotient may swing by up to 2 lr. A parameter
# past the tolerance must lie there, and such parameters must stay rare
TRAIN_CROSS_PARAM_TOL = 1e-6
TRAIN_CROSS_FLOOR, TRAIN_CROSS_FLIP_SHARE = 1e3, 1e-4
# phase 10b's kernel cases: (name, b, s, hq, hkv, dtype) of the attention
# forward with log-sum-exp and its backward, causal, q_offset 0
TRAIN_ATTN_CASES = (("train step", TRAIN_BATCH, TRAIN_SEQ, 32, 8, "bfloat16"),
                    ("ragged group 4", 2, 100, 32, 8, "bfloat16"),
                    ("ragged group 4 fp32", 2, 100, 32, 8, "float32"),
                    ("ragged group 1", 2, 77, 8, 8, "bfloat16"),
                    ("ragged group 1 fp32", 2, 77, 8, 8, "float32"))
# phase 10b's further bf16 cases of the attention backward: (name, b, sq,
# sk, hq, hkv, d, causal, q_offset); lse from the log-sum-exp forward at the
# same mask
TRAIN_BWD_CASES = (("ragged group 8", 2, 100, 100, 64, 8, 128, True, 0),
                   ("S 77 group 4", 2, 77, 77, 32, 8, 128, True, 0),
                   ("S 77 group 8", 2, 77, 77, 64, 8, 128, True, 0),
                   ("q_offset 64 Sk 164", 2, 100, 164, 32, 8, 128, True, 64),
                   ("Sk 200 no mask", 1, 128, 200, 32, 8, 128, False, 0),
                   ("head dim 32", 2, 100, 100, 8, 2, 32, True, 0),
                   ("group 8 train width", 4, 512, 512, 64, 8, 128, True, 0))
# the bf16 backward's three launches by their bits in
# ops.flash_backward_launches: each is timed alone
BWD_LAUNCHES = (("delta", 1), ("dkdv", 2), ("dq", 4))
# the RMSNorm backward at the train step's rows (8 x 512 tokens)
TRAIN_NORM_ROWS = TRAIN_BATCH * TRAIN_SEQ
# the backward kernels against their plain versions (atol, rtol): bf16, the
# plain versions compute in fp32 from the same inputs; the attention
# kernel feeds P and dS to the tensor cores as two bf16 parts (~16 bits)
# and sums in another order, then rounds once: one bf16 ulp of |plain|
# plus 1e-2 for the cancellations of gradients of order 1-10; the norm:
# two ulps plus 1e-3, in the add mode of |plain| + |the norm's own
# gradient| (rounded before ds is added). fp32: the forward's
# 2e-4; the norm's weight gradient sums 4,096 rows in another order:
# 1e-5 of |plain| plus 1e-4.
TRAIN_TOL = {
    ("attention_bwd", "bfloat16"): (1e-2, 2.0 ** -7),
    ("attention_bwd", "float32"): (2e-4, 2e-4),
    ("rmsnorm_bwd", "bfloat16"): (1e-3, 2.0 ** -6),
    ("rmsnorm_bwd", "float32"): (1e-4, 1e-5),
}
# the log-sum-exp of each row, card vs plain (fp32, values ~6-10)
TRAIN_LSE_TOL = 1e-4
# the disaggregated legs: config 6's 16 requests and budgets with
# block-aligned prompts of 16, 32 or 48 tokens, so a handoff adopts every
# prompt block and the decode engine runs no prefill at all (traffic built
# for the fast path, not users' traffic), greedy, then sampled at
# SERVE_TEMPS; then config 6's own prompts (8-36 tokens, none a whole
# number of blocks) sampled at SERVE_TEMPS, where the decode engine adopts
# the full blocks and prefills each suffix over them (held to a replay
# without the pipeline, and to the unified engine up to near-ties); a warm
# drain on its own aligned prompts first. (name, temperatures, seed
# offset, aligned)
def disagg_prompt_len(i: int) -> int:
    return 16 * (1 + i % 3)


DISAGG_LEGS = (("greedy", (0.0,), 31, True), ("sampled", SERVE_TEMPS, 32, True),
               ("config6_prompts", SERVE_TEMPS, 33, False))

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


def phase_mark(t_start: float, phase: str) -> None:
    """The run's seconds so far, as phase ``phase`` starts."""
    print(f"phase {phase} starts at {time.perf_counter() - t_start:.1f} s", flush=True)


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


def graphed_ms(torch, calls, replays: int = 20) -> float:
    """Device ms per call of a CUDA graph that runs ``calls`` (functions of
    no argument) in order: the calls warmed up on a side stream, captured
    once, then the median of ``replays`` replays (each behind a ~0.25 ms
    spin, as in :func:`time_ms`) over the number of calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(replays)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(replays)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(500_000)
        s.record()
        graph.replay()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    del graph
    return times[len(times) // 2] / len(calls)


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, kind, name, out, ref, dtype_name, mag=None) -> float:
    """Max abs error of ``out`` against ``ref``; fails past ``atol + rtol *
    |ref|`` (``mag`` in place of ``|ref|`` where a rounding before the last
    step bounds the error: the add-mode norm backward)."""
    atol, rtol = (QUANT_TOL[dtype_name] if kind == "quant"
                  else {**TOL, **TRAIN_TOL}[(kind, dtype_name)])
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        fail(f"{name}: kernel output not finite")
    err = (out - ref).abs()
    worst = float((err - rtol * (ref.abs() if mag is None else mag)).max())
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
    version (which widens the weight to x's type first), on the route the
    wrapper picks. The yardstick is torch.matmul on the weight dequantized
    ahead of time (its widening not timed)."""
    leaf = quant.quantize_array(
        (torch.randn((k, n), generator=gen, device=dev) * (1.0 / 64)).to(dtype))
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    q, scale = leaf["q"], leaf["scale"]
    dn = str(dtype).split(".")[-1]
    routes = dict(getattr(ops.quant_matmul_cuda, "routes", {}))
    err = compare(torch, "quant", name, ops.quant_matmul_cuda(x, q, scale),
                  ops.quant_matmul_reference(x, q, scale), dn)
    # the route that carried it (None for a kernel without routes)
    route = next((r for r, c in getattr(ops.quant_matmul_cuda, "routes", {}).items()
                  if c != routes[r]), None)
    w = quant.dequantize_array(leaf)
    b_ms, b_by = bound(quant_bytes(m, k, n, x.element_size()), 2 * m * k * n, dn)
    return {
        "case": name, "x": [m, k], "q": [k, n], "dtype": dn, "route": route,
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.quant_matmul_cuda(x, q, scale), flush),
        "plain_ms": time_ms(torch, lambda: ops.quant_matmul_reference(x, q, scale), flush),
        "library_ms": time_ms(torch, lambda: torch.matmul(x, w), flush),
        "library": "torch.matmul on the weight dequantized ahead of time",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def pick_bytes(rows: int, v: int, es: int, keyed: bool) -> int:
    """The logits read once, the temperatures, rids and token indices read
    once (when keyed), the tokens written once."""
    return rows * v * es + (12 * rows if keyed else 0) + 4 * rows


def pick_flops(v: int, temps) -> int:
    """A compare an element, and for an element of a sampled row a division,
    an add and two logs more (the noise's integer work is not counted)."""
    return len(temps) * v + sum(t > 0 for t in temps) * v * 4


def pick_inputs(torch, rows: int, v: int, temps, dtype, gen, dev) -> tuple:
    """``rows`` random rows of ``v`` logits (randn x 3, in ``dtype``) and,
    unless ``temps`` is None, their temperatures, rids and token indices."""
    logits = (torch.randn((rows, v), generator=gen, device=dev) * 3).to(dtype)
    if temps is None:
        return logits, ()
    return logits, (torch.tensor(temps, dtype=torch.float32, device=dev),
                    torch.arange(rows, dtype=torch.int32, device=dev) * 7919 + 11,
                    torch.arange(rows, dtype=torch.int32, device=dev) + 5)


def pick_copies(logits) -> list:
    """The graphed timer's copies of ``logits``: PICK_GRAPH_CALLS or more,
    PICK_GRAPH_BYTES together or more, so every launch reads its logits
    from the card's memory."""
    n = max(PICK_GRAPH_CALLS, -(-PICK_GRAPH_BYTES // (logits.numel() * logits.element_size())))
    return [logits.clone() for _ in range(n)]


def pick_case(torch, ops, flush, name, rows, v, temps, dtype, gen, dev):
    """One pick over ``rows`` random rows of ``v`` logits (``temps`` None:
    the all-greedy form the draft's proposals take): greedy rows must equal
    the plain version bit for bit; a sampled row may differ only where the
    plain version's top two scores lie within PICK_NEAR_TIE of max(1,
    |top|). max_abs_err: the largest shortfall of the kernel's token's
    plain score under the plain version's best. The yardstick is
    torch.argmax over the same rows."""
    logits, keyed = pick_inputs(torch, rows, v, temps, dtype, gen, dev)
    got = ops.pick_tokens_cuda(logits, *keyed)
    want = ops.pick_tokens_reference(logits, *keyed)
    torch.cuda.synchronize()
    scores = logits.float()
    sampled = [i for i, t in enumerate(temps or ()) if t > 0]
    if sampled:
        # the module (the package exports a function of its name)
        noise = importlib.import_module("bobrapet_tpu_torch.ops.pick_tokens").gumbel_noise
        rows_s = torch.tensor(sampled, device=dev)
        scores = scores.clone()
        scores[rows_s] = (scores[rows_s] / keyed[0][rows_s][:, None]
                          + noise(keyed[1][rows_s], keyed[2][rows_s], v))
    top = scores.topk(2, dim=-1).values
    shortfall = top[:, 0] - scores.gather(1, got.long()[:, None])[:, 0]
    allowed = PICK_NEAR_TIE * top[:, 0].abs().clamp(min=1.0)
    near = (top[:, 0] - top[:, 1]) <= allowed
    for i in range(rows):
        same = bool(got[i] == want[i])
        if i not in sampled and not same:
            fail(f"{name}: greedy row {i} picked {int(got[i])}, the plain version {int(want[i])}")
        if not same and not (bool(near[i]) and float(shortfall[i]) <= float(allowed[i])):
            fail(f"{name}: sampled row {i} picked {int(got[i])}, the plain version "
                 f"{int(want[i])}, and its top two are no near-tie")
    err = float(shortfall.max())
    print(f"  {name}: rows agreeing {int((got == want).sum())}/{rows} (greedy rows bit for "
          f"bit), max score shortfall {err:.3e}", flush=True)
    dn = str(dtype).split(".")[-1]
    b_ms, b_by = bound(pick_bytes(rows, v, logits.element_size(), bool(keyed)),
                       pick_flops(v, temps or (0.0,) * rows), "float32")
    copies = pick_copies(logits)
    graphed = graphed_ms(torch, [lambda x=x: ops.pick_tokens_cuda(x, *keyed) for x in copies])
    lib_graphed = graphed_ms(torch, [lambda x=x: torch.argmax(x, -1) for x in copies])
    n = len(copies)
    del copies
    return {
        "case": name, "logits": [rows, v], "dtype": dn, "temperatures": temps,
        "rows_agreeing": int((got == want).sum()), "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.pick_tokens_cuda(logits, *keyed), flush),
        "graphed_ms": graphed, "graph_launches": n,
        "plain_ms": time_ms(torch, lambda: ops.pick_tokens_reference(logits, *keyed), flush),
        "library_ms": time_ms(torch, lambda: torch.argmax(logits, -1), flush),
        "library_graphed_ms": lib_graphed,
        "library": "torch.argmax over the same rows (greedy only)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def pick_floor_check(torch, ops, dev) -> dict:
    """The temperature floor on the card: fp32 [4, 128256] (torch.randn *
    3, seed 0, made on the CPU) at T = 1e-39 must pick each row's argmax,
    as JAX's jnp.maximum(t, 1e-6) does, and the same as at T = 1e-6."""
    logits = (torch.randn(4, VOCAB, generator=torch.Generator().manual_seed(0)) * 3).to(dev)
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    picks = {t: ops.pick_tokens_cuda(logits, torch.full((4,), t, device=dev), ids * 7 + 1,
                                     ids).tolist() for t in (1e-39, 1e-6)}
    want = logits.argmax(-1).tolist()
    print(f"  pick floor: T = 1e-39 picks {picks[1e-39]}, T = 1e-6 {picks[1e-6]}, argmax {want}",
          flush=True)
    if picks[1e-39] != want or picks[1e-6] != want:
        fail("the pick at a subnormal temperature is not the argmax: the floor is missing")
    return {"temperature": 1e-39, "picked": picks[1e-39], "argmax": want}


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
    """``--quant-sweep``: the bf16 int8 kernel forced through its C entry
    (bypassing ``ops.quant_matmul``'s rules) onto route D at each cluster
    split of ``QUANT_SPLITS`` (products of up to 128 rows) and onto route P
    at each tile of ``QUANT_TILES`` (products of 40 rows and more), on the
    int8 cases, a verify's and a catch-up's rows: each held against the
    plain version and timed, beside the route, split and tile the rules
    pick (the crossover is set from these) and the bound."""
    from bobrapet_tpu_torch.kernels import KERNEL_DTYPES, check_launch, kernel_function, launch
    from bobrapet_tpu_torch.ops import quant_matmul as qm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    fn = kernel_function("bobra_quant_matmul", qm._ARGTYPES)
    cases = {}
    for name, m, k, n in (QUANT_CASES + QUANT_VERIFY_CASES + QUANT_CATCHUP_CASES
                          + QUANT_PREFILL_CASES):
        leaf = quant.quantize_array(
            (torch.randn((k, n), generator=gen, device=dev) * (1.0 / 64)).to(bf16))
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        out = torch.empty((m, n), dtype=bf16, device=dev)
        ref = qm.quant_matmul_reference(x, leaf["q"], leaf["scale"])
        choices = ([("D", splits, qm.decode_rows(m)) for splits in QUANT_SPLITS] if m <= 128
                   else [])
        choices += [("P", 1, tile) for tile in QUANT_TILES] if m >= 40 else []
        times = {}
        for route, splits, tile in choices:
            def call(route=route, splits=splits, tile=tile):
                return launch(fn, dev.index or 0, x.data_ptr(), leaf["q"].data_ptr(),
                              leaf["scale"].data_ptr(), out.data_ptr(), m, n, k,
                              qm.ROUTE_CODES[route], splits, tile, qm.FLAG_PDL,
                              KERNEL_DTYPES[bf16])
            key = f"D splits {splits}" if route == "D" else f"P tile {tile}"
            check_launch("quant_matmul", call())
            compare(torch, "quant", f"{name} {key}", out, ref, "bfloat16")
            times[key] = time_ms(torch, call, flush)
        b_ms, b_by = bound(quant_bytes(m, k, n, 2), 2 * m * k * n, "bfloat16")
        route = qm.quant_route(m, n, bf16, sms)
        cases[name] = {"x": [m, k], "q": [k, n], "ms": times, "rule": {
            "route": route, "splits_tile": list(qm.route_args(route, m, n, k, sms))},
            "bound_ms": b_ms, "bound_by": b_by}
    return cases


def request_split(torch, llama, params, prompt, cfg, dev, cuda_graph: bool = True,
                  steps: int = 16, profiled: int = 4, forward_fn=None) -> dict:
    """Prefill ms, decode step ms (host clock, synchronised) and the
    device's busy share of a decode step, for the steps of
    ``greedy_generate``'s decoder (eager, or one CUDA graph replayed per
    step): kernel time per step from torch.profiler over ``profiled``
    steps, over the unprofiled step time. The first two steps (with the
    graph's capture) are not timed. ``forward_fn``: another family's
    forward (llama's ``forward_fn`` hook), with its port kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, s = prompt.shape
    cache = llama.init_cache(cfg, b, s + 2 + steps + profiled, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        positions = torch.arange(s, device=dev).expand(b, s)
        if forward_fn is None:
            logits, _ = llama.forward(params, prompt, cfg, cache=cache, positions=positions)
        else:
            logits, _ = forward_fn(params, prompt, cfg, cache, positions)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(logits[:, -1]).all():
            fail("non-finite prefill logits")
        decoder = llama.GreedyDecoder(params, cfg, cache, logits[:, -1:].argmax(-1), s,
                                      cuda_graph=cuda_graph, forward_fn=forward_fn)

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
        "decode_port_kernels": port_kernel_shares(
            kernels, profiled, PORT_KERNELS + (MOE_PORT_KERNELS if forward_fn else ())),
        "decode_int8_products": marked_share(kernels, profiled, "qmm"),
        # PyTorch's argmax, where the tree's greedy loop still calls it
        "decode_argmax": marked_share(kernels, profiled, "ArgMax"),
        "decode_top_kernels": [
            {"name": e.key[:70], "ms_per_step": e.self_device_time_total / 1e3 / profiled,
             "calls_per_step": e.count / profiled} for e in top],
    }


# the port's kernels by the names the profiler gives their instances
PORT_KERNELS = (("paged_attention", ("PagedPolicy", "paged_attention_kernel")),
                ("flash_attention", ("flash_rows_kernel", "DensePolicy", "CachedPolicy",
                                     "flash_attention_kernel")),
                ("rmsnorm", ("rmsnorm_kernel",)),
                ("pick_tokens", ("pick_tokens_kernel",)))


# the MoE kernels' instances, told apart where phase 9 profiles
MOE_PORT_KERNELS = (("moe_route", ("moe_route_kernel",)),
                    ("moe_dispatch", ("moe_dispatch_kernel",)),
                    ("moe_gate_up", ("moe_wide_kernel<true", "moe_narrow_kernel<true",
                                     "moe_f32_kernel<true")),
                    ("moe_down", ("moe_wide_kernel<false", "moe_narrow_kernel<false",
                                  "moe_f32_kernel<false")),
                    ("moe_combine", ("moe_combine_kernel",)))


def port_kernel_shares(kernels, steps: int, table=PORT_KERNELS) -> dict:
    """Device ms and calls per step of each port kernel of ``table``, from
    the profiler's per-kernel averages over ``steps`` steps."""
    out = {name: {"ms_per_step": 0.0, "calls_per_step": 0.0} for name, _ in table}
    for e in kernels:
        for name, marks in table:
            if any(mark in e.key for mark in marks):
                out[name]["ms_per_step"] += e.self_device_time_total / 1e3 / steps
                out[name]["calls_per_step"] += e.count / steps
                break
    return out


def in_horizon_pick(share: dict) -> dict:
    """The pick's device ms and launches a profiled engine tick (one
    horizon at H > 1), and its ms a pick."""
    picks = share["calls_per_step"]
    return {"ms_per_tick": share["ms_per_step"], "picks_per_tick": picks,
            "ms_per_pick": share["ms_per_step"] / picks if picks else None}


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
               ops.paged_attention_multi_cuda, ops.quant_matmul_cuda, ops.pick_tokens_cuda,
               ops.moe_route_cuda, ops.moe_dispatch_cuda, ops.moe_combine_cuda,
               ops.moe_gate_up_cuda, ops.moe_down_cuda):
        fn.launches = 0
    for route in ops.quant_matmul_cuda.routes:
        ops.quant_matmul_cuda.routes[route] = 0


def read_routes(ops) -> dict:
    """The int8 product's launches by route (D, P, F)."""
    return dict(ops.quant_matmul_cuda.routes)


def read_counts(ops) -> dict:
    """The wrappers' counters. ``flash_attention`` counts both entries of
    csrc/flash_attention.cu, ``cached_attention`` the device-length one."""
    return {"rmsnorm": ops.rmsnorm_cuda.launches,
            "add_rmsnorm": ops.add_rmsnorm_cuda.launches,
            "flash_attention": ops.flash_attention_cuda.launches,
            "cached_attention": ops.cached_attention_cuda.launches,
            "paged_attention": ops.paged_attention_cuda.launches}


def greedy_counts(ops) -> dict:
    """:func:`read_counts` and the pick's (a greedy loop's argmax)."""
    return {**read_counts(ops), "pick_tokens": ops.pick_tokens_cuda.launches}


def read_all_counts(ops) -> dict:
    """:func:`read_counts` and the speculative path's two kernels: the
    T-query paged entry and the int8 product."""
    return {**read_counts(ops), "paged_attention_multi": ops.paged_attention_multi_cuda.launches,
            "quant_matmul": ops.quant_matmul_cuda.launches}


def pick_launches(pc: dict, k: int) -> int:
    """The token picks of an engine's run, from its phase counts: one a
    decode step (a classic tick, or each step of a plain horizon), one a
    prefill's first token, and per speculative round or tick k for the
    draft's proposals and one over the verify's rows."""
    return pc["device_steps"] + pc["prefill_picks"] + (pc["spec_rounds"] + pc["spec_ticks"]) * (
        k + 1)


def with_picks(ops, eng, launches: dict, what: str) -> dict:
    """``launches`` with the pick kernel's count of the run, which must be
    :func:`pick_launches` of the engine's phase counts."""
    got, want = ops.pick_tokens_cuda.launches, pick_launches(eng.phase_counts, eng.spec_k)
    if got != want:
        fail(f"{what}: the pick kernel ran {got} times, expected {want}: not every committed "
             "token went through it")
    return {**launches, "pick_tokens": got}


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
    the flash counter also counts); 2L + 1 norms a forward; a pick for the
    first token, one a draft step and one over each verify's rows."""
    t_fwd, d_fwd = 1 + rounds, 1 + rounds * (k + 1)
    cached = rounds * (n_layers + (k + 1) * draft_layers)
    return {"rmsnorm": t_fwd * (2 * n_layers + 1) + d_fwd * (2 * draft_layers + 1),
            "add_rmsnorm": t_fwd * 2 * n_layers + d_fwd * 2 * draft_layers,
            "flash_attention": n_layers + draft_layers + cached, "cached_attention": cached,
            "paged_attention": 0, "paged_attention_multi": 0, "quant_matmul": 0,
            "pick_tokens": 1 + rounds * (k + 2)}


def greedy_launches(n_layers: int) -> dict:
    """Launch counts of one greedy_generate request: 1 + NEW_TOKENS
    forwards, the prefill's attention through the flash entry and every
    decode step's through the device-length entry (which the flash
    counter also counts), and a pick a forward (the prefill's is the
    first token)."""
    forwards = 1 + NEW_TOKENS
    return {**norm_launches(forwards, n_layers), "flash_attention": forwards * n_layers,
            "cached_attention": NEW_TOKENS * n_layers, "paged_attention": 0,
            "pick_tokens": forwards}


def norm_launches(forwards: int, n_layers: int) -> dict:
    """RMSNorm launches of ``forwards`` model forwards: 2L + 1 each, of
    which 2L (every norm after a residual add) in the add mode."""
    return {"rmsnorm": forwards * (2 * n_layers + 1), "add_rmsnorm": forwards * 2 * n_layers}


def spills_in(instances: list, mark: str) -> list:
    """Names of the kernel instances with ``mark`` in their name that spill."""
    return [i["name"] for i in instances
            if mark in i["name"] and (i["spill_stores"] or i["spill_loads"])]


def serve_drain(torch, ops, eng, prompts, temps=None) -> dict:
    """One measured drain of the config-6 traffic (request i at
    ``temps[i % len(temps)]``, greedy without): the counts set to 0 just
    before, read just after; every request must end with exactly its budget
    of in-range tokens."""
    budgets = [serve_budget(i) for i in range(SERVE_REQUESTS)]
    temps = temps or (0.0,)
    eng.reset_phase_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ops)
    t0 = time.perf_counter()
    rids = [eng.submit(p, b, temperature=temps[i % len(temps)])
            for i, (p, b) in enumerate(zip(prompts, budgets))]
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
          f"{eng.decode_horizon}, dispatch_depth={eng.dispatch_depth}, temperatures {temps}) "
          f"launches {launches}, expected {expected}", flush=True)
    if launches != expected:
        fail("the serving path did not run every norm and attention through the kernels")
    launches = with_picks(ops, eng, launches, "serving")
    tokens = sum(budgets)
    ph = eng.phase_seconds
    return {
        "pipeline_decode": eng.pipeline_decode, "decode_horizon": eng.decode_horizon,
        "dispatch_depth": eng.dispatch_depth, "temperatures": list(temps),
        "requests": SERVE_REQUESTS, "new_tokens": tokens, "drain_s": drain_s,
        "tok_per_s": tokens / drain_s, "ticks": ticks, "prefills": prefills,
        "horizons": eng.phase_counts["horizons"],
        "decode_tick_ms": (ph["decode_device"] + ph["host_sync"]) / ticks * 1e3,
        "tick_enqueue_ms": ph["decode_device"] / ticks * 1e3,
        "prefill_ms": ph["prefill"] / prefills * 1e3,
        "host_sync_share": ph["host_sync"] / drain_s,
        "host_overlap_s": ph["host_overlap"], "host_gap_s": ph["host_gap"],
        "ttft_ms_p50": p50(r.ttft_seconds for r in reqs) * 1e3,
        "tpot_ms_p50": p50(r.tpot_seconds for r in reqs) * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "outputs": [r.output for r in reqs],
    }


def drain_device_ms(torch, eng, prompts, temps=None) -> float:
    """The card's kernel time over one more drain of the traffic, under the
    profiler tracing the card alone (its host overhead stretches the drain,
    not the kernels); a mode's busy share is this over its unprofiled
    drain's seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    temps = temps or (0.0,)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, p in enumerate(prompts):
            eng.submit(p, serve_budget(i), temperature=temps[i % len(temps)])
        eng.run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def tick_profile(torch, eng, prompts, steps: int = 8, profiled: int = 4,
                 warm: int = 3, temps=None) -> dict:
    """Steady decode ticks of a full engine (a tick is one horizon when
    the engine has one): host ms per step() over ``steps``
    (synchronised), and the device's busy share of a step from
    torch.profiler's kernel time over ``profiled`` more steps, after
    ``warm`` steps (admission and the first ticks). Every slot's budget
    of 64 lasts the whole stretch; request i at ``temps[i % len(temps)]``
    (greedy without)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if (warm + steps + profiled) * eng.decode_horizon >= 64:
        fail("tick_profile: the budgets would end inside the measured ticks")
    temps = temps or (0.0,)
    for i, p in enumerate(prompts[:eng.pcfg.max_slots]):
        eng.submit(p, 64, temperature=temps[i % len(temps)])
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
    """The continuous-batching engine at full width in its modes (the
    classic tick with dispatch-ahead off and on, the fused horizon of 8
    steps replayed as one CUDA graph, and the engine as its constructor
    builds it: a horizon of 8 at dispatch depth 2): one warm drain each,
    then measured drains in turns (SERVE_ORDER) so that host-clock drift
    between the modes cancels, then a profiled stretch of steady ticks.
    Then the same traffic sampled (SERVE_TEMPS) at (H, depth) (1, 1), (8, 1)
    and (8, 2), in turns (SAMPLED_ORDER): the streams must be the same in
    every mode, and each mode's busy share is the kernel time of one more,
    profiled, drain over its measured drains' median seconds."""
    warm = serve_prompts(torch, cfg, seed + 10, dev)
    prompts = serve_prompts(torch, cfg, seed + 11, dev)
    torch.cuda.reset_peak_memory_stats()

    def build(args: dict):
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**SERVE_PAGING), **args)
        for i, p in enumerate(warm):
            eng.submit(p, serve_budget(i))
        eng.run()
        return eng

    engines = {mode: build({} if spec is None else dict(
        pipeline_decode=spec[0], decode_horizon=spec[1], dispatch_depth=1))
        for mode, spec in SERVE_MODES.items()}
    drains = {mode: [] for mode in SERVE_MODES}
    for mode in SERVE_ORDER:
        drains[mode].append(serve_drain(torch, ops, engines[mode], prompts))
    outputs = [d.pop("outputs") for runs in drains.values() for d in runs]
    if any(o != outputs[0] for o in outputs):
        fail("serving: the engine's modes gave different tokens")
    greedy = outputs[0]
    out = {"model": "llama3_8b", "dtype": "bfloat16", "paging": SERVE_PAGING,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
           "identical_tokens": True, "order": ", ".join(SERVE_ORDER),
           "greedy_outputs": greedy}
    for mode, eng in engines.items():
        runs = drains[mode]
        h = eng.decode_horizon
        out[mode] = {
            "pipeline_decode": eng.pipeline_decode, "decode_horizon": h,
            "dispatch_depth": eng.dispatch_depth, "drains": runs,
            "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
        }
        if mode in ("h8", "default"):
            out[mode]["drain_device_ms"] = drain_device_ms(torch, eng, prompts) or None
        out[mode]["profile"] = tick_profile(torch, eng, warm,
                                            *((8, 4, 3) if h == 1 else (2, 2, 1)))
    del engines

    sampled = {mode: build(dict(decode_horizon=h, dispatch_depth=d))
               for mode, (h, d) in SAMPLED_MODES.items()}
    runs = {mode: [] for mode in SAMPLED_MODES}
    for mode in SAMPLED_ORDER:
        runs[mode].append(serve_drain(torch, ops, sampled[mode], prompts, SERVE_TEMPS))
    # each engine serves its n-th drain under the same rids, so the n-th
    # drains of all modes draw the same keys
    for n in range(2):
        streams = [runs[mode][n]["outputs"] for mode in SAMPLED_MODES]
        if any(s != streams[0] for s in streams):
            fail(f"serving: the sampled streams of drain {n + 1} differ between the modes")
    first = runs["s_h1"][0]["outputs"]
    drawn = sum(a != b for i, (a, b) in enumerate(zip(first, greedy))
                if SERVE_TEMPS[i % len(SERVE_TEMPS)] > 0)
    if drawn == 0:
        fail("serving: no sampled request drew a token other than the greedy one")
    out["sampled"] = {"temperatures": list(SERVE_TEMPS), "order": ", ".join(SAMPLED_ORDER),
                      "identical_streams": True, "sampled_requests_unlike_greedy": drawn}
    for mode, eng in sampled.items():
        for d in runs[mode]:
            d.pop("outputs")
        out["sampled"][mode] = {
            "decode_horizon": eng.decode_horizon, "dispatch_depth": eng.dispatch_depth,
            "drains": runs[mode],
            "launches": {k: sum(r["launches"][k] for r in runs[mode])
                         for k in runs[mode][0]["launches"]},
            "drain_device_ms": drain_device_ms(torch, eng, prompts, SERVE_TEMPS) or None}
    # the sampled horizon's kernels, the pick's among them
    out["sampled"]["s_h8"]["profile"] = tick_profile(torch, sampled["s_h8"], warm, 2, 2, 1,
                                                     temps=SERVE_TEMPS)
    del sampled

    def line(rec: dict) -> dict:
        """A mode's drains side by side; busy share: the profiled drain's
        kernel time over the median measured drain (None: not measured)."""
        ds = rec["drains"]
        busy = rec.get("drain_device_ms")
        return {"tok_per_s": [d["tok_per_s"] for d in ds],
                "ttft_ms_p50": [d["ttft_ms_p50"] for d in ds],
                "tpot_ms_p50": [d["tpot_ms_p50"] for d in ds],
                "host_overlap_s": [d["host_overlap_s"] for d in ds],
                "host_gap_s": [d["host_gap_s"] for d in ds],
                "busy_share": busy / 1e3 / p50(d["drain_s"] for d in ds) if busy else None,
                "peak_memory_gb": max(d["peak_memory_gb"] for d in ds)}

    out["summary"] = {**{m: line(out[m]) for m in SERVE_MODES},
                      **{m: line(out["sampled"][m]) for m in SAMPLED_MODES}}
    print("  serving modes: " + json.dumps(out["summary"]), flush=True)
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
            routes = read_routes(ops)
            if routes != {"D": 0, "P": 0, "F": got["quant_matmul"]}:
                fail(f"the fp32 int8 products did not all take route F: {routes}")
            counts[f"{name}_h{horizon}"] = {**got, "routes": routes,
                                            "spec_rounds": eng.phase_counts["spec_rounds"],
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
    got = with_picks(ops, eng, got, "a phase-8 drain")
    routes = read_routes(ops)
    if sum(routes.values()) != got["quant_matmul"] or routes["F"]:
        fail(f"phase 8: the int8 products' routes {routes} do not add up to their launches")
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
        "launches": got, "routes": routes, "outputs": [r.output for r in reqs],
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


def int8_launches(n_layers: int) -> dict:
    """Launch counts of one greedy_generate request over an int8 tree: the
    bf16 request's norms and attention, and 7L + 1 int8 products a forward,
    the prefill's (8 x 128 rows) all on route P and every decode step's (8
    rows) on route D."""
    per = 7 * n_layers + 1
    return {**greedy_launches(n_layers), "quant_matmul": (1 + NEW_TOKENS) * per,
            "routes": {"D": NEW_TOKENS * per, "P": per, "F": 0}}


def int8_step_bound_ms(n_layers: int) -> float:
    """The least time of one int8 decode step's products (M = 8): the int8
    weights' bytes, x, the scales and the outputs, at the card's memory
    rate."""
    per = {w: bound(quant_bytes(BATCH, k, n, 2), 2 * BATCH * k * n, "bfloat16")[0]
           for w, k, n in QUANT_SHAPES}
    return (n_layers * (2 * per["wq/wo"] + 2 * per["wk/wv"] + 2 * per["w_gate/w_up"]
                        + per["w_down"]) + per["lm_head"])


def int8_phase(torch, ops, llama, qparams, cfg, prompt, dev, card: str) -> dict:
    """Phase 8's first leg, the int8 headline leg (bench.py's BENCH_QUANT=int8
    generate step): phase 4's request through greedy_generate over the int8
    tree, eager, graphed, graphed, eager; identical tokens and exact launch
    counts by route, then the parts of a request in the same turns."""
    t_phase = time.perf_counter()
    expected = int8_launches(cfg.n_layers)
    runs, outputs = [], []
    for graph in GREEDY_RUNS:
        zero_counts(ops)
        t0 = time.perf_counter()
        toks = llama.greedy_generate(qparams, prompt, cfg, max_new_tokens=NEW_TOKENS,
                                     cuda_graph=graph)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**greedy_counts(ops), "quant_matmul": ops.quant_matmul_cuda.launches,
                    "routes": read_routes(ops)}
        print(f"int8 greedy leg (cuda_graph={graph}) launches {launches}, expected {expected}",
              flush=True)
        if launches != expected:
            fail("the int8 greedy leg did not run every product through the kernel on its route")
        if (tuple(toks.shape) != (BATCH, NEW_TOKENS) or toks.dtype != torch.int32
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
            fail(f"int8 greedy leg: bad generated tokens {toks.dtype} {tuple(toks.shape)}")
        outputs.append(toks)
        runs.append({"cuda_graph": graph, "request_s": seconds,
                     "tok_per_s": BATCH * NEW_TOKENS / seconds, "launches": launches})
    if any(not torch.equal(o, outputs[0]) for o in outputs):
        fail("int8 greedy leg: the CUDA-graphed decode changed the tokens")
    splits = [request_split(torch, llama, qparams, prompt, cfg, dev, cuda_graph=graph)
              for graph in GREEDY_RUNS]
    result = {
        "model": "llama3_8b", "weights": "quantize_params, int8", "dtype": "bfloat16",
        "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
        "order": "eager, graph, graph, eager", "identical_tokens": True, "runs": runs,
        "splits": [{**sp, "decode_tok_per_s": BATCH / sp["decode_step_ms"] * 1e3}
                   for sp in splits],
        "int8_products_step_bound_ms": int8_step_bound_ms(cfg.n_layers), "card": card,
        "seconds": time.perf_counter() - t_phase,
    }
    print("int8 greedy leg: " + json.dumps(result), flush=True)
    return result


def int8_whole_path(torch, ops, llama, quant, cfg2, seed: int, dev) -> dict:
    """Phase 6's hold of the int8 routes inside the model: a 2-layer int8
    tree at the 8B widths, prefill of 8 x 24 tokens (192 rows: every
    product on route P) and the next decode step (8 rows: route D) on the
    card, against the same tree's plain versions on the CPU fed the card's
    next tokens."""
    params = llama.init_params(cfg2, torch.Generator(device=dev).manual_seed(seed + 4), dev)
    qparams = quant.quantize_params(params)
    del params
    toks = torch.randint(0, cfg2.vocab_size, (BATCH, INT8_CHECK_TOKENS), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 5))
    pos = torch.arange(INT8_CHECK_TOKENS, device=dev).expand(BATCH, INT8_CHECK_TOKENS)
    per = 7 * cfg2.n_layers + 1
    out = {}
    with torch.no_grad():
        zero_counts(ops)
        cache = llama.init_cache(cfg2, BATCH, INT8_CHECK_TOKENS + 1, device=dev)
        pre, _ = llama.forward(qparams, toks, cfg2, cache=cache, positions=pos)
        nxt = pre[:, -1:].argmax(-1)
        dec, _ = llama.forward(qparams, nxt, cfg2, cache=cache,
                               positions=torch.full((BATCH, 1), INT8_CHECK_TOKENS, device=dev))
        routes = read_routes(ops)
        if routes != {"D": per, "P": per, "F": 0}:
            fail(f"int8 whole-path check: routes {routes}, expected P and D {per} each")
        cpu_tree = tree_to(qparams, "cpu")
        del qparams
        t0 = time.perf_counter()
        cache = llama.init_cache(cfg2, BATCH, INT8_CHECK_TOKENS + 1, device="cpu")
        cpu_pre, _ = llama.forward(cpu_tree, toks.cpu(), cfg2, cache=cache, positions=pos.cpu())
        cpu_dec, _ = llama.forward(cpu_tree, nxt.cpu(), cfg2, cache=cache,
                                   positions=torch.full((BATCH, 1), INT8_CHECK_TOKENS))
        cpu_s = time.perf_counter() - t0
    for name, card_logits, cpu_logits in (("prefill", pre, cpu_pre), ("decode", dec, cpu_dec)):
        if not torch.isfinite(card_logits).all():
            fail(f"int8 whole-path check: non-finite {name} logits on the card")
        err = (card_logits.cpu() - cpu_logits).abs()
        out[name] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                     "max_abs_logit": float(cpu_logits.abs().max()),
                     "argmax_agree": float((card_logits.cpu().argmax(-1) == cpu_logits.argmax(-1))
                                           .float().mean())}
        if out[name]["max_abs_err"] > LOGIT_MAX_ERR or out[name]["mean_abs_err"] > LOGIT_MEAN_ERR:
            fail(f"int8 whole-path check: card and CPU {name} logits disagree")
    result = {**out, "routes": routes, "tolerance": [LOGIT_MAX_ERR, LOGIT_MEAN_ERR],
              "cpu_s": cpu_s}
    print("int8 whole path (2 layers, 8B widths, card vs CPU): " + json.dumps(result),
          flush=True)
    return result


def spec_phase(torch, ops, serving, llama, quant, params, cfg, seed: int, dev, card: str,
               draft=None) -> dict:
    """Phase 8: the draft-less engine against the engine with the target's
    int8 tree as its draft (guard off), drained in turns, then the guarded
    engine warmed until it decides, then standalone speculative_generate.
    ``draft``: that tree when the caller built it already."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if draft is None:
        draft = quant.quantize_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    warm = spec_prompts(torch, cfg, seed + 40, dev)
    prompts = spec_prompts(torch, cfg, seed + 41, dev)
    torch.cuda.reset_peak_memory_stats()
    paging = serving.PagedConfig(**SPEC_PAGING)
    common = dict(decode_horizon=SPEC_HORIZON, dispatch_depth=1)
    spec_kw = dict(draft_params=draft, draft_cfg=cfg, spec_k=SPEC_K, spec_guard=False)
    engines = {"plain": serving.ServingEngine(params, cfg, paging, **common),
               "spec": serving.ServingEngine(params, cfg, paging, **spec_kw, **common),
               "spec_d2": serving.ServingEngine(params, cfg, paging, **spec_kw,
                                                decode_horizon=SPEC_HORIZON, dispatch_depth=2)}
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
    out_d2 = drains["spec_d2"][0]["outputs"]
    if any(a[0] != b[0] for a, b in zip(out_p, out_s)):
        fail("phase 8: a first token (the same prefill) differs with the draft")
    same = sum(x == y for a, b in zip(out_p, out_s) for x, y in zip(a, b))
    divergence = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                  for a, b in zip(out_p, out_s)]
    # the draft engine at depth 2 against depth 1: the same tokens, up to
    # near-ties where the two verify in other alignments (a lane's rounds
    # can start at other positions)
    same_d2 = sum(x == y for a, b in zip(out_s, out_d2) for x, y in zip(a, b))
    divergence_d2 = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                     for a, b in zip(out_s, out_d2)]
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
    d2_checks = []
    for i, j in enumerate(divergence_d2):
        if j is not None:
            run = paged_runner(torch, params, cfg, prompts[i], out_s[i][:j], dev)
            d2_checks.append({"request": i, **divergence_check(run, j, SPEC_K, out_s[i][j],
                                                               out_d2[i][j])})
    print("spec phase, depth 2 against depth 1, first divergences: " + json.dumps(d2_checks),
          flush=True)
    for c in d2_checks:
        # either token may be the one-token step's lower: both came from
        # verify forms within the logit error of it
        if abs(c["margin"]) > 2 * c["max_abs_logit_err"]:
            fail(f"phase 8: at position {c['position']} of request {c['request']} depth 2's "
                 f"token and depth 1's differ by {c['margin']} in the one-token step, beyond "
                 f"twice the logit error {c['max_abs_logit_err']} of the verify forms")

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
        "depth2_equals_depth1_token_share": same_d2 / (SPEC_REQUESTS * SPEC_NEW),
        "depth2_first_divergence": divergence_d2, "depth2_divergence_checks": d2_checks,
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
    got = {**read_all_counts(ops), "pick_tokens": ops.pick_tokens_cuda.launches}
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
    launches = with_picks(ops, eng, launches, "an engine drain")
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


# ---------------------------------------------------------------------------
# the sparse-MoE family: phase 3's MoE kernel cases and phase 9
# ---------------------------------------------------------------------------


def moe_counts(ops) -> dict:
    """The MoE wrappers' counters."""
    return {"moe_route": ops.moe_route_cuda.launches,
            "moe_dispatch": ops.moe_dispatch_cuda.launches,
            "moe_gate_up": ops.moe_gate_up_cuda.launches,
            "moe_down": ops.moe_down_cuda.launches,
            "moe_combine": ops.moe_combine_cuda.launches}


def moe_launches(forwards: int, n_layers: int) -> dict:
    """A route, a gate/up, a down and a combine a layer a forward, and no
    dispatch: the gate/up product gathers its own rows."""
    n = forwards * n_layers
    return {"moe_route": n, "moe_dispatch": 0, "moe_gate_up": n, "moe_down": n,
            "moe_combine": n}


def moe_route_bytes(t: int, e: int, k: int, c: int, es: int) -> int:
    """The logits read once; expert, slot, gate [T, k], src [E, C], counts
    and probsum [E] written once."""
    return t * e * es + 12 * t * k + 4 * e * c + 8 * e


def moe_dispatch_bytes(t: int, e: int, c: int, d: int, es: int) -> int:
    """h's T rows and src read once, the E x C rows written once."""
    return t * d * es + 4 * e * c + e * c * d * es


def moe_combine_bytes(t: int, k: int, d: int, es: int) -> int:
    """The k rows each token takes from the expert rows and its expert,
    slot and gate read once, its row written once (this run's data: every
    (t, k) kept at no-drop capacity)."""
    return t * k * d * es + 12 * t * k + t * d * es


def moe_product_flops(rows: int, d: int, f: int, part: str) -> int:
    """The routed FLOPs of one expert product over ``rows`` live rows:
    gate/up two [rows, d] x [d, f] products, down one [rows, f] x [f, d]."""
    return (2 if part == "gate_up" else 1) * 2 * rows * d * f


def moe_product_bytes(tokens: int, rows: int, live_experts: int, e: int, c: int, d: int,
                      f: int, part: str, es: int) -> int:
    """What one expert product must move, each input read once and each
    output written once: the live experts' weights (gate/up two [d, f],
    down one [f, d]); gate/up reads the T rows of h, src [E, C] and counts
    and writes the live rows of act; down reads those rows and counts and
    writes the live rows of out."""
    if part == "gate_up":
        return live_experts * 2 * d * f * es + tokens * d * es + 4 * e * c + 4 * e + rows * f * es
    return live_experts * f * d * es + rows * f * es + 4 * e + rows * d * es


def moe_live_expert_flops(tokens: int, cfg) -> int:
    """The expert products' FLOPs one forward of ``tokens`` tokens runs on
    the card at the no-drop capacity: every (t, k) is a live row, and only
    live rows are multiplied (``moe_expert_flops``' ``routed``)."""
    rows = tokens * cfg.experts_per_token
    return sum(moe_product_flops(rows, cfg.dim, cfg.ffn_hidden, part)
               for part in ("gate_up", "down")) * cfg.n_layers


def bf16_ulps(torch, a, b):
    """Per element, the bf16 ulps between bf16 tensors ``a`` and ``b``
    (+0 and -0 the same number)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -32768 - bits, bits)

    return (ordered(a) - ordered(b)).abs()


def moe_ties(torch, t: int, e: int, gen, dev):
    """bf16 router logits where every row ties: two random experts share the
    row's top value, and every fifth row is all equal."""
    x = torch.round(torch.randn((t, e), generator=gen, device=dev) * 2) / 2
    pair = torch.rand((t, e), generator=gen, device=dev).argsort(dim=1)[:, :2]
    x.scatter_(1, pair, (x.max(dim=1, keepdim=True).values + 0.5).expand(t, 2))
    x[::5] = x[::5, :1]
    return x.to(torch.bfloat16)


def moe_route_case(torch, ops, flush, name, t, dtype, gen, dev, ties=False):
    """The route of ``t`` tokens over Mixtral's 8 experts, top 2, at the
    no-drop capacity (C = 2t): experts, slots, src and counts bit for bit;
    the gates bit for bit with forced ties, else within 2 fp32 ulps (the
    plain version's torch.exp against the kernel's expf; their bit share
    reported); probsum within 1e-5 (another sum order). The yardstick is
    torch.topk over the softmax (ties in its own order)."""
    e, k, c = MOE_EXPERTS, MOE_TOP_K, MOE_TOP_K * t
    logits = (moe_ties(torch, t, e, gen, dev) if ties
              else (torch.randn((t, e), generator=gen, device=dev) * 2).to(dtype))
    got = ops.moe_route_cuda(logits, k, c)
    want = ops.moe_route_reference(logits, k, c)
    for what, a, b in zip(("expert", "slot", "src", "counts"), (got[0], got[1], got[3], got[4]),
                          (want[0], want[1], want[3], want[4])):
        if not torch.equal(a, b):
            fail(f"{name}: the kernel's {what} differ from the plain version's")
    gate_err = float((got[2] - want[2]).abs().max())
    gate_share = float((got[2] == want[2]).float().mean())
    if ties and gate_share != 1.0:
        fail(f"{name}: tied gates are not bit for bit the plain version's")
    if not bool(((got[2] - want[2]).abs() <= 2.0 ** -22 * want[2].abs()).all()):
        fail(f"{name}: the kernel's gates differ from the plain version's by over 2 ulps")
    if not bool(((got[5] - want[5]).abs() <= 1e-5 * want[5].abs() + 1e-6).all()):
        fail(f"{name}: the kernel's probability sums differ from the plain version's")
    print(f"  {name}: experts, slots, src, counts bit for bit; gates max_abs_err {gate_err:.3e}, "
          f"bit-identical on {gate_share:.6f}", flush=True)
    dn = str(logits.dtype).split(".")[-1]
    b_ms, b_by = bound(moe_route_bytes(t, e, k, c, logits.element_size()),
                       t * e * 5 + t * k * e, dn)
    return {
        "case": name, "kernel": "moe_route", "tokens": t, "experts": e, "top_k": k,
        "capacity": c, "dtype": dn, "forced_ties": ties, "max_abs_err": gate_err,
        "gate_bit_share": gate_share,
        "ms": time_ms(torch, lambda: ops.moe_route_cuda(logits, k, c), flush),
        "plain_ms": time_ms(torch, lambda: ops.moe_route_reference(logits, k, c), flush),
        "library_ms": time_ms(torch, lambda: torch.topk(torch.softmax(logits.float(), -1), k),
                              flush),
        "library": "torch.topk over torch.softmax (two calls)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def moe_dispatch_case(torch, ops, flush, name, t, d, dtype, gen, dev):
    """The dispatch of ``t`` rows of width ``d`` into Mixtral's E x C rows
    (C = 2t, the route of random logits): bit for bit (a copy, zeros in the
    empty rows). The yardstick is torch.index_select of the same rows,
    which leaves the empty rows' content to an index of its own."""
    e, k, c = MOE_EXPERTS, MOE_TOP_K, MOE_TOP_K * t
    logits = (torch.randn((t, e), generator=gen, device=dev) * 2).to(dtype)
    src = ops.moe_route_reference(logits, k, c)[3]
    h = torch.randn((t, d), generator=gen, device=dev).to(dtype)
    out = ops.moe_dispatch_cuda(h, src)
    if not torch.equal(out, ops.moe_dispatch_reference(h, src)):
        fail(f"{name}: the kernel's rows differ from the plain version's")
    print(f"  {name}: bit for bit, {int((src < 0).sum())} of {e * c} rows empty", flush=True)
    rows = src.reshape(-1).clamp_min(0)
    dn = str(dtype).split(".")[-1]
    b_ms, b_by = bound(moe_dispatch_bytes(t, e, c, d, h.element_size()), 0, dn)
    return {
        "case": name, "kernel": "moe_dispatch", "tokens": t, "rows": [e, c, d], "dtype": dn,
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: ops.moe_dispatch_cuda(h, src), flush),
        "plain_ms": time_ms(torch, lambda: ops.moe_dispatch_reference(h, src), flush),
        "library_ms": time_ms(torch, lambda: torch.index_select(h, 0, rows), flush),
        "library": "torch.index_select of the src rows",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def moe_combine_case(torch, ops, flush, name, t, d, dtype, gen, dev):
    """The combine of ``t`` tokens from Mixtral's E x C expert rows (C = 2t,
    the route of random logits): bit for bit (the same fp32 roundings). The
    yardstick is JAX's formulation, one fp32 einsum("tec,ecd->td") over the
    one-hot combine tensor (built and widened outside the timer)."""
    e, k, c = MOE_EXPERTS, MOE_TOP_K, MOE_TOP_K * t
    logits = (torch.randn((t, e), generator=gen, device=dev) * 2).to(dtype)
    expert, slot, gate, *_ = ops.moe_route_reference(logits, k, c)
    out_e = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
    got = ops.moe_combine_cuda(out_e, expert, slot, gate)
    if not torch.equal(got, ops.moe_combine_reference(out_e, expert, slot, gate)):
        fail(f"{name}: the kernel's rows differ from the plain version's")
    print(f"  {name}: bit for bit", flush=True)
    onehot = torch.zeros((t, e, c), device=dev)
    onehot[torch.arange(t, device=dev)[:, None], expert.long(), slot.long()] = gate
    out_f = out_e.float()
    dn = str(dtype).split(".")[-1]
    b_ms, b_by = bound(moe_combine_bytes(t, k, d, out_e.element_size()), 2 * t * k * d, dn)
    return {
        "case": name, "kernel": "moe_combine", "tokens": t, "rows": [e, c, d], "dtype": dn,
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: ops.moe_combine_cuda(out_e, expert, slot, gate), flush),
        "plain_ms": time_ms(torch, lambda: ops.moe_combine_reference(out_e, expert, slot, gate),
                            flush),
        "library_ms": time_ms(torch, lambda: torch.einsum("tec,ecd->td", onehot, out_f), flush),
        "library": "JAX's fp32 einsum('tec,ecd->td') over the one-hot combine",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def moe_expert_case(torch, ops, flush, label, t, weights, gen, dev, empty=False) -> list:
    """The gate/up and down kernels of ``t`` tokens at Mixtral's widths
    (bf16, 8 experts, top 2, C = 2t; the route of random logits, with
    ``empty`` expert 0 never chosen), each against its plain version on the
    live rows: bits equal on MOE_EXPERT_BIT_SHARE of them and none more than
    MOE_EXPERT_ULPS apart. The down kernel takes the gate/up kernel's rows,
    so each is held alone. The bound is the larger of the routed FLOPs at the
    bf16 peak and the bytes (the live experts' weights, the rows) at the HBM
    rate. Each is timed against the parent's sequence for the same function
    (``parent_sequence_ms``: for gate/up the dispatch kernel, torch.bmm over
    every capacity row and the fp32 elementwise; for down one torch.bmm).
    The down product is one batched product, so that torch.bmm is also its
    library call (``library_ms``); no single PyTorch call computes the
    gate/up product with its gather and SwiGLU (``library_ms`` None)."""
    from bobrapet_tpu_torch.ops.moe_experts import live_rows

    bf16, silu = torch.bfloat16, torch.nn.functional.silu
    w_gate, w_up, w_down = weights
    e, k, c = MOE_EXPERTS, MOE_TOP_K, MOE_TOP_K * t
    d, f = w_gate.shape[1], w_gate.shape[2]
    logits = torch.randn((t, e), generator=gen, device=dev) * 2
    if empty:
        logits[:, 0] = -30.0
    _, _, _, src, counts, _ = ops.moe_route_reference(logits.to(bf16), k, c)
    h = torch.randn((t, d), generator=gen, device=dev).to(bf16)
    act = ops.moe_gate_up_cuda(h, src, counts, w_gate, w_up)
    out = ops.moe_down_cuda(act, counts, w_down, t)
    want_act = ops.moe_gate_up_reference(h, src, counts, w_gate, w_up)
    want_out = ops.moe_down_reference(act, counts, w_down)
    torch.cuda.synchronize()
    live = live_rows(counts, c)
    rows, live_e = int(live.sum()), int((counts > 0).sum())
    if empty and int(counts[0]) != 0:
        fail(f"moe experts {label}: expert 0 took a token")

    def parent_gate_up():
        x = ops.moe_dispatch_cuda(h, src)
        return (silu(torch.bmm(x, w_gate).float()) * torch.bmm(x, w_up).float()).to(bf16)

    cases = []
    for part, got, want, run, plain, parent, library in (
            ("gate_up", act, want_act,
             lambda: ops.moe_gate_up_cuda(h, src, counts, w_gate, w_up),
             lambda: ops.moe_gate_up_reference(h, src, counts, w_gate, w_up), parent_gate_up,
             None),
            ("down", out, want_out, lambda: ops.moe_down_cuda(act, counts, w_down, t),
             lambda: ops.moe_down_reference(act, counts, w_down),
             lambda: torch.bmm(want_act, w_down), "torch.bmm")):
        g, r = got[live], want[live]
        if not torch.isfinite(g.float()).all():
            fail(f"moe {part} {label}: the kernel's live rows are not finite")
        ulps = bf16_ulps(torch, g, r)
        share, worst = float((ulps == 0).float().mean()), int(ulps.max())
        print(f"  moe {part} {label}: {rows} live rows, {live_e} live experts, bits equal on "
              f"{share:.6f}, at most {worst} bf16 ulps apart", flush=True)
        if share < MOE_EXPERT_BIT_SHARE or worst > MOE_EXPERT_ULPS:
            fail(f"moe {part} {label}: the kernel differs from the plain version (bits equal "
                 f"on {share}, {worst} ulps)")
        b_ms, b_by = bound(moe_product_bytes(t, rows, live_e, e, c, d, f, part, 2),
                           moe_product_flops(rows, d, f, part), "bfloat16")
        # the kernel first, as every phase-3 case: the parent's dense
        # sequence, timed before it, would leave the card hot
        ms, plain_ms = time_ms(torch, run, flush), time_ms(torch, plain, flush)
        parent_ms = time_ms(torch, parent, flush)
        cases.append({
            "case": f"moe {part} {label}", "kernel": f"moe_{part}", "tokens": t,
            "capacity": c, "rows": rows, "live_experts": live_e,
            "dtype": "bfloat16", "max_abs_err": float((g.float() - r.float()).abs().max()),
            "bit_share": share, "max_ulps": worst, "ms": ms, "plain_ms": plain_ms,
            "parent_sequence_ms": parent_ms,
            # the down product's parent sequence is one torch.bmm: its library call
            "library_ms": parent_ms if library else None, "library": library,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    return cases


def moe_kernel_cases(torch, ops, flush, gen, dev) -> list:
    """Phase 3's MoE cases: route, dispatch, gate/up, down and combine at
    each of MOE_TOKENS (bf16, d = 4096, f = 14336), the route with forced
    ties, and the expert products with an empty expert."""
    bf16, d = torch.bfloat16, MOE_DIM
    e, f = MOE_EXPERTS, MOE_FFN

    def weight(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev)
        return w.mul_(fan_in ** -0.5).to(bf16)

    weights = (weight((e, d, f), d), weight((e, d, f), d), weight((e, f, d), f))
    cases = []
    for label, t in MOE_TOKENS:
        cases.append(moe_route_case(torch, ops, flush, f"moe route {label}", t, bf16, gen, dev))
        cases.append(moe_dispatch_case(torch, ops, flush, f"moe dispatch {label}", t, d, bf16,
                                       gen, dev))
        cases += moe_expert_case(torch, ops, flush, label, t, weights, gen, dev)
        cases.append(moe_combine_case(torch, ops, flush, f"moe combine {label}", t, d, bf16,
                                      gen, dev))
    cases += moe_expert_case(torch, ops, flush, "decode, expert 0 empty", BATCH, weights, gen,
                             dev, empty=True)
    cases.append(moe_route_case(torch, ops, flush, "moe route ties", BATCH * PROMPT, bf16, gen,
                                dev, ties=True))
    del weights
    return cases


def moe_split(torch, prof, steps: int) -> dict:
    """Device ms a step by part, from a profile of eager steps: the expert
    products (the gate/up and down kernels: ``expert_products_ms``; and
    ``aten::bmm``, the plain versions' batched products, which should read
    0), the other products (``aten::mm``: q, k, v, o, the router and the LM
    head), each port kernel, PyTorch's elementwise kernels, and the total."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def op_ms(key: str) -> float:
        return sum(e.device_time_total for e in events
                   if e.key == key and e.device_type == DeviceType.CPU) / 1e3 / steps

    shares = port_kernel_shares(kernels, steps, PORT_KERNELS + MOE_PORT_KERNELS)
    return {"device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / steps,
            "expert_bmm_ms": op_ms("aten::bmm"),
            "expert_products_ms": (shares["moe_gate_up"]["ms_per_step"]
                                   + shares["moe_down"]["ms_per_step"]),
            "other_mm_ms": op_ms("aten::mm"),
            **{f"{name}_ms": s["ms_per_step"] for name, s in shares.items()},
            "elementwise_ms": elementwise_share(kernels, steps)["ms_per_step"]}


def moe_step_profile(torch, moe, params, prompt, cfg, dev) -> dict:
    """The greedy request's parts on the Mixtral tree: one prefill and
    eager decode steps under the profiler (CPU and CUDA activity, so each
    product is told apart by its op), split by :func:`moe_split`."""
    from torch.profiler import ProfilerActivity, profile

    b, s = prompt.shape
    steps = 4
    cache = moe.init_cache(cfg, b, s + steps + 2, device=dev)
    pos = torch.arange(s, device=dev).expand(b, s)
    with torch.no_grad():
        moe.routed_forward(params, prompt, cfg, moe.init_cache(cfg, b, s, device=dev), pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, _ = moe.routed_forward(params, prompt, cfg, cache, pos)
            torch.cuda.synchronize()
        prefill = moe_split(torch, prof, 1)
        decoder = moe.llama.GreedyDecoder(params, cfg, cache, logits[:, -1:].argmax(-1), s,
                                          cuda_graph=False, forward_fn=moe.routed_forward)
        decoder.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                decoder.step()
            torch.cuda.synchronize()
    return {"prefill": prefill, "decode_step": moe_split(torch, prof, steps)}


def moe_expert_flops(tokens: int, cfg) -> dict:
    """The expert products' FLOPs of one forward of ``tokens`` tokens: as
    run (every capacity row of every expert: E x C rows) and as routed
    (T x k rows), and the share the dense formulation wastes."""
    per_row = 3 * 2 * cfg.dim * cfg.ffn_hidden * cfg.n_layers
    dense = cfg.n_experts * cfg.capacity(tokens) * per_row
    routed = tokens * cfg.experts_per_token * per_row
    return {"dense": dense, "routed": routed, "wasted_share": 1 - routed / dense,
            "dense_bound_ms": dense / PEAK_FLOPS["bfloat16"] * 1e3,
            "routed_bound_ms": routed / PEAK_FLOPS["bfloat16"] * 1e3}


def moe_cfg(moe, n_layers: int, dtype=None):
    """Mixtral-8x7B at full width, ``n_layers`` deep (in ``dtype``, else
    bf16), at the no-drop capacity serving requires (capacity_factor =
    n_experts)."""
    cfg = moe.mixtral_8x7b()
    return dataclasses.replace(cfg, n_layers=n_layers, capacity_factor=float(cfg.n_experts),
                               dtype=dtype or cfg.dtype)


def moe_plain_agreement(torch, ops, moe, params, cfg, prompt, tokens, dev) -> dict:
    """Phase 9(a'): the kernels' path against the plain path on the same
    tree: the expert products' plain versions (the parent's dispatch,
    torch.bmm and elementwise sequence) put in for the kernels in
    ``moe_mlp_block``, eager. The bf16 prefill logits' largest difference
    and the argmax agreement of their last position, and the share of the
    greedy tokens (``tokens``, the kernels' path) the plain path repeats,
    with its first divergence. Printed, not held to a bound: bf16 near-ties
    may flip a token and the rest follow; the kernels are held in phase 3
    and the path in fp32 against the CPU in phase 9(c)."""
    b, s = prompt.shape
    pos = torch.arange(s, device=dev).expand(b, s)
    with torch.no_grad():
        kern, _ = moe.routed_forward(params, prompt, cfg, moe.init_cache(cfg, b, s, device=dev),
                                     pos)
        saved = moe.moe_gate_up, moe.moe_down
        moe.moe_gate_up, moe.moe_down = ops.moe_gate_up_reference, ops.moe_down_reference
        try:
            plain, _ = moe.routed_forward(params, prompt, cfg,
                                          moe.init_cache(cfg, b, s, device=dev), pos)
            plain_toks = moe.greedy_generate(params, prompt, cfg, max_new_tokens=NEW_TOKENS,
                                             cuda_graph=False)
        finally:
            moe.moe_gate_up, moe.moe_down = saved
    if not torch.isfinite(kern).all() or not torch.isfinite(plain).all():
        fail("phase 9: non-finite prefill logits on the kernels' or the plain path")
    same = (plain_toks == tokens).all(dim=0)
    differs = (~same).nonzero()
    out = {"prefill_logits_max_abs_diff": float((kern - plain).abs().max()),
           "prefill_logits_max_abs": float(plain.abs().max()),
           "prefill_last_argmax_agree": float((kern[:, -1].argmax(-1) == plain[:, -1].argmax(-1))
                                              .float().mean()),
           "greedy_tokens_identical_share": float((plain_toks == tokens).float().mean()),
           "greedy_first_divergent_step": int(differs[0]) if len(differs) else None}
    print("moe kernels' path vs plain path (bf16, same tree): " + json.dumps(out), flush=True)
    return out


def moe_greedy(torch, ops, moe, params, cfg, prompt, dev, card: str) -> dict:
    """Phase 9(a): greedy_generate over the Mixtral tree, eager, graphed,
    graphed, eager: identical tokens and exact launch counts each run, then
    prefill ms, step ms and busy share (request_split), the step against
    its bound (every weight but the embedding read once), the parts of a
    prefill and a step (moe_step_profile), and the agreement with the plain
    path (moe_plain_agreement)."""
    expected = {**greedy_launches(cfg.n_layers), **moe_launches(1 + NEW_TOKENS, cfg.n_layers)}
    runs, outputs = [], []
    for graph in GREEDY_RUNS:
        zero_counts(ops)
        t0 = time.perf_counter()
        toks = moe.greedy_generate(params, prompt, cfg, max_new_tokens=NEW_TOKENS,
                                   cuda_graph=graph)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**greedy_counts(ops), **moe_counts(ops)}
        print(f"moe greedy (cuda_graph={graph}) launches {launches}, expected {expected}",
              flush=True)
        if launches != expected:
            fail("phase 9: the MoE greedy path did not run every route, expert product, combine, "
                 "norm, attention and pick through the kernels (and no dispatch)")
        if (tuple(toks.shape) != (BATCH, NEW_TOKENS) or toks.dtype != torch.int32
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
            fail(f"phase 9: bad generated tokens: {toks.dtype} {tuple(toks.shape)}")
        outputs.append(toks)
        runs.append({"cuda_graph": graph, "request_s": seconds,
                     "tok_per_s": BATCH * NEW_TOKENS / seconds, "launches": launches})
    if any(not torch.equal(o, outputs[0]) for o in outputs):
        fail("phase 9: the CUDA-graphed MoE decode changed the tokens")
    from bobrapet_tpu_torch.models import tree_bytes

    splits = [request_split(torch, moe.llama, params, prompt, cfg, dev, cuda_graph=graph,
                            forward_fn=moe.routed_forward)
              for graph in GREEDY_RUNS]
    weight_bytes = tree_bytes(params)
    embed = params["embed"]["weight"]
    read_bytes = weight_bytes - embed.numel() * embed.element_size()
    return {
        "order": "eager, graph, graph, eager", "identical_tokens": True, "runs": runs,
        "launches": {k: sum(r["launches"][k] for r in runs) for k in expected},
        "splits": splits, "decode_step_bound_ms": read_bytes / HBM_BYTES_PER_S * 1e3,
        "decode_bytes": read_bytes,
        "prefill_expert_flops": moe_expert_flops(BATCH * PROMPT, cfg),
        "decode_expert_flops": moe_expert_flops(BATCH, cfg),
        "prefill_expert_flops_run": moe_live_expert_flops(BATCH * PROMPT, cfg),
        "decode_expert_flops_run": moe_live_expert_flops(BATCH, cfg),
        "parts": moe_step_profile(torch, moe, params, prompt, cfg, dev),
        "plain_agreement": moe_plain_agreement(torch, ops, moe, params, cfg, prompt, outputs[0],
                                               dev),
        "card": card,
    }


def moe_serve_drain(torch, ops, eng, prompts, temps=None) -> dict:
    """:func:`serve_drain` on the MoE engine, and the MoE kernels' exact
    launches: one each a layer a forward (prefills + decode steps)."""
    d = serve_drain(torch, ops, eng, prompts, temps)
    got, want = moe_counts(ops), moe_launches(d["prefills"] + d["ticks"], eng.cfg.n_layers)
    if got != want:
        fail(f"phase 9: the MoE engine's route, expert products and combine ran {got}, expected "
             f"{want}")
    d["launches"].update(got)
    return d


def moe_serving(torch, ops, serving, params, cfg, seed: int, dev, card: str) -> dict:
    """Phase 9(b): config 6's traffic through the MoE engine, the classic
    tick (H 1, depth 1) and the constructor's defaults (H 8, depth 2), a
    warm drain each, then drains in turns (MOE_SERVE_ORDER), greedy and
    then sampled (SERVE_TEMPS): the same tokens in every greedy mode and
    the same streams in every sampled one, exact launch counts; tok/s,
    TTFT and TPOT p50, peak memory and a profiled drain's busy share."""
    warm = serve_prompts(torch, cfg, seed + 10, dev)
    prompts = serve_prompts(torch, cfg, seed + 11, dev)
    torch.cuda.reset_peak_memory_stats()
    out = {"paging": SERVE_PAGING, "card": card, "order": ", ".join(MOE_SERVE_ORDER)}
    greedy = None
    for label, temps in (("greedy", None), ("sampled", SERVE_TEMPS)):
        engines = {}
        for mode, kw in MOE_SERVE_MODES.items():
            eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**SERVE_PAGING), **kw)
            for i, p in enumerate(warm):
                eng.submit(p, serve_budget(i))
            eng.run()
            engines[mode] = eng
        drains = {mode: [] for mode in engines}
        for mode in MOE_SERVE_ORDER:
            drains[mode].append(moe_serve_drain(torch, ops, engines[mode], prompts, temps))
        for n in range(2):
            streams = [drains[mode][n]["outputs"] for mode in engines]
            if any(s != streams[0] for s in streams):
                fail(f"phase 9: the MoE engine's {label} drain {n + 1} differs between the modes")
        if greedy is None:
            greedy = drains["classic"][0]["outputs"]
        elif all(a == b for a, b in zip(drains["classic"][0]["outputs"], greedy)):
            fail("phase 9: no sampled request drew a token other than the greedy one")
        for mode, eng in engines.items():
            runs = drains[mode]
            for d in runs:
                d.pop("outputs")
            busy = drain_device_ms(torch, eng, prompts, temps)
            out[f"{label}_{mode}"] = {
                "decode_horizon": eng.decode_horizon, "dispatch_depth": eng.dispatch_depth,
                "drains": runs,
                "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
                "tok_per_s": [d["tok_per_s"] for d in runs],
                "ttft_ms_p50": [d["ttft_ms_p50"] for d in runs],
                "tpot_ms_p50": [d["tpot_ms_p50"] for d in runs],
                "peak_memory_gb": max(d["peak_memory_gb"] for d in runs),
                "busy_share": busy / 1e3 / p50(d["drain_s"] for d in runs) if busy else None}
        del engines
    out["identical_tokens"] = out["identical_streams"] = True
    print("  moe serving modes: " + json.dumps(
        {k: {m: v[m] for m in ("tok_per_s", "ttft_ms_p50", "tpot_ms_p50", "busy_share",
                               "peak_memory_gb")}
         for k, v in out.items() if isinstance(v, dict) and "drains" in v}), flush=True)
    return out


def moe_cross_check(torch, ops, moe, serving, seed: int, dev) -> dict:
    """Phase 9(c): one layer at Mixtral's widths in fp32 (TF32 off), the same
    seeded weights on the card (kernels) and on the CPU (plain versions):
    prefill logits within MOE_CROSS_TOL, and the engine's tokens identical
    at H 1 and H 8 with prefix caching and chunks of 16 (a shared 32-token
    system prompt, two waves), one route, dispatch and combine a layer a
    forward on the card."""
    cfg = moe_cfg(moe, 1, torch.float32)
    params = moe.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 30), dev)
    params_cpu = tree_to(params, "cpu")
    gen = torch.Generator().manual_seed(seed + 31)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    pos = torch.arange(16).expand(2, 16)
    t0 = time.perf_counter()
    with torch.no_grad():
        card, _, _ = moe.forward(params, toks.to(dev), cfg,
                                 cache=moe.init_cache(cfg, 2, 16, device=dev),
                                 positions=pos.to(dev))
        cpu, _, _ = moe.forward(params_cpu, toks, cfg,
                                cache=moe.init_cache(cfg, 2, 16, device="cpu"), positions=pos)
    err = float((card.cpu() - cpu).abs().max())
    if not torch.isfinite(card).all() or err > MOE_CROSS_TOL:
        fail(f"phase 9: the fp32 MoE prefill logits differ card vs CPU by {err}")
    system = torch.randint(0, cfg.vocab_size, (32,), generator=gen).tolist()
    waves = [[system + torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
              for n in tail] for tail in CROSS_TAILS]
    pcfg = serving.PagedConfig(**CROSS_PREFIX_PAGING)
    outs, counts = {}, {}
    for horizon in (1, 8):
        for side, tree in (("card", params), ("cpu", params_cpu)):
            eng = serving.ServingEngine(tree, cfg, pcfg, decode_horizon=horizon,
                                        dispatch_depth=1)
            zero_counts(ops)
            for wave in waves:
                for p in wave:
                    eng.submit(p, MOE_CROSS_BUDGET[horizon])
                eng.run()
            outs[side, horizon] = [r.output for r in sorted(eng.finished, key=lambda r: r.rid)]
            if side == "card":
                pc = eng.phase_counts
                got = moe_counts(ops)
                counts[f"h{horizon}"] = {**read_counts(ops),
                                         "pick_tokens": ops.pick_tokens_cuda.launches, **got}
                if got != moe_launches(pc["prefills"] + pc["device_steps"], cfg.n_layers):
                    fail("phase 9: the fp32 MoE engine skipped the MoE kernels")
                if not pc["chunks"] or not eng.blocks.hit_tokens:
                    fail("phase 9: the fp32 MoE engine ran no chunk or hit no cached prefix")
    result = {"layers": 1, "dtype": "float32", "logits_max_abs_err": err,
              "tolerance": MOE_CROSS_TOL, "requests": sum(len(w) for w in waves),
              "paging": CROSS_PREFIX_PAGING, "new_tokens": MOE_CROSS_BUDGET,
              "identical_tokens": all(outs["card", h] == outs["cpu", h] for h in (1, 8)),
              "card_launches": counts, "seconds": time.perf_counter() - t0}
    print("moe engine (1 layer, Mixtral widths, fp32, card vs CPU): " + json.dumps(result),
          flush=True)
    if not result["identical_tokens"]:
        fail("phase 9: the fp32 MoE engine on the card and on the CPU gave different tokens")
    return result


def moe_phase(torch, ops, moe, serving, seed: int, dev, card: str) -> dict:
    """Phase 9: Mixtral-8x7B at full width, MOE_LAYERS of its 32 layers,
    bf16, weights from the seed made on the card: (a) greedy, (b) serving,
    then, with that tree freed, (c) card against CPU."""
    from bobrapet_tpu_torch.models import tree_bytes

    # the earlier phases' graphed steps hold their trees in reference
    # cycles (a step and its owner's bound method): collect them first
    gc.collect()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    cfg = moe_cfg(moe, MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 20), dev)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(params)
    print(f"mixtral_8x7b: {cfg.n_layers} of 32 layers, dim {cfg.dim}, {cfg.n_experts} experts, "
          f"{weight_bytes / 1e9:.2f} GB of bf16 weights, made in {made_s:.1f} s "
          f"({before_gb:.2f} GB held before)", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed + 21))
    out = {"model": "mixtral_8x7b", "layers": cfg.n_layers, "dtype": "bfloat16",
           "capacity_factor": cfg.capacity_factor, "weight_bytes": weight_bytes,
           "made_s": made_s, "memory_before_gb": before_gb}
    out["greedy"] = moe_greedy(torch, ops, moe, params, cfg, prompt, dev, card)
    out["greedy_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("moe greedy: " + json.dumps(out["greedy"]), flush=True)
    out["serving"] = moe_serving(torch, ops, serving, params, cfg, seed, dev, card)
    del params
    torch.cuda.empty_cache()
    out["cross"] = moe_cross_check(torch, ops, moe, serving, seed, dev)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


# ---------------------------------------------------------------------------
# phase 10: the serving engram
# ---------------------------------------------------------------------------


class TimedStore:
    """A blob store that times and counts its writes (the spill tier)."""

    def __init__(self, store):
        self.store = store
        self.puts, self.put_bytes, self.put_s = 0, 0, 0.0

    def put(self, key, data):
        t0 = time.perf_counter()
        self.store.put(key, data)
        self.put_s += time.perf_counter() - t0
        self.puts += 1
        self.put_bytes += len(data)

    def __getattr__(self, name):
        return getattr(self.store, name)


class EngramCtx:
    """What the engram reads of a step's context: its config, the run's
    blob store, the downstream producers (one collector) and the input
    stream (the wire JSON of ``messages``, then EOS). ``engine`` is the
    engine serve() built, taken when it opens the input stream, and
    ``built_at`` that moment (the restore and the build end there)."""

    def __init__(self, engram, config, store, messages=()):
        self.engram = engram
        self.config = config
        self.storage = types.SimpleNamespace(store=store)
        self.sent, self.closed, self.engine, self.built_at = [], 0, None, None
        self.messages = [json.dumps(m) for m in messages]
        self.known = set()

    def open_output_streams(self):
        ctx = self

        class Collector:
            def send(self, payload, **kw):
                ctx.sent.append(payload)

            def close(self):
                ctx.closed += 1

        self.known = set(self.engram._LIVE_ENGINES)
        return [Collector()]

    def open_input_stream(self, hub):
        if hub != self.config["hub"]:
            fail(f"phase 10: serve opened hub {hub!r}")
        fresh = [e for e in self.engram._LIVE_ENGINES if e not in self.known]
        self.engine = fresh[0] if len(fresh) == 1 else None
        self.built_at = time.perf_counter()
        return (json.loads(m) for m in self.messages)


def tree_equal_bits(torch, a, b) -> bool:
    """Two trees of the same structure hold the same bits in every leaf."""
    from bobrapet_tpu_torch.tree import flatten_with_path

    la, lb = flatten_with_path(a), flatten_with_path(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y):
            return False
    return True


def engine_counts(ops, engines, what: str) -> dict:
    """The kernels' counts of a run over ``engines`` (counts set to 0 just
    before), which must be exact against their phase counts: 2L + 1 norms a
    forward, a flash launch a layer a prefill, the paged kernel a layer a
    decode step, a pick a committed token."""
    got = read_counts(ops)
    pcs = [e.phase_counts for e in engines]
    n_layers = engines[0].cfg.n_layers
    prefills = sum(pc["prefills"] for pc in pcs)
    steps = sum(pc["device_steps"] for pc in pcs)
    want = {**norm_launches(prefills + steps, n_layers), "flash_attention": prefills * n_layers,
            "cached_attention": 0, "paged_attention": steps * n_layers}
    print(f"  {what}: launches {got}, expected {want}", flush=True)
    if got != want:
        fail(f"phase 10: {what} did not run every norm and attention through the kernels")
    picks = sum(pick_launches(pc, 4) for pc in pcs)
    if ops.pick_tokens_cuda.launches != picks:
        fail(f"phase 10: {what}: the pick ran {ops.pick_tokens_cuda.launches} times, "
             f"expected {picks}")
    return {**got, "pick_tokens": picks}


def disagg_traffic(torch, cfg, seed: int, dev) -> list:
    """(prompt, budget) of the disaggregated legs: block-aligned prompts."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randint(0, cfg.vocab_size, (disagg_prompt_len(i),), generator=gen,
                           device=dev).tolist(), serve_budget(i))
            for i in range(SERVE_REQUESTS)]


def latency_summary(reqs, drain_s: float) -> dict:
    tokens = sum(len(r.output) for r in reqs)
    out = {"drain_s": drain_s, "new_tokens": tokens, "tok_per_s": tokens / drain_s,
           "ttft_ms_p50": p50(r.ttft_seconds for r in reqs) * 1e3,
           "tpot_ms_p50": p50(r.tpot_seconds for r in reqs) * 1e3}
    handoffs = [r.kv_handoff_s for r in reqs if r.kv_handoff_s is not None]
    if handoffs:
        out["kv_handoff_ms_p50"] = pctl(handoffs, 0.5) * 1e3
        out["kv_handoff_ms_p95"] = pctl(handoffs, 0.95) * 1e3
    return out


def unified_drain(torch, eng, traffic, rids, temps) -> tuple:
    """The unified engram engine serves ``traffic`` under the router's rids
    (the pick is keyed by (rid, token index)); returns (outputs, summary)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [eng.submit(p, b, temperature=temps[i % len(temps)], rid=rid)
           for i, ((p, b), rid) in enumerate(zip(traffic, rids))]
    done = eng.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    by_rid = {r.rid: r for r in done[-len(traffic):]}
    reqs = [by_rid[r] for r in got]
    return [r.output for r in reqs], latency_summary(reqs, drain_s)


def router_drain(torch, ops, router, pf, dec, traffic, temps, what: str,
                 aligned: bool = True) -> tuple:
    """One measured drain through the router: counts set to 0 just before;
    the prefill engine only prefills. Over block-aligned prompts the decode
    engine only decodes (every handoff adopts all its prompt blocks); over
    other prompts it adopts the full blocks and prefills each request's
    suffix once, with flash attention at an offset over the adopted
    blocks."""
    for e in (pf, dec):
        e.reset_phase_stats()
    hits0 = dec.blocks.shared_hits
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    rids = [router.submit(p, b, temperature=temps[i % len(temps)])
            for i, (p, b) in enumerate(traffic)]
    router.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    counts = engine_counts(ops, [pf, dec], what)
    if aligned and (dec.phase_counts["prefills"] or dec.phase_seconds["prefill"]):
        fail(f"phase 10: {what}: the decode engine ran a prefill dispatch")
    if not aligned and dec.phase_counts["prefills"] != len(traffic):
        fail(f"phase 10: {what}: the decode engine ran {dec.phase_counts['prefills']} "
             f"prefills, expected one a request ({len(traffic)})")
    if pf.phase_counts["device_steps"]:
        fail(f"phase 10: {what}: the prefill engine decoded")
    by_rid = {r.rid: r for r in router.finished}
    reqs = [by_rid.get(r) for r in rids]
    for req, (p, b) in zip(reqs, traffic):
        if req is None or len(req.output) != b or req.kv_handoff_s is None:
            fail(f"phase 10: {what}: a request did not end handed off with its {b} tokens")
    hits = dec.blocks.shared_hits - hits0
    if hits != sum(len(p) // 16 for p, _ in traffic):
        fail(f"phase 10: {what}: the decode engine adopted {hits} blocks, expected every "
             f"full prompt block")
    return rids, [r.output for r in reqs], {**latency_summary(reqs, drain_s),
                                             "registry_hits": hits,
                                             "decode_prefills": dec.phase_counts["prefills"],
                                             "launches": counts}


def replay_router(torch, serving, params, cfg, pcfg, traffic, temps, rids) -> list:
    """The same handoffs again through a fresh prefill and decode engine at
    a horizon of 1 and depth 1 (no pipeline: every tick waits for the card)
    on a fresh registry in memory, under the rids ``rids``: the
    disaggregated streams as they must come without the dispatch pipeline
    (a decode step's tokens do not depend on H or depth: phase 5)."""
    reg = serving.SharedPrefixRegistry()
    engines = {role: serving.ServingEngine(params, cfg, pcfg, prefix_shared=reg, role=role,
                                           decode_horizon=1, dispatch_depth=1)
               for role in ("prefill", "decode")}
    for e in engines.values():
        e._next_rid = rids[0]
    router = serving.ServingRouter(engines, registry=reg)
    got = [router.submit(p, b, temperature=temps[i % len(temps)])
           for i, (p, b) in enumerate(traffic)]
    if got != rids:
        fail("phase 10: the replay router minted other rids")
    router.run()
    by_rid = {r.rid: r.output for r in router.finished}
    return [by_rid.get(r) for r in rids]


def handoff_tie_check(torch, llama, params, cfg, prompt, uni, dis, block: int, cap: int,
                      dev) -> "dict | None":
    """Where a greedy request's handed-off tokens ``dis`` first leave the
    unified engine's ``uni`` (position j >= 1: both first tokens come from
    the same prefill), recompute token j's fp32 logits both ways through
    ``llama.forward`` over a contiguous cache: unified, a prefill of the
    prompt then one-token forwards; handed off, the same prefill, then the
    decode engine's one forward over the prompt's partial block and the
    first token from the last block boundary, then one-token forwards. A
    divergence that rounding explains has ``margin`` (the unified logit of
    its token less that of the handed-off one) at most twice the largest
    logit difference between the two. None where the tokens agree."""
    j = next((k for k, (a, b) in enumerate(zip(uni, dis)) if a != b), None)
    if j is None:
        return None
    n, s = len(prompt), len(prompt) // block * block

    def forward(cache, toks, start):
        if not isinstance(cache[0]["cursor"], int):
            cache[0]["cursor"].fill_(start)
        pos = start + torch.arange(len(toks), device=dev)[None, :]
        logits, _ = llama.forward(params, torch.tensor([toks], device=dev), cfg, cache=cache,
                                  positions=pos)
        return logits[0, -1].float()

    def run(handoff: bool):
        cache = llama.init_cache(cfg, 1, cap, device=dev)
        last = forward(cache, list(prompt), 0)
        llama.device_cursor(cache)
        first = 1 if handoff else 0
        if handoff:
            last = forward(cache, list(prompt[s:]) + uni[:1], s)
        for i in range(first, j):
            last = forward(cache, uni[i:i + 1], n + i)
        return last

    with torch.no_grad():
        lu, ld = run(False), run(True)
    return {"position": j, "unified": uni[j], "handed_off": dis[j],
            "recomputed_argmax": [int(lu.argmax()), int(ld.argmax())],
            "margin": float(lu[uni[j]] - lu[dis[j]]),
            "max_abs_logit_err": float((lu - ld).abs().max())}


def engram_phase(torch, ops, serving, llama, cfg, seed: int, dev, card: str,
                 phase5_tokens: list) -> dict:
    """Phase 10: (a) save, (b) serve(ctx), restoring it, (c) the
    disaggregated router beside serve's engine, (d) resume from the disk
    spill."""
    import shutil

    from bobrapet_tpu_torch import storage
    from bobrapet_tpu_torch.models import tree_bytes
    from bobrapet_tpu_torch.sdk.checkpoint import save_checkpoint
    from bobrapet_tpu_torch.serving import engram

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ENGRAM_DIR, ignore_errors=True)
    store = storage.FileStore(f"{ENGRAM_DIR}/blobs")
    out = {"model": "llama3_8b", "dtype": "bfloat16", "config": ENGRAM_CONFIG, "card": card,
           "disk_free_gb": shutil.disk_usage(ENGRAM_DIR).free / 1e9}
    # (a) save; the engram restores it in (b)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    nbytes = tree_bytes(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(store, ENGRAM_PREFIX, {"params": params}, step=1)
    save_s = time.perf_counter() - t0
    launches = {}

    # (b) config 6's requests as wire JSON through serve(ctx), which
    # restores the tree (until it opens the input stream), then serves
    prompts = serve_prompts(torch, cfg, seed + 11, dev)
    msgs = [{"id": i, "prompt": p, "maxNewTokens": serve_budget(i)} for i, p in enumerate(prompts)]
    sctx = EngramCtx(engram, {**ENGRAM_CONFIG, "hub": ENGRAM_HUB}, store, msgs)
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    result = engram.serve(sctx, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    eng = sctx.engine
    if eng is None:
        fail("phase 10: serve built no engine of its own")
    restore_s = sctx.built_at - t0
    if not tree_equal_bits(torch, eng.params, params):
        fail("phase 10: the restored tree differs from the saved one")
    del params
    out["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "save_gb_per_s": nbytes / save_s / 1e9,
                         "restore_s": restore_s, "restore_gb_per_s": nbytes / restore_s / 1e9,
                         "bit_for_bit": True, "note": "restore_s: serve's build_engine, "
                         "which read files just written (warm page cache)"}
    print("  engram checkpoint: " + json.dumps(out["checkpoint"]), flush=True)
    launches["serve"] = engine_counts(ops, [eng], "serve(ctx)")
    got = {m.get("id"): m for m in sctx.sent}
    if result != {"served": SERVE_REQUESTS} or sctx.closed != 1 or len(got) != SERVE_REQUESTS:
        fail(f"phase 10: serve returned {result}, closed {sctx.closed}, sent {len(sctx.sent)}")
    for i, want in enumerate(phase5_tokens):
        m = got.get(i, {})
        if m.get("tokens") != want or m.get("preemptions") != 0 or "prefilled" in m:
            fail(f"phase 10: serve's completion {i} is not phase 5's tokens")
    out["serve"] = {"served": result["served"], "serve_s": serve_s,
                    "serve_after_build_s": serve_s - restore_s, "phase5_tokens": True}
    del sctx

    # (c) a prefill-role and a decode-role engine under the router
    tier = TimedStore(storage.SliceLocalSSDStore(f"{ENGRAM_DIR}/tier"))
    reg = serving.SharedPrefixRegistry()
    reg.attach_spill(tier)
    pcfg = eng.pcfg
    pf = serving.ServingEngine(eng.params, cfg, pcfg, prefix_shared=reg, role="prefill")
    dec = serving.ServingEngine(eng.params, cfg, pcfg, prefix_shared=reg, role="decode")
    if pf.blocks.scope != eng._sharing_scope():
        fail("phase 10: engines on the same tensors have different sharing scopes")
    router = serving.ServingRouter({"prefill": pf, "decode": dec}, registry=reg)
    warm = disagg_traffic(torch, cfg, seed + 30, dev)
    rids, _, _ = router_drain(torch, ops, router, pf, dec, warm, (0.0,), "the warm router drain")
    unified_drain(torch, eng, warm, rids, (0.0,))
    legs = {}
    for name, temps, tseed, aligned in DISAGG_LEGS:
        if aligned:
            traffic = disagg_traffic(torch, cfg, seed + tseed, dev)
        else:
            traffic = [(p, serve_budget(i))
                       for i, p in enumerate(serve_prompts(torch, cfg, seed + tseed, dev))]
        puts0, bytes0, s0 = tier.puts, tier.put_bytes, tier.put_s
        rids, outs, summary = router_drain(torch, ops, router, pf, dec, traffic, temps,
                                           f"the {name} router drain", aligned)
        ref, ref_summary = unified_drain(torch, eng, traffic, rids, temps)
        bad = [i for i, (a, b) in enumerate(zip(outs, ref)) if a != b]
        if aligned and bad:
            fail(f"phase 10: {name}: requests {bad} handed off differ from the unified engine")
        if not aligned:
            # the decode engine recomputes the partial block's K/V and picks
            # the second token from its prefill, where the unified engine
            # ran a one-shot prefill and a decode step: other kernels and
            # shapes, so bf16 rounding may flip a near-tie from there on
            # (as phase 7's cached against one-shot prefills). Held: both
            # first tokens; the streams to a replay without the pipeline,
            # bit for bit; every greedy divergence to a near-tie.
            if [o[:1] for o in outs] != [r[:1] for r in ref]:
                fail(f"phase 10: {name}: a first token differs from the unified engine's")
            replay = replay_router(torch, serving, eng.params, cfg, eng.pcfg, traffic, temps,
                                   rids)
            if replay != outs:
                fail(f"phase 10: {name}: requests "
                     f"{[i for i, (a, b) in enumerate(zip(outs, replay)) if a != b]} differ "
                     "from their replay at H 1, depth 1")
            ties = []
            for i in bad:
                if temps[i % len(temps)] == 0.0:
                    c = handoff_tie_check(torch, llama, eng.params, cfg, traffic[i][0], ref[i],
                                          outs[i], 16, eng.pcfg.capacity, dev)
                    ties.append({"request": i, **c})
            print(f"  {name}: handed off against unified: requests {bad} differ; greedy "
                  f"divergences {json.dumps(ties)}", flush=True)
            for c in ties:
                if c["margin"] > 2 * c["max_abs_logit_err"]:
                    fail(f"phase 10: {name}: at position {c['position']} of request "
                         f"{c['request']} the handed-off token trails the unified one by "
                         f"{c['margin']}, beyond twice the logit error "
                         f"{c['max_abs_logit_err']} between the two paths")
            summary.update(
                identical_token_share=sum(x == y for a, b in zip(outs, ref) for x, y in zip(a, b))
                / sum(len(r) for r in ref), requests_differing=bad, greedy_divergences=ties,
                replay_h1_depth1_identical=True)
        puts = tier.puts - puts0
        summary.update(spill_writes=puts, bytes_spilled=tier.put_bytes - bytes0,
                       ms_per_spill_write=(tier.put_s - s0) / max(puts, 1) * 1e3)
        launches[f"disagg_{name}"] = summary.pop("launches")
        legs[name] = {"disaggregated": summary, "unified": ref_summary,
                      "temperatures": list(temps), "block_aligned": aligned,
                      "identical_to_unified": not bad,
                      "traffic": traffic, "outputs": outs, "rids": rids}
    greedy = legs["greedy"]
    del router, pf, dec, reg
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a fresh registry on the same spill directory, a fresh decode engine
    reg2 = serving.SharedPrefixRegistry()
    reg2.attach_spill(storage.SliceLocalSSDStore(f"{ENGRAM_DIR}/tier"))
    dec2 = serving.ServingEngine(eng.params, cfg, pcfg, prefix_shared=reg2, role="decode")
    torch.cuda.synchronize()
    zero_counts(ops)
    t0 = time.perf_counter()
    for (p, b), rid, toks in zip(greedy["traffic"], greedy["rids"], greedy["outputs"]):
        dec2.submit(p, b, rid=rid, output=toks[:1])
    done = {r.rid: r.output for r in dec2.run()}
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches["resume"] = engine_counts(ops, [dec2], "the resume from disk")
    if dec2.phase_counts["prefills"]:
        fail("phase 10: the resumed decode engine ran a prefill forward")
    if [done.get(r) for r in greedy["rids"]] != greedy["outputs"]:
        fail("phase 10: the engine resumed from disk gave other tokens than (c)'s")
    want_blocks = sum(len(p) // 16 for p, _ in greedy["traffic"])
    if dec2.blocks.shared_hits != want_blocks:
        fail(f"phase 10: the resumed engine adopted {dec2.blocks.shared_hits} blocks, "
             f"expected {want_blocks}")
    out["resume"] = {"resume_s": resume_s, "blocks_adopted_from_disk": dec2.blocks.shared_hits,
                     "greedy_tokens": True}
    for leg in legs.values():
        for key in ("traffic", "outputs", "rids"):
            leg.pop(key)
    out["disaggregated"] = legs
    out["launches"] = launches
    del dec2, reg2, eng
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ENGRAM_DIR, ignore_errors=True)
    return out


def attention_bwd_flops(b: int, sq: int, sk: int, hq: int, d: int, causal: bool = True,
                        q_offset: int = 0) -> int:
    """The backward's products over the unmasked pairs: S = q k^T again,
    dP = do v^T, dv = P^T do, dk = dS^T q, dq = dS k; 2 flops a
    multiply-add, 5 products against the forward's 2 (2.5x)."""
    return 10 * d * attention_pairs(sq, sk, causal, q_offset) * b * hq


def attention_bwd_bytes(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, es: int) -> int:
    """q, k, v, o, do read once and dq, dk, dv written once, and the fp32
    log-sum-exp of every row read once."""
    return 4 * (b * sq * hq * d + b * sk * hkv * d) * es + 4 * b * hq * sq


def rmsnorm_bwd_bytes(rows: int, d: int, es: int, add: bool) -> int:
    """dy and x read once (and ds in the add mode), dx written once; the
    weight read and its gradient written once."""
    return (4 if add else 3) * rows * d * es + 2 * d * es


def rmsnorm_bwd_flops(rows: int, d: int, add: bool) -> int:
    """About 10 an element: two products in x's type, the two row sums,
    dx's three terms, the weight gradient's product and sum (and the add)."""
    return (11 if add else 10) * rows * d


def train_nonembed_params(cfg) -> int:
    """Every parameter but the embedding table (the LM head is a product)."""
    return cfg.param_count - cfg.vocab_size * cfg.dim


def train_step_flops(cfg, batch: int, seq: int) -> dict:
    """A train step's model FLOPs: 6 N T for the weights' products (N the
    non-embedding parameters, T the tokens; forward 2, backward 4) and the
    causal attention's 12 d pairs a head and layer (forward 4, backward 8;
    the backward's recomputed S not counted, as model FLOPs do not)."""
    tokens = batch * seq
    dense = 6 * train_nonembed_params(cfg) * tokens
    attn = 12 * cfg.head_dim * attention_pairs(seq, seq, True, 0) * batch * cfg.n_heads \
        * cfg.n_layers
    return {"tokens": tokens, "nonembed_params": train_nonembed_params(cfg), "dense": dense,
            "attention": attn, "total": dense + attn}


def train_mfu(flops: float, step_s: float) -> float:
    """Model FLOPs utilization against the H100's dense bf16 peak."""
    return flops / step_s / PEAK_FLOPS["bfloat16"]


def train_launches(n_layers: int, remat: bool = False) -> dict:
    """The kernels of one train step: a log-sum-exp forward and a backward
    of attention a layer, 2L + 1 norm forwards (2L in the add mode) and as
    many backwards; remat runs every forward again inside the backward;
    nothing of the serving entries."""
    fwd = 2 if remat else 1
    return {"rmsnorm": fwd * (2 * n_layers + 1), "add_rmsnorm": fwd * 2 * n_layers,
            "flash_attention": 0, "cached_attention": 0, "paged_attention": 0,
            "flash_attention_lse": fwd * n_layers, "flash_attention_backward": n_layers,
            "rmsnorm_backward": 2 * n_layers + 1, "add_rmsnorm_backward": 2 * n_layers}


def zero_train_counts(ops) -> None:
    zero_counts(ops)
    for fn in (ops.flash_attention_lse_cuda, ops.flash_attention_backward_cuda,
               ops.rmsnorm_backward_cuda, ops.add_rmsnorm_backward_cuda):
        fn.launches = 0


def read_train_counts(ops) -> dict:
    return {**read_counts(ops),
            "flash_attention_lse": ops.flash_attention_lse_cuda.launches,
            "flash_attention_backward": ops.flash_attention_backward_cuda.launches,
            "rmsnorm_backward": ops.rmsnorm_backward_cuda.launches,
            "add_rmsnorm_backward": ops.add_rmsnorm_backward_cuda.launches}


def backward_launch_ms(torch, ops, call, flush) -> dict:
    """Device ms of each of the bf16 backward's launches (D, dk/dv, dq),
    each run alone (ops.flash_backward_launches) and timed as time_ms
    times a call; all three are restored. (Back-to-back profiler runs
    late in a whole run saw a share of these kernels, then none.)"""
    before = ops.flash_backward_launches()
    out = {}
    try:
        for name, bit in BWD_LAUNCHES:
            ops.flash_backward_launches(bit)
            out[name] = time_ms(torch, call, flush)
    finally:
        ops.flash_backward_launches(before)
    return out


def backward_parts(torch, ops, flush, name, args, kw, want) -> dict:
    """The bf16 backward with P and dS in one bf16 part and in two (hi +
    lo): each form's largest error against the plain version ``want``,
    whether it holds TRAIN_TOL, its ms and its launches' ms. The form in
    force before is restored."""
    atol, rtol = TRAIN_TOL[("attention_bwd", "bfloat16")]
    before = ops.flash_backward_parts()
    out = {}
    try:
        for parts in (1, 2):
            ops.flash_backward_parts(parts)
            call = lambda: ops.flash_attention_backward_cuda(*args, **kw)  # noqa: E731
            got = call()
            errs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
            within = all(bool(torch.isfinite(g).all())
                         and float((e - rtol * w.float().abs()).max()) <= atol
                         for g, e, w in zip(got, errs, want))
            out[parts] = {"max_abs_err": max(float(e.max()) for e in errs),
                          "within_tolerance": within, "ms": time_ms(torch, call, flush),
                          "launch_ms": backward_launch_ms(torch, ops, call, flush)}
    finally:
        ops.flash_backward_parts(before)
    for parts, r in out.items():
        print(f"  attention backward {name}, P and dS in {parts} bf16 part(s): max_abs_err "
              f"{r['max_abs_err']:.3e} (within the tolerance: {r['within_tolerance']}), "
              f"{r['ms']:.5f} ms (D {r['launch_ms']['delta']:.5f}, dk/dv "
              f"{r['launch_ms']['dkdv']:.5f}, dq {r['launch_ms']['dq']:.5f})", flush=True)
    return out


def sdpa_backward_ms(torch, F, flush, q, k, v, do, causal: bool, q_offset: int) -> float:
    """SDPA's backward (autograd, enable_gqa) on the same inputs, a
    yardstick: the mask as the port's (keys past q_offset + i hidden from
    query i) through is_causal where Sq = Sk and no offset, else a boolean
    mask."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal and not (sq == sk and q_offset == 0):
        mask = (q_offset + torch.arange(sq, device=q.device))[:, None] >= torch.arange(
            sk, device=q.device)[None, :]
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None, enable_gqa=True)
    dot = do.transpose(1, 2)
    return time_ms(torch, lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
                   flush)


def lse_forward_check(torch, ops, name, q, k, v, dtype, kw) -> tuple:
    """The log-sum-exp forward on q, k, v (causal and q_offset in ``kw``)
    against its plain version: the output within the forward's tolerance,
    lse within TRAIN_LSE_TOL, and the same bits from a second run.
    Returns ``(o, lse, output error, lse error)``."""
    out, lse = ops.flash_attention_lse_cuda(q, k, v, **kw)
    ref_o, ref_lse = ops.flash_attention_lse_reference(q, k, v, **kw)
    fwd_err = compare(torch, "attention", f"attention lse {name}", out, ref_o, dtype)
    lse_err = float((lse - ref_lse).abs().max())
    print(f"  attention lse {name}: lse max_abs_err {lse_err:.3e} (tolerance {TRAIN_LSE_TOL})",
          flush=True)
    if lse_err > TRAIN_LSE_TOL:
        fail(f"attention lse {name}: the log-sum-exp disagrees with its plain version")
    again = ops.flash_attention_lse_cuda(q, k, v, **kw)
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        fail(f"attention lse {name}: two runs gave different bits")
    return out, lse, fwd_err, lse_err


def train_backward_case(torch, F, ops, flush, name, b, sq, sk, hq, hkv, d, causal, q_offset,
                        gen, dev) -> dict:
    """The bf16 attention backward at q [b, sq, hq, d], k/v [b, sk, hkv, d]
    with the mask and offset given, fed the log-sum-exp forward's output
    (held to its plain version, twice the same bits), against its plain
    version, twice the same bits; timed, its launches apart, in one part
    and in two."""
    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, k, v, do = randn(b, sq, hq, d), randn(b, sk, hkv, d), randn(b, sk, hkv, d), \
        randn(b, sq, hq, d)
    kw = {"causal": causal, "q_offset": q_offset}
    out, lse, fwd_err, lse_err = lse_forward_check(torch, ops, name, q, k, v, "bfloat16", kw)
    args = (q, k, v, out, do, lse)
    got = ops.flash_attention_backward_cuda(*args, **kw)
    want = ops.flash_attention_backward_reference(*args, **kw)
    err = max(compare(torch, "attention_bwd", f"attention backward {name} d{n}", g, w, "bfloat16")
              for n, g, w in zip("qkv", got, want))
    again = ops.flash_attention_backward_cuda(*args, **kw)
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        fail(f"attention backward {name}: two runs gave different bits")
    b_ms, b_by = bound(attention_bwd_bytes(b, sq, sk, hq, hkv, d, 2),
                       attention_bwd_flops(b, sq, sk, hq, d, causal, q_offset), "bfloat16")
    kernel = lambda: ops.flash_attention_backward_cuda(*args, **kw)  # noqa: E731
    with torch.no_grad():
        case = {"case": f"attention backward {name}", "kernel": "flash_attention_backward",
                "q": [b, sq, hq, d], "kv": [b, sk, hkv, d], "causal": causal,
                "q_offset": q_offset, "dtype": "bfloat16", "max_abs_err": err,
                "same_bits_twice": True, "forward_max_abs_err": fwd_err,
                "forward_lse_max_abs_err": lse_err, "ms": time_ms(torch, kernel, flush),
                "plain_ms": time_ms(torch, lambda: ops.flash_attention_backward_reference(
                    *args, **kw), flush),
                "launch_ms": backward_launch_ms(torch, ops, kernel, flush),
                "parts": backward_parts(torch, ops, flush, name, args, kw, want)}
    case.update({"library_ms": sdpa_backward_ms(torch, F, flush, q, k, v, do, causal, q_offset),
                 "library": "scaled_dot_product_attention (enable_gqa; the same mask) backward",
                 "bound_ms": b_ms, "bound_by": b_by})
    return case


def attention_build_report() -> dict:
    """Every instance of the bf16 training attention kernels, by kernel:
    the log-sum-exp forward (flash_fwd_lse_kernel) and the backward's
    (flash_bwd_*): registers, static shared memory and spills from the
    build log, and its SASS's wgmma (HGMMA), TMA (UTMALDG) and mbarrier
    (SYNCS) instructions where the toolkit's cuobjdump is at hand. Fails
    on a spill, and on an instance whose SASS shows no HGMMA or no UTMALDG."""
    from bobrapet_tpu_torch.kernels import build as kbuild

    marks = {"flash_attention_lse": "flash_fwd_lse_kernel",
             "flash_attention_backward": "flash_bwd_"}
    insts = [dict(i) for i in ptxas_instances(kbuild.build_log)
             if any(m in i["name"] for m in marks.values())]
    sass = {}
    tool = "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(kbuild.build())], capture_output=True,
                              text=True, timeout=300).stdout
    except (OSError, subprocess.SubprocessError):
        text = ""
    for chunk in text.split("Function : ")[1:]:
        sass[chunk.split("\n", 1)[0].strip()] = {
            op: len(re.findall(rf"\b{op}\b", chunk)) for op in ("HGMMA", "UTMALDG", "SYNCS")}
    out = {kernel: [] for kernel in marks}
    for inst, name in zip(insts, demangle([i["name"] for i in insts])):
        inst["sass"] = sass.get(inst["name"])
        kernel = next(k for k, m in marks.items() if m in inst["name"])
        inst["name"] = name
        out[kernel].append(inst)
        print(f"  {kernel} instance {name.split('(')[0]}: {inst['registers']} registers, "
              f"{inst['smem_bytes']} bytes static smem, spill stores {inst['spill_stores']} B, "
              f"spill loads {inst['spill_loads']} B, SASS {inst['sass']}", flush=True)
        if inst["spill_stores"] or inst["spill_loads"]:
            fail(f"{name} spills registers")
        if inst["sass"] is not None and not (inst["sass"]["HGMMA"] and inst["sass"]["UTMALDG"]):
            fail(f"{name}: no wgmma or no TMA load in its SASS")
    for kernel, found in out.items():
        if not found:
            fail(f"the build log shows no instance of the bf16 {kernel} kernel")
    return out


def train_attention_case(torch, F, ops, flush, name, b, s, hq, hkv, dtype, gen, dev) -> list:
    """The log-sum-exp forward and the backward at q [b, s, hq, 128], k/v
    [b, s, hkv, 128], causal, each against its plain version on the same
    inputs; timed beside SDPA's forward and backward (a yardstick only)."""
    d = 128
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, k, v, do = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d), randn(b, s, hq, d)
    out, lse, fwd_err, lse_err = lse_forward_check(torch, ops, name, q, k, v, dtype, {})
    got = ops.flash_attention_backward_cuda(q, k, v, out, do, lse)
    want = ops.flash_attention_backward_reference(q, k, v, out, do, lse)
    bwd_err = max(compare(torch, "attention_bwd", f"attention backward {name} d{n}", g, w, dtype)
                  for n, g, w in zip("qkv", got, want))
    again = ops.flash_attention_backward_cuda(q, k, v, out, do, lse)
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        fail(f"attention backward {name}: two runs gave different bits")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    es = q.element_size()
    f_ms, f_by = bound((2 * q.numel() + k.numel() + v.numel()) * es + 4 * b * hq * s,
                       4 * d * attention_pairs(s, s, True, 0) * b * hq, dtype)
    b_ms, b_by = bound(attention_bwd_bytes(b, s, s, hq, hkv, d, es),
                       attention_bwd_flops(b, s, s, hq, d), dtype)
    shape = {"q": [b, s, hq, d], "kv": [b, s, hkv, d], "dtype": dtype}
    with torch.no_grad():
        fwd = {"case": f"attention lse {name}", "kernel": "flash_attention_lse", **shape,
               "max_abs_err": fwd_err, "lse_max_abs_err": lse_err, "same_bits_twice": True,
               "ms": time_ms(torch, lambda: ops.flash_attention_lse_cuda(q, k, v), flush),
               "plain_ms": time_ms(torch, lambda: ops.flash_attention_lse_reference(q, k, v),
                                   flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True), flush),
               "library": "scaled_dot_product_attention (is_causal, enable_gqa) forward",
               "bound_ms": f_ms, "bound_by": f_by}
        if dtype == "bfloat16":
            # the serving entry's rows kernel on the same inputs: what the
            # log-sum-exp forward ran (with an lse write) before its own kernel
            fwd["rows_kernel_ms"] = time_ms(torch, lambda: ops.flash_attention_cuda(q, k, v),
                                            flush)
        bwd = {"case": f"attention backward {name}", "kernel": "flash_attention_backward",
               **shape, "max_abs_err": bwd_err, "same_bits_twice": True,
               "ms": time_ms(torch, lambda: ops.flash_attention_backward_cuda(
                   q, k, v, out, do, lse), flush),
               "plain_ms": time_ms(torch, lambda: ops.flash_attention_backward_reference(
                   q, k, v, out, do, lse), flush)}
        if dtype == "bfloat16":
            bwd["launch_ms"] = backward_launch_ms(
                torch, ops, lambda: ops.flash_attention_backward_cuda(q, k, v, out, do, lse), flush)
            bwd["parts"] = backward_parts(torch, ops, flush, name, (q, k, v, out, do, lse), {},
                                          want)
    bwd.update({
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), flush),
        "library": "scaled_dot_product_attention (is_causal, enable_gqa) backward",
        "bound_ms": b_ms, "bound_by": b_by})
    return [fwd, bwd]


def train_norm_case(torch, F, ops, flush, name, rows, d, dtype, gen, dev, add=False) -> dict:
    """The RMSNorm backward (plain or add mode) at [rows, d] against its
    plain version, timed beside F.rms_norm's backward (a yardstick)."""
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    x, dy, ds = randn(rows, d), randn(rows, d), randn(rows, d)
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1 + 1.0).to(dt)
    if add:
        kernel = lambda: ops.add_rmsnorm_backward_cuda(ds, dy, x, w, 1e-5)  # noqa: E731
        plain = lambda: ops.add_rmsnorm_backward_reference(ds, dy, x, w, 1e-5)  # noqa: E731
    else:
        kernel = lambda: ops.rmsnorm_backward_cuda(dy, x, w, 1e-5)  # noqa: E731
        plain = lambda: ops.rmsnorm_backward_reference(dy, x, w, 1e-5)  # noqa: E731
    got, want = kernel(), plain()
    # the add mode rounds the norm's gradient, then adds ds and rounds again:
    # an ulp of the first outlives a cancellation
    mag = (ops.rmsnorm_backward_reference(dy, x, w, 1e-5)[0].float().abs()
           + want[0].float().abs()) if add else None
    err = max(compare(torch, "rmsnorm_bwd", f"{name} d{n}", g, r, dtype, m)
              for n, g, r, m in zip(("x", "w"), got, want, (mag, None)))
    if not all(torch.equal(a, g) for a, g in zip(kernel(), got)):
        fail(f"{name}: two runs gave different bits")
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lib_out = F.rms_norm(xl, (d,), wl, 1e-5)
    b_ms, b_by = bound(rmsnorm_bwd_bytes(rows, d, x.element_size(), add),
                       rmsnorm_bwd_flops(rows, d, add), dtype)
    return {"case": name, "kernel": "rmsnorm_backward", "mode": "add" if add else "plain",
            "shape": [rows, d], "dtype": dtype, "max_abs_err": err, "same_bits_twice": True,
            "ms": time_ms(torch, kernel, flush), "plain_ms": time_ms(torch, plain, flush),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (xl, wl), dy, retain_graph=True), flush),
            "library": "F.rms_norm backward (dx, dw; no ds)",
            "bound_ms": b_ms, "bound_by": b_by}


def train_kernel_cases(torch, F, ops, flush, gen, dev) -> list:
    """Phase 10b (a): every training kernel against its plain version."""
    instances = attention_build_report()
    cases = []
    for name, b, s, hq, hkv, dtype in TRAIN_ATTN_CASES:
        cases += train_attention_case(torch, F, ops, flush, name, b, s, hq, hkv, dtype, gen, dev)
    cases += [train_backward_case(torch, F, ops, flush, *case, gen, dev)
              for case in TRAIN_BWD_CASES]
    for kernel, found in instances.items():
        next(c for c in cases
             if c["kernel"] == kernel and c["case"].endswith(" train step"))["instances"] = found
    for dtype in ("bfloat16", "float32"):
        for add in (False, True):
            name = (f"{'add_' if add else ''}rmsnorm backward train"
                    f"{'' if dtype == 'bfloat16' else ' fp32'}")
            cases.append(train_norm_case(torch, F, ops, flush, name, TRAIN_NORM_ROWS, 4096,
                                         dtype, gen, dev, add=add))
    for c in cases:
        print(f"  {c['case']}: kernel {c['ms']:.5f} ms, plain {c['plain_ms']:.5f} ms, library "
              f"{c['library_ms']:.5f} ms, bound {c['bound_ms']:.6f} ms ({c['bound_by']})",
              flush=True)
    return cases


class StepTimer:
    """CUDA events at a train step's start and at each part's end (the
    step's ``phase_hook``): device ms of forward, backward, optimizer."""

    PARTS = ("forward", "backward", "update")

    def __init__(self, torch):
        self.torch = torch
        self.events = {}

    def start(self) -> None:
        self.events = {"start": self.torch.cuda.Event(enable_timing=True)}
        self.events["start"].record()

    def __call__(self, name: str) -> None:
        self.events[name] = self.torch.cuda.Event(enable_timing=True)
        self.events[name].record()

    def split(self) -> dict:
        marks = ("start",) + self.PARTS
        return {part: self.events[a].elapsed_time(self.events[part])
                for a, part in zip(marks, self.PARTS)}


def cpu_copy(torch, tree) -> list:
    """The leaves of a tree on the host, in flatten order."""
    from bobrapet_tpu_torch.parallel.optim import tree_leaves

    return [t.to("cpu") for t in tree_leaves(tree)]


def same_bits(torch, leaves: list, tree) -> bool:
    from bobrapet_tpu_torch.parallel.optim import tree_leaves

    return all(torch.equal(a, b.to("cpu")) for a, b in zip(leaves, tree_leaves(tree)))


def train_step_leg(torch, ops, llama, train, mesh_mod, ctx_mod, seed: int, dev,
                   card: str) -> dict:
    """Phase 10b (b) and (d): the train step at Llama-3-8B width,
    TRAIN_LAYERS deep, bf16, on a one-rank mesh; then remat, and the mesh
    from the span env, from the state before the last step."""
    import math

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=TRAIN_LAYERS)
    mesh = mesh_mod.build_mesh({"data": 1}, device_type=dev.type)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, state, opt = train.init_train_state(cfg, mesh, gen,
                                                train.adamw(TRAIN_LR, weight_decay=TRAIN_WD))
    tokens = train.make_token_batch(torch.Generator(device=dev).manual_seed(seed + 1), cfg,
                                    TRAIN_BATCH, TRAIN_SEQ, mesh)
    step = train.make_train_step(cfg, mesh, optimizer=opt)
    timer = StepTimer(torch)
    step.phase_hook = timer
    want = train_launches(cfg.n_layers)
    losses, steps, launches = [], [], None
    for i in range(TRAIN_STEPS - 1):
        zero_train_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.start()
        params, state, loss = step(params, state, tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_train_counts(ops)
        if got != want:
            fail(f"train step {i}: launches {got}, expected {want}: not every attention and "
                 "norm, forward and backward, went through the kernels")
        launches = got if launches is None else {k: launches[k] + got[k] for k in got}
        losses.append(float(loss))
        steps.append({"step_ms": seconds * 1e3, **{f"{k}_ms": v for k, v in timer.split().items()}})
    # the last step from the state before it, three ways: plain, remat, and
    # on the mesh the span env builds
    zero_train_counts(ops)
    timer.start()
    new_params, _, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    if read_train_counts(ops) != want:
        fail("the last train step did not run every kernel")
    launches = {k: launches[k] + want[k] for k in want}
    losses.append(float(loss))
    steps.append({"step_ms": None, **{f"{k}_ms": v for k, v in timer.split().items()}})
    last = cpu_copy(torch, new_params)
    del new_params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  train losses {losses}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("a train loss is not finite")
    ln_v = math.log(cfg.vocab_size)
    if abs(losses[0] - ln_v) > TRAIN_FIRST_LOSS_TOL:
        fail(f"the first loss {losses[0]} is not near ln(V) = {ln_v}")
    if not losses[-1] < losses[TRAIN_FALLING] < losses[0]:
        fail(f"the loss does not fall over the first {TRAIN_FALLING} steps and after: {losses}")

    remat = train.make_train_step(cfg, mesh, optimizer=opt, remat=True)
    zero_train_counts(ops)
    r_params, _, r_loss = remat(params, state, tokens)
    torch.cuda.synchronize()
    r_launches = read_train_counts(ops)
    if r_launches != train_launches(cfg.n_layers, remat=True):
        fail(f"the remat step's launches {r_launches}")
    remat_same = float(r_loss) == losses[-1] and same_bits(torch, last, r_params)
    del r_params
    print(f"  remat step: loss {float(r_loss)} (plain {losses[-1]}), same parameters bit for "
          f"bit: {remat_same}", flush=True)
    if not remat_same:
        fail("remat=True gave another step than remat=False")

    # (d) the span env on one card
    dctx = ctx_mod.DistributedContext({})
    if dctx.initialize_distributed() is not False:
        fail("initialize_distributed with no span env is not a no-op")
    env_mesh = mesh_mod.build_mesh_from_env({"BOBRA_MESH_AXES": '{"data": 1}'},
                                            device_type=dev.type)
    if dict(zip(env_mesh.mesh_dim_names, env_mesh.shape)) != {"data": 1}:
        fail(f"the env mesh is {env_mesh}")
    env_step = train.make_train_step(cfg, env_mesh, optimizer=opt)
    e_params, _, e_loss = env_step(params, state, tokens)
    torch.cuda.synchronize()
    env_same = float(e_loss) == losses[-1] and same_bits(torch, last, e_params)
    del e_params
    print(f"  span-env mesh step: same loss and parameters bit for bit: {env_same}", flush=True)
    if not env_same:
        fail("the step on the mesh from the span env differs from the step on build_mesh's")

    # the card's busy share of one profiled step, after the timed ones
    step.phase_hook = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p_params, _, _ = step(params, state, tokens)
        torch.cuda.synchronize()
    del p_params, params, state, last
    plain = plain_path_losses(torch, ops, llama, train, cfg, mesh, opt, tokens, seed, dev)
    gaps = [abs(a - b) / b for a, b in zip(plain, losses)]
    print(f"  plain-path losses {plain}: largest relative gap {max(gaps):.5f}", flush=True)
    if max(gaps) > TRAIN_PLAIN_RTOL:
        fail("the kernels' train steps leave the plain path's")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    timed = steps[1:-1]
    step_ms = p50([s["step_ms"] for s in timed])
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "model": "llama3_8b widths", "n_layers": cfg.n_layers, "params": cfg.param_count,
        "dtype": "bfloat16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "optimizer": f"adamw({TRAIN_LR}, weight_decay={TRAIN_WD})", "losses": losses,
        "first_loss_vs_ln_v": losses[0] - ln_v, "launches": launches,
        "launches_per_step": want, "remat_launches": r_launches,
        "remat_same_bits": remat_same, "span_env_mesh_same_bits": env_same,
        "plain_path_losses": plain, "plain_path_max_rel_gap": max(gaps),
        "step_ms_p50": step_ms,
        "split_ms_p50": {part: p50([s[f"{part}_ms"] for s in timed]) for part in StepTimer.PARTS},
        "steps": steps, "tokens_per_s": flops["tokens"] / step_ms * 1e3,
        "flops": flops, "mfu": train_mfu(flops["total"], step_ms / 1e3),
        "peak_memory_gb": peak_gb,
        "profiled_step_device_ms": device_ms or None,
        "device_busy_share": device_ms / step_ms if device_ms else None,
        "port_kernels_ms": port_kernel_shares(kernels, 1, TRAIN_PORT_KERNELS),
        "top_kernels": [{"name": e.key[:70], "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top],
        "card": card,
    }


def plain_path_losses(torch, ops, llama, train, cfg, mesh, opt, tokens, seed: int,
                      dev) -> list:
    """Phase 10b's steps from the same seed with the model's attention and
    norms on their plain versions (autograd differentiates them), on the
    card: the other side of the kernels' A/B. No training kernel may run."""
    saved = (llama.attention, llama.rmsnorm, llama.add_rmsnorm)
    llama.attention = lambda q, k, v, causal=True, q_offset=0: ops.attention_reference(
        q, k, v, causal=causal, q_offset=q_offset)
    llama.rmsnorm, llama.add_rmsnorm = ops.rmsnorm_reference, ops.add_rmsnorm_reference
    try:
        params, state, _ = train.init_train_state(
            cfg, mesh, torch.Generator(device=dev).manual_seed(seed), opt)
        step = train.make_train_step(cfg, mesh, optimizer=opt)
        zero_train_counts(ops)
        losses = []
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
        if any(read_train_counts(ops).values()):
            fail("the plain path ran a kernel")
    finally:
        llama.attention, llama.rmsnorm, llama.add_rmsnorm = saved
    return losses


# the training kernels' instances by the names the profiler gives them
TRAIN_PORT_KERNELS = (("flash_attention_lse", ("flash_fwd_lse_kernel", "flash_attention_kernel")),
                      ("flash_attention_backward", ("flash_bwd_", "attn_bwd_")),
                      ("rmsnorm_backward", ("rmsnorm_bwd_kernel", "rmsnorm_dw_reduce")),
                      ("rmsnorm", ("rmsnorm_kernel",)))


def train_cross_check(torch, ops, llama, train, mesh_mod, seed: int, dev) -> dict:
    """Phase 10b (c): two layers at the 8B widths in fp32 (the scalar
    kernels), one train step on the card and one on the CPU (the plain
    versions) from the same weights and tokens."""
    from bobrapet_tpu_torch.parallel.optim import tree_leaves

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=TRAIN_CROSS_LAYERS,
                              dtype=torch.float32)
    mesh = mesh_mod.build_mesh({"data": 1}, device_type=dev.type)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    params, state, opt = train.init_train_state(cfg, mesh, gen,
                                                train.adamw(TRAIN_LR, weight_decay=TRAIN_WD))
    tokens = train.make_token_batch(torch.Generator(device=dev).manual_seed(seed + 6), cfg,
                                    TRAIN_CROSS_BATCH, TRAIN_CROSS_SEQ, mesh)
    step = train.make_train_step(cfg, mesh, optimizer=opt)
    params_cpu = tree_to(params, "cpu")
    state_cpu = opt.init(params_cpu)
    zero_train_counts(ops)
    g_params, g_state, g_loss = step(params, state, tokens)
    torch.cuda.synchronize()
    card_launches = read_train_counts(ops)
    if card_launches != train_launches(cfg.n_layers):
        fail(f"fp32 train step: launches {card_launches}")
    del params, state
    t0 = time.perf_counter()
    c_params, c_state, c_loss = step(params_cpu, state_cpu, tokens.cpu())
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(g_loss) - float(c_loss)) / abs(float(c_loss))
    worst_grad, worst_param, flips, total = 0.0, 0.0, 0, 0
    for gp, cp, gm, cm in zip(tree_leaves(g_params), tree_leaves(c_params),
                              tree_leaves(g_state[0].mu), tree_leaves(c_state[0].mu)):
        g_grad, c_grad = gm.cpu() * 10, cm * 10  # one step: mu = (1 - b1) g
        dg = float((g_grad - c_grad).abs().max())
        scale = float(c_grad.abs().max())
        worst_grad = max(worst_grad, dg / scale if scale else dg)
        if dg > TRAIN_CROSS_GRAD_RTOL * scale:
            fail(f"fp32 card vs CPU: a gradient differs by {dg} against a largest {scale}")
        err = (gp.cpu() - cp).abs()
        past = err > TRAIN_CROSS_PARAM_TOL * (1 + cp.abs())
        worst_param = max(worst_param, float(err.max()))
        total += err.numel()
        if past.any():
            near0 = (c_grad.abs() < TRAIN_CROSS_FLOOR * dg) & (c_grad != 0)
            if bool((past & ~near0).any()):
                fail("fp32 card vs CPU: a parameter differs past Adam's rounding")
            if float(err[past].max()) > 2 * TRAIN_LR + TRAIN_CROSS_PARAM_TOL:
                fail("fp32 card vs CPU: a parameter at a near-zero gradient moved past 2 lr")
            flips += int(past.sum())
    out = {"layers": cfg.n_layers, "dtype": "float32", "tokens": [TRAIN_CROSS_BATCH,
                                                                   TRAIN_CROSS_SEQ + 1],
           "card_loss": float(g_loss), "cpu_loss": float(c_loss), "loss_rel_err": loss_rel,
           "max_grad_rel_err": worst_grad, "max_param_err": worst_param,
           "params_past_tolerance": flips, "cpu_s": cpu_s,
           "card_launches": card_launches}
    print("  train card vs CPU (fp32): " + json.dumps(out), flush=True)
    if loss_rel > TRAIN_CROSS_LOSS_RTOL:
        fail("fp32 card vs CPU: the losses differ")
    if flips > TRAIN_CROSS_FLIP_SHARE * total:
        fail(f"fp32 card vs CPU: {flips} parameters past the tolerance, at near-zero gradients")
    return out


def train_phase(torch, F, ops, llama, seed: int, dev, card: str) -> dict:
    """Phase 10b: the training kernels, the train step at 8B width with
    remat and the span-env mesh, and fp32 card against CPU."""
    from bobrapet_tpu_torch import parallel as train
    from bobrapet_tpu_torch.parallel import mesh as mesh_mod
    from bobrapet_tpu_torch.sdk import context as ctx_mod

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    cases = train_kernel_cases(torch, F, ops, flush, gen, dev)
    del flush
    leg = train_step_leg(torch, ops, llama, train, mesh_mod, ctx_mod, seed, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    cross = train_cross_check(torch, ops, llama, train, mesh_mod, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the one-rank group build_mesh started for the meshes above
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return {"cases": cases, "step": leg, "cross": cross, "phase_s": time.perf_counter() - t0}


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
    t_start = time.perf_counter()

    try:
        from bobrapet_tpu_torch import ops, serving
        from bobrapet_tpu_torch.kernels import build as kbuild
        from bobrapet_tpu_torch.models import llama, tree_bytes
        from bobrapet_tpu_torch.models import lora as lora_mod
        from bobrapet_tpu_torch.models import moe as moe_mod
        from bobrapet_tpu_torch.models import quant
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from the root of the repo")

    phase_mark(t_start, "2")
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
    if spills_in(instances, "pick_tokens_kernel"):
        fail(f"a token pick instance spills registers: {spills_in(instances, 'pick_tokens')}")
    if spills_in(instances, "bobra::moe::"):
        fail(f"an MoE kernel instance spills registers: {spills_in(instances, 'bobra::moe::')}")

    phase_mark(t_start, "3")
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
                   for name, m, k, n in QUANT_CASES + QUANT_CATCHUP_CASES + QUANT_PREFILL_CASES]
    quant_cases.append(quant_case(torch, ops, quant, flush, "quant wq/wo decode fp32", 8, 4096,
                                  4096, f32, gen, dev))
    pick_cases = [pick_case(torch, ops, flush, name, rows, VOCAB, temps, getattr(torch, dt),
                            gen, dev) for name, rows, temps, dt in PICK_CASES]
    pick_floor = pick_floor_check(torch, ops, dev)
    moe_cases = moe_kernel_cases(torch, ops, flush, gen, dev)
    for c in (rms_cases + flash_cases + cached_cases + paged_cases + multi_cases + quant_cases
              + pick_cases + moe_cases):
        route = f" (route {c['route']})" if c.get("route") else ""
        graphed = f" (graphed {c['graphed_ms']:.5f})" if "graphed_ms" in c else ""
        library = ("none" if c["library_ms"] is None else f"{c['library_ms']:.5f} ms")
        parent = (f", parent's sequence {c['parent_sequence_ms']:.5f} ms"
                  if "parent_sequence_ms" in c else "")
        print(f"  {c['case']}{route}: kernel {c['ms']:.5f} ms{graphed}, plain "
              f"{c['plain_ms']:.5f} ms, library {library}{parent}, bound "
              f"{c['bound_ms']:.6f} ms ({c['bound_by']})", flush=True)
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

    phase_mark(t_start, "4")
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
        launches = greedy_counts(ops)
        print(f"greedy path (cuda_graph={graph}) launches {launches}, expected {expected}",
              flush=True)
        if launches != expected:
            fail("the main path did not run every norm, attention and pick through the kernels")
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

    phase_mark(t_start, "5")
    # ---- 5. the serving path on the same weights
    served = serving_phase(torch, ops, serving, params, cfg, args.seed, dev, card)
    phase5_tokens = served.pop("greedy_outputs")
    print("serving path: " + json.dumps(served), flush=True)
    del params
    launches_by_path = {"greedy": launches,
                        **{f"serving_{mode}": served[mode]["launches"] for mode in SERVE_MODES},
                        **{f"serving_{mode}": served["sampled"][mode]["launches"]
                           for mode in SAMPLED_MODES}}

    phase_mark(t_start, "6")
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
    int8_whole = int8_whole_path(torch, ops, llama, quant, cfg2, args.seed, dev)
    engine_cross_check(torch, ops, llama, serving, cfg, args.seed, dev)
    prefix_cross_check(torch, ops, llama, serving, lora_mod, cfg, args.seed, dev)
    spec_cross = spec_cross_check(torch, ops, llama, quant, serving, cfg, args.seed, dev)

    phase_mark(t_start, "7")
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

    phase_mark(t_start, "8")
    # ---- 8. the int8 tree at full width (the same weights), built once: the
    # int8 greedy leg, then speculative decoding with it as the draft
    t0 = time.perf_counter()
    qparams = quant.quantize_params(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    int8_leg = int8_phase(torch, ops, llama, qparams, cfg, prompt, dev, card)
    int8_leg["quantize_s"] = quantize_s
    spec = spec_phase(torch, ops, serving, llama, quant, params, cfg, args.seed, dev, card,
                      draft=qparams)
    del params, qparams
    launches_by_path["int8_greedy"] = {
        k: sum(r["launches"][k] for r in int8_leg["runs"]) for k in int8_leg["runs"][0]["launches"]
        if k != "routes"}
    routes_by_path = {
        "int8_greedy": {r: sum(run["launches"]["routes"][r] for run in int8_leg["runs"])
                        for r in ("D", "P", "F")},
        **{f"spec_{name}": {r: sum(d["routes"][r] for d in runs) for r in ("D", "P", "F")}
           for name, runs in spec["drains"].items()},
        "spec_guarded": spec["guard"]["drain"]["routes"],
        "int8_whole_path": int8_whole["routes"],
        "fp32_int8_draft": spec_cross["card_counts"]["int8_h8"]["routes"]}
    for name, runs in spec["drains"].items():
        launches_by_path[f"spec_{name}"] = {
            k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    launches_by_path["spec_guarded"] = spec["guard"]["drain"]["launches"]
    launches_by_path["spec_standalone"] = spec["standalone"]["launches"]

    phase_mark(t_start, "9")
    # ---- 9. the sparse-MoE family at Mixtral-8x7B width (phase 8's trees freed)
    mixtral = moe_phase(torch, ops, moe_mod, serving, args.seed, dev, card)
    print("moe phase: " + json.dumps({k: v for k, v in mixtral.items() if k != "greedy"}),
          flush=True)
    launches_by_path["moe_greedy"] = mixtral["greedy"]["launches"]
    for key, rec in mixtral["serving"].items():
        if isinstance(rec, dict) and "drains" in rec:
            launches_by_path[f"moe_{key}"] = rec["launches"]
    launches_by_path["moe_fp32_cross"] = {
        k: sum(c[k] for c in mixtral["cross"]["card_launches"].values())
        for k in mixtral["cross"]["card_launches"]["h1"]}

    phase_mark(t_start, "10")
    # ---- 10. the serving engram (phase 9's trees freed)
    engram_out = engram_phase(torch, ops, serving, llama, cfg, args.seed, dev, card,
                              phase5_tokens)
    print("engram phase: " + json.dumps(engram_out), flush=True)
    for key, counts in engram_out["launches"].items():
        launches_by_path[f"engram_{key}"] = counts
    del engram_out

    phase_mark(t_start, "10b")
    # ---- 10b. the train step (phase 10's trees freed)
    trained = train_phase(torch, F, ops, llama, args.seed, dev, card)
    print("train phase: " + json.dumps(trained), flush=True)
    launches_by_path["train"] = trained["step"]["launches"]
    launches_by_path["train_remat"] = trained["step"]["remat_launches"]
    launches_by_path["train_fp32_cross"] = trained["cross"]["card_launches"]

    phase_mark(t_start, "11")
    # ---- 11. result
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

    def route_entry(route, main_case):
        """The int8 product's entry for one route: its cases and launches."""
        cases = [c for c in quant_cases if c["route"] == route]
        top = next(c for c in cases if c["case"] == main_case)
        return {
            "name": f"quant_matmul route {route}", "route": "cuda",
            "source": "bobrapet_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "bobrapet_tpu/models/quant.py:70",
            "launches": sum(path[route] for path in routes_by_path.values()),
            "launches_by_path": {k: path[route] for k, path in routes_by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"], "cases": cases,
        }

    def train_entry(name, src, replaces, main_case):
        """A training kernel's entry; the attention kernels' also carry
        their instances, the backward's its launches' ms and the one- and
        two-part forms, the forward's the rows kernel's ms on its inputs
        (the kernel it replaced)."""
        out = entry(name, f"bobrapet_tpu_torch/csrc/{src}", replaces,
                    [c for c in trained["cases"] if c["kernel"] == name], main_case)
        top = next(c for c in out["cases"] if c["case"] == main_case)
        out.update({k: top[k] for k in ("launch_ms", "parts", "instances", "rows_kernel_ms")
                    if k in top})
        return out

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
        route_entry("D", "quant wq/wo decode"),
        route_entry("P", "quant w_gate/w_up prefill 1024"),
        route_entry("F", "quant wq/wo decode fp32"),
        {**entry("pick_tokens", "bobrapet_tpu_torch/csrc/pick_tokens.cu",
                 "bobrapet_tpu/serving/engine.py:2916", pick_cases, "pick decode"),
         "max_abs_err": max(c["max_abs_err"] for c in pick_cases),
         "graphed_ms": next(c["graphed_ms"] for c in pick_cases if c["case"] == "pick decode"),
         # per profiled engine tick: at H 8 a tick is one horizon of up to 8 picks
         "in_horizon_per_tick": {
             mode: in_horizon_pick(prof["port_kernels"]["pick_tokens"]) for mode, prof in (
                 ("h8", served["h8"]["profile"]), ("default", served["default"]["profile"]),
                 ("s_h8", served["sampled"]["s_h8"]["profile"]))},
         "floor": pick_floor},
        *(entry(f"moe_{step}", "bobrapet_tpu_torch/csrc/moe_dispatch.cu",
                f"bobrapet_tpu/models/moe.py:{line}",
                [c for c in moe_cases if c["kernel"] == f"moe_{step}"],
                f"moe {step} greedy prefill")
          for step, line in (("route", 142), ("combine", 209))),
        {**entry("moe_dispatch", "bobrapet_tpu_torch/csrc/moe_dispatch.cu",
                 "bobrapet_tpu/models/moe.py:197",
                 [c for c in moe_cases if c["kernel"] == "moe_dispatch"],
                 "moe dispatch greedy prefill"),
         "main_path": False,
         "note": "off the main path: the gate/up product gathers its rows itself"},
        *({**entry(f"moe_{part}", "bobrapet_tpu_torch/csrc/moe_experts.cu",
                   f"bobrapet_tpu/models/moe.py:{line}", cases, f"moe {part} greedy prefill"),
           "parent_sequence_ms": next(c["parent_sequence_ms"] for c in cases
                                      if c["case"] == f"moe {part} greedy prefill")}
          for part, line, cases in (
              (part, line, [c for c in moe_cases if c["kernel"] == f"moe_{part}"])
              for part, line in (("gate_up", 200), ("down", 206)))),
        *(train_entry(name, src, replaces, main_case)
          for name, src, replaces, main_case in (
              ("flash_attention_lse", "flash_attention.cu", "bobrapet_tpu/ops/attention.py:117",
               "attention lse train step"),
              ("flash_attention_backward", "flash_attention_bwd.cu",
               "bobrapet_tpu/ops/attention.py:161", "attention backward train step"),
              ("rmsnorm_backward", "rmsnorm_bwd.cu", "bobrapet_tpu/ops/rmsnorm.py:19",
               "add_rmsnorm backward train"))),
    ], "build_s": build_s, "host_us_per_call": host_costs}
    print(json.dumps(kernels), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
