#!/usr/bin/env python3
"""Per-step kernel profile of the port's greedy decode step and serving
tick on one CUDA card, for any checkout of the port.

    python3 step_profile.py [--tree DIR] [--seed N] [--graph | --wrappers | --tokens |
                            --pick [--no-pdl] |
                            --quant [--no-pdl] | --moe | --train]

Imports ``bobrapet_tpu_torch`` from DIR (default: this script's own
checkout) and builds its kernels, makes Llama-3-8B at full width and
depth with random bf16 weights from --seed, and profiles its greedy
decode steps (batch 8 after a 128-token prefill, through
``models.llama.GreedyDecoder``, which trees before it lack: eager, or
with --graph as the CUDA graph it replays) and the serving engine's
steady decode ticks (8 slots, the synchronous tick) with torch.profiler.
Both go through ``request_split`` and ``tick_profile`` of the
``chip_smoke.py`` beside this script, whatever DIR is, so two checkouts
are counted by one definition: every kernel, PyTorch's elementwise
kernels (``elementwise_kernel`` in the name) and the port's kernels, each
per step. With --wrappers it times instead each kernel wrapper's host
microseconds per call (``wrapper_host_costs`` of the same
``chip_smoke.py``) beside ``torch.add``, and makes no model. With --quant
it times instead the int8 product at every int8 case of chip_smoke.py's
phase 3 (``quant_case``: kernel, plain version, torch.matmul on a widened
weight, bound; the route where the tree's kernel has routes), then
profiles the int8 greedy decode step (``quantize_params`` of the 8B
weights through ``request_split``; --graph for the replayed graph), with
--no-pdl launching the products without programmatic dependent launch
where the tree's kernel has it. With --pick it times instead the token
pick at every pick case of chip_smoke.py's phase 3 (``pick_case``:
kernel under the single-launch timer and as a CUDA graph of launches over
cold copies of the logits, plain version, torch.argmax, bound), and makes
no model; --no-pdl launches the pick without programmatic dependent
launch where the tree's kernel has it. With --moe it makes instead
chip_smoke.py's phase-9 Mixtral tree (Mixtral-8x7B at full width, 16 of
its 32 layers, bf16 from --seed) and runs its greedy request's parts
(``request_split`` with the tree's routed forward: prefill ms, decode step
ms eager and as the CUDA graph, busy share) and the profiled split of a
prefill and an eager step (``moe_step_profile``: expert products, bmm,
other products, port kernels, elementwise); where the tree has the expert
kernels, first their phase-3 cases (``moe_expert_case`` at each of
MOE_TOKENS: kernel alone, plain version, the parent's sequence, bound).
Prints one JSON line. With --train it times instead the log-sum-exp
attention forward at the train step's shapes (the tree's kernel and
SDPA's forward under chip_smoke.py's ``time_ms``, and the bound) and runs
chip_smoke.py's phase-10b train step on the tree (Llama-3-8B width,
TRAIN_LAYERS deep, bf16, TRAIN_STEPS steps from --seed): the medians of
step ms and of its forward, backward and optimizer ms (``StepTimer``)
over the steps after the first, and each step's launches of the tree's
log-sum-exp forward. With --tokens it prints instead a digest of the tokens
of each leg of chip_smoke.py's main paths at full width, through the
tree's own entry points (greedy_generate bf16 and int8, the default-built
engine on config 6's traffic greedy and sampled, the prefix engine on
config 14's, the int8-drafted engine and standalone speculative_generate),
so that two trees' tokens can be compared. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def smoke_helpers():
    """This checkout's chip_smoke.py, under a name of its own (DIR may hold
    another chip_smoke.py)."""
    spec = importlib.util.spec_from_file_location("step_profile_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graph", action="store_true",
                    help="profile the greedy step as a CUDA graph")
    ap.add_argument("--wrappers", action="store_true",
                    help="time the kernel wrappers' host cost per call instead")
    ap.add_argument("--quant", action="store_true",
                    help="time the int8 product and profile the int8 greedy step instead")
    ap.add_argument("--tokens", action="store_true",
                    help="print a digest of every main-path leg's tokens instead")
    ap.add_argument("--pick", action="store_true",
                    help="time the token pick at chip_smoke.py's pick cases instead")
    ap.add_argument("--moe", action="store_true",
                    help="time the Mixtral tree's greedy prefill and decode step instead")
    ap.add_argument("--train", action="store_true",
                    help="time the log-sum-exp forward and the train step's split instead")
    ap.add_argument("--no-pdl", action="store_true",
                    help="with --quant or --pick: launch the int8 products or the pick "
                         "without programmatic dependent launch")
    args = ap.parse_args()
    smoke = smoke_helpers()

    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    sys.path.insert(0, str(args.tree.resolve()))
    from bobrapet_tpu_torch import serving
    from bobrapet_tpu_torch.kernels import build as kbuild
    from bobrapet_tpu_torch.models import llama

    kbuild.library()
    dev = torch.device("cuda", 0)
    if args.wrappers:
        from bobrapet_tpu_torch import ops

        costs = smoke.wrapper_host_costs(torch, ops, torch.Generator(device=dev).manual_seed(
            args.seed), dev)
        print(json.dumps({"tree": str(args.tree), "card": smoke.card_line(),
                          "host_us_per_call": costs}), flush=True)
        return
    if args.pick:
        from bobrapet_tpu_torch import ops

        pick_profile(smoke, torch, args, ops, dev)
        return
    if args.tokens:
        token_digests(smoke, torch, args, dev)
        return
    if args.moe:
        moe_profile(smoke, torch, args, dev)
        return
    if args.train:
        train_profile(smoke, torch, args, dev)
        return
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prompt = torch.randint(0, cfg.vocab_size, (smoke.BATCH, smoke.PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    if args.quant:
        quant_profile(smoke, torch, args, llama, params, prompt, cfg, dev)
        return
    split = smoke.request_split(torch, llama, params, prompt, cfg, dev, cuda_graph=args.graph)
    eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**smoke.SERVE_PAGING),
                                pipeline_decode=False, decode_horizon=1, dispatch_depth=1)
    warm = smoke.serve_prompts(torch, cfg, args.seed + 10, dev)
    for i, p in enumerate(warm):
        eng.submit(p, smoke.serve_budget(i))
    eng.run()
    tick = smoke.tick_profile(torch, eng, warm)
    keys = ("kernels_per_step", "elementwise", "port_kernels", "step_device_ms", "step_ms")
    print(json.dumps({
        "tree": str(args.tree), "card": smoke.card_line(),
        "greedy_step": {k: split[f"decode_{k}"] for k in keys[:4] + ("argmax",)}
        | {"step_ms": split["decode_step_ms"]},
        "serving_tick": {k: tick[k] for k in keys},
    }), flush=True)


def token_digests(smoke, torch, args, dev) -> None:
    """``--tokens``: sha-256 prefixes of each leg's tokens, every engine
    fresh (rids from 0), the weights and traffic of chip_smoke.py."""
    import hashlib

    from bobrapet_tpu_torch import serving
    from bobrapet_tpu_torch.models import llama, quant, speculative_generate

    def digest(tokens) -> str:
        return hashlib.sha256(json.dumps(tokens).encode()).hexdigest()[:16]

    def drain(eng, work, temps=(0.0,)) -> list:
        rids = [eng.submit(p, n, temperature=temps[i % len(temps)])
                for i, (p, n) in enumerate(work)]
        eng.run()
        by_rid = {r.rid: r.output for r in eng.finished}
        return [by_rid[r] for r in rids]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, gen(args.seed), dev)
    prompt = torch.randint(0, cfg.vocab_size, (smoke.BATCH, smoke.PROMPT), device=dev,
                           generator=gen(args.seed + 1))
    out = {"greedy": llama.greedy_generate(params, prompt, cfg,
                                           max_new_tokens=smoke.NEW_TOKENS).tolist()}
    config6 = [(p, smoke.serve_budget(i))
               for i, p in enumerate(smoke.serve_prompts(torch, cfg, args.seed + 11, dev))]
    for name, temps in (("serving", (0.0,)), ("serving_sampled", smoke.SERVE_TEMPS)):
        eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**smoke.SERVE_PAGING))
        out[name] = drain(eng, config6, temps)
        del eng
    eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**smoke.PREFIX_PAGING),
                                decode_horizon=smoke.PREFIX_HORIZON, dispatch_depth=1)
    out["prefix"] = drain(eng, [(p, n) for p, n, _ in smoke.mixed_workload(
        torch, cfg, args.seed + 20, args.seed + 22, dev)])
    del eng
    qparams = quant.quantize_params(params)
    out["int8_greedy"] = llama.greedy_generate(qparams, prompt, cfg,
                                               max_new_tokens=smoke.NEW_TOKENS).tolist()
    eng = serving.ServingEngine(params, cfg, serving.PagedConfig(**smoke.SPEC_PAGING),
                                decode_horizon=smoke.SPEC_HORIZON, dispatch_depth=1,
                                draft_params=qparams, draft_cfg=cfg, spec_k=smoke.SPEC_K,
                                spec_guard=False)
    out["spec"] = drain(eng, [(p, smoke.SPEC_NEW) for p in smoke.spec_prompts(
        torch, cfg, args.seed + 41, dev)])
    del eng, qparams
    dcfg = llama.llama_tiny(vocab_size=cfg.vocab_size)
    draft = llama.init_params(dcfg, gen(args.seed + 7), dev)
    sprompt = torch.randint(0, cfg.vocab_size, (1, smoke.STANDALONE_PROMPT), device=dev,
                            generator=gen(args.seed + 9))
    out["standalone_spec"] = speculative_generate(
        params, draft, sprompt, cfg, dcfg, max_new_tokens=smoke.STANDALONE_NEW,
        k=smoke.SPEC_K).tokens.tolist()
    print(json.dumps({"tree": str(args.tree), "card": smoke.card_line(),
                      "digests": {k: digest(v) for k, v in out.items()},
                      "tokens": {k: sum(len(x) if isinstance(x, list) else 1 for x in v)
                                 for k, v in out.items()}}),
          flush=True)


def pick_profile(smoke, torch, args, ops, dev) -> None:
    """``--pick``: the pick cases."""
    pdl = getattr(ops.pick_tokens_cuda, "pdl", None)
    if pdl is not None and args.no_pdl:
        ops.pick_tokens_cuda.pdl = pdl = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases = [smoke.pick_case(torch, ops, flush, name, rows, smoke.VOCAB, temps,
                             getattr(torch, dt), gen, dev)
             for name, rows, temps, dt in smoke.PICK_CASES]
    print(json.dumps({"tree": str(args.tree), "card": smoke.card_line(), "pdl": pdl,
                      "cases": cases}), flush=True)


def moe_profile(smoke, torch, args, dev) -> None:
    """``--moe``: the Mixtral tree's greedy request, eager and graphed, and
    the split of a prefill and an eager step."""
    from bobrapet_tpu_torch import ops
    from bobrapet_tpu_torch.models import moe

    cases = []
    if hasattr(ops, "moe_gate_up_cuda"):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        e, d, f = smoke.MOE_EXPERTS, smoke.MOE_DIM, smoke.MOE_FFN
        weights = tuple((torch.randn(shape, generator=gen, device=dev) * fan ** -0.5)
                        .to(torch.bfloat16)
                        for shape, fan in (((e, d, f), d), ((e, d, f), d), ((e, f, d), f)))
        for label, t in smoke.MOE_TOKENS:
            cases += smoke.moe_expert_case(torch, ops, flush, label, t, weights, gen, dev)
        del weights, flush
    cfg = smoke.moe_cfg(moe, smoke.MOE_LAYERS)
    params = moe.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed + 20), dev)
    prompt = torch.randint(0, cfg.vocab_size, (smoke.BATCH, smoke.PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 21))
    keys = ("prefill_ms", "decode_step_ms", "decode_step_device_ms", "decode_device_busy_share",
            "decode_port_kernels")
    splits = {}
    for graph in (False, True):
        split = smoke.request_split(torch, moe.llama, params, prompt, cfg, dev,
                                    cuda_graph=graph, forward_fn=moe.routed_forward)
        splits["graph" if graph else "eager"] = {k: split[k] for k in keys}
    print(json.dumps({
        "tree": str(args.tree), "card": smoke.card_line(), "layers": cfg.n_layers,
        "expert_cases": [{k: c[k] for k in ("case", "ms", "plain_ms", "parent_sequence_ms",
                                            "bound_ms", "bound_by", "bit_share", "max_ulps")}
                         for c in cases],
        "greedy": splits, "parts": smoke.moe_step_profile(torch, moe, params, prompt, cfg, dev),
    }), flush=True)


def train_profile(smoke, torch, args, dev) -> None:
    """``--train``: the log-sum-exp forward at the step's shapes, then the
    step's split."""
    import dataclasses
    import time

    import torch.nn.functional as F

    from bobrapet_tpu_torch import ops
    from bobrapet_tpu_torch import parallel as train
    from bobrapet_tpu_torch.models import llama
    from bobrapet_tpu_torch.parallel import mesh as mesh_mod

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    b, s, hq, hkv, d = smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, 32, 8, 128
    g = gen(args.seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.no_grad():
        lse_ms = smoke.time_ms(torch, lambda: ops.flash_attention_lse_cuda(q, k, v), flush)
        sdpa_ms = smoke.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    bound_ms, bound_by = smoke.bound((2 * q.numel() + k.numel() + v.numel()) * 2 + 4 * b * hq * s,
                                     4 * d * smoke.attention_pairs(s, s, True, 0) * b * hq,
                                     "bfloat16")
    del q, k, v, qt, kt, vt, flush
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=smoke.TRAIN_LAYERS)
    mesh = mesh_mod.build_mesh({"data": 1}, device_type=dev.type)
    params, state, opt = train.init_train_state(
        cfg, mesh, gen(args.seed), train.adamw(smoke.TRAIN_LR, weight_decay=smoke.TRAIN_WD))
    tokens = train.make_token_batch(gen(args.seed + 1), cfg, b, s, mesh)
    step = train.make_train_step(cfg, mesh, optimizer=opt)
    timer = smoke.StepTimer(torch)
    step.phase_hook = timer
    steps, losses, lse_launches = [], [], []
    for _ in range(smoke.TRAIN_STEPS):
        ops.flash_attention_lse_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.start()
        params, state, loss = step(params, state, tokens)
        torch.cuda.synchronize()
        steps.append({"step": (time.perf_counter() - t0) * 1e3, **timer.split()})
        losses.append(float(loss))
        lse_launches.append(ops.flash_attention_lse_cuda.launches)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    timed = steps[1:]
    print(json.dumps({
        "tree": str(args.tree), "card": smoke.card_line(),
        "lse_forward": {"shape": [b, s, hq, hkv, d], "ms": lse_ms, "sdpa_forward_ms": sdpa_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by},
        "train_step": {"layers": cfg.n_layers, "steps": len(steps), "losses": losses,
                       "lse_launches_per_step": lse_launches,
                       "ms_p50": {part: smoke.p50([x[part] for x in timed])
                                  for part in ("step",) + smoke.StepTimer.PARTS}},
    }), flush=True)


def quant_profile(smoke, torch, args, llama, params, prompt, cfg, dev) -> None:
    """``--quant``: the int8 cases, then the int8 greedy step."""
    from bobrapet_tpu_torch import ops
    from bobrapet_tpu_torch.models import quant

    pdl = getattr(ops.quant_matmul_cuda, "pdl", None)
    if pdl is not None and args.no_pdl:
        ops.quant_matmul_cuda.pdl = pdl = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases = [smoke.quant_case(torch, ops, quant, flush, name, m, k, n, torch.bfloat16, gen, dev)
             for name, m, k, n in (smoke.QUANT_CASES + smoke.QUANT_CATCHUP_CASES
                                   + smoke.QUANT_PREFILL_CASES)]
    cases.append(smoke.quant_case(torch, ops, quant, flush, "quant wq/wo decode fp32", 8, 4096,
                                  4096, torch.float32, gen, dev))
    del flush
    qparams = quant.quantize_params(params)
    del params
    split = smoke.request_split(torch, llama, qparams, prompt, cfg, dev, cuda_graph=args.graph)
    print(json.dumps({
        "tree": str(args.tree), "card": smoke.card_line(), "pdl": pdl, "cases": cases,
        "int8_step_products": {key: smoke.quant_step_ms(cases, cfg.n_layers, key)
                               for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "int8_greedy_step": {k: split[k] for k in (
            "cuda_graph", "prefill_ms", "decode_step_ms", "decode_step_device_ms",
            "decode_device_busy_share", "decode_int8_products", "decode_kernels_per_step")},
    }), flush=True)


if __name__ == "__main__":
    main()
