#!/usr/bin/env python3
"""Per-step kernel profile of the port's greedy decode step and serving
tick on one CUDA card, for any checkout of the port.

    python3 step_profile.py [--tree DIR] [--seed N] [--graph | --wrappers]

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
``chip_smoke.py``) beside ``torch.add``, and makes no model. Prints one
JSON line. Imports nothing of JAX.
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
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prompt = torch.randint(0, cfg.vocab_size, (smoke.BATCH, smoke.PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
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
        "greedy_step": {k: split[f"decode_{k}"] for k in keys[:4]}
        | {"step_ms": split["decode_step_ms"]},
        "serving_tick": {k: tick[k] for k in keys},
    }), flush=True)


if __name__ == "__main__":
    main()
