#!/usr/bin/env python3
"""Time the bf16 attention backward's launches (D, dk/dv, dq), or the bf16
log-sum-exp forward of the train step, for variants of its source, on one
card.

    python3 attention_bwd_ab.py [--forward] [--variants base,...] [--reps 3]
                                [--src NAME=FILE ...]

A variant is ``bobrapet_tpu_torch/csrc/flash_attention_bwd.cu`` (with
--forward: ``flash_attention.cu``) with the text substitutions of
``VARIANTS`` (``FWD_VARIANTS``): the source as built, and for the backward
ablations that drop one step of the consumers' work, put the exponential
back behind a branch an element, or change the ring's depth; for the
forward ablations that drop the score product, the P V product or the
softmax, P V with P in one bf16 part (outside the tolerance: a timing
only), and other ring depths. Or another source file (``--src``, built against this
checkout's headers). Every variant is built by nvcc into
``build/ab/<name>/`` at once, then timed in a process of its own (two
statically linked CUDA runtimes in one process refused the second's
launches) at the train step's shapes (q [8, 512, 32, 128], k/v [8, 512, 8,
128], causal, bf16): the backward with o and lse from the plain forward,
or the forward, checked once against its plain version (largest error of
o and of lse); then 20 calls under the profiler with the L2 flushed before
each, device ms a call of each launch. Prints the card's name and power
limit, then one JSON line a variant and rep. A measurement for choosing a
design; the port never calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "bobrapet_tpu_torch" / "csrc"
OUT = ROOT / "build" / "ab"
SOURCE = "flash_attention_bwd.cu"
FWD_SOURCE = "flash_attention.cu"
NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
        "-shared", "-Xptxas", "-v"]
SHAPE = (8, 512, 32, 8, 128)  # b, s, hq, hkv, d
CALLS = 20
KERNELS = (("delta", "attn_bwd_delta_kernel"), ("dkdv", "flash_bwd_dkdv_kernel"),
           ("dq", "flash_bwd_dq_kernel"))
FWD_KERNELS = (("lse_forward", "flash_fwd_lse_kernel"),)
# (pattern, replacement) regex substitutions on the source, per variant
EXP_DKDV = r"exp2_approx\(live \? raw - \(x \? l2\.y : l2\.x\) : -INFINITY\)"
EXP_DQ = r"exp2_approx\(live \? raw - lse_r\[hh\] : -INFINITY\)"
VARIANTS = {
    "base": [],
    "branch_exp": [(EXP_DKDV, "(live ? exp2f(raw - (x ? l2.y : l2.x)) : 0.f)"),
                   (EXP_DQ, "(live ? exp2f(raw - lse_r[hh]) : 0.f)")],
    "no_exp": [(EXP_DKDV, "(live ? raw - (x ? l2.y : l2.x) : 0.f)"),
               (EXP_DQ, "(live ? raw - lse_r[hh] : 0.f)")],
    "no_rs": [(r"accumulate_rs<D, PARTS>\([^;]*\);", "")],
    "no_ss": [(r"two_score_products<D>\([^;]*\);", "zero_acc(sacc); zero_acc(pacc);")],
    "stages2": [(r"constexpr int kBwdStages = \d+;", "constexpr int kBwdStages = 2;")],
    "stages4": [(r"constexpr int kBwdStages = \d+;", "constexpr int kBwdStages = 4;")],
}
FWD_VARIANTS = {
    "base": [],
    "no_pv": [(r"issue_pv<D>\(o, pa, [^;]*\);", "hopper::wgmma_commit();")],
    "no_scores": [(r"issue_scores<D>\(sacc, q_tile, \w+\);",
                   "zero_acc(sacc); hopper::wgmma_commit();")],
    "no_softmax": [(r"fwd_softmax\(sacc, [^;]*\);", "alpha[0] = alpha[1] = 1.f;")],
    "one_part": [(r"accumulate_rs<D, 2>\(o, pa, v_tile, 0\);",
                  "accumulate_rs<D, 1>(o, reinterpret_cast<const uint32_t (&)[1][4][4]>(pa), "
                  "v_tile, 0);")],
    "stages2": [(r"constexpr int kFwdStages = \d+;", "constexpr int kFwdStages = 2;")],
    "stages4": [(r"constexpr int kFwdStages = \d+;", "constexpr int kFwdStages = 4;")],
}


def variant_source(name: str, text: str, forward: bool = False) -> str:
    """The source of variant ``name`` (of the forward's source with
    ``forward``): each substitution must apply."""
    for pattern, repl in (FWD_VARIANTS if forward else VARIANTS)[name]:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise ValueError(f"variant {name}: {pattern!r} matches nothing in "
                             f"{FWD_SOURCE if forward else SOURCE}")
    return text


def build(sources: dict, source: str = SOURCE) -> dict:
    """nvcc every variant at once, its text as ``source``: {name: library
    path}."""
    from bobrapet_tpu_torch.kernels.build import find_nvcc

    nvcc, procs = find_nvcc(), {}
    for name, text in sources.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / source).write_text(text)
        procs[name] = subprocess.Popen([nvcc, *NVCC, "-I", str(d), "-o", str(d / "lib.so"),
                                        str(d / source)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (OUT / name / "build.log").write_text(log)
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{log[-4000:]}")
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        advisories = sorted({line.strip() for line in log.splitlines() if "wgmma" in line})
        print(f"built {name}: spill bytes {max((int(a) + int(b) for a, b in spills), default=0)}"
              f", wgmma advisories {advisories}", flush=True)
        libs[name] = OUT / name / "lib.so"
    return libs


def time_variant(name: str, lib: Path, rep: int) -> dict:
    """This process: the variant's backward at the train step's shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    attn = importlib.import_module("bobrapet_tpu_torch.ops.attention")
    fn = ctypes.CDLL(str(lib)).bobra_flash_attention_backward
    fn.argtypes, fn.restype = attn._BWD_ARGTYPES, ctypes.c_int
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    b, s, hq, hkv, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d), randn(b, s, hq, d)
    o, lse = attn.flash_attention_lse_reference(q, k, v)
    o = o.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, s, s, hq, hq // hkv, d, 1, 0, 1.0 / d ** 0.5, 1, stream)
        if err:
            sys.exit(f"variant {name}: the entry returned cudaError {err}")

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    out = {"variant": name, "rep": rep}
    for key, mark in KERNELS:
        out[f"{key}_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                               if mark in e.key) / 1e3 / CALLS
    if not all(out[f"{key}_ms"] for key, _ in KERNELS):
        sys.exit(f"variant {name}: the profiler saw no device time of a launch: {out}")
    return out


def time_forward(name: str, lib: Path, rep: int) -> dict:
    """This process: the variant's log-sum-exp forward at the train step's
    shapes, its largest errors against the plain version, then its time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    attn = importlib.import_module("bobrapet_tpu_torch.ops.attention")
    fn = ctypes.CDLL(str(lib)).bobra_flash_attention_lse
    fn.argtypes, fn.restype = attn._LSE_ARGTYPES, ctypes.c_int
    dev = torch.device("cuda", 0)
    b, s, hq, hkv, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 b, s, s, hq, hq // hkv, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), o.stride(0), o.stride(1), 1, 0, 1.0 / d ** 0.5, 1,
                 stream)
        if err:
            sys.exit(f"variant {name}: the entry returned cudaError {err}")

    call()
    torch.cuda.synchronize()
    ref_o, ref_lse = attn.flash_attention_lse_reference(q, k, v)
    out = {"variant": name, "rep": rep,
           "max_abs_err": float((o.float() - ref_o.float()).abs().max()),
           "lse_max_abs_err": float((lse - ref_lse).abs().max())}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    for key, mark in FWD_KERNELS:
        out[f"{key}_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                               if mark in e.key) / 1e3 / CALLS
    if not all(out[f"{key}_ms"] for key, _ in FWD_KERNELS):
        sys.exit(f"variant {name}: the profiler saw no device time of the kernel: {out}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true",
                    help="the log-sum-exp forward (flash_attention.cu) instead of the backward")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names (default: every variant of the source)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--src", action="append", default=[], metavar="NAME=FILE")
    ap.add_argument("--time", nargs=3, metavar=("NAME", "LIB", "REP"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.time:
        name, lib, rep = args.time
        timer = time_forward if args.forward else time_variant
        print(json.dumps(timer(name, Path(lib), int(rep))), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("attention_bwd_ab.py needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(f"card: {smoke.card_line()}", flush=True)
    source = FWD_SOURCE if args.forward else SOURCE
    text = (CSRC / source).read_text()
    names = args.variants.split(",") if args.variants else list(
        FWD_VARIANTS if args.forward else VARIANTS)
    sources = {name: variant_source(name, text, args.forward) for name in names}
    for item in args.src:
        name, _, path = item.partition("=")
        sources[name] = Path(path).read_text()
    libs = build(sources, source)
    for rep in range(args.reps):
        for name, lib in libs.items():
            done = subprocess.run([sys.executable, __file__, "--time", name, str(lib), str(rep)]
                                  + (["--forward"] if args.forward else []))
            if done.returncode:
                sys.exit(done.returncode)


if __name__ == "__main__":
    main()
