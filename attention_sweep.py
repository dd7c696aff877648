#!/usr/bin/env python3
"""Time the bf16 decode attention kernels at every cluster split, on one card.

    python3 attention_sweep.py

The decode kernel of csrc/attention_core.cuh splits a sequence's keys
across a thread-block cluster of C blocks; ``ops.attention.kv_splits``
picks C from a static size. This script forces C to 1, 2, 4 and 8 in
turn on chip_smoke.py's decode cases (greedy decode over 160 and 2048
cache rows, the engine's tick with tables of 8 and 64 pages) and prints
each kernel time (chip_smoke.py's timer: median of 50 launches, L2
flushed), with the split the rule picks and SDPA's time for the dense
cases, as one JSON line after the card's name and power limit. A
measurement for choosing the rule; the port never calls it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPLITS = (1, 2, 4, 8)


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("attention_sweep: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from bobrapet_tpu_torch import ops

    attn = importlib.import_module("bobrapet_tpu_torch.ops.attention")
    paged = importlib.import_module("bobrapet_tpu_torch.ops.paged_attention")
    rule = attn.kv_splits
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    cases = {}
    for name, sk in (("flash decode", smoke.DECODE_KV), ("flash long decode", smoke.LONG_KV)):
        q, k, v = randn(8, 1, 32, 128), randn(8, sk, 8, 128), randn(8, sk, 8, 128)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        cases[name] = (sk, lambda q=q, k=k, v=v, sk=sk: ops.flash_attention_cuda(
            q, k, v, causal=True, q_offset=sk - 1),
            lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True))
    for name, lens, pages, n_blocks in (
            ("paged decode", smoke.PAGED_LENS, 8, 256),
            ("paged long decode", smoke.LONG_PAGED_LENS, smoke.LONG_KV_PAGES,
             smoke.LONG_PAGED_BLOCKS)):
        q = randn(len(lens), 32, 128)
        kp, vp = randn(n_blocks, 16, 8, 128), randn(n_blocks, 16, 8, 128)
        ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
        tables = torch.zeros((len(lens), pages), dtype=torch.int32)
        for s, n in enumerate(lens[1:], start=1):
            used = -(-n // 16)
            tables[s, :used] = torch.tensor(ids[:used], dtype=torch.int32)
            ids = ids[used:]
        args = (q, kp, vp, tables.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev))
        cases[name] = (16 * pages, lambda args=args: ops.paged_attention_cuda(*args), None)

    out = {}
    try:
        for name, (size, fn, lib) in cases.items():
            row = {"rule": rule(size)}
            for c in SPLITS:
                attn.kv_splits = paged.kv_splits = lambda _size, c=c: c
                row[f"ms_at_{c}"] = smoke.time_ms(torch, fn, flush)
            row["library_ms"] = smoke.time_ms(torch, lib, flush) if lib else None
            out[name] = row
    finally:
        attn.kv_splits = paged.kv_splits = rule
    print(smoke.card_line(), flush=True)
    print(json.dumps({"splits": out}), flush=True)


if __name__ == "__main__":
    main()
