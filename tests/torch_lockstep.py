"""Lockstep harness for the port's ServingEngine against the JAX package's.

Both engines get the same requests in the same order and are stepped
together; after every ``step()`` the scheduler and prefix-cache state must
be the same: finished rids, slots (rid, blocks, seq_len, ingest_pos,
shared tokens, outputs), the free list, the queue, the prefix cache's hash
maps, refcounts and hit/miss tokens, the speculative drafted and accepted
counts, the horizon and host-sync counts and the horizons in flight. Used
by tests/test_torch_prefix.py, tests/test_torch_lora.py,
tests/test_torch_spec.py and tests/test_torch_pipeline.py.
"""

import jax
import numpy as np

from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine


def bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def prompt(rng, n, vocab):
    return rng.integers(0, vocab, n).tolist()


def engines(params_j, params_t, cfg_j, cfg_t, pcfg: dict, horizon: int, depth: int = 1,
            **kw):
    """A JAX engine and a port engine on the same config, at ``dispatch_depth``
    ``depth`` with the dispatch-ahead tick off (``kw``: ``loras`` as a pair
    (JAX tree, port tree), ``lora_scale``; ``draft`` as (JAX tree, port tree,
    JAX config, port config), with ``spec_k`` and the guard's arguments)."""
    loras = kw.pop("loras", (None, None))
    draft = kw.pop("draft", (None, None, None, None))
    common = dict(pipeline_decode=False, decode_horizon=horizon, dispatch_depth=depth, **kw)
    jeng = JServingEngine(params_j, cfg_j, JPagedConfig(**pcfg), loras=loras[0],
                          draft_params=draft[0], draft_cfg=draft[2], **common)
    teng = ServingEngine(params_t, cfg_t, PagedConfig(**pcfg), loras=loras[1],
                         draft_params=draft[1], draft_cfg=draft[3], **common)
    return jeng, teng


def slot_view(eng):
    return [(s.request.rid, list(s.blocks), s.seq_len, s.ingest_pos, s.shared_tokens,
             list(s.request.output)) if s is not None else None for s in eng.slots]


def cache_view(eng):
    b = eng.blocks
    return (dict(b._by_hash), dict(b._hash_of), dict(b._refs), b.hit_tokens, b.miss_tokens)


def outputs(eng):
    return {r.rid: r.output for r in eng.finished}


def assert_same_state(jeng, teng):
    assert slot_view(teng) == slot_view(jeng)
    assert teng.allocator._free == jeng.allocator._free
    assert [r.rid for r in teng.pending] == [r.rid for r in jeng.pending]
    assert cache_view(teng) == cache_view(jeng)
    assert outputs(teng) == outputs(jeng)
    assert (teng.spec_drafted, teng.spec_accepted) == (jeng.spec_drafted, jeng.spec_accepted)
    # (the port's device_steps also counts classic ticks; JAX's counts
    # only horizon steps)
    for key in ("horizons", "host_syncs"):
        assert teng.phase_counts[key] == jeng.phase_counts[key], key
    assert len(teng._inflight) == len(jeng._inflight)


def run_lockstep(jeng, teng, waves) -> int:
    """``waves``: a list of ``(requests, steps)``, requests a list of
    ``(prompt, budget, submit kwargs)``; each wave's requests are submitted
    to both engines, which then step together ``steps`` times (None: until
    both are idle). Returns the steps taken."""
    total = 0
    for requests, steps in waves:
        for p, budget, kw in requests:
            assert jeng.submit(p, budget, **kw) == teng.submit(p, budget, **kw)
        n = 0
        while (jeng.pending or any(jeng.slots)) and (steps is None or n < steps):
            assert jeng.step() == teng.step()
            assert_same_state(jeng, teng)
            n += 1
        total += n
    assert not (teng.pending or any(teng.slots))
    jeng.run()
    teng.run()
    assert outputs(teng) == outputs(jeng)
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert [r.preemptions for r in teng.finished] == [r.preemptions for r in jeng.finished]
    assert teng.allocator.free_blocks == teng.pcfg.num_blocks - 1
    return total
