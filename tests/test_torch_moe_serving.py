"""The port's serving engine on the sparse-MoE family against the JAX
package's, on the CPU.

JAX's weights (``moe_tiny`` at the no-drop capacity serving requires) are
carried over with the bridge. Held here:

- the engine in lockstep with JAX's (tests/torch_lockstep.py: slots,
  blocks, free list, prefix-cache state and outputs after every step) at
  H = 1, 2, 8 x dispatch depth 1, 2, on the scenarios of
  tests/test_serving.py's TestMoEServing: three requests over three slots,
  and a shared 16-token prefix with chunks of 16 (prefix caching on),
  then a third request that hits the cached prefix;
- the engine at its own defaults (``ServingEngine(params, cfg)``) against
  the port's ``moe.greedy_generate``, token for token, and its sampled
  streams the same at H = 1 and at the defaults;
- JAX's refusals, with JAX's messages: LoRA, a droppy capacity, an int8
  router, a draft.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import lora as jlora
from bobrapet_tpu.models import moe as jmoe
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models import lora as tlora
from bobrapet_tpu_torch.models import moe as tmoe
from bobrapet_tpu_torch.models import quant as tquant
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from tests.torch_lockstep import bridge, engines, prompt, run_lockstep

SLOTS3 = dict(max_slots=3, block_size=8, num_blocks=64, max_blocks_per_seq=8)
PREFIX = dict(max_slots=2, block_size=8, num_blocks=64, max_blocks_per_seq=8, prefill_chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def moe_model():
    cfg_j = dataclasses.replace(jmoe.moe_tiny(), capacity_factor=float(jmoe.moe_tiny().n_experts))
    cfg_t = dataclasses.replace(tmoe.moe_tiny(), capacity_factor=float(tmoe.moe_tiny().n_experts))
    params_j = jmoe.init_params(jax.random.PRNGKey(0), cfg_j)
    return {"cfg": (cfg_j, cfg_t), "params": (params_j, bridge(params_j))}


def _scenario(name: str, vocab: int):
    """The paging and the waves of requests of a lockstep scenario: JAX's
    requests, and for the prefix a second wave that hits the cached prefix."""
    if name == "three_requests":
        rng = np.random.default_rng(100)
        return SLOTS3, [([(prompt(rng, n, vocab), 5, {}) for n in (7, 15, 22)], None)]
    rng = np.random.default_rng(101)
    system = prompt(rng, 16, vocab)
    a = system + prompt(rng, 20, vocab)
    b = system + prompt(rng, 3, vocab)
    c = system + prompt(rng, 9, vocab)
    return PREFIX, [([(a, 4, {}), (b, 4, {})], None), ([(c, 4, {})], None)]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("horizon", [1, 2, 8])
@pytest.mark.parametrize("scenario", ["three_requests", "prefix_and_chunks"])
def test_engine_in_lockstep_with_jax(moe_model, scenario, horizon, depth):
    (cfg_j, cfg_t), (params_j, params_t) = moe_model["cfg"], moe_model["params"]
    pcfg, waves = _scenario(scenario, cfg_t.vocab_size)
    jeng, teng = engines(params_j, params_t, cfg_j, cfg_t, pcfg, horizon, depth)
    assert teng.is_moe and jeng.is_moe
    run_lockstep(jeng, teng, waves)
    if scenario == "prefix_and_chunks":
        assert teng.phase_counts["chunks"] > 0 and teng.blocks.hit_tokens > 0


def test_default_engine_matches_greedy_generate(moe_model):
    _, cfg_t = moe_model["cfg"]
    _, params_t = moe_model["params"]
    eng = ServingEngine(params_t, cfg_t, PagedConfig(**SLOTS3))
    assert (eng.decode_horizon, eng.dispatch_depth) == (8, 2) and eng.is_moe
    rng = np.random.default_rng(102)
    prompts = [prompt(rng, n, cfg_t.vocab_size) for n in (5, 11, 18, 9)]
    rids = [eng.submit(p, 7) for p in prompts]
    done = {r.rid: r.output for r in eng.run()}
    for rid, p in zip(rids, prompts):
        want = tmoe.greedy_generate(params_t, torch.tensor([p]), cfg_t, max_new_tokens=7)
        assert done[rid] == want[0].tolist()
    assert eng.allocator.free_blocks == SLOTS3["num_blocks"] - 1


def test_sampled_streams_are_the_same_at_every_horizon(moe_model):
    _, cfg_t = moe_model["cfg"]
    _, params_t = moe_model["params"]
    rng = np.random.default_rng(103)
    prompts = [prompt(rng, n, cfg_t.vocab_size) for n in (6, 13, 21, 4)]
    streams = []
    for kw in (dict(decode_horizon=1, dispatch_depth=1), {}):
        eng = ServingEngine(params_t, cfg_t, PagedConfig(**SLOTS3), **kw)
        rids = [eng.submit(p, 9, temperature=t) for p, t in zip(prompts, (0.0, 0.7, 1.0, 1.3))]
        done = {r.rid: r.output for r in eng.run()}
        streams.append([done[r] for r in rids])
    assert streams[0] == streams[1]


def _refusal(case: str, side: str, model):
    """The constructor call of ``case`` on the JAX (``side`` "jax") or the
    port's engine; returns the error it raises."""
    (cfg_j, cfg_t), (params_j, params_t) = model["cfg"], model["params"]
    jax_side = side == "jax"
    cfg, params = (cfg_j, params_j) if jax_side else (cfg_t, params_t)
    engine, pcfg = (JServingEngine, JPagedConfig()) if jax_side else (ServingEngine,
                                                                      PagedConfig())
    kw = {}
    if case == "lora":
        if jax_side:
            lcfg = jlora.LoRAConfig(rank=2)
            kw["loras"] = jlora.stack_adapters([jlora.zero_lora(jllama.llama_tiny(), lcfg)] * 2)
        else:
            lcfg = tlora.LoRAConfig(rank=2)
            kw["loras"] = tlora.stack_adapters(
                [tlora.zero_lora(tllama.llama_tiny(), lcfg, device="cpu")] * 2)
    elif case == "droppy":
        cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    elif case == "int8_router":
        params = (jquant if jax_side else tquant).quantize_params(params)
    else:  # a draft
        dcfg = (jllama if jax_side else tllama).llama_tiny()
        kw.update(draft_params=params, draft_cfg=dcfg)
    with pytest.raises(ValueError) as err:
        engine(params, cfg, pcfg, **kw)
    return err.value


@pytest.mark.parametrize("case,match", [
    ("lora", "dense-family only"),
    ("droppy", "no-drop"),
    ("int8_router", "dense-family"),
    ("draft", "dense-target only"),
])
def test_refusals_are_jax_refusals(moe_model, case, match):
    want = _refusal(case, "jax", moe_model)
    got = _refusal(case, "port", moe_model)
    assert match in str(got) and str(got) == str(want)
