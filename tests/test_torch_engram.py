"""The port's serving engram against the JAX package's, on the CPU.

Every refusal of ``build_engine``, ``_build_draft`` and ``serve`` raises
the JAX engram's ValueError with its message; a checkpoint JAX saved is
served by the port's engram with the JAX engram's tokens; ``serve(ctx)``
puts the same wire messages downstream as JAX's for the same input
messages; ``apply_tuning`` keeps what a step pinned, as JAX's does; and
tenant weights reorder admission as they do in JAX's engine, in lockstep.
The contexts are duck-typed (``config``, ``storage.store``,
``open_output_streams``, ``open_input_stream``), the way both engrams read
them. Models: llama_tiny (fp32, 2 layers); JAX's weights reach the port
through its checkpoint.
"""

import types

import jax
import numpy as np
import pytest
import torch

from bobrapet_tpu.config import operator as jop
from bobrapet_tpu.config.operator import ServingConfig
from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.sdk.checkpoint import save_checkpoint as jax_save
from bobrapet_tpu.serving import PagedConfig as JPagedConfig
from bobrapet_tpu.serving import ServingEngine as JServingEngine
from bobrapet_tpu.serving import engram as jengram
from bobrapet_tpu.storage.store import MemoryStore as JMemoryStore
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from bobrapet_tpu_torch.serving import engram as tengram
from bobrapet_tpu_torch.traffic.fairness import WeightedFairQueue
from tests.torch_lockstep import assert_same_state, outputs

PAGING = {"maxSlots": 2, "blockSize": 8, "numBlocks": 32, "maxBlocksPerSeq": 6}


@pytest.fixture(autouse=True)
def _clean_tuning(monkeypatch):
    """No operator tuning parked by another test, and one torch thread."""
    monkeypatch.setattr(jengram, "_TUNING", None)
    monkeypatch.setattr(jop, "LAST_SERVING_TUNING", None)
    monkeypatch.setattr(tengram, "_TUNING", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt():
    """JAX's llama_tiny weights saved by JAX's checkpoint into a store."""
    cfg = jllama.llama_tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    store = JMemoryStore()
    jax_save(store, "runs/d/r1/model", {"params": params}, step=3)
    return {"cfg": cfg, "params": params, "store": store}


class Ctx:
    """What both engrams read of an EngramContext."""

    def __init__(self, config, store=None, messages=(), producers=1):
        self.config = config
        self.storage = types.SimpleNamespace(store=store) if store is not None else None
        self.step = "generate"
        self.trace_context = None
        self.sent: list = []
        self.closed = 0
        self._messages = list(messages)
        self._producers = producers

    def open_output_streams(self):
        ctx = self

        class Producer:
            def send(self, payload, **kw):
                ctx.sent.append(payload)

            def close(self):
                ctx.closed += 1

        return [Producer() for _ in range(self._producers)]

    def open_input_stream(self, hub):
        assert hub == self.config["hub"]
        return iter(self._messages)


def _jax_build(ctx):
    return jengram.build_engine(ctx)


def _port_build(ctx):
    return tengram.build_engine(ctx, device="cpu")


REFUSALS = {
    "unknown_model": {"model": "nope"},
    "moe_quant": {"model": "moe-tiny", "quant": "int8"},
    "moe_lora": {"model": "moe-tiny", "lora": {"initSeeds": [1]}},
    "moe_draft": {"model": "moe-tiny", "draft": {"selfInt8": True}},
    "quant_unsupported": {"model": "tiny", "quant": "fp4"},
    "lora_empty": {"model": "tiny", "lora": {"rank": 4}},
    "checkpoint_without_storage": {"model": "tiny", "checkpoint": "runs/prod/llama"},
    "draft_checkpoint_without_storage": {"model": "tiny",
                                         "draft": {"model": "tiny", "checkpoint": "x"}},
    "shared_without_caching": {"model": "tiny", "prefixShared": True,
                               "paging": {"prefixCaching": False}},
    "prefill_without_caching": {"model": "tiny", "role": "prefill",
                                "paging": {"prefixCaching": False}},
    "prefill_without_sharing": {"model": "tiny", "role": "prefill", "prefixShared": False},
    "tenant_weights_not_mapping": {"model": "tiny", "tenantWeights": [1, 2]},
    "tenant_weights_empty": {"model": "tiny", "tenantWeights": {}},
    "tenant_weight_zero": {"model": "tiny", "tenantWeights": {"a": 1, "b": 0}},
    "self_int8_with_model": {"model": "tiny", "draft": {"selfInt8": True, "model": "tiny"}},
    "self_int8_with_quant": {"model": "tiny", "quant": "int8", "draft": {"selfInt8": True}},
    "draft_unknown": {"model": "tiny", "draft": {"model": "huge"}},
    "draft_moe": {"model": "tiny", "draft": {"model": "moe-tiny"}},
    "engine_refusal": {"model": "tiny", "decodeHorizon": 0},
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_build_engine_refusals_match_jax(name):
    config = {**REFUSALS[name]}
    config.setdefault("paging", {})
    config["paging"] = {**PAGING, **config["paging"]}
    with pytest.raises(ValueError) as want:
        _jax_build(Ctx(config))
    with pytest.raises(ValueError) as got:
        _port_build(Ctx(config))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("config,producers", [
    ({"model": "tiny"}, 1),                 # no hub
    ({"model": "tiny", "hub": "h"}, 0),     # no downstream target
    ({"model": "nope", "hub": "h"}, 2),     # the build fails: both targets closed
], ids=["no_hub", "no_target", "build_fails"])
def test_serve_refusals_match_jax(config, producers):
    results = []
    for serve in (jengram.serve, lambda c: tengram.serve(c, device="cpu")):
        ctx = Ctx(config, producers=producers)
        with pytest.raises(ValueError) as err:
            serve(ctx)
        results.append((str(err.value), ctx.closed))
    assert results[0] == results[1]


def _prompts(n, seed=91, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 6 + 3 * i).tolist() for i in range(n)]


@pytest.mark.parametrize("extra", [{}, {"decodeHorizon": 1, "dispatchDepth": 1},
                                   {"quant": "int8"}, {"prefixShared": True}],
                         ids=["defaults", "classic", "int8", "shared"])
def test_jax_checkpoint_served_with_jax_engrams_tokens(ckpt, extra):
    config = {"model": "tiny", "checkpoint": "runs/d/r1/model", "paging": PAGING, **extra}
    outs = []
    for build in (_jax_build, _port_build):
        eng = build(Ctx(config, store=ckpt["store"]))
        for p in _prompts(3):
            eng.submit(p, 5)
        outs.append({r.rid: r.output for r in eng.run()})
        if build is _port_build:
            assert eng.device == torch.device("cpu")
            assert (eng.blocks.shared is not None) == bool(extra.get("prefixShared"))
    assert outs[0] == outs[1]


def test_port_params_restored_bit_for_bit(ckpt):
    eng = _port_build(Ctx({"model": "tiny", "checkpoint": "runs/d/r1/model", "paging": PAGING},
                          store=ckpt["store"]))
    want = params_from_numpy(jax.tree.map(np.asarray, ckpt["params"]), "cpu")
    got_l, want_l = jax.tree.leaves(eng.params), jax.tree.leaves(want)
    assert len(got_l) == len(want_l) and all(torch.equal(a, b) for a, b in zip(got_l, want_l))


def test_serve_wire_output_matches_jax(ckpt):
    """The same input messages, good and malformed, give the same wire
    messages downstream, in the same order, and the same served count."""
    prompts = _prompts(4, seed=92)
    messages = [
        {"id": 0, "prompt": prompts[0], "maxNewTokens": 4},
        "not an object",
        {"id": "x", "prompt": prompts[1], "maxNewTokens": 3, "temperature": 0.0},
        {"id": 2},                                                  # no prompt
        {"id": 3, "prompt": prompts[2], "maxNewTokens": 0},         # no budget
        {"id": 4, "prompt": prompts[3], "eos": 7, "tenant": "t1"},  # default budget
        {"id": 5, "prompt": prompts[0], "maxNewTokens": 2, "trace": {"traceId": "a" * 32}},
    ]
    config = {"model": "tiny", "checkpoint": "runs/d/r1/model", "hub": "inproc:0",
              "paging": {**PAGING, "maxBlocksPerSeq": 8}}
    sent = []
    for serve in (jengram.serve, lambda c: tengram.serve(c, device="cpu")):
        ctx = Ctx(config, store=ckpt["store"], messages=messages, producers=2)
        result = serve(ctx)
        assert result == {"served": 4} and ctx.closed == 2
        sent.append(ctx.sent)
    assert sent[1] == sent[0]
    assert {m["id"] for m in sent[1] if "tokens" in m} == {0, "x", 4, 5}


def test_lora_checkpoints_and_init_seeds_build_the_stack(ckpt):
    from bobrapet_tpu.models import lora as jlora

    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, sites=("wq", "wv"))
    trained = jax.tree.map(lambda leaf: leaf + 0.05,
                           jlora.init_lora(jax.random.PRNGKey(4), ckpt["cfg"], lcfg))
    store = ckpt["store"]
    jax_save(store, "runs/d/r2/adapter-a", {"lora": trained}, step=1)
    config = {"model": "tiny", "checkpoint": "runs/d/r1/model", "paging": PAGING,
              "lora": {"rank": 4, "alpha": 8, "sites": ["wq", "wv"],
                       "checkpoints": ["runs/d/r2/adapter-a"]}}
    outs = []
    for build in (_jax_build, _port_build):
        eng = build(Ctx(config, store=store))
        assert eng.n_adapters == 2
        p = _prompts(1, seed=93)[0]
        r0, r1 = eng.submit(p, 4, adapter=0), eng.submit(p, 4, adapter=1)
        done = {r.rid: r.output for r in eng.run()}
        outs.append((done[r0], done[r1]))
    assert outs[0] == outs[1] and outs[1][0] != outs[1][1]
    seeded = _port_build(Ctx({"model": "tiny", "initSeed": 0, "paging": PAGING,
                              "lora": {"rank": 4, "initSeeds": [1, 2]}}))
    assert seeded.n_adapters == 3


@pytest.mark.parametrize("draft", [{"selfInt8": True, "specK": 2, "guard": False},
                                   {"model": "tiny", "checkpoint": "runs/d/r1/model"}],
                         ids=["self_int8", "named"])
def test_draft_configs_serve_the_plain_tokens(ckpt, draft):
    config = {"model": "tiny", "checkpoint": "runs/d/r1/model", "paging": PAGING}
    plain = _port_build(Ctx(config, store=ckpt["store"]))
    spec = _port_build(Ctx({**config, "draft": draft}, store=ckpt["store"]))
    assert spec.draft_params is not None and spec.spec_k == draft.get("specK", 4)
    for eng in (plain, spec):
        for p in _prompts(2, seed=94):
            eng.submit(p, 5)
    assert {r.rid: r.output for r in spec.run()} == {r.rid: r.output for r in plain.run()}


def test_seeded_init_uses_the_ports_generator():
    eng = _port_build(Ctx({"model": "tiny", "initSeed": 5, "paging": PAGING}))
    from bobrapet_tpu_torch.models import llama as tllama

    want = tllama.init_params(tllama.llama_tiny(), torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(eng.params["layers"][1]["attn"]["wq"], want["layers"][1]["attn"]["wq"])


def test_moe_model_builds_with_no_drop_capacity():
    eng = _port_build(Ctx({"model": "moe-tiny", "paging": PAGING}))
    assert eng.is_moe and eng.cfg.capacity_factor == float(eng.cfg.n_experts)


def test_apply_tuning_keeps_step_pins_as_jax():
    config = {"model": "tiny", "paging": PAGING, "decodeHorizon": 2, "tenantWeights": {"a": 2}}
    jeng, teng = _jax_build(Ctx(config)), _port_build(Ctx(config))
    free_j, free_t = _jax_build(Ctx({"model": "tiny", "paging": PAGING})), _port_build(
        Ctx({"model": "tiny", "paging": PAGING}))
    assert teng._engram_pinned == jeng._engram_pinned == {"decode_horizon", "tenant_weights"}
    scfg = ServingConfig(decode_horizon=4, dispatch_depth=1, spec_k=3, prefix_cache_shared=True,
                         tenant_weights="b:3")
    try:
        jengram.apply_tuning(scfg)
        tengram.apply_tuning(scfg)
        for j, t in ((jeng, teng), (free_j, free_t)):
            assert (t.decode_horizon, t.dispatch_depth, t.spec_k, t.role) == (
                j.decode_horizon, j.dispatch_depth, j.spec_k, j.role)
            assert t._tenant_weights == j._tenant_weights
            assert (t.blocks.shared is None) == (j.blocks._shared is None)
        assert teng.decode_horizon == 2 and teng._tenant_weights == {"a": 2.0}
        assert free_t.decode_horizon == 4 and free_t._tenant_weights == {"b": 3.0}
        # a build after the push takes its knobs as defaults
        later = _port_build(Ctx({"model": "tiny", "paging": PAGING}))
        assert (later.decode_horizon, later.dispatch_depth) == (4, 1)
        assert later.blocks.shared is not None
        # an unparseable weights string keeps the prior weights
        bad = ServingConfig(tenant_weights="b:0")
        jengram.apply_tuning(bad)
        tengram.apply_tuning(bad)
        assert free_t._tenant_weights == free_j._tenant_weights == {"b": 3.0}
    finally:
        jengram.apply_tuning(ServingConfig())
        tengram.apply_tuning(ServingConfig())
    assert free_t.blocks.shared is None and free_t.decode_horizon == 8


@pytest.mark.parametrize("horizon", [1, 8])
def test_tenant_weights_in_lockstep_with_jax(ckpt, horizon):
    """A flood from one tenant and a trickle from two others: with weights
    the port admits in JAX's order, step by step, with JAX's outputs."""
    params_t = params_from_numpy(jax.tree.map(np.asarray, ckpt["params"]), "cpu")
    pcfg = dict(max_slots=2, block_size=8, num_blocks=64, max_blocks_per_seq=6)
    kw = dict(pipeline_decode=False, decode_horizon=horizon, dispatch_depth=1)
    jeng = JServingEngine(ckpt["params"], ckpt["cfg"], JPagedConfig(**pcfg), **kw)
    from bobrapet_tpu_torch.models import llama as tllama

    teng = ServingEngine(params_t, tllama.llama_tiny(), PagedConfig(**pcfg), **kw)
    weights = {"gold": 4.0, "*": 1.0}
    rng = np.random.default_rng(95)
    first = rng.integers(0, 512, 5).tolist()
    for eng in (jeng, teng):
        eng.submit(first, 3, tenant="flood")
    for eng in (jeng, teng):
        eng.set_tenant_weights(weights)  # a live swap keeps the queued request
    assert isinstance(teng.pending, WeightedFairQueue) and len(teng.pending) == 1
    reqs = [(rng.integers(0, 512, 4 + i % 3).tolist(), 2 + i % 4,
             ["flood", "flood", "flood", "gold", "free"][i % 5]) for i in range(14)]
    for p, budget, tenant in reqs:
        assert jeng.submit(p, budget, tenant=tenant) == teng.submit(p, budget, tenant=tenant)
    while jeng.pending or any(jeng.slots):
        assert jeng.step() == teng.step()
        assert_same_state(jeng, teng)
    assert outputs(teng) == outputs(jeng)
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    for eng in (jeng, teng):
        eng.set_tenant_weights(None)
    assert not isinstance(teng.pending, WeightedFairQueue)


def test_tenant_labels_are_bounded_as_jax():
    eng = _port_build(Ctx({"model": "tiny", "paging": PAGING}))
    jeng = _jax_build(Ctx({"model": "tiny", "paging": PAGING}))
    for i in range(70):
        assert eng._bound_tenant(f"t{i}") == jeng._bound_tenant(f"t{i}")
    assert eng._bound_tenant("x" * 100) == "other" and eng._bound_tenant("t3") == "t3"
    assert ServingEngine.MAX_TENANT_LABELS == JServingEngine.MAX_TENANT_LABELS == 64


def test_parse_tenant_weights_matches_jax():
    from bobrapet_tpu.traffic.fairness import parse_tenant_weights as jparse
    from bobrapet_tpu_torch.traffic.fairness import parse_tenant_weights as tparse

    for raw in ("", "  ", "alice:4,bob:1", "a:1, ,b:2.5", "*:2,x:1"):
        assert tparse(raw) == jparse(raw)
    for raw in ("alice", ":3", "a:0", "a:-1", "a:x"):
        with pytest.raises(ValueError) as want:
            jparse(raw)
        with pytest.raises(ValueError) as got:
            tparse(raw)
        assert str(got.value) == str(want.value)


def test_build_engine_defaults_to_the_card():
    ctx = Ctx({"model": "tiny", "paging": PAGING})
    if torch.cuda.is_available():
        assert tengram.build_engine(ctx).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengram.build_engine(ctx)
