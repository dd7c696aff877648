"""The port's span env, meshes and data-parallel train step against the
JAX package's, on the CPU.

``span_facts``, ``distributed_init_args`` and ``_resolve_axes`` are held
to JAX's over one table, messages included. Then one train step over a
2-process gloo group, on a ``data`` 2 mesh and on a two-level ``dcn`` 2 x
``data`` 1 mesh, is held to JAX's step on the matching 2-device mesh:
the loss, the optax state and the parameters (``tests/torch_train_check.py``),
and both ranks must agree bit for bit. Each group starts with
``torch.multiprocessing.spawn`` and ``init_method="file://<tmp_path>/pg"``
(no TCP port to share under xdist); the join fails after 90 s, it does not
hang.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker
from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.parallel import mesh as jmesh
from bobrapet_tpu.parallel import train as jtrain
from bobrapet_tpu_torch.models import bridge
from bobrapet_tpu_torch.parallel import mesh as tmesh
from bobrapet_tpu_torch.sdk import context as tcontext
from torch_train_check import assert_state_and_params, by_path, step_gradient

LR, WD = 1e-3, 0.1
JOIN_S = 90

ENVS = {
    "empty": {},
    "mesh-axes": {"BOBRA_MESH_AXES": '{"data": 2, "model": 4}'},
    "bad-json": {"BOBRA_MESH_AXES": "{not json"},
    "not-a-dict": {"BOBRA_MESH_AXES": "[1, 2]"},
    "span": {"BOBRA_DCN_REPLICAS": "2", "BOBRA_DCN_REPLICA_INDEX": "1", "BOBRA_SPAN_ID": "s-1",
             "BOBRA_SPAN_PROCESSES": "4", "BOBRA_SPAN_PROCESS_BASE": "2",
             "BOBRA_COORDINATOR_ADDRESS": "10.0.0.1:8476", "BOBRA_TPU_HOST_ID": "1",
             "BOBRA_MESH_AXES": '{"data": 2}'},
    "hosts-only": {"BOBRA_TPU_HOSTS": "2", "BOBRA_COORDINATOR_ADDRESS": "c:1"},
    "no-coordinator": {"BOBRA_SPAN_PROCESSES": "4"},
    "garbage": {"BOBRA_TPU_HOSTS": "x", "BOBRA_DCN_REPLICAS": "bad", "BOBRA_TPU_HOST_ID": "?",
                "BOBRA_SPAN_PROCESS_BASE": "", "BOBRA_COORDINATOR_ADDRESS": "c:2"},
    "zero-replicas": {"BOBRA_DCN_REPLICAS": "0", "BOBRA_SPAN_PROCESSES": "1"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_span_facts_and_init_args_match_jax(name):
    env = ENVS[name]
    assert tmesh.span_facts(env) == jmesh.span_facts(env)
    for host in (None, 0, 3):
        assert (tmesh.distributed_init_args(env, host_id=host)
                == jmesh.distributed_init_args(env, host_id=host))
    ctx = tcontext.DistributedContext(env)
    assert ctx.dcn_replicas == jmesh.span_facts(env)["replicas"]
    assert ctx.dcn_replica_index == jmesh.span_facts(env)["replica"]


@pytest.mark.parametrize("axes,n", [
    ({"data": 2}, 8), ({"data": 8}, 8), ({"data": 1, "model": 4}, 8), ({"data": 2, "model": 4}, 8),
    ({"data": 16}, 8), ({"a": 3}, 8), ({"data": 3, "model": 3}, 8), ({"data": 0, "seq": 2}, 4),
])
def test_resolve_axes_matches_jax(axes, n):
    try:
        want = jmesh._resolve_axes(axes, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh._resolve_axes(axes, n)
        assert str(got.value) == str(e)
    else:
        assert tmesh._resolve_axes(axes, n) == want


def test_initialize_distributed_joins_the_span(monkeypatch):
    calls = []
    monkeypatch.setattr(tcontext.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    assert tcontext.DistributedContext({}).initialize_distributed("cpu") is False
    ctx = tcontext.DistributedContext(ENVS["span"])
    assert ctx.host_id == 1
    assert ctx.initialize_distributed("cpu") is True
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:8476", "world_size": 4,
                               "rank": 3})]
    calls.clear()
    tcontext.DistributedContext(ENVS["span"], host_id=0).initialize_distributed("cuda")
    assert calls == [("nccl", {"init_method": "tcp://10.0.0.1:8476", "world_size": 4,
                               "rank": 2})]


def _jax_step(two_level: bool, params, tokens):
    opt = optax.adamw(LR, weight_decay=WD)
    cfg = jllama.llama_tiny()
    if two_level:
        mesh, step = jtrain.make_multislice_train_step(cfg, 2, {"data": 1},
                                                       devices=jax.devices()[:2], optimizer=opt)
    else:
        mesh = jmesh.build_mesh({"data": 2}, devices=jax.devices()[:2])
        step = jtrain.make_train_step(cfg, mesh, optimizer=opt)
    state = opt.init(params)
    mu_before = by_path(state[0].mu, False)
    new_p, new_s, loss = step(params, state, jnp.asarray(tokens))
    return dict(mesh.shape), new_p, new_s, float(loss), step_gradient(
        mu_before, by_path(new_s[0].mu, False))


@pytest.mark.parametrize("two_level", [False, True], ids=["data2", "dcn2xdata1"])
def test_data_parallel_step_over_a_gloo_group_matches_jax(tmp_path, two_level):
    cfg = jllama.llama_tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    in_path = tmp_path / "in.pt"
    torch.save({"params": bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                "tokens": torch.from_numpy(tokens).long()}, in_path)
    ctx = mp.spawn(torch_dist_worker.run_step,
                   args=(2, str(tmp_path / "pg"), str(in_path), str(tmp_path), two_level),
                   nprocs=2, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo group did not finish in {JOIN_S} s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    axes, jp, js, jloss, grads = _jax_step(two_level, params, tokens)
    assert ranks[0]["axes"] == axes == ({"dcn": 2, "data": 1} if two_level else {"data": 2})
    for r in ranks:
        assert float(r["loss"]) == pytest.approx(jloss, rel=1e-5)
    for a, b in zip(by_path(ranks[0]["params"], True).values(),
                    by_path(ranks[1]["params"], True).values()):
        assert np.array_equal(a, b)
    ill = assert_state_and_params(jp, js, ranks[0]["params"], ranks[0]["state"], [grads], LR)
    assert ill < sum(x.size for x in jax.tree.leaves(params)) // 100
