"""The port's train step against the JAX package's, on the CPU.

The same llama_tiny weights (JAX's ``init_params``, carried across with
``models.bridge``) and the same numpy tokens go through JAX's
``make_train_step`` on a one-device mesh with ``optax.adamw`` and through
the port's on a one-rank mesh with its own AdamW. Held: the loss, the
gradients (through the plain versions of the kernels), the optax state and
the parameters, step by step, with and without ``remat``; JAX's refusals;
optax's state paths; and a JAX-saved train state continued by the port.

Tolerances. Losses and gradients agree to ~1e-7 (sums in another order),
held to 1e-5; the optax state to 1e-5; the parameters to 1e-5 except where
a gradient lies within ``GRAD_FLOOR`` of zero, where Adam's normalized step
amplifies that difference (``tests/torch_train_check.py``).
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.parallel import mesh as jmesh
from bobrapet_tpu.parallel import train as jtrain
from bobrapet_tpu.sdk import checkpoint as jckpt
from bobrapet_tpu.storage import store as jstore
from bobrapet_tpu_torch.models import bridge
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.parallel import mesh as tmesh
from bobrapet_tpu_torch.parallel import optim as toptim
from bobrapet_tpu_torch.parallel import train as ttrain
from bobrapet_tpu_torch.sdk import checkpoint as tckpt
from bobrapet_tpu_torch.tree import flatten_with_path
from torch_train_check import assert_state_and_params, by_path, step_gradient

LR, WD = 1e-3, 0.1


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_mesh():
    """A one-rank mesh (the port starts a one-rank gloo group of this
    process), torn down after the module."""
    mesh = tmesh.build_mesh({"data": 1}, device_type="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def setup():
    cfg = jllama.llama_tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return cfg, params, tokens


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_tree(tree):
    return bridge.params_from_numpy(_np(tree), "cpu")


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jtrain.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(ttrain.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)


def _jax_loss(cfg):
    def loss_fn(params, tokens):
        logits, _ = jllama.forward(params, tokens[:, :-1], cfg)
        return jtrain.cross_entropy_loss(logits, tokens[:, 1:])
    return loss_fn


def test_gradients_match_jax_grad(setup):
    cfg, params, tokens = setup
    loss, grads = jax.value_and_grad(_jax_loss(cfg))(params, jnp.asarray(tokens))
    tp = _port_tree(params)
    leaves = [leaf.requires_grad_(True) for _, leaf in flatten_with_path(tp)]
    t = torch.from_numpy(tokens).long()
    logits, _ = tllama.forward(tp, t[:, :-1], tllama.llama_tiny())
    tloss = ttrain.cross_entropy_loss(logits, t[:, 1:])
    tgrads = torch.autograd.grad(tloss, leaves)
    assert float(tloss.detach()) == pytest.approx(float(loss), rel=1e-6)
    jg = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [p for p, _ in flatten_with_path(tp)] == [jax.tree_util.keystr(p) for p, _ in jg]
    for (path, want), got in zip(jg, tgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_jax(setup, port_mesh, steps, remat):
    cfg, params, tokens = setup
    mesh = jmesh.build_mesh({"data": 1}, devices=jax.devices()[:1])
    jopt = optax.adamw(LR, weight_decay=WD)
    jstep = jtrain.make_train_step(cfg, mesh, optimizer=jopt, remat=remat)
    topt = toptim.adamw(LR, weight_decay=WD)
    tstep = ttrain.make_train_step(tllama.llama_tiny(), port_mesh, optimizer=topt, remat=remat)
    assert tstep.ring_active is False
    jp, js = params, jopt.init(params)
    tp, ts = _port_tree(params), topt.init(_port_tree(params))
    t = torch.from_numpy(tokens).long()
    grads = []
    for _ in range(steps):
        mu_before = by_path(js[0].mu, False)
        jp, js, jloss = jstep(jp, js, jnp.asarray(tokens))
        tp, ts, tloss = tstep(tp, ts, t)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
        grads.append(step_gradient(mu_before, by_path(js[0].mu, False)))
    ill = assert_state_and_params(jp, js, tp, ts, grads, LR)
    # the ill-conditioned elements are few (a gradient of exactly 0, as in
    # the embedding rows no token reads, is exact on both sides)
    total = sum(leaf.size for leaf in jax.tree.leaves(params))
    assert ill < total // 100


def test_port_step_leaves_its_inputs_alone(setup, port_mesh):
    cfg, params, tokens = setup
    topt = toptim.adamw(LR, weight_decay=WD)
    tstep = ttrain.make_train_step(tllama.llama_tiny(), port_mesh, optimizer=topt)
    tp = _port_tree(params)
    ts = topt.init(tp)
    before = {p: leaf.clone() for p, leaf in flatten_with_path({"p": tp, "s": ts})}
    new_p, new_s, _ = tstep(tp, ts, torch.from_numpy(tokens).long())
    for p, leaf in flatten_with_path({"p": tp, "s": ts}):
        assert torch.equal(leaf, before[p]), p
    assert int(new_s[0].count) == 1 and not any(
        leaf.requires_grad for _, leaf in flatten_with_path(new_p))


def _fake_mesh(**axes):
    """The port reads a mesh's axis names and sizes only, before building
    anything: a stand-in for a mesh of more ranks than the test has."""
    from types import SimpleNamespace

    return SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(axes.values()))


@pytest.mark.parametrize("kwargs,axes", [
    ({"seq_parallel": "tree"}, {"data": 1}),
    ({"seq_parallel": "ring", "use_ring_attention": False}, {"data": 1}),
    ({"seq_parallel": "ulysses"}, {"seq": 2}),
], ids=["bad-strategy", "ring-off-contradiction", "ulysses-heads"])
def test_make_train_step_value_errors_match_jax(kwargs, axes):
    jcfg = jllama.llama_tiny()
    tcfg = tllama.llama_tiny()
    if axes == {"seq": 2}:
        jcfg = jllama.LlamaConfig(**{**jcfg.__dict__, "n_heads": 3})
        tcfg = tllama.LlamaConfig(**{**tcfg.__dict__, "n_heads": 3})
    n = int(np.prod(list(axes.values())))
    with pytest.raises(ValueError) as want:
        jtrain.make_train_step(jcfg, jmesh.build_mesh(axes, devices=jax.devices()[:n]),
                               **kwargs)
    with pytest.raises(ValueError) as got:
        ttrain.make_train_step(tcfg, _fake_mesh(**axes), **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axes,kwargs", [
    ({"data": 1, "fsdp": 2}, {}),
    ({"data": 1, "model": 2}, {}),
    ({"data": 1, "seq": 2}, {}),
    ({"data": 2}, {"seq_parallel": "ring"}),
    ({"data": 2}, {"use_ring_attention": True}),
], ids=["fsdp", "model", "seq", "seq-parallel", "ring"])
def test_sharded_axes_wait_for_the_sharded_slice(axes, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        ttrain.make_train_step(tllama.llama_tiny(), _fake_mesh(**axes), **kwargs)


def test_flatten_with_path_gives_keystr_paths_of_optax_state(setup):
    _, params, _ = setup
    state = optax.adamw(LR, weight_decay=WD).init(params)
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert want[:2] == ["[0].count", "[0].mu['embed']['weight']"]
    assert [p for p, _ in flatten_with_path(_np(state))] == want
    port_state = bridge.opt_state_from_numpy(_np(state), "cpu")
    assert isinstance(port_state[0], toptim.ScaleByAdamState)
    assert isinstance(port_state[1], toptim.EmptyState)
    assert [p for p, _ in flatten_with_path(port_state)] == want
    assert port_state[0].count.dtype == torch.int32
    # plain tuples and lists keep their [i] paths
    assert [p for p, _ in flatten_with_path({"a": (1, [2])})] == ["['a'][0]", "['a'][1][0]"]


def test_port_continues_a_jax_saved_train_state(setup, port_mesh):
    """The dry run's checkpoint-continuity leg across frameworks: JAX takes
    a step and saves ``{"params", "opt"}``; the port restores it and its
    next step gives JAX's next loss."""
    cfg, params, tokens = setup
    mesh = jmesh.build_mesh({"data": 1}, devices=jax.devices()[:1])
    jopt = optax.adamw(LR, weight_decay=WD)
    jstep = jtrain.make_train_step(cfg, mesh, optimizer=jopt)
    jp, js, _ = jstep(params, jopt.init(params), jnp.asarray(tokens))
    store = jstore.MemoryStore()
    jckpt.save_checkpoint(store, "train", {"params": jp, "opt": js}, step=1)
    tokens2 = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    _, _, jloss2 = jstep(jp, js, jnp.asarray(tokens2))

    topt = toptim.adamw(LR, weight_decay=WD)
    template = {"params": _port_tree(params), "opt": topt.init(_port_tree(params))}
    restored, step = tckpt.restore_checkpoint(store, "train", template, device="cpu")
    assert step == 1 and int(restored["opt"][0].count) == 1
    assert isinstance(restored["opt"][0], toptim.ScaleByAdamState)
    tstep = ttrain.make_train_step(tllama.llama_tiny(), port_mesh, optimizer=topt)
    _, _, tloss2 = tstep(restored["params"], restored["opt"], torch.from_numpy(tokens2).long())
    assert float(tloss2) == pytest.approx(float(jloss2), rel=1e-5)


def test_token_batch_and_train_state_on_the_mesh(port_mesh):
    cfg = tllama.llama_tiny()
    gen = torch.Generator().manual_seed(3)
    params, state, opt = ttrain.init_train_state(cfg, port_mesh, gen)
    assert isinstance(opt, toptim.AdamW) and (opt.learning_rate, opt.weight_decay) == (3e-4, 0.1)
    assert int(state[0].count) == 0 and params["embed"]["weight"].device.type == "cpu"
    tokens = ttrain.make_token_batch(torch.Generator().manual_seed(4), cfg, 2, 8, port_mesh)
    assert tokens.shape == (2, 9) and int(tokens.max()) < cfg.vocab_size
    with pytest.raises(NotImplementedError):
        ttrain.make_token_batch(gen, cfg, 2, 8, port_mesh, sequence_sharded=True)


def test_forward_takes_jax_attn_fn_hook(setup):
    """``forward(attn_fn=)``: the attention of a cache-less forward, as
    JAX's hook (here full, non-causal attention on both sides); None is
    causal attention."""
    cfg, params, tokens = setup
    jfn = importlib.import_module("bobrapet_tpu.ops.attention").attention_reference
    tfn = importlib.import_module("bobrapet_tpu_torch.ops.attention").attention_reference
    t = tokens[:, :-1]
    want, _ = jllama.forward(params, jnp.asarray(t), cfg,
                             attn_fn=lambda q, k, v: jfn(q, k, v, causal=False))
    tp = _port_tree(params)
    got, _ = tllama.forward(tp, torch.from_numpy(t).long(), tllama.llama_tiny(),
                            attn_fn=lambda q, k, v: tfn(q, k, v, causal=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    causal, _ = tllama.forward(tp, torch.from_numpy(t).long(), tllama.llama_tiny())
    assert not torch.allclose(causal, got)


def test_port_saved_train_state_has_jax_manifest(setup):
    """A train state saved by the port writes JAX's manifest: the same
    leaf paths, order and tree structure (optax's named tuples)."""
    _, params, _ = setup
    state = optax.adamw(LR, weight_decay=WD).init(params)
    jstore_, tstore_ = jstore.MemoryStore(), jstore.MemoryStore()
    jckpt.save_checkpoint(jstore_, "t", {"params": params, "opt": state}, step=2)
    port = {"params": _port_tree(params), "opt": bridge.opt_state_from_numpy(_np(state), "cpu")}
    tckpt.save_checkpoint(tstore_, "t", port, step=2)
    key = [k for k in jstore_.list("t/") if k.endswith(".json")]
    assert key and [k for k in tstore_.list("t/") if k.endswith(".json")] == key
    jm, tm = (json.loads(s.get(key[0])) for s in (jstore_, tstore_))
    assert tm["treedef"] == jm["treedef"] and "namedtuple[ScaleByAdamState]" in jm["treedef"]
    assert [e["path"] for e in tm["leaves"]] == [e["path"] for e in jm["leaves"]]
