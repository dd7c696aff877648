"""The port's checkpoint and blob stores against the JAX package's, on the
CPU.

A checkpoint written by JAX's ``save_checkpoint`` (fp32, bf16, int8
``{"q", "scale"}`` leaves, a stacked LoRA tree, leaves sharded over the
tests' 8-device CPU mesh) must restore in the port bit for bit, and one the
port writes must restore in JAX bit for bit, with the same blob keys, the
same manifest and the same ``leaf-<i>`` order. This is the second way from
JAX's weights into the port's, beside ``models.bridge.params_from_numpy``:
the test also serves the restored tree and holds its tokens to the bridged
tree's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from bobrapet_tpu.models import llama as jllama
from bobrapet_tpu.models import lora as jlora
from bobrapet_tpu.models import quant as jquant
from bobrapet_tpu.sdk import checkpoint as jckpt
from bobrapet_tpu.storage import store as jstore
from bobrapet_tpu_torch import storage as tstore
from bobrapet_tpu_torch.models import llama as tllama
from bobrapet_tpu_torch.models.bridge import params_from_numpy
from bobrapet_tpu_torch.sdk import checkpoint as tckpt
from bobrapet_tpu_torch.serving import PagedConfig, ServingEngine
from bobrapet_tpu_torch.tree import flatten_with_path


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _trees():
    """name -> (JAX tree, port tree of the same values)."""
    cfg = jllama.llama_tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, sites=("wq", "wv"))
    loras = jlora.stack_adapters([
        jlora.zero_lora(cfg, lcfg),
        jax.tree.map(lambda x: x + 0.5, jlora.init_lora(jax.random.PRNGKey(1), cfg, lcfg))])
    mixed = {"step": jnp.asarray(7, jnp.int32), "ids": jnp.arange(12, dtype=jnp.int32),
             "w": jnp.linspace(-1, 1, 24, dtype=jnp.float32).reshape(4, 6)}
    out = {"fp32": {"params": params}, "bf16": {"params": bf16},
           "int8": {"params": jquant.quantize_params(params)},
           "lora": {"lora": loras}, "mixed": mixed}
    return {k: (v, _bridge(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def trees():
    return _trees()


def _same(a, b) -> bool:
    """Same dtype, shape and bits (a: torch, b: torch)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _assert_bits(port_tree, jax_tree):
    """Every leaf of ``port_tree`` (torch) equals JAX's bit for bit."""
    tl, jl = flatten_with_path(port_tree), jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    for (_, t), (_, j) in zip(tl, jl):
        assert _same(t, tensor_of(j)), (t.dtype, j.dtype)


def tensor_of(arr):
    return params_from_numpy({"x": np.asarray(arr)}, "cpu")["x"]


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8", "lora", "mixed"])
def test_jax_checkpoint_restores_in_the_port_bit_for_bit(trees, name):
    jtree, ttree = trees[name]
    store = jstore.MemoryStore()
    jckpt.save_checkpoint(store, "runs/a", jtree, step=3)
    like = jax.tree.map(lambda t: torch.empty_like(t, device="meta"), ttree)
    got, step = tckpt.restore_checkpoint(store, "runs/a", like, device="cpu")
    assert step == 3
    _assert_bits(got, jtree)


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8", "lora", "mixed"])
def test_port_checkpoint_restores_in_jax_bit_for_bit(trees, name):
    jtree, ttree = trees[name]
    port, ref = tstore.MemoryStore(), jstore.MemoryStore()
    tckpt.save_checkpoint(port, "runs/b", ttree, step=5)
    jckpt.save_checkpoint(ref, "runs/b", jtree, step=5)
    # the same blob keys, the same bytes, the same manifest
    assert port.list() == ref.list()
    for key in ref.list():
        if key.endswith(".json"):
            assert json.loads(port.get(key)) == json.loads(ref.get(key))
        else:
            assert port.get(key) == ref.get(key), key
    got, step = jckpt.restore_checkpoint(port, "runs/b", jtree)
    assert step == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _mesh(shape):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, ("data", "model"))


@pytest.mark.parametrize("spec", [P("data", "model"), P(None, "model"), P("data", None), P()])
def test_mesh_sharded_jax_checkpoint_restores_whole(spec):
    """A tree saved sharded over the 8-device CPU mesh has several blobs a
    leaf; the port stitches each leaf whole."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    mesh = _mesh((2, 4))
    w = jnp.arange(8 * 16, dtype=jnp.float32).reshape(8, 16) / 7
    b = (jnp.arange(8 * 16).reshape(8, 16) % 251).astype(jnp.bfloat16)
    tree = {"w": jax.device_put(w, NamedSharding(mesh, spec)),
            "b": jax.device_put(b, NamedSharding(mesh, spec))}
    store = jstore.MemoryStore()
    jckpt.save_checkpoint(store, "runs/m", tree, step=1)
    shards = [k for k in store.list() if "/leaf-0/" in k]
    assert len(shards) == {P(): 1, P("data", None): 2, P(None, "model"): 4}.get(spec, 8)
    like = {"w": torch.empty((8, 16), device="meta"),
            "b": torch.empty((8, 16), dtype=torch.bfloat16, device="meta")}
    got, _ = tckpt.restore_checkpoint(store, "runs/m", like, device="cpu")
    assert _same(got["w"], tensor_of(w)) and _same(got["b"], tensor_of(b))


def test_missing_shard_refuses_and_falls_back():
    """A step whose shards do not cover a leaf does not restore; without an
    explicit step the newest complete one does."""
    store = tstore.MemoryStore()
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    tckpt.save_checkpoint(store, "p", tree, step=1)
    tckpt.save_checkpoint(store, "p", {"w": tree["w"] + 1}, step=2)
    store.delete("p/ckpt-000000000002/leaf-0/0-2_0-3")
    like = {"w": torch.empty(2, 3, device="meta")}
    with pytest.raises(tstore.BlobNotFound):
        tckpt.restore_checkpoint(store, "p", like, step=2, device="cpu")
    got, step = tckpt.restore_checkpoint(store, "p", like, device="cpu")
    assert step == 1 and torch.equal(got["w"], tree["w"])
    assert tckpt.latest_checkpoint_step(store, "p") == 2
    # the probe reads manifests only, as JAX's does: a lost blob under a
    # complete manifest shows only at restore
    assert tckpt.latest_restorable_checkpoint_step(store, "p") == 2
    assert jckpt.latest_restorable_checkpoint_step(store, "p") == 2
    # a manifest whose shards leave a leaf uncovered is skipped
    key = "p/ckpt-000000000002/manifest-00000.json"
    m = json.loads(store.get(key))
    m["leaves"][0]["shards"] = ["0-1_0-3"]
    store.put(key, json.dumps(m).encode())
    assert tckpt.latest_restorable_checkpoint_step(store, "p") == 1
    assert jckpt.latest_restorable_checkpoint_step(store, "p") == 1


def test_step_listings_and_pruning_match_jax():
    port, ref = tstore.MemoryStore(), jstore.MemoryStore()
    for step in (3, 10, 7, 12):
        tckpt.save_checkpoint(port, "q", {"x": torch.zeros(2)}, step=step, keep=3)
        jckpt.save_checkpoint(ref, "q", {"x": np.zeros(2, np.float32)}, step=step, keep=3)
    assert tckpt.checkpoint_steps(port, "q") == jckpt.checkpoint_steps(ref, "q") == [7, 10, 12]
    assert port.list() == ref.list()
    tckpt.delete_checkpoint(port, "q", 10)
    assert tckpt.checkpoint_steps(port, "q") == [7, 12]
    assert tckpt.latest_checkpoint_step(port, "q") == 12
    assert tckpt.latest_checkpoint_step(tstore.MemoryStore(), "q") is None
    with pytest.raises(tstore.BlobNotFound):
        tckpt.restore_checkpoint(tstore.MemoryStore(), "q", {"x": torch.zeros(2)})


def test_structure_mismatch_refused():
    store = tstore.MemoryStore()
    tckpt.save_checkpoint(store, "s", {"a": torch.zeros(2), "b": torch.zeros(3)}, step=1)
    with pytest.raises(tckpt.StorageMismatch, match="leaves"):
        tckpt.restore_checkpoint(store, "s", {"a": torch.zeros(2)}, step=1, device="cpu")
    with pytest.raises(tckpt.StorageMismatch, match="order"):
        tckpt.restore_checkpoint(store, "s", {"a": torch.zeros(2), "c": torch.zeros(3)},
                                 step=1, device="cpu")


def test_cooperative_manifests_union_and_shrink():
    """Two processes' manifests are unioned on restore; a re-save with a
    smaller world removes the departed process's manifest, as JAX's
    does."""
    store = tstore.MemoryStore()
    tree = {"x": torch.arange(4, dtype=torch.int32)}
    tckpt.save_checkpoint(store, "g", tree, step=1, process=0)
    tckpt.save_checkpoint(store, "g", tree, step=1, process=1)
    assert len(store.list("g/ckpt-000000000001/manifest-")) == 2
    got, _ = tckpt.restore_checkpoint(store, "g", tree, device="cpu")
    assert torch.equal(got["x"], tree["x"])
    tckpt.save_checkpoint(store, "g", tree, step=1, process=0, world=1)
    assert store.list("g/ckpt-000000000001/manifest-") == [
        "g/ckpt-000000000001/manifest-00000.json"]


def test_file_store_keys_and_bytes_match_jax(tmp_path, trees):
    """On disk too: the port's FileStore and JAX's hold the same files."""
    jtree, ttree = trees["int8"]
    tckpt.save_checkpoint(tstore.FileStore(str(tmp_path / "t")), "r", ttree, step=2)
    jckpt.save_checkpoint(jstore.FileStore(str(tmp_path / "j")), "r", jtree, step=2)
    a, b = tstore.FileStore(str(tmp_path / "t")), jstore.FileStore(str(tmp_path / "j"))
    assert a.list() == b.list()
    assert all(a.get(k) == b.get(k) for k in a.list() if not k.endswith(".json"))


def test_restore_template_on_meta_lands_on_the_target_device(trees):
    jtree, _ = trees["fp32"]
    store = jstore.MemoryStore()
    jckpt.save_checkpoint(store, "runs/c", jtree, step=1)
    like = {"params": tllama.init_params(tllama.llama_tiny(), torch.Generator(), "meta")}
    got, _ = tckpt.restore_checkpoint(store, "runs/c", like, device="cpu")
    assert all(t.device.type == "cpu" for _, t in flatten_with_path(got))
    _assert_bits(got, jtree)


def test_restored_tree_serves_the_bridged_trees_tokens(trees):
    """The restored tree and the bridged tree are the same weights: the
    engine gives the same tokens from both."""
    jtree, ttree = trees["fp32"]
    store = jstore.MemoryStore()
    jckpt.save_checkpoint(store, "runs/d", jtree, step=1)
    like = {"params": tllama.init_params(tllama.llama_tiny(), torch.Generator(), "meta")}
    restored = tckpt.restore_checkpoint(store, "runs/d", like, device="cpu")[0]["params"]
    prompt = np.random.default_rng(3).integers(0, 512, 20).tolist()
    outs = []
    for params in (restored, ttree["params"]):
        eng = ServingEngine(params, tllama.llama_tiny(), PagedConfig(num_blocks=32),
                            decode_horizon=2, dispatch_depth=1)
        eng.submit(prompt, 6)
        outs.append(eng.run()[0].output)
    assert outs[0] == outs[1]


class TestStores:
    """The port's stores behave as JAX's under the same calls."""

    @pytest.mark.parametrize("kind", ["memory", "file", "ssd"])
    def test_same_listing_and_refusals(self, tmp_path, kind):
        make = {"memory": (tstore.MemoryStore, jstore.MemoryStore),
                "file": (tstore.FileStore, jstore.FileStore),
                "ssd": (tstore.SliceLocalSSDStore, jstore.SliceLocalSSDStore)}[kind]
        args = () if kind == "memory" else (str(tmp_path / "t"),)
        jargs = () if kind == "memory" else (str(tmp_path / "j"),)
        t, j = make[0](*args), make[1](*jargs)
        for s in (t, j):
            s.put("a/b/c", b"123")
            s.put("a/d", b"4")
            s.delete("a/missing")
        assert t.list() == j.list() and t.list("a/b") == ["a/b/c"]
        assert t.exists("a/d") and not t.exists("zz")
        with pytest.raises(tstore.BlobNotFound):
            t.get("zz")
        assert t.provider == j.provider

    def test_ssd_budget_evicts_lru_and_spares_pins(self, tmp_path):
        evicted = []
        t = tstore.SliceLocalSSDStore(str(tmp_path / "t"), capacity_bytes=10,
                                      on_evict=evicted.append)
        j = jstore.SliceLocalSSDStore(str(tmp_path / "j"), capacity_bytes=10)
        for s in (t, j):
            s.pin_prefix("keep/")
            s.put("keep/x", b"aaaa")
            s.put("a", b"bbbb")
            s.get("a")
            s.put("b", b"cccc")
        assert t.list() == j.list() == ["b", "keep/x"] and evicted == ["a"]
        assert t.used_bytes() == j.used_bytes() == 8
        with pytest.raises(tstore.StorageError, match="exceeds"):
            t.put("big", b"x" * 11)
        # a reopened store rebuilds its accounting from disk
        assert tstore.SliceLocalSSDStore(str(tmp_path / "t"), capacity_bytes=10).used_bytes() == 8
