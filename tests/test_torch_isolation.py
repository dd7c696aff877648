"""The port stands alone: it imports neither jax nor bobrapet_tpu, its
entry points default to the card, and its kernel wrappers never compute
on a device they were not written for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bobrapet_tpu_torch import resolve_device
from bobrapet_tpu_torch.ops import (
    attention,
    flash_attention_cuda,
    paged_attention,
    paged_attention_cuda,
    rmsnorm,
    rmsnorm_cuda,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bobrapet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "attention_sweep.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "bobrapet_tpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, bobrapet_tpu_torch, bobrapet_tpu_torch.kernels.build, "
        "bobrapet_tpu_torch.models.bridge, bobrapet_tpu_torch.serving\n"
        "print('\\n'.join(sorted(sys.modules)))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "bobrapet_tpu_torch.models.llama" in loaded
    assert "bobrapet_tpu_torch.serving.engine" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []


def test_resolve_device_defaults_to_the_card():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_entry_points_without_device_need_the_card():
    from bobrapet_tpu_torch.models import init_cache, llama_tiny

    if torch.cuda.is_available():
        assert init_cache(llama_tiny(), 1, 4)[0]["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            init_cache(llama_tiny(), 1, 4)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("fn", [rmsnorm, rmsnorm_cuda])
def test_rmsnorm_refuses_a_meta_tensor(fn):
    with pytest.raises(ValueError):
        fn(_meta(4, 32), _meta(32))


@pytest.mark.parametrize("fn", [attention, flash_attention_cuda])
def test_attention_refuses_a_meta_tensor(fn):
    q, kv = _meta(1, 4, 2, 32), _meta(1, 4, 1, 32)
    with pytest.raises(ValueError):
        fn(q, kv, kv)


@pytest.mark.parametrize("fn", [paged_attention, paged_attention_cuda])
def test_paged_attention_refuses_a_meta_tensor(fn):
    q, pool = _meta(2, 4, 32), _meta(8, 4, 2, 32)
    tables, lens = torch.zeros(2, 3, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fn(q, pool, pool, tables, lens)


def test_engine_without_device_needs_the_card():
    from bobrapet_tpu_torch.serving.paged_cache import PagedConfig, init_pools
    from bobrapet_tpu_torch.models import llama_tiny

    if torch.cuda.is_available():
        assert init_pools(llama_tiny(), PagedConfig(num_blocks=4))["k"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            init_pools(llama_tiny(), PagedConfig(num_blocks=4))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.ones(2, 32)
    with pytest.raises(ValueError):
        rmsnorm_cuda(x, torch.ones(32))
    q, kv = torch.ones(1, 4, 2, 32), torch.ones(1, 4, 1, 32)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, kv, kv)
    q, pool = torch.ones(2, 4, 32), torch.ones(8, 4, 2, 32)
    tables, lens = torch.zeros(2, 3, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_attention_cuda(q, pool, pool, tables, lens)
