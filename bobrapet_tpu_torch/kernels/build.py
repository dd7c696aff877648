"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source, all started together, and linked into one
``libbobra_kernels.so`` with a plain C interface that ``ctypes`` loads.
The sources include no PyTorch header, so a build takes seconds.

The library lands in ``build/kernels/<hash>/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.
Nothing here runs at import: the first call to :func:`library` builds.
A missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libbobra_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: element-type codes of the C interface (``csrc/common.cuh``)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_functions: dict[str, ctypes._CFuncPtr] = {}
#: nvcc's output of the build this process loaded (read back when reused)
build_log = ""


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (or reuse) the library; returns its path."""
    global build_log
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        log = out_dir / "build.log"
        build_log = log.read_text() if log.exists() else ""
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a private directory and rename into place, so processes
    # building at once (test workers) never load a half-written library
    work = Path(tempfile.mkdtemp(dir=out_dir, prefix="tmp-"))
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(work / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        build_log = "\n".join(logs)
        (work / "build.log").write_text(build_log)
        os.replace(work / "build.log", out_dir / "build.log")
        os.replace(work / LIB_NAME, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def kernel_function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """One C entry point with its signature declared; every entry point
    returns the ``cudaError_t`` of its launch as an int."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def launch(fn: ctypes._CFuncPtr, device_index: int, *args) -> int:
    """Call a C entry point with ``args`` and then the raw handle of the
    current stream of card ``device_index``: no ``torch.Stream`` is built,
    and the card is entered only when it is not already the current one.
    Returns the entry's ``cudaError_t``."""
    if device_index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    with torch.cuda.device(device_index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))


def refuse_grad(name: str, *tensors) -> None:
    """A kernel wrapper that autograd cannot see refuses a tensor that
    requires grad while grad is enabled: its output would have no
    ``grad_fn``, and a backward through it would quietly give no gradient
    to anything before it. Checked before the device, so the CPU sees it."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and autograd cannot see this kernel; "
            "call it under torch.no_grad(), or through the op that carries its "
            "backward (ops.attention, ops.rmsnorm, ops.add_rmsnorm)")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
