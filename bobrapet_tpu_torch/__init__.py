"""bobrapet_tpu_torch: the PyTorch/CUDA port of bobrapet_tpu's compute plane.

A package of its own beside ``bobrapet_tpu`` (the JAX reference, which it
never imports). Plain tensor code is PyTorch; the TPU's Pallas kernels
become kernels written by hand for Hopper (``csrc/``, built on first use
by :mod:`bobrapet_tpu_torch.kernels`). Entry points run on the first CUDA
card unless the caller passes ``device="cpu"``, which takes the kernels'
plain PyTorch versions.
"""

from . import graphs, models, ops, serving
from .device import resolve_device

__all__ = ["graphs", "models", "ops", "resolve_device", "serving"]
