"""Build and load the hand-written CUDA kernels (``csrc/``); see
:mod:`bobrapet_tpu_torch.kernels.build`."""

from .build import KERNEL_DTYPES, check_launch, kernel_function, launch, library, refuse_grad

__all__ = ["KERNEL_DTYPES", "check_launch", "kernel_function", "launch", "library",
           "refuse_grad"]
