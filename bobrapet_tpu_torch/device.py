"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the first CUDA card; anything else is taken as given.

    There is no quiet CPU fallback: without a card, ``None`` raises, and a
    caller that wants the CPU (the tests) says ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bobrapet_tpu_torch runs on a CUDA card and none is visible; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return torch.device("cuda", 0)
