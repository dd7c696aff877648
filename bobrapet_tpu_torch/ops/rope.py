"""Rotary position embeddings (RoPE) for the Llama family.

Counterpart of ``bobrapet_tpu/ops/rope.py``: plain PyTorch, as the JAX
package leaves it to XLA (elementwise work that sits between matmuls).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device


def rope_frequencies(
    dim: int,
    max_seq_len: int,
    theta: float = 500_000.0,
    scaling: Optional[tuple[float, float, float, int]] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Rotation table ``[max_seq_len, dim//2, 2]`` of (cos, sin), fp32.

    ``scaling`` is the Llama-3.1 long-context frequency remap ``(factor,
    low_freq_factor, high_freq_factor, original_max_position_embeddings)``:
    wavelengths beyond the original context divide by ``factor``, short
    wavelengths stay, the band between interpolates smoothly.
    """
    device = resolve_device(device)
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if scaling is not None:
        factor, low_f, high_f, orig_len = scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = orig_len / low_f
        high_wavelen = orig_len / high_f
        smooth = (orig_len / wavelen - low_f) / (high_f - low_f)
        interpolated = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < high_wavelen,
            inv_freq,
            torch.where(wavelen > low_wavelen, inv_freq / factor, interpolated),
        )
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [S, dim/2]
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate q/k by split halves (not interleaved pairs), in fp32.

    x: [..., S, H, D]; freqs: [max_S, D/2, 2]; positions: [..., S] absolute
    positions (defaults to arange; pass real positions for decode).
    """
    seq_len = x.shape[-3]
    table = freqs[:seq_len] if positions is None else freqs[positions]
    cos = table[..., 0][..., :, None, :]  # [..., S, 1, D/2]
    sin = table[..., 1][..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)
