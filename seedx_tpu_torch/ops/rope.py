"""Rotary position embeddings (reference: seedx_tpu/ops/rope.py).

Half-split rotate, theta base 10000, computed on the fly in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim] (fp32) for integer positions [...]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [batch, seq, heads, head_dim]; cos/sin [batch, seq, head_dim] or
    [seq, head_dim]."""
    if cos.dim() == x.dim() - 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
