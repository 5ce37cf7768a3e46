"""Rotary position embeddings (reference: seedx_tpu/ops/rope.py).

Half-split rotate, theta base 10000, computed on the fly in fp32.

DeepSeek-V2's YaRN scaling (``DeepseekV2YarnRotaryEmbedding`` in its
``modeling_deepseek.py``; the JAX package has none): ``yarn_inv_freq``
ramps each frequency between its extrapolated value ``theta^(-2i/d)`` and
its interpolated one (that over ``factor``) across the dims between the
correction dims of ``beta_fast`` and ``beta_slow``; cos and sin are scaled
by ``yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)``
and the attention's softmax scale by ``yarn_mscale(factor,
mscale_all_dim) ** 2``.  DeepSeek-V2 ropes its 64-wide q / k parts after a
de-interleave (``deinterleave``: the even channels, then the odd), then
the same half-split rotate.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0,
                 inv_freq: Optional[torch.Tensor] = None,
                 mscale: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim] (fp32) for integer positions [...];
    ``inv_freq`` [head_dim // 2] replaces theta's, ``mscale`` scales
    both tables."""
    if inv_freq is None:
        exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                                device=positions.device) / head_dim
        inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    if mscale != 1.0:
        return torch.cos(angles) * mscale, torch.sin(angles) * mscale
    return torch.cos(angles), torch.sin(angles)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """``0.1 * mscale * ln(factor) + 1`` (1 at factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(dim: int, theta: float, original_max: int,
                          beta_fast: float, beta_slow: float
                          ) -> Tuple[int, int]:
    """(low, high): the dims whose wavelengths turn ``beta_fast`` and
    ``beta_slow`` times over ``original_max`` positions, floored / ceiled
    and clamped to [0, dim - 1]."""
    def dim_of(turns):
        return (dim * math.log(original_max / (turns * 2 * math.pi))
                / (2 * math.log(theta)))

    return (max(math.floor(dim_of(beta_fast)), 0),
            min(math.ceil(dim_of(beta_slow)), dim - 1))


def yarn_inv_freq(dim: int, theta: float, factor: float, original_max: int,
                  beta_fast: float, beta_slow: float,
                  device=None) -> torch.Tensor:
    """fp32 [dim // 2]: ``f_inter * (1 - m) + f_extra * m`` with
    ``f_extra = theta^(-2i/dim)``, ``f_inter = f_extra / factor`` and ``m
    = 1 - clamp((i - low) / (high - low), 0, 1)``."""
    low, high = yarn_correction_range(dim, theta, original_max, beta_fast,
                                      beta_slow)
    f_extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                           device=device) / dim)
    f_inter = f_extra / factor
    span = (high - low) if high != low else 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / span, 0.0, 1.0)
    m = 1.0 - ramp
    return f_inter * (1.0 - m) + f_extra * m


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d] -> the even channels, then the odd (DeepSeek-V2's
    ``view(..., d // 2, 2).transpose(-1, -2)``)."""
    d = x.shape[-1]
    return x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)


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
