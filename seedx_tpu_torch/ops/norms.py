"""Normalization primitives (reference: seedx_tpu/ops/norms.py).

RMSNorm matches the reference LLaMA backbone's ``LlamaRMSNorm``: variance
in fp32, scale applied in the input dtype.  Plain torch.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return weight * normed.to(dtype)


def layer_norm_fp32_stats(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5
                          ) -> torch.Tensor:
    """LayerNorm with fp32 statistics and input-dtype output."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xf * xf, dim=-1, keepdim=True) - mean * mean
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = normed * scale.float() + bias.float()
    return out.to(dtype)


def group_norm_fp32_stats(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, num_groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over a channels-last tensor ([B, ..., C]) with fp32
    statistics and input-dtype output: mean and E[x^2] - mean^2 per (batch,
    group) over every spatial position and the group's channels, the
    affine in fp32."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    normed = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (normed * scale.float() + bias.float()).to(dtype)
