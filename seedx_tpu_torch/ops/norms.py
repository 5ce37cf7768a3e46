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
