"""Normalization primitives (reference: seedx_tpu/ops/norms.py).

RMSNorm matches the reference LLaMA backbone's ``LlamaRMSNorm``: variance
in fp32, scale applied in the input dtype.  Plain torch.
"""

from __future__ import annotations

from typing import Callable, Optional

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
                          eps: float = 1e-5,
                          reduce: Optional[Callable] = None,
                          parts: int = 1) -> torch.Tensor:
    """GroupNorm over a channels-last tensor ([B, ..., C]) with fp32
    statistics and input-dtype output: mean and E[x^2] - mean^2 per (batch,
    group) over every spatial position and the group's channels, the
    affine in fp32.  The statistics are sums divided by the element count.
    With ``reduce`` (an in-place sum over the ranks holding the other
    ``parts - 1`` blocks of the spatial positions, e.g. latent rows split
    over a mesh axis) the fp32 sums of every rank are added before the
    division: the global statistics, from one collective.  Over one rank
    the sums come back unchanged, so a split of one part is the unsplit
    call bit for bit."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    sums = torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))])
    if reduce is not None:
        sums = reduce(sums)
    count = xf.shape[1] * xf.shape[3] * parts
    mean = (sums[0] / count)[:, None, :, None]
    var = (sums[1] / count)[:, None, :, None] - mean * mean
    normed = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (normed * scale.float() + bias.float()).to(dtype)
