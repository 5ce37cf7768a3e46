"""Normalization primitives (reference: seedx_tpu/ops/norms.py).

RMSNorm matches the reference LLaMA backbone's ``LlamaRMSNorm``: variance
in fp32, scale applied in the input dtype.  Plain torch.

The SDXL UNet's and VAE's GroupNorm (with the SiLU that follows it) and
LayerNorm also have CUDA kernels (``seedx_tpu_torch/csrc/norms.cu``, with
its design note): ``group_norm`` and ``layer_norm`` launch them for CUDA
tensors and run the plain versions ``group_norm_fp32_stats`` /
``layer_norm_fp32_stats`` for CPU tensors.  On CUDA each is an autograd
function: the kernel forward saves x (and GroupNorm's [2, B, G] sums), and
the backward is the closed-form gradient in plain torch
(``group_norm_backward`` / ``layer_norm_backward``), so adapter training
backpropagates through the kernels' forward.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from seedx_tpu_torch.ops._build import (launch, load_library, register,
                                     sm_count)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"group_norm_stats": [_P] * 3 + [_I] * 10 + [_P],
               "group_norm_apply": [_P] * 5 + [_I] * 10 + [_F, _I, _I, _P],
               "layer_norm_rows": [_P] * 4 + [_I, _I, _F, _I, _P]}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

GN_THREADS = 256      # the most threads of a GroupNorm block
GN_FILL = 4           # GroupNorm blocks an SM the plan aims for
GN_SLOTS = (1, 2, 4)  # 16-byte vectors a thread along the channels (built)
GN_SMEM = 48 * 1024   # the statistics block's shared memory, at most
MAX_SPLITS = 1024     # GroupNorm blocks a batch row, at most
LN_LANES = 16         # 16-byte vectors a lane of a LayerNorm row, at most
register("group_norm", "layer_norm")   # launch counters: one a call each


def library() -> ctypes.CDLL:
    return load_library("norms", "norms.cu", _SIGNATURES)


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


def gn_plan(batch: int, positions: int, channels: int, itemsize: int,
            sms: int):
    """(slots, tpr, rows, chunk, splits) of a GroupNorm launch over
    [batch, positions, channels].  A block's threads tile ``rows``
    positions x the channels in 16-byte vectors, ``tpr`` threads across a
    position, each covering ``slots`` vectors: up to GN_THREADS vectors a
    position, as many whole positions as fit in GN_THREADS threads, one
    vector a thread; above, one position, the vectors spread over the
    fewest slots (rounded up to a built count) and ``tpr`` a multiple of 32.
    Each block takes ``chunk`` positions (a multiple of ``rows``), so that
    the blocks number about GN_FILL an SM, at most MAX_SPLITS (``splits``)
    a batch row."""
    nvec = channels * itemsize // 16
    if nvec <= GN_THREADS:
        slots, tpr, rows = 1, nvec, GN_THREADS // nvec
    else:
        need = -(-nvec // GN_THREADS)
        slots = next((s for s in GN_SLOTS if s >= need), need)
        tpr = -(-(-(-nvec // need)) // 32) * 32
        rows = 1
    per_batch = min(max(1, -(-GN_FILL * sms // batch)), MAX_SPLITS)
    chunk = -(-positions // per_batch)
    chunk = -(-chunk // rows) * rows
    return slots, tpr, rows, chunk, -(-positions // chunk)


def _kernel_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 what: str):
    """x contiguous and the fp32 scale / bias, checked for the kernels:
    bf16 or fp32, channels a whole number of 16-byte vectors, every
    pointer 16-byte aligned and on x's device."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: x must be bf16 or fp32 on CUDA, got "
                         f"{x.dtype}")
    c = x.shape[-1]
    x = x.contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{what}: scale {tuple(scale.shape)} bias "
                         f"{tuple(bias.shape)} for {c} channels")
    if c * x.element_size() % 16:
        raise ValueError(f"{what}: {c} channels of {x.dtype} are not a "
                         f"whole number of 16-byte vectors")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned and "
                             f"on {x.device}")
    return x, scale, bias


def group_norm_backward(dy: torch.Tensor, x: torch.Tensor,
                        sums: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, count: int, eps: float,
                        silu: bool = False,
                        reduce: Optional[Callable] = None):
    """(dx, dscale, dbias) of ``group_norm`` from its input and its fp32
    [2, B, G] sums (after ``reduce``), in plain torch.  With ``silu`` the
    rounded norm is recomputed and SiLU's derivative taken there, rounded
    to x's type as the plain chain's ``F.silu`` backward does.  Then, with
    x^ = (x - mean) * r and g = dy * scale, dx = r * (g - mean(g) - x^ *
    mean(g * x^)) per (batch, group): the gradient of the plain function
    (its E[x^2] - mean^2 variance included).  ``reduce`` adds the two
    means' sums over the ranks holding the other row blocks, as in the
    forward; dscale and dbias are this rank's."""
    b, c = x.shape[0], x.shape[-1]
    groups = sums.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = (sums[0] / count)[:, None, :, None]
    var = (sums[1] / count)[:, None, :, None] - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    s = scale.float().reshape(groups, -1)
    dyf = dy.float().reshape(xf.shape)
    if silu:
        z = (xhat * s + bias.float().reshape(groups, -1)).to(x.dtype).float()
        sig = torch.sigmoid(z)
        dyf = (dyf * (sig * (1 + z * (1 - sig)))).to(x.dtype).float()
    g = dyf * s
    gsums = torch.stack([g.sum(dim=(1, 3)), (g * xhat).sum(dim=(1, 3))])
    if reduce is not None:
        gsums = reduce(gsums)
    gm = (gsums / count)[:, :, None, :, None]
    dx = (rstd * (g - gm[0] - xhat * gm[1])).reshape(x.shape).to(x.dtype)
    return (dx, (dyf * xhat).sum(dim=(0, 1)).reshape(c).to(scale.dtype),
            dyf.sum(dim=(0, 1)).reshape(c).to(bias.dtype))


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        eps: float):
    """(dx, dscale, dbias) of ``layer_norm`` in plain torch: the row's
    statistics recomputed from x as the plain function computes them, then
    dx = r * (g - mean(g) - x^ * mean(g * x^)) with g = dy * scale."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xf * xf, dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    dyf = dy.float()
    g = dyf * scale.float()
    dx = rstd * (g - g.mean(dim=-1, keepdim=True)
                 - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    rows = dyf.reshape(-1, x.shape[-1])
    return (dx.to(x.dtype),
            (rows * xhat.reshape(rows.shape)).sum(0).to(scale.dtype),
            rows.sum(0).to(bias.dtype))


def _group_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int, eps: float,
                       reduce: Optional[Callable], parts: int, silu: bool):
    """The GroupNorm kernel's launches: (y, x as launched, the [2, B, G]
    sums after ``reduce``, the count they are divided by)."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"group_norm: {c} channels in {num_groups} groups")
    x, scale, bias = _kernel_args(x, scale, bias, "group_norm")
    positions = x.numel() // max(1, b * c)
    count = positions * (c // num_groups) * parts
    if positions == 0:
        return (torch.empty_like(x), x, x.new_zeros((2, b, num_groups),
                                                    dtype=torch.float32), 1)
    slots, tpr, rows, chunk, splits = gn_plan(
        b, positions, c, x.element_size(), sm_count(x.device.index or 0))
    if slots not in GN_SLOTS or 8 * rows * c > GN_SMEM:
        raise ValueError(f"group_norm: {c} channels of {x.dtype} are more "
                         f"than a block takes")
    shape = (b, positions, c, num_groups, slots, tpr, rows, chunk, splits)
    part = torch.empty((b, splits, num_groups, 2), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((2, b, num_groups), dtype=torch.float32,
                       device=x.device)
    code = _DTYPES[x.dtype]
    launch(library(), "group_norm_stats", x.device, x.data_ptr(),
           part.data_ptr(), sums.data_ptr(), *shape, code)
    if reduce is not None:
        sums = reduce(sums).contiguous()
    y = torch.empty_like(x)
    launch(library(), "group_norm_apply", x.device,
           x.data_ptr(), y.data_ptr(), sums.data_ptr(), scale.data_ptr(),
           bias.data_ptr(), *shape, count, eps, int(silu), code,
           counts=("group_norm",))
    return y, x, sums, count


class _GroupNorm(torch.autograd.Function):
    """The kernel forward, ``group_norm_backward`` backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, reduce, parts, silu):
        y, xc, sums, count = _group_norm_kernel(x, scale, bias, num_groups,
                                                eps, reduce, parts, silu)
        ctx.save_for_backward(xc, sums, scale, bias)
        ctx.rest = (count, eps, silu, reduce)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, sums, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = group_norm_backward(dy, x, sums, scale, bias,
                                                *ctx.rest)
        need = ctx.needs_input_grad
        return (dx, dscale if need[1] else None, dbias if need[2] else None,
                None, None, None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               reduce: Optional[Callable] = None, parts: int = 1,
               silu: bool = False) -> torch.Tensor:
    """``group_norm_fp32_stats`` and, with ``silu``, SiLU on its rounded
    output (what ``F.silu`` of the plain output computes).  Wrapper: the
    kernel for CUDA tensors -- the statistics with their sum over blocks
    ([2, B, G] fp32), ``reduce`` on those sums, then the apply pass; one
    count a call; differentiable by ``group_norm_backward`` -- and the plain
    version for CPU tensors."""
    if not x.is_cuda:
        y = group_norm_fp32_stats(x, scale, bias, num_groups, eps, reduce,
                                  parts)
        return F.silu(y) if silu else y
    return _GroupNorm.apply(x, scale, bias, num_groups, eps, reduce, parts,
                            silu)



def _layer_norm_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float):
    """The LayerNorm kernel's launch: (y, x as launched)."""
    x, scale, bias = _kernel_args(x, scale, bias, "layer_norm")
    c = x.shape[-1]
    if c * x.element_size() > 32 * LN_LANES * 16:
        raise ValueError(f"layer_norm: {c} channels of {x.dtype} are more "
                         f"than a warp holds")
    y = torch.empty_like(x)
    if x.numel():
        launch(library(), "layer_norm_rows", x.device,
               x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               x.numel() // c, c, eps, _DTYPES[x.dtype],
               counts=("layer_norm",))
    return y, x


class _LayerNorm(torch.autograd.Function):
    """The kernel forward, ``layer_norm_backward`` backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, xc = _layer_norm_kernel(x, scale, bias, eps)
        ctx.save_for_backward(xc, scale, bias)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(dy, x, scale, bias, ctx.eps)
        need = ctx.needs_input_grad
        return (dx, dscale if need[1] else None, dbias if need[2] else None,
                None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``layer_norm_fp32_stats`` over the last dim.  Wrapper: the kernel
    (one launch, one warp a row; differentiable by ``layer_norm_backward``)
    for CUDA tensors, the plain version for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_fp32_stats(x, scale, bias, eps)
    return _LayerNorm.apply(x, scale, bias, eps)

