"""The SDXL UNet's Dense epilogues: what follows the projection's GEMM.

``bias_residual(y, bias, residual, scale)`` is ``[residual +] (y [* scale]
+ bias)`` (``scale``: the int8 ``Dense``'s per-column ``kernel_scale``);
``bias_geglu(y, bias, scale)`` is GEGLU over the biased projection, ``h *
F.gelu(gate)`` with ``h, gate`` its two halves.  Both have CUDA kernels
(``seedx_tpu_torch/csrc/epilogue.cu``, with its design note), one pass
each: the wrappers launch them for CUDA tensors and run the plain chains
``bias_residual_plain`` / ``bias_geglu_plain`` for CPU tensors.  The
kernels round where the chains round: ``bias_residual`` is bit-equal to
its chain, ``bias_geglu`` within one ULP (GELU's ``erff``).  On CUDA each
is an autograd function whose backward is the closed-form gradient in
plain torch (``bias_residual_backward`` / ``bias_geglu_backward``), so
adapter training backpropagates through the kernels' forward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from seedx_tpu_torch.ops._build import (launch, load_library, register,
                                     sm_count)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"bias_residual": [_P] * 5 + [_I] * 6 + [_P],
               "bias_geglu": [_P] * 4 + [_I] * 6 + [_P]}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

EP_THREADS = 256     # threads a block
EP_FILL = 4          # blocks an SM at most: one resident wave (kMinBlocks)
register("bias_residual", "bias_geglu")   # launch counters


def library() -> ctypes.CDLL:
    return load_library("epilogue", "epilogue.cu", _SIGNATURES)


def bias_residual_plain(y: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The chain the UNet's ``Dense`` ran: ``y * scale``, ``+ bias``, then
    ``residual +``, each a PyTorch elementwise op rounded to y's type."""
    if scale is not None:
        y = y * scale
    y = y + bias
    return y if residual is None else residual + y


def bias_geglu_plain(y: torch.Tensor, bias: torch.Tensor,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEGLU over the biased projection, as the UNet's ``GEGLU`` ran it."""
    h, gate = bias_residual_plain(y, bias, None, scale).chunk(2, dim=-1)
    return h * F.gelu(gate)


def ep_plan(rows: int, nvec: int, sms: int):
    """(tx, ty, row_blocks) of an epilogue launch over ``rows`` rows of
    ``nvec`` 16-byte vectors: a block of ``tx`` vectors across (the
    largest of 32, 16, 8 that divides ``nvec``, else 32 with the last
    strip ragged, or ``nvec`` below 32) by ``ty`` rows, EP_THREADS threads
    in all; ``row_blocks`` blocks down each strip, so that the grid is
    at most EP_FILL blocks an SM (one wave the SMs hold at once, no tail),
    never more than the rows need."""
    if nvec < 32:
        tx = nvec
    else:
        tx = next((t for t in (32, 16, 8) if nvec % t == 0), 32)
    ty = EP_THREADS // tx
    strips = -(-nvec // tx)
    row_blocks = min(-(-rows // ty), max(1, EP_FILL * sms // strips),
                     65535)
    return tx, ty, row_blocks


def _flat(t: torch.Tensor, what: str, name: str) -> torch.Tensor:
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return t


def _kernel_args(y: torch.Tensor, n: int, what: str, **vectors):
    """y contiguous and each of ``vectors`` (None, or [n] in y's type on
    y's device), checked for the kernels: bf16 or fp32, ``n`` columns a
    whole number of 16-byte vectors, every pointer 16-byte aligned."""
    if y.dtype not in _DTYPES:
        raise ValueError(f"{what}: y must be bf16 or fp32 on CUDA, got "
                         f"{y.dtype}")
    if n * y.element_size() % 16:
        raise ValueError(f"{what}: {n} columns of {y.dtype} are not a whole "
                         f"number of 16-byte vectors")
    out = [_flat(y, what, "y")]
    for name, t in vectors.items():
        if t is not None:
            if t.dtype != y.dtype or t.device != y.device:
                raise ValueError(f"{what}: {name} is {t.dtype} on "
                                 f"{t.device}, y {y.dtype} on {y.device}")
            t = _flat(t, what, name)
        out.append(t)
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _bias_residual_kernel(y, bias, residual, scale):
    n = y.shape[-1]
    if bias.shape != (n,) or (scale is not None and scale.shape != (n,)):
        raise ValueError(f"bias_residual: bias {tuple(bias.shape)} for {n} "
                         f"columns")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"bias_residual: residual {tuple(residual.shape)} "
                         f"for y {tuple(y.shape)}")
    y, bias, residual, scale = _kernel_args(
        y, n, "bias_residual", bias=bias, residual=residual, scale=scale)
    out = torch.empty_like(y)
    rows, nvec = y.numel() // n, n * y.element_size() // 16
    if rows:
        launch(library(), "bias_residual", y.device,
               y.data_ptr(), bias.data_ptr(), _ptr(scale), _ptr(residual),
               out.data_ptr(), rows, nvec,
               *ep_plan(rows, nvec, sm_count(y.device.index or 0)),
               _DTYPES[y.dtype], counts=("bias_residual",))
    return out


def bias_residual_backward(dy: torch.Tensor, y: Optional[torch.Tensor],
                           scale: Optional[torch.Tensor], need):
    """(dy_in, dbias, dresidual, dscale) of ``bias_residual`` in plain
    torch: the residual and the bias pass dy on (the bias summed over
    rows), the scale multiplies it, its own gradient is sum(dy * y).
    ``need``: which of (y, bias, residual, scale) want one."""
    n = dy.shape[-1]
    rows = dy.reshape(-1, n)
    return (None if not need[0] else dy if scale is None else dy * scale,
            rows.sum(0) if need[1] else None,
            dy if need[2] else None,
            (dy * y).reshape(-1, n).sum(0) if need[3] else None)


class _BiasResidual(torch.autograd.Function):
    """The kernel forward, ``bias_residual_backward`` backward."""

    @staticmethod
    def forward(ctx, y, bias, residual, scale):
        out = _bias_residual_kernel(y, bias, residual, scale)
        ctx.save_for_backward(None if scale is None else y, scale)
        return out

    @staticmethod
    def backward(ctx, dy):
        y, scale = ctx.saved_tensors
        return bias_residual_backward(dy, y, scale, ctx.needs_input_grad)


def bias_residual(y: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[residual +] (y [* scale] + bias)`` over the last dim (bias and
    scale [N], residual y's shape, all in y's type).  Wrapper: the kernel
    (one launch, one count; differentiable by ``bias_residual_backward``)
    for CUDA tensors, ``bias_residual_plain`` for CPU tensors."""
    if not y.is_cuda:
        return bias_residual_plain(y, bias, residual, scale)
    return _BiasResidual.apply(y, bias, residual, scale)



def _bias_geglu_kernel(y, bias, scale):
    n2 = y.shape[-1]
    if n2 % 2 or bias.shape != (n2,) or (scale is not None
                                         and scale.shape != (n2,)):
        raise ValueError(f"bias_geglu: bias {tuple(bias.shape)} for "
                         f"{n2} columns (two halves)")
    n = n2 // 2
    y, bias, scale = _kernel_args(y, n, "bias_geglu", bias=bias,
                                  scale=scale)
    out = y.new_empty(y.shape[:-1] + (n,))
    rows, nvec = y.numel() // n2, n * y.element_size() // 16
    if rows:
        launch(library(), "bias_geglu", y.device,
               y.data_ptr(), bias.data_ptr(), _ptr(scale), out.data_ptr(),
               rows, nvec, *ep_plan(rows, nvec, sm_count(y.device.index or 0)),
               _DTYPES[y.dtype], counts=("bias_geglu",))
    return out


def bias_geglu_backward(dy: torch.Tensor, y: torch.Tensor,
                        bias: torch.Tensor, scale: Optional[torch.Tensor],
                        need):
    """(dy_in, dbias, dscale) of ``bias_geglu`` in plain torch: the
    biased halves h, g recomputed as the forward rounds them, then d h =
    dy * gelu(g) and d g = dy * h * gelu'(g) (``gelu_backward``, what
    autograd through ``F.gelu`` takes), the bias's gradient their sum over
    rows, the scale's as in ``bias_residual_backward``."""
    h, g = bias_residual_plain(y, bias, None, scale).chunk(2, dim=-1)
    dv = torch.cat([dy * F.gelu(g),
                    torch.ops.aten.gelu_backward(dy * h, g)], dim=-1)
    dy_in, dbias, _, dscale = bias_residual_backward(
        dv, y, scale, (need[0], need[1], False, need[2]))
    return dy_in, dbias, dscale


class _BiasGeglu(torch.autograd.Function):
    """The kernel forward, ``bias_geglu_backward`` backward."""

    @staticmethod
    def forward(ctx, y, bias, scale):
        out = _bias_geglu_kernel(y, bias, scale)
        ctx.save_for_backward(y, bias, scale)
        return out

    @staticmethod
    def backward(ctx, dy):
        y, bias, scale = ctx.saved_tensors
        return bias_geglu_backward(dy, y, bias, scale, ctx.needs_input_grad)


def bias_geglu(y: torch.Tensor, bias: torch.Tensor,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h * F.gelu(gate)`` with ``h, gate`` the halves of ``y [* scale] +
    bias`` along the last dim ([..., 2F] -> [..., F]; bias and scale [2F]
    in y's type).  Wrapper: the kernel (one launch, one count;
    differentiable by ``bias_geglu_backward``) for CUDA tensors,
    ``bias_geglu_plain`` for CPU tensors."""
    if not y.is_cuda:
        return bias_geglu_plain(y, bias, scale)
    return _BiasGeglu.apply(y, bias, scale)

