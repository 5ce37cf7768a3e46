"""Flash attention, forward and backward: CUDA kernels + their plain
PyTorch versions (reference: seedx_tpu/ops/flash_attention.py, the Pallas
kernels ``_flash_fwd_kernel`` (K1), ``_flash_bwd_dq_kernel`` (K4) and
``_flash_bwd_dkv_kernel`` (K5)).

Kernel sources and design notes: ``seedx_tpu_torch/csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``, which share the memory and ``wgmma`` helpers
of ``csrc/flash_common.cuh``.  Each wrapper launches its kernel for CUDA
tensors and runs the plain version for CPU tensors; there is no other
fallback.  ``FlashAttention`` is the autograd function around them (the
JAX package's ``custom_vjp``): its forward is K1, which saves the row
logsumexp, and its backward computes ``delta = rowsum(dO * O)`` in fp32
torch outside the kernels, then runs K4 and K5.  ``flash_attention`` goes
through it, so every flash call is differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from seedx_tpu_torch.ops._build import (launch, load_library, register,
                                     sm_count)
from seedx_tpu_torch.ops.attention import NEG_INF

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"flash_fwd_bf16": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I,
                                                         _I, _P],
               "flash_wgmma_tile_debug": [_P] * 5 + [_I, _P]}
_BWD_SIGNATURES = {
    "flash_bwd_dq_bf16": [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _I, _P],
    "flash_bwd_dkv_bf16": [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _I,
                                                  _P]}
HEAD_DIMS = (64, 128)
# K1's block tiles (q rows, keys) by head dim: the kernels csrc/flash_fwd.cu
# builds, exactly the ones ``tile_shape`` picks
TILES = {128: ((128, 128), (64, 128), (64, 64)), 64: ((64, 128), (64, 64))}
# K4's and K5's block tiles (q rows, keys) by head dim: the kernels
# csrc/flash_bwd.cu builds, exactly the ones ``bwd_tile_shape`` picks.  K4
# holds its q rows (64 a warpgroup) and streams keys; K5 holds its keys (64
# a warpgroup) and streams q rows
BWD_TILES = {128: {"dq": ((64, 64),), "dkv": ((64, 64),)},
             64: {"dq": ((64, 64),), "dkv": ((64, 64),)}}
register("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")   # launch counters


def library() -> ctypes.CDLL:
    return load_library("flash_fwd", "flash_fwd.cu", _SIGNATURES)


def bwd_library() -> ctypes.CDLL:
    return load_library("flash_bwd", "flash_bwd.cu", _BWD_SIGNATURES)


def _window_mask(starts, ends, sq: int, skv: int, q_offset: int,
                 causal: bool, device) -> torch.Tensor:
    """[B, 1, Sq, Skv] bool: key in the row's window, and (causal) at or
    before the query's kv position ``q_offset + i``."""
    k_pos = torch.arange(skv, device=device)
    mask = ((k_pos[None] >= starts[:, None])
            & (k_pos[None] < ends[:, None]))[:, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(sq, device=device)
        mask = mask & (q_pos[:, None] >= k_pos[None])[None, None]
    return mask


def flash_fwd_plain(q, k, v, starts, ends, q_offset: int, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain torch: fp32 scores from the scaled q,
    window + causal masks, p cast to the v dtype before PV, zero output and
    lse NEG_INF for fully masked rows.  Returns (out [B, Sq, H, D] in the q
    dtype, lse [B, H, 1, Sq] fp32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    mask = _window_mask(starts, ends, q.shape[1], k.shape[1], q_offset,
                        causal, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m == NEG_INF, 0.0, torch.exp(s - m))
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l_safe)).permute(0, 1, 3, 2)
    return out, lse


def _check_inputs(what: str, tensors, starts, ends, b: int, sq: int,
                  skv: int, h: int, d: int) -> None:
    """The kernels' contract: CUDA bf16 (fp32 for lse / delta) tensors,
    contiguous and 16-byte aligned, of the expected shapes, on one device;
    head_dim in ``HEAD_DIMS``; int32 [B] windows."""
    dev = tensors[0][1].device
    for name, t in tensors:
        want = (torch.float32 if name in ("lse", "delta") else torch.bfloat16)
        if t.dtype != want or not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA {want} tensor, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned")
        if t.device != dev:
            raise ValueError(f"{what}: inputs on different devices")
        shape = {"k": (b, skv, h, d), "v": (b, skv, h, d),
                 "lse": (b, h, 1, sq), "delta": (b, h, 1, sq)}.get(
                     name, (b, sq, h, d))
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"want {shape}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim must be one of {HEAD_DIMS}")
    for name, t in (("starts", starts), ("ends", ends)):
        if (t.dtype != torch.int32 or t.shape != (b,) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be int32 [{b}] on {dev}")


def tile_shape(b: int, sq: int, h: int, d: int, causal: bool,
               sms: int) -> Tuple[int, int]:
    """K1's block tile, (q rows, keys): 128 keys a tile where no causal
    diagonal cuts the tiles (the ViT, the UNet), 64 where one does (prefill,
    the chunk, training); 128 q rows (two warpgroups) only at D 128 and only
    where the grid at 128 rows still covers every SM.  Chosen from the
    kernel's times on the H100 (``flash_sweep.py``, PERF.md), not a user
    knob."""
    if causal:
        return 64, 64
    return (128 if d == 128 and -(-sq // 128) * h * b >= sms else 64), 128


def bwd_tile_shape(b: int, sq: int, skv: int, h: int, d: int, causal: bool,
                   sms: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """K4's and K5's block tiles, each (q rows, keys): one warpgroup of 64
    rows (K4) or keys (K5) streaming 64-wide tiles of the other, at every
    shape.  Chosen from the kernels' times on the H100 (``flash_sweep.py
    --bwd``, PERF.md): two warpgroups a block (128 q rows for K4, 128 keys
    for K5) and 128-wide streamed tiles were no faster at any main-path
    shape, causal or not, and slower at the train step's."""
    return (64, 64), (64, 64)


def flash_fwd(q, k, v, starts, ends, q_offset: int, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper: kernel for CUDA tensors, plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, starts, ends, q_offset, causal, scale)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check_inputs("flash_fwd", (("q", q), ("k", k), ("v", v)), starts, ends,
                  b, sq, skv, h, d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    launch(library(), "flash_fwd_bf16", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(),
           ends.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, skv, h, d,
           int(q_offset), int(bool(causal)), float(scale),
           *tile_shape(b, sq, h, d, causal, sm_count(q.device.index or 0)),
           counts=("flash_fwd",))
    return out, lse


def wgmma_tile_debug(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash kernels' wgmma descriptors (``csrc/flash_common.cuh``:
    K1, K4 and K5 run every product through them) on one tile, for the
    card's tests: q, k, v [64, D] bf16 CUDA -> (s = q k^T [64, 64], o =
    bf16(s) v [64, D]), both fp32 accumulators as the kernel holds them.
    Not on any path."""
    d = q.shape[-1]
    for t in (q, k, v):
        if (t.shape != (64, d) or t.dtype != torch.bfloat16 or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError("wgmma_tile_debug: q, k, v must be contiguous "
                             "CUDA bf16 [64, D]")
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty((64, d), dtype=torch.float32, device=q.device)
    launch(library(), "flash_wgmma_tile_debug", q.device, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), d)
    return s, o


def flash_bwd_plain(q, k, v, do, lse, delta, starts, ends, q_offset: int,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' contract in plain torch, fp32 throughout as
    the TPU kernels compute (seedx_tpu/ops/flash_attention.py:264-351):
    p = exp(s * scale - lse) under the EXPLICIT window / causal mask (not a
    bias: a fully masked row has lse = NEG_INF, where exp(s - lse) would be
    1), ds = p * (dp - delta) * scale.  lse, delta [B, H, 1, Sq] fp32.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _window_mask(starts, ends, q.shape[1], k.shape[1], q_offset,
                        causal, q.device)
    lse_c = lse.permute(0, 1, 3, 2)                        # [B, H, Sq, 1]
    p = torch.where(mask, torch.exp(s - lse_c), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.permute(0, 1, 3, 2)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(what, q, k, v, do, lse, delta, starts, ends,
              causal):
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check_inputs(what, (("q", q), ("k", k), ("v", v), ("do", do),
                         ("lse", lse), ("delta", delta)), starts, ends,
                  b, sq, skv, h, d)
    tiles = bwd_tile_shape(b, sq, skv, h, d, causal,
                           sm_count(q.device.index or 0))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), starts.data_ptr(),
            ends.data_ptr()), (b, sq, skv, h, d), tiles


def flash_bwd_dq(q, k, v, do, lse, delta, starts, ends, q_offset: int,
                 causal: bool, scale: float) -> torch.Tensor:
    """K4 wrapper: dq [B, Sq, H, D]; the plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, lse, delta, starts, ends,
                               q_offset, causal, scale)[0]
    ptrs, dims, tiles = _bwd_args("flash_bwd_dq", q, k, v, do, lse, delta,
                                  starts, ends, causal)
    dq = torch.empty_like(q)
    launch(bwd_library(), "flash_bwd_dq_bf16", q.device,
           *ptrs, dq.data_ptr(), *dims, int(q_offset), int(bool(causal)),
           float(scale), *tiles[0], counts=("flash_bwd_dq",))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, starts, ends, q_offset: int,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper: (dk, dv) [B, Skv, H, D]; the plain version for CPU
    tensors."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, lse, delta, starts, ends,
                               q_offset, causal, scale)[1:]
    ptrs, dims, tiles = _bwd_args("flash_bwd_dkv", q, k, v, do, lse, delta,
                                  starts, ends, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch(bwd_library(), "flash_bwd_dkv_bf16", q.device,
           *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, int(q_offset),
           int(bool(causal)), float(scale), *tiles[1],
           counts=("flash_bwd_dkv",))
    return dk, dv


def flash_bwd(q, k, v, do, lse, delta, starts, ends, q_offset: int,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): K4 then K5 for CUDA tensors, the plain version for CPU
    tensors."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, lse, delta, starts, ends,
                               q_offset, causal, scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, starts, ends, q_offset,
                      causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, starts, ends, q_offset,
                           causal, scale)
    return dq, dk, dv


def row_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, 1, Sq] (reference
    flash_attention.py:481)."""
    delta = (do.float() * out.float()).sum(dim=-1)          # [B, Sq, H]
    return delta.permute(0, 2, 1)[:, :, None, :].contiguous()


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (reference ``_flash`` custom_vjp):
    forward K1, backward K4 + K5 from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, starts, ends, q_offset: int, causal: bool,
                scale: float):
        out, lse = flash_fwd(q, k, v, starts, ends, q_offset, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, starts, ends)
        ctx.args = (q_offset, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, starts, ends = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, do, lse, row_delta(do, out), starts,
                               ends, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    starts: Optional[torch.Tensor] = None,
                    ends: Optional[torch.Tensor] = None, q_offset=None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with a per-batch valid kv window (reference
    ``flash_attention``): q, k, v [batch, seq, heads, head_dim]; kv seq may
    exceed q seq (prefill into a preallocated cache); ``starts``/``ends``
    [batch] default to the whole kv; ``q_offset`` (int) is the kv position
    of q row 0, by default aligned to the kv tail.  Differentiable in q, k
    and v through ``FlashAttention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, q_len = q.shape[:2]
    kv_len = k.shape[1]
    dev = q.device
    starts = (torch.zeros((b,), dtype=torch.int32, device=dev)
              if starts is None else starts.to(dev, torch.int32).contiguous())
    ends = (torch.full((b,), kv_len, dtype=torch.int32, device=dev)
            if ends is None else ends.to(dev, torch.int32).contiguous())
    if q_offset is None:
        q_offset = kv_len - q_len
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), starts, ends, int(q_offset),
                                causal, float(scale))
