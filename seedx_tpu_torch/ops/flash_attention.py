"""Flash-attention forward: CUDA kernel + its plain PyTorch version
(reference: seedx_tpu/ops/flash_attention.py, the Pallas kernel
``_flash_fwd_kernel``).

Kernel source and design note: ``seedx_tpu_torch/csrc/flash_fwd.cu``.
``flash_fwd`` launches the kernel for CUDA tensors and runs
``flash_fwd_plain`` for CPU tensors; there is no other fallback.  The
backward kernels (training) are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from seedx_tpu_torch.ops._build import check, load_library
from seedx_tpu_torch.ops.attention import NEG_INF

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"flash_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, ctypes.c_float, _P]}
HEAD_DIMS = (64, 128)


def library() -> ctypes.CDLL:
    return load_library("flash_fwd", "flash_fwd.cu", _SIGNATURES)


def flash_fwd_plain(q, k, v, starts, ends, q_offset: int, causal: bool,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain torch: fp32 scores from the scaled q,
    window + causal masks, p cast to the v dtype before PV, zero output and
    lse NEG_INF for fully masked rows.  Returns (out [B, Sq, H, D] in the q
    dtype, lse [B, H, 1, Sq] fp32)."""
    b, sq, _, _ = q.shape
    skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    k_pos = torch.arange(skv, device=q.device)
    mask = ((k_pos[None] >= starts[:, None])
            & (k_pos[None] < ends[:, None]))[:, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = mask & (q_pos[:, None] >= k_pos[None])[None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m == NEG_INF, 0.0, torch.exp(s - m))
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l_sum == 0.0, 1.0, l_sum)
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l_safe)).permute(0, 1, 3, 2)
    return out, lse


def flash_fwd(q, k, v, starts, ends, q_offset: int, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper: kernel for CUDA tensors, plain version for CPU tensors."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, starts, ends, q_offset, causal, scale)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_cuda:
            raise ValueError(f"flash_fwd: {name} must be a CUDA bf16 tensor,"
                             f" got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} must be contiguous and "
                             f"16-byte aligned")
        if t.device != q.device:
            raise ValueError("flash_fwd: q, k, v on different devices")
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim must be one of {HEAD_DIMS}")
    for name, t in (("starts", starts), ("ends", ends)):
        if (t.dtype != torch.int32 or t.shape != (b,) or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_fwd: {name} must be int32 [{b}] on "
                             f"{q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, skv, h, d,
        int(q_offset), int(bool(causal)), float(scale), stream)
    check(err, "flash_fwd_bf16")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    starts: Optional[torch.Tensor] = None,
                    ends: Optional[torch.Tensor] = None, q_offset=None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with a per-batch valid kv window (reference
    ``flash_attention``): q, k, v [batch, seq, heads, head_dim]; kv seq may
    exceed q seq (prefill into a preallocated cache); ``starts``/``ends``
    [batch] default to the whole kv; ``q_offset`` (int) is the kv position
    of q row 0, by default aligned to the kv tail."""
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
    out, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                       starts, ends, int(q_offset), causal, scale)
    return out
