"""Attention dispatch: plain path + the hand-written flash kernel
(reference: seedx_tpu/ops/attention.py).

Layout everywhere: ``[batch, seq, heads, head_dim]``.

``impl``:
  * ``"plain"`` - einsum + fp32 softmax, any device (the JAX package's
    ``"xla"`` path).
  * ``"flash"`` - ``ops/flash_attention.flash_attention``: the CUDA kernel
    for a CUDA tensor, its plain version for a CPU tensor.
  * ``"auto"``  - flash for a CUDA bf16 tensor with q_len > 1, no bias and a
    scalar ``q_offset`` (or q_len == kv_len); plain otherwise.  Decode
    (q_len 1) stays plain, as it does in the JAX package at batch 1.  The
    JAX package's ``q_len >= 128`` floor is a TPU tile choice and is
    dropped: the kernel masks ragged sequence edges itself, so the 65-token
    forced image chunk takes the kernel too.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_bias(kv_valid: Optional[torch.Tensor], q_len: int,
                        kv_len: int, causal: bool, dtype=torch.float32,
                        q_offset=None, device=None) -> Optional[torch.Tensor]:
    """Additive bias [batch|1, 1, q_len, kv_len] from a kv validity mask.

    kv_valid: [batch, kv_len] bool (True = attend) or None.  Causal: query
    row i sits at kv position ``q_offset + i`` (default: aligned to the kv
    tail); ``q_offset`` may be an int or a [batch] tensor.
    """
    if device is None and kv_valid is not None:
        device = kv_valid.device
    bias = None
    if causal:
        if q_offset is None:
            q_offset = kv_len - q_len
        k_pos = torch.arange(kv_len, device=device)[None, :]
        if torch.is_tensor(q_offset) and q_offset.dim() == 1:
            q_pos = (torch.arange(q_len, device=device)[None, :]
                     + q_offset.to(device)[:, None])          # [batch, q]
            mask = q_pos[:, :, None] >= k_pos[None]           # [batch, q, kv]
            bias = torch.where(mask, 0.0, NEG_INF)[:, None].to(dtype)
        else:
            q_pos = torch.arange(q_len, device=device)[:, None] + int(q_offset)
            bias = torch.where(q_pos >= k_pos, 0.0,
                               NEG_INF)[None, None].to(dtype)
    if kv_valid is not None:
        pad = torch.where(kv_valid[:, None, None, :], 0.0, NEG_INF).to(dtype)
        bias = pad if bias is None else bias + pad
    return bias


def plain_attention(q, k, v, bias, scale):
    """fp32 logits and softmax; probs cast to the v dtype before PV
    (reference ``_xla_attention``, seedx_tpu/ops/attention.py:68-75)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _use_flash(q, kv_len, bias, q_offset) -> bool:
    q_len = q.shape[1]
    return (q.is_cuda and q.dtype == torch.bfloat16 and bias is None
            and q_len > 1
            and (q_len == kv_len or q_offset is not None)
            and not (torch.is_tensor(q_offset) and q_offset.dim() == 1))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, bias: Optional[torch.Tensor] = None,
                          kv_valid: Optional[torch.Tensor] = None,
                          causal: bool = False, scale: Optional[float] = None,
                          impl: str = "auto", q_offset=None) -> torch.Tensor:
    """Multi-head attention; k/v may have fewer (grouped) heads than q."""
    b, q_len, heads, head_dim = q.shape
    kv_len, kv_heads = k.shape[1], k.shape[2]
    if kv_heads != heads:
        rep = heads // kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    if scale is None:
        scale = head_dim ** -0.5
    if impl not in ("auto", "plain", "flash"):
        raise ValueError(f"impl must be auto|plain|flash, got {impl!r}")
    use_flash = impl == "flash" or (
        impl == "auto" and _use_flash(q, kv_len, bias, q_offset))
    if use_flash:
        from seedx_tpu_torch.ops.flash_attention import flash_attention

        starts = ends = None
        if kv_valid is not None:
            # kv_valid is one contiguous window in every caller
            m = kv_valid.to(torch.int32)
            starts = torch.argmax(m, dim=-1).to(torch.int32)
            ends = (starts + m.sum(dim=-1)).to(torch.int32)
        # the kernel takes head dims 64 and 128: zero-pad others (ViT-bigG's
        # 104 -> 128); padded q/k channels leave the logits unchanged and
        # padded v channels are sliced away
        pad = (64 if head_dim <= 64 else 128) - head_dim
        if pad < 0:
            raise ValueError(f"flash attention takes head_dim <= 128, "
                             f"got {head_dim}")
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, pad))
                       for t in (q, k, v))
        out = flash_attention(q, k, v, starts=starts, ends=ends,
                              q_offset=q_offset, causal=causal, scale=scale)
        return out[..., :head_dim] if pad else out

    full_bias = bias
    extra = make_attention_bias(kv_valid, q_len, kv_len, causal,
                                q_offset=q_offset, device=q.device)
    if extra is not None:
        full_bias = extra if full_bias is None else full_bias + extra
    return plain_attention(q, k, v, full_bias, scale)
