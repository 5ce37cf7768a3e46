"""Qwen-style attention-pool Resampler (reference:
seedx_tpu/models/resampler.py; src/models/tokenizer/qwen_visual.py:94-149).

One cross-attention layer pooling a variable-length token set onto
``grid_size**2`` learned queries with fixed 2D sincos position embeddings,
resized with torch's bicubic kernel when the kv grid differs.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from seedx_tpu_torch.models.layers import PDense, PLayerNorm, TorchMHA


def sincos_2d_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """2D sincos table [grid_size**2, embed_dim] (reference:
    seedx_tpu/models/resampler.py:30-49, qwen_visual.py:44-91); the first
    half encodes the w meshgrid, the second the h meshgrid."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim must be a multiple of 4: {embed_dim}")
    pos = np.arange(grid_size, dtype=np.float32)
    grid_w, grid_h = np.meshgrid(pos, pos)

    def embed_1d(dim, coords):
        omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", coords.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([embed_1d(embed_dim // 2, grid_w),
                           embed_1d(embed_dim // 2, grid_h)], axis=1)


def _torch_bicubic_matrix(src: int, tgt: int) -> np.ndarray:
    """[tgt, src] matrix reproducing ``F.interpolate(mode="bicubic",
    align_corners=False)`` on one axis: a = -0.75 cubic kernel at half-pixel
    centers, edge-clamped taps, no antialias (reference:
    seedx_tpu/models/resampler.py:52-79)."""
    a = -0.75

    def k(d):
        d = abs(d)
        if d <= 1.0:
            return (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
        if d < 2.0:
            return a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a
        return 0.0

    scale = src / tgt
    w = np.zeros((tgt, src), np.float64)
    for i in range(tgt):
        x = (i + 0.5) * scale - 0.5
        x0 = math.floor(x)
        t = x - x0
        for j, d in ((x0 - 1, t + 1.0), (x0, t), (x0 + 1, 1.0 - t),
                     (x0 + 2, 2.0 - t)):
            w[i, min(max(j, 0), src - 1)] += k(d)
    return w.astype(np.float32)


def resize_pos_embed(pos: torch.Tensor, tgt_tokens: int) -> torch.Tensor:
    """Resize a square [src_tokens, dim] table to [tgt_tokens, dim]
    (reference ``get_abs_pos``: torch bicubic, align_corners=False), as one
    fp32 matmul per axis."""
    src = math.isqrt(pos.shape[0])
    tgt = math.isqrt(tgt_tokens)
    if src == tgt:
        return pos
    grid = pos.reshape(src, src, -1).float()
    w = torch.from_numpy(_torch_bicubic_matrix(src, tgt)).to(pos.device)
    rows = torch.einsum("ts,shc->thc", w, grid)
    out = torch.einsum("ts,hsc->htc", w, rows)
    return out.reshape(tgt * tgt, -1).to(pos.dtype)


class Resampler(nn.Module):
    """Cross-attention pooling: [batch, n_tokens, kv_dim] ->
    [batch, grid_size**2, embed_dim]."""

    def __init__(self, grid_size: int, embed_dim: int, num_heads: int,
                 kv_dim: Optional[int] = None, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.num_queries = grid_size ** 2
        self.embed_dim = embed_dim
        self.register_buffer("query", torch.zeros(
            (self.num_queries, embed_dim), dtype=dtype, device=device))
        self.register_buffer("pos", torch.from_numpy(
            sincos_2d_pos_embed(embed_dim, grid_size)).to(device, dtype),
            persistent=False)
        self.kv_proj = None
        if kv_dim is not None and kv_dim != embed_dim:
            self.kv_proj = PDense(kv_dim, embed_dim, use_bias=False,
                                  dtype=dtype, device=device)
        self.ln_kv = PLayerNorm(embed_dim, dtype=dtype, device=device)
        self.ln_q = PLayerNorm(embed_dim, dtype=dtype, device=device)
        self.attn = TorchMHA(embed_dim, num_heads, dtype=dtype, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        x = self.ln_kv(x)
        q = self.ln_q(self.query)
        kv_pos = resize_pos_embed(self.pos, x.shape[1])
        q_in = (q + self.pos)[None].to(self.dtype).expand(
            x.shape[0], self.num_queries, self.embed_dim)
        return self.attn(q_in, x + kv_pos[None], x)
