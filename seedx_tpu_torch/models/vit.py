"""Qwen ViT-bigG/14 visual encoder (reference: seedx_tpu/models/vit.py;
src/models/tokenizer/qwen_visual.py:325-459).

Patchify (a stride-p conv, run as one matmul over flattened patches), the
bicubic-resized position table, 48 pre-LN blocks with stacked [L, ...]
weights read per layer, the attention-pool Resampler, the optional tile
position embedding, ``ln_post`` and ``proj``.  Images are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from seedx_tpu_torch.models.layers import MLP, PDense, PLayerNorm
from seedx_tpu_torch.models.resampler import Resampler, resize_pos_embed
from seedx_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_ratio: float = 4.9231
    n_queries: int = 256
    output_dim: int = 4096
    patch_pos: bool = False
    pos_embed_len: int = 256
    pool_heads: int = 0       # attn-pool heads; 0 -> output_dim // 128
    quantization: str = "none"
    dtype: torch.dtype = torch.bfloat16

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


def qwen_vitg_448(**overrides) -> ViTConfig:
    """The flagship config (configs/visual_encoder/qwen_vitg_448.yaml)."""
    return ViTConfig(**overrides)


def vit_tiny_debug(**overrides) -> ViTConfig:
    kw = dict(width=128, layers=2, heads=4, mlp_ratio=2.0, output_dim=128)
    kw.update(overrides)
    return ViTConfig(**kw)


class _Patchify(nn.Module):
    """Bias-free stride-p conv with the JAX kernel layout [p, p, 3, width]."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.p = p
        self.register_buffer("kernel", torch.zeros(
            (p, p, 3, cfg.width), dtype=cfg.dtype, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, c = images.shape
        p = self.p
        x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return x.to(self.kernel.dtype) @ self.kernel.reshape(p * p * c, -1)


class ViTBlocks(nn.Module):
    """The trunk: ``cfg.layers`` pre-LN blocks, weights stacked [L, ...]."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        L, w, dt = cfg.layers, cfg.width, cfg.dtype
        q = cfg.quantization
        self.cfg = cfg
        self.ln_1 = PLayerNorm(w, dtype=dt, layers=L, device=device)
        self.in_proj = PDense(w, 3 * w, quantize=q, dtype=dt, layers=L,
                              device=device)
        self.out_proj = PDense(w, w, quantize=q, dtype=dt, layers=L,
                               device=device)
        self.ln_2 = PLayerNorm(w, dtype=dt, layers=L, device=device)
        self.mlp = MLP(w, cfg.mlp_hidden, quantize=q, dtype=dt, layers=L,
                       device=device)

    def block(self, x: torch.Tensor, li: int) -> torch.Tensor:
        cfg = self.cfg
        hd = cfg.width // cfg.heads
        qkv = self.in_proj(self.ln_1(x, li), li)
        q, k, v = (t.reshape(*t.shape[:-1], cfg.heads, hd)
                   for t in qkv.chunk(3, dim=-1))
        attn = dot_product_attention(q, k, v, impl="auto")
        x = x + self.out_proj(attn.reshape(x.shape), li)
        return x + self.mlp(self.ln_2(x, li), li)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for li in range(self.cfg.layers):
            x = self.block(x, li)
        return x


class VisionTransformer(nn.Module):
    """images [B, H, W, 3] (NHWC), patch_positions [B, 2] optional ->
    [B, n_queries, output_dim]."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.conv1 = _Patchify(cfg, device)
        self.register_buffer("positional_embedding", torch.zeros(
            (cfg.pos_embed_len, cfg.width), dtype=dt, device=device))
        self.ln_pre = PLayerNorm(cfg.width, dtype=dt, device=device)
        self.blocks = ViTBlocks(cfg, device)
        self.attn_pool = Resampler(
            grid_size=int(cfg.n_queries ** 0.5), embed_dim=cfg.output_dim,
            num_heads=cfg.pool_heads or max(1, cfg.output_dim // 128),
            kv_dim=cfg.width, dtype=dt, device=device)
        if cfg.patch_pos:
            self.register_buffer("patch_pos_embed", torch.zeros(
                (4, cfg.output_dim), dtype=dt, device=device))
        self.ln_post = PLayerNorm(cfg.output_dim, dtype=dt, device=device)
        self.register_buffer("proj", torch.zeros(
            (cfg.output_dim, cfg.output_dim), dtype=dt, device=device))

    def forward(self, images: torch.Tensor,
                patch_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        x = self.conv1(images)
        x = x + resize_pos_embed(self.positional_embedding, x.shape[1])[None]
        x = self.ln_pre(x)
        x = self.blocks(x)
        x = self.attn_pool(x)
        if cfg.patch_pos:
            coords = torch.cat([patch_positions, 1.0 - patch_positions],
                               dim=-1) / 2.0
            x = x + (coords.to(cfg.dtype) @ self.patch_pos_embed)[:, None]
        x = self.ln_post(x)
        return x @ self.proj


def vit_downsample(embeds: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """Average-pool the token axis 256 -> 64 (reference ``vit_down``)."""
    b, n, d = embeds.shape
    return embeds.reshape(b, n // pool, pool, d).mean(dim=2)
