"""De-tokenizer resampler: 64 generated visual embeddings -> SDXL
conditioning (reference: seedx_tpu/models/detokenizer.py; the reference's
``ResamplerXLV2``, src/models/detokenizer/resampler.py:226-286, config
configs/sdxl_adapter/*.yaml: dim 1024, depth 4, dim_head 64, heads 16,
num_queries 64, embedding_dim 4096, outputs 768 + 1280, ff_mult 4).

Four perceiver blocks (learned latents attending over [input tokens ++
latents]), then the dual text-stream heads ``unet_proj_1`` (768) ++
``unet_proj_2`` (1280) -> the 2048-d ``prompt_embeds``, and an
``AttentionPool2d`` -> the 1280-d pooled ``text_embeds``.  Its attention
is plain (``impl="xla"`` in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seedx_tpu_torch.models.layers import PDense, PLayerNorm
from seedx_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class DetokenizerConfig:
    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 16
    num_queries: int = 64
    embedding_dim: int = 4096
    output1_dim: int = 768
    output2_dim: int = 1280
    ff_mult: int = 4
    normalize: bool = False
    dtype: torch.dtype = torch.bfloat16


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


class PerceiverAttention(nn.Module):
    """(reference: resampler.py:30-75) kv over concat(x, latents)."""

    def __init__(self, cfg: DetokenizerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        inner = cfg.dim_head * cfg.heads
        self.norm1 = PLayerNorm(cfg.dim, 1e-5, **kw)
        self.norm2 = PLayerNorm(cfg.dim, 1e-5, **kw)
        self.to_q = PDense(cfg.dim, inner, use_bias=False, **kw)
        self.to_kv = PDense(cfg.dim, 2 * inner, use_bias=False, **kw)
        self.to_out = PDense(inner, cfg.dim, use_bias=False, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x, latents = self.norm1(x), self.norm2(latents)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        out = dot_product_attention(
            _heads(q, cfg.heads), _heads(k, cfg.heads), _heads(v, cfg.heads),
            scale=1.0 / cfg.dim_head ** 0.5, impl="plain")
        return self.to_out(out.reshape(*latents.shape[:-1], -1))


class FeedForward(nn.Module):
    """LN -> Linear -> exact GELU -> Linear, no biases (resampler.py:9-16)."""

    def __init__(self, cfg: DetokenizerConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.norm = PLayerNorm(cfg.dim, 1e-5, **kw)
        self.fc1 = PDense(cfg.dim, cfg.dim * cfg.ff_mult, use_bias=False,
                          **kw)
        self.fc2 = PDense(cfg.dim * cfg.ff_mult, cfg.dim, use_bias=False,
                          **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (reference: resampler.py:78-116):
    [B, N, C] -> [B, output_dim] from the mean token's row."""

    def __init__(self, num_tokens: int, dim: int, num_heads: int,
                 output_dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.register_buffer("positional_embedding", torch.zeros(
            (num_tokens + 1, dim), dtype=dtype, device=device))
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, PDense(dim, dim, dtype=dtype, device=device))
        self.c_proj = PDense(dim, output_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None].to(x.dtype)
        out = dot_product_attention(
            _heads(self.q_proj(x), self.num_heads),
            _heads(self.k_proj(x), self.num_heads),
            _heads(self.v_proj(x), self.num_heads), impl="plain")
        return self.c_proj(out.reshape(x.shape))[:, 0]


class ResamplerXL(nn.Module):
    """Perceiver resampler emitting SDXL dual conditioning streams."""

    def __init__(self, cfg: DetokenizerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.register_buffer("latents", torch.zeros(
            (1, cfg.num_queries, cfg.dim), **kw))
        self.proj_in = PDense(cfg.embedding_dim, cfg.dim, **kw)
        for i in range(cfg.depth):
            setattr(self, f"attn_{i}", PerceiverAttention(cfg, device))
            setattr(self, f"ff_{i}", FeedForward(cfg, device))
        self.norm_out = PLayerNorm(cfg.dim, 1e-5, **kw)
        self.unet_proj_1 = PDense(cfg.dim, cfg.output1_dim, **kw)
        self.unet_proj_2 = PDense(cfg.dim, cfg.output2_dim, **kw)
        self.unet_attnpool = AttentionPool2d(cfg.num_queries, cfg.dim,
                                             cfg.heads, cfg.output2_dim, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, embedding_dim] -> (prompt_embeds [B, nq, out1 + out2],
        pooled [B, out2])."""
        cfg = self.cfg
        # a trainable (fp32 master) latents leaf is cast at its use
        lat = self.latents.to(cfg.dtype).expand(x.shape[0], -1, -1)
        if cfg.normalize:
            # the reference's F.normalize(x) with torch's default dim=1: the
            # l2 norm runs over the token axis, not the feature axis
            # (resampler.py:271-272)
            xf = x.float()
            norm = torch.linalg.vector_norm(xf, dim=1, keepdim=True)
            x = (xf / torch.clamp(norm, min=1e-12)).to(x.dtype)
        x = self.proj_in(x)
        for i in range(cfg.depth):
            lat = getattr(self, f"attn_{i}")(x, lat) + lat
            lat = getattr(self, f"ff_{i}")(lat) + lat
        hidden = self.norm_out(lat)
        prompt_embeds = torch.cat([self.unet_proj_1(hidden),
                                   self.unet_proj_2(hidden)], dim=-1)
        return prompt_embeds, self.unet_attnpool(hidden)


class ResamplerXLIdentity(nn.Module):
    """Pass-through variant (reference: resampler.py:288-293)."""

    def forward(self, x, pooled=None):
        return x, pooled
