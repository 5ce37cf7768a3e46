"""SDXL AutoencoderKL (VAE) (reference: seedx_tpu/models/sdxl/vae.py;
src/inference/eval_text2img_seed_x_i.py:62, the encoder's ``.mode()`` for
the edit condition latents, pipeline_stable_diffusion_xl_t2i_edit.py:490-551,
and the fp32 decode, :965-986).

Channels (128, 256, 512, 512), 2 resnets a block in the encoder and 3 in
the decoder, a single-head mid attention, 4 latent channels,
scaling_factor 0.13025.  NHWC, fp32 throughout: the SDXL VAE overflows in
fp16 (the reference upcasts too).  The mid attention's head dim (512) is
above what the flash kernel takes, and the JAX module computes it as a
plain einsum: so does this one.

The decoder splits its rows as the UNet does (``unet.RowSplit``, the
JAX package's constraints at vae.py:153-160): its convs take halo rows,
its GroupNorms sum their statistics over the ranks, the mid attention
keeps its query rows and gathers the keys and values, and the image's
rows are gathered at the end.  The encoder stays whole, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from seedx_tpu_torch.models.sdxl.unet import (Conv, Dense, GroupNorm,
                                              row_split, upsample_conv)

SDXL_VAE_SCALING = 0.13025


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    channels: Tuple[int, ...] = (128, 256, 512, 512)
    latent_channels: int = 4
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SDXL_VAE_SCALING
    dtype: torch.dtype = torch.float32    # fp32: SDXL VAE is fp16-unstable


def sdxl_vae(**overrides) -> VAEConfig:
    return VAEConfig(**overrides)


def vae_debug(**overrides) -> VAEConfig:
    kw = dict(channels=(16, 32), norm_num_groups=8)
    kw.update(overrides)
    return VAEConfig(**kw)


def _conv(cfg: VAEConfig, c_in: int, c_out: int, k: int, device,
          **kw) -> Conv:
    return Conv(c_in, c_out, (k, k), padding=k // 2, dtype=cfg.dtype,
                device=device, **kw)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cfg: VAEConfig,
                 device=None):
        super().__init__()
        g = cfg.norm_num_groups
        self.norm1 = GroupNorm(in_channels, g, 1e-6, device)
        self.conv1 = _conv(cfg, in_channels, out_channels, 3, device)
        self.norm2 = GroupNorm(out_channels, g, 1e-6, device)
        self.conv2 = _conv(cfg, out_channels, out_channels, 3, device)
        if in_channels != out_channels:
            self.conv_shortcut = _conv(cfg, in_channels, out_channels, 1,
                                       device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention in the mid block."""

    def __init__(self, channels: int, cfg: VAEConfig, device=None):
        super().__init__()
        self.group_norm = GroupNorm(channels, cfg.norm_num_groups, 1e-6,
                                    device)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, Dense(channels, channels, dtype=cfg.dtype,
                                      device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hidden = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(hidden), self.to_k(hidden), self.to_v(hidden)
        rows = row_split(self)
        if rows is not None:
            # local query rows against every rank's keys and values
            k, v = rows.gather(torch.stack([k, v]), 2).unbind(0)
        # [B, h*w, h*w] fp32 logits: at 1024^2 (128^2 latents, 16384
        # tokens) 1 GiB an image, and the softmax another
        attn = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k)
                             / math.sqrt(c), dim=-1)
        out = self.to_out(torch.einsum("bqk,bkc->bqc", attn, v),
                          x.reshape(b, h * w, c))
        return out.reshape(b, h, w, c)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        chs = cfg.channels
        self.conv_in = _conv(cfg, 3, chs[0], 3, device)
        ch_in = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_res_{j}",
                        VAEResnet(ch_in, ch, cfg, device))
                ch_in = ch
            if i < len(chs) - 1:
                # stride 2, padded on the bottom and right only
                setattr(self, f"down_{i}_downsample", Conv(
                    ch, ch, (3, 3), stride=2, padding=((0, 1), (0, 1)),
                    dtype=cfg.dtype, device=device))
        ch = chs[-1]
        self.mid_res_0 = VAEResnet(ch, ch, cfg, device)
        self.mid_attn = VAEAttention(ch, cfg, device)
        self.mid_res_1 = VAEResnet(ch, ch, cfg, device)
        self.norm_out = GroupNorm(ch, cfg.norm_num_groups, 1e-6, device)
        self.conv_out = _conv(cfg, ch, 2 * cfg.latent_channels, 3, device)
        self.quant_conv = _conv(cfg, 2 * cfg.latent_channels,
                                2 * cfg.latent_channels, 1, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [-1, 1] -> moments [B, h, w, 2*latent]."""
        cfg = self.cfg
        x = self.conv_in(images)
        for i in range(len(cfg.channels)):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            if i < len(cfg.channels) - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = self.conv_out(self.norm_out(x, silu=True))
        return self.quant_conv(x)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        lc = cfg.latent_channels
        self.post_quant_conv = _conv(cfg, lc, lc, 1, device)
        ch = cfg.channels[-1]
        self.conv_in = _conv(cfg, lc, ch, 3, device)
        self.mid_res_0 = VAEResnet(ch, ch, cfg, device)
        self.mid_attn = VAEAttention(ch, cfg, device)
        self.mid_res_1 = VAEResnet(ch, ch, cfg, device)
        ch_in = ch
        for i, ch in enumerate(reversed(cfg.channels)):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_res_{j}",
                        VAEResnet(ch_in, ch, cfg, device))
                ch_in = ch
            if i < len(cfg.channels) - 1:
                setattr(self, f"up_{i}_upsample",
                        _conv(cfg, ch, ch, 3, device))
        self.norm_out = GroupNorm(ch, cfg.norm_num_groups, 1e-6, device)
        self.conv_out = _conv(cfg, ch, 3, 3, device)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [B, h, w, latent] (unscaled) -> images [B, H, W, 3]."""
        cfg = self.cfg
        split = row_split(self)
        if split is not None:
            latents = split.local_rows(latents)
        x = self.conv_in(self.post_quant_conv(latents))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        for i in range(len(cfg.channels)):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x)
            if i < len(cfg.channels) - 1:
                x = upsample_conv(getattr(self, f"up_{i}_upsample"), x)
        out = self.conv_out(self.norm_out(x, silu=True))
        return out if split is None else split.gather(out, 1)


def sample_moments(moments: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Split moments into (mean, logvar); the mean (``.mode()``, the edit
    condition latents) without a generator, else a sample."""
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    return mean + std * noise
