"""Diffusers SDXL checkpoints -> the port's state dicts (reference:
seedx_tpu/utils/sdxl_weights.py).

Covers the frozen SDXL base the reference loads (reference:
src/inference/eval_text2img_seed_x_i.py:60-64: UNet and VAE from
stabilityai/stable-diffusion-xl-base-1.0), the released detokenizer's
UNet deltas (a full fine-tune or the cross-attention to_k / to_v only,
adapter_modules.py:21-33) and the Edit variant's widened 8-channel
``conv_in`` (zero-init new channels, adapter_modules.py:183-198).

The port's conv modules hold torch's own ``weight [out, in, kh, kw]``, so
conv weights pass through as they are (``utils/convert.load_jax_params``
turns the JAX package's ``[kh, kw, in, out]`` back to this); Linear
weights become ``kernel [in, out]``; GroupNorm / LayerNorm ``weight``
becomes ``scale``.  Tensors keep their file dtype; the module's buffers
decide storage.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import torch

from seedx_tpu_torch.utils.weights import _dense, _ln


def _conv(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.weight": sd[f"{src}.weight"],
            f"{dst}.bias": sd[f"{src}.bias"]}


def _lin(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return _dense(sd, src, dst, bias=f"{src}.bias" in sd)


def _resnet(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    out = {}
    out.update(_ln(sd, f"{src}.norm1", f"{dst}.norm1"))
    out.update(_conv(sd, f"{src}.conv1", f"{dst}.conv1"))
    out.update(_ln(sd, f"{src}.norm2", f"{dst}.norm2"))
    out.update(_conv(sd, f"{src}.conv2", f"{dst}.conv2"))
    if f"{src}.time_emb_proj.weight" in sd:
        out.update(_lin(sd, f"{src}.time_emb_proj", f"{dst}.time_emb_proj"))
    if f"{src}.conv_shortcut.weight" in sd:
        out.update(_conv(sd, f"{src}.conv_shortcut",
                         f"{dst}.conv_shortcut"))
    return out


def _basic_transformer(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i in (1, 2, 3):
        out.update(_ln(sd, f"{src}.norm{i}", f"{dst}.norm{i}"))
    for attn in ("attn1", "attn2"):
        for proj, name in (("to_q", "to_q"), ("to_k", "to_k"),
                           ("to_v", "to_v"), ("to_out.0", "to_out")):
            out.update(_lin(sd, f"{src}.{attn}.{proj}",
                            f"{dst}.{attn}.{name}"))
    out.update(_lin(sd, f"{src}.ff.net.0.proj", f"{dst}.ff_geglu.proj"))
    out.update(_lin(sd, f"{src}.ff.net.2", f"{dst}.ff_out"))
    return out


def _transformer2d(sd, src: str, dst: str, depth: int
                   ) -> Dict[str, torch.Tensor]:
    out = {}
    out.update(_ln(sd, f"{src}.norm", f"{dst}.norm"))
    out.update(_lin(sd, f"{src}.proj_in", f"{dst}.proj_in"))
    out.update(_lin(sd, f"{src}.proj_out", f"{dst}.proj_out"))
    for k in range(depth):
        out.update(_basic_transformer(sd, f"{src}.transformer_blocks.{k}",
                                      f"{dst}.block_{k}"))
    return out


def widen_conv_in(weight: torch.Tensor, to_channels: int) -> torch.Tensor:
    """Widen a torch-layout ``[out, in, kh, kw]`` conv weight's input
    channels, the new ones zero (the Edit variant's surgery, reference:
    adapter_modules.py:191-198)."""
    have = weight.shape[1]
    if to_channels <= have:
        return weight
    pad = weight.new_zeros((weight.shape[0], to_channels - have,
                            *weight.shape[2:]))
    return torch.cat([weight, pad], dim=1)


def convert_sdxl_unet(
    sd: Mapping[str, Any],
    block_out_channels=(320, 640, 1280),
    layers_per_block: int = 2,
    transformer_layers=(0, 2, 10),
    widen_conv_in_to: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Diffusers UNet2DConditionModel state dict -> UNet2DCondition state.
    ``widen_conv_in_to=8``: the Edit variant's conv_in surgery on a base
    (4-channel) checkpoint."""
    n = len(block_out_channels)
    out: Dict[str, torch.Tensor] = {}
    out.update(_conv(sd, "conv_in", "conv_in"))
    if widen_conv_in_to:
        out["conv_in.weight"] = widen_conv_in(out["conv_in.weight"],
                                              widen_conv_in_to)
    for src, dst in (("time_embedding.linear_1", "time_embed_1"),
                     ("time_embedding.linear_2", "time_embed_2"),
                     ("add_embedding.linear_1", "add_embed_1"),
                     ("add_embedding.linear_2", "add_embed_2")):
        out.update(_lin(sd, src, dst))
    out.update(_ln(sd, "conv_norm_out", "conv_norm_out"))
    out.update(_conv(sd, "conv_out", "conv_out"))

    for i in range(n):
        depth = transformer_layers[i]
        for j in range(layers_per_block):
            out.update(_resnet(sd, f"down_blocks.{i}.resnets.{j}",
                               f"down_{i}_res_{j}"))
            if depth:
                out.update(_transformer2d(
                    sd, f"down_blocks.{i}.attentions.{j}",
                    f"down_{i}_attn_{j}", depth))
        if i < n - 1:
            out.update(_conv(sd, f"down_blocks.{i}.downsamplers.0.conv",
                             f"down_{i}_downsample.conv"))

    out.update(_resnet(sd, "mid_block.resnets.0", "mid_res_0"))
    out.update(_resnet(sd, "mid_block.resnets.1", "mid_res_1"))
    if transformer_layers[-1]:
        out.update(_transformer2d(sd, "mid_block.attentions.0", "mid_attn",
                                  transformer_layers[-1]))

    for i in range(n):
        depth = transformer_layers[n - 1 - i]
        for j in range(layers_per_block + 1):
            out.update(_resnet(sd, f"up_blocks.{i}.resnets.{j}",
                               f"up_{i}_res_{j}"))
            if depth:
                out.update(_transformer2d(
                    sd, f"up_blocks.{i}.attentions.{j}", f"up_{i}_attn_{j}",
                    depth))
        if i < n - 1:
            out.update(_conv(sd, f"up_blocks.{i}.upsamplers.0.conv",
                             f"up_{i}_upsample.conv"))
    return out


_ATTN_KEY = re.compile(
    r"(down_blocks\.(\d+)|mid_block|up_blocks\.(\d+))"
    r"\.attentions\.(\d+)\.transformer_blocks\.(\d+)"
    r"\.(attn[12])\.(to_q|to_k|to_v|to_out\.0)\.(weight|bias)")


def _map_attn_key(key: str) -> Optional[str]:
    """One diffusers transformer-attention parameter key -> the port's
    state name, or None if the key is no transformer-attention linear
    (the set the detokenizer stage checkpoints may carry as deltas
    without a full UNet: the trainable cross-attention to_k / to_v,
    reference adapter_modules.py:21-33, and any other attn1 / attn2
    linear)."""
    m = _ATTN_KEY.fullmatch(key)
    if not m:
        return None
    blk, down_i, up_i, attn_j, tblock, attn, proj, kind = m.groups()
    if blk == "mid_block":
        top = "mid_attn"
    elif down_i is not None:
        top = f"down_{down_i}_attn_{attn_j}"
    else:
        top = f"up_{up_i}_attn_{attn_j}"
    proj = "to_out" if proj == "to_out.0" else proj
    leaf = "kernel" if kind == "weight" else "bias"
    return f"{top}.block_{tblock}.{attn}.{proj}.{leaf}"


def convert_sdxl_unet_deltas(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A PARTIAL UNet state dict (e.g. only the trainable attn2 to_k /
    to_v of a detokenizer stage checkpoint) -> ``{"deltas": {state name:
    tensor}, "skipped": [keys that are no transformer-attention
    linears]}``, to overlay on a loaded UNet (the reference's
    ``load_state_dict(ckpt, strict=False)``, adapter_modules.py:62-65)."""
    deltas: Dict[str, torch.Tensor] = {}
    skipped = []
    for key, val in sd.items():
        name = _map_attn_key(key)
        if name is None:
            skipped.append(key)
        else:
            deltas[name] = val.T if name.endswith(".kernel") else val
    return {"deltas": deltas, "skipped": skipped}


def _vae_attention(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    """Both the old (query / key / value / proj_attn) and the new (to_q /
    ...) diffusers names."""
    if f"{src}.to_q.weight" in sd:
        names = ("to_q", "to_k", "to_v", "to_out.0")
    else:
        names = ("query", "key", "value", "proj_attn")
    out = _ln(sd, f"{src}.group_norm", f"{dst}.group_norm")
    for name, port in zip(names, ("to_q", "to_k", "to_v", "to_out")):
        out.update(_lin(sd, f"{src}.{name}", f"{dst}.{port}"))
    return out


def convert_sdxl_vae(sd: Mapping[str, Any],
                     channels=(128, 256, 512, 512),
                     layers_per_block: int = 2
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Diffusers AutoencoderKL -> {"encoder": VAEEncoder state,
    "decoder": VAEDecoder state}."""
    n = len(channels)
    enc: Dict[str, torch.Tensor] = {}
    enc.update(_conv(sd, "encoder.conv_in", "conv_in"))
    enc.update(_ln(sd, "encoder.conv_norm_out", "norm_out"))
    enc.update(_conv(sd, "encoder.conv_out", "conv_out"))
    enc.update(_conv(sd, "quant_conv", "quant_conv"))
    enc.update(_resnet(sd, "encoder.mid_block.resnets.0", "mid_res_0"))
    enc.update(_resnet(sd, "encoder.mid_block.resnets.1", "mid_res_1"))
    enc.update(_vae_attention(sd, "encoder.mid_block.attentions.0",
                              "mid_attn"))
    for i in range(n):
        for j in range(layers_per_block):
            enc.update(_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}",
                               f"down_{i}_res_{j}"))
        if i < n - 1:
            enc.update(_conv(sd,
                             f"encoder.down_blocks.{i}.downsamplers.0.conv",
                             f"down_{i}_downsample"))

    dec: Dict[str, torch.Tensor] = {}
    dec.update(_conv(sd, "post_quant_conv", "post_quant_conv"))
    dec.update(_conv(sd, "decoder.conv_in", "conv_in"))
    dec.update(_ln(sd, "decoder.conv_norm_out", "norm_out"))
    dec.update(_conv(sd, "decoder.conv_out", "conv_out"))
    dec.update(_resnet(sd, "decoder.mid_block.resnets.0", "mid_res_0"))
    dec.update(_resnet(sd, "decoder.mid_block.resnets.1", "mid_res_1"))
    dec.update(_vae_attention(sd, "decoder.mid_block.attentions.0",
                              "mid_attn"))
    for i in range(n):
        for j in range(layers_per_block + 1):
            dec.update(_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}",
                               f"up_{i}_res_{j}"))
        if i < n - 1:
            dec.update(_conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                             f"up_{i}_upsample"))
    return {"encoder": enc, "decoder": dec}
