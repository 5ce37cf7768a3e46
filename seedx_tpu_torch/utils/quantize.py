"""Weight quantization in torch (reference: seedx_tpu/utils/quantize.py,
whose numpy packers cannot be imported here: that module imports jax).

The packers give the same bytes as the JAX package's, so one quantized
tree feeds both packages: int8 per-output-channel kernels, int8 per-row
embedding tables, and int4 row-pair nibbles with per-(group, out) scales;
``quantize_llama_params`` / ``quantize_vit_params`` /
``quantize_unet_params`` lay a whole model's state out for its quantized
config.
They run on whatever device the weight lives on, one matrix at a time,
and give the same bytes on the card as on the CPU: each scale divides by
a tensor (ATen divides a CUDA tensor by a Python number as a multiply by
its reciprocal, one ulp off the division).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


def _absmax_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(absmax, 1e-8) / qmax, a true fp32 division on every device."""
    absmax = torch.clamp(absmax, min=1e-8)
    return absmax / torch.full_like(absmax, qmax)


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] -> (int8 same shape, fp32 scale [..., out]):
    symmetric absmax over the in dim."""
    k = kernel.float()
    scale = _absmax_scale(k.abs().amax(dim=-2), 127.0)
    q = torch.clamp(torch.round(k / scale.unsqueeze(-2)), -127, 127)
    return q.to(torch.int8), scale


def quantize_kernel_int4(kernel: torch.Tensor, group: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] -> (packed uint8 [..., in//2, out], fp32 scales
    [..., in//group, out]); group = in when in % group != 0.  Byte [r, c]
    holds W[2r, c] in its lo nibble and W[2r+1, c] in its hi nibble,
    two's-complement; scale = absmax / 7 per (group, out), codes in
    [-7, 7]."""
    k = kernel.float()
    *lead, n_in, n_out = k.shape
    if n_in % 2:
        raise ValueError("in dim must be even to nibble-pack")
    if n_in % group:
        group = n_in
    g = k.reshape(*lead, n_in // group, group, n_out)
    scale = _absmax_scale(g.abs().amax(dim=-2), 7.0)
    q = torch.clamp(torch.round(g / scale.unsqueeze(-2)), -7, 7)
    q = q.to(torch.int16).reshape(*lead, n_in, n_out)
    packed = (q[..., 0::2, :] & 0xF) | ((q[..., 1::2, :] & 0xF) << 4)
    return packed.to(torch.uint8), scale


def quantize_embedding(table: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[vocab, hidden] -> (int8 table, fp32 per-row scale [vocab])."""
    t = table.float()
    scale = _absmax_scale(t.abs().amax(dim=-1), 127.0)
    q = torch.clamp(torch.round(t / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_llama_params(state: Dict[str, torch.Tensor],
                          mode: str = "int4") -> Dict[str, torch.Tensor]:
    """Full-precision llama state (the port's flat names) -> the layout
    ``LlamaConfig(quantization=mode)`` expects.  mode "int8": projections
    int8; "int8_full": + embedding and lm_head int8; "int4": projections
    int4, embedding and lm_head int8."""
    if mode not in ("int8", "int8_full", "int4"):
        raise ValueError(f"mode must be int8|int8_full|int4, got {mode!r}")
    full = mode in ("int8_full", "int4")
    out = {}
    for key, v in state.items():
        parts = key.split(".")
        base = ".".join(parts[:-1])
        if len(parts) >= 2 and parts[-1] == "kernel" and \
                parts[-2] in QUANT_TARGETS:
            if mode == "int4":
                out[base + ".kernel_q4"], out[base + ".kernel_scale"] = \
                    quantize_kernel_int4(v)
            else:
                out[base + ".kernel_q"], out[base + ".kernel_scale"] = \
                    quantize_kernel(v)
        elif full and len(parts) >= 2 and parts[-1] == "kernel" \
                and parts[-2] == "lm_head":
            out[base + ".kernel_q"], out[base + ".kernel_scale"] = \
                quantize_kernel(v)
        elif full and parts[-1] == "embedding":
            out[base + ".embedding_q"], out[base + ".embedding_scale"] = \
                quantize_embedding(v)
        else:
            out[key] = v
    return out


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [in, out] codes times the per-output scale [out], in ``dtype``
    (reference quantize.py:119)."""
    return q.to(dtype) * scale.to(dtype)[None, :]


VIT_QUANT_TARGETS = ("in_proj", "out_proj", "c_fc", "c_proj")


def quantize_vit_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Full-precision ViT state (the port's flat names) -> the layout
    ``ViTConfig(quantization="int8")`` expects: every trunk projection
    ``blocks.*.kernel`` (stacked [L, in, out]) becomes ``kernel_q`` int8 +
    ``kernel_scale`` fp32 [L, out]; biases, norms, position tables, the
    patchify conv and the attention pool stay as they are (the JAX
    package's ``quantize_vit_params``, the same bytes)."""
    out = {}
    for key, v in state.items():
        parts = key.split(".")
        base = ".".join(parts[:-1])
        if (parts[0] == "blocks" and parts[-1] == "kernel"
                and parts[-2] in VIT_QUANT_TARGETS):
            out[base + ".kernel_q"], out[base + ".kernel_scale"] = \
                quantize_kernel(v)
        else:
            out[key] = v
    return out


# kept high precision in the int8 UNet: tiny and numerically sensitive
UNET_SKIP_PREFIXES = ("time_embed_1", "time_embed_2", "add_embed_1",
                      "add_embed_2", "conv_in", "conv_out")


def quantize_unet_params(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Full-precision SDXL UNet state (the port's flat names) -> the layout
    ``UNetConfig(quantize="int8")`` expects: every block Dense ``kernel``
    [in, out] becomes ``kernel_q`` int8 + ``kernel_scale`` fp32 [out], every
    block conv ``weight`` [out, in, kh, kw] ``weight_q`` int8 (same layout
    and memory format) + ``kernel_scale``, symmetric per-output-channel
    absmax (the JAX package's bytes: it takes the absmax of its
    [kh, kw, in, out] kernel over all but the out axis); biases and norms
    stay as they are, and so do the time / added-cond embeds and conv_in /
    conv_out (``UNET_SKIP_PREFIXES``)."""
    out = {}
    for key, v in state.items():
        base, _, leaf = key.rpartition(".")
        skip = key.split(".")[0] in UNET_SKIP_PREFIXES
        if leaf == "kernel" and not skip:
            out[base + ".kernel_q"], out[base + ".kernel_scale"] = \
                quantize_kernel(v)
        elif leaf == "weight" and not skip:
            q, scale = quantize_kernel(v.reshape(v.shape[0], -1).T)
            out[base + ".weight_q"] = q.T.reshape(v.shape).contiguous(
                memory_format=torch.channels_last)
            out[base + ".kernel_scale"] = scale
        else:
            out[key] = v
    return out


@torch.no_grad()
def random_quantized_llama_(llm: nn.Module, generator: torch.Generator,
                            std: float = 0.02) -> nn.Module:
    """Fill every quantized leaf of a quantized ``LlamaForCausalLM`` with
    the quantization of normal(0, std) weights, drawn on the module's
    device one layer (one matrix) at a time, so a full-precision copy of
    the whole model never exists."""
    from seedx_tpu_torch.models.llama import Embedder

    def draw(shape, device):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, std, generator=generator)

    for mod in llm.modules():
        if isinstance(mod, Embedder) and mod.quantized:
            q, s = quantize_embedding(draw(mod.embedding_q.shape,
                                           mod.embedding_q.device))
            mod.embedding_q.copy_(q)
            mod.embedding_scale.copy_(s)
        for leaf in ("kernel_q4", "kernel_q"):
            codes = mod._buffers.get(leaf)
            if codes is None:
                continue
            stacked = codes.dim() == 3
            n_in = codes.shape[-2] * (2 if leaf == "kernel_q4" else 1)
            n_out = codes.shape[-1]
            for li in range(codes.shape[0] if stacked else 1):
                w = draw((n_in, n_out), codes.device)
                if leaf == "kernel_q4":
                    group = n_in // mod.kernel_scale.shape[-2]
                    q, s = quantize_kernel_int4(w, group)
                else:
                    q, s = quantize_kernel(w)
                (codes[li] if stacked else codes).copy_(q)
                (mod.kernel_scale[li] if stacked
                 else mod.kernel_scale).copy_(s)
    return llm
