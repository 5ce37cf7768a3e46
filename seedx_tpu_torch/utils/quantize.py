"""Weight quantization in torch (reference: seedx_tpu/utils/quantize.py,
whose numpy packers cannot be imported here: that module imports jax).

The packers give the same bytes as the JAX package's, so one quantized
tree feeds both packages: int8 per-output-channel kernels, int8 per-row
embedding tables, and int4 row-pair nibbles with per-(group, out) scales.
They run on whatever device the weight lives on, one matrix at a time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] -> (int8 same shape, fp32 scale [..., out]):
    symmetric absmax over the in dim."""
    k = kernel.float()
    scale = torch.clamp(k.abs().amax(dim=-2), min=1e-8) / 127.0
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
    scale = torch.clamp(g.abs().amax(dim=-2), min=1e-8) / 7.0
    q = torch.clamp(torch.round(g / scale.unsqueeze(-2)), -7, 7)
    q = q.to(torch.int16).reshape(*lead, n_in, n_out)
    packed = (q[..., 0::2, :] & 0xF) | ((q[..., 1::2, :] & 0xF) << 4)
    return packed.to(torch.uint8), scale


def quantize_embedding(table: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[vocab, hidden] -> (int8 table, fp32 per-row scale [vocab])."""
    t = table.float()
    scale = torch.clamp(t.abs().amax(dim=-1), min=1e-8) / 127.0
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
