"""Shared building blocks (reference: seedx_tpu/models/layers.py).

Weights are buffers named as the JAX package's parameter leaves
(``kernel`` [in, out], ``kernel_q``, ``kernel_q4``, ``kernel_scale``,
``bias``, ``scale``), so ``utils/convert.py`` is mostly a rename.  With
``layers=L`` a module holds its weights stacked ``[L, ...]`` and
``forward(x, layer)`` reads layer ``layer`` as a view: one layer loop
serves prefill and decode.  Float weights are stored in the compute dtype;
the JAX package casts its fp32 parameters to that dtype at every use, so
the values are the same.  Inference only: buffers, no gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from seedx_tpu_torch.ops.attention import dot_product_attention
from seedx_tpu_torch.ops.int4_matmul import int4_matmul_auto
from seedx_tpu_torch.ops.norms import rms_norm


def _lead(layers: Optional[int]) -> tuple:
    return () if layers is None else (layers,)


class Stacked(nn.Module):
    """Base: ``self.w(name, layer)`` is buffer ``name`` or its layer view."""

    def w(self, name: str, layer: Optional[int]) -> torch.Tensor:
        t = getattr(self, name)
        return t if layer is None else t[layer]


class PDense(Stacked):
    """Dense: ``kernel`` [in, out] (+ ``bias``); ``quantize="int8"`` stores
    ``kernel_q`` int8 + per-output fp32 ``kernel_scale``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 quantize: str = "none", dtype=torch.bfloat16,
                 layers: Optional[int] = None, device=None):
        super().__init__()
        if quantize not in ("none", "int8"):
            raise ValueError(f"PDense quantize must be none|int8: {quantize}")
        self.quantize, self.dtype, self.use_bias = quantize, dtype, use_bias
        lead = _lead(layers)
        if quantize == "int8":
            self.register_buffer("kernel_q", torch.zeros(
                lead + (in_features, features), dtype=torch.int8,
                device=device))
            self.register_buffer("kernel_scale", torch.ones(
                lead + (features,), dtype=torch.float32, device=device))
        else:
            self.register_buffer("kernel", torch.zeros(
                lead + (in_features, features), dtype=dtype, device=device))
        if use_bias:
            self.register_buffer("bias", torch.zeros(
                lead + (features,), dtype=dtype, device=device))

    def dense_kernel(self, layer: Optional[int] = None) -> torch.Tensor:
        if self.quantize == "int8":
            return (self.w("kernel_q", layer).to(self.dtype)
                    * self.w("kernel_scale", layer).to(self.dtype)[None, :])
        return self.w("kernel", layer)

    def forward(self, x: torch.Tensor,
                layer: Optional[int] = None) -> torch.Tensor:
        y = x.to(self.dtype) @ self.dense_kernel(layer)
        if self.use_bias:
            y = y + self.w("bias", layer)
        return y


class LoRADense(PDense):
    """Dense with optional low-rank delta and int8 / int4 weights.

    ``quantize="int4"``: ``kernel_q4`` uint8 [in//2, out] (row-pair signed
    nibbles) + ``kernel_scale`` fp32 [in//group, out], group = 128, or in
    when in % 128 != 0 (reference layers.py:121-142), through the W4A8
    kernel.  ``lora_rank > 0`` adds ``scale * (x @ lora_a) @ lora_b``,
    scale = alpha / rank (inference: no dropout)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 32.0,
                 quantize: str = "none", quantize_group: int = 128,
                 dtype=torch.bfloat16, layers: Optional[int] = None,
                 device=None):
        base_q = "int8" if quantize in ("int8", "int8_full") else "none"
        super().__init__(in_features, features, use_bias=use_bias,
                         quantize=base_q, dtype=dtype, layers=layers,
                         device=device)
        self.quantize = quantize if quantize != "int8_full" else "int8"
        lead = _lead(layers)
        if quantize == "int4":
            del self.kernel
            group = (quantize_group if in_features % quantize_group == 0
                     else in_features)
            self.register_buffer("kernel_q4", torch.zeros(
                lead + (in_features // 2, features), dtype=torch.uint8,
                device=device))
            self.register_buffer("kernel_scale", torch.ones(
                lead + (in_features // group, features), dtype=torch.float32,
                device=device))
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        if lora_rank > 0:
            self.register_buffer("lora_a", torch.zeros(
                lead + (in_features, lora_rank), dtype=dtype, device=device))
            self.register_buffer("lora_b", torch.zeros(
                lead + (lora_rank, features), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor,
                layer: Optional[int] = None) -> torch.Tensor:
        if self.quantize == "int4":
            y = int4_matmul_auto(x.to(self.dtype), self.w("kernel_q4", layer),
                                 self.w("kernel_scale", layer))
        else:
            y = x.to(self.dtype) @ self.dense_kernel(layer)
        if self.lora_rank > 0:
            delta = ((x.to(self.dtype) @ self.w("lora_a", layer))
                     @ self.w("lora_b", layer))
            y = y + (self.lora_alpha / self.lora_rank) * delta
        if self.use_bias:
            y = y + self.w("bias", layer)
        return y


class PLayerNorm(Stacked):
    """LayerNorm with fp32 statistics; output in the compute dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-6, dtype=torch.bfloat16,
                 layers: Optional[int] = None, device=None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.register_buffer("scale", torch.ones(_lead(layers) + (dim,),
                                                 dtype=dtype, device=device))
        self.register_buffer("bias", torch.zeros(_lead(layers) + (dim,),
                                                 dtype=dtype, device=device))

    def forward(self, x: torch.Tensor,
                layer: Optional[int] = None) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        normed = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(self.dtype)
        return normed * self.w("scale", layer) + self.w("bias", layer)


class RMSNorm(Stacked):
    """LLaMA RMSNorm (reference: modeling_llama_xformer.py:75-94)."""

    def __init__(self, dim: int, epsilon: float = 1e-5, dtype=torch.bfloat16,
                 layers: Optional[int] = None, device=None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.register_buffer("scale", torch.ones(_lead(layers) + (dim,),
                                                 dtype=dtype, device=device))

    def forward(self, x: torch.Tensor,
                layer: Optional[int] = None) -> torch.Tensor:
        return rms_norm(x.to(self.dtype), self.w("scale", layer), self.epsilon)


class MLP(nn.Module):
    """ViT MLP: c_fc -> exact GELU -> c_proj (reference: qwen_visual.py)."""

    def __init__(self, dim: int, hidden: int, quantize: str = "none",
                 dtype=torch.bfloat16, layers: Optional[int] = None,
                 device=None):
        super().__init__()
        self.c_fc = PDense(dim, hidden, quantize=quantize, dtype=dtype,
                           layers=layers, device=device)
        self.c_proj = PDense(hidden, dim, quantize=quantize, dtype=dtype,
                             layers=layers, device=device)

    def forward(self, x: torch.Tensor,
                layer: Optional[int] = None) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x, layer)), layer)


class TorchMHA(nn.Module):
    """``nn.MultiheadAttention``-equivalent cross attention for the
    resamplers: q/k/v/out projections with biases, plain fp32 softmax."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, PDense(dim, dim, dtype=dtype, device=device))

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        dim = q.shape[-1]
        hd = dim // self.num_heads

        def heads(t):
            return t.reshape(*t.shape[:-1], self.num_heads, hd)

        out = dot_product_attention(heads(self.q_proj(q)),
                                    heads(self.k_proj(k)),
                                    heads(self.v_proj(v)), impl="plain")
        return self.out_proj(out.reshape(*q.shape[:-1], dim))


def init_normal_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Random weights for a module built with zeros: normal(0, s) with
    s = min(std, fan_in ** -0.5) for float kernels, tables and queries;
    1 + normal(0, 0.1) for norm scales; normal(0, 0.02) for biases.
    Integer leaves and quantizer scales are left to the quantizer.  Values
    are drawn in fp32 on the module's device, one buffer at a time."""
    # state_dict: persistent buffers only (not the fixed sincos tables)
    for name, buf in module.state_dict(keep_vars=True).items():
        if not buf.is_floating_point() or name.endswith("kernel_scale"):
            continue
        leaf = name.rsplit(".", 1)[-1]
        noise = torch.empty(buf.shape, dtype=torch.float32, device=buf.device)
        noise.normal_(0.0, 1.0, generator=generator)
        if leaf == "scale":
            noise = 1.0 + 0.1 * noise
        elif leaf == "bias":
            noise = 0.02 * noise
        else:
            fan_in = buf.shape[-2] if buf.dim() >= 2 else buf.shape[-1]
            noise = noise * min(std, 1.0 / math.sqrt(fan_in))
        buf.copy_(noise)
    return module
