"""LLaMA2 causal LM backbone (reference: seedx_tpu/models/llama.py).

RoPE, RMSNorm, SwiGLU MLP, causal attention, the dual input contract
(callers embed ids, splice image embeddings in, and pass embeddings).
Layer weights are stacked [L, ...] and read per layer as views; one
Python layer loop serves prefill and decode.  The KV cache is the JAX
package's flat layout [L, B, S, Hkv * D], updated in place at
``cache_index`` (the JAX package returns a new cache; here the caller's
tensors are written, which saves a copy of the cache per step).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seedx_tpu_torch.models.layers import LoRADense, RMSNorm
from seedx_tpu_torch.ops.attention import dot_product_attention
from seedx_tpu_torch.ops.rope import apply_rope, rope_cos_sin

KVCache = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32330   # 32000 + 330 multimodal tokens
    hidden_size: int = 5120
    intermediate_size: int = 13824
    num_layers: int = 40
    num_heads: int = 40
    num_kv_heads: int = 40
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_position_embeddings: int = 2048
    lora_rank: int = 0
    lora_alpha: float = 32.0
    # "none" | "int8" (projections) | "int8_full" (+ embedding, lm_head) |
    # "int4" (nibble-packed projections, int8 embedding + lm_head)
    quantization: str = "none"
    kv_quantization: str = "none"   # "none" | "int8"
    attention_impl: str = "auto"    # "auto" | "plain" | "flash"
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama2_13b(**overrides) -> LlamaConfig:
    """SEED-X backbone: LLaMA2-13B with the 32330-token multimodal vocab."""
    return LlamaConfig(**overrides)


def llama_debug(**overrides) -> LlamaConfig:
    kw = dict(vocab_size=32330, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=4, num_kv_heads=4,
              max_position_embeddings=2048)
    kw.update(overrides)
    return LlamaConfig(**kw)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> KVCache:
    """(k, v) [L, B, S, Hkv*D] in ``dtype``; with int8 KV, int8 codes plus
    per-(position, head) scales [L, B, S, Hkv] in ``dtype``.  The JAX
    package pads the scale lanes to 128 for TPU DMA; here they stay
    compact."""
    dtype = dtype or cfg.dtype
    flat = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
    if cfg.kv_quantization == "int8":
        sshape = flat[:-1] + (cfg.num_kv_heads,)
        return (torch.zeros(flat, dtype=torch.int8, device=device),
                torch.zeros(flat, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=dtype, device=device),
                torch.zeros(sshape, dtype=dtype, device=device))
    return (torch.zeros(flat, dtype=dtype, device=device),
            torch.zeros(flat, dtype=dtype, device=device))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(position, head) int8: scale = amax / 127 over
    head_dim.  x [..., D] -> (int8 [..., D], scale [..., 1] in x's dtype)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    return torch.round(xf / scale).to(torch.int8), scale.to(x.dtype)


class LlamaLayers(nn.Module):
    """All decoder layers, weights stacked [L, ...]."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        L, d, dt = cfg.num_layers, cfg.hidden_size, cfg.dtype
        hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

        def dense(n_in, n_out):
            return LoRADense(n_in, n_out, lora_rank=cfg.lora_rank,
                             lora_alpha=cfg.lora_alpha,
                             quantize=cfg.quantization, dtype=dt, layers=L,
                             device=device)

        self.input_layernorm = RMSNorm(d, cfg.rms_eps, dt, L, device)
        self.q_proj = dense(d, hq)
        self.k_proj = dense(d, hkv)
        self.v_proj = dense(d, hkv)
        self.o_proj = dense(hq, d)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_eps, dt, L, device)
        self.gate_proj = dense(d, cfg.intermediate_size)
        self.up_proj = dense(d, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, d)

    def block(self, li: int, x, cache: Optional[KVCache], cos, sin,
              kv_valid, cache_index: int) -> torch.Tensor:
        """One decoder layer (reference LlamaBlock, llama.py:180-309):
        x [B, S, hidden]; with a cache, k/v are written at [cache_index,
        cache_index + S) of layer ``li`` and attention reads the whole
        layer cache under ``kv_valid``."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_kv_heads, cfg.head_dim
        h = self.input_layernorm(x, li)
        q = self.q_proj(h, li).reshape(b, s, cfg.num_heads, hd)
        k = self.k_proj(h, li).reshape(b, s, nh, hd)
        v = self.v_proj(h, li).reshape(b, s, nh, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache is not None:
            at = slice(cache_index, cache_index + s)
            if len(cache) == 4:            # int8 codes + per-entry scales
                ck, cv, ks, vs = (c[li] for c in cache)
                kq, ksc = quantize_kv(k)
                vq, vsc = quantize_kv(v)
                ck[:, at] = kq.reshape(b, s, -1)
                cv[:, at] = vq.reshape(b, s, -1)
                ks[:, at] = ksc.reshape(b, s, nh).to(ks.dtype)
                vs[:, at] = vsc.reshape(b, s, nh).to(vs.dtype)
                max_len = ck.shape[1]
                kk = (ck.reshape(b, max_len, nh, hd).to(cfg.dtype)
                      * ks[..., None].to(cfg.dtype))
                vv = (cv.reshape(b, max_len, nh, hd).to(cfg.dtype)
                      * vs[..., None].to(cfg.dtype))
            else:
                ck, cv = (c[li] for c in cache)
                ck[:, at] = k.to(ck.dtype).reshape(b, s, -1)
                cv[:, at] = v.to(cv.dtype).reshape(b, s, -1)
                max_len = ck.shape[1]
                kk = ck.reshape(b, max_len, nh, hd)
                vv = cv.reshape(b, max_len, nh, hd)
            attn = dot_product_attention(
                q, kk, vv, kv_valid=kv_valid, causal=s > 1,
                q_offset=cache_index if s > 1 else None,
                impl="plain" if s == 1 else cfg.attention_impl)
        else:
            attn = dot_product_attention(q, k, v, kv_valid=kv_valid,
                                         causal=True, impl=cfg.attention_impl)

        x = x + self.o_proj(attn.reshape(b, s, cfg.num_heads * hd), li)
        h = self.post_attention_layernorm(x, li)
        gate = self.gate_proj(h, li)
        up = self.up_proj(h, li)
        return x + self.down_proj(F.silu(gate) * up, li)


class Embedder(nn.Module):
    """Token table [vocab, hidden]; int8 rows + per-row fp32 scales under
    ``int8_full`` / ``int4`` (reference llama.py:336-349)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.vocab_size, cfg.hidden_size)
        self.quantized = cfg.quantization in ("int8_full", "int4")
        if self.quantized:
            self.register_buffer("embedding_q", torch.zeros(
                shape, dtype=torch.int8, device=device))
            self.register_buffer("embedding_scale", torch.ones(
                (cfg.vocab_size,), dtype=torch.float32, device=device))
        else:
            self.register_buffer("embedding", torch.zeros(
                shape, dtype=cfg.dtype, device=device))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        if self.quantized:
            rows = self.embedding_q[input_ids].to(dt)
            return rows * self.embedding_scale[input_ids][..., None].to(dt)
        return self.embedding[input_ids]


class LlamaForCausalLM(nn.Module):
    """Embedder + decoder layers + final norm + LM head (int8 under
    int8_full / int4)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedder(cfg, device)
        self.layers = LlamaLayers(cfg, device)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                            device=device)
        self.lm_head = LoRADense(
            cfg.hidden_size, cfg.vocab_size,
            quantize=("int8" if cfg.quantization in ("int8_full", "int4")
                      else "none"), dtype=cfg.dtype, device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                kv_valid: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, cache_index: int = 0):
        """Returns (logits, last hidden state, cache); the cache tensors are
        updated in place."""
        cfg = self.cfg
        x = inputs_embeds.to(cfg.dtype)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        for li in range(cfg.num_layers):
            x = self.layers.block(li, x, cache, cos, sin, kv_valid,
                                  int(cache_index))
        hidden = self.norm(x)
        return self.lm_head(hidden), hidden, cache
