"""Plain fp32 reference of DeepSeek-V2's forward pass (the equations of
``DeepseekV2Attention``, ``DeepseekV2YarnRotaryEmbedding``,
``DeepseekV2MLP`` and ``DeepseekV2MoE`` in DeepSeek's public
``modeling_deepseek.py``), written out in plain ``torch``: no kernel, no
cache, no batching.  It imports neither JAX nor ``seedx_tpu_torch``.

``forward(cfg, params, embeds)``: ``cfg`` holds the published
``config.json`` keys (``hidden_size``, ``kv_lora_rank``, ``rope_scaling``,
...), ``params`` the weights under the port's leaf names with the stacked
leading layer axis ([in, out] kernels), ``embeds`` one sequence's input
embeddings [S, hidden].  Every product runs in fp32 with TF32 off.  Per
layer, for x after ``input_layernorm``:

  q = x W_q -> [S, H, nope + rope]; [c, k_pe] = x W_kv_a; c = RMSNorm(c);
  [k_nope, v] = c W_kv_b -> [S, H, nope], [S, H, v];
  q_pe, k_pe roped (de-interleaved, then rotate-half, YaRN frequencies,
  cos / sin times mscale(factor, mscale) / mscale(factor, mscale_all_dim));
  softmax(scale * (q_nope . k_nope + q_pe . k_pe)), causal, with
  scale = (nope + rope)^-0.5 * mscale(factor, mscale_all_dim)^2; then . v
  and W_o.
  MLP: the first ``first_k_dense_replace`` layers SwiGLU; the rest route
  by softmax(x W_router) in fp32, take the top ``num_experts_per_tok``
  scores (greedy, not renormalised, times ``routed_scaling_factor``) and
  add sum_k w_k SwiGLU_k(x) to the shared experts' SwiGLU.
Then the final RMSNorm and the untied LM head.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(cfg: Dict, dim: int):
    """(inv_freq [dim / 2], cos / sin factor) of the configuration's rope."""
    base = float(cfg["rope_theta"])
    freq_extra = 1.0 / base ** (torch.arange(0, dim, 2).float() / dim)
    rs = cfg.get("rope_scaling")
    if not rs:
        return freq_extra, 1.0
    factor = float(rs["factor"])
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2).float() - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    inv = (freq_extra / factor) * (1.0 - keep) + freq_extra * keep
    return inv, mscale(factor, rs["mscale"]) / mscale(factor,
                                                       rs["mscale_all_dim"])


def softmax_scale(cfg: Dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = mscale(float(rs["factor"]), rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope(x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """x [S, heads, d] at positions 0..S-1: de-interleave, rotate half."""
    s, h, d = x.shape
    inv, ms = yarn(cfg, d)
    ang = torch.arange(s).float()[:, None].to(x.device) * inv.to(x.device)
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = (torch.cos(ang) * ms)[:, None], (torch.sin(ang) * ms)[:, None]
    x = x.reshape(s, h, d // 2, 2).transpose(-1, -2).reshape(s, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def attention(cfg: Dict, w: Callable, li: int, h: torch.Tensor
              ) -> torch.Tensor:
    """One layer's latent attention over h [S, hidden] (normed)."""
    s = h.shape[0]
    nh, dn = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    dr, dv, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (h @ w("layers.q_proj.kernel", li)).reshape(s, nh, dn + dr)
    kv_a = h @ w("layers.kv_a_proj.kernel", li)
    c = rms(kv_a[:, :r], w("layers.kv_a_layernorm.scale", li),
            cfg["rms_norm_eps"])
    kv = (c @ w("layers.kv_b_proj.kernel", li)).reshape(s, nh, dn + dv)
    q_pe = rope(q[..., dn:], cfg)
    k_pe = rope(kv_a[:, None, r:], cfg)
    scores = (torch.einsum("qhd,khd->hqk", q[..., :dn], kv[..., :dn])
              + torch.einsum("qhd,kd->hqk", q_pe, k_pe[:, 0]))
    scores = scores * softmax_scale(cfg)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, kv[..., dn:])
    return out.reshape(s, nh * dv) @ w("layers.o_proj.kernel", li)


def experts(cfg: Dict, w: Callable, m: int, h: torch.Tensor) -> torch.Tensor:
    """MoE layer ``m``'s output for h [S, hidden]: the routed experts (on
    this reference's own fp32 scores) plus the shared experts."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(h @ w("layers.router.kernel", m), dim=-1)
    weight, ids = torch.topk(scores, k, dim=-1)
    weight = weight * cfg.get("routed_scaling_factor", 1.0)
    y = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.where(ids == e)
        if tok.numel():
            out = swiglu(h[tok], w("layers.experts.gate_proj", m, e),
                         w("layers.experts.up_proj", m, e),
                         w("layers.experts.down_proj", m, e))
            y.index_add_(0, tok, out * weight[tok, slot, None])
    if cfg.get("n_shared_experts"):
        y = y + swiglu(h, w("layers.shared_gate_proj.kernel", m),
                       w("layers.shared_up_proj.kernel", m),
                       w("layers.shared_down_proj.kernel", m))
    return y


@torch.no_grad()
def forward(cfg: Dict, params: Dict[str, torch.Tensor],
            embeds: torch.Tensor) -> torch.Tensor:
    """embeds [S, hidden] -> fp32 logits [S, vocab]."""
    def w(name, *index):
        t = params[name]
        for i in index:
            t = t[i]
        return t.float()

    eps, kd = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
    with no_tf32():
        x = embeds.float()
        for li in range(cfg["num_hidden_layers"]):
            h = rms(x, w("layers.input_layernorm.scale", li), eps)
            x = x + attention(cfg, w, li, h)
            h = rms(x, w("layers.post_attention_layernorm.scale", li), eps)
            if li < kd:
                x = x + swiglu(h, w("layers.gate_proj.kernel", li),
                               w("layers.up_proj.kernel", li),
                               w("layers.down_proj.kernel", li))
            else:
                x = x + experts(cfg, w, li - kd, h)
        return rms(x, w("norm.scale"), eps) @ w("lm_head.kernel")
