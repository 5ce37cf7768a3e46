"""Plain fp32 reference of the SEED-X-I agent with DeepSeek-V2 as its LLM:
the agent's image path as ``reference/agent.py`` has it (ViT-bigG, the
input resampler, the splice), and DeepSeek-V2's forward pass (the
equations of ``DeepseekV2Attention``, ``DeepseekV2YarnRotaryEmbedding``,
``DeepseekV2MLP`` and ``DeepseekV2MoE`` in DeepSeek's public
``modeling_deepseek.py``; the same as ``tests/plain_deepseek_v2.py``) over
the whole prompt and the served tokens, with no cache:

  latent attention: q = x W_q [S, H, nope + rope]; [c, k_pe] = x W_kv_a;
  c = RMSNorm(c); [k_nope, v] = c W_kv_b; q_pe and k_pe de-interleaved,
  rotated by YaRN frequencies; softmax(scale * (q_nope . k_nope + q_pe .
  k_pe)) causal, scale = (nope + rope)^-0.5 * mscale(factor,
  mscale_all_dim)^2; . v; W_o;
  MLP: the first ``first_k_dense_replace`` layers SwiGLU, the rest the
  top-k of an fp32 softmax router (greedy, not renormalised) over the
  routed experts plus the shared experts' SwiGLU.

Weights come from ``benchmark.harness.weights.draw`` by leaf name, as the
program's do (bf16, the configuration's serving precision), and are used
in fp32, one layer at a time and the experts a block at a time, with TF32
off.  It imports nothing of the program.

``bits="fp8"`` (the control, one precision below the bf16 the
configuration states): every product's input rows, its weight columns
and its output rounded to fp8 e4m3 (each row or column scaled to its
range), and the latent cache rows too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.agent import (Agent, Leaves, constrained, fake_quant,
                                       free_positions, matmul,
                                       plain_precision, rms_norm, splice_mask,
                                       tiles, vit)

EXPERT_BLOCK = 16     # experts converted to fp32 at a time


def leaf_shapes(cfg: Dict) -> Dict[str, tuple]:
    """The LLM's leaves (the program's names under ``llm.``) and shapes."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    kd = cfg["first_k_dense_replace"]
    lm, e = L - kd, cfg["n_routed_experts"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = fe * cfg["n_shared_experts"]
    p = "layers."
    out = {"embed_tokens.embedding": (cfg["vocab_size"], d),
           p + "input_layernorm.scale": (L, d),
           p + "q_proj.kernel": (L, d, nh * (dn + dr)),
           p + "kv_a_proj.kernel": (L, d, r + dr),
           p + "kv_a_layernorm.scale": (L, r),
           p + "kv_b_proj.kernel": (L, r, nh * (dn + dv)),
           p + "o_proj.kernel": (L, nh * dv, d),
           p + "post_attention_layernorm.scale": (L, d),
           p + "gate_proj.kernel": (kd, d, f),
           p + "up_proj.kernel": (kd, d, f),
           p + "down_proj.kernel": (kd, f, d),
           p + "router.kernel": (lm, d, e),
           p + "experts.gate_proj": (lm, e, d, fe),
           p + "experts.up_proj": (lm, e, d, fe),
           p + "experts.down_proj": (lm, e, fe, d),
           "norm.scale": (d,),
           "lm_head.kernel": (d, cfg["vocab_size"])}
    if fs:
        out.update({p + "shared_gate_proj.kernel": (lm, d, fs),
                    p + "shared_up_proj.kernel": (lm, d, fs),
                    p + "shared_down_proj.kernel": (lm, fs, d)})
    return out


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


class DeepSeekV2(Agent):
    """The agent (input resampler, splice: ``reference/agent.Agent``) with
    DeepSeek-V2 as its LLM, fp32."""

    def __init__(self, seed: int, cfg: Dict, device,
                 bits: Optional[str] = None):
        self.cfg, self.device, self.bits = cfg, device, bits
        self.W = Leaves(seed, "agent.", device)
        self.shapes = leaf_shapes(cfg)

    def w(self, name: str, *index) -> torch.Tensor:
        t = self.W("llm." + name, self.shapes[name])
        for i in index:
            t = t[i]
        return t.float()

    def mm(self, x, w):
        return matmul(x, w, self.bits)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w("embed_tokens.embedding")[ids]

    def attention(self, li: int, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        nh, dn = c["num_attention_heads"], c["qk_nope_head_dim"]
        dr, dv, r = c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
        p = "layers."
        q = self.mm(h, self.w(p + "q_proj.kernel", li)).reshape(s, nh, -1)
        kv_a = self.mm(h, self.w(p + "kv_a_proj.kernel", li))
        latent = torch.cat([
            rms_norm(kv_a[:, :r], self.w(p + "kv_a_layernorm.scale", li),
                     c["rms_norm_eps"]),
            rope(kv_a[:, None, r:], c)[:, 0]], dim=-1)
        latent = fake_quant(latent, self.bits)      # the cache's rows
        kv = self.mm(latent[:, :r], self.w(p + "kv_b_proj.kernel", li)
                     ).reshape(s, nh, dn + dv)
        q_pe = rope(q[..., dn:], c)
        scores = (torch.einsum("qhd,khd->hqk", q[..., :dn], kv[..., :dn])
                  + torch.einsum("qhd,kd->hqk", q_pe, latent[:, r:]))
        scores = scores * softmax_scale(c)
        mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        out = torch.einsum("hqk,khd->qhd", probs, kv[..., dn:])
        out = fake_quant(out.reshape(s, nh * dv), self.bits)
        return self.mm(out, self.w(p + "o_proj.kernel", li))

    def swiglu(self, x, gate, up, down):
        act = F.silu(self.mm(x, gate)) * self.mm(x, up)
        return self.mm(fake_quant(act, self.bits), down)

    def experts(self, m: int, h: torch.Tensor) -> torch.Tensor:
        c, p = self.cfg, "layers."
        k, n_exp = c["num_experts_per_tok"], c["n_routed_experts"]
        scores = torch.softmax(self.mm(h, self.w(p + "router.kernel", m)), -1)
        weight, ids = torch.topk(scores, k, dim=-1)
        weight = weight * c.get("routed_scaling_factor", 1.0)
        y = torch.zeros_like(h)
        names = [p + "experts." + n for n in ("gate_proj", "up_proj",
                                               "down_proj")]
        stacks = [self.W("llm." + n, self.shapes[n])[m] for n in names]
        for e0 in range(0, n_exp, EXPERT_BLOCK):
            block = [s[e0:e0 + EXPERT_BLOCK].float() for s in stacks]
            for j in range(block[0].shape[0]):
                tok, slot = torch.where(ids == e0 + j)
                if tok.numel():
                    out = self.swiglu(h[tok], *(b[j] for b in block))
                    y.index_add_(0, tok, out * weight[tok, slot, None])
            del block
        if c.get("n_shared_experts"):
            y = y + self.swiglu(h, self.w(p + "shared_gate_proj.kernel", m),
                                self.w(p + "shared_up_proj.kernel", m),
                                self.w(p + "shared_down_proj.kernel", m))
        return y

    @torch.no_grad()
    def logits(self, seqs: List[Dict]) -> List[torch.Tensor]:
        """Each seq: ``ids`` [S] (long), optional ``image_tokens`` [M, d]
        at ``cmp`` [S] bool, and ``rows`` (the positions whose logits are
        wanted).  Returns fp32 logits [len(rows), vocab] per seq."""
        c, p = self.cfg, "layers."
        eps, kd = c["rms_norm_eps"], c["first_k_dense_replace"]
        xs = []
        for s in seqs:
            x = self.embed(s["ids"])
            if s.get("image_tokens") is not None:
                x = x.clone()
                x[s["cmp"]] = s["image_tokens"]
            xs.append(x)
        for li in range(c["num_hidden_layers"]):
            for i, x in enumerate(xs):
                h = fake_quant(rms_norm(x, self.w(p + "input_layernorm.scale",
                                                  li), eps), self.bits)
                x = x + self.attention(li, h)
                h = fake_quant(rms_norm(
                    x, self.w(p + "post_attention_layernorm.scale", li), eps),
                    self.bits)
                if li < kd:
                    x = x + self.swiglu(h, self.w(p + "gate_proj.kernel", li),
                                        self.w(p + "up_proj.kernel", li),
                                        self.w(p + "down_proj.kernel", li))
                else:
                    x = x + self.experts(li - kd, h)
                xs[i] = fake_quant(x, self.bits)
        head, norm = self.w("lm_head.kernel"), self.w("norm.scale")
        return [self.mm(fake_quant(rms_norm(x[s["rows"]], norm, eps),
                                   self.bits), head)
                for x, s in zip(xs, seqs)]


@torch.no_grad()
@plain_precision()
def served_gaps(seed: int, cfg: Dict, requests: List[Dict], device,
                bits: Optional[str] = None,
                pick: str = "served") -> List[float]:
    """``reference/agent.served_gaps``'s contract on DeepSeek-V2: per
    request, the widest gap by which a served token's reference logit lies
    below the reference's best, over the positions where the token was
    the model's free choice.  With ``pick="argmax"`` (the control) the
    token read at each position is the one the reference at ``bits`` puts
    first, the gap read in the fp32 reference's logits."""
    markers = cfg["markers"]
    n_img = cfg["agent"]["num_img_out_tokens"]
    agent = DeepSeekV2(seed, cfg, device)
    seqs, arrs, poss, counts = [], [], [], []
    for r in requests:
        ids = list(r["ids"]) + list(r["tokens"][:-1])
        s = {"ids": torch.tensor(ids, device=device),
             "rows": torch.arange(len(r["ids"]) - 1, len(ids),
                                  device=device)}
        if r.get("image") is not None:
            arr, pos = tiles(r["image"], r["grid"], cfg["vision"]["image_size"])
            arrs.append(arr)
            poss.append(pos)
            s["cmp"] = torch.from_numpy(splice_mask(ids, markers)).to(device)
        counts.append(0 if r.get("image") is None else len(arr))
        seqs.append(s)
    if arrs:
        feats = vit(seed, cfg, torch.from_numpy(np.concatenate(arrs)).to(
            device))
        img = agent.image_tokens(feats, torch.from_numpy(
            np.concatenate(poss)).to(device))
        at = 0
        for s, n in zip(seqs, counts):
            if n:
                s["image_tokens"] = img[at:at + n].reshape(-1, img.shape[-1])
                at += n
        del feats
    ref = agent.logits(seqs)
    low = None
    if pick == "argmax":
        low_agent = DeepSeekV2(seed, cfg, device, bits)
        low_agent.W = agent.W
        low = low_agent.logits(seqs)
    gaps = []
    for i, r in enumerate(requests):
        lg = constrained(ref[i], markers, n_img)
        free = torch.from_numpy(free_positions(r["tokens"], markers,
                                               n_img)).to(device)
        if low is None:
            tok = torch.tensor(r["tokens"], device=device)
        else:
            tok = constrained(low[i], markers, n_img).argmax(dim=-1)
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        gaps.append(float(torch.where(free, gap, 0.0).max()))
    return gaps
