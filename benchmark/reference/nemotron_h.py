"""Plain fp32 reference of the SEED-X-I agent's LLM when it is
Nemotron-H: the forward pass of NVIDIA's public ``modeling_nemotron_h.py``
(the same equations as ``tests/plain_nemotron_h.py``) over the whole
prompt and the served tokens, text only, with no cache:

  block i of kind P[i] (at its ordinal j among the blocks of that kind):
  x = x + mixer(RMSNorm_i(x)), the norm in fp32;
  M, Mamba-2: [z | xBC | dt] = h W_in; xBC = silu(causal depthwise conv1d
  + bias); x [H, P], B / C [G, N] (head h reads group h // (H / G));
  dt = softplus(dt + dt_bias); A = -exp(A_log); token by token from a zero
  state, S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t + D x_t
  (the published recurrence, not the program's chunked scan); y * silu(z)
  RMS-normed over G groups, times its scale; W_out;
  *, attention: GQA without rotary embedding, causal softmax(q k /
  sqrt(D)) v; W_o;
  E, experts: sigmoid(h W_router) in fp32, the top k of the scores plus
  the score-correction bias, their scores renormalised (+ 1e-20) times
  routed_scaling_factor; sum_k w_k down_k(relu(up_k h)^2) plus the shared
  expert's down(relu(up h)^2).
  Then the final RMSNorm and the untied LM head.

Weights come from ``benchmark.harness.weights.draw`` by leaf name, as the
program's do (bf16, the configuration's serving precision; the
correction bias fp32), kept in bf16 and used in fp32 one block at a time
(the experts a few at a time), with TF32 off: the fp32 model (126 GB)
does not fit beside nothing on one card.  It imports nothing of the
program.

``bits="fp8"`` (the control, one precision below what the configuration
states everywhere): every product's input rows, its weight columns and
its output rounded to fp8 e4m3 (each row or column scaled to its range),
the KV rows too (bf16 stated); the SSM state rounded to bf16 after every
token and the router's logits to bf16 (fp32 stated).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.agent import (Leaves, constrained, fake_quant,
                                       free_positions, matmul,
                                       plain_precision, rms_norm)

EXPERT_BLOCK = 16     # experts converted to fp32 at a time
F32 = torch.float32


def leaf_shapes(cfg: Dict) -> Dict[str, tuple]:
    """The LLM's leaves (the program's names under ``llm.``) and shapes
    (the routed experts: one leaf an expert block)."""
    pattern = cfg["hybrid_override_pattern"]
    d, L = cfg["hidden_size"], len(pattern)
    na, nm, ne = (pattern.count(k) for k in "*ME")
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    h, p = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, n, k = cfg["n_groups"], cfg["ssm_state_size"], cfg["conv_kernel"]
    d_in, c = h * p, h * p + 2 * g * n
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["moe_shared_expert_intermediate_size"]
    q = "layers."
    m = q + "mamba."
    out = {"embed_tokens.embedding": (cfg["vocab_size"], d),
           q + "input_layernorm.scale": (L, d),
           q + "q_proj.kernel": (na, d, hq * hd),
           q + "k_proj.kernel": (na, d, hkv * hd),
           q + "v_proj.kernel": (na, d, hkv * hd),
           q + "o_proj.kernel": (na, hq * hd, d),
           m + "in_proj.kernel": (nm, d, d_in + c + h),
           m + "conv_kernel": (nm, k, c), m + "conv_bias": (nm, c),
           m + "dt_bias": (nm, h), m + "A_log": (nm, h), m + "D": (nm, h),
           m + "norm.scale": (nm, d_in),
           m + "out_proj.kernel": (nm, d_in, d),
           q + "router.kernel": (ne, d, e),
           q + "e_score_correction_bias": (ne, e),
           q + "shared_up_proj.kernel": (ne, d, fs),
           q + "shared_down_proj.kernel": (ne, fs, d),
           "norm.scale": (d,),
           "lm_head.kernel": (d, cfg["vocab_size"])}
    for j in range(ne):
        out[f"{q}experts.{j}.up_proj"] = (e, d, f)
        out[f"{q}experts.{j}.down_proj"] = (e, f, d)
    return out


def bf16(x: torch.Tensor, on: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32) if on else x


class NemotronH:
    """Nemotron-H's forward pass in fp32 (see the module docstring)."""

    def __init__(self, seed: int, cfg: Dict, device,
                 bits: Optional[str] = None):
        self.cfg, self.device, self.bits = cfg, device, bits
        self.W = Leaves(seed, "agent.", device)
        self.shapes = leaf_shapes(cfg)

    def raw(self, name: str) -> torch.Tensor:
        dtype = F32 if name.endswith("correction_bias") else None
        return self.W("llm." + name, self.shapes[name], dtype)

    def w(self, name: str, *index) -> torch.Tensor:
        t = self.raw(name)
        for i in index:
            t = t[i]
        return t.float()

    def mm(self, x, w):
        return matmul(x, w, self.bits)

    def mamba(self, j: int, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        hh, p = c["mamba_num_heads"], c["mamba_head_dim"]
        g, n, k = c["n_groups"], c["ssm_state_size"], c["conv_kernel"]
        d_in = hh * p
        cd = d_in + 2 * g * n
        pre = "layers.mamba."
        proj = self.mm(h, self.w(pre + "in_proj.kernel", j))
        z, xbc, dt = proj[:, :d_in], proj[:, d_in:d_in + cd], \
            proj[:, d_in + cd:]
        kern, bias = (self.w(pre + "conv_kernel", j),
                      self.w(pre + "conv_bias", j))
        xpad = torch.cat([xbc.new_zeros(k - 1, cd), xbc])
        xbc = F.silu(sum(xpad[i:i + s] * kern[i] for i in range(k)) + bias)
        x = xbc[:, :d_in].reshape(s, hh, p)
        bh = xbc[:, d_in:d_in + g * n].reshape(s, g, n).repeat_interleave(
            hh // g, dim=1)
        ch = xbc[:, d_in + g * n:].reshape(s, g, n).repeat_interleave(
            hh // g, dim=1)
        dt = F.softplus(dt + self.w(pre + "dt_bias", j))
        decay = torch.exp(dt * -torch.exp(self.w(pre + "A_log", j)))
        d_skip = self.w(pre + "D", j)
        low = self.bits is not None
        state = h.new_zeros(hh, p, n)
        ys = []
        for t in range(s):
            state = bf16(decay[t][:, None, None] * state
                         + (dt[t][:, None] * x[t])[:, :, None]
                         * bh[t][:, None, :], low)
            ys.append((state @ ch[t][:, :, None])[..., 0]
                      + d_skip[:, None] * x[t])
        y = torch.stack(ys).reshape(s, d_in) * F.silu(z)
        yg = y.reshape(s, g, -1)
        yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True)
                              + c["norm_eps"])
        y = yg.reshape(s, d_in) * self.w(pre + "norm.scale", j)
        return self.mm(fake_quant(y, self.bits),
                       self.w(pre + "out_proj.kernel", j))

    def attention(self, j: int, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = h.shape[0]
        hq, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"])
        q = self.mm(h, self.w("layers.q_proj.kernel", j)).reshape(s, hq, hd)
        # the cache's rows
        k = fake_quant(self.mm(h, self.w("layers.k_proj.kernel", j)),
                       self.bits).reshape(s, hkv, hd)
        v = fake_quant(self.mm(h, self.w("layers.v_proj.kernel", j)),
                       self.bits).reshape(s, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
        mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        out = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, hq * hd)
        out = fake_quant(out, self.bits)
        return self.mm(out, self.w("layers.o_proj.kernel", j))

    def relu2(self, x, up, down):
        act = F.relu(self.mm(x, up)).square()
        return self.mm(fake_quant(act, self.bits), down)

    def experts(self, j: int, h: torch.Tensor) -> torch.Tensor:
        c, q = self.cfg, "layers."
        logits = bf16(h @ self.w(q + "router.kernel", j),
                      self.bits is not None)
        scores = torch.sigmoid(logits)
        ids = torch.topk(scores + self.w(q + "e_score_correction_bias", j),
                         c["num_experts_per_tok"], dim=-1).indices
        weight = scores.gather(1, ids)
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        weight = weight * c["routed_scaling_factor"]
        y = torch.zeros_like(h)
        up, down = (self.raw(f"{q}experts.{j}.{n}")
                    for n in ("up_proj", "down_proj"))
        for e0 in range(0, c["n_routed_experts"], EXPERT_BLOCK):
            bu, bd = up[e0:e0 + EXPERT_BLOCK].float(), \
                down[e0:e0 + EXPERT_BLOCK].float()
            for i in range(bu.shape[0]):
                tok, slot = torch.where(ids == e0 + i)
                if tok.numel():
                    y.index_add_(0, tok, self.relu2(h[tok], bu[i], bd[i])
                                 * weight[tok, slot, None])
            del bu, bd
        return y + self.relu2(h, self.w(q + "shared_up_proj.kernel", j),
                              self.w(q + "shared_down_proj.kernel", j))

    @torch.no_grad()
    def logits(self, seqs: List[Dict]) -> List[torch.Tensor]:
        """Each seq: ``ids`` [S] (long) and ``rows`` (the positions whose
        logits are wanted).  Returns fp32 logits [len(rows), vocab] per
        seq."""
        c = self.cfg
        pattern, eps = c["hybrid_override_pattern"], c["norm_eps"]
        mixers = {"M": self.mamba, "*": self.attention, "E": self.experts}
        emb = self.w("embed_tokens.embedding")
        xs = [emb[s["ids"]] for s in seqs]
        del emb
        for i, kind in enumerate(pattern):
            j = pattern[:i].count(kind)
            scale = self.w("layers.input_layernorm.scale", i)
            for b, x in enumerate(xs):
                h = fake_quant(rms_norm(x, scale, eps), self.bits)
                xs[b] = fake_quant(x + mixers[kind](j, h), self.bits)
        head, norm = self.w("lm_head.kernel"), self.w("norm.scale")
        return [self.mm(fake_quant(rms_norm(x[s["rows"]], norm, eps),
                                   self.bits), head)
                for x, s in zip(xs, seqs)]


@torch.no_grad()
@plain_precision()
def served_gaps(seed: int, cfg: Dict, requests: List[Dict], device,
                bits: Optional[str] = None, pick: str = "served",
                reduce: Optional[str] = "max") -> List:
    """``reference/agent.served_gaps``'s contract on Nemotron-H (text
    requests): per request, the gaps by which a served token's reference
    logit lies below the reference's best, over the positions where the
    token was the model's free choice, reduced by ``reduce``: "max" (the
    widest), "mean", or None (the gaps themselves, a CPU tensor).  With
    ``pick="argmax"`` (the control) the token read at each position is
    the one the reference at ``bits`` puts first, the gap read in the
    fp32 reference's logits."""
    markers = cfg["markers"]
    n_img = cfg["agent"]["num_img_out_tokens"]
    if any(r.get("image") is not None for r in requests):
        raise ValueError("the Nemotron-H reference reads text requests")
    model = NemotronH(seed, cfg, device)
    seqs = []
    for r in requests:
        ids = list(r["ids"]) + list(r["tokens"][:-1])
        seqs.append({"ids": torch.tensor(ids, device=device),
                     "rows": torch.arange(len(r["ids"]) - 1, len(ids),
                                          device=device)})
    ref = model.logits(seqs)
    low = None
    if pick == "argmax":
        low_model = NemotronH(seed, cfg, device, bits)
        low_model.W = model.W
        low = low_model.logits(seqs)
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
        gap = gap[free]
        gaps.append(gap.cpu() if reduce is None
                    else float(gap.max() if reduce == "max" else gap.mean()))
    return gaps
