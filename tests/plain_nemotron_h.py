"""Plain fp32 reference of Nemotron-H's forward pass (the equations of
``NemotronHBlock``, ``NemotronHMamba2Mixer``, ``NemotronHAttention``,
``NemotronHMOE`` and ``NemotronHMLP`` in NVIDIA's public
``modeling_nemotron_h.py``), written out in plain ``torch``: no kernel, no
cache, no batching.  It imports neither JAX nor ``seedx_tpu_torch``.

``forward(cfg, params, embeds)``: ``cfg`` holds the published
``config.json`` keys (``hybrid_override_pattern``, ``mamba_num_heads``,
``n_groups``, ``moe_shared_expert_intermediate_size``, ...), ``params`` the
weights under the port's leaf names (each kind stacked over its own
blocks, the routed experts one leaf a block, [in, out] kernels),
``embeds`` one sequence's input embeddings [S, hidden].  Every product
runs in fp32 with TF32 off.  Block i of kind P[i], at its ordinal j among
the blocks of that kind, is ``x = x + mixer(RMSNorm_i(x))``:

  M (Mamba-2): [z | xBC | dt] = h W_in; xBC = silu(causal depthwise
  conv1d(xBC) + bias) over zeros before position 0; x [H, P], B and C
  [G, N] (head h reads group h // (H / G)); dt = softplus(dt + dt_bias),
  A = -exp(A_log); then, token by token from S = 0 (the published
  recurrence, not the chunked scan the program runs):
      S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,  y_t = S_t C_t + D x_t;
  y = y * silu(z), RMS-normed over G groups of H * P / G, times the
  norm's scale; W_out.
  * (attention): q = h W_q [S, Hq, D], k / v = h W_k / W_v [S, Hkv, D],
  no rotary embedding, causal softmax(q k / sqrt(D)) v with q head j
  reading kv head j // (Hq / Hkv); W_o.
  E (experts): scores = sigmoid(h W_router) in fp32; the top k of
  scores + e_score_correction_bias; weights = their scores / (sum + 1e-20)
  * routed_scaling_factor; sum_k w_k down_k(relu(up_k h)^2) plus the
  shared expert's down(relu(up h)^2).
Then the final RMSNorm and the untied LM head.  The embedding is not
scaled.
"""

from __future__ import annotations

import contextlib
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


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def relu2_mlp(x, up, down):
    return F.relu(x @ up).square() @ down


def mamba(cfg: Dict, w: Callable, j: int, h: torch.Tensor) -> torch.Tensor:
    """Mamba block j over h [S, hidden], the recurrence token by token."""
    s = h.shape[0]
    hh, p = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, n, k = cfg["n_groups"], cfg["ssm_state_size"], cfg["conv_kernel"]
    d_in = hh * p
    c = d_in + 2 * g * n
    pre = "layers.mamba."
    proj = h @ w(pre + "in_proj.kernel", j)
    z, xbc, dt = proj[:, :d_in], proj[:, d_in:d_in + c], proj[:, d_in + c:]
    kern, bias = w(pre + "conv_kernel", j), w(pre + "conv_bias", j)
    xpad = torch.cat([xbc.new_zeros(k - 1, c), xbc])
    xbc = F.silu(sum(xpad[i:i + s] * kern[i] for i in range(k)) + bias)
    x = xbc[:, :d_in].reshape(s, hh, p)
    bm = xbc[:, d_in:d_in + g * n].reshape(s, g, n)
    cm = xbc[:, d_in + g * n:].reshape(s, g, n)
    bh = bm.repeat_interleave(hh // g, dim=1)
    ch = cm.repeat_interleave(hh // g, dim=1)
    dt = F.softplus(dt + w(pre + "dt_bias", j))
    a = -torch.exp(w(pre + "A_log", j))
    d_skip = w(pre + "D", j)
    state = h.new_zeros(hh, p, n)
    ys = []
    for t in range(s):
        state = torch.exp(dt[t] * a)[:, None, None] * state \
            + (dt[t][:, None] * x[t])[:, :, None] * bh[t][:, None, :]
        ys.append((state @ ch[t][:, :, None])[..., 0] + d_skip[:, None] * x[t])
    y = torch.stack(ys).reshape(s, d_in) * F.silu(z)
    yg = y.reshape(s, g, -1)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True)
                          + cfg["norm_eps"])
    y = yg.reshape(s, d_in) * w(pre + "norm.scale", j)
    return y @ w(pre + "out_proj.kernel", j)


def attention(cfg: Dict, w: Callable, j: int, h: torch.Tensor
              ) -> torch.Tensor:
    s = h.shape[0]
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    q = (h @ w("layers.q_proj.kernel", j)).reshape(s, hq, d)
    k = (h @ w("layers.k_proj.kernel", j)).reshape(s, hkv, d)
    v = (h @ w("layers.v_proj.kernel", j)).reshape(s, hkv, d)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * d ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, hq * d)
    return out @ w("layers.o_proj.kernel", j)


def route(cfg: Dict, w: Callable, j: int, h: torch.Tensor):
    """(weights [S, k], ids [S, k]) of the sigmoid router."""
    scores = torch.sigmoid(h @ w("layers.router.kernel", j))
    ids = torch.topk(scores + w("layers.e_score_correction_bias", j),
                     cfg["num_experts_per_tok"], dim=-1).indices
    weight = scores.gather(1, ids)
    weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return weight * cfg["routed_scaling_factor"], ids


def experts(cfg: Dict, w: Callable, j: int, h: torch.Tensor) -> torch.Tensor:
    weight, ids = route(cfg, w, j, h)
    y = torch.zeros_like(h)
    up, down = (w(f"layers.experts.{j}.{n}") for n in ("up_proj",
                                                         "down_proj"))
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.where(ids == e)
        if tok.numel():
            y.index_add_(0, tok, relu2_mlp(h[tok], up[e], down[e])
                         * weight[tok, slot, None])
    return y + relu2_mlp(h, w("layers.shared_up_proj.kernel", j),
                         w("layers.shared_down_proj.kernel", j))


def forward(cfg: Dict, params: Dict[str, torch.Tensor],
            embeds: torch.Tensor) -> torch.Tensor:
    """Logits [S, vocab] of one sequence (see the module docstring)."""
    def w(name, j=None):
        t = params[name].float()
        return t if j is None else t[j]

    pattern, eps = cfg["hybrid_override_pattern"], cfg["norm_eps"]
    mixers = {"M": mamba, "*": attention, "E": experts}
    with no_tf32():
        x = embeds.float()
        for i, kind in enumerate(pattern):
            h = rms(x, w("layers.input_layernorm.scale", i), eps)
            x = x + mixers[kind](cfg, w, pattern[:i].count(kind), h)
        return rms(x, w("norm.scale"), eps) @ w("lm_head.kernel")
