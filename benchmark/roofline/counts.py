"""Operations and bytes of each kernel's work, from the model's shapes and
the tokens or images processed, never from what was launched: a kernel's
roofline reads the same work whatever implements it.

A bound is the least time the card could take: the larger of operations
over the peak of their precision and bytes over the memory bandwidth,
each input byte read once and each output byte written once.  Peaks are
the published H100 SXM figures in ``peaks.json``.  Kernel-name patterns
live one file a kernel in ``kernels/``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> Dict[str, float]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def kernel_patterns(kernel: str) -> List[str]:
    """Every name pattern any file of ``kernels/`` gives ``kernel`` (a PR
    that replaces a kernel adds a file naming its successor)."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        if spec["kernel"] == kernel:
            out += spec["patterns"]
    return out


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    p = peaks()
    return max(ops / p[peak], nbytes / p["hbm_bytes_per_s"])


# ---- the LLM ---------------------------------------------------------------

def llm_dims(cfg: Dict) -> Dict[str, int]:
    d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = d // nh
    return {"d": d, "f": cfg["intermediate_size"], "L": cfg["num_hidden_layers"],
            "hq": nh, "hkv": cfg["num_key_value_heads"], "hd": hd,
            "V": cfg["vocab_size"]}


def projections(cfg: Dict) -> List[Tuple[int, int]]:
    """(in, out) of the seven int4 projections of one layer."""
    m = llm_dims(cfg)
    d, f, q, kv = m["d"], m["f"], m["hq"] * m["hd"], m["hkv"] * m["hd"]
    return [(d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d)]


def int4_call(rows: float, n_in: int, n_out: int, group: int
              ) -> Tuple[float, float]:
    """(int8 ops, bytes) of one W4A8 call: int4 codes and fp32 group
    scales read once, bf16 rows in and out."""
    ops = 2.0 * rows * n_in * n_out
    nbytes = (n_in * n_out / 2 + n_in / group * n_out * 4
              + rows * (n_in + n_out) * 2)
    return ops, nbytes


def k2_bound_s(cfg: Dict, calls: Iterable[float]) -> float:
    """Least time of K2 over passes of the whole model, one pass per
    entry of ``calls`` with that many rows in each projection."""
    group = cfg["serving"]["group_size"]
    L = llm_dims(cfg)["L"]
    total = 0.0
    for rows in calls:
        for n_in, n_out in projections(cfg):
            total += L * bound_s(*int4_call(rows, n_in, n_out, group),
                                 "int8_ops_per_s")
    return total


def k3_bound_s(cfg: Dict, tokens: int, kv_positions: int) -> float:
    """Least time of the one-query decode attention: each live row's
    valid window of the int8 cache (codes and bf16 scales of k and v)
    read once a step, q in and out bf16; QK and PV at the bf16 peak."""
    m = llm_dims(cfg)
    per_pos = 2 * m["hkv"] * (m["hd"] + 2)
    nbytes = m["L"] * (kv_positions * per_pos
                       + tokens * 2 * m["hq"] * m["hd"] * 2)
    ops = m["L"] * 4.0 * kv_positions * m["hq"] * m["hd"]
    return bound_s(ops, nbytes, "bf16_flops_per_s")


def causal_attn(cfg: Dict, p: int) -> Tuple[float, float]:
    """(bf16 ops, bytes) of one layer's causal self-attention over a
    p-token prompt: the lower triangle of QK and PV, q / k / v / o once."""
    m = llm_dims(cfg)
    ops = 4.0 * m["hq"] * m["hd"] * p * (p + 1) / 2
    nbytes = 2 * p * m["hd"] * (2 * m["hq"] + 2 * m["hkv"])
    return ops, nbytes


def k1_prefill_bound_s(cfg: Dict, groups: Iterable[List[int]]) -> float:
    """Least time of K1 over prefill groups (one launch a layer a group,
    each prompt its real tokens only)."""
    L = llm_dims(cfg)["L"]
    total = 0.0
    for p_lens in groups:
        ops = sum(causal_attn(cfg, p)[0] for p in p_lens)
        nbytes = sum(causal_attn(cfg, p)[1] for p in p_lens)
        total += L * bound_s(ops, nbytes, "bf16_flops_per_s")
    return total


def proj_params(cfg: Dict) -> int:
    return sum(a * b for a, b in projections(cfg)) * llm_dims(cfg)["L"]


def resampler_ops(n_kv: int, n_q: int, dim: int, kv_dim: int) -> float:
    ops = 2.0 * n_kv * kv_dim * dim if kv_dim != dim else 0.0
    ops += 2.0 * (2 * n_q + 2 * n_kv) * dim * dim      # q, o; k, v
    return ops + 4.0 * n_q * n_kv * dim                 # QK, PV


def decode_least_s(cfg: Dict, tokens: int, kv_positions: int) -> float:
    """Least time of the model operations of decode steps that produced
    ``tokens`` tokens over ``kv_positions`` attended positions: the
    projections at the int8 peak, the LM head and attention at bf16."""
    p = peaks()
    m = llm_dims(cfg)
    int8 = 2.0 * tokens * proj_params(cfg)
    bf16 = (2.0 * tokens * m["d"] * m["V"]
            + m["L"] * 4.0 * kv_positions * m["hq"] * m["hd"])
    return int8 / p["int8_ops_per_s"] + bf16 / p["bf16_flops_per_s"]


def prefill_least_s(cfg: Dict, p_lens: Iterable[int], images: int) -> float:
    """Least time of the model operations a prefill needs: every real
    prompt token through the projections (int8 peak), causal attention
    and one row of logits a prompt (bf16), and the input resampler over
    each image's ViT tokens (bf16)."""
    p = peaks()
    m = llm_dims(cfg)
    p_lens = list(p_lens)
    int8 = 2.0 * sum(p_lens) * proj_params(cfg)
    bf16 = sum(m["L"] * causal_attn(cfg, n)[0] for n in p_lens)
    bf16 += 2.0 * len(p_lens) * m["d"] * m["V"]
    a = cfg["agent"]
    bf16 += images * resampler_ops(cfg["vision"]["n_queries"],
                                   a["num_img_in_tokens"], m["d"],
                                   a["vit_dim"])
    return int8 / p["int8_ops_per_s"] + bf16 / p["bf16_flops_per_s"]


# ---- the image stack ---------------------------------------------------------

def vit_ops(v: Dict, images: int) -> float:
    """bf16 operations of ViT-bigG over ``images`` tiles."""
    n = (v["image_size"] // v["patch_size"]) ** 2
    w, L = v["width"], v["layers"]
    hidden = int(w * v["mlp_ratio"])
    per = 2.0 * n * (v["patch_size"] ** 2 * 3) * w
    per += L * (2.0 * n * w * (4 * w + 2 * hidden) + 4.0 * n * n * w)
    per += resampler_ops(n, v["n_queries"], v["output_dim"], w)
    per += 2.0 * v["n_queries"] * v["output_dim"] ** 2
    return images * per


def unet_levels(u: Dict):
    """(tokens, channels, transformer depth) of each UNet level at the
    sampler's latent size."""
    s = u["sampler"]
    h, w = s["height"] // 8, s["width"] // 8
    out = []
    for i, (ch, kind) in enumerate(zip(u["block_out_channels"],
                                       u["down_block_types"])):
        depth = u["transformer_layers_per_block"][i] \
            if kind.startswith("CrossAttn") else 0
        out.append(((h >> i) * (w >> i), ch, depth))
    return out


def self_attn(batch: int, tokens: int, channels: int) -> Tuple[float, float]:
    """(bf16 ops, bytes) of one unmasked self-attention call: QK and PV,
    q / k / v / o read or written once."""
    return (batch * 4.0 * tokens * tokens * channels,
            batch * 4 * tokens * channels * 2)


def unet_self_attn(u: Dict, batch: int) -> Tuple[float, float]:
    """(bf16 ops, bytes) of one eval's self-attention calls: every
    transformer block's over its level's tokens (down blocks, up blocks,
    and the mid block at the last level)."""
    ops = nbytes = 0.0
    lpb = u["layers_per_block"]
    levels = unet_levels(u)
    for i, (n, ch, depth) in enumerate(levels):
        blocks = depth * (2 * lpb + 1) + (depth if i == len(levels) - 1
                                          else 0)
        o, b = self_attn(batch, n, ch)
        ops += blocks * o
        nbytes += blocks * b
    return ops, nbytes


def unet_ops(u: Dict, batch: int) -> float:
    """bf16 operations of one UNet eval at the sampler's size: convs,
    resnet time projections, transformer projections and attention."""
    lpb, ctx = u["layers_per_block"], u["cross_attention_dim"]
    levels = unet_levels(u)
    chs = [c for _, c, _ in levels]
    ops = 0.0

    def conv(n, cin, cout, k):
        return 2.0 * n * cin * cout * k * k

    def transformer(n, ch, depth):
        per = 2.0 * n * ch * ch * 2                       # proj in / out
        per += depth * (2.0 * n * ch * ch * 4             # self q k v o
                        + 2.0 * n * ch * ch * 2           # cross q o
                        + 2.0 * n * ch * 8 * ch           # GEGLU in
                        + 2.0 * n * 4 * ch * ch           # ff out
                        + 4.0 * n * n * ch)               # self QK PV
        return per

    def cross(n, ch, depth, kv):
        return depth * (2.0 * kv * ctx * ch * 2 + 4.0 * n * kv * ch)

    kv_tokens = u["resampler"]["num_queries"]
    n0 = levels[0][0]
    ops += conv(n0, u["in_channels"], chs[0], 3)
    skips = [chs[0]]
    ch_in = chs[0]
    for i, (n, ch, depth) in enumerate(levels):
        for _ in range(lpb):
            ops += conv(n, ch_in, ch, 3) + conv(n, ch, ch, 3)
            if ch_in != ch:
                ops += conv(n, ch_in, ch, 1)
            if depth:
                ops += transformer(n, ch, depth) + cross(n, ch, depth,
                                                         kv_tokens)
            ch_in = ch
            skips.append(ch)
        if i < len(levels) - 1:
            ops += conv(levels[i + 1][0], ch, ch, 3)
            skips.append(ch)
    n, ch, depth = levels[-1]
    ops += 2 * 2 * conv(n, ch, ch, 3)
    if depth:
        ops += transformer(n, ch, depth) + cross(n, ch, depth, kv_tokens)
    for i, (n, ch, depth) in enumerate(reversed(levels)):
        for _ in range(lpb + 1):
            cin = ch_in + skips.pop()
            ops += conv(n, cin, ch, 3) + conv(n, ch, ch, 3) + conv(n, cin,
                                                                  ch, 1)
            if depth:
                ops += transformer(n, ch, depth) + cross(n, ch, depth,
                                                         kv_tokens)
            ch_in = ch
        if i < len(levels) - 1:
            ops += conv(4 * n, ch, ch, 3)
    ops += conv(n0, chs[0], u["out_channels"], 3)
    return batch * ops


def vae_decoder_ops(u: Dict) -> float:
    """fp32 operations of the VAE decoder at the sampler's size."""
    v, s = u["vae"], u["sampler"]
    chs = list(v["block_out_channels"])
    lat = v["latent_channels"]
    n = (s["height"] // 8) * (s["width"] // 8)

    def conv(n, cin, cout, k):
        return 2.0 * n * cin * cout * k * k

    ops = conv(n, lat, lat, 1) + conv(n, lat, chs[-1], 3)
    c = chs[-1]
    ops += 4 * conv(n, c, c, 3) + 2.0 * n * c * c * 4 + 4.0 * n * n * c
    ch_in = c
    for i, ch in enumerate(reversed(chs)):
        for _ in range(v["layers_per_block"] + 1):
            ops += conv(n, ch_in, ch, 3) + conv(n, ch, ch, 3)
            if ch_in != ch:
                ops += conv(n, ch_in, ch, 1)
            ch_in = ch
        if i < len(chs) - 1:
            n *= 4
            ops += conv(n, ch, ch, 3)
    return ops + conv(n, chs[0], 3, 3)


def resampler_xl_ops(u: Dict, batch: int) -> float:
    r = u["resampler"]
    nq, dim, T = r["num_queries"], r["dim"], 64
    inner = r["dim_head"] * r["heads"]
    ops = 2.0 * T * r["embedding_dim"] * dim
    per = (2.0 * nq * dim * inner + 2.0 * (T + nq) * dim * 2 * inner
           + 4.0 * nq * (T + nq) * inner + 2.0 * nq * inner * dim
           + 2.0 * nq * dim * dim * r["ff_mult"] * 2)
    ops += r["depth"] * per
    ops += 2.0 * nq * dim * (r["output1_dim"] + r["output2_dim"])
    ops += 2.0 * (nq + 1) * dim * dim * 3 + 4.0 * (nq + 1) ** 2 * dim \
        + 2.0 * (nq + 1) * dim * r["output2_dim"]
    return batch * ops


def image_least_s(u: Dict) -> float:
    """Least time of one text-to-image image: the CFG UNet evals (bf16),
    ResamplerXL and the negative's ViT pass (bf16), the VAE decoder
    (fp32)."""
    p = peaks()
    s = u["sampler"]
    bf16 = s["num_inference_steps"] * unet_ops(u, 2)
    bf16 += resampler_xl_ops(u, 2) + vit_ops(u["vision"], 1)
    return bf16 / p["bf16_flops_per_s"] + vae_decoder_ops(u) / p[
        "fp32_flops_per_s"]
