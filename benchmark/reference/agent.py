"""Plain fp32 reference of the SEED-X-I comprehension stack: the anyres
tiling and CLIP transform, ViT-bigG/14 with its attention pool, the
agent's input resampler and patch positions, the image tokens spliced into
the prompt, and the LLaMA-block LLM (RMSNorm, RoPE, SwiGLU, causal
attention, untied head) over the whole prompt and the served tokens, with
no cache.

Weights come from ``benchmark.harness.weights.draw`` by leaf name, as the
program's do; the reference quantizes them itself as the configuration
serves them (int4 g128 projections, int8 embedding rows, int8 LM head
columns) and computes everything else in fp32 with TF32 off.  It imports
nothing of the program.

``act_bits`` / ``kv_bits`` (None: fp32) fake-quantize each projection's
input rows and each key and value vector to that many bits, symmetric
absmax: the control, one precision below what the configuration states
(int4 for its int8 activations and KV cache).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from benchmark.harness.weights import draw

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BF16 = torch.bfloat16


@contextlib.contextmanager
def plain_precision():
    """fp32 matmuls and convolutions without TF32 while a reference runs
    (a context, or a decorator); the flags are given back as they were."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


# ---- quantizers (the configuration's rules, written out) ------------------

def int4_groups(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """[in, out] -> its int4 g``group`` quantization, dequantized: scale
    absmax / 7 per (group of in, out), codes rounded into [-7, 7]."""
    n_in, n_out = w.shape
    g = w.float().reshape(n_in // group, group, n_out)
    scale = g.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 7.0
    return (torch.clamp(torch.round(g / scale), -7, 7) * scale).reshape(
        n_in, n_out)


def int8_columns(w: torch.Tensor) -> torch.Tensor:
    """[in, out] -> int8 per output column (absmax / 127), dequantized."""
    w = w.float()
    scale = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def int8_rows(t: torch.Tensor) -> torch.Tensor:
    """[rows, d] -> int8 per row (absmax / 127), dequantized."""
    t = t.float()
    scale = t.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(t / scale), -127, 127) * scale


def fake_quant(x: torch.Tensor, bits) -> torch.Tensor:
    """Symmetric absmax fake quantization over the last dim: ``bits`` an
    integer width, or ``"fp8"`` (e4m3, each row scaled to its range)."""
    if bits is None:
        return x
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6)
    if bits == "fp8":
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    q = 2 ** (bits - 1) - 1
    scale = amax / q
    return torch.clamp(torch.round(x / scale), -q, q) * scale


# ---- image in --------------------------------------------------------------

def grid_shape(grid: str):
    a, b = grid.split("x")
    return int(a), int(b)


def tiles(image: np.ndarray, grid: str, base: int):
    """An image whose size is its grid's (``grid`` columns x rows of
    ``base`` pixels) -> (tiles + thumbnail [n, base, base, 3] fp32 after
    the CLIP transform, their centre positions [n, 2])."""
    gw, gh = grid_shape(grid)
    h, w = image.shape[:2]
    if (w, h) != (gw * base, gh * base):
        raise ValueError(f"image {w}x{h} is not grid {grid} of {base}")
    crops = [image[r * base:(r + 1) * base, c * base:(c + 1) * base]
             for r in range(gh) for c in range(gw)]
    thumb = np.asarray(Image.fromarray(image).resize((base, base),
                                                     Image.BICUBIC))
    arr = np.stack(crops + [thumb]).astype(np.float32) / 255.0
    arr = (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(
        CLIP_STD, np.float32)
    pos = [((c + 0.5) / gw, (r + 0.5) / gh)
           for r in range(gh) for c in range(gw)] + [(0.5, 0.5)]
    return arr, np.asarray(pos, np.float32)


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), eps)


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """q [B, Sq, H, D], k / v [B, Sk, H, D], fp32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (scale or 1.0 / math.sqrt(d))
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def bicubic_tokens(table: torch.Tensor, n: int) -> torch.Tensor:
    """A square [m, C] token table resized to n tokens (torch bicubic,
    align_corners False)."""
    src, tgt = math.isqrt(table.shape[0]), math.isqrt(n)
    if src == tgt:
        return table
    grid = table.float().reshape(src, src, -1).permute(2, 0, 1)[None]
    out = F.interpolate(grid, size=(tgt, tgt), mode="bicubic",
                        align_corners=False)
    return out[0].permute(1, 2, 0).reshape(tgt * tgt, -1)


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """The resamplers' fixed 2D sincos table [grid**2, dim] (w first)."""
    pos = np.arange(grid, dtype=np.float32)
    gw, gh = np.meshgrid(pos, pos)

    def one(d, coords):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float32) / (d / 2))
        out = np.einsum("m,d->md", coords.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return torch.from_numpy(np.concatenate([one(dim // 2, gw),
                                            one(dim // 2, gh)], axis=1))


class Leaves:
    """fp32 views of the leaves drawn under one prefix, in the dtype the
    program serves them in."""

    def __init__(self, seed: int, prefix: str, device, dtype=BF16):
        self.seed, self.prefix, self.device = seed, prefix, device
        self.dtype = dtype
        self.cache: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str, shape, dtype=None) -> torch.Tensor:
        key = self.prefix + name
        if key not in self.cache:
            self.cache[key] = draw(self.seed, key, shape,
                                   dtype or self.dtype, self.device)
        return self.cache[key]

    def f(self, name: str, shape, dtype=None) -> torch.Tensor:
        return self(name, shape, dtype).float()


def matmul(x, w, bits=None):
    """x @ w; with ``bits`` (a control) w per output column and x per row
    fake-quantized, and the product too."""
    if not bits:
        return x @ w
    return fake_quant(fake_quant(x, bits) @ fake_quant(w.T, bits).T, bits)


def mha(W: Leaves, pre: str, q_in, k_in, v_in, dim: int, heads: int,
        bits=None):
    def proj(name, x):
        return matmul(x, W.f(f"{pre}.{name}.kernel", (dim, dim)), bits) \
            + W.f(f"{pre}.{name}.bias", (dim,))

    def split(t):
        return t.reshape(*t.shape[:-1], heads, dim // heads)

    out = attention(split(proj("q_proj", q_in)), split(proj("k_proj", k_in)),
                    split(proj("v_proj", v_in)))
    return proj("out_proj", fake_quant(out.reshape(*q_in.shape[:-1], dim),
                                       bits))


def resampler(W: Leaves, pre: str, x, grid: int, dim: int, heads: int,
              kv_dim: int, bits=None):
    """The attention-pool resampler: [B, T, kv_dim] -> [B, grid**2, dim]."""
    if kv_dim != dim:
        x = matmul(x, W.f(f"{pre}.kv_proj.kernel", (kv_dim, dim)), bits)
    x = fake_quant(layer_norm(x, W(f"{pre}.ln_kv.scale", (dim,)),
                              W(f"{pre}.ln_kv.bias", (dim,)), 1e-6), bits)
    q = layer_norm(W.f(f"{pre}.query", (grid * grid, dim)),
                   W(f"{pre}.ln_q.scale", (dim,)),
                   W(f"{pre}.ln_q.bias", (dim,)), 1e-6)
    pos = sincos_2d(dim, grid).to(x.device)
    kv_pos = bicubic_tokens(pos, x.shape[1])
    q_in = (q + pos)[None].expand(x.shape[0], -1, -1)
    return mha(W, f"{pre}.attn", q_in, x + kv_pos[None], x, dim, heads, bits)


@torch.no_grad()
def vit(seed: int, cfg: Dict, images: torch.Tensor, bits=None
        ) -> torch.Tensor:
    """ViT-bigG/14 in fp32: images [N, H, W, 3] (CLIP-normalised) ->
    [N, n_queries, output_dim].  ``bits`` (a control): computed in that
    many bits where the program computes in bf16 (every layer's weights,
    inputs and outputs, the norms, the residual sums)."""
    v = cfg["vision"]
    W = Leaves(seed, "vit.", images.device)
    p, width, L, heads = v["patch_size"], v["width"], v["layers"], v["heads"]
    hidden = int(width * v["mlp_ratio"])
    n, h, w, c = images.shape

    def q(t):
        return fake_quant(t, bits)

    def ln(t, scale, bias):
        return q(layer_norm(t, scale, bias, 1e-6))

    x = images.float().reshape(n, h // p, p, w // p, p, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, (h // p) * (w // p), p * p * c)
    x = matmul(x, W.f("conv1.kernel", (p, p, 3, width)).reshape(
        p * p * c, width), bits)
    x = q(x + bicubic_tokens(W.f("positional_embedding", (256, width)),
                             x.shape[1])[None])
    x = ln(x, W("ln_pre.scale", (width,)), W("ln_pre.bias", (width,)))
    B = "blocks."

    def lw(name, shape, li):
        return W(B + name, (L,) + shape)[li].float()

    for li in range(L):
        y = ln(x, lw("ln_1.scale", (width,), li),
               lw("ln_1.bias", (width,), li))
        qkv = matmul(y, lw("in_proj.kernel", (width, 3 * width), li), bits) \
            + lw("in_proj.bias", (3 * width,), li)
        qq, k, vv = (t.reshape(n, -1, heads, width // heads)
                     for t in qkv.chunk(3, dim=-1))
        a = q(attention(qq, k, vv).reshape(n, -1, width))
        x = q(x + matmul(a, lw("out_proj.kernel", (width, width), li), bits)
              + lw("out_proj.bias", (width,), li))
        y = ln(x, lw("ln_2.scale", (width,), li),
               lw("ln_2.bias", (width,), li))
        y = q(F.gelu(matmul(y, lw("mlp.c_fc.kernel", (width, hidden), li),
                            bits) + lw("mlp.c_fc.bias", (hidden,), li)))
        x = q(x + matmul(y, lw("mlp.c_proj.kernel", (hidden, width), li),
                         bits) + lw("mlp.c_proj.bias", (width,), li))
    od = v["output_dim"]
    grid = math.isqrt(v["n_queries"])
    x = resampler(W, "attn_pool", x, grid, od, max(1, od // 128), width,
                  bits)
    x = ln(x, W("ln_post.scale", (od,)), W("ln_post.bias", (od,)))
    return matmul(x, W.f("proj", (od, od)), bits)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, positions, theta):
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions.float()[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


class Agent:
    """The agent's LLM, input resampler and splice, fp32."""

    def __init__(self, seed: int, cfg: Dict, device,
                 act_bits: Optional[int] = None,
                 kv_bits: Optional[int] = None):
        self.cfg, self.device = cfg, device
        self.act_bits, self.kv_bits = act_bits, kv_bits
        self.W = Leaves(seed, "agent.", device)
        self.group = cfg["serving"]["group_size"]

    def shapes(self):
        c = self.cfg
        d, f = c["hidden_size"], c["intermediate_size"]
        hq = c["num_attention_heads"] * (d // c["num_attention_heads"])
        hkv = c["num_key_value_heads"] * (d // c["num_attention_heads"])
        return {"q_proj": (d, hq), "k_proj": (d, hkv), "v_proj": (d, hkv),
                "o_proj": (hq, d), "gate_proj": (d, f), "up_proj": (d, f),
                "down_proj": (f, d)}

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        c, W, L = self.cfg, self.W, self.cfg["num_hidden_layers"]
        d = c["hidden_size"]
        out = {n: int4_groups(W(f"llm.layers.{n}.kernel", (L,) + s)[li],
                              self.group)
               for n, s in self.shapes().items()}
        for n in ("input_layernorm", "post_attention_layernorm"):
            out[n] = W(f"llm.layers.{n}.scale", (L, d))[li].float()
        return out

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        table = self.W("llm.embed_tokens.embedding",
                       (c["vocab_size"], c["hidden_size"]))
        return int8_rows(table[ids])

    def image_tokens(self, feats: torch.Tensor, pos: torch.Tensor):
        """ViT features [N, T, vit_dim] + centres [N, 2] -> [N, n_in, d]."""
        a, d = self.cfg["agent"], self.cfg["hidden_size"]
        x = resampler(self.W, "input_resampler", feats,
                      math.isqrt(a["num_img_in_tokens"]), d,
                      a["resampler_heads"], a["vit_dim"])
        coords = torch.cat([pos, 1.0 - pos], dim=-1) / 2.0
        return x + (coords @ self.W.f("patch_pos_embed", (4, d)))[:, None]

    @torch.no_grad()
    def logits(self, seqs: List[Dict]) -> List[torch.Tensor]:
        """Each seq: ``ids`` [S] (long), optional ``image_tokens`` [M, d]
        at ``cmp`` [S] bool, and ``rows`` (the positions whose logits are
        wanted).  Returns fp32 logits [len(rows), vocab] per seq."""
        c = self.cfg
        d, L = c["hidden_size"], c["num_hidden_layers"]
        nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
        hd = d // nh
        xs = []
        for s in seqs:
            x = self.embed(s["ids"])
            if s.get("image_tokens") is not None:
                x = x.clone()
                x[s["cmp"]] = s["image_tokens"]
            xs.append(x)
        eps, theta = c["rms_norm_eps"], float(c["rope_theta"])
        for li in range(L):
            w = self.layer(li)
            for i, x in enumerate(xs):
                S = x.shape[0]
                pos = torch.arange(S, device=x.device)
                h = rms_norm(x, w["input_layernorm"], eps)
                ha = fake_quant(h, self.act_bits)
                q = rope((ha @ w["q_proj"]).reshape(1, S, nh, hd), pos, theta)
                k = rope((ha @ w["k_proj"]).reshape(1, S, nkv, hd), pos, theta)
                v = (ha @ w["v_proj"]).reshape(1, S, nkv, hd)
                k, v = fake_quant(k, self.kv_bits), fake_quant(v, self.kv_bits)
                if nkv != nh:
                    k = k.repeat_interleave(nh // nkv, dim=2)
                    v = v.repeat_interleave(nh // nkv, dim=2)
                a = attention(q, k, v, causal=True).reshape(S, nh * hd)
                x = x + fake_quant(a, self.act_bits) @ w["o_proj"]
                h = fake_quant(rms_norm(x, w["post_attention_layernorm"],
                                        eps), self.act_bits)
                act = F.silu(h @ w["gate_proj"]) * (h @ w["up_proj"])
                xs[i] = x + fake_quant(act, self.act_bits) @ w["down_proj"]
            del w
        head = int8_columns(self.W("llm.lm_head.kernel",
                                   (d, c["vocab_size"])))
        norm = self.W.f("llm.norm.scale", (d,))
        return [rms_norm(x[s["rows"]], norm, eps) @ head
                for x, s in zip(xs, seqs)]


def splice_mask(ids: Sequence[int], markers: Dict[str, int]) -> np.ndarray:
    """True strictly inside every <img>..</img> / <patch>..</patch> span."""
    ids = np.asarray(ids)
    mask = np.zeros(ids.shape, bool)
    opens = np.where((ids == markers["boi"]) | (ids == markers["bop"]))[0]
    closes = np.where((ids == markers["eoi"]) | (ids == markers["eop"]))[0]
    for o, cl in zip(opens, closes):
        mask[o + 1:cl] = True
    return mask


def constrained(logits: torch.Tensor, markers: Dict[str, int],
                n_img: int) -> torch.Tensor:
    """The served model's unforced image-token rule: the image
    continuation ids and </img> score 0.0."""
    out = logits.clone()
    img0 = markers["img0"]
    out[:, img0:img0 + n_img] = 0.0
    out[:, markers["eoi"]] = 0.0
    return out


def free_positions(tokens: Sequence[int], markers: Dict[str, int],
                   n_img: int) -> np.ndarray:
    """True where a served token was the model's free choice (not forced
    by an open image span: the n_img ids and </img> after each <img>)."""
    free = np.ones(len(tokens), bool)
    i = 0
    while i < len(tokens):
        if tokens[i] == markers["boi"]:
            free[i + 1:i + 2 + n_img] = False
            i += 2 + n_img
        else:
            i += 1
    return free


@torch.no_grad()
@plain_precision()
def served_gaps(seed: int, cfg: Dict, requests: List[Dict], device,
                act_bits: Optional[int] = None,
                kv_bits: Optional[int] = None,
                pick: str = "served") -> List[float]:
    """Per request: the widest gap by which a served token's reference
    logit lies below the reference's best, over the positions where the
    token was the model's free choice.  Each request: ``ids`` (the prompt),
    ``tokens`` (served), and with an image ``image`` (uint8 HxWx3) and
    ``grid``.  With ``pick="argmax"`` (the control), the token read at
    each position is the one this reference, at its own precision, puts
    first, and the gap is read in the fp32 reference's logits."""
    markers = cfg["markers"]
    n_img = cfg["agent"]["num_img_out_tokens"]
    base = cfg["vision"]["image_size"]
    agent = Agent(seed, cfg, device)
    seqs, arrs, poss, counts = [], [], [], []
    for r in requests:
        ids = list(r["ids"]) + list(r["tokens"][:-1])
        s = {"ids": torch.tensor(ids, device=device),
             "rows": torch.arange(len(r["ids"]) - 1, len(ids),
                                  device=device)}
        if r.get("image") is not None:
            arr, pos = tiles(r["image"], r["grid"], base)
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
        low_agent = Agent(seed, cfg, device, act_bits, kv_bits)
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
