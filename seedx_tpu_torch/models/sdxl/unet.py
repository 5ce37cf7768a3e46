"""SDXL UNet2DCondition (reference: seedx_tpu/models/sdxl/unet.py; the
diffusers UNet the reference drives, src/inference/eval_text2img_seed_x_i.py:64,
and the 8-channel ``conv_in`` of SEED-X-Edit, adapter_modules.py:183-209).

SDXL base geometry: block channels (320, 640, 1280), transformer depths
(0, 2, 10), heads = C / 64, 2 resnets a down block and 3 an up block, a
depth-10 mid block, 2048-d cross-attention context, and the "text_time"
added embedding (1280-d pooled ``text_embeds`` + 6 ``time_ids`` through
256-d sincos -> 2816 -> 1280).

Activations are NHWC, as in the JAX package; each convolution runs on a
permuted view (channels-last memory), and conv weights are stored in
torch's ``[out, in, kh, kw]`` order in channels-last memory
(``utils/convert.py`` transposes the JAX ``[kh, kw, in, out]`` kernels).
Dense and conv weights are stored in the compute dtype (the JAX package
keeps fp32 parameters and casts them at every use: the same values); norm
scales and biases stay fp32, as the JAX norms read them.  For training,
``layers.set_trainable_`` turns the leaves a trainer names into fp32
``nn.Parameter`` masters (the JAX ``param_dtype=float32``), which
``Dense`` and ``Conv`` cast to the compute dtype at each use; frozen
leaves stay buffers and are read as they are, so the inference path's
bits do not change.  With
``quantize="int8"`` every block Dense / conv holds an int8 weight and an
fp32 per-output-channel scale applied to the output (``Dense8`` /
``Conv8``).  Self-attention goes through ``dot_product_attention(...,
impl="auto")``, as in the JAX module: the flash kernel (K1) for a CUDA
bf16 tensor, the plain path otherwise; cross-attention (64 context
tokens) is plain.  GroupNorm (with the SiLU after it where one follows)
and LayerNorm go through ``ops/norms.py``'s wrappers: their CUDA kernels
(with a plain-torch backward) for a CUDA tensor, the plain fp32 versions
for a CPU one.  Likewise each Dense's epilogue after its GEMM (bias, the
int8 scale, and the residual that ``to_out``, ``ff_out`` and ``proj_out``
are handed; GEGLU's bias and gate) goes through ``ops/epilogue.py``: one
kernel pass for a CUDA tensor, the plain chain for a CPU one.

Row split (``RowSplit``, set by ``split_rows``; ``SDXLAdapter.shard``
from the rules ``("height", "tensor")`` / ``("cfg_batch", "data")``):
from ``conv_in`` to ``conv_out`` each rank holds a contiguous block of
H / n latent rows, where the JAX package's ``_spatial_constraint``
splits them (unet.py:43-45) and GSPMD derives the rest.  Here it is
written out: a 3x3 conv takes the rows its block reads past its edges
from its neighbours (``MeshGroups.halo``; zeros at the image's top and
bottom), worked out from its stride (1 above and 1 below at stride 1, 1
above at stride 2), an upsample takes one source row each side before it
repeats them; GroupNorm sums its fp32 statistics over the ranks;
self-attention keeps its query rows and gathers the keys and values
(K1 with Sq = the block's tokens, Skv = all); the 1x1 convs, the
projections, LayerNorm, the FF and cross-attention (keys and values from
the conditioning every rank holds) stay local.  The output rows are
gathered at the end.  Every conv pads its rows itself (zeros, or the
halo) and convolves with row padding 0, split or not, so a split over
one rank is the unsplit forward bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from seedx_tpu_torch.ops.attention import dot_product_attention
from seedx_tpu_torch.ops.epilogue import bias_geglu, bias_residual
from seedx_tpu_torch.ops.norms import group_norm, layer_norm


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4               # 8 for the Edit variant
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers: Tuple[int, ...] = (0, 2, 10)  # 0 = plain DownBlock
    cross_attention_dim: int = 2048
    attention_head_dim: int = 64
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32
    # "int8": every block Dense / conv weight int8 with per-output fp32
    # scales (utils/quantize.quantize_unet_params); the time / added-cond
    # embeds and conv_in / conv_out stay high precision
    quantize: str = "none"
    dtype: torch.dtype = torch.bfloat16

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def sdxl_base_unet(**overrides) -> UNetConfig:
    return UNetConfig(**overrides)


def sdxl_edit_unet(**overrides) -> UNetConfig:
    """8-channel conv_in variant for SEED-X-Edit
    (reference: adapter_modules.py:183-198)."""
    overrides.setdefault("in_channels", 8)
    return UNetConfig(**overrides)


def sdxl_debug_unet(**overrides) -> UNetConfig:
    kw = dict(block_out_channels=(32, 64), transformer_layers=(0, 1),
              cross_attention_dim=64, attention_head_dim=32,
              norm_num_groups=8, addition_time_embed_dim=32,
              projection_class_embeddings_input_dim=32 * 6 + 64)
    kw.update(overrides)
    return UNetConfig(**kw)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal embedding (diffusers get_timestep_embedding semantics),
    fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class RowSplit:
    """Latent rows over the ``rows`` axis and CFG branches over the
    ``batch`` axis of a mesh (``parallel.distributed.MeshGroups``)."""

    def __init__(self, groups, rows: str = "tensor", batch: str = "data"):
        self.groups, self.rows, self.batch = groups, rows, batch
        self.n, self.r = groups.size[rows], groups.rank[rows]

    @property
    def key(self) -> tuple:
        return (id(self.groups), self.rows, self.n, self.batch,
                self.groups.size[self.batch])

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of a whole NHWC tensor."""
        h = x.shape[1]
        if h % self.n:
            raise ValueError(f"{h} rows do not split over {self.n} ranks")
        k = h // self.n
        return x[:, self.r * k:(self.r + 1) * k]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block along ``dim``: its rows (NHWC dim 1) or its
        tokens (the rows flattened)."""
        return self.groups.all_gather(x, dim, self.rows)

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        return self.groups.halo(x, top, bottom, self.rows)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.groups.all_reduce(t, self.rows)


def split_rows(module: nn.Module, split: Optional[RowSplit]) -> nn.Module:
    """Run ``module`` (a UNet or VAE decoder) on ``split`` (None: whole)."""
    for m in module.modules():
        if split is None:
            vars(m).pop("_rows", None)
        else:
            m._rows = split
    return module


def row_split(module: nn.Module) -> Optional[RowSplit]:
    return vars(module).get("_rows")


def master(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A trainable leaf (an fp32 ``nn.Parameter``) cast to ``dtype`` at its
    use; a frozen buffer as it is."""
    return t.to(dtype) if isinstance(t, nn.Parameter) else t


class GroupNorm(nn.Module):
    """GroupNorm over NHWC with fp32 statistics, input-dtype output; with
    ``silu`` SiLU on that output (``ops.norms.group_norm``)."""

    def __init__(self, channels: int, num_groups: int, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.register_buffer("scale", torch.ones(channels, device=device))
        self.register_buffer("bias", torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        split = row_split(self)
        return group_norm(
            x, self.scale, self.bias, self.num_groups, self.epsilon,
            None if split is None else split.sum,
            1 if split is None else split.n, silu=silu)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and affine, input-dtype output
    (``ops.norms.layer_norm``)."""

    def __init__(self, dim: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("scale", torch.ones(dim, device=device))
        self.register_buffer("bias", torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.epsilon)


class Dense(nn.Module):
    """``nn.Dense`` (``kernel`` [in, out] in the compute dtype) or, with
    ``quantize="int8"``, ``Dense8``: ``kernel_q`` int8 and a per-output fp32
    ``kernel_scale`` applied to the output, ``(x @ w) * s == x @ (w * s)``
    for per-output scales, so the int8 weight is only cast."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 quantize: str = "none", dtype=torch.bfloat16, device=None):
        super().__init__()
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be none|int8: {quantize}")
        self.quantize, self.dtype, self.use_bias = quantize, dtype, use_bias
        if quantize == "int8":
            self.register_buffer("kernel_q", torch.zeros(
                (in_features, features), dtype=torch.int8, device=device))
            self.register_buffer("kernel_scale", torch.ones(
                features, device=device))
        else:
            self.register_buffer("kernel", torch.zeros(
                (in_features, features), dtype=dtype, device=device))
        if use_bias:
            self.register_buffer("bias", torch.zeros(features, dtype=dtype,
                                                     device=device))

    def gemm(self, x: torch.Tensor):
        """(x @ kernel in the compute dtype, the per-output scale the int8
        path applies to it or None): the GEMM before the epilogue."""
        x = x.to(self.dtype)
        if self.quantize == "int8":
            return (x @ self.kernel_q.to(self.dtype),
                    self.kernel_scale.to(self.dtype))
        return x @ master(self.kernel, self.dtype), None

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[residual +] (x @ kernel [* scale] + bias)``; the epilogue is
        ``ops.epilogue.bias_residual``.  Without a bias (``to_q`` / ``to_k``
        / ``to_v``) nothing follows the GEMM but the int8 scale."""
        y, scale = self.gemm(x)
        if self.use_bias:
            return bias_residual(y, master(self.bias, self.dtype), residual,
                                 scale)
        if scale is not None:
            y = y * scale
        return y if residual is None else residual + y


Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


class Conv(nn.Module):
    """2-D convolution on NHWC activations: ``nn.Conv`` (``weight`` [out,
    in, kh, kw] in the compute dtype, channels-last memory) or, with
    ``quantize="int8"``, ``Conv8``: ``weight_q`` int8 and a per-output fp32
    ``kernel_scale`` applied to the output.  ``padding`` is symmetric (an
    int) or ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int], stride: int = 1,
                 padding: Padding = 0, quantize: str = "none",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be none|int8: {quantize}")
        self.quantize, self.dtype = quantize, dtype
        self.stride, self.padding = stride, padding
        self.kernel_size = tuple(kernel_size)
        shape = (features, in_channels) + tuple(kernel_size)
        if quantize == "int8":
            self.register_buffer("weight_q", torch.zeros(
                shape, dtype=torch.int8, device=device).contiguous(
                    memory_format=torch.channels_last))
            self.register_buffer("kernel_scale", torch.ones(
                features, device=device))
        else:
            self.register_buffer("weight", torch.zeros(
                shape, dtype=dtype, device=device).contiguous(
                    memory_format=torch.channels_last))
        self.register_buffer("bias", torch.zeros(features, dtype=dtype,
                                                 device=device))

    def row_pads(self, h: int) -> Tuple[int, int]:
        """(above, below): the input rows a block of ``h`` rows needs past
        its edges, from the stride and the row padding; below < 0 drops
        rows no output reads.  Split over n ranks, each rank's output
        rows must read from its own block's start on."""
        pad = self.padding
        top, bottom = (pad, pad) if isinstance(pad, int) else pad[0]
        k, s = self.kernel_size[0], self.stride
        split = row_split(self)
        n = 1 if split is None else split.n
        out = (h * n + top + bottom - k) // s + 1
        if out % n or (n > 1 and out // n * s != h):
            raise ValueError(f"a stride-{s} conv over {h * n} rows does not "
                             f"split into {n} blocks of {h}")
        return top, (out // n - 1) * s + k - top - h

    def pad_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` with the rows ``row_pads`` asks for: the neighbours' rows
        (``halo``) on a split, zeros past the image's edges."""
        top, below = self.row_pads(x.shape[1])
        if below < 0:
            x, below = x[:, :x.shape[1] + below], 0
        if not (top or below):
            return x
        split = row_split(self)
        if split is not None:
            return split.halo(x, top, below)
        return torch.cat([x.new_zeros((x.shape[0], top) + x.shape[2:]), x,
                          x.new_zeros((x.shape[0], below) + x.shape[2:])], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_rows(self.pad_rows(x.to(self.dtype)))

    def conv_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution of an input whose rows are padded already."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        pad = self.padding
        if isinstance(pad, int):
            pad = (0, pad)
        else:
            (_, (left, right)) = pad
            x, pad = F.pad(x, (left, right)), 0
        if self.quantize == "int8":
            y = F.conv2d(x, self.weight_q.to(self.dtype), None, self.stride,
                         pad)
            y = y * self.kernel_scale.to(self.dtype)[:, None, None] \
                + self.bias[:, None, None]
        else:
            y = F.conv2d(x, master(self.weight, self.dtype),
                         master(self.bias, self.dtype), self.stride, pad)
        return y.permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cfg: UNetConfig,
                 device=None):
        super().__init__()
        kw = dict(quantize=cfg.quantize, dtype=cfg.dtype, device=device)
        g = cfg.norm_num_groups
        self.norm1 = GroupNorm(in_channels, g, device=device)
        self.conv1 = Conv(in_channels, out_channels, (3, 3), padding=1, **kw)
        self.time_emb_proj = Dense(cfg.time_embed_dim, out_channels, **kw)
        self.norm2 = GroupNorm(out_channels, g, device=device)
        self.conv2 = Conv(out_channels, out_channels, (3, 3), padding=1, **kw)
        if in_channels != out_channels:
            self.conv_shortcut = Conv(in_channels, out_channels, (1, 1), **kw)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, cfg: UNetConfig,
                 device=None):
        super().__init__()
        kw = dict(quantize=cfg.quantize, dtype=cfg.dtype, device=device)
        self.heads = query_dim // cfg.attention_head_dim
        self.head_dim = cfg.attention_head_dim
        self.to_q = Dense(query_dim, query_dim, use_bias=False, **kw)
        self.to_k = Dense(context_dim, query_dim, use_bias=False, **kw)
        self.to_v = Dense(context_dim, query_dim, use_bias=False, **kw)
        self.to_out = Dense(query_dim, query_dim, **kw)

    def forward(self, x: torch.Tensor, context=None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention of ``x`` (self) or over ``context`` (cross), through
        ``to_out``, which adds ``residual`` (the block's stream) in its
        epilogue."""
        def split(t):
            return t.reshape(*t.shape[:-1], self.heads, self.head_dim)

        if context is None:
            k, v = self.to_k(x), self.to_v(x)
            rows = row_split(self)
            if rows is not None:
                # local queries against every rank's keys and values
                k, v = rows.gather(torch.stack([k, v]), 2).unbind(0)
        else:
            k, v = self.to_k(context), self.to_v(context)
        # auto: self-attention (4096 / 1024 tokens at 1024^2, no mask; on a
        # row split the block's queries against every key, which q_offset
        # marks as the kernel's case) takes the flash kernel on the card;
        # cross-attention (kv = the 64 detokenizer tokens) stays plain
        out = dot_product_attention(split(self.to_q(x)), split(k), split(v),
                                    impl="auto",
                                    q_offset=0 if context is None else None)
        return self.to_out(out.reshape(*x.shape[:-1], -1), residual)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, quantize=cfg.quantize,
                          dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``h * gelu(gate)`` over the biased projection's halves: its GEMM,
        then ``ops.epilogue.bias_geglu``."""
        y, scale = self.proj.gemm(x)
        return bias_geglu(y, master(self.proj.bias, self.proj.dtype), scale)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device=device)
        self.attn1 = CrossAttention(dim, dim, cfg, device)
        self.norm2 = LayerNorm(dim, device=device)
        self.attn2 = CrossAttention(dim, cfg.cross_attention_dim, cfg, device)
        self.norm3 = LayerNorm(dim, device=device)
        self.ff_geglu = GEGLU(dim, dim * 4, cfg, device)
        self.ff_out = Dense(dim * 4, dim, quantize=cfg.quantize,
                            dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        # each residual add is the epilogue of the Dense before it
        x = self.attn1(self.norm1(x), residual=x)
        x = self.attn2(self.norm2(x), context, residual=x)
        return self.ff_out(self.ff_geglu(self.norm3(x)), residual=x)


class Transformer2D(nn.Module):
    def __init__(self, channels: int, depth: int, cfg: UNetConfig,
                 device=None):
        super().__init__()
        kw = dict(quantize=cfg.quantize, dtype=cfg.dtype, device=device)
        # diffusers Transformer2DModel's GroupNorm uses eps 1e-6 (the
        # resnets' 1e-5)
        self.norm = GroupNorm(channels, cfg.norm_num_groups, 1e-6, device)
        self.proj_in = Dense(channels, channels, **kw)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block_{i}",
                    BasicTransformerBlock(channels, cfg, device))
        self.proj_out = Dense(channels, channels, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hidden = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for i in range(self.depth):
            hidden = getattr(self, f"block_{i}")(hidden, context)
        return self.proj_out(hidden, x.reshape(b, h * w, c)).reshape(
            b, h, w, c)


class Downsample(nn.Module):
    def __init__(self, channels: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, (3, 3), stride=2, padding=1,
                         quantize=cfg.quantize, dtype=cfg.dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour x2 (every pixel repeated 2 x 2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample_conv(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """Nearest x2, then ``conv`` (3x3, padding 1): one source row each side
    (the neighbours' on a split, else zeros), repeated, gives the
    upsampled rows one halo row each side."""
    split = row_split(conv)
    x = x.to(conv.dtype)
    if split is not None:
        x = split.halo(x, 1, 1)
    else:
        zeros = x.new_zeros((x.shape[0], 1) + x.shape[2:])
        x = torch.cat([zeros, x, zeros], 1)
    return conv.conv_rows(upsample_nearest(x)[:, 1:-1])


class Upsample(nn.Module):
    def __init__(self, channels: int, cfg: UNetConfig, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, (3, 3), padding=1,
                         quantize=cfg.quantize, dtype=cfg.dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_conv(self.conv, x)


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ch0, ted, dt = cfg.block_out_channels[0], cfg.time_embed_dim, cfg.dtype
        self.time_embed_1 = Dense(ch0, ted, dtype=dt, device=device)
        self.time_embed_2 = Dense(ted, ted, dtype=dt, device=device)
        self.add_embed_1 = Dense(cfg.projection_class_embeddings_input_dim,
                                 ted, dtype=dt, device=device)
        self.add_embed_2 = Dense(ted, ted, dtype=dt, device=device)
        self.conv_in = Conv(cfg.in_channels, ch0, (3, 3), padding=1, dtype=dt,
                            device=device)

        n_blocks = len(cfg.block_out_channels)
        ch_in, skips = ch0, [ch0]
        for i, ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_res_{j}",
                        ResnetBlock(ch_in, ch, cfg, device))
                if cfg.transformer_layers[i]:
                    setattr(self, f"down_{i}_attn_{j}", Transformer2D(
                        ch, cfg.transformer_layers[i], cfg, device))
                ch_in = ch
                skips.append(ch)
            if i < n_blocks - 1:
                setattr(self, f"down_{i}_downsample",
                        Downsample(ch, cfg, device))
                skips.append(ch)

        ch = cfg.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock(ch, ch, cfg, device)
        if cfg.transformer_layers[-1]:
            self.mid_attn = Transformer2D(ch, cfg.transformer_layers[-1], cfg,
                                          device)
        self.mid_res_1 = ResnetBlock(ch, ch, cfg, device)

        for i, ch in enumerate(reversed(cfg.block_out_channels)):
            depth = cfg.transformer_layers[n_blocks - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_res_{j}",
                        ResnetBlock(ch_in + skips.pop(), ch, cfg, device))
                if depth:
                    setattr(self, f"up_{i}_attn_{j}",
                            Transformer2D(ch, depth, cfg, device))
                ch_in = ch
            if i < n_blocks - 1:
                setattr(self, f"up_{i}_upsample", Upsample(ch, cfg, device))

        self.conv_norm_out = GroupNorm(ch0, cfg.norm_num_groups, device=device)
        self.conv_out = Conv(ch0, cfg.out_channels, (3, 3), padding=1,
                             dtype=dt, device=device)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                text_embeds: torch.Tensor,
                time_ids: torch.Tensor) -> torch.Tensor:
        """Args (NHWC): sample [B, H, W, in_channels] noisy latents (+ the
        condition latents channel-concat for the Edit variant), timesteps
        [B] or scalar, encoder_hidden_states [B, T, cross_attention_dim],
        text_embeds [B, pooled], time_ids [B, 6].  Returns the eps
        prediction [B, H, W, out_channels] in the compute dtype."""
        cfg = self.cfg
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)

        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb)))
        tids = timestep_embedding(time_ids.reshape(-1),
                                  cfg.addition_time_embed_dim).reshape(b, -1)
        add = torch.cat([text_embeds.float(), tids], dim=-1)
        temb = temb + self.add_embed_2(F.silu(self.add_embed_1(add)))

        context = encoder_hidden_states.to(cfg.dtype)
        split = row_split(self)
        if split is not None:
            sample = split.local_rows(sample)
        x = self.conv_in(sample)

        skips = [x]
        n_blocks = len(cfg.block_out_channels)
        for i in range(n_blocks):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x, temb)
                if cfg.transformer_layers[i]:
                    x = getattr(self, f"down_{i}_attn_{j}")(x, context)
                skips.append(x)
            if i < n_blocks - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)

        x = self.mid_res_0(x, temb)
        if cfg.transformer_layers[-1]:
            x = self.mid_attn(x, context)
        x = self.mid_res_1(x, temb)

        for i in range(n_blocks):
            depth = cfg.transformer_layers[n_blocks - 1 - i]
            for j in range(cfg.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = getattr(self, f"up_{i}_res_{j}")(x, temb)
                if depth:
                    x = getattr(self, f"up_{i}_attn_{j}")(x, context)
            if i < n_blocks - 1:
                x = getattr(self, f"up_{i}_upsample")(x)

        out = self.conv_out(self.conv_norm_out(x, silu=True))
        return out if split is None else split.gather(out, 1)


def flash_launches_per_eval(cfg: UNetConfig) -> int:
    """Self-attention calls of one UNet eval (one K1 launch each on the
    card, on each rank of a row split): down and up blocks of every level
    with transformers, and the mid block (70 for SDXL base)."""
    per_level = sum(d * (2 * cfg.layers_per_block + 1)
                    for d in cfg.transformer_layers)
    return per_level + cfg.transformer_layers[-1]


def norm_launches_per_eval(cfg: UNetConfig) -> Tuple[int, int]:
    """(GroupNorm, LayerNorm) calls of one UNet eval, one kernel call each
    on the card: two GroupNorms a resnet (``layers_per_block`` a level
    down, one more up, 2 in the mid block), one a Transformer2D and
    ``conv_norm_out``; three LayerNorms a transformer block.  (46, 210)
    for SDXL base."""
    resnets, transformers = _resnets_transformers(cfg)
    return (2 * resnets + transformers + 1,
            3 * flash_launches_per_eval(cfg))


def _resnets_transformers(cfg: UNetConfig) -> Tuple[int, int]:
    """ResnetBlocks and Transformer2Ds of a UNet: ``layers_per_block`` a
    level down, one more up, and the mid block's."""
    n = len(cfg.block_out_channels)
    with_attn = sum(1 for d in cfg.transformer_layers if d)
    resnets = n * (2 * cfg.layers_per_block + 1) + 2
    transformers = with_attn * (2 * cfg.layers_per_block + 1) + (
        1 if cfg.transformer_layers[-1] else 0)
    return resnets, transformers


def epilogue_launches_per_eval(cfg: UNetConfig) -> Tuple[int, int]:
    """(bias_residual, bias_geglu) calls of one UNet eval, one kernel call
    each on the card: every Dense with a bias but GEGLU's projection --
    ``to_out`` twice and ``ff_out`` a transformer block, ``proj_in`` and
    ``proj_out`` a Transformer2D, ``time_emb_proj`` a resnet, the four
    time / added-condition embeddings -- and one GEGLU a transformer block.
    (253, 70) for SDXL base."""
    blocks = flash_launches_per_eval(cfg)
    resnets, transformers = _resnets_transformers(cfg)
    return 3 * blocks + 2 * transformers + resnets + 4, blocks
