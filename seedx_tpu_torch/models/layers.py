"""Shared building blocks (reference: seedx_tpu/models/layers.py).

Weights are buffers named as the JAX package's parameter leaves
(``kernel`` [in, out], ``kernel_q``, ``kernel_q4``, ``kernel_scale``,
``bias``, ``scale``), so ``utils/convert.py`` is mostly a rename.  With
``layers=L`` a module holds its weights stacked ``[L, ...]`` and
``forward(x, layer)`` reads layer ``layer`` as a view: one layer loop
serves prefill and decode.  Float weights are stored in the compute dtype;
the JAX package casts its fp32 parameters to that dtype at every use, so
the values are the same.

Every weight is a buffer (no gradient) until ``set_trainable_`` turns the
leaves a trainer names into fp32 ``nn.Parameter`` master copies, which
are cast to the compute dtype at each use (``Stacked.w``), as the JAX
package does with ``param_dtype=float32``; frozen leaves stay bf16
buffers.  LoRA dropout (training) draws its masks from an explicit
``torch.Generator`` passed to ``LoRADense.forward``.

On a mesh (``parallel/mesh.place_params``) a module holds its rank's
shard of each leaf; ``leaf`` reads a leaf with the splits the module does
not compute on gathered (``_gathers``), and a projection's ``tp`` role
says how it computes on the rest: ``"col"`` (its output columns: local
heads or MLP columns), ``"row"`` (its input rows: partial sums
all-reduced over the tensor group before the IA3 output scale and the
bias; under int4 every row is quantized against the whole row's absmax,
an all-reduce MAX, so the shards sum to the unsharded W4A8 product), or
None (everything gathered, the whole product).  Training on a mesh takes
its gradients through these collectives: a trainable leaf's fsdp gather
reduce-scatters its gradient, a column-parallel input all-reduces its
dx (Megatron's "f", ``col_input``), a row-parallel sum passes its
gradient on (``reduce_partial``, "g"); LoRA's rank-r bottleneck is whole
on every tensor rank, so no replicated leaf gets a partial gradient; and
dropout keeps this rank's block of the unsharded step's mask
(``dropout_mask``).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from seedx_tpu_torch.ops.attention import dot_product_attention
from seedx_tpu_torch.ops.int4_matmul import int4_matmul_auto, row_absmax
from seedx_tpu_torch.ops.norms import rms_norm


def _lead(layers: Optional[int]) -> tuple:
    return () if layers is None else (layers,)


def leaf(mod: nn.Module, name: str, layer: Optional[int] = None
         ) -> torch.Tensor:
    """Weight ``name`` of ``mod`` (its layer view with ``layer``); on a
    mesh, the splits ``mod`` does not compute on gathered from every rank
    (a buffer per leaf, reused by every layer)."""
    t = getattr(mod, name)
    t = t if layer is None else t[layer]
    gathers = mod.__dict__.get("_gathers")
    if gathers:
        for dim, axis in gathers.get(name, ()):
            if t.requires_grad:
                # a trainable leaf: its gradient is reduce-scattered back
                t = mod._par.gather_leaf(t, dim, axis)
            else:
                t = mod._par.all_gather(t, dim, axis,
                                        key=(id(mod), name, dim))
    return t


def tensor_size(mod: nn.Module) -> int:
    """The tensor axis's size of the mesh ``mod`` is placed on (1 off one)."""
    par = mod.__dict__.get("_par")
    return 1 if par is None else par.size["tensor"]


def reduce_partial(mod: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel product's partial sums over the tensor group (in
    fp32, one rounding back); the backward is the identity (Megatron's
    "g")."""
    return mod._par.reduce_from(y)


def col_input(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: the identity, whose backward
    sums each rank's partial dx over the tensor group (Megatron's "f")."""
    return mod._par.copy_to(x) if x.requires_grad else x


def dropout_mask(x: torch.Tensor, rate: float, generator: torch.Generator,
                 mod: nn.Module, split_cols: bool) -> torch.Tensor:
    """The keep mask of ``x`` [B, ..., F]: drawn for the unsharded step's
    whole input, of which this rank keeps its rows (its block of the batch
    axes, data x fsdp) and, with ``split_cols`` (a row-parallel input),
    its block of the tensor-split last dim; so a sharded step drops what
    the unsharded one drops, from the same generator."""
    par = mod.__dict__.get("_par")
    if par is None:
        return torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - rate
    nb, nt = par.batch_count, par.size["tensor"] if split_cols else 1
    b, f = x.shape[0], x.shape[-1]
    keep = torch.rand((nb * b,) + x.shape[1:-1] + (nt * f,),
                      generator=generator, device=x.device) < 1.0 - rate
    keep = keep[par.batch_index * b:(par.batch_index + 1) * b]
    if nt > 1:
        keep = keep[..., par.rank["tensor"] * f:(par.rank["tensor"] + 1) * f]
    return keep


class Stacked(nn.Module):
    """Base: ``self.w(name, layer)`` is weight ``name`` or its layer view;
    a trainable (fp32 ``nn.Parameter``) leaf comes back cast to the
    compute dtype."""

    tp: Optional[str] = None       # "col" | "row" on a mesh (see above)

    def w(self, name: str, layer: Optional[int]) -> torch.Tensor:
        cast = isinstance(getattr(self, name), nn.Parameter)
        t = leaf(self, name, layer)
        return t.to(self.dtype) if cast else t


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
        if self.tp == "col":
            x = col_input(self, x)
        y = x.to(self.dtype) @ self.dense_kernel(layer)
        if self.tp == "row":
            y = reduce_partial(self, y)
        if self.use_bias:
            y = y + self.w("bias", layer)
        return y


class LoRADense(PDense):
    """Dense with optional low-rank delta and int8 / int4 weights.

    ``quantize="int4"``: ``kernel_q4`` uint8 [in//2, out] (row-pair signed
    nibbles) + ``kernel_scale`` fp32 [in//group, out], group = 128, or in
    when in % 128 != 0 (reference layers.py:121-142), through the W4A8
    kernel.  ``lora_rank > 0`` adds ``scale * (dropout(x) @ lora_a) @
    lora_b``, scale = alpha / rank; dropout (rate ``lora_dropout``, on the
    LoRA input only, reference layers.py:180-193) runs only when the
    caller passes a generator.  ``ia3`` (reference layers.py:101-121,
    194-199): a learned ``ia3_scale`` vector, ones at init, that scales the
    input (``"in"``: before any quantized product, so int4 quantizes the
    scaled rows) or the output (``"out"``: after the LoRA delta, before
    the bias)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 32.0,
                 lora_dropout: float = 0.0,
                 quantize: str = "none", quantize_group: int = 128,
                 ia3: Optional[str] = None,
                 dtype=torch.bfloat16, layers: Optional[int] = None,
                 device=None):
        base_q = "int8" if quantize in ("int8", "int8_full") else "none"
        super().__init__(in_features, features, use_bias=use_bias,
                         quantize=base_q, dtype=dtype, layers=layers,
                         device=device)
        self.quantize = quantize if quantize != "int8_full" else "int8"
        lead = _lead(layers)
        if ia3 not in (None, "in", "out"):
            raise ValueError(f"LoRADense ia3 must be None|in|out: {ia3}")
        self.ia3 = ia3
        if ia3 is not None:
            self.register_buffer("ia3_scale", torch.ones(
                lead + (in_features if ia3 == "in" else features,),
                dtype=dtype, device=device))
        self.group = (quantize_group if in_features % quantize_group == 0
                      else in_features)
        if quantize == "int4":
            del self.kernel
            self.register_buffer("kernel_q4", torch.zeros(
                lead + (in_features // 2, features), dtype=torch.uint8,
                device=device))
            self.register_buffer("kernel_scale", torch.ones(
                lead + (in_features // self.group, features),
                dtype=torch.float32,
                device=device))
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        self.lora_dropout = lora_dropout
        if lora_rank > 0:
            self.register_buffer("lora_a", torch.zeros(
                lead + (in_features, lora_rank), dtype=dtype, device=device))
            self.register_buffer("lora_b", torch.zeros(
                lead + (lora_rank, features), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, layer: Optional[int] = None,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.ia3 == "in":
            x = x * self.w("ia3_scale", layer).to(x.dtype)
        xl = x                      # the LoRA branch's input
        if self.tp == "col":
            x = col_input(self, x)
        if self.quantize == "int4":
            scale, amax = self.w("kernel_scale", layer), None
            if self.tp == "row":
                # this rank's rows [r * n, (r + 1) * n) of the whole in dim
                n, r = x.shape[-1], self._par.rank["tensor"]
                scale = scale[r * n // self.group:(r + 1) * n // self.group]
                amax = self._par.all_reduce(row_absmax(x.to(self.dtype)),
                                            op="max")
            y = int4_matmul_auto(x.to(self.dtype), self.w("kernel_q4", layer),
                                 scale, *(() if amax is None else (amax,)))
        else:
            y = x.to(self.dtype) @ self.dense_kernel(layer)
        if self.tp == "row":
            y = reduce_partial(self, y)
        if self.lora_rank > 0:
            xd = xl
            rate = self.lora_dropout
            if rate > 0.0 and dropout is not None:
                keep = dropout_mask(xl, rate, dropout, self,
                                    split_cols=self.tp == "row")
                xd = torch.where(keep, xl / (1.0 - rate), 0.0).to(xl.dtype)
            # on a mesh the rank-r bottleneck h is whole on every tensor
            # rank: a column-parallel layer's h enters its local lora_b
            # columns through "f" (so lora_a's gradient is whole), a
            # row-parallel layer's partial h is summed before the
            # replicated lora_b (so lora_b's gradient is whole)
            h = xd.to(self.dtype) @ self.w("lora_a", layer)
            if self.tp == "col":
                h = col_input(self, h)
            elif self.tp == "row":
                h = reduce_partial(self, h)
            delta = h @ self.w("lora_b", layer)
            y = y + (self.lora_alpha / self.lora_rank) * delta
        if self.ia3 == "out":
            y = y * self.w("ia3_scale", layer).to(y.dtype)
        if self.use_bias:
            y = y + self.w("bias", layer)
        return y

    def row_split_ok(self, tensor: int) -> bool:
        """Whether ``tensor`` ranks can each take whole int4 groups of the
        in dimension (always, unquantized or int8)."""
        n = self.kernel_q4.shape[-2] * 2 if self.quantize == "int4" else 0
        return not n or (n // tensor) % self.group == 0


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

    def tp_plan(self, tensor: int) -> dict:
        return {"c_fc": "col", "c_proj": "row"}

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

    def tp_plan(self, tensor: int) -> dict:
        """Heads over ``tensor`` where they divide (else all on each rank)."""
        ok = self.num_heads % tensor == 0
        return {"q_proj": "col" if ok else None, "k_proj": "col" if ok
                else None, "v_proj": "col" if ok else None,
                "out_proj": "row" if ok else None}

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        dim = q.shape[-1]
        hd = dim // self.num_heads
        nh = self.num_heads // (tensor_size(self) if self.q_proj.tp == "col"
                                else 1)

        def heads(t):
            return t.reshape(*t.shape[:-1], nh, hd)

        out = dot_product_attention(heads(self.q_proj(q)),
                                    heads(self.k_proj(k)),
                                    heads(self.v_proj(v)), impl="plain")
        return self.out_proj(out.reshape(*q.shape[:-1], nh * hd))


@torch.no_grad()
def init_normal_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Random weights for a module built with zeros: normal(0, s) with
    s = min(std, fan_in ** -0.5) for float kernels, tables and queries
    (fan_in: the ``in`` of a JAX-layout [..., in, out] kernel; in * kh * kw
    of a torch-layout conv ``weight`` [out, in, kh, kw]);
    1 + normal(0, 0.1) for norm scales; normal(0, 0.02) for biases.
    Integer leaves and quantizer scales are left to the quantizer.  Values
    are drawn in fp32 on the module's device, one buffer (or trainable
    parameter) at a time."""
    # state_dict: persistent buffers and parameters (not the fixed sincos
    # tables)
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
            if leaf == "weight":     # torch-layout conv [out, in, kh, kw]
                fan_in = buf[0].numel()
            else:                    # JAX-layout [..., in, out]
                fan_in = buf.shape[-2] if buf.dim() >= 2 else buf.shape[-1]
            noise.mul_(min(std, 1.0 / math.sqrt(fan_in)))
        buf.copy_(noise)
        # freed before the next leaf's draw: a sparse-expert stack is
        # ~18 GiB in fp32, so two at once do not fit beside the weights
        del noise
    return module


def set_trainable_(module: nn.Module, names: Iterable[str]) -> List[str]:
    """Turn the float weights ``names`` (state-dict names) of ``module``
    into fp32 ``nn.Parameter`` master copies, in place, as the JAX
    package's ``param_dtype=float32`` leaves; the others stay buffers.  A
    leaf that is already a parameter is kept.  Returns the names."""
    names = list(names)
    for name in names:
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        t = getattr(owner, leaf)
        if isinstance(t, nn.Parameter):
            continue
        if not t.is_floating_point():
            raise ValueError(f"{name}: {t.dtype} leaves cannot train")
        del owner._buffers[leaf]
        owner.register_parameter(leaf, nn.Parameter(t.detach().float()))
    return names
