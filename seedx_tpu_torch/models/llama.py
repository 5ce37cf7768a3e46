"""LLaMA2 causal LM backbone (reference: seedx_tpu/models/llama.py).

RoPE, RMSNorm, SwiGLU MLP, causal attention, the dual input contract
(callers embed ids, splice image embeddings in, and pass embeddings).
Layer weights are stacked [L, ...] and read per layer as views; one
Python layer loop serves prefill and decode (the JAX package's
``decode_stacked.py`` loop is this loop: ``packed[li]`` is a view, not a
copy).  The KV cache is the JAX package's flat layout [L, B, S, Hkv * D],
or a shared paged pool [L, P * page, Hkv * D] addressed through block
tables, updated in place at ``cache_index`` (the JAX package returns a new
cache; here the caller's tensors are written, which saves a copy of the
cache per step).  A one-token step with a kv window reads only that window
through ``ops/decode_attention.ragged_decode_attention`` (see
``LlamaConfig.decode_attention``).

The continuous engine's fused prefill+decode step (reference:
``decode_stacked.py`` ``decode_layers_stacked`` on its mixed branch and
``decode_layers_packed``) comes in two layouts.  *Windowed*: x is
``[B, w, hidden]``, row b's slots ``[0, write_widths[b])`` are real tokens
written at ``[cache_index[b], ...)`` and the rest are dropped, never
clamped.  *Packed*: x is ``[P, hidden]``, P = B + w real tokens, each with
its row (``tok_row``; B marks an invalid token) and its slot in the row's
window (``tok_slot``); projections, MLP and norms run over the P tokens
and q is scattered into the ``[B, w]`` window for attention.  Either way
query slot i of row b attends the causal stair ``[start_b, pos_b + i]``:
through the ragged kernel's multi-query mode when the kv window goes to
the kernel, else through the plain attention with a per-row causal
``q_offset`` (as the JAX package's XLA path does).

A per-row step has static shapes only, so a captured program can replay
it: a slot the fused step drops, or a token the packed step does not
carry, writes back what a dump cell held, at a cell no real write of the
step targets (the reserved page 0 of a paged pool; in a dense cache the
first cell past its row's real writes), never onto a clamped cell a real
token may own; a one-token step's ``write_mask`` [B] writes a masked
row's cell back as it was (a predicated step that must change nothing).

DeepSeek-V2 (``LlamaConfig.mla`` / ``.moe``; reference: DeepSeek's
``modeling_deepseek.py``, the JAX package has neither) adds two kinds to
the one layer loop.  Latent attention (MLA): q is ``[nope | rope]`` per
head; one ``kv_a_proj`` gives the ``kv_lora_rank`` latent c (RMS-normed)
and a single-head ``k_pe``, both roped parts after a de-interleave with
YaRN frequencies.  The cache holds the latent ``[c | k_pe]``, one tensor
[L, B, S, kv_lora_rank + rope] (``init_kv_cache``).  A multi-row step
(prefill) expands the cached latent through ``kv_b_proj`` into per-head
``k_nope`` and v and attends with q / k 192 wide and v 128, through the
plain path (``dot_product_attention``'s ``"auto"`` sends what K1 cannot
take there), a few rows a call; a one-token step runs the absorbed form
over the whole static cache under ``kv_valid``: q_nope through W_UK (a
view of ``kv_b_proj``) into the latent space, scores against the cached
``[c | k_pe]``, the latent output back through W_UV.  Sparse experts
(MoE): the first ``first_k_dense_replace`` layers keep the dense SwiGLU
(stack ``gate_proj`` / ``up_proj`` / ``down_proj``), the rest route each
token to ``num_experts_per_tok`` of ``n_routed_experts`` experts
(``ops/moe.py``, K6) and add the shared experts' SwiGLU (stack
``shared_*``); in a step that is not per-row, the tokens whose own cells
``kv_valid`` leaves out (a right-padded prefill's pads) route to no
expert.

Nemotron-H (``LlamaConfig.block_pattern``; reference: NVIDIA's
``modeling_nemotron_h.py``) is the same loop over a hybrid stack: block i
is ``x + mixer_i(RMSNorm_i(x))`` with one mixer of the kind the pattern
names, "M" a Mamba-2 mixer (``models/mamba.py``: its conv and SSM state
live in the cache beside the attention blocks' KV), "E" sparse experts
(relu2 experts, a sigmoid router with a score-correction bias:
``expert_act`` / ``router_scoring``) and "*" GQA attention without
rotary embedding (``rope=False``).  Each kind's weights are stacked over
its own blocks and indexed by the block's ordinal within its kind
(``LlamaConfig.kind_index``); the routed experts are one leaf a block
(``experts.<m>.up_proj``), so no leaf outgrows a card's spare memory
when it is drawn.  A multi-row step of more than ``HYBRID_ROWS_TOKENS``
tokens runs its rows in groups (``LlamaForCausalLM.forward``).

What latent attention, sparse experts and the hybrid stack refuse (each
with a ValueError) is named in one place, ``LlamaConfig.refuse``:
quantized weights or KV, LoRA / IA3, paged KV, the fused step and fused
prefill, speculative decoding, beam search, a mesh and training.

Training (``LlamaForCausalLM.forward_train``, ``causal_lm_loss``) runs the
cache-less forward with per-layer recomputation (``remat``, the JAX
package's ``nn.remat``) on a bf16 / fp32 base; its causal attention goes
through the flash kernels' autograd function on the card.

On a mesh (``parallel/mesh.place_params``, ``SeedXRuntime.shard``) each
rank holds its shard of every leaf: q / k / v / gate / up are
column-parallel and o / down row-parallel over ``tensor`` (one all-reduce
each), the embedding is vocab-parallel (a masked local lookup, then an
all-reduce), the LM head's logits are all-gathered over the vocab (every
rank samples from the same logits), and leaves split over ``fsdp`` are
gathered a layer at a time right before use.  Each rank attends over its
own heads, and its KV cache holds only those (``kv_heads``).  Where the
heads do not divide over ``tensor`` (or an int4 o_proj's row shard would
cut a quantization group) attention runs whole on every rank; where an
int4 down_proj's row shard would cut a group (13824 / 8), down_proj
gathers its input and its weight and runs whole.  Training on a mesh:
the embedding's all-reduce and the logits' gather carry gradients
(``MeshGroups.reduce_from`` / ``gather_from``), and ``causal_lm_loss``
divides by the global batch's label count.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from seedx_tpu_torch.models.layers import (LoRADense, PDense, RMSNorm, leaf,
                                           tensor_size)
from seedx_tpu_torch.models.mamba import Mamba2Mixers
from seedx_tpu_torch.ops.attention import dot_product_attention
from seedx_tpu_torch.ops.attention import NEG_INF
from seedx_tpu_torch.ops.decode_attention import ragged_decode_attention
from seedx_tpu_torch.ops.moe import moe_experts
from seedx_tpu_torch.ops.rope import (apply_rope, deinterleave, rope_cos_sin,
                                      yarn_inv_freq, yarn_mscale)

KVCache = Tuple[torch.Tensor, ...]
IGNORE_INDEX = -100   # label value excluded from the LM loss (HF convention)
# a hybrid stack's multi-row step runs its rows in groups of about this
# many tokens (the experts' sorted rows and fp32 sums, the scan's chunk
# matrices: ~4 GB at full width)
HYBRID_ROWS_TOKENS = 16384
# what the special kinds (latent attention, sparse experts, the hybrid
# stack) do not support: LlamaConfig.refuse
UNSUPPORTED = ("quantized weights or KV", "LoRA or IA3 adapters",
               "paged KV", "fused step", "fused prefill",
               "speculative decoding", "beam search", "mesh", "training")


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
    lora_dropout: float = 0.05      # training only (a generator is given)
    # IA3 (the PEFT fork's tuner; reference llama.py:53-58): ones-init
    # scales on the k_proj / v_proj outputs and the down_proj input
    ia3: bool = False
    # "none" | "int8" (projections) | "int8_full" (+ embedding, lm_head) |
    # "int4" (nibble-packed projections, int8 embedding + lm_head)
    quantization: str = "none"
    kv_quantization: str = "none"   # "none" | "int8"
    # One-token decode steps and the fused step's stair through the ragged
    # kernel (reads only each row's window of the cache): "auto" = on CUDA
    # tensors, at every batch size; "force" = also on CPU tensors (its
    # plain version, for parity tests); "never" = dequantize the whole
    # cache and attend with the plain path.  Paged KV needs it on.
    decode_attention: str = "auto"
    attention_impl: str = "auto"    # "auto" | "plain" | "flash"
    remat: bool = True              # training: recompute each layer
    # Pad the embedding and lm_head rows up to this size (0 = exact;
    # reference llama.py:80-95): 32330 = 2*5*53*61 splits over tensor only
    # at 2, 5 and 10; 32336 = 8*4042 at 8.  Pad logits are masked to -1e9.
    vocab_pad_to: int = 0
    dtype: torch.dtype = torch.bfloat16
    # DeepSeek-V2 latent attention (kv_lora_rank 0: the LLaMA attention)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # DeepSeek-V2 sparse experts (n_routed_experts 0: every layer dense):
    # the first first_k_dense_replace layers dense (intermediate_size),
    # the rest top-num_experts_per_tok routed experts of width
    # moe_intermediate_size plus n_shared_experts of the same width as
    # one SwiGLU
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    # YaRN rope scaling (factor 0: plain RoPE)
    yarn_factor: float = 0.0
    yarn_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # Nemotron-H's hybrid stack ("": every layer attention + MLP): one
    # character a block, "M" Mamba-2, "E" sparse experts, "*" attention
    block_pattern: str = ""
    attn_head_dim: int = 0          # 0: hidden_size // num_heads
    rope: bool = True               # False: attention without RoPE
    # Mamba-2 (mamba_heads 0: none): H heads of P, state N, G groups of B
    # and C, a causal conv of conv_kernel taps, the prefill scan's chunk
    mamba_heads: int = 0
    mamba_head_dim: int = 64
    ssm_state_size: int = 128
    mamba_groups: int = 8
    conv_kernel: int = 4
    ssm_chunk: int = 128
    # sparse experts: "swiglu" (gate, up, down) or "relu2" (up, down);
    # "softmax" routing (DeepSeek-V2) or "sigmoid" (a score-correction
    # bias picks, the chosen scores renormalised); the shared experts'
    # width (0: moe_intermediate_size * n_shared_experts)
    expert_act: str = "swiglu"
    router_scoring: str = "softmax"
    shared_intermediate_size: int = 0

    def __post_init__(self):
        if not self.kinds():
            return
        if self.quantization != "none" or self.kv_quantization != "none":
            self.refuse("quantized weights or KV")
        if self.lora_rank or self.ia3:
            self.refuse("LoRA or IA3 adapters")
        if self.moe and not (0 < self.num_experts_per_tok
                             <= self.n_routed_experts
                             and self.moe_intermediate_size > 0
                             and 0 <= self.first_k_dense_replace
                             <= self.num_layers):
            raise ValueError("sparse experts: need 0 < num_experts_per_tok "
                             "<= n_routed_experts, moe_intermediate_size and "
                             "first_k_dense_replace <= num_layers")
        if self.expert_act not in ("swiglu", "relu2") or \
                self.router_scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"sparse experts: expert_act swiglu | relu2, "
                             f"router_scoring softmax | sigmoid, got "
                             f"{self.expert_act!r}, {self.router_scoring!r}")
        if self.hybrid:
            counts = {k: self.block_pattern.count(k) for k in "ME*"}
            if (len(self.block_pattern) != self.num_layers
                    or sum(counts.values()) != self.num_layers
                    or (counts["M"] and not self.mamba_heads)
                    or (counts["E"] and not self.moe) or self.mla
                    or self.mamba_heads % max(self.mamba_groups, 1)):
                raise ValueError(
                    f"block_pattern {self.block_pattern!r}: one of M / E / "
                    f"* a layer ({self.num_layers}), mamba_heads for M "
                    f"(a multiple of mamba_groups), sparse experts for E, "
                    f"no latent attention")

    def kinds(self) -> list:
        """The special kinds this configuration holds."""
        return [k for k, on in (("latent attention", self.mla),
                                ("sparse experts", self.moe),
                                ("state-space mixers", self.hybrid)) if on]

    def refuse(self, feature: str) -> None:
        """The one place that names what latent attention, sparse experts
        and the hybrid stack do not support (``UNSUPPORTED``): a
        ValueError naming ``feature`` if this configuration holds any of
        them, else nothing."""
        if feature not in UNSUPPORTED:
            raise KeyError(f"not a refusable feature: {feature!r}")
        kinds = self.kinds()
        if kinds:
            raise ValueError(f"{' / '.join(kinds)}: no {feature}")

    @property
    def hybrid(self) -> bool:
        return bool(self.block_pattern)

    def kind_index(self, li: int) -> int:
        """Block ``li``'s ordinal among the blocks of its kind."""
        return self.block_pattern[:li].count(self.block_pattern[li])

    @property
    def mamba_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        """Width of the Mamba conv: x, B and C."""
        return self.mamba_inner + 2 * self.mamba_groups * self.ssm_state_size

    @property
    def shared_width(self) -> int:
        return (self.shared_intermediate_size
                or self.moe_intermediate_size * self.n_shared_experts)

    @property
    def head_dim(self) -> int:
        return self.attn_head_dim or self.hidden_size // self.num_heads

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def dense_layers(self) -> int:
        """Layers with the dense MLP (the first; every layer without
        experts; none in a hybrid stack)."""
        if self.hybrid:
            return 0
        return self.first_k_dense_replace if self.moe else self.num_layers

    @property
    def latent_dim(self) -> int:
        """Width of an MLA cache row: ``[c | k_pe]``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def rope_dim(self) -> int:
        return self.qk_rope_head_dim if self.mla else self.head_dim

    @property
    def softmax_scale(self) -> float:
        """q.k scale: (q head dim)^-0.5, times YaRN's mscale(factor,
        mscale_all_dim)^2 (DeepseekV2Attention)."""
        d = (self.qk_nope_head_dim + self.qk_rope_head_dim if self.mla
             else self.head_dim)
        m = (yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim)
             if self.yarn_factor and self.yarn_mscale_all_dim else 1.0)
        return d ** -0.5 * m * m

    def rope_tables(self, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cos / sin [..., rope_dim] for ``positions`` (YaRN where set)."""
        if not self.yarn_factor:
            return rope_cos_sin(positions, self.rope_dim, self.rope_theta)
        inv = yarn_inv_freq(self.rope_dim, self.rope_theta, self.yarn_factor,
                            self.yarn_original_max_position,
                            self.yarn_beta_fast, self.yarn_beta_slow,
                            positions.device)
        m = (yarn_mscale(self.yarn_factor, self.yarn_mscale)
             / yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim))
        return rope_cos_sin(positions, self.rope_dim, inv_freq=inv, mscale=m)

    @property
    def padded_vocab_size(self) -> int:
        return max(self.vocab_size, self.vocab_pad_to)


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
                  device=None, kv_heads: Optional[int] = None) -> KVCache:
    """(k, v) [L, B, S, Hkv*D] in ``dtype``; with int8 KV, int8 codes plus
    per-(position, head) scales [L, B, S, Hkv] in ``dtype``; with latent
    attention one tensor, the latent [L, B, S, kv_lora_rank + rope].  The JAX
    package pads the scale lanes to 128 for TPU DMA; here they stay
    compact.  ``kv_heads``: the heads a rank holds (``LlamaForCausalLM.
    kv_heads``; default all).  A hybrid stack: (k, v) [A, B, S, Hkv*D] of
    its A attention blocks, the conv state [M, B, K - 1, conv_dim] in
    ``dtype`` and the SSM state [M, B, H, P, N] in fp32 of its M Mamba
    blocks, each block at its ordinal within its kind."""
    dtype = dtype or cfg.dtype
    if cfg.hybrid:
        na, nm = (cfg.block_pattern.count(k) for k in "*M")
        flat = (na, batch, max_len, (kv_heads or cfg.num_kv_heads)
                * cfg.head_dim)
        return (torch.zeros(flat, dtype=dtype, device=device),
                torch.zeros(flat, dtype=dtype, device=device),
                torch.zeros((nm, batch, cfg.conv_kernel - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
                torch.zeros((nm, batch, cfg.mamba_heads, cfg.mamba_head_dim,
                             cfg.ssm_state_size), dtype=torch.float32,
                            device=device))
    if cfg.mla:
        # the latent [c | k_pe] of every position, one tensor
        return (torch.zeros((cfg.num_layers, batch, max_len, cfg.latent_dim),
                            dtype=dtype, device=device),)
    hkv = kv_heads or cfg.num_kv_heads
    flat = (cfg.num_layers, batch, max_len, hkv * cfg.head_dim)
    if cfg.kv_quantization == "int8":
        sshape = flat[:-1] + (hkv,)
        return (torch.zeros(flat, dtype=torch.int8, device=device),
                torch.zeros(flat, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=dtype, device=device),
                torch.zeros(sshape, dtype=dtype, device=device))
    return (torch.zeros(flat, dtype=dtype, device=device),
            torch.zeros(flat, dtype=dtype, device=device))


def init_paged_kv_pool(cfg: LlamaConfig, pool_tokens: int, dtype=None,
                       device=None, kv_heads: Optional[int] = None) -> KVCache:
    """Shared paged KV pool: the leaves of ``init_kv_cache`` without the
    per-slot batch axis, [L, pool_tokens, Hkv*D] (+ scales [L, pool_tokens,
    Hkv]).  Rows are handed out in fixed-size pages through block tables
    (inference/continuous.py paged mode)."""
    cfg.refuse("paged KV")
    dtype = dtype or cfg.dtype
    hkv = kv_heads or cfg.num_kv_heads
    flat = (cfg.num_layers, pool_tokens, hkv * cfg.head_dim)
    if cfg.kv_quantization == "int8":
        sshape = flat[:-1] + (hkv,)
        return (torch.zeros(flat, dtype=torch.int8, device=device),
                torch.zeros(flat, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=dtype, device=device),
                torch.zeros(sshape, dtype=dtype, device=device))
    return (torch.zeros(flat, dtype=dtype, device=device),
            torch.zeros(flat, dtype=dtype, device=device))


def kv_window(kv_valid: torch.Tensor):
    """(starts, ends) int32 [B] of each row's one contiguous valid window
    (reference decode_stacked.py:145-148)."""
    m = kv_valid.to(torch.int32)
    starts = torch.argmax(m, dim=-1).to(torch.int32)
    return starts, (starts + m.sum(dim=-1)).to(torch.int32)


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
        # IA3 target set = the PEFT fork's llama defaults (reference
        # llama.py:208-210): k / v outputs, the down_proj input
        ia3 = ({"k_proj": "out", "v_proj": "out", "down_proj": "in"}
               if cfg.ia3 else {})

        def dense(name, n_in, n_out, layers=L):
            return LoRADense(n_in, n_out, lora_rank=cfg.lora_rank,
                             lora_alpha=cfg.lora_alpha,
                             lora_dropout=cfg.lora_dropout,
                             quantize=cfg.quantization, ia3=ia3.get(name),
                             dtype=dt, layers=layers, device=device)

        self.input_layernorm = RMSNorm(d, cfg.rms_eps, dt, L, device)
        if cfg.hybrid:
            self._init_hybrid(dense, device)
            return
        if cfg.mla:
            h, r = cfg.num_heads, cfg.kv_lora_rank
            self.q_proj = dense("q_proj", d, h * (cfg.qk_nope_head_dim
                                                  + cfg.qk_rope_head_dim))
            self.kv_a_proj = dense("kv_a_proj", d, cfg.latent_dim)
            self.kv_a_layernorm = RMSNorm(r, cfg.rms_eps, dt, L, device)
            self.kv_b_proj = dense("kv_b_proj", r, h * (cfg.qk_nope_head_dim
                                                        + cfg.v_head_dim))
            self.o_proj = dense("o_proj", h * cfg.v_head_dim, d)
        else:
            self.q_proj = dense("q_proj", d, hq)
            self.k_proj = dense("k_proj", d, hkv)
            self.v_proj = dense("v_proj", d, hkv)
            self.o_proj = dense("o_proj", hq, d)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_eps, dt, L, device)
        nd = cfg.dense_layers
        if nd:
            f = cfg.intermediate_size
            self.gate_proj = dense("gate_proj", d, f, nd)
            self.up_proj = dense("up_proj", d, f, nd)
            self.down_proj = dense("down_proj", f, d, nd)
        if cfg.moe:
            self._init_moe(L - nd, Experts(L - nd, cfg.n_routed_experts, d,
                                           cfg.moe_intermediate_size, dt,
                                           device), device)

    def _init_moe(self, nm: int, experts: nn.Module, device) -> None:
        """The router, the routed ``experts``, the shared experts and the
        activation counter of ``nm`` sparse-expert layers."""
        cfg = self.cfg
        d, dt, e, fs = (cfg.hidden_size, cfg.dtype, cfg.n_routed_experts,
                        cfg.shared_width)
        self.router = PDense(d, e, use_bias=False, dtype=dt, layers=nm,
                             device=device)
        self.experts = experts
        if cfg.router_scoring == "sigmoid":
            # the score-correction bias: it picks the experts, fp32
            self.register_buffer("e_score_correction_bias", torch.zeros(
                (nm, e), dtype=torch.float32, device=device))
        if fs:
            if cfg.expert_act == "swiglu":
                self.shared_gate_proj = PDense(d, fs, use_bias=False,
                                               dtype=dt, layers=nm,
                                               device=device)
            self.shared_up_proj = PDense(d, fs, use_bias=False, dtype=dt,
                                         layers=nm, device=device)
            self.shared_down_proj = PDense(fs, d, use_bias=False, dtype=dt,
                                           layers=nm, device=device)
        # (layer, step) expert activations with rows: K6 adds to it
        self.register_buffer("experts_active", torch.zeros(
            (), dtype=torch.int64, device=device), persistent=False)

    def _init_hybrid(self, dense, device) -> None:
        """A hybrid stack's mixers, each kind stacked over its own blocks:
        the attention's q / k / v / o, the Mamba mixers, the sparse
        experts (a leaf a block)."""
        cfg = self.cfg
        d, dt = cfg.hidden_size, cfg.dtype
        na, nm, ne = (cfg.block_pattern.count(k) for k in "*ME")
        hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        if na:
            self.q_proj = dense("q_proj", d, hq, na)
            self.k_proj = dense("k_proj", d, hkv, na)
            self.v_proj = dense("v_proj", d, hkv, na)
            self.o_proj = dense("o_proj", hq, d, na)
        if nm:
            self.mamba = Mamba2Mixers(cfg, nm, device)
        if ne:
            self._init_moe(ne, nn.ModuleList(
                Experts(None, cfg.n_routed_experts, d,
                        cfg.moe_intermediate_size, dt, device,
                        gated=cfg.expert_act == "swiglu")
                for _ in range(ne)), device)

    def tp_plan(self, tensor: int) -> dict:
        """Roles over ``tensor`` (see the module docstring)."""
        cfg = self.cfg
        attn = (cfg.num_heads % tensor == 0 and cfg.num_kv_heads % tensor == 0
                and self.o_proj.row_split_ok(tensor))
        roles = {n: "col" if attn else None
                 for n in ("q_proj", "k_proj", "v_proj")}
        roles.update(o_proj="row" if attn else None, gate_proj="col",
                     up_proj="col", down_proj="row"
                     if self.down_proj.row_split_ok(tensor) else None)
        return roles

    def heads(self) -> Tuple[int, int]:
        """(query heads, kv heads) this rank attends over."""
        cfg = self.cfg
        t = tensor_size(self) if self.q_proj.tp == "col" else 1
        return cfg.num_heads // t, cfg.num_kv_heads // t

    def block(self, li: int, x, cache: Optional[KVCache], cos, sin,
              kv_valid, cache_index, step: Optional["_Step"] = None,
              drop: Optional[torch.Generator] = None,
              keep: Optional[torch.Tensor] = None,
              write_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decoder layer (reference LlamaBlock, llama.py:180-309):
        x [B, S, hidden] (the packed fused step: [1, P, hidden]); with a
        cache, ``step`` says where layer ``li``'s new k/v rows go and how
        the queries attend (see ``_Step``).  ``drop`` (training) draws the
        LoRA dropout masks of the seven projections in order.  ``keep``
        [B, S] bool (sparse experts, Mamba mixers): the real tokens, the
        rest routed to no expert and left out of the recurrent state.
        ``write_mask`` [B] (a hybrid stack's one-token step): the rows
        whose recurrent state the step may change."""
        b, s, _ = x.shape
        h = self.input_layernorm(x, li)
        if self.cfg.hybrid:
            return x + self._mixer(li, h, cache, kv_valid, cache_index, step,
                                   keep, write_mask)
        if self.cfg.mla:
            attn = self._latent_attention(li, h, cache, cos, sin, kv_valid,
                                          cache_index, step)
        else:
            attn = self._attention(li, h, cache, cos, sin, kv_valid,
                                   cache_index, step, drop)
        x = x + self.o_proj(attn.reshape(b, s, -1), li, drop)
        h = self.post_attention_layernorm(x, li)
        if li >= self.cfg.dense_layers:
            return x + self._experts(li - self.cfg.dense_layers, h, keep)
        gate = self.gate_proj(h, li, drop)
        up = self.up_proj(h, li, drop)
        act = F.silu(gate) * up
        if self.gate_proj.tp == "col" and self.down_proj.tp != "row":
            act = self.down_proj._par.all_gather(act, -1, "tensor")
        return x + self.down_proj(act, li, drop)

    def _attention(self, li: int, h, cache: Optional[KVCache], cos, sin,
                   kv_valid, cache_index, step: Optional["_Step"],
                   drop: Optional[torch.Generator]) -> torch.Tensor:
        """The LLaMA attention of layer ``li`` over h [B, S, hidden]: the
        heads' outputs [B, S, heads, head_dim]."""
        cfg = self.cfg
        b, s, _ = h.shape
        (nq, nh), hd = self.heads(), cfg.head_dim
        q = self.q_proj(h, li, drop).reshape(b, s, nq, hd)
        k = self.k_proj(h, li, drop).reshape(b, s, nh, hd)
        v = self.v_proj(h, li, drop).reshape(b, s, nh, hd)
        if cfg.rope:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        if cache is None:
            attn = dot_product_attention(q, k, v, kv_valid=kv_valid,
                                         causal=True, impl=cfg.attention_impl)
        else:
            layer = tuple(c[li] for c in cache)
            if len(layer) == 4:            # int8 codes + per-entry scales
                kq, ksc = quantize_kv(k)
                vq, vsc = quantize_kv(v)
                new = (kq, vq, ksc, vsc)
            else:
                new = (k, v)
            for buf, val in zip(layer, new):
                step.store(buf, val)
            if step.window is not None:
                scales = ({"k_scale": layer[2], "v_scale": layer[3]}
                          if len(layer) == 4 else {})
                qw = step.to_window(q)
                out = ragged_decode_attention(
                    qw if step.stair else qw[:, 0].contiguous(), layer[0],
                    layer[1], *step.window, block_tables=step.block_tables,
                    page=step.page, **scales)
                attn = step.from_window(out if step.stair else out[:, None])
            else:
                bw, max_len = layer[0].shape[:2]
                kk = layer[0].reshape(bw, max_len, nh, hd).to(cfg.dtype)
                vv = layer[1].reshape(bw, max_len, nh, hd).to(cfg.dtype)
                if len(layer) == 4:
                    kk = kk * layer[2][..., None].to(cfg.dtype)
                    vv = vv * layer[3][..., None].to(cfg.dtype)
                if step.stair:
                    # per-row causal: query slot i of row b sees positions
                    # <= cache_index[b] + i (decode_stacked.py:266-273)
                    attn = step.from_window(dot_product_attention(
                        step.to_window(q), kk, vv, kv_valid=kv_valid,
                        causal=True,
                        q_offset=cache_index, impl="plain"))
                else:
                    attn = dot_product_attention(
                        q, kk, vv, kv_valid=kv_valid, causal=s > 1,
                        q_offset=cache_index if s > 1 else None,
                        impl="plain" if s == 1 else cfg.attention_impl)
        return attn

    def _latent_attention(self, li: int, h, cache: Optional[KVCache], cos,
                          sin, kv_valid, cache_index,
                          step: Optional["_Step"]) -> torch.Tensor:
        """DeepSeek-V2's latent attention of layer ``li`` over h [B, S,
        hidden] (see the module docstring): [B, S, heads, v_head_dim]."""
        cfg = self.cfg
        b, s, _ = h.shape
        nh, dn, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        q = self.q_proj(h, li).reshape(b, s, nh, -1)
        q_pe = apply_rope(deinterleave(q[..., dn:]), cos, sin)
        kv = self.kv_a_proj(h, li)
        k_pe = apply_rope(deinterleave(kv[..., None, r:]), cos, sin)
        latent = torch.cat([self.kv_a_layernorm(kv[..., :r], li),
                            k_pe[:, :, 0]], dim=-1)           # [B, S, r + dr]
        if cache is None:
            return self._expanded(li, torch.cat([q[..., :dn], q_pe], -1),
                                  latent, kv_valid, None)
        buf = cache[0][li]
        step.store(buf, latent)
        if s == 1:
            return self._absorbed(li, q[:, 0, :, :dn], q_pe[:, 0], buf,
                                  kv_valid)
        # a multi-row step at a scalar offset (prefill, the forced <img>
        # chunk): the cached window up to its last row, expanded
        end = cache_index + s
        return self._expanded(li, torch.cat([q[..., :dn], q_pe], -1),
                              buf[:, :end], None if kv_valid is None
                              else kv_valid[:, :end], cache_index)

    def _expanded(self, li: int, q, latent, kv_valid, q_offset
                  ) -> torch.Tensor:
        """Attention with per-head k = [c W_UK | k_pe] and v = c W_UV
        expanded from the latent [B, S, r + dr]; q [B, s, H, dn + dr].  A
        few batch rows a call: a 4096-token row's fp32 scores take 1 GiB."""
        cfg = self.cfg
        b, n = latent.shape[:2]
        nh, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        kv = self.kv_b_proj(latent[..., :r], li).reshape(b, n, nh, dn + dv)
        k = torch.cat([kv[..., :dn], latent[:, :, None, r:].expand(
            b, n, nh, cfg.qk_rope_head_dim)], dim=-1)
        v = kv[..., dn:]
        per = max(1, (1 << 30) // (4 * nh * q.shape[1] * n))
        return torch.cat([dot_product_attention(
            q[i:i + per], k[i:i + per], v[i:i + per],
            kv_valid=None if kv_valid is None else kv_valid[i:i + per],
            causal=True, q_offset=q_offset, scale=cfg.softmax_scale,
            impl=cfg.attention_impl) for i in range(0, b, per)])

    def _absorbed(self, li: int, q_nope, q_pe, buf, kv_valid
                  ) -> torch.Tensor:
        """One query a row, q_nope [B, H, dn] and q_pe [B, H, dr], against
        the cached latent buf [B, S, r + dr] under ``kv_valid`` [B, S]:
        W_UK and W_UV are views of ``kv_b_proj``'s kernel.  Scores in bf16
        products with fp32 accumulation, softmax in fp32.  Returns [B, 1,
        H, dv]."""
        cfg = self.cfg
        nh, dn, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        w = self.kv_b_proj.dense_kernel(li).reshape(r, nh, -1)
        w_uk, w_uv = w[..., :dn], w[..., dn:]            # [r, H, dn / dv]
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk.permute(1, 2, 0))
        q_all = torch.cat([q_lat, q_pe.transpose(0, 1).to(q_lat.dtype)],
                          dim=-1).transpose(0, 1)         # [B, H, r + dr]
        scores = torch.bmm(q_all, buf.transpose(1, 2)).float()
        scores = torch.where(kv_valid[:, None, :],
                             scores * cfg.softmax_scale, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(buf.dtype)
        o_lat = torch.bmm(probs, buf[..., :r])            # [B, H, r]
        out = torch.bmm(o_lat.transpose(0, 1), w_uv.permute(1, 0, 2))
        return out.transpose(0, 1)[:, None]

    def _mixer(self, li: int, h, cache: Optional[KVCache], kv_valid,
               cache_index, step: Optional["_Step"], keep, write_mask
               ) -> torch.Tensor:
        """Block ``li`` of a hybrid stack: its one mixer over the normed
        h [B, S, hidden], by the pattern's kind, at the block's ordinal
        within its kind."""
        kind, j = self.cfg.block_pattern[li], self.cfg.kind_index(li)
        if kind == "M":
            state = None if cache is None else (cache[2][j], cache[3][j])
            return self.mamba(j, h, state, cache_index, keep, write_mask)
        if kind == "E":
            return self._experts(j, h, keep)
        b, s, _ = h.shape
        attn = self._attention(j, h, None if cache is None else cache[:2],
                               None, None, kv_valid, cache_index, step, None)
        return self.o_proj(attn.reshape(b, s, -1), j)

    def _experts(self, m: int, h: torch.Tensor,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sparse-expert MLP of MoE layer ``m``: the routed experts (fp32
        sum; tokens outside ``keep`` get none) plus the shared experts'
        SwiGLU (relu2 for relu2 experts), rounded once."""
        cfg = self.cfg
        b, s, d = h.shape
        x = h.reshape(-1, d)
        if cfg.hybrid:
            bank = self.experts[m]
            gate, up, down = (getattr(bank, "gate_proj", None), bank.up_proj,
                              bank.down_proj)
        else:
            ex = self.experts
            gate, up, down = ex.gate_proj[m], ex.up_proj[m], ex.down_proj[m]
        corr = (self.e_score_correction_bias[m]
                if cfg.router_scoring == "sigmoid" else None)
        y = moe_experts(x, leaf(self.router, "kernel", m), gate, up, down,
                        cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                        self.experts_active,
                        None if keep is None else keep.reshape(-1), corr)
        if cfg.shared_width:
            if cfg.expert_act == "relu2":
                act = F.relu(self.shared_up_proj(x, m)).square()
            else:
                act = F.silu(self.shared_gate_proj(x, m)) \
                    * self.shared_up_proj(x, m)
            y = y + self.shared_down_proj(act, m).float()
        return y.to(h.dtype).reshape(b, s, d)


class Experts(nn.Module):
    """The routed experts of every MoE layer: ``gate_proj`` / ``up_proj``
    [L, E, hidden, f] and ``down_proj`` [L, E, f, hidden], each expert's
    kernel in the [in, out] layout; ``layers`` None: one layer's, [E,
    ...]; ``gated`` False: no ``gate_proj`` (relu2 experts)."""

    def __init__(self, layers: Optional[int], experts: int, d: int, f: int,
                 dtype, device=None, gated: bool = True):
        super().__init__()
        lead = (experts,) if layers is None else (layers, experts)
        for name, shape in (("gate_proj", (d, f)), ("up_proj", (d, f)),
                            ("down_proj", (f, d))):
            if name != "gate_proj" or gated:
                self.register_buffer(name, torch.zeros(
                    lead + shape, dtype=dtype, device=device))


@dataclasses.dataclass
class _Step:
    """Where one forward writes its new k/v rows and how its queries read
    the cache; built once per forward, used by every layer.

    ``at`` indexes one cell of a layer buffer ([B, S, F], or a pool
    [P * page, F]) for every row of the flattened new k/v; a slot the step
    drops indexes a dump cell (see the module docstring).  ``mask`` (one
    entry a row of the flattened k/v) writes a cell back as it was where
    it is False.  ``flat`` is False only for the [B, s] block write at a scalar
    offset.  ``window`` (starts, ends) sends attention to the ragged
    kernel; ``stair`` marks the fused step, whose queries form a [B, w]
    window: the x rows themselves (windowed), or every packed token
    scattered there at (``q_row``, ``q_slot``), a token the step does not
    carry into a dump row B, and every token gathered back from
    (``row_c``, ``slot``) (packed)."""

    at: tuple
    mask: Optional[torch.Tensor] = None
    flat: bool = True
    window: Optional[tuple] = None
    stair: bool = False
    block_tables: Optional[torch.Tensor] = None
    page: int = 0
    # (q_row, q_slot, row_c, slot, B, w)
    packed: Optional[tuple] = None

    def store(self, buf: torch.Tensor, val: torch.Tensor) -> None:
        if not self.flat:
            buf[self.at] = val.to(buf.dtype).reshape(buf.shape[0], -1,
                                                     buf.shape[-1])
            return
        val = val.to(buf.dtype).reshape(-1, buf.shape[-1])
        if self.mask is not None:
            val = torch.where(self.mask[:, None], val, buf[self.at])
        buf[self.at] = val

    def to_window(self, q: torch.Tensor) -> torch.Tensor:
        """Packed [1, P, H, D] -> [B, w, H, D] (decode_stacked.py:402-407);
        slots no token fills stay zero, compute garbage and are never
        gathered."""
        if self.packed is None:
            return q
        q_row, q_slot, _, _, b, w = self.packed
        out = q.new_zeros((b + 1, w) + q.shape[2:])
        out[q_row, q_slot] = q[0]
        return out[:b]

    def from_window(self, t: torch.Tensor) -> torch.Tensor:
        """[B, w, H, D] -> packed [1, P, H, D] (decode_stacked.py:409-411)."""
        if self.packed is None:
            return t
        row_c, slot = self.packed[2:4]
        return t[row_c, slot][None]


class Embedder(nn.Module):
    """Token table [padded vocab, hidden]; int8 rows + per-row fp32 scales
    under ``int8_full`` / ``int4`` (reference llama.py:336-349).  On a
    mesh (``tp == "vocab"``) a rank holds a contiguous range of rows: ids
    outside it look up zeros, and the all-reduce over the tensor group
    sums each id's one real row."""

    tp: Optional[str] = None

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.padded_vocab_size, cfg.hidden_size)
        self.quantized = cfg.quantization in ("int8_full", "int4")
        if self.quantized:
            self.register_buffer("embedding_q", torch.zeros(
                shape, dtype=torch.int8, device=device))
            self.register_buffer("embedding_scale", torch.ones(
                (cfg.padded_vocab_size,), dtype=torch.float32,
                device=device))
        else:
            self.register_buffer("embedding", torch.zeros(
                shape, dtype=cfg.dtype, device=device))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        ids, ok = input_ids, None
        if self.tp == "vocab":
            n = self.embedding_scale.shape[0] if self.quantized \
                else self.embedding.shape[0]
            ids = input_ids - self._par.rank["tensor"] * n
            ok = (ids >= 0) & (ids < n)
            ids = torch.where(ok, ids, 0)
        if self.quantized:
            rows = leaf(self, "embedding_q")[ids].to(dt)
            rows = rows * leaf(self, "embedding_scale")[ids][..., None].to(dt)
        else:
            rows = leaf(self, "embedding")[ids].to(dt)
        if ok is not None:
            rows = torch.where(ok[..., None], rows, 0.0)
            rows = self._par.reduce_from(rows)
        return rows


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
            cfg.hidden_size, cfg.padded_vocab_size,
            quantize=("int8" if cfg.quantization in ("int8_full", "int4")
                      else "none"), dtype=cfg.dtype, device=device)

    def tp_plan(self, tensor: int) -> dict:
        return {"embed_tokens": "vocab", "lm_head": "col"}

    @property
    def kv_heads(self) -> int:
        """The KV heads this rank's cache holds."""
        return self.layers.heads()[1]

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits over the vocab (gathered from the tensor group on a
        mesh), pad columns masked to -1e9 (reference llama.py:494-499)."""
        logits = self.lm_head(hidden)
        if self.lm_head.tp == "col":
            par = self.lm_head._par
            # training: the gather's backward keeps this rank's vocab block
            logits = (par.gather_from(logits, -1) if logits.requires_grad
                      else par.all_gather(logits, -1, "tensor"))
        cfg = self.cfg
        if cfg.padded_vocab_size != cfg.vocab_size:
            keep = torch.arange(logits.shape[-1], device=logits.device) \
                < cfg.vocab_size
            logits = torch.where(keep, logits,
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device))
        return logits

    def forward(self, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                kv_valid: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, cache_index=0,
                block_tables: Optional[torch.Tensor] = None,
                write_widths: Optional[torch.Tensor] = None,
                tok_row: Optional[torch.Tensor] = None,
                tok_slot: Optional[torch.Tensor] = None,
                packed_window: int = 0,
                write_mask: Optional[torch.Tensor] = None,
                last: Optional[torch.Tensor] = None):
        """Returns (logits, last hidden state, cache); the cache tensors are
        updated in place.  ``last`` [B] keeps only row b's position
        ``last[b]`` past the layers (logits and hidden [B, 1, ...]: a
        prefill's next-token rows, without the LM head over the prompt).  ``cache_index`` is an int, or a [B] tensor of
        per-row write positions for a one-token or fused step;
        ``block_tables`` [B, S // page] makes ``cache`` a paged pool
        (per-row steps with a kv window only).  ``write_widths`` [B] makes
        the step the windowed fused step (x [B, w, hidden]); with
        ``tok_row`` / ``tok_slot`` [P] and ``packed_window`` w it is the
        packed fused step (x [P, hidden], positions [P], logits and hidden
        [P, ...]); see the module docstring.  ``write_mask`` [B] bool (a
        one-token step with per-row ``cache_index``) keeps the cache cells
        of the rows where it is False as they were."""
        cfg = self.cfg
        packed = tok_row is not None
        fused = write_widths is not None
        per_row = torch.is_tensor(cache_index) and cache_index.dim() == 1
        if packed and not (fused and per_row and packed_window > 0
                           and cache is not None):
            raise ValueError("the packed fused step needs a cache, per-row "
                             "cache_index, write_widths and packed_window")
        if packed:
            inputs_embeds, positions = inputs_embeds[None], positions[None]
        b, s = inputs_embeds.shape[:2]
        if per_row and s != 1 and not fused:
            raise ValueError("per-row cache_index requires seq == 1 (or "
                             "write_widths for the fused step)")
        if fused and not per_row:
            raise ValueError("the fused step (write_widths) needs per-row "
                             "cache_index")
        if write_mask is not None and (fused or not per_row):
            raise ValueError("write_mask needs a one-token step with "
                             "per-row cache_index")
        if not per_row:
            cache_index = int(cache_index)
        if fused:
            cfg.refuse("fused step")
        if block_tables is not None:
            cfg.refuse("paged KV")
        if cfg.hybrid and s > 1 and b > 1 and b * s > HYBRID_ROWS_TOKENS:
            return self._row_groups(inputs_embeds, positions, kv_valid, cache,
                                    cache_index, last)
        page = 0
        if block_tables is not None:
            if (cfg.quantization != "int4" or cfg.decode_attention == "never"
                    or not per_row or kv_valid is None):
                raise ValueError(
                    "paged KV (block_tables) requires quantization='int4', "
                    "decode_attention on, and one-token or fused steps with "
                    "per-row cache_index and kv_valid")
            page = kv_valid.shape[1] // block_tables.shape[1]
        step = None
        if cache is not None:
            step = self._step(cache, kv_valid, cache_index, block_tables,
                              page, write_widths, tok_row, tok_slot,
                              packed_window, b, s, inputs_embeds.is_cuda,
                              write_mask)
        keep = None
        if (cfg.moe or cfg.hybrid) and kv_valid is not None and not per_row:
            # a padded batch's real tokens: the cells they write (all of
            # kv_valid without a cache)
            keep = (kv_valid if cache is None
                    else kv_valid[:, cache_index:cache_index + s])
        x = inputs_embeds.to(cfg.dtype)
        cos, sin = cfg.rope_tables(positions) if cfg.rope else (None, None)
        for li in range(cfg.num_layers):
            x = self.layers.block(li, x, cache, cos, sin, kv_valid,
                                  cache_index, step, keep=keep,
                                  write_mask=write_mask)
        if last is not None:
            x = x[torch.arange(b, device=x.device), last.long()][:, None]
        hidden = self.norm(x)
        logits = self.head(hidden)
        if packed:
            return logits[0], hidden[0], cache
        return logits, hidden, cache

    def _row_groups(self, embeds, positions, kv_valid, cache, cache_index,
                    last):
        """A hybrid stack's multi-row step in groups of rows of about
        ``HYBRID_ROWS_TOKENS`` tokens, each through every layer, writing
        its rows' views of the cache."""
        b, s = embeds.shape[:2]
        per = max(1, HYBRID_ROWS_TOKENS // s)
        outs = []
        for r in range(0, b, per):
            rows = slice(r, r + per)
            outs.append(self(
                embeds[rows], positions[rows],
                None if kv_valid is None else kv_valid[rows],
                None if cache is None else tuple(c[:, rows] for c in cache),
                cache_index, last=None if last is None else last[rows])[:2])
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), cache)

    def forward_train(self, inputs_embeds: torch.Tensor,
                      positions: torch.Tensor,
                      kv_valid: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """The cache-less training forward: (logits, hidden), hidden after
        the final norm (reference LlamaModel.__call__ with no cache).  With
        ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
        (non-reentrant) and is recomputed in the backward, as the JAX
        package's ``nn.remat`` block.  With a ``generator`` and
        ``lora_dropout > 0`` the LoRA inputs drop out: each layer's masks
        come from its own seed, drawn from ``generator`` up front, so the
        recomputation draws the same masks.  A quantized base raises: its
        projections have no backward (neither has the JAX package's int4
        kernel)."""
        cfg = self.cfg
        cfg.refuse("training")
        if cfg.quantization != "none":
            raise ValueError(f"training needs quantization='none' (a bf16 "
                             f"or fp32 base), got {cfg.quantization!r}")
        n = cfg.num_layers
        seeds = [None] * n
        if generator is not None and cfg.lora_rank and cfg.lora_dropout:
            seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                                  device=generator.device).tolist()
        x = inputs_embeds.to(cfg.dtype)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        for li in range(n):
            fn = functools.partial(self._train_block, li, seeds[li])
            if cfg.remat and torch.is_grad_enabled():
                # the layer draws no global randomness: no RNG state to keep
                x = checkpoint(fn, x, cos, sin, kv_valid, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = fn(x, cos, sin, kv_valid)
        hidden = self.norm(x)
        return self.head(hidden), hidden

    def _train_block(self, li: int, seed: Optional[int], x, cos, sin,
                     kv_valid) -> torch.Tensor:
        drop = None
        if seed is not None:
            drop = torch.Generator(device=x.device)
            drop.manual_seed(seed)
        return self.layers.block(li, x, None, cos, sin, kv_valid, 0,
                                 drop=drop)

    def _step(self, cache, kv_valid, cache_index, block_tables, page: int,
              write_widths, tok_row, tok_slot, window_w: int, b: int, s: int,
              on_cuda: bool, write_mask=None) -> _Step:
        """The write and attention plan of one forward (see ``_Step``)."""
        cfg = self.cfg
        dev = cache[0].device
        kernel = not cfg.mla and kv_valid is not None and (
            block_tables is not None or cfg.decode_attention == "force"
            or (cfg.decode_attention == "auto" and on_cuda))
        if write_widths is None and not torch.is_tensor(cache_index):
            # prefill, the forced <img> chunk, or a one-token step of the
            # whole batch at a scalar offset
            return _Step(at=(slice(None), slice(cache_index,
                                                cache_index + s)),
                         flat=False, window=kv_window(kv_valid)
                         if kernel and s == 1 else None)
        rows = torch.arange(cache_index.shape[0], device=dev)
        ci = cache_index.long()
        if tok_row is not None:
            # packed: one write per token at its row's position + its slot
            n_rows = rows.shape[0]
            row_c = torch.clamp(tok_row.long(), max=n_rows - 1)
            slot = tok_slot.long()
            w_row, w_pos = row_c, ci[row_c] + slot
            ok = tok_row < n_rows
            packed = (torch.where(ok, tok_row.long(), n_rows),
                      torch.where(ok, slot, 0), row_c, slot, n_rows,
                      window_w)
        elif write_widths is not None:
            # windowed: row b's slots [0, write_widths[b]) at ci[b] + slot
            slots = torch.arange(s, device=dev)
            w_row = rows[:, None].expand(-1, s).reshape(-1)
            w_pos = (ci[:, None] + slots).reshape(-1)
            ok = (slots[None, :] < write_widths[:, None]).reshape(-1)
            packed = None
        else:
            # one position per row (s == 1): [B] rows of the cache, or pool
            # rows through the block tables (decode_stacked.py:185)
            at = ((block_tables.long()[rows, ci // page] * page + ci % page,)
                  if block_tables is not None else (rows, ci))
            return _Step(at=at, mask=write_mask, window=kv_window(kv_valid)
                         if kernel else None, block_tables=block_tables,
                         page=page)
        # slots past a row's width and positions past the cache are
        # dropped, never clamped (decode_stacked.py:170-184): a clamped
        # write would land on a cell another row's real token owns.  A
        # dropped write puts back what its cell held, at a cell no real
        # write of this step targets: on the reserved dump page 0 of a
        # pool; in a dense cache, the first cell past its row's real
        # writes (mod the cache length).  Shapes stay static.
        if block_tables is not None:
            n_tiles = block_tables.shape[1]
            col = w_pos // page
            ok = ok & (col < n_tiles)
            tiles = block_tables.long()[w_row, torch.clamp(col,
                                                           max=n_tiles - 1)]
            at = (torch.where(ok, tiles * page + w_pos % page,
                              w_pos % page),)
        else:
            c = cache[0].shape[2]
            ok = ok & (w_pos < c)
            dump = (ci + write_widths.long()) % c
            at = (w_row, torch.where(ok, w_pos, dump[w_row]))
        window = None
        if kernel:
            # the stair: kv_valid covers [start, pos + width), so slot 0's
            # end is that end minus (width - 1) (decode_stacked.py:149-154)
            starts, ends = kv_window(kv_valid)
            ends = (ends - torch.clamp(write_widths - 1, min=0)).to(
                torch.int32)
            window = (starts, ends)
        return _Step(at=at, mask=ok, window=window, stair=True,
                     block_tables=block_tables, page=page, packed=packed)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   groups=None) -> torch.Tensor:
    """Shifted cross-entropy over fp32 log-softmax, mean over the labels
    that are not ``IGNORE_INDEX`` (reference llama.py:503-514).  With a
    mesh's ``groups`` (``parallel.distributed.MeshGroups``) the mean is
    the global batch's, as the JAX package's loss under SPMD: this rank's
    sum over the valid labels of the whole batch (their count summed over
    the batch axes), so the ranks' losses and gradients sum to the
    global ones."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    total = torch.where(valid, -token_ll, 0.0).sum()
    count = valid.sum()
    if groups is not None:
        count = groups.batch_sum(count)
    return total / torch.clamp(count, min=1)


class LlamaForSequenceClassification(nn.Module):
    """Sequence classification over the trunk (reference llama.py:517-544;
    modeling_llama_xformer.py:804-919): ``score`` (no bias) on the hidden
    state of each row's last non-pad token.  Leaves as the JAX package
    names them (``embed_tokens``, the trunk ``layers`` + ``norm``,
    ``score``).  The padded trunk attends with ``kv_valid`` = the mask,
    causally, through the flash kernel on the card."""

    def __init__(self, cfg: LlamaConfig, num_labels: int = 2, device=None):
        super().__init__()
        self.cfg, self.num_labels = cfg, num_labels
        self.embed_tokens = Embedder(cfg, device)
        self.layers = LlamaLayers(cfg, device)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                            device=device)
        self.score = PDense(cfg.hidden_size, num_labels, use_bias=False,
                            dtype=cfg.dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """input_ids [B, S], attention_mask [B, S] (right-padded) ->
        logits [B, num_labels]."""
        cfg = self.cfg
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.bool,
                                        device=input_ids.device)
        mask = attention_mask.to(torch.int64)
        positions = torch.clamp(torch.cumsum(mask, dim=-1) - 1, min=0)
        x = self.embed_tokens(input_ids)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        kv_valid = attention_mask.to(torch.bool)
        for li in range(cfg.num_layers):
            x = self.layers.block(li, x, None, cos, sin, kv_valid, 0)
        logits = self.score(self.norm(x))
        last = mask.sum(dim=-1) - 1
        return logits[torch.arange(b, device=logits.device), last]
