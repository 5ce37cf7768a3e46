"""Release checkpoints -> the port's state dicts (reference:
seedx_tpu/utils/weights.py).

Readers and converters for the artifacts a SEED-X user has on disk
(reference README.md:74-158): ``QwenViT/qwen_vit_G.pt`` (the ViT), the
LLaMA2 HF shard directory and the agent's ``pytorch_model.bin`` (LoRA,
resamplers, norms), the detokenizer's ``pytorch_model.bin`` (ResamplerXL
and UNet deltas); ``utils/sdxl_weights.py`` covers the diffusers SDXL
UNet and VAE.

Each converter emits the port's own state names, the ones
``utils/convert.from_jax_params`` gives for the JAX package's trees
(``layers.*`` for the flax ``model.layers.layer.*``), in the JAX layouts
the port's modules hold: Linear ``[out, in]`` -> ``kernel [in, out]``,
the ViT's patchify conv -> ``[kh, kw, in, out]``, LayerNorm ``weight`` ->
``scale``.

Nothing is widened to fp32 or stacked on the host: readers keep every
tensor in its file dtype and over the file's pages (``mmap``), and a
stacked ``[L, ...]`` leaf is a ``LayerStack`` of per-layer views that the
factories (``models/factory.py``) copy into a module one layer at a time,
on its device, quantizing there when the module is quantized.  So loading
the 13B never holds a second copy of it on the host.

``.safetensors`` is read here (an 8-byte little-endian header length, the
JSON header, the raw bytes): the ``safetensors`` package is not needed.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
import warnings
import zipfile
from typing import Any, Callable, Dict, Mapping

import torch

StateDict = Mapping[str, Any]


class LayerStack:
    """A stacked ``[n, ...]`` leaf given by its layers: ``get(i)`` is
    layer ``i`` (usually a view of a file tensor), read when a loader
    copies it; ``tensor()`` stacks all of them."""

    def __init__(self, get: Callable[[int], torch.Tensor], n: int):
        self.get, self.n = get, n

    def tensor(self) -> torch.Tensor:
        return torch.stack([self.get(i) for i in range(self.n)])


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "F64": torch.float64,
              "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
              "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: tensor} over a read-only map of
    the file (no copy)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which the reader does not know")
        start, end = info["data_offsets"]
        shape = info["shape"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        with warnings.catch_warnings():    # the map is read-only
            warnings.simplefilter("ignore", UserWarning)
            t = torch.frombuffer(mapped, dtype=dtype, count=count,
                                 offset=base + start)
        out[name] = t.reshape(shape)
    return out


def load_torch_checkpoint(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Load a ``.bin`` / ``.pt`` (torch pickle, read with
    ``weights_only=True`` and, for the zip format, over a map of the
    file) or ``.safetensors`` file; tensors keep their file dtype.  A
    pickle holding ``{"state_dict": {...}}`` is unwrapped.  ``device``:
    move every tensor there."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=zipfile.is_zipfile(path))
        if "state_dict" in sd and isinstance(sd["state_dict"], dict):
            sd = sd["state_dict"]
    if device is not None:
        sd = {k: v.to(device) for k, v in sd.items()}
    return sd


# Single-file names HF / diffusers exporters use, in probe order.
_SINGLE_FILE_NAMES = (
    "model.safetensors", "pytorch_model.bin",
    "diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
)
_INDEX_NAMES = ("model.safetensors.index.json",
                "pytorch_model.bin.index.json",
                "diffusion_pytorch_model.safetensors.index.json")


def load_checkpoint_auto(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Load a checkpoint FILE or an HF-layout DIRECTORY (reference
    README.md:74-87: ``<model>/llm`` is an index JSON + shards,
    ``stable-diffusion-xl-base-1.0/unet`` a diffusers single-file dir).
    Probe order: index JSON (sharded) -> the known single-file names ->
    lone ``.safetensors`` / ``.bin`` / ``.pt`` files (several: merged in
    name order)."""
    if not os.path.isdir(path):
        return load_torch_checkpoint(path, device)
    for idx_name in _INDEX_NAMES:
        idx_path = os.path.join(path, idx_name)
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                weight_map = json.load(f)["weight_map"]
            out: Dict[str, torch.Tensor] = {}
            for shard in sorted(set(weight_map.values())):
                out.update(load_torch_checkpoint(os.path.join(path, shard),
                                                 device))
            return out
    for fname in _SINGLE_FILE_NAMES:
        fpath = os.path.join(path, fname)
        if os.path.exists(fpath):
            return load_torch_checkpoint(fpath, device)
    lone = [f for f in sorted(os.listdir(path))
            if f.endswith((".safetensors", ".bin", ".pt"))]
    out = {}
    for f in lone:
        out.update(load_torch_checkpoint(os.path.join(path, f), device))
    if lone:
        return out
    raise FileNotFoundError(
        f"no weight files found under checkpoint directory {path!r} "
        f"(looked for {_INDEX_NAMES + _SINGLE_FILE_NAMES} and lone "
        f".safetensors/.bin/.pt files)")


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _ln(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.scale": sd[f"{src}.weight"],
            f"{dst}.bias": sd[f"{src}.bias"]}


def _dense(sd, src: str, dst: str, bias: bool = True
           ) -> Dict[str, torch.Tensor]:
    out = {f"{dst}.kernel": sd[f"{src}.weight"].T}
    if bias:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]
    return out


def convert_resampler(sd: StateDict, prefix: str = "") -> Dict[str, Any]:
    """Qwen-style Resampler (qwen_visual.py:94-149): the packed
    ``nn.MultiheadAttention`` q/k/v split into three projections."""
    p = lambda k: f"{prefix}{k}"
    out: Dict[str, Any] = {"query": sd[p("query")]}
    out.update(_ln(sd, p("ln_q"), "ln_q"))
    out.update(_ln(sd, p("ln_kv"), "ln_kv"))
    w = sd[p("attn.in_proj_weight")]
    b = sd.get(p("attn.in_proj_bias"))
    dim = w.shape[0] // 3
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"attn.{name}.kernel"] = w[i * dim:(i + 1) * dim].T
        if b is not None:
            out[f"attn.{name}.bias"] = b[i * dim:(i + 1) * dim]
    out.update(_dense(sd, p("attn.out_proj"), "attn.out_proj"))
    if p("kv_proj.weight") in sd:
        out.update(_dense(sd, p("kv_proj"), "kv_proj", bias=False))
    return out


def _deinterleave_qkv(w: torch.Tensor, heads: int) -> torch.Tensor:
    """The reference ``VisualAttention.in_proj`` packs its output rows per
    head as [q_h | k_h | v_h] (qwen_visual.py:186-196), not torch MHA's
    [all q | all k | all v]: re-order the rows to the packed layout the
    block's ``chunk(3)`` expects."""
    hd = w.shape[0] // (3 * heads)
    grouped = w.reshape(heads, 3, hd, *w.shape[1:])
    return grouped.transpose(0, 1).reshape(w.shape)


def convert_qwen_vit(sd: StateDict, num_layers: int = 48,
                     num_heads: int = 16) -> Dict[str, Any]:
    """``qwen_vit_G.pt`` -> VisionTransformer state (blocks stacked)."""
    out: Dict[str, Any] = {
        "conv1.kernel": sd["conv1.weight"].permute(2, 3, 1, 0),
        "positional_embedding": sd["positional_embedding"],
        "proj": sd["proj"],
    }
    out.update(_ln(sd, "ln_pre", "ln_pre"))
    out.update(_ln(sd, "ln_post", "ln_post"))

    def stack(key: str, fn=lambda t: t) -> LayerStack:
        return LayerStack(
            lambda i: fn(sd[f"transformer.resblocks.{i}.{key}"]), num_layers)

    def qkv(t):
        return _deinterleave_qkv(t, num_heads)

    for ln in ("ln_1", "ln_2"):
        out[f"blocks.{ln}.scale"] = stack(f"{ln}.weight")
        out[f"blocks.{ln}.bias"] = stack(f"{ln}.bias")
    out["blocks.in_proj.kernel"] = stack("attn.in_proj.weight",
                                         lambda t: qkv(t).T)
    out["blocks.in_proj.bias"] = stack("attn.in_proj.bias", qkv)
    for src, dst in (("attn.out_proj", "out_proj"), ("mlp.c_fc", "mlp.c_fc"),
                     ("mlp.c_proj", "mlp.c_proj")):
        out[f"blocks.{dst}.kernel"] = stack(f"{src}.weight", lambda t: t.T)
        out[f"blocks.{dst}.bias"] = stack(f"{src}.bias")
    out.update({f"attn_pool.{k}": v for k, v in
                convert_resampler(sd, "attn_pool.").items()})
    if "patch_pos_embed" in sd:
        out["patch_pos_embed"] = sd["patch_pos_embed"]
    return out


def _row_mean(t: torch.Tensor) -> torch.Tensor:
    """fp32 mean over rows, [1, D], summed as numpy sums it (the JAX
    converter's arithmetic, so a resized table is bit-equal)."""
    if t.is_meta:
        return torch.empty((1, t.shape[1]), dtype=torch.float32,
                           device="meta")
    return torch.from_numpy(
        t.detach().float().cpu().numpy().mean(axis=0, keepdims=True))


def resize_vocab(embedding: torch.Tensor, lm_head: torch.Tensor,
                 new_vocab: int):
    """Mean-init new input rows, mean * 3 new output rows (reference:
    peft_models.py:69-84); both tables come back fp32 when they grow, as
    the JAX converter computes them."""
    old = embedding.shape[0]
    if new_vocab <= old:
        return embedding[:new_vocab], lm_head[:new_vocab]
    n = new_vocab - old
    mean_in = _row_mean(embedding)
    mean_out = _row_mean(lm_head) * 3
    return (torch.cat([embedding.float(), mean_in.expand(n, -1)]),
            torch.cat([lm_head.float(), mean_out.expand(n, -1)]))


def _normalize_peft(sd: StateDict) -> Dict[str, Any]:
    """HF ("model.layers.N...") or PEFT-wrapped ("base_model.model.model.
    layers.N...", ".base_layer", ".modules_to_save.default",
    ".original_module") keys -> HF keys.  Where a PEFT wrapper holds both
    copies of a module, the trained ``modules_to_save.default`` one is
    kept, whichever comes first in the file."""
    norm: Dict[str, Any] = {}
    saved = set()
    for k, v in sd.items():
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer.weight", ".weight")
        trained = ".modules_to_save.default" in k
        k = re.sub(r"\.modules_to_save\.default", "", k)
        k = re.sub(r"\.original_module", "", k)
        if k in saved and not trained:
            continue
        if trained:
            saved.add(k)
        norm[k] = v
    return norm


def convert_llama_hf(sd: StateDict, num_layers: int = 40,
                     vocab_size: int = 32330, pad_to: int = 0
                     ) -> Dict[str, Any]:
    """HF LLaMA state dict -> LlamaForCausalLM state (layers stacked),
    with LoRA factors where the checkpoint has them (``lora_A`` [r, in]
    -> ``lora_a`` [in, r]).  ``pad_to``: zero rows up to this vocab (the
    JAX package's tensor-parallel padding; inert)."""
    sd = _normalize_peft(sd)
    embedding = sd["model.embed_tokens.weight"]
    lm_head = sd["lm_head.weight"]
    if embedding.shape[0] != vocab_size:
        embedding, lm_head = resize_vocab(embedding, lm_head, vocab_size)
    if pad_to > vocab_size:
        pad = pad_to - vocab_size
        embedding = torch.cat([embedding, embedding.new_zeros(
            (pad, embedding.shape[1]))])
        lm_head = torch.cat([lm_head, lm_head.new_zeros(
            (pad, lm_head.shape[1]))])

    lyr = "model.layers.{}."

    def stack(pattern: str, fn=lambda t: t) -> LayerStack:
        return LayerStack(lambda i: fn(sd[lyr.format(i) + pattern]),
                          num_layers)

    out: Dict[str, Any] = {"embed_tokens.embedding": embedding}
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        sub = "self_attn" if proj in ("q_proj", "k_proj", "v_proj",
                                      "o_proj") else "mlp"
        out[f"layers.{proj}.kernel"] = stack(f"{sub}.{proj}.weight",
                                             lambda t: t.T)
        # LoRA factors: under self_attn or mlp, as the JAX converter probes
        found = [s for s in ("self_attn", "mlp")
                 if lyr.format(0) + f"{s}.{proj}.lora_A.default.weight" in sd]
        if found and lyr.format(0) + \
                f"{found[0]}.{proj}.lora_B.default.weight" in sd:
            for which in ("A", "B"):
                out[f"layers.{proj}.lora_{which.lower()}"] = stack(
                    f"{found[0]}.{proj}.lora_{which}.default.weight",
                    lambda t: t.T)
    for norm in ("input_layernorm", "post_attention_layernorm"):
        out[f"layers.{norm}.scale"] = stack(f"{norm}.weight")
    out["norm.scale"] = sd["model.norm.weight"]
    out["lm_head.kernel"] = lm_head.T
    return out


def convert_agent_checkpoint(sd: StateDict) -> Dict[str, Any]:
    """SEED-X agent ``pytorch_model.bin`` -> the agent's own state
    (patch position table, input / output resamplers); its ``llm.*`` keys
    come back under ``"llm_state_dict"`` for ``convert_llama_hf``."""
    out: Dict[str, Any] = {}
    if "patch_pos_embed" in sd:
        out["patch_pos_embed"] = sd["patch_pos_embed"]
    for name in ("input_resampler", "output_resampler"):
        if any(k.startswith(name + ".") for k in sd):
            out.update({f"{name}.{k}": v for k, v in
                        convert_resampler(sd, name + ".").items()})
    llm_sd = {k[len("llm."):]: v for k, v in sd.items()
              if k.startswith("llm.")}
    if llm_sd:
        out["llm_state_dict"] = llm_sd
    return out


def convert_detokenizer_resampler(sd: StateDict, depth: int = 4,
                                  prefix: str = "resampler."
                                  ) -> Dict[str, Any]:
    """The detokenizer's ResamplerXL (reference:
    src/models/detokenizer/resampler.py) -> the port's ResamplerXL."""
    p = lambda k: f"{prefix}{k}"
    out: Dict[str, Any] = {"latents": sd[p("latents")]}
    out.update(_dense(sd, p("proj_in"), "proj_in"))
    out.update(_ln(sd, p("norm_out"), "norm_out"))
    out.update(_dense(sd, p("unet_proj_1"), "unet_proj_1"))
    out.update(_dense(sd, p("unet_proj_2"), "unet_proj_2"))
    for i in range(depth):
        # torch: layers.{i}.0 = PerceiverAttention, layers.{i}.1 = FeedForward
        att, ff = p(f"layers.{i}.0."), p(f"layers.{i}.1.")
        out.update(_ln(sd, att + "norm1", f"attn_{i}.norm1"))
        out.update(_ln(sd, att + "norm2", f"attn_{i}.norm2"))
        for name in ("to_q", "to_kv", "to_out"):
            out.update(_dense(sd, att + name, f"attn_{i}.{name}",
                              bias=False))
        out.update(_ln(sd, ff + "0", f"ff_{i}.norm"))
        out.update(_dense(sd, ff + "1", f"ff_{i}.fc1", bias=False))
        out.update(_dense(sd, ff + "3", f"ff_{i}.fc2", bias=False))
    ap = p("unet_attnpool.")
    out["unet_attnpool.positional_embedding"] = \
        sd[ap + "positional_embedding"]
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        out.update(_dense(sd, ap + name, f"unet_attnpool.{name}"))
    return out


def extract_qwen_vit_from_qwen_vl(sd: StateDict) -> Dict[str, Any]:
    """The visual tower of a full Qwen-VL-Chat checkpoint (reference tool
    src/tools/reload_qwen_vit.py: ``transformer.visual.*`` into
    qwen_vit_G.pt), for :func:`convert_qwen_vit`."""
    prefix = "transformer.visual."
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}

