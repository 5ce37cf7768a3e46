"""Synthetic release artifacts for the checkpoint-loading tests of the
port (tests/test_torch_weights.py, test_torch_manifests.py,
test_torch_factory.py).

No released weight is available, so an artifact is made from its release
manifest: the manifest's keys (``num_layers`` keeps the first layers),
each full-geometry width mapped to a small one by ``SHRINK`` (a width
maps to one small width everywhere in a manifest, so sums such as the
UNet's skip concatenations stay consistent, and the detokenizer's outputs
fit the UNet's context and pooled widths), values drawn from a seed
with numpy and rounded to bf16 (exact in every dtype the readers meet).
The small geometries that match are ``VIT_SMALL``, ``LLM_SMALL`` (the
agent's: LoRA r4, vit_dim 128), ``DETOK_SMALL``, ``UNET_SMALL`` and
``VAE_SMALL``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

MANIFEST_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                            "seedx_tpu_torch", "utils", "manifests")

SHRINK = {
    "qwen_vit": {1664: 64, 4992: 192, 8192: 128, 4096: 128, 12288: 384},
    "llm": {5120: 64, 13824: 128},
    "agent": {5120: 64, 13824: 128, 15360: 192, 4096: 128, 12288: 384,
              32: 4},
    "detokenizer": {1024: 32, 4096: 128, 2048: 64, 768: 24, 1280: 128},
    "sdxl_unet": {320: 32, 640: 64, 960: 96, 1280: 128, 1920: 192,
                  2048: 152, 2560: 256, 2816: 224, 5120: 512, 10240: 1024},
    "sdxl_vae": {128: 32, 256: 64, 512: 96},
}
# the geometries the shrunk artifacts have (kwargs of the configs)
VIT_SMALL = dict(width=64, heads=16, mlp_ratio=2.0, output_dim=128)
LLM_SMALL = dict(hidden_size=64, intermediate_size=128, num_heads=4,
                 num_kv_heads=4)
DETOK_SMALL = dict(dim=32, depth=4, dim_head=2, heads=16, num_queries=64,
                   embedding_dim=128, output1_dim=24, output2_dim=128,
                   ff_mult=4)
UNET_SMALL = dict(block_out_channels=(32, 64, 128), cross_attention_dim=152,
                  addition_time_embed_dim=16,
                  projection_class_embeddings_input_dim=224)
VAE_SMALL = dict(channels=(32, 64, 96, 96))

_LAYER = re.compile(r"(?:^|\.)(?:layers|resblocks)\.(\d+)\.")


def manifest(name: str) -> dict:
    with open(os.path.join(MANIFEST_DIR, name + ".json")) as f:
        return json.load(f)


def _value(key: str, shape, rng) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    n = rng.standard_normal(shape)
    if leaf == "weight" and len(shape) == 1:     # norm scales
        v = 1.0 + 0.1 * n
    elif leaf == "bias" or leaf.endswith("_bias"):
        v = 0.02 * n
    else:
        v = 0.05 * n
    # rounded to bf16: exact in fp32, fp16-close, bf16
    return torch.from_numpy(v.astype(np.float32)).bfloat16().float().numpy()


def small_state(name: str, seed: int = 0, num_layers=None,
                deltas: bool = False, shrink=None) -> dict:
    """{release key: fp32 numpy} for manifest ``name`` at the small
    geometry (``shrink``: another width map); ``deltas``: the
    detokenizer's optional UNet to_k / to_v deltas too (shaped from the
    UNet manifest)."""
    m = manifest(name)
    rng = np.random.default_rng(seed)
    shrink = shrink or SHRINK[name]
    shapes = dict(m["keys"])
    if deltas:
        unet = manifest("sdxl_unet")["keys"]
        for k in m["optional"]:
            if k.startswith("unet."):
                shapes[k] = unet[k[len("unet."):]]
    out = {}
    for key, shape in shapes.items():
        mt = _LAYER.search(key)
        if num_layers is not None and mt and int(mt.group(1)) >= num_layers \
                and name in ("qwen_vit", "llm", "agent"):
            continue
        table = SHRINK["sdxl_unet"] if key.startswith("unet.") else shrink
        out[key] = _value(key, tuple(table.get(d, d) for d in shape), rng)
    return out


def torch_state(sd: dict, dtype=torch.bfloat16) -> dict:
    return {k: torch.from_numpy(v).to(dtype) for k, v in sd.items()}


def peft_order(sd: dict) -> dict:
    """PEFT's own key order: a wrapped module's ``original_module`` copy
    before its ``modules_to_save.default`` one."""
    first = [k for k in sd if "original_module" in k]
    return {**{k: sd[k] for k in first},
            **{k: v for k, v in sd.items() if k not in first}}


def write_safetensors_dir(path: str, sd: dict, shards: int = 2) -> None:
    """An HF shard directory: ``model-0000i-of-0000n.safetensors`` and
    ``model.safetensors.index.json``."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    keys = list(sd)
    weight_map = {}
    for i in range(shards):
        part = keys[i::shards]
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({k: sd[k].contiguous() for k in part},
                  os.path.join(path, fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
