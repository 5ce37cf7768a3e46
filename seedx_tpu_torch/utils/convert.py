"""JAX parameter trees -> the port's state dicts.

The port keeps the JAX layouts (``[in, out]`` kernels, stacked ``[L, ...]``
layer weights, the same leaf names), so conversion is a flatten plus two
renames that drop the flax scan wrappers of the LLaMA trunk.  Works for
the ViT tree, the agent tree and the quantized agent tree (int8 / int4
leaves keep their names and bytes), and for the SDXL trees (UNet, int8
UNet, VAE encoder and decoder, ``ResamplerXL``): their conv modules hold a
torch-layout ``weight`` / ``weight_q`` [out, in, kh, kw] where the JAX
tree has ``kernel`` / ``kernel_q`` [kh, kw, in, out], and
``load_jax_params`` transposes those.  Input: a nested mapping of numpy
arrays (unboxed flax params).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_RENAMES = ((".model.layers.layer.", ".layers."), (".model.norm.", ".norm."))


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested numpy tree -> {port state name: array}; bf16 leaves widen to
    fp32 (numpy has no bf16; the module's buffer dtype decides storage)."""
    state = {}
    for key, v in _flatten(tree).items():
        key = "." + key
        for old, new in _RENAMES:
            key = key.replace(old, new)
        key = key[1:]
        arr = np.asarray(v)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        state[key] = arr
    return state


def load_jax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a converted JAX tree into ``module`` (strict: every buffer must
    be present and every leaf used); values cast to each buffer's dtype
    and written in its memory format."""
    targets = module.state_dict()
    state = {}
    for k, v in from_jax_params(tree).items():
        t = torch.from_numpy(np.array(v))
        base, _, leaf = k.rpartition(".")
        conv = {"kernel": "weight", "kernel_q": "weight_q"}.get(leaf)
        if k not in targets and conv and f"{base}.{conv}" in targets:
            # a conv kernel: JAX [kh, kw, in, out] -> torch [out, in, kh, kw]
            k, t = f"{base}.{conv}", t.permute(3, 2, 0, 1)
        state[k] = t
    module.load_state_dict(state, strict=True)
    return module
