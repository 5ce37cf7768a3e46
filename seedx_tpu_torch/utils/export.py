"""Serving artifacts (reference: seedx_tpu/utils/export.py).

``merge_lora`` folds trained LoRA factors into their base kernels,
``W' = W + (alpha / r) A @ B`` (flat [in, out] or stacked [L, in, out]),
and drops the factors, so the agent serves through the plain dense path
of a ``lora_rank=0`` config (and through the quantizer after it);
``export_merged`` writes the merged state once; ``export_serving``
quantizes a model family's state once and writes it, so a server's cold
start reads the quantized bytes instead of converting and quantizing the
release checkpoints at every launch.  Both write ``torch.save`` state
dicts (``train/checkpoints.save_pytree``); ``restore_pytree`` reads them
back, into the matching quantized module bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from seedx_tpu_torch.train.checkpoints import save_pytree
from seedx_tpu_torch.utils import quantize as qz


def merge_lora(state: Mapping[str, torch.Tensor],
               alpha: float = 32.0) -> Dict[str, torch.Tensor]:
    """A state dict with every ``*.kernel`` that has ``*.lora_a`` /
    ``*.lora_b`` siblings merged (in fp32, stored back in the kernel's
    dtype) and the factors removed."""
    out = {}
    for key, value in state.items():
        if key.endswith((".lora_a", ".lora_b")):
            continue
        base = key[:-len(".kernel")] if key.endswith(".kernel") else None
        a = state.get(f"{base}.lora_a") if base is not None else None
        b = state.get(f"{base}.lora_b") if base is not None else None
        if a is not None and b is not None:
            delta = torch.einsum("...ir,...ro->...io", a.float(),
                                 b.float()) * (alpha / a.shape[-1])
            value = (value.float() + delta).to(value.dtype)
        out[key] = value
    return out


def export_merged(state_trainable: Mapping[str, torch.Tensor],
                  frozen: Mapping[str, torch.Tensor], path: str,
                  lora_alpha: float = 32.0) -> Dict[str, torch.Tensor]:
    """The trainable leaves over the frozen ones, LoRA folded in, written
    to ``path`` as one state dict; returns it."""
    merged = merge_lora({**frozen, **state_trainable}, alpha=lora_alpha)
    save_pytree(path, merged)
    return merged


def export_serving(params: Mapping[str, torch.Tensor], path: str,
                   family: str, mode: Optional[str] = None
                   ) -> Dict[str, torch.Tensor]:
    """Quantize once, deploy many: write a family's serving state (the
    quantized codes and scales) to ``path`` and return it.  family
    "llama" (a LlamaForCausalLM state; mode "int8" | "int8_full" | "int4",
    default int4), "vit" (int8) or "unet" (int8); already-quantized
    leaves pass through.  Restore with ``train.checkpoints.restore_pytree``
    into ``LlamaConfig(quantization=mode)``, ``ViTConfig(quantization=
    "int8")`` or ``UNetConfig(quantize="int8")``: the round trip is bit
    for bit."""
    if family == "llama":
        qstate = qz.quantize_llama_params(dict(params), mode=mode or "int4")
    elif family == "vit":
        qstate = qz.quantize_vit_params(dict(params))
    elif family == "unet":
        qstate = qz.quantize_unet_params(dict(params))
    else:
        raise ValueError(
            f"unknown family {family!r}; one of ['llama', 'unet', 'vit']")
    save_pytree(path, qstate)
    return qstate
