"""LoRA merge for serving (reference: seedx_tpu/utils/export.py
``merge_lora``).

``merge_lora`` folds trained LoRA factors into their base kernels,
``W' = W + (alpha / r) A @ B`` (flat [in, out] or stacked [L, in, out]),
and drops the factors, so the agent serves through the plain dense path
of a ``lora_rank=0`` config (and through the quantizer after it).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


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
