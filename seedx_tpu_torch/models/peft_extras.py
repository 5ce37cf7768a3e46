"""PEFT tuners beyond LoRA (reference: seedx_tpu/models/peft_extras.py).

The reference vendors a patched PEFT fork (proj/peft/src/peft/tuners/)
whose SEED-X configs only ever use LoRA (configs/clm_models/
llm_seed_x_lora.yaml:6-25).  For fork parity the port carries the two
tuners the JAX package carries:

  * IA3 (reference ia3.py): ones-init elementwise rescaling vectors on
    the k_proj / v_proj outputs and the down_proj input, built into
    ``models.layers.LoRADense(ia3=...)`` and switched on with
    ``LlamaConfig(ia3=True)``; train with ``IA3_TRAINABLE_PATTERNS``.
  * Prompt tuning (reference prompt_tuning.py): learned virtual-token
    embeddings prepended to the input embedding stream: ``SoftPrompt``
    plus ``apply_soft_prompt``, which also extends the attention mask and
    the labels.  It uses the LLaMA's embeddings-in contract, so the
    backbone does not change.

Deliberately not carried (the JAX package's documented descope,
PARITY.md section 2b row 12): AdaLoRA (adalora.py, an SVD-parameterised
training-schedule feature with rank reallocation; no SEED-X flow uses it)
and prefix / p-tuning (prefix_tuning.py, learned per-layer past KV, which
would thread a second KV stream through the cache machinery for a tuner
nothing uses).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class SoftPrompt(nn.Module):
    """Learned virtual-token embeddings (prompt tuning): an ``embedding``
    parameter [n, hidden], fp32, normal(0, 0.02) drawn from ``generator``;
    ``forward(batch)`` broadcasts it over the batch (the fork's
    nn.Embedding over ``num_virtual_tokens`` ids, always selected in
    order)."""

    def __init__(self, num_virtual_tokens: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        emb = torch.empty((num_virtual_tokens, hidden_size),
                          dtype=torch.float32, device=device)
        emb.normal_(0.0, 0.02, generator=generator)
        self.embedding = nn.Parameter(emb)

    def forward(self, batch: int) -> torch.Tensor:
        return self.embedding[None].expand(batch, *self.embedding.shape)


def apply_soft_prompt(prompt_embeds: torch.Tensor,
                      inputs_embeds: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      labels: Optional[torch.Tensor] = None,
                      ignore_index: int = -100
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Prepend soft-prompt embeddings to an embedding stream (the fork's
    PeftModelForCausalLM.forward prompt-tuning path): virtual tokens are
    attended positions (mask True) that never enter the LM loss (labels
    ``ignore_index``).  Returns (embeds, mask, labels), [B, n + S, ...]."""
    b, n = inputs_embeds.shape[0], prompt_embeds.shape[1]
    embeds = torch.cat([prompt_embeds.to(inputs_embeds.dtype),
                        inputs_embeds], dim=1)
    mask_out = None
    if attention_mask is not None:
        mask_out = torch.cat([torch.ones((b, n), dtype=attention_mask.dtype,
                                         device=attention_mask.device),
                              attention_mask], dim=1)
    labels_out = None
    if labels is not None:
        labels_out = torch.cat([torch.full((b, n), ignore_index,
                                           dtype=labels.dtype,
                                           device=labels.device),
                                labels], dim=1)
    return embeds, mask_out, labels_out


# trainable-pattern presets for train.partition.path_labels
IA3_TRAINABLE_PATTERNS: Tuple[str, ...] = (r".*ia3_scale$",)
PROMPT_TRAINABLE_PATTERNS: Tuple[str, ...] = (r".*soft_prompt.*",)
