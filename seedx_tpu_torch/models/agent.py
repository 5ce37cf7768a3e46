"""ContinuousLVLM, the SEED-X agent: its generation-facing parts
(reference: seedx_tpu/models/agent.py; src/models/mllm/seed_x.py).

Input images are resampled into the LLM embedding stream at the
``ids_cmp_mask`` positions; generated image spans are decoded from the
LLM hidden states by the output resampler.  The training losses are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from seedx_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from seedx_tpu_torch.models.resampler import Resampler


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Agent hyperparameters (configs/clm_models/agent_seed_x.yaml)."""

    llm: LlamaConfig
    num_img_in_tokens: int = 64
    num_img_out_tokens: int = 64
    vit_dim: int = 4096
    resampler_heads: int = 32
    add_patch_pos: bool = True
    vit_down: bool = True
    dtype: torch.dtype = torch.bfloat16


def _compact_rows(rows: torch.Tensor, slot_mask: torch.Tensor) -> torch.Tensor:
    """Rows of valid slots packed to the front in order, zeros after:
    [N, T, D] -> [N, T, D] (``rows[slot_mask]`` at a fixed shape)."""
    out = torch.zeros_like(rows)
    kept = rows[slot_mask]
    out[:kept.shape[0]] = kept
    return out


def _scatter_to_positions(base: torch.Tensor, token_mask: torch.Tensor,
                          compact_rows: torch.Tensor) -> torch.Tensor:
    """Place ``compact_rows`` [M, D] at the True positions of
    ``token_mask`` [B, S] (row-major order) inside ``base`` [B, S, D]."""
    b, s, d = base.shape
    flat_mask = token_mask.reshape(-1)
    rank = torch.cumsum(flat_mask.to(torch.int64), dim=0) - 1
    picked = compact_rows[torch.clamp(rank, 0, compact_rows.shape[0] - 1)]
    out = torch.where(flat_mask[:, None], picked.to(base.dtype),
                      base.reshape(-1, d))
    return out.reshape(b, s, d)


def _gather_from_positions(hidden: torch.Tensor, token_mask: torch.Tensor,
                           num_slots: int, tokens_per_slot: int
                           ) -> torch.Tensor:
    """Inverse of ``_scatter_to_positions``: hidden rows at the True
    positions -> [num_slots, tokens_per_slot, D]; extra positions drop."""
    d = hidden.shape[-1]
    rows = hidden.reshape(-1, d)[token_mask.reshape(-1)]
    n = num_slots * tokens_per_slot
    out = torch.zeros((n, d), dtype=hidden.dtype, device=hidden.device)
    out[:min(n, rows.shape[0])] = rows[:n]
    return out.reshape(num_slots, tokens_per_slot, d)


class ContinuousLVLM(nn.Module):
    def __init__(self, cfg: AgentConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.llm.hidden_size
        self.llm = LlamaForCausalLM(cfg.llm, device)
        self.input_resampler = Resampler(
            grid_size=int(cfg.num_img_in_tokens ** 0.5), embed_dim=hidden,
            num_heads=cfg.resampler_heads, kv_dim=cfg.vit_dim,
            dtype=cfg.dtype, device=device)
        self.output_resampler = Resampler(
            grid_size=int(cfg.num_img_out_tokens ** 0.5),
            embed_dim=cfg.vit_dim, num_heads=cfg.resampler_heads,
            kv_dim=hidden, dtype=cfg.dtype, device=device)
        if cfg.add_patch_pos:
            self.register_buffer("patch_pos_embed", torch.zeros(
                (4, hidden), dtype=cfg.dtype, device=device))

    def _embed_images(self, image_embeds: torch.Tensor,
                      patch_positions: Optional[torch.Tensor]) -> torch.Tensor:
        """ViT features [N, T, vit_dim] -> LLM tokens [N, n_in, hidden]."""
        x = self.input_resampler(image_embeds)
        if self.cfg.add_patch_pos and patch_positions is not None:
            coords = torch.cat([patch_positions, 1.0 - patch_positions],
                               dim=-1) / 2.0
            rel = coords.to(x.dtype) @ self.patch_pos_embed.to(x.dtype)
            x = x + rel[:, None, :]
        return x

    def embed_with_images(self, input_ids, image_embeds=None,
                          ids_cmp_mask=None, embeds_cmp_mask=None,
                          patch_positions=None) -> torch.Tensor:
        """Token embeddings with resampled image embeddings spliced in at
        the ``ids_cmp_mask`` positions (reference: seed_x.py:158-173)."""
        input_embeds = self.llm.embed(input_ids)
        if image_embeds is not None:
            img_lm = self._embed_images(image_embeds, patch_positions)
            if embeds_cmp_mask is not None:
                img_lm = _compact_rows(img_lm, embeds_cmp_mask)
            input_embeds = _scatter_to_positions(
                input_embeds, ids_cmp_mask,
                img_lm.reshape(-1, self.cfg.llm.hidden_size))
        return input_embeds

    def embed_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.llm.embed(input_ids)

    def llm_step(self, inputs_embeds, positions, kv_valid=None, cache=None,
                 cache_index: int = 0):
        """One LLM forward (prefill or decode): (logits, hidden, cache)."""
        return self.llm(inputs_embeds, positions, kv_valid, cache,
                        cache_index)

    def decode_image_feats(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """Output resampler over generated spans [num_imgs, n_out, hidden]
        -> [num_imgs, n, vit_dim] (reference: seed_x.py:204-210)."""
        return self.output_resampler(hidden_states)
