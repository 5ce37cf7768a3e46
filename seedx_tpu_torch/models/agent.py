"""ContinuousLVLM, the SEED-X agent (reference: seedx_tpu/models/agent.py;
src/models/mllm/seed_x.py).

Input images are resampled into the LLM embedding stream at the
``ids_cmp_mask`` positions; generated image spans are decoded from the
LLM hidden states by the output resampler.  ``forward`` is the SFT loss:
the causal LM loss plus the reconstruction MSE of the generated spans'
output-resampler features against the (4x-pooled) ViT features, total =
``lm_loss_scale * lm + rec_loss_scale * rec``.  The splice helpers write
into no tensor that autograd needs, so every trainable leaf gets its
gradient through them.  ``graphs`` is the switch of the agent's captured
decode programs (``utils/graphs.py``; a runtime puts its own here), which
``generation.decode_programs`` keeps with their buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from seedx_tpu_torch.models.layers import leaf
from seedx_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          causal_lm_loss)
from seedx_tpu_torch.models.resampler import Resampler
from seedx_tpu_torch.models.vit import vit_downsample
from seedx_tpu_torch.utils.graphs import Graphs


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Agent hyperparameters (configs/clm_models/agent_seed_x.yaml)."""

    llm: LlamaConfig
    num_img_in_tokens: int = 64
    num_img_out_tokens: int = 64
    vit_dim: int = 4096
    resampler_heads: int = 32
    lm_loss_scale: float = 1.0
    rec_loss_scale: float = 6.0
    add_patch_pos: bool = True
    vit_down: bool = True
    dtype: torch.dtype = torch.bfloat16


def _compact_rows(rows: torch.Tensor, slot_mask: torch.Tensor) -> torch.Tensor:
    """Rows of valid slots packed to the front in order, zeros after:
    [N, T, D] -> [N, T, D] (``rows[slot_mask]`` at a fixed shape)."""
    kept = rows[slot_mask]
    pad = rows.new_zeros((rows.shape[0] - kept.shape[0],) + rows.shape[1:])
    return torch.cat([kept, pad])


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
    rows = rows[:n]
    pad = hidden.new_zeros((n - rows.shape[0], d))
    return torch.cat([rows, pad]).reshape(num_slots, tokens_per_slot, d)


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
        self.graphs = Graphs()

    def _embed_images(self, image_embeds: torch.Tensor,
                      patch_positions: Optional[torch.Tensor]) -> torch.Tensor:
        """ViT features [N, T, vit_dim] -> LLM tokens [N, n_in, hidden]."""
        x = self.input_resampler(image_embeds)
        if self.cfg.add_patch_pos and patch_positions is not None:
            coords = torch.cat([patch_positions, 1.0 - patch_positions],
                               dim=-1) / 2.0
            rel = coords.to(x.dtype) @ leaf(self, "patch_pos_embed").to(
                x.dtype)
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
                 cache_index=0, block_tables=None, write_widths=None,
                 tok_row=None, tok_slot=None, packed_window=0,
                 write_mask=None, last=None):
        """One LLM forward (prefill, decode or the fused step): (logits,
        hidden, cache).  ``cache_index`` may be a [B] tensor of per-row
        positions, ``block_tables`` a paged pool's tables,
        ``write_widths`` / ``tok_row`` / ``tok_slot`` / ``packed_window``
        select the continuous engine's fused step and ``write_mask`` masks
        a one-token step's cache writes and ``last`` keeps one position a
        row (see LlamaForCausalLM; reference agent.py:160-170)."""
        return self.llm(inputs_embeds, positions, kv_valid, cache,
                        cache_index, block_tables, write_widths, tok_row,
                        tok_slot, packed_window, write_mask, last)

    def decode_image_feats(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """Output resampler over generated spans [num_imgs, n_out, hidden]
        -> [num_imgs, n, vit_dim] (reference: seed_x.py:204-210)."""
        return self.output_resampler(hidden_states)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                labels: torch.Tensor, image_embeds: Optional[torch.Tensor],
                embeds_gen_mask: Optional[torch.Tensor],
                embeds_cmp_mask: Optional[torch.Tensor],
                ids_gen_mask: torch.Tensor, ids_cmp_mask: torch.Tensor,
                patch_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The SFT losses (reference agent.py:191-242): ``input_ids``,
        ``attention_mask`` (right-padded), ``labels``, ``ids_gen_mask`` and
        ``ids_cmp_mask`` [B, S]; ``image_embeds`` [N, T, vit_dim] with
        ``embeds_gen_mask`` / ``embeds_cmp_mask`` [N] and
        ``patch_positions`` [N, 2], or None.  ``generator`` turns on LoRA
        dropout.  Returns fp32 ``total_loss``, ``lm_loss``, ``rec_loss``."""
        cfg = self.cfg
        input_embeds = self.embed_with_images(
            input_ids, image_embeds, ids_cmp_mask, embeds_cmp_mask,
            patch_positions)
        logits, hidden = self.llm.forward_train(
            input_embeds, positions_from_mask(attention_mask),
            attention_mask.to(torch.bool), generator)
        # on a mesh both losses are means over the global batch
        par = self.llm.lm_head.__dict__.get("_par")
        lm_loss = causal_lm_loss(logits, labels, par)
        rec_loss = torch.zeros((), dtype=torch.float32,
                               device=lm_loss.device)
        if image_embeds is not None:
            # generation regression (reference seed_x.py:100-117)
            target = image_embeds
            if cfg.vit_down:
                target = vit_downsample(target)
            if target.shape[1] != cfg.num_img_out_tokens:
                raise ValueError(
                    f"reconstruction target has {target.shape[1]} tokens but "
                    f"num_img_out_tokens={cfg.num_img_out_tokens}; with "
                    f"vit_down the ViT must emit 4*num_img_out_tokens tokens")
            n_slots = image_embeds.shape[0]
            target = _compact_rows(target, embeds_gen_mask).detach()
            gen_hidden = _gather_from_positions(
                hidden, ids_gen_mask, n_slots, cfg.num_img_out_tokens)
            recon = self.output_resampler(gen_hidden)
            num_gen = embeds_gen_mask.to(torch.int64).sum()
            slot_valid = (torch.arange(n_slots, device=num_gen.device)
                          < num_gen)[:, None, None]
            sq = (recon.float() - target.float()) ** 2
            if par is not None:
                num_gen = par.batch_sum(num_gen.clone())
            denom = (torch.clamp(num_gen, min=1) * target.shape[1]
                     * target.shape[2])
            rec_loss = torch.where(slot_valid, sq, 0.0).sum() / denom
        total = cfg.lm_loss_scale * lm_loss + cfg.rec_loss_scale * rec_loss
        return {"total_loss": total, "lm_loss": lm_loss, "rec_loss": rec_loss}


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Position ids from a (left- or right-) padded attention mask
    (reference agent.py:245-248)."""
    mask = attention_mask.to(torch.int64)
    return torch.clamp(torch.cumsum(mask, dim=-1) - 1, min=0)
