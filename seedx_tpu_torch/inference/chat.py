"""Multi-turn interleaved chat with a KV prefix cache (reference:
seedx_tpu/inference/chat.py).

The reference ships only single-turn eval scripts; its chat format is the
training one: ``[INST] ... [/INST]\\n`` turns joined by ``\\n`` with image
spans spliced into user turns (reference: src/data/sft_clm.py:230-272).
``ChatSession`` keeps that history, re-serializes it each turn, and feeds
every referenced image's ViT features through the comprehension splice.
An image the model generates joins the context as ViT-space features, and
the runtime's SDXL adapter turns it into pixels for the reply's ``images``
(None without an adapter or an image span).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from seedx_tpu_torch.models.generation import (DecodeState,
                                               GenerationConfig,
                                               _trim_and_spans, build_result,
                                               generate_tokens_cached,
                                               spec_width)
from seedx_tpu_torch.models.llama import init_kv_cache
from seedx_tpu_torch.text import prompts

SEG_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass
class Turn:
    role: str                    # "user" | "assistant"
    text: str
    num_patches: int = 0         # image spans carried by this turn


class ChatSession:
    """Stateful multi-turn conversation over a ``SeedXRuntime``.

    With ``prefix_cache=True`` (default) the session keeps one KV cache at
    absolute token positions across turns: each ``send`` re-serializes the
    history, finds the longest common token prefix (LCP) with what the
    cache holds (the last prompt and its reply) and prefills only the new
    suffix.  Reuse stops where the cached KV's embedding kind differs from
    what a position needs now (a generated image span was written from
    token embeddings, but the next turn splices the image's features in),
    never splits an image span, and always leaves at least one token to
    prefill; so replies equal those of a full prefill, which
    ``prefix_cache=False`` runs every turn.  The session keeps its decode
    state with its cache (``generation.DecodeState``, its step captured
    while the runtime's graphs are on), so both go with the session."""

    def __init__(self, rt, system_message: str = "",
                 prefix_cache: bool = True, cache_capacity: int = 2048):
        self.rt = rt
        self.system_message = system_message
        self.turns: List[Turn] = []
        self._image_embeds: List[torch.Tensor] = []   # [n_tiles, T, D] each
        self._patch_positions: List[torch.Tensor] = []
        self.prefix_cache = prefix_cache
        self.cache_capacity = cache_capacity
        self._cache = None
        self._decode: Optional[DecodeState] = None   # over self._cache
        self._cached_ids: List[int] = []   # ids whose KV fills cache[0:len)
        # was each cached position's KV computed with image features
        # spliced in (True) or from token-id embeddings (False)?
        self._cached_cmp: List[bool] = []
        self.last_reused = 0               # LCP length of the last send
        self.last_prefill_tokens = 0       # tokens the last send prefilled

    # ------------------------------------------------------------------

    def _add_image(self, image) -> int:
        """Anyres-encode an image; returns its tile count."""
        embeds, ppos = self.rt.encode_image_anyres(image)
        self._image_embeds.append(embeds)
        self._patch_positions.append(ppos.float())
        return embeds.shape[0]

    def _add_generated(self, img_gen_feat: torch.Tensor) -> int:
        """Register a generated image's features [1, n, D] as a 1-tile
        context image.  The output resampler emits 64 ViT-space tokens (an
        8x8 grid); context images carry the ViT's 256 (16x16): upsample
        bilinearly on the 2-D grid (``jax.image.resize``'s "bilinear" is
        half-pixel, i.e. ``align_corners=False``)."""
        n, d = img_gen_feat.shape[1], img_gen_feat.shape[2]
        vit_tokens = self.rt.vit_cfg.n_queries
        if n != vit_tokens:
            g_src, g_tgt = int(n ** 0.5), int(vit_tokens ** 0.5)
            grid = img_gen_feat.reshape(1, g_src, g_src, d).permute(
                0, 3, 1, 2).float()
            grid = F.interpolate(grid, size=(g_tgt, g_tgt), mode="bilinear",
                                 align_corners=False)
            img_gen_feat = grid.permute(0, 2, 3, 1).reshape(
                1, vit_tokens, d).to(img_gen_feat.dtype)
        self._image_embeds.append(img_gen_feat)
        self._patch_positions.append(torch.full(
            (1, 2), 0.5, dtype=torch.float32, device=img_gen_feat.device))
        return 1

    def _build_prompt(self) -> str:
        parts = []
        if self.system_message:
            msg = self.system_message
            parts.append(msg if msg.endswith("\n") else msg + "\n")
        first_user = True
        for turn in self.turns:
            spans = prompts.multi_patch_image_string(
                turn.num_patches, self.rt.agent_cfg.num_img_in_tokens) \
                if turn.num_patches else ""
            if turn.role == "user":
                text = prompts.INSTRUCTION_PROMPT.format(
                    instruction=spans + turn.text)
                if not first_user:
                    text = "\n" + text
                first_user = False
            else:
                text = spans + turn.text
            parts.append(text)
        return "".join(parts)

    # ------------------------------------------------------------------

    def _generate_cached(self, input_ids, cmp_mask, image_embeds, ppos,
                         max_new_tokens: int, spec_k: int = 0,
                         timings: Optional[Dict[str, float]] = None):
        """Delta-prefill generation against the session KV cache."""
        rt = self.rt
        vocab = rt.tokenizer.vocab
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            num_img_gen_tokens=rt.agent_cfg.num_img_out_tokens,
            eos_token_id=rt.tokenizer.eos_token_id,
            pad_token_id=rt.tokenizer.pad_token_id, spec_k=spec_k)
        full_mask = (np.asarray(cmp_mask, bool) if cmp_mask is not None
                     else np.zeros((len(input_ids),), bool))
        n_in = rt.agent_cfg.num_img_in_tokens

        def seg_bucket(n):
            return next((x for x in SEG_BUCKETS if x >= n), n)

        lcp = 0
        for i, (a, b) in enumerate(zip(self._cached_ids, input_ids)):
            # stop at an id mismatch or where the cached KV's embedding kind
            # differs from what this position needs now
            if a != b or self._cached_cmp[i] != bool(full_mask[i]):
                break
            lcp += 1
        lcp = min(lcp, len(input_ids) - 1)   # always prefill >= 1 token
        if int(full_mask[:lcp].sum()) % n_in:
            lcp = 0                          # never split an image span

        # the cache must hold the decode AND the bucket-padded prefill
        # written at offset lcp (a write past its end would fail); a
        # verify forward writes spec_k rows past the last token
        need = max(len(input_ids) + max_new_tokens + spec_k,
                   lcp + seg_bucket(len(input_ids) - lcp))
        if self._cache is None or self._cache[0].shape[2] < need:
            lcp = 0                          # a fresh cache: full prefill
            need = max(len(input_ids) + max_new_tokens + spec_k,
                       seg_bucket(len(input_ids)))
            cap = (max(self.cache_capacity, need) + 127) // 128 * 128
            self._cache = init_kv_cache(rt.agent_cfg.llm, 1, cap,
                                        device=rt.device,
                                        kv_heads=rt.agent.llm.kv_heads)
            self._cached_ids = []
            self._cached_cmp = []
        self.last_reused = lcp

        delta = input_ids[lcp:]
        delta_mask = full_mask[lcp:]
        prefix_spans = int(full_mask[:lcp].sum()) // n_in
        img_delta = ecm = ppos_delta = None
        if image_embeds is not None and int(delta_mask.sum()):
            img_delta = image_embeds[prefix_spans:]
            ecm = torch.ones((img_delta.shape[0],), dtype=torch.bool,
                             device=rt.device)
            ppos_delta = ppos[prefix_spans:] if ppos is not None else None

        sb = seg_bucket(len(delta))
        ids_padded = np.full((1, sb), gen_cfg.pad_token_id, np.int64)
        ids_padded[0, :len(delta)] = np.asarray(delta, np.int64)
        dm = np.zeros((1, sb), bool)
        dm[0, :len(delta)] = delta_mask
        with torch.no_grad():
            seg_embeds = rt.agent.embed_with_images(
                torch.as_tensor(ids_padded, device=rt.device), img_delta,
                torch.as_tensor(dm, device=rt.device)
                if img_delta is not None else None, ecm, ppos_delta)
        hist_ids = None
        cap = self._cache[0].shape[2]
        if spec_k:
            # the ids at absolute cache positions: multi-turn history is
            # the prime n-gram workload
            hist_ids = torch.full((cap,), -1, dtype=torch.int64,
                                  device=rt.device)
            hist_ids[:len(input_ids)] = torch.as_tensor(input_ids)
        # a session keeps one decode state, made anew (and captured anew)
        # for another generation config
        if (self._decode is None or self._decode.cache is not self._cache
                or self._decode.gen_cfg != gen_cfg):
            self._decode = DecodeState(rt.agent, self._cache, 1, gen_cfg,
                                       vocab, rt.agent.graphs,
                                       spec_k=spec_width(gen_cfg, 1, True),
                                       hist_len=cap)
        out, self._cache, _ = generate_tokens_cached(
            rt.agent, self._cache, seg_embeds, lcp, len(delta),
            int(input_ids[-1]), gen_cfg, vocab, timings=timings,
            decode=self._decode, hist_ids=hist_ids)
        self.last_prefill_tokens = len(delta)

        tokens = out["tokens"][0].cpu().numpy()
        gen_tokens, eoi_indices = _trim_and_spans(tokens, gen_cfg, vocab)
        self._cached_ids = list(input_ids) + [int(x) for x in gen_tokens]
        # prompt positions were embedded per full_mask; every position
        # decode produced (forced image spans included) from token ids
        self._cached_cmp = ([bool(x) for x in full_mask]
                            + [False] * len(gen_tokens))

        n_img = gen_cfg.num_img_gen_tokens
        img_gen_feat = None
        if eoi_indices:
            spans = torch.stack([out["hidden"][0][j - n_img:j]
                                 for j in eoi_indices])
            with torch.no_grad():
                img_gen_feat = rt.agent.decode_image_feats(spans)
        return build_result(gen_tokens, eoi_indices, img_gen_feat,
                            rt.tokenizer, vocab, n_img)

    def send(self, text: str, image=None, max_new_tokens: int = 512,
             num_inference_steps: int = 30, seed: int = 42, spec_k: int = 0,
             timings: Optional[Dict[str, float]] = None):
        """One user turn -> the assistant's reply {text, images,
        num_gen_imgs, tokens}; ``images`` [n, H, W, 3] in [0, 1] when the
        reply holds image spans and the runtime has an adapter
        (``num_inference_steps`` and ``seed`` go to its ``generate``).
        ``spec_k`` > 0 decodes the reply with exact n-gram speculative
        decoding (greedy; ``models/generation.py``): multi-turn history is
        the prime prompt-lookup workload.  ``timings`` receives the
        prefill / decode host seconds of the turn (see
        ``generate_tokens``) and the adapter's phases."""
        n_patches = self._add_image(image) if image is not None else 0
        self.turns.append(Turn("user", text, n_patches))

        tok = self.rt.tokenizer
        input_ids = [tok.bos_token_id] + tok.encode(self._build_prompt())
        cmp_mask = prompts.cmp_mask_from_ids(input_ids)

        image_embeds = embeds_cmp = ppos = None
        if self._image_embeds:
            image_embeds = torch.cat(self._image_embeds)
            embeds_cmp = np.ones((image_embeds.shape[0],), bool)
            ppos = torch.cat(self._patch_positions)
            if int(cmp_mask.sum()) != image_embeds.shape[0] * \
                    self.rt.agent_cfg.num_img_in_tokens:
                raise RuntimeError("history image spans out of sync with "
                                   "the stored features")

        if self.prefix_cache:
            out = self._generate_cached(input_ids, cmp_mask, image_embeds,
                                        ppos, max_new_tokens, spec_k=spec_k,
                                        timings=timings)
        else:
            out = self.rt.generate(input_ids, image_embeds=image_embeds,
                                   embeds_cmp_mask=embeds_cmp,
                                   ids_cmp_mask=cmp_mask,
                                   patch_positions=ppos,
                                   max_new_tokens=max_new_tokens,
                                   spec_k=spec_k, timings=timings)
            self.last_prefill_tokens = len(input_ids)

        images = None
        reply_patches = 0
        if out["has_img_output"]:
            if self.rt.adapter is not None:
                images = self.rt.adapter.generate(
                    out["img_gen_feat"], seed=seed,
                    num_inference_steps=num_inference_steps,
                    timings=timings)
            # the generated image joins the context for later turns: the
            # output resampler emits ViT-space features (seed_x.py:109-111)
            for i in range(out["num_gen_imgs"]):
                reply_patches += self._add_generated(
                    out["img_gen_feat"][i:i + 1])

        reply = prompts.strip_markup(out["text"])
        self.turns.append(Turn("assistant", reply, reply_patches))
        return {"text": reply, "images": images,
                "num_gen_imgs": out["num_gen_imgs"],
                "tokens": out["tokens"]}
