"""Bucket-batched serving engine (reference:
seedx_tpu/inference/serving.py).

The reference serves one prompt at a time through the HF ``generate``
loop (src/inference/eval_img2text_seed_x_i.py, a bare for-loop).  Decode
streams the same int4 weights at batch 1 and batch 8, so batching
multiplies tokens per second until the matmuls stop being bound by
memory.  The engine queues heterogeneous requests (comprehension, t2i,
edit, raw), groups them by prompt-length bucket, runs one prefill + decode
loop (``generate_batch``) per chunk of ``max_batch_size`` requests of a
bucket, then turns every image span of the chunk into pixels with one
batched SDXL run per kind (t2i-like spans, edit spans with their source
images as the condition), and returns results in submission order.
Without an adapter a request's ``images`` is None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seedx_tpu_torch.inference.apps import (_prepare_image_prompt,
                                            condition_input)
from seedx_tpu_torch.inference.runtime import SeedXRuntime
from seedx_tpu_torch.models.generation import (GenerationConfig,
                                               decode_programs,
                                               generate_batch)
from seedx_tpu_torch.text import prompts


@dataclasses.dataclass
class _Pending:
    idx: int                      # submission order
    request: Dict[str, Any]      # generate_batch schema
    kind: str                    # "comprehend" | "t2i" | "edit" | "raw"
    image: Any = None            # source PIL image (edit condition)


class ServingEngine:
    """In-process micro-batching server over a SeedXRuntime."""

    def __init__(self, rt: SeedXRuntime, max_batch_size: int = 8,
                 max_new_tokens: int = 512, num_inference_steps: int = 50,
                 seed: int = 42,
                 image_guidance_scale: Optional[float] = None):
        """``image_guidance_scale`` of edit requests: None takes the
        adapter config's (1.5, the reference's); exactly 1.0 selects the
        2-branch CFG of ``denoise_edit``."""
        self.rt = rt
        self.max_batch_size = max_batch_size
        self.max_new_tokens = max_new_tokens
        self.num_inference_steps = num_inference_steps
        self.seed = seed
        self.image_guidance_scale = image_guidance_scale
        self._pending: List[_Pending] = []
        self._count = 0

    # ---- submission --------------------------------------------------------

    def _push(self, request: Dict[str, Any], kind: str, image=None) -> int:
        idx = self._count
        self._count += 1
        self._pending.append(_Pending(idx, request, kind, image))
        return idx

    def submit_comprehend(self, image, question: str,
                          prompt_style: str = "instruct") -> int:
        ids, cmp_mask, embeds, ecm, ppos = _prepare_image_prompt(
            self.rt, image, question, prompt_style)
        return self._push({"input_ids": ids, "image_embeds": embeds,
                           "embeds_cmp_mask": ecm, "ids_cmp_mask": cmp_mask,
                           "patch_positions": ppos}, "comprehend")

    def submit_text_to_image(self, caption: str) -> int:
        text = prompts.generation_prompt(caption)
        ids = [self.rt.tokenizer.bos_token_id] + self.rt.tokenizer.encode(text)
        return self._push({"input_ids": ids}, "t2i")

    def submit_edit(self, image, instruction: str) -> int:
        """The edit prompt (image + instruction); the image is kept as the
        condition of the request's generated images."""
        ids, cmp_mask, embeds, ecm, ppos = _prepare_image_prompt(
            self.rt, image, instruction)
        return self._push({"input_ids": ids, "image_embeds": embeds,
                           "embeds_cmp_mask": ecm, "ids_cmp_mask": cmp_mask,
                           "patch_positions": ppos}, "edit", image=image)

    def submit_raw(self, request: Dict[str, Any]) -> int:
        """A pre-built generate_batch request dict."""
        return self._push(request, "raw")

    # ---- execution ---------------------------------------------------------

    def _gen_cfg(self) -> GenerationConfig:
        return GenerationConfig(
            max_new_tokens=self.max_new_tokens,
            num_img_gen_tokens=self.rt.agent_cfg.num_img_out_tokens,
            eos_token_id=self.rt.tokenizer.eos_token_id,
            pad_token_id=self.rt.tokenizer.pad_token_id)

    def warmup(self) -> "ServingEngine":
        """Build the flush's decode programs ahead of serving: the agent's
        decode KV storage sized for a full batch at the largest prompt
        bucket, and the captured decode step of a single request at every
        bucket (``generation.DecodePrograms``; nothing off the card or
        with the runtime's graphs off).  Returns ``self``."""
        gen_cfg = self._gen_cfg()
        agent = self.rt.agent
        if not agent.graphs.active(self.rt.device):
            return self
        store = decode_programs(agent)
        store.reserve(agent, self.max_batch_size,
                      max(gen_cfg.prompt_buckets) + gen_cfg.max_new_tokens,
                      self.rt.device)
        for bucket in gen_cfg.prompt_buckets:
            store.warm(agent, 1, bucket, gen_cfg, self.rt.tokenizer.vocab)
        return self

    def flush(self) -> List[Dict[str, Any]]:
        """Run everything queued; returns results in submission order."""
        gen_cfg = self._gen_cfg()

        groups: Dict[int, List[_Pending]] = {}
        for p in self._pending:
            n = len(p.request["input_ids"])
            bucket = next((x for x in gen_cfg.prompt_buckets if x >= n), n)
            groups.setdefault(bucket, []).append(p)
        self._pending = []

        results: Dict[int, Dict[str, Any]] = {}
        for bucket in sorted(groups):
            batch = groups[bucket]
            for i in range(0, len(batch), self.max_batch_size):
                chunk = batch[i:i + self.max_batch_size]
                outs = generate_batch(self.rt.agent, self.rt.tokenizer,
                                      [p.request for p in chunk],
                                      gen_cfg=gen_cfg)
                for p, out in zip(chunk, outs):
                    out["clean_text"] = prompts.strip_markup(out["text"])
                    out["images"] = None
                    results[p.idx] = out
                self._decode_images(chunk, outs, results)

        return [results[i] for i in sorted(results)]

    def _decode_images(self, chunk: List[_Pending], outs: List[Dict],
                       results: Dict[int, Dict]) -> None:
        """One batched SDXL run per kind for every image span of a chunk
        (reference serving.py:140-185): t2i-like spans (the 2-way CFG
        pipeline; the 8-channel UNet with zero condition latents), then
        edit spans, each with its request's source image as the
        condition."""
        if self.rt.adapter is None:
            return
        for edit in (False, True):
            feats, owners, conds = [], [], []
            for p, out in zip(chunk, outs):
                if (p.kind == "edit") != edit or not out["has_img_output"]:
                    continue
                n = out["num_gen_imgs"]
                feats.append(out["img_gen_feat"])
                owners.extend([p.idx] * n)
                if edit:
                    conds.append(condition_input(self.rt, p.image).expand(
                        n, -1, -1, -1))
            if not feats:
                continue
            images = self.rt.adapter.generate(
                torch.cat(feats),
                latent_image=torch.cat(conds) if edit else None,
                seed=self.seed, num_inference_steps=self.num_inference_steps,
                image_guidance_scale=(self.image_guidance_scale if edit
                                      else None))
            for owner, img in zip(owners, images):
                prev = results[owner]["images"]
                results[owner]["images"] = (
                    img[None] if prev is None
                    else np.concatenate([prev, img[None]]))
