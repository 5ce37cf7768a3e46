"""Bucket-batched serving engine (reference:
seedx_tpu/inference/serving.py).

The reference serves one prompt at a time through the HF ``generate``
loop (src/inference/eval_img2text_seed_x_i.py, a bare for-loop).  Decode
streams the same int4 weights at batch 1 and batch 8, so batching
multiplies tokens per second until the matmuls stop being bound by
memory.  The engine queues heterogeneous requests (comprehension, t2i,
edit, raw), groups them by prompt-length bucket, runs one prefill + decode
loop (``generate_batch``) per chunk of ``max_batch_size`` requests of a
bucket, and returns results in submission order.

The SDXL adapter (image out) is not ported yet: t2i and edit requests
return their text with ``images: None``, as any request does when the
runtime has no adapter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from seedx_tpu_torch.inference.apps import _prepare_image_prompt
from seedx_tpu_torch.inference.runtime import SeedXRuntime
from seedx_tpu_torch.models.generation import (GenerationConfig,
                                               generate_batch)
from seedx_tpu_torch.text import prompts


@dataclasses.dataclass
class _Pending:
    idx: int                      # submission order
    request: Dict[str, Any]      # generate_batch schema


class ServingEngine:
    """In-process micro-batching server over a SeedXRuntime."""

    def __init__(self, rt: SeedXRuntime, max_batch_size: int = 8,
                 max_new_tokens: int = 512):
        self.rt = rt
        self.max_batch_size = max_batch_size
        self.max_new_tokens = max_new_tokens
        self._pending: List[_Pending] = []
        self._count = 0

    # ---- submission --------------------------------------------------------

    def _push(self, request: Dict[str, Any]) -> int:
        idx = self._count
        self._count += 1
        self._pending.append(_Pending(idx, request))
        return idx

    def submit_comprehend(self, image, question: str,
                          prompt_style: str = "instruct") -> int:
        ids, cmp_mask, embeds, ecm, ppos = _prepare_image_prompt(
            self.rt, image, question, prompt_style)
        return self._push({"input_ids": ids, "image_embeds": embeds,
                           "embeds_cmp_mask": ecm, "ids_cmp_mask": cmp_mask,
                           "patch_positions": ppos})

    def submit_text_to_image(self, caption: str) -> int:
        text = prompts.generation_prompt(caption)
        ids = [self.rt.tokenizer.bos_token_id] + self.rt.tokenizer.encode(text)
        return self._push({"input_ids": ids})

    def submit_edit(self, image, instruction: str) -> int:
        """The edit prompt (image + instruction); its text comes back, the
        image edit itself needs the SDXL adapter."""
        return self.submit_comprehend(image, instruction)

    def submit_raw(self, request: Dict[str, Any]) -> int:
        """A pre-built generate_batch request dict."""
        return self._push(request)

    # ---- execution ---------------------------------------------------------

    def flush(self) -> List[Dict[str, Any]]:
        """Run everything queued; returns results in submission order."""
        gen_cfg = GenerationConfig(
            max_new_tokens=self.max_new_tokens,
            num_img_gen_tokens=self.rt.agent_cfg.num_img_out_tokens,
            eos_token_id=self.rt.tokenizer.eos_token_id,
            pad_token_id=self.rt.tokenizer.pad_token_id)

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
                self._decode_images()

        return [results[i] for i in sorted(results)]

    def _decode_images(self) -> None:
        """One batched SDXL run per kind for every image span of a chunk
        (reference serving.py:140-185): nothing to do without the adapter,
        which is not ported yet."""
        if self.rt.adapter is None:
            return
        raise NotImplementedError("the SDXL adapter is not ported yet")
