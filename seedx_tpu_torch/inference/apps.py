"""Inference apps (reference: seedx_tpu/inference/apps.py): the image-in
comprehension turn.  ``ground``, ``text_to_image``, ``edit_image`` and the
reconstruction apps need the SDXL adapter and are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from seedx_tpu_torch.inference.runtime import SeedXRuntime
from seedx_tpu_torch.models.generation import PhaseClock
from seedx_tpu_torch.text import prompts


def _prepare_image_prompt(rt: SeedXRuntime, image, instruction: str,
                          prompt_style: str = "instruct"):
    """Anyres-encode an image and build the token stream + masks
    (reference: eval_img2text_seed_x_i.py:132-165)."""
    embeds, patch_pos = rt.encode_image_anyres(image)
    n_patches = embeds.shape[0]
    image_tokens = prompts.multi_patch_image_string(
        n_patches, rt.agent_cfg.num_img_in_tokens)
    if prompt_style == "instruct":
        text = prompts.INSTRUCTION_PROMPT.format(
            instruction=image_tokens + instruction)
    else:  # pretrain QA (reference: eval_img2text_seed_x.py)
        text = image_tokens + prompts.PRETRAIN_QA_PROMPT.format(
            question=instruction)
    input_ids = [rt.tokenizer.bos_token_id] + rt.tokenizer.encode(text)
    cmp_mask = prompts.cmp_mask_from_ids(input_ids)
    embeds_cmp_mask = np.ones((n_patches,), bool)
    return input_ids, cmp_mask, embeds, embeds_cmp_mask, patch_pos


def comprehend(rt: SeedXRuntime, image, question: str,
               prompt_style: str = "instruct", max_new_tokens: int = 512,
               timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Image + question -> answer text (and any generated image features).
    ``timings``, when given, receives host seconds (each closed by a device
    synchronize) for "vit", "prefill" and "decode"."""
    clock = PhaseClock(rt.device, timings)
    input_ids, cmp_mask, embeds, ecm, ppos = _prepare_image_prompt(
        rt, image, question, prompt_style)
    clock.mark("vit")
    if timings is not None:
        timings["n_tiles"] = int(embeds.shape[0])
    out = rt.generate(input_ids, image_embeds=embeds, embeds_cmp_mask=ecm,
                      ids_cmp_mask=cmp_mask, patch_positions=ppos,
                      max_new_tokens=max_new_tokens, timings=timings)
    out["clean_text"] = prompts.strip_markup(out["text"])
    return out
