"""Inference apps (reference: seedx_tpu/inference/apps.py): the image-in
comprehension turn and grounding (``comprehend`` plus box parsing and
drawing).  ``text_to_image``, ``edit_image`` and the reconstruction apps
need the SDXL adapter and are not ported yet.
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


def draw_boxes(image, boxes_pixels, width: int = 2):
    """Render pixel corner boxes onto a copy of the image (green, 2px --
    reference: eval_img2text_seed_x_i.py:16-36 ``visualize_bbox``)."""
    from PIL import ImageDraw

    vis = image.copy()
    drawer = ImageDraw.Draw(vis)
    for (x1, y1, x2, y2) in boxes_pixels:
        drawer.rectangle([x1, y1, x2, y2], outline=(0, 255, 0), width=width)
    return vis


def ground(rt: SeedXRuntime, image, question: str,
           max_new_tokens: int = 512,
           timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Comprehension + bounding-box extraction + box rendering
    (reference: eval_img2text_seed_x_i.py:182-231)."""
    out = comprehend(rt, image, question, max_new_tokens=max_new_tokens,
                     timings=timings)
    boxes = prompts.extract_boxes(out["text"])
    out["boxes"] = boxes
    out["boxes_image"] = None
    if boxes is not None:
        w, h = image.size
        out["boxes_pixels"] = prompts.boxes_to_pixels(boxes, w, h)
        out["boxes_image"] = draw_boxes(image, out["boxes_pixels"])
    return out
