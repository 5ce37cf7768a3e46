"""Inference apps (reference: seedx_tpu/inference/apps.py), one per
reference eval script:

  comprehend()        <- src/inference/eval_img2text_seed_x_i.py
  ground()            <- the detection half of eval_img2text_seed_x_i.py
  text_to_image()     <- eval_text2img_seed_x_i.py / eval_text2img_seed_x.py
  edit_image()        <- eval_img2edit_seed_x_edit.py
  reconstruct()       <- eval_seed_x_detokenizer.py
  reconstruct_with_condition() <- eval_seed_x_detokenizer_with_condition.py

The last four turn image features into pixels through the runtime's SDXL
adapter; ``text_to_image`` and ``edit_image`` return ``images: None`` when
the agent emits no image span or the runtime has no adapter.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from seedx_tpu_torch.data.transforms import get_transform
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
               spec_k: int = 0,
               timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Image + question -> answer text (and any generated image features).
    ``spec_k`` > 0 decodes with exact n-gram speculative decoding (greedy;
    ``models/generation.py``): the same tokens, fewer weight passes.
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
                      max_new_tokens=max_new_tokens, spec_k=spec_k,
                      timings=timings)
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
           max_new_tokens: int = 512, spec_k: int = 0,
           timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Comprehension + bounding-box extraction + box rendering
    (reference: eval_img2text_seed_x_i.py:182-231).  Grounding replies
    are self-similar (``<box_start>..<box_end>`` markup): territory for
    ``spec_k``."""
    out = comprehend(rt, image, question, max_new_tokens=max_new_tokens,
                     spec_k=spec_k, timings=timings)
    boxes = prompts.extract_boxes(out["text"])
    out["boxes"] = boxes
    out["boxes_image"] = None
    if boxes is not None:
        w, h = image.size
        out["boxes_pixels"] = prompts.boxes_to_pixels(boxes, w, h)
        out["boxes_image"] = draw_boxes(image, out["boxes_pixels"])
    return out


def condition_input(rt: SeedXRuntime, image) -> torch.Tensor:
    """A PIL image -> the edit UNet's condition input [1, H, W, 3] in
    [-1, 1] at the sampler's size, on the runtime's device."""
    tf = get_transform("sd", keep_ratio=False,
                       image_size=rt.adapter.cfg.sampler.height)
    return torch.from_numpy(tf(image))[None].to(rt.device)


def text_to_image(rt: SeedXRuntime, caption: str, seed: int = 42,
                  num_inference_steps: int = 50, max_new_tokens: int = 120,
                  solver: str = "euler", spec_k: int = 0,
                  timings: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Any]:
    """Caption -> generated image (reference: eval_text2img_seed_x_i.py:85-94):
    the agent is prompted to emit an image span, whose 64 output-resampler
    features drive the SDXL adapter.  ``timings`` receives the agent's and
    the adapter's phases (``SeedXRuntime.generate``,
    ``SDXLAdapter.generate``)."""
    text = prompts.generation_prompt(caption)
    input_ids = [rt.tokenizer.bos_token_id] + rt.tokenizer.encode(text)
    out = rt.generate(input_ids, max_new_tokens=max_new_tokens,
                      spec_k=spec_k, timings=timings)
    out["images"] = None
    if out["has_img_output"] and rt.adapter is not None:
        out["images"] = rt.adapter.generate(
            out["img_gen_feat"], seed=seed,
            num_inference_steps=num_inference_steps, solver=solver,
            timings=timings)
    return out


def edit_image(rt: SeedXRuntime, image, instruction: str, seed: int = 42,
               num_inference_steps: int = 50, max_new_tokens: int = 120,
               solver: str = "euler", spec_k: int = 0,
               image_guidance_scale: Optional[float] = None,
               timings: Optional[Dict[str, float]] = None
               ) -> Dict[str, Any]:
    """Instruction-guided editing (reference: eval_img2edit_seed_x_edit.py):
    the source image enters both the agent (the comprehension splice) and
    the SDXL UNet (condition latents).  ``image_guidance_scale=1.0`` selects
    the 2-branch CFG (``pipeline.denoise_edit``)."""
    input_ids, cmp_mask, embeds, ecm, ppos = _prepare_image_prompt(
        rt, image, instruction)
    out = rt.generate(input_ids, image_embeds=embeds, embeds_cmp_mask=ecm,
                      ids_cmp_mask=cmp_mask, patch_positions=ppos,
                      max_new_tokens=max_new_tokens, spec_k=spec_k,
                      timings=timings)
    out["images"] = None
    if out["has_img_output"] and rt.adapter is not None:
        out["images"] = rt.adapter.generate(
            out["img_gen_feat"], latent_image=condition_input(rt, image),
            seed=seed, num_inference_steps=num_inference_steps,
            solver=solver, image_guidance_scale=image_guidance_scale,
            timings=timings)
    return out


def reconstruct(rt: SeedXRuntime, image, seed: int = 42,
                num_inference_steps: int = 50, solver: str = "euler",
                timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """ViT features -> SDXL directly, no agent: detokenizer reconstruction
    (reference: eval_seed_x_detokenizer.py).  The raw ViT tokens condition
    the adapter (adapter_modules.py:103-108), against the unpooled
    negative."""
    if rt.adapter is None:
        raise ValueError("reconstruct needs a runtime with an SDXL adapter")
    return rt.adapter.generate(rt.encode_image_single(image), from_vit=True,
                               seed=seed,
                               num_inference_steps=num_inference_steps,
                               solver=solver, timings=timings)


def reconstruct_with_condition(rt: SeedXRuntime, image, condition_image,
                               seed: int = 42, num_inference_steps: int = 50,
                               solver: str = "euler",
                               timings: Optional[Dict[str, float]] = None
                               ) -> np.ndarray:
    """Reconstruction with a condition image through the edit UNet
    (reference: eval_seed_x_detokenizer_with_condition.py)."""
    if rt.adapter is None:
        raise ValueError("reconstruct_with_condition needs a runtime with "
                         "an SDXL adapter")
    return rt.adapter.generate(
        rt.encode_image_single(image), from_vit=True,
        latent_image=condition_input(rt, condition_image), seed=seed,
        num_inference_steps=num_inference_steps, solver=solver,
        timings=timings)
