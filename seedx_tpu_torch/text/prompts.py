"""Prompt construction and box parsing (a copy of the pieces of
seedx_tpu/text/prompts.py the port uses, so it imports nothing of the JAX
package; keep the two identical).

Comprehension / grounding: ``(<patch> <img_k>*64 </patch>)* <img>
<img_k>*64 </img> [INST] question [/INST]\\n`` (reference:
src/inference/eval_img2text_seed_x_i.py:55,143-149); text-to-image
``[INST] Generate an image: {caption} [/INST]\\n``
(eval_text2img_seed_x_i.py:23); pretrain-style QA ``Question:
{q}\\nAnswer:`` (eval_img2text_seed_x.py); box coordinates
``<box_start><loc-k>*4<box_end>`` in /224 bins
(eval_img2text_seed_x_i.py:16-46).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB, MultimodalVocab

INSTRUCTION_PROMPT = "[INST] {instruction} [/INST]\n"
GENERATION_PROMPT = "[INST] Generate an image: {caption} [/INST]\n"
PRETRAIN_QA_PROMPT = "Question: {question}\nAnswer:"
LOC_SCALE = 224  # grounding coordinate bins (eval_img2text_seed_x_i.py:23-27)


def image_token_block(num_tokens: int = 64,
                      vocab: MultimodalVocab = DEFAULT_VOCAB) -> str:
    return "".join(vocab.img_token(i) for i in range(num_tokens))


def multi_patch_image_string(num_patches: int, num_tokens: int = 64,
                             vocab: MultimodalVocab = DEFAULT_VOCAB) -> str:
    """Anyres image string: (num_patches-1) tile spans + one global span
    (reference: eval_img2text_seed_x_i.py:143-146)."""
    block = image_token_block(num_tokens, vocab)
    s = ""
    for _ in range(num_patches - 1):
        s += vocab.BOP_TOKEN + block + vocab.EOP_TOKEN
    s += vocab.BOI_TOKEN + block + vocab.EOI_TOKEN
    return s


def comprehension_prompt(question: str, num_patches: int = 1,
                         num_tokens: int = 64,
                         vocab: MultimodalVocab = DEFAULT_VOCAB) -> str:
    """The instruction prompt around an anyres image string and the
    question (reference prompts.py:47)."""
    imgs = multi_patch_image_string(num_patches, num_tokens, vocab)
    return INSTRUCTION_PROMPT.format(instruction=imgs + question)


def generation_prompt(caption: str) -> str:
    return GENERATION_PROMPT.format(caption=caption)


def cmp_mask_from_ids(input_ids: Sequence[int],
                      vocab: MultimodalVocab = DEFAULT_VOCAB) -> np.ndarray:
    """True at every position inside <img>..</img> / <patch>..</patch>
    spans (exclusive of the markers): where resampled image embeddings are
    spliced in (reference: eval_img2text_seed_x_i.py:156-162)."""
    ids = np.asarray(input_ids)
    mask = np.zeros(ids.shape, dtype=bool)
    opens = np.where((ids == vocab.boi) | (ids == vocab.bop))[0]
    closes = np.where((ids == vocab.eoi) | (ids == vocab.eop))[0]
    for o, c in zip(opens, closes):
        mask[o + 1:c] = True
    return mask


def extract_boxes(text: str) -> Optional[List[Tuple[int, int, int, int]]]:
    """Parse ``<box_start><loc-x><loc-y><loc-w><loc-h><box_end>`` groups
    (reference: eval_img2text_seed_x_i.py:39-46).  Coordinates are center-x,
    center-y, width, height in /224 bins."""
    boxes = re.findall(r"<box_start>(.*?)<box_end>", text)
    if not boxes:
        return None
    return [tuple(int(n) for n in re.findall(r"<loc-(\d+)>", b))
            for b in boxes]


def boxes_to_pixels(boxes, img_width: int, img_height: int):
    """Scale /224 center boxes to pixel corner boxes
    (reference: eval_img2text_seed_x_i.py:16-34)."""
    out = []
    for (cx, cy, w, h) in boxes:
        cx = cx / LOC_SCALE * img_width
        cy = cy / LOC_SCALE * img_height
        w = w / LOC_SCALE * img_width
        h = h / LOC_SCALE * img_height
        out.append((int(cx - w / 2), int(cy - h / 2),
                    int(cx + w / 2), int(cy + h / 2)))
    return out


def strip_markup(text: str) -> str:
    """Remove all <...> tags for display (reference:
    eval_img2text_seed_x_i.py:178)."""
    return re.sub(r"<[^>]*>", "", text)
