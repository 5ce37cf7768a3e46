"""Prompt construction for the comprehension turn (a copy of the pieces of
seedx_tpu/text/prompts.py the port uses, so it imports nothing of the JAX
package; keep the two identical).

Comprehension: ``(<patch> <img_k>*64 </patch>)* <img> <img_k>*64 </img>
[INST] question [/INST]\\n`` (reference:
src/inference/eval_img2text_seed_x_i.py:55,143-149); pretrain-style QA
``Question: {q}\\nAnswer:`` (eval_img2text_seed_x.py).
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB, MultimodalVocab

INSTRUCTION_PROMPT = "[INST] {instruction} [/INST]\n"
PRETRAIN_QA_PROMPT = "Question: {question}\nAnswer:"


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


def strip_markup(text: str) -> str:
    """Remove all <...> tags for display (reference:
    eval_img2text_seed_x_i.py:178)."""
    return re.sub(r"<[^>]*>", "", text)
