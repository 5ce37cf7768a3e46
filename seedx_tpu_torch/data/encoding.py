"""Training-sample encoders: text + image-token streams -> fixed-shape
arrays (a copy of seedx_tpu/data/encoding.py, so the port imports nothing
of the JAX package; keep the two identical).

Pure-numpy mirrors of the reference's tokenization logic:
  * ``encode_caption_sample``      <- encode_caption_input_ids_v2
    (reference: src/data/image_text_pairs_clm.py:172-256) — image-first
    (comprehension) vs image-last (generation) coin flip; anyres patch spans,
  * ``encode_conversation_sample`` <- decode_llava_data
    (reference: src/data/sft_clm.py:149-345) — [INST] turns, labels only on
    assistant turns, image tokens spliced into the first user turn,
  * ``encode_edit_sample``         <- decode_single_turn_edit_data
    (reference: src/data/sft_clm.py:451-651) — source image (comprehension)
    + target image (generation) + polite response.

All return the SFT batch keys with fixed ``max_length`` padding:
input_ids, attention_mask, labels, ids_gen_mask, ids_cmp_mask (np arrays)
and per-image-slot embeds_gen_mask / embeds_cmp_mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB, MultimodalVocab

IGNORE = -100

# reference: src/data/sft_clm.py:31-53
GEN_PROMPT_RESPONSES = [
    "Here is a picture.", "I have designed an image.", "Here is a photo.",
    "I have generated an image.", "Here's a painting.", "Here's a drawing.",
    "Enjoy this illustration.", "Take a look at this image.",
    "Here is a picture.", "I have created a photo.", "Enjoy this photo.",
    "I have generated a picture.", "Here is a photograph.",
    "Here's an image.", "Certainly, here's an image.",
    "Absolutely, here is a painting.", "Sure, here is a picture.",
    "Of course, here is a photo.", "Certainly, please enjoy this picture.",
    "Sure, please enjoy this illustration.", "",
]

# reference: src/data/image_text_pairs_clm.py:30-58 (``gen_prompt_all``) —
# training-data constants; one index samples the PAIR (prompt, response)
GEN_INSTRUCTIONS = [
    "Please show me a picture of",
    "Please design an image of",
    "Please produce a photo of",
    "Please generate an image of",
    "Please draw a painting of",
    "I'd like to see a drawing of",
    "I'd love to see an illustration of",
    "I'd like to view an image of",
    "I want to see a picture of",
    "I would like to see a photo of",
    "Show me a photo of",
    "Generate a picture of",
    "Show me a photograph of",
    "Generate an image of",
    "Generate an image:",
    "Generate a picture:",
    "Generate a painting:",
    "Generate a photograph:",
    "Show me a photograph:",
    "Draw a picture:",
    "Draw a painting:",
    "Draw an image:",
    "Can you make an image of",
    "Can you draw a painting of",
    "Can you produce a picture of",
    "Can you generate a photo of",
    "Can you depict a picture of",
    "Can you show me an illustration of",
]

# reference: src/data/image_text_pairs_clm.py:60-89
# (``gen_prompt_response_all``, index-paired with GEN_INSTRUCTIONS)
GEN_INSTRUCTION_RESPONSES = [
    "Here is a picture.",
    "I have designed an image.",
    "Here is a photo.",
    "I have generated an image.",
    "Here's a painting.",
    "Here's a drawing.",
    "Enjoy this illustration.",
    "Take a look at this image.",
    "Here is a picture.",
    "I have created a photo.",
    "Enjoy this photo.",
    "I have generated a picture.",
    "Here is a photograph.",
    "Here's an image.",
    "Here's an image.",
    "Here's a picture.",
    "Here's a painting.",
    "Here's a photograph.",
    "Here's a photograph.",
    "Enjoy this picture.",
    "Enjoy this painting.",
    "Enjoy this image.",
    "Absolutely, here is an image.",
    "Absolutely, here is a painting.",
    "Sure, here is a picture.",
    "Of course, here is a photo.",
    "Certainly, please enjoy this picture.",
    "Sure, please enjoy this illustration.",
]

INSTRUCTION_PROMPT = "[INST] {instruction} [/INST]\n"


def _img_span(vocab: MultimodalVocab, n: int, patch: bool) -> List[int]:
    open_id = vocab.bop if patch else vocab.boi
    close_id = vocab.eop if patch else vocab.eoi
    return [open_id] + [vocab.img_token_id(i) for i in range(n)] + [close_id]


def _anyres_image_ids(vocab: MultimodalVocab, patch_length: int,
                      n_tokens: int) -> List[int]:
    """(patch_length-1) tile spans + one global <img> span."""
    ids: List[int] = []
    for _ in range(patch_length - 1):
        ids += _img_span(vocab, n_tokens, patch=True)
    ids += _img_span(vocab, n_tokens, patch=False)
    return ids


def _pad_and_pack(tokenizer, input_ids, labels, ids_gen_mask, ids_cmp_mask,
                  max_length) -> Dict[str, np.ndarray]:
    n = len(input_ids)
    attention_mask = [1] * n
    if n >= max_length:
        input_ids = input_ids[:max_length]
        attention_mask = attention_mask[:max_length]
        labels = labels[:max_length]
        ids_gen_mask = ids_gen_mask[:max_length]
        ids_cmp_mask = ids_cmp_mask[:max_length]
    else:
        pad = max_length - n
        input_ids = input_ids + [tokenizer.pad_token_id] * pad
        attention_mask = attention_mask + [0] * pad
        labels = labels + [IGNORE] * pad
        ids_gen_mask = ids_gen_mask + [False] * pad
        ids_cmp_mask = ids_cmp_mask + [False] * pad
    return {
        "input_ids": np.asarray(input_ids, np.int32),
        "attention_mask": np.asarray(attention_mask, np.int32),
        "labels": np.asarray(labels, np.int32),
        "ids_gen_mask": np.asarray(ids_gen_mask, bool),
        "ids_cmp_mask": np.asarray(ids_cmp_mask, bool),
    }


def _span_masks(input_ids: Sequence[int], vocab: MultimodalVocab):
    """cmp positions = inside <img>/<patch> spans whose content is consumed."""
    ids = np.asarray(input_ids)
    mask = np.zeros(len(ids), bool)
    opens = np.where((ids == vocab.boi) | (ids == vocab.bop))[0]
    closes = np.where((ids == vocab.eoi) | (ids == vocab.eop))[0]
    return ids, mask, opens, closes


def encode_caption_sample(
    caption: str,
    tokenizer,
    *,
    max_length: int,
    img_first_ratio: float = 0.5,
    num_img_in_tokens: int = 64,
    num_img_out_tokens: int = 64,
    patch_length: int = 1,
    rng: Optional[np.random.Generator] = None,
    vocab: MultimodalVocab = DEFAULT_VOCAB,
    instruction_prompt: Optional[str] = None,
    add_gen_prompt: bool = False,
) -> Dict[str, np.ndarray]:
    """Image-text pair -> comprehension (img first) or generation (img last)
    sample (reference: image_text_pairs_clm.py:172-256)."""
    rng = rng or np.random.default_rng()
    caption_ids = tokenizer.encode(caption)

    img_first = rng.uniform() < img_first_ratio
    if len(caption_ids) + (num_img_out_tokens + 2) * patch_length + 2 > max_length:
        img_first = True

    if img_first:
        # comprehension: all anyres tiles in front, caption is the label
        image_ids = _anyres_image_ids(vocab, patch_length, num_img_in_tokens)
        input_ids = ([tokenizer.bos_token_id] + image_ids + caption_ids
                     + [tokenizer.eos_token_id])
        labels = ([IGNORE] + [IGNORE] * len(image_ids) + caption_ids
                  + [tokenizer.eos_token_id])
        ids_gen_mask = [False] * len(input_ids)
        ids_cmp_mask = [False]
        for _ in range(patch_length):
            ids_cmp_mask += [False] + [True] * num_img_in_tokens + [False]
        ids_cmp_mask += [False] * len(caption_ids) + [False]
        embeds_gen_mask = [False] * patch_length
        embeds_cmp_mask = [True] * patch_length
    else:
        # generation: caption first, single 64-token target span; <img> (the
        # span opener) is itself a label so the model learns to emit it
        if add_gen_prompt:
            # index-paired sampling of (instruction, response), composed as
            # prompt + caption -> template -> + response
            # (reference: image_text_pairs_clm.py:282-300)
            k = int(rng.integers(len(GEN_INSTRUCTIONS)))
            tmpl = instruction_prompt or INSTRUCTION_PROMPT
            text = GEN_INSTRUCTIONS[k] + " " + caption.lstrip(" ")
            text = tmpl.format(instruction=text)
            text = text.rstrip(" ") + " " + GEN_INSTRUCTION_RESPONSES[k]
            caption_ids = tokenizer.encode(text)
        image_ids = _img_span(vocab, num_img_out_tokens, patch=False)
        image_labels = [image_ids[0]] + [IGNORE] * (len(image_ids) - 1)
        input_ids = ([tokenizer.bos_token_id] + caption_ids + image_ids
                     + [tokenizer.eos_token_id])
        labels = ([IGNORE] + [IGNORE] * len(caption_ids) + image_labels
                  + [tokenizer.eos_token_id])
        ids_gen_mask = ([False] + [False] * len(caption_ids) + [False]
                        + [True] * num_img_out_tokens + [False] + [False])
        ids_cmp_mask = [False] * len(input_ids)
        embeds_gen_mask = [False] * (patch_length - 1) + [True]
        embeds_cmp_mask = [False] * patch_length

    out = _pad_and_pack(tokenizer, input_ids, labels, ids_gen_mask,
                        ids_cmp_mask, max_length)
    out["embeds_gen_mask"] = np.asarray(embeds_gen_mask, bool)
    out["embeds_cmp_mask"] = np.asarray(embeds_cmp_mask, bool)
    return out


def encode_conversation_sample(
    turns: Sequence[str],
    tokenizer,
    *,
    max_length: int,
    patch_length: int = 0,          # 0 = text-only conversation
    num_img_in_tokens: int = 64,
    instruction_prompt: str = INSTRUCTION_PROMPT,
    turn_sep: str = "\n",
    system_message: str = "",
    rng: Optional[np.random.Generator] = None,
    vocab: MultimodalVocab = DEFAULT_VOCAB,
) -> Optional[Dict[str, np.ndarray]]:
    """LLaVA-style multi-turn conversation (reference: sft_clm.py:149-345).

    ``turns`` alternate user/assistant starting with user.  When
    ``patch_length > 0`` the anyres image-token block is spliced into the
    first user turn (image-first/last coin flip, sft_clm.py:249-254).
    Returns None when the image span would be truncated (reference drops
    those samples, sft_clm.py:288-289).
    """
    rng = rng or np.random.default_rng()
    input_ids: List[int] = []
    labels: List[int] = []

    if system_message:
        if not system_message.endswith("\n"):
            system_message += "\n"
        ids = tokenizer.encode(system_message)
        input_ids += ids
        labels += [IGNORE] * len(ids)

    image_token_ids = (_anyres_image_ids(vocab, patch_length,
                                         num_img_in_tokens)
                       if patch_length else [])
    image_text = "".join(
        vocab.id_to_token(t) if t >= vocab.img_token_start else ""
        for t in image_token_ids)

    for idx, content in enumerate(turns):
        if idx % 2 == 0:  # user
            if idx == 0:
                if image_token_ids:
                    image_in_start = rng.uniform() < 0.5
                    instruction = (image_text + content if image_in_start
                                   else content + image_text)
                else:
                    instruction = content
                text = instruction_prompt.format(instruction=instruction)
            else:
                text = turn_sep + instruction_prompt.format(
                    instruction=content)
            ids = tokenizer.encode(text)
            input_ids += ids
            labels += [IGNORE] * len(ids)
        else:  # assistant
            ids = tokenizer.encode(content)
            input_ids += ids
            labels += ids

    input_ids = [tokenizer.bos_token_id] + input_ids + [tokenizer.eos_token_id]
    labels = [IGNORE] + labels + [tokenizer.eos_token_id]

    ids, _, opens, closes = _span_masks(input_ids, DEFAULT_VOCAB)
    if patch_length:
        eoi_positions = np.where(ids == vocab.eoi)[0]
        if eoi_positions.size and eoi_positions[-1] >= max_length:
            return None

    ids_cmp = np.zeros(len(input_ids), bool)
    for o, c in zip(opens, closes):
        ids_cmp[o + 1:c] = True
    ids_gen = [False] * len(input_ids)

    out = _pad_and_pack(tokenizer, input_ids, labels, ids_gen,
                        list(ids_cmp), max_length)
    out["embeds_gen_mask"] = np.zeros((patch_length,), bool)
    out["embeds_cmp_mask"] = np.ones((patch_length,), bool)
    return out


def encode_edit_sample(
    instruction: str,
    tokenizer,
    *,
    max_length: int,
    source_patch_length: int,
    target_patch_length: int,
    response: Optional[str] = None,
    use_polite_response: bool = True,
    prompt_drop_ratio: float = 0.0,
    num_img_in_tokens: int = 64,
    num_img_out_tokens: int = 64,
    instruction_prompt: str = INSTRUCTION_PROMPT,
    rng: Optional[np.random.Generator] = None,
    vocab: MultimodalVocab = DEFAULT_VOCAB,
) -> Dict[str, np.ndarray]:
    """Single-turn edit sample (reference: sft_clm.py:451-651):
    [INST] source-image-tokens + instruction [/INST] response + target span.

    Image slots: ``source_patch_length`` comprehension tiles, then
    ``target_patch_length`` tiles of which only the LAST (the global
    thumbnail) is a generation target."""
    rng = rng or np.random.default_rng()

    if rng.uniform() < prompt_drop_ratio or instruction is None:
        instruction = ""
    if response is None:
        response = (GEN_PROMPT_RESPONSES[int(rng.integers(
            len(GEN_PROMPT_RESPONSES)))] if use_polite_response else "")

    src_ids = _anyres_image_ids(vocab, source_patch_length, num_img_in_tokens)
    gen_ids = _img_span(vocab, num_img_out_tokens, patch=False)

    # image-first/image-last coin flip inside the instruction template
    # (reference: sft_clm.py:560-566)
    image_in_start = rng.uniform() < 0.5
    prefix, _, suffix = instruction_prompt.partition("{instruction}")
    if image_in_start:
        user_ids = (tokenizer.encode(prefix) + src_ids
                    + tokenizer.encode(instruction + suffix))
    else:
        user_ids = (tokenizer.encode(prefix + instruction) + src_ids
                    + tokenizer.encode(suffix))

    resp_ids = tokenizer.encode(response) if response else []
    gen_labels = [gen_ids[0]] + [IGNORE] * (len(gen_ids) - 1)

    input_ids = ([tokenizer.bos_token_id] + user_ids + resp_ids + gen_ids
                 + [tokenizer.eos_token_id])
    labels = ([IGNORE] + [IGNORE] * len(user_ids) + resp_ids + gen_labels
              + [tokenizer.eos_token_id])

    ids = np.asarray(input_ids)
    ids_cmp = np.zeros(len(ids), bool)
    ids_gen = np.zeros(len(ids), bool)
    opens = np.where((ids == vocab.boi) | (ids == vocab.bop))[0]
    closes = np.where((ids == vocab.eoi) | (ids == vocab.eop))[0]
    # every span except the LAST <img> span is comprehension; the last is the
    # generation target
    for o, c in zip(opens[:-1], closes[:-1]):
        ids_cmp[o + 1:c] = True
    ids_gen[opens[-1] + 1:closes[-1]] = True

    out = _pad_and_pack(tokenizer, input_ids, labels, list(ids_gen),
                        list(ids_cmp), max_length)
    out["embeds_cmp_mask"] = np.asarray(
        [True] * source_patch_length + [False] * target_patch_length, bool)
    out["embeds_gen_mask"] = np.asarray(
        [False] * source_patch_length
        + [False] * (target_patch_length - 1) + [True], bool)
    return out
