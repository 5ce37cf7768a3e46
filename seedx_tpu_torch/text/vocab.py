"""Multimodal vocabulary layout (a copy of seedx_tpu/text/vocab.py, so the
port imports nothing of the JAX package; keep the two identical).

The reference extends the LLaMA2 tokenizer to 32330 tokens
(configs/clm_models/llm_seed_x_lora.yaml:25): 32000 base + 100
``<img_xxxxx>`` + 224 ``<loc-k>`` grounding bins + 6 span markers
(``<img> </img> <patch> </patch> <box_start> <box_end>``,
src/inference/eval_img2text_seed_x_i.py:49-53,39-46).  The image tokens are
a contiguous id range, so the constrained image-token decoder is integer
arithmetic (models/generation.py).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List


@dataclasses.dataclass(frozen=True)
class MultimodalVocab:
    base_vocab_size: int = 32000
    num_img_tokens: int = 100
    num_loc_tokens: int = 224

    # -- derived ids ---------------------------------------------------------
    @property
    def img_token_start(self) -> int:          # <img_00000>
        return self.base_vocab_size

    @property
    def loc_token_start(self) -> int:          # <loc-0>
        return self.img_token_start + self.num_img_tokens

    @property
    def boi(self) -> int:                      # <img>
        return self.loc_token_start + self.num_loc_tokens

    @property
    def eoi(self) -> int:                      # </img>
        return self.boi + 1

    @property
    def bop(self) -> int:                      # <patch>
        return self.boi + 2

    @property
    def eop(self) -> int:                      # </patch>
        return self.boi + 3

    @property
    def box_start(self) -> int:                # <box_start>
        return self.boi + 4

    @property
    def box_end(self) -> int:                  # <box_end>
        return self.boi + 5

    @property
    def vocab_size(self) -> int:
        return self.boi + 6                    # 32330 with defaults

    # -- token strings ---------------------------------------------------------
    BOI_TOKEN = "<img>"
    EOI_TOKEN = "</img>"
    BOP_TOKEN = "<patch>"
    EOP_TOKEN = "</patch>"
    BOX_START = "<box_start>"
    BOX_END = "<box_end>"

    def img_token(self, i: int) -> str:
        return f"<img_{i:05d}>"

    def loc_token(self, i: int) -> str:
        return f"<loc-{i}>"

    def img_token_id(self, i: int) -> int:
        return self.img_token_start + i

    def loc_token_id(self, i: int) -> int:
        return self.loc_token_start + i

    def special_token_strings(self) -> List[str]:
        """All 330 added tokens in id order."""
        toks = [self.img_token(i) for i in range(self.num_img_tokens)]
        toks += [self.loc_token(i) for i in range(self.num_loc_tokens)]
        toks += [self.BOI_TOKEN, self.EOI_TOKEN, self.BOP_TOKEN, self.EOP_TOKEN,
                 self.BOX_START, self.BOX_END]
        return toks

    def token_id(self, token: str) -> int:
        m = re.fullmatch(r"<img_(\d{5})>", token)
        if m:
            return self.img_token_id(int(m.group(1)))
        m = re.fullmatch(r"<loc-(\d+)>", token)
        if m:
            return self.loc_token_id(int(m.group(1)))
        fixed = {
            self.BOI_TOKEN: self.boi, self.EOI_TOKEN: self.eoi,
            self.BOP_TOKEN: self.bop, self.EOP_TOKEN: self.eop,
            self.BOX_START: self.box_start, self.BOX_END: self.box_end,
        }
        if token in fixed:
            return fixed[token]
        raise KeyError(token)

    def id_to_token(self, tid: int) -> str:
        if self.img_token_start <= tid < self.loc_token_start:
            return self.img_token(tid - self.img_token_start)
        if self.loc_token_start <= tid < self.boi:
            return self.loc_token(tid - self.loc_token_start)
        names = [self.BOI_TOKEN, self.EOI_TOKEN, self.BOP_TOKEN, self.EOP_TOKEN,
                 self.BOX_START, self.BOX_END]
        if self.boi <= tid < self.vocab_size:
            return names[tid - self.boi]
        raise KeyError(tid)


DEFAULT_VOCAB = MultimodalVocab()
