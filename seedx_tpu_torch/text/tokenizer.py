"""Byte-level tokenizer over the SEED-X id space (a copy of the
``ByteFallbackTokenizer`` part of seedx_tpu/text/tokenizer.py, so the port
imports nothing of the JAX package; keep the two identical).

The analogue of the reference's DEBUG_FLAG path (peft_models.py:38-47):
deterministic, no tokenizer files.  ``encode(text, add_bos=False)``,
``decode(ids, skip_special_tokens=False)``, ``bos_token_id``,
``eos_token_id``, ``pad_token_id`` and ``.vocab``.  The HuggingFace
adapter for the released tokenizer is not ported yet.
"""

from __future__ import annotations

import re
from typing import List, Sequence

from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB, MultimodalVocab

_SPECIAL_RE = re.compile(r"<img_\d{5}>|<loc-\d+>|<img>|</img>|<patch>|</patch>|"
                         r"<box_start>|<box_end>")


def _split_on_specials(text: str):
    """Yield (is_special, segment) pieces."""
    pos = 0
    for m in _SPECIAL_RE.finditer(text):
        if m.start() > pos:
            yield False, text[pos:m.start()]
        yield True, m.group(0)
        pos = m.end()
    if pos < len(text):
        yield False, text[pos:]


class ByteFallbackTokenizer:
    """ids: 0 <pad/unk>, 1 <s>, 2 </s>, 3..258 bytes; 32000.. follow the
    MultimodalVocab layout."""

    def __init__(self, vocab: MultimodalVocab = DEFAULT_VOCAB):
        self.vocab = vocab
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self._byte_offset = 3

    @property
    def vocab_size(self) -> int:
        return self.vocab.vocab_size

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_bos else []
        for is_special, seg in _split_on_specials(text):
            if is_special:
                ids.append(self.vocab.token_id(seg))
            else:
                ids.extend(b + self._byte_offset for b in seg.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        buf = bytearray()

        def flush():
            nonlocal buf
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()

        for tid in ids:
            tid = int(tid)
            if self._byte_offset <= tid < self._byte_offset + 256:
                buf.append(tid - self._byte_offset)
            elif tid >= self.vocab.img_token_start:
                flush()
                if not skip_special_tokens:
                    out.append(self.vocab.id_to_token(tid))
            else:
                flush()
                if not skip_special_tokens and tid == self.bos_token_id:
                    out.append("<s>")
                if not skip_special_tokens and tid == self.eos_token_id:
                    out.append("</s>")
        flush()
        return "".join(out)


def load_tokenizer(vocab: MultimodalVocab = DEFAULT_VOCAB
                   ) -> ByteFallbackTokenizer:
    return ByteFallbackTokenizer(vocab)
