"""Tokenizers over the SEED-X id space (a copy of
seedx_tpu/text/tokenizer.py, so the port imports nothing of the JAX
package; keep the two identical).

  * ``HFTokenizer`` wraps a HuggingFace tokenizer directory (the released
    SEED-X tokenizer, a ``LlamaTokenizer`` with 330 added tokens,
    configs/tokenizer/clm_llama_tokenizer_224loc_anyres.yaml) and overlays
    the multimodal special tokens so their ids follow
    :mod:`seedx_tpu_torch.text.vocab`; it needs ``transformers``.
  * ``ByteFallbackTokenizer``: deterministic bytes, no tokenizer files
    (the analogue of the reference's DEBUG_FLAG path,
    peft_models.py:38-47).

Both: ``encode(text, add_bos=False)``, ``decode(ids,
skip_special_tokens=False)``, ``bos_token_id``, ``eos_token_id``,
``pad_token_id`` and ``.vocab``.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

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


class HFTokenizer:
    """Adapter over a HuggingFace tokenizer directory.

    The multimodal specials are re-encoded through :class:`MultimodalVocab`
    so model-side ids are layout-stable regardless of the order the HF
    tokenizer registered its added tokens.
    """

    def __init__(self, path: str, vocab: MultimodalVocab = DEFAULT_VOCAB):
        from transformers import AutoTokenizer  # local import: heavy

        try:
            # the released SEED-X dir is a slow LlamaTokenizer (reference:
            # configs/tokenizer/clm_llama_tokenizer_224loc_anyres.yaml)
            self._tok = AutoTokenizer.from_pretrained(path, use_fast=False)
        except (ValueError, OSError, ImportError):
            # fast-only directories (e.g. test fixtures without a
            # sentencepiece model file)
            self._tok = AutoTokenizer.from_pretrained(path)
        self.vocab = vocab
        self.pad_token_id = self._tok.pad_token_id or 0
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.vocab_size, len(self._tok))

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_bos else []
        for is_special, seg in _split_on_specials(text):
            if is_special:
                ids.append(self.vocab.token_id(seg))
            else:
                ids.extend(self._tok.encode(seg, add_special_tokens=False))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                out.append(self._tok.decode(run))
                run.clear()

        for tid in ids:
            tid = int(tid)
            if tid >= self.vocab.img_token_start:
                flush()
                if not skip_special_tokens:
                    out.append(self.vocab.id_to_token(tid))
            else:
                run.append(tid)
        flush()
        return "".join(out)


def load_tokenizer(path: Optional[str] = None,
                   vocab: MultimodalVocab = DEFAULT_VOCAB):
    """The HF tokenizer of a directory (``transformers`` needed), the
    byte fallback without one."""
    if path and os.path.isdir(path):
        return HFTokenizer(path, vocab)
    return ByteFallbackTokenizer(vocab)
