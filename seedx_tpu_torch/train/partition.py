"""Trainable / frozen partition of the agent's weights (reference:
seedx_tpu/train/partition.py).

SEED-X SFT freezes the 13B LLaMA and the ViT and trains the LoRA factors
of all seven projections, the layer norms (PEFT ``modules_to_save``), the
resized embeddings and LM head, both agent resamplers and the patch
position embedding (reference: configs/clm_models/llm_seed_x_lora.yaml:
6-25, src/train/train_seed_x_sft.py:189-197).  The patterns are the JAX
package's, written for the port's state names: ``utils/convert.py`` drops
the flax ``model.`` level, so the JAX ``.*model/norm.*`` is the port's
``llm.norm``.  Frozen weights get no gradient and no optimizer state.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Sequence, Tuple

SEED_X_TRAINABLE_PATTERNS: Tuple[str, ...] = (
    r".*lora_[ab]$",                     # LoRA factors
    r".*input_layernorm.*",              # modules_to_save layer norms
    r".*post_attention_layernorm.*",
    r"(.*\.)?llm\.norm\..*",             # the final norm (JAX model/norm)
    r".*embed_tokens.*",                 # resized embeddings re-enabled
    r".*lm_head.*",
    r".*input_resampler.*",              # agent resamplers train fully
    r".*output_resampler.*",
    r".*patch_pos_embed.*",
)


def path_labels(names: Iterable[str], trainable_patterns: Sequence[str]
                = SEED_X_TRAINABLE_PATTERNS) -> Dict[str, str]:
    """{state name: "trainable" | "frozen"}: trainable where the name
    matches any pattern."""
    regexes = [re.compile(p) for p in trainable_patterns]
    return {n: "trainable" if any(r.match(n) for r in regexes) else "frozen"
            for n in names}


def split_params(state: Mapping[str, object], labels: Mapping[str, str]
                 ) -> Tuple[Dict[str, object], Dict[str, object]]:
    """-> (trainable, frozen) sub-dicts of ``state``."""
    train = {k: v for k, v in state.items() if labels[k] == "trainable"}
    frozen = {k: v for k, v in state.items() if labels[k] == "frozen"}
    return train, frozen


def count_params(state: Mapping[str, object]) -> int:
    return sum(int(v.numel()) for v in state.values())
