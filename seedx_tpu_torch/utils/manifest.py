"""Converter manifests (reference: seedx_tpu/utils/manifest.py, whose six
JSON files ``utils/manifests/`` copies byte for byte) — expected key /
shape schemas of the released SEED-X checkpoints, validated BEFORE
conversion so a wrong / renamed / truncated artifact fails loudly with a
diff instead of silently zero-filling params.

The reference loads checkpoints with ``strict=False`` + a printed count
(adapter_modules.py:59-66, seed_x.py:225-234, peft_models.py:96-106); here
the expected key sets are pinned as JSON manifests generated from the
reference torch modules at full geometry on the meta device
(scripts/gen_manifests.py) — the day the released 17B artifacts are on
disk, `validate_state_dict` proves the files match what the converters
were built for, before any of the 17B floats move.

Manifest JSON schema (utils/manifests/<name>.json):
  {"keys": {key: [shape...]},   # required keys with exact shapes
   "optional": [key...],        # may be present (e.g. UNet to_k/to_v deltas)
   "ignored": [key...]}         # deliberately skipped by converters
                                # (deterministic buffers recomputed here)

Names: qwen_vit, llm, agent, detokenizer, sdxl_unet, sdxl_vae.

``num_layers`` holds a depth-cut model (the first ``n`` layers of the
13B or of ViT-bigG) to the manifest's keys of those layers: keys of
deeper layers (``layers.N.``, ``resblocks.N.``) are neither required
nor reported.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

_MANIFEST_DIR = os.path.join(os.path.dirname(__file__), "manifests")

MANIFEST_NAMES = ("qwen_vit", "llm", "agent", "detokenizer",
                  "sdxl_unet", "sdxl_vae")


def load_manifest(name: str) -> Dict[str, Any]:
    path = os.path.join(_MANIFEST_DIR, name + ".json")
    with open(path) as f:
        m = json.load(f)
    m.setdefault("optional", [])
    m.setdefault("ignored", [])
    return m


@dataclasses.dataclass
class ManifestReport:
    name: str
    missing: List[str]
    unexpected: List[str]
    mismatched: List[Tuple[str, Sequence[int], Sequence[int]]]  # key, got, want
    n_checked: int = 0

    @property
    def ok(self) -> bool:
        return not (self.missing or self.unexpected or self.mismatched)

    def summary(self, max_items: int = 8) -> str:
        if self.ok:
            return (f"[{self.name}] OK — {self.n_checked} keys match the "
                    f"release manifest")
        lines = [f"[{self.name}] MANIFEST MISMATCH "
                 f"({len(self.missing)} missing, {len(self.unexpected)} "
                 f"unexpected, {len(self.mismatched)} shape-mismatched "
                 f"of {self.n_checked} expected):"]
        for k in self.missing[:max_items]:
            lines.append(f"  missing    {k}")
        for k in self.unexpected[:max_items]:
            lines.append(f"  unexpected {k}")
        for k, got, want in self.mismatched[:max_items]:
            lines.append(f"  shape      {k}: file {list(got)} != "
                         f"manifest {list(want)}")
        return "\n".join(lines)


_LAYER = re.compile(r"(?:^|\.)(?:layers|resblocks)\.(\d+)\.")


def deeper_layer(key: str, num_layers: Optional[int]) -> bool:
    """Whether ``key`` belongs to a layer at or past ``num_layers``."""
    m = _LAYER.search(key)
    return (num_layers is not None and m is not None
            and int(m.group(1)) >= num_layers)


def validate_state_dict(sd: Mapping[str, Any], name: str,
                        extra_optional: Sequence[str] = (),
                        num_layers: Optional[int] = None) -> ManifestReport:
    """Check a loaded torch state dict against the release manifest.

    ``sd`` values only need a ``.shape`` (numpy arrays, torch tensors, or
    meta tensors all work).  ``extra_optional`` adds glob patterns whose
    matches are tolerated in either direction (e.g. a stage checkpoint that
    also carries optimizer state the converters ignore).
    """
    m = load_manifest(name)
    want = {k: s for k, s in m["keys"].items()
            if not deeper_layer(k, num_layers)}
    optional = set(m["optional"])
    ignored = set(m["ignored"])

    def _tolerated(k: str) -> bool:
        return (k in optional or k in ignored or deeper_layer(k, num_layers)
                or any(fnmatch.fnmatch(k, pat) for pat in extra_optional))

    missing = [k for k in want if k not in sd]
    unexpected = [k for k in sd if k not in want and not _tolerated(k)]
    mismatched = []
    for k, shape in want.items():
        if k in sd and list(getattr(sd[k], "shape", ())) != list(shape):
            mismatched.append((k, tuple(getattr(sd[k], "shape", ())),
                               tuple(shape)))
    return ManifestReport(name=name, missing=sorted(missing),
                          unexpected=sorted(unexpected),
                          mismatched=sorted(mismatched),
                          n_checked=len(want))


def validate_or_raise(sd: Mapping[str, Any], name: str,
                      extra_optional: Sequence[str] = (),
                      num_layers: Optional[int] = None) -> ManifestReport:
    rep = validate_state_dict(sd, name, extra_optional=extra_optional,
                              num_layers=num_layers)
    if not rep.ok:
        raise ValueError(rep.summary())
    return rep
