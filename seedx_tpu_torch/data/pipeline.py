"""Host-side batching for SFT (a copy of the batching, collation and
resume parts of seedx_tpu/data/pipeline.py, so the port imports nothing of
the JAX package; keep them identical).

  * ``batched`` groups samples,
  * ``collate_anyres`` packs samples into one static-shape batch: image
    slots padded to a per-batch maximum (reference: src/data/any_res.py:
    217-250 pads text only),
  * ``ResumableIterator`` fast-forwards a deterministic stream for an
    exact data resume.

The file readers, shuffling, mixing and prefetching of the JAX module (the
``train_sft.main`` datapipes) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np


def batched(it: Iterable, batch_size: int, drop_last: bool = True
            ) -> Iterator[List]:
    batch: List[Any] = []
    for item in it:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


def collate_anyres(batch: List[Dict[str, np.ndarray]], max_images: int,
                   image_size: int, vit_tokens_hw: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    """Pack samples into ONE static-shape batch.

    Text arrays stack [B, S].  Image tiles from all samples concatenate in
    sample order (the invariant the agent's rank-compaction relies on) and
    pad with zero tiles up to ``max_images``; the embeds masks pad False.
    """
    out: Dict[str, np.ndarray] = {}
    for key in ("input_ids", "attention_mask", "labels", "ids_gen_mask",
                "ids_cmp_mask"):
        out[key] = np.stack([b[key] for b in batch])

    images, patch_pos, e_gen, e_cmp = [], [], [], []
    for b in batch:
        imgs = b.get("images")
        if imgs is None or len(imgs) == 0:
            continue
        images.append(np.asarray(imgs, np.float32))
        pp = b.get("patch_positions")
        patch_pos.append(np.asarray(pp, np.float32) if pp is not None
                         else np.full((len(imgs), 2), 0.5, np.float32))
        e_gen.append(np.asarray(b["embeds_gen_mask"], bool))
        e_cmp.append(np.asarray(b["embeds_cmp_mask"], bool))

    n = sum(len(x) for x in images)
    if n > max_images:
        raise ValueError(f"batch has {n} image tiles > max_images={max_images}")
    pad = max_images - n
    zero_img = np.zeros((pad, image_size, image_size, 3), np.float32)
    out["images"] = (np.concatenate(images + [zero_img])
                     if images else zero_img)
    out["patch_positions"] = np.concatenate(
        patch_pos + [np.full((pad, 2), 0.5, np.float32)]) if patch_pos else \
        np.full((max_images, 2), 0.5, np.float32)
    out["embeds_gen_mask"] = np.concatenate(
        e_gen + [np.zeros(pad, bool)]) if e_gen else np.zeros(max_images, bool)
    out["embeds_cmp_mask"] = np.concatenate(
        e_cmp + [np.zeros(pad, bool)]) if e_cmp else np.zeros(max_images, bool)
    return out


class ResumableIterator:
    """Position-tracked stream wrapper for EXACT data resume.

    The reference has no dataloader state capture at all — resume just
    reseeds the datapipe per epoch, replaying already-seen samples
    (reference: src/train/train_seed_x_sft.py:242-269; SURVEY §5).  Here
    the trainer wraps its (deterministically seeded) stream in this
    iterator and, on resume, fast-forwards ``skip(step * accum)`` batches
    so training continues on exactly the data it would have seen —
    byte-identical streams given the same seeds.  ``skip`` consumes (and
    decodes) the skipped batches; for the reference-scale micro-batches
    that costs seconds per thousand steps, traded for exactness.
    """

    def __init__(self, it):
        self._it = iter(it)
        self.position = 0          # batches consumed from the source

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.position += 1
        return batch

    def skip(self, n: int) -> int:
        """Fast-forward ``n`` batches; returns how many were skipped
        (fewer if the stream ended)."""
        done = 0
        for _ in range(n):
            try:
                next(self._it)
            except StopIteration:
                break
            self.position += 1
            done += 1
        return done
