"""Host-side streaming input pipeline (a copy of
seedx_tpu/data/pipeline.py, so the port imports nothing of the JAX
package; keep the two identical but for the host rank, which comes from
``torch.distributed``).

Replaces the reference's torchdata DataLoader2 stack (DistributedReadingService
+ MultiProcessingReadingService + SampleMultiplexer; reference:
src/train/train_seed_x_sft.py:78-85, src/data/sft_clm.py:55-71,428-446) with
plain composable iterators:

  * ``read_jsonl`` / ``read_tar_shards`` — robust readers that swallow corrupt
    lines/shards with a warning instead of killing a multi-day run
    (reference: src/data/datapipes.py:15-61); ``read_tar_shards_multi``
    takes the native C++ reader (``data/native``) when it builds,
  * ``shard_files`` — per-host file sharding (the DistributedReadingService
    analogue: each process reads its own files),
  * ``shuffle_stream`` / ``cycle_files`` / ``weighted_mix`` — buffered shuffle,
    epoch cycling, and the SampleMultiplexer analogue with a per-host seed,
  * ``collate_anyres`` — fixed-shape batch packing: image slots are padded to
    a static per-batch maximum (reference: src/data/any_res.py:217-250 pads
    text only),
  * ``ThreadPrefetcher`` — background decode/prefetch (the
    MultiProcessingReadingService analogue; decode is PIL/numpy so threads
    suffice — no pickling tax),
  * ``ResumableIterator`` — fast-forwards a deterministic stream for an
    exact data resume.
"""

from __future__ import annotations

import io
import json
import logging
import queue as queue_mod
import tarfile
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_jsonl(path: str) -> Iterator[Dict]:
    """Best-effort jsonl line parser (reference: datapipes.py:47-61)."""
    try:
        with open(path, "r") as f:
            for line_no, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError as e:
                    logger.warning("skipping bad json line %s:%d: %s",
                                   path, line_no, e)
    except OSError as e:
        logger.warning("skipping unreadable jsonl %s: %s", path, e)


def read_tar_shards(path: str) -> Iterator[Dict[str, Any]]:
    """WebDataset-style tar reader: groups members by basename key, decodes
    .jpg/.png (PIL), .txt (str), .json (dict).  Corrupt shards are skipped
    with a warning (reference ``TarArchiveLoaderWoException``,
    datapipes.py:15-44)."""
    from PIL import Image

    def decode(name: str, data: bytes):
        if name.endswith((".jpg", ".jpeg", ".png", ".webp")):
            return "images", Image.open(io.BytesIO(data)).convert("RGB")
        if name.endswith(".txt"):
            return "text", data.decode("utf-8", errors="replace")
        if name.endswith((".json", ".metadata")):
            return "metadata", data.decode("utf-8", errors="replace")
        return None, None

    try:
        with tarfile.open(path, "r|*") as tf:
            current_key = None
            sample: Dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                base = member.name
                key, _, ext = base.partition(".")
                try:
                    data = tf.extractfile(member).read()
                except Exception as e:  # corrupt member
                    logger.warning("skipping corrupt tar member %s in %s: %s",
                                   base, path, e)
                    continue
                if key != current_key:
                    if sample.get("images") is not None or "text" in sample:
                        sample.setdefault("metadata", "{}")
                        sample["__key__"] = current_key
                        yield sample
                    current_key, sample = key, {}
                field, value = decode(base, data)
                if field:
                    try:
                        sample[field] = value
                    except Exception:
                        pass
            if sample.get("images") is not None or "text" in sample:
                sample.setdefault("metadata", "{}")
                sample["__key__"] = current_key
                yield sample
    except Exception as e:  # corrupt shard
        logger.warning("skipping corrupt tar shard %s: %s", path, e)


# ---------------------------------------------------------------------------
# stream combinators
# ---------------------------------------------------------------------------

def process_rank():
    """(index, count) of this process among the readers of different data
    (the JAX package's process index / count): on a mesh its coordinate
    over the batch axes (data x fsdp), so ``tensor`` peers, which are
    processes of their own here, read the same rows; else the
    ``torch.distributed`` rank and world size when a group is initialised,
    else (0, 1) (``parallel.distributed.batch_coordinate``)."""
    from seedx_tpu_torch.parallel.distributed import batch_coordinate

    return batch_coordinate()


def read_tar_shards_multi(paths, num_threads: int = 4,
                          native: bool = None) -> Iterator[Dict[str, Any]]:
    """Stream samples from MANY shards; uses the C++ threaded reader
    (data/native) when a toolchain is available, else chains the Python
    reader.  Sample grouping is per shard either way; cross-shard sample
    ORDER differs under the native reader (worker interleave), which the
    downstream buffered shuffle treats as free extra mixing."""
    paths = list(paths)
    if native is None:
        from seedx_tpu_torch.data import native as native_io

        native = native_io.available()
    if native:
        from seedx_tpu_torch.data.native import read_tar_shards_native

        yield from read_tar_shards_native(paths, num_threads=num_threads)
    else:
        for p in paths:
            yield from read_tar_shards(p)


def shard_files(files: Sequence[str], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[str]:
    """Round-robin file assignment to this host (default: this process's
    ``torch.distributed`` rank and world size, or (0, 1))."""
    if process_index is None:
        process_index, process_count = process_rank()
    return list(files)[process_index::max(1, process_count)]


def cycle_files(files: Sequence[str], cycle_count: int = 1,
                seed: int = 42) -> Iterator[str]:
    """Repeat the file list ``cycle_count`` times, reshuffled per epoch
    (the reference's shuffle->cycle->shuffle, sft_clm.py:428-433)."""
    rng = np.random.default_rng(seed)
    files = list(files)
    for _ in range(cycle_count):
        order = rng.permutation(len(files))
        for i in order:
            yield files[i]


def shuffle_stream(it: Iterable, buffer_size: int = 256,
                   seed: int = 0) -> Iterator:
    rng = np.random.default_rng(seed)
    buf: List[Any] = []
    for item in it:
        buf.append(item)
        if len(buf) >= buffer_size:
            idx = int(rng.integers(len(buf)))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def weighted_mix(streams: Sequence[Iterator], weights: Sequence[float],
                 seed: int = 42) -> Iterator:
    """SampleMultiplexer analogue (reference: sft_clm.py:55-71, seed
    42 + rank).  Exhausted streams drop out; ends when all are done."""
    rng = np.random.default_rng(seed + process_rank()[0])
    streams = [iter(s) for s in streams]
    weights = [float(w) for w in weights]
    alive = list(range(len(streams)))
    while alive:
        probs = np.asarray([weights[i] for i in alive])
        probs = probs / probs.sum()
        pick = alive[int(rng.choice(len(alive), p=probs))]
        try:
            yield next(streams[pick])
        except StopIteration:
            alive.remove(pick)


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


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

class ThreadPrefetcher:
    """Runs an iterator factory in a daemon thread, buffering ahead
    (MultiProcessingReadingService analogue, train_seed_x_sft.py:80-84).
    Kept for parity with the JAX package's API: neither package's
    ``train_loop`` wraps its stream in it; a caller may wrap a builder's
    iterator to decode ahead of the step."""

    _DONE = object()

    def __init__(self, iterator: Iterable, buffer_size: int = 4):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


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
