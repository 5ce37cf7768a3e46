"""Dataset builders mirroring the reference's datapipe factories (a copy of
seedx_tpu/data/datasets.py, so the port imports nothing of the JAX
package; keep the two identical).

  * ``build_caption_datapipes_with_pixels``
    (reference: src/data/image_text_pairs_clm.py:533-613) — webdataset tar
    shards of image-text pairs, similarity filtering, anyres tiling,
    img-first/img-last caption encoding,
  * ``build_llava_jsonl_datapipes`` (reference: src/data/sft_clm.py:378-449)
    — LLaVA-style multi-turn conversations with one image,
  * ``build_single_turn_edit_datapipes`` (reference: sft_clm.py:673-745)
    — source/target edit pairs,
  * ``build_multi_datapipes`` (reference: sft_clm.py:55-71) — weighted mix.

Each builder returns an iterator of collated, STATIC-shape numpy batches
(``train_sft.train_loop`` moves them to the device).  Every sample stream
is per-host sharded; decode errors drop the sample with a warning
(reference behaviour, SURVEY.md §4.3).
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from seedx_tpu_torch.data import encoding
from seedx_tpu_torch.data.anyres import (grid_pinpoints_from_strings,
                                         process_anyres_image)
from seedx_tpu_torch.data.pipeline import (batched, collate_anyres,
                                           cycle_files, read_jsonl,
                                           read_tar_shards_multi, shard_files,
                                           shuffle_stream, weighted_mix)

logger = logging.getLogger(__name__)


def _max_tiles(resolution_grids: Sequence[str]) -> int:
    """Max anyres tiles per image (+1 thumbnail)."""
    best = 1
    for g in resolution_grids:
        a, b = g.split("x")
        best = max(best, int(a) * int(b))
    return best + 1


def _list_files(data_dir, pattern: str) -> List[str]:
    dirs = data_dir if isinstance(data_dir, (list, tuple)) else [data_dir]
    files: List[str] = []
    for d in dirs:
        if os.path.isfile(d):
            files.append(d)
        else:
            files.extend(sorted(glob.glob(os.path.join(d, pattern))))
    return files


def _passes_similarity(metadata_str: str, similarity_thr: float) -> bool:
    """(reference: sft_clm.py:95-120)"""
    try:
        metadata = json.loads(metadata_str or "{}")
    except json.JSONDecodeError:
        return True
    if "all_similarities" in metadata:
        sim = max(metadata["all_similarities"])
    else:
        sim = (metadata.get("similarity") or metadata.get("score")
               or metadata.get("SCORE"))
    return sim is None or sim >= similarity_thr


def _render_pdf_page(path: str):
    """First PDF page -> PIL image (reference: sft_clm.py:175-185; requires
    pymupdf, which is optional — samples are skipped with a warning when it
    is absent, matching the reference's fitz-missing behaviour)."""
    try:
        import fitz  # pymupdf
    except ImportError as e:
        raise RuntimeError("pymupdf (fitz) not installed; skipping pdf "
                           "sample") from e
    from PIL import Image

    pages = fitz.open(path)
    pix = pages[0].get_pixmap(matrix=fitz.Matrix(1, 1))
    return Image.frombytes("RGB", (pix.width, pix.height), pix.samples)


def _check_image(image, min_resolution: int, min_aspect_ratio: float) -> bool:
    w, h = image.size
    if w < min_resolution or h < min_resolution:
        return False
    ar = h / w
    return min_aspect_ratio <= ar <= 1.0 / min_aspect_ratio


def build_caption_datapipes_with_pixels(
    data_dir,
    tokenizer=None,
    image_transform=None,
    max_length: int = 260,
    batch_size: int = 8,
    similarity_thr: float = 0.1,
    min_resolution: int = 400,
    min_aspect_ratio: float = 0.6,
    instruction_prompt: str = "[INST] {instruction} [/INST]\n",
    add_gen_prompt: bool = False,
    img_first_ratio: float = 0.5,
    num_img_in_tokens: int = 64,
    num_img_out_tokens: int = 64,
    cycle_count: int = 1,
    multi_resolution: bool = True,
    resolution_grids: Sequence[str] = ("1x1",),
    base_resolution: int = 448,
    dataset_name: Optional[str] = None,
    seed: int = 42,
    use_caption_in_metadata: bool = False,
    caption_key_in_metadata: str = "top_caption",
    assure_text: bool = True,
    **unused,
) -> Iterator[Dict[str, np.ndarray]]:
    files = shard_files(_list_files(data_dir, "*.tar"))
    pinpoints = grid_pinpoints_from_strings(resolution_grids, base_resolution)
    rng = np.random.default_rng(seed)
    max_images = batch_size * _max_tiles(resolution_grids)

    def samples():
        shard_order = list(cycle_files(files, cycle_count, seed))
        for raw in read_tar_shards_multi(shard_order):
            image = raw.get("images")
            if image is None:
                continue
            if use_caption_in_metadata:
                try:
                    caption = json.loads(
                        raw.get("metadata", "{}"))[caption_key_in_metadata]
                except (KeyError, json.JSONDecodeError):
                    continue
            else:
                caption = raw.get("text")
            if assure_text and not caption:
                continue
            if not _passes_similarity(raw.get("metadata", "{}"),
                                      similarity_thr):
                continue
            if not _check_image(image, min_resolution, min_aspect_ratio):
                continue
            try:
                tiles, patch_pos = process_anyres_image(
                    image, image_transform, pinpoints, base_resolution)
            except Exception as e:
                logger.warning("anyres decode failed: %s", e)
                continue
            enc = encoding.encode_caption_sample(
                caption, tokenizer, max_length=max_length,
                img_first_ratio=img_first_ratio,
                num_img_in_tokens=num_img_in_tokens,
                num_img_out_tokens=num_img_out_tokens,
                patch_length=len(tiles), rng=rng,
                instruction_prompt=instruction_prompt,
                add_gen_prompt=add_gen_prompt)
            enc["images"] = tiles
            enc["patch_positions"] = patch_pos
            yield enc

    stream = shuffle_stream(samples(), buffer_size=64, seed=seed)
    for batch in batched(stream, batch_size):
        yield collate_anyres(batch, max_images, base_resolution)


def build_llava_jsonl_datapipes(
    data_dir,
    image_dir: str,
    tokenizer=None,
    image_transform=None,
    max_length: int = 880,
    batch_size: int = 2,
    min_resolution: int = 400,
    min_aspect_ratio: float = 0.666,
    instruction_prompt: str = "[INST] {instruction} [/INST]\n",
    turn_sep: str = "\n",
    system_message: str = "",
    num_img_in_tokens: int = 64,
    num_img_out_tokens: int = 64,
    cycle_count: int = 1,
    multi_resolution: bool = True,
    resolution_grids: Sequence[str] = ("1x1",),
    base_resolution: int = 448,
    dataset_name: Optional[str] = None,
    seed: int = 42,
    **unused,
) -> Iterator[Dict[str, np.ndarray]]:
    from PIL import Image

    files = shard_files(_list_files(data_dir, "*.jsonl"))
    pinpoints = grid_pinpoints_from_strings(resolution_grids, base_resolution)
    rng = np.random.default_rng(seed)
    max_images = batch_size * _max_tiles(resolution_grids)

    def samples():
        for path in cycle_files(files, cycle_count, seed):
            for value in read_jsonl(path):
                turns = value.get("data")
                if not turns:
                    continue
                tiles = patch_pos = None
                image_name = value.get("image") or ""
                if image_name and "null" not in image_name and \
                        image_name != "none":
                    try:
                        path = os.path.join(image_dir,
                                            image_name.lstrip("/"))
                        if path.endswith(".pdf"):
                            image = _render_pdf_page(path)
                        else:
                            image = Image.open(path).convert("RGB")
                        tiles, patch_pos = process_anyres_image(
                            image, image_transform, pinpoints,
                            base_resolution)
                    except Exception as e:
                        logger.warning("image decode failed: %s", e)
                        continue
                enc = encoding.encode_conversation_sample(
                    turns, tokenizer, max_length=max_length,
                    patch_length=0 if tiles is None else len(tiles),
                    num_img_in_tokens=num_img_in_tokens,
                    instruction_prompt=instruction_prompt,
                    turn_sep=turn_sep, system_message=system_message, rng=rng)
                if enc is None:
                    continue
                enc["images"] = tiles
                enc["patch_positions"] = patch_pos
                yield enc

    stream = shuffle_stream(samples(), buffer_size=64, seed=seed)
    for batch in batched(stream, batch_size):
        yield collate_anyres(batch, max_images, base_resolution)


def build_single_turn_edit_datapipes(
    data_dir,
    image_dir: str,
    tokenizer=None,
    image_transform=None,
    max_length: int = 320,
    batch_size: int = 6,
    min_resolution: int = 400,
    min_aspect_ratio: float = 0.6,
    instruction_prompt: str = "[INST] {instruction} [/INST]\n",
    prompt_drop_ratio: float = 0.0,
    use_polite_response: bool = True,
    num_img_in_tokens: int = 64,
    num_img_out_tokens: int = 64,
    cycle_count: int = 1,
    multi_resolution: bool = True,
    resolution_grids: Sequence[str] = ("1x1",),
    base_resolution: int = 448,
    dataset_name: Optional[str] = None,
    seed: int = 42,
    **unused,
) -> Iterator[Dict[str, np.ndarray]]:
    from PIL import Image

    files = shard_files(_list_files(data_dir, "*.jsonl"))
    pinpoints = grid_pinpoints_from_strings(resolution_grids, base_resolution)
    rng = np.random.default_rng(seed)
    max_images = batch_size * 2 * _max_tiles(resolution_grids)

    def samples():
        for path in cycle_files(files, cycle_count, seed):
            for value in read_jsonl(path):
                if not all(k in value for k in
                           ("source_image", "target_image", "instruction")):
                    continue
                try:
                    src = Image.open(os.path.join(
                        image_dir, value["source_image"])).convert("RGB")
                    tgt = Image.open(os.path.join(
                        image_dir, value["target_image"])).convert("RGB")
                except Exception as e:
                    logger.warning("edit image decode failed: %s", e)
                    continue
                if not _check_image(src, min_resolution, min_aspect_ratio):
                    continue
                src_tiles, src_pos = process_anyres_image(
                    src, image_transform, pinpoints, base_resolution)
                tgt_tiles, tgt_pos = process_anyres_image(
                    tgt, image_transform, pinpoints, base_resolution)
                enc = encoding.encode_edit_sample(
                    value.get("instruction_new", value["instruction"]),
                    tokenizer, max_length=max_length,
                    source_patch_length=len(src_tiles),
                    target_patch_length=len(tgt_tiles),
                    response=value.get("response"),
                    use_polite_response=use_polite_response,
                    prompt_drop_ratio=prompt_drop_ratio,
                    num_img_in_tokens=num_img_in_tokens,
                    num_img_out_tokens=num_img_out_tokens,
                    instruction_prompt=instruction_prompt, rng=rng)
                enc["images"] = np.concatenate([src_tiles, tgt_tiles])
                enc["patch_positions"] = np.concatenate([src_pos, tgt_pos])
                yield enc

    stream = shuffle_stream(samples(), buffer_size=64, seed=seed)
    for batch in batched(stream, batch_size):
        yield collate_anyres(batch, max_images, base_resolution)


def build_multi_datapipes(datapipes: Sequence[Any], tokenizer=None,
                          image_transform=None,
                          sample_weights: Optional[Sequence[float]] = None,
                          seed: int = 42) -> Iterator[Dict[str, np.ndarray]]:
    """Weighted mixture of lazily-instantiated dataset configs
    (reference: sft_clm.py:55-71 — hydra instantiation + SampleMultiplexer
    with seed 42 + rank)."""
    from seedx_tpu_torch.config import instantiate

    if sample_weights is None:
        sample_weights = [1.0] * len(datapipes)
    streams = [
        instantiate(dp, tokenizer=tokenizer, image_transform=image_transform)
        for dp in datapipes
    ]
    return weighted_mix(streams, sample_weights, seed=seed)
