"""Synthetic SFT data on disk for the port's data and CLI tests
(``tests/test_torch_datasets.py``, ``test_torch_native_io.py``,
``test_torch_train_cli.py``), in the formats the dataset builders read:
webdataset tar shards of jpg + txt + json captions, a LLaVA jsonl with an
image dir, and an edit jsonl with source / target images.  Every file is
drawn from ``np.random.default_rng(seed)``.

Some samples are there to be dropped: captions below the similarity
threshold, images below ``min_resolution`` or outside the aspect range,
a conversation whose image file is missing.
"""

import io
import json
import os
import tarfile

import numpy as np
import yaml
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTIONS = ("a red bicycle by a white fence", "two cats on a chair",
            "a bowl of ramen with egg", "a snowy mountain above a lake",
            "an old lighthouse in a storm", "a child with a yellow kite")
TURNS = (["What is in the picture?", "A harbour with small boats at dawn.",
          "What colour are the boats?", "Red, blue and white."],
         ["Describe the scene.", "A street market under striped awnings."])


def image_bytes(rng, w: int, h: int, fmt: str = "JPEG") -> bytes:
    arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_caption_shards(root: str, seed: int = 0, shards: int = 2,
                         per_shard: int = 6, sizes=None) -> str:
    """``root/webdataset/{i:05d}.tar``: per sample ``key.jpg``,
    ``key.txt`` and ``key.json`` ({"similarity": s}); every fourth sample
    fails the 0.1 similarity threshold, every fifth image is 300 px wide
    (under ``min_resolution`` 400).  Returns the shard directory."""
    rng = np.random.default_rng(seed)
    out = os.path.join(root, "webdataset")
    os.makedirs(out, exist_ok=True)
    for s in range(shards):
        with tarfile.open(os.path.join(out, f"{s:05d}.tar"), "w") as tf:
            for i in range(per_shard):
                n = s * per_shard + i
                key = f"s{s:02d}_{i:04d}"
                w, h = ((300, 420) if n % 5 == 4 else
                        (sizes[n % len(sizes)] if sizes
                         else (int(rng.integers(420, 520)),
                               int(rng.integers(420, 520)))))
                _add(tf, f"{key}.jpg", image_bytes(rng, w, h))
                _add(tf, f"{key}.txt",
                     CAPTIONS[n % len(CAPTIONS)].encode())
                sim = 0.05 if n % 4 == 3 else float(rng.uniform(0.2, 0.4))
                _add(tf, f"{key}.json",
                     json.dumps({"similarity": sim}).encode())
    return out


def write_llava(root: str, seed: int = 1, n: int = 6,
                sizes=((600, 450), (448, 448), (900, 448))) -> tuple:
    """``root/llava/conv.jsonl`` + ``root/llava/images``: n conversations,
    each with one image of ``sizes`` (cycled); the third names a missing
    image (dropped with a warning).  Returns (jsonl dir, image dir)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "llava")
    img_dir = os.path.join(base, "images")
    os.makedirs(img_dir, exist_ok=True)
    lines = []
    for i in range(n):
        name = f"img_{i}.jpg"
        if i == 2:
            name = "missing.jpg"
        else:
            w, h = sizes[i % len(sizes)]
            with open(os.path.join(img_dir, name), "wb") as f:
                f.write(image_bytes(rng, w, h))
        lines.append({"image": name, "data": list(TURNS[i % len(TURNS)])})
    jsonl_dir = os.path.join(base, "annotations")
    os.makedirs(jsonl_dir, exist_ok=True)
    with open(os.path.join(jsonl_dir, "conv.jsonl"), "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
        f.write("{not json\n")
    return jsonl_dir, img_dir


def write_edit(root: str, seed: int = 2, n: int = 6,
               name: str = "edit") -> tuple:
    """``root/<name>/annotations/edit.jsonl`` + images: n source / target
    pairs with an instruction; the fourth source is 300 px (dropped by
    ``min_resolution``), the fifth lacks its instruction.  Returns
    (jsonl dir, image dir)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, name)
    img_dir = os.path.join(base, "images")
    os.makedirs(img_dir, exist_ok=True)
    lines = []
    for i in range(n):
        src, tgt = f"src_{i}.jpg", f"tgt_{i}.jpg"
        w, h = (300, 420) if i == 3 else (int(rng.integers(420, 520)),
                                          int(rng.integers(420, 520)))
        for fname in (src, tgt):
            with open(os.path.join(img_dir, fname), "wb") as f:
                f.write(image_bytes(rng, w, h))
        rec = {"source_image": src, "target_image": tgt,
               "instruction": f"make the sky {['red', 'green'][i % 2]}"}
        if i == 4:
            del rec["instruction"]
        lines.append(rec)
    jsonl_dir = os.path.join(base, "annotations")
    os.makedirs(jsonl_dir, exist_ok=True)
    with open(os.path.join(jsonl_dir, "edit.jsonl"), "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    return jsonl_dir, img_dir


def data_yamls(root: str) -> dict:
    """The repo's two data YAMLs with only ``data_dir`` / ``image_dir``
    rewritten to files written under ``root``; every other value as
    published.  Returns {"comprehension_gen": path, "edit": path}."""
    shards = write_caption_shards(root)
    conv_dir, conv_img = write_llava(root)
    out = {}
    with open(os.path.join(REPO, "configs/data/sft_comprehension_gen.yaml")
              ) as f:
        cfg = yaml.safe_load(f)
    llava, caption = cfg["datapipes"]
    llava.update(data_dir=conv_dir, image_dir=conv_img)
    caption.update(data_dir=[shards])
    out["comprehension_gen"] = os.path.join(root, "sft_comprehension_gen.yaml")
    with open(out["comprehension_gen"], "w") as f:
        yaml.safe_dump(cfg, f)
    with open(os.path.join(REPO, "configs/data/sft_edit.yaml")) as f:
        cfg = yaml.safe_load(f)
    for i, dp in enumerate(cfg["datapipes"]):
        ann, img = write_edit(root, seed=10 + i, name=f"edit{i}")
        dp.update(data_dir=[ann], image_dir=img)
    out["edit"] = os.path.join(root, "sft_edit.yaml")
    with open(out["edit"], "w") as f:
        yaml.safe_dump(cfg, f)
    return out
