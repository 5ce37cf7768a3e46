"""Host-side image transforms, numpy/PIL, NHWC float32 output (a copy of
the ``clip`` and ``sd`` types of seedx_tpu/data/transforms.py, so the port
imports nothing of the JAX package; keep the two identical).

Mirrors the reference's torchvision pipelines (src/processer/transforms.py):
bicubic resize (or shorter-side resize + center crop with ``keep_ratio``),
scale to [0, 1], then CLIP mean/std (``clip``) or [-1, 1] (``sd``, the
SDXL VAE's input).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from PIL import Image

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def get_transform(type: str = "clip", keep_ratio: bool = True,
                  image_size: int = 224) -> Callable[[Image.Image], np.ndarray]:
    """PIL.Image -> float32 [H, W, 3].  ``type`` "clip" or "sd"; the JAX
    package's "clipa" and "clipb" are not ported."""
    if type not in ("clip", "sd"):
        raise NotImplementedError(f"transform type {type!r} is not ported")
    mean, std = ((CLIP_MEAN, CLIP_STD) if type == "clip"
                 else ((0.5,) * 3, (0.5,) * 3))

    def apply(img: Image.Image) -> np.ndarray:
        img = img.convert("RGB")
        if keep_ratio:
            w, h = img.size
            if w < h:
                size = (image_size, int(round(h * image_size / w)))
            else:
                size = (int(round(w * image_size / h)), image_size)
            img = img.resize(size, resample=Image.BICUBIC)
            w, h = img.size
            left, top = (w - image_size) // 2, (h - image_size) // 2
            img = img.crop((left, top, left + image_size, top + image_size))
        else:
            img = img.resize((image_size, image_size), resample=Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
        return ((arr - np.asarray(mean, np.float32))
                / np.asarray(std, np.float32))

    return apply
