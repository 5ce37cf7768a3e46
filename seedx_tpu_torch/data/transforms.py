"""Host-side image transforms, numpy/PIL, NHWC float32 output (a copy of
seedx_tpu/data/transforms.py, so the port imports nothing of the JAX
package; keep the two identical).

Mirrors the reference's torchvision pipelines
(reference: src/processer/transforms.py:5-83): four types —
``clip`` (CLIP mean/std), ``clipa`` (ImageNet mean/std), ``clipb``
(square-pad + CLIP), ``sd`` ([-1, 1], the SDXL VAE's input).  Output
layout is NHWC, as in the JAX package, instead of torch's NCHW.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
from PIL import Image

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _resize(img: Image.Image, size: Tuple[int, int],
            resample=Image.BICUBIC) -> Image.Image:
    return img.resize(size, resample=resample)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _resize_shorter(img: Image.Image, size: int,
                    resample=Image.BICUBIC) -> Image.Image:
    w, h = img.size
    if w < h:
        return img.resize((size, int(round(h * size / w))), resample=resample)
    return img.resize((int(round(w * size / h)), size), resample=resample)


def _expand2square(img: Image.Image, fill) -> Image.Image:
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), fill)
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (arr - mean) / std


def get_transform(type: str = "clip", keep_ratio: bool = True,
                  image_size: int = 224) -> Callable[[Image.Image], np.ndarray]:
    """Returns PIL.Image -> float32 [H, W, 3]."""

    def apply(img: Image.Image) -> np.ndarray:
        img = img.convert("RGB")
        if type in ("clip", "clipa", "sd"):
            if keep_ratio:
                img = _resize_shorter(img, image_size)
                img = _center_crop(img, image_size)
            else:
                img = _resize(img, (image_size, image_size))
        elif type == "clipb":
            if keep_ratio:
                fill = tuple(int(x * 255) for x in CLIP_MEAN)
                img = _expand2square(img, fill)
            img = _resize(img, (image_size, image_size))
        else:
            raise NotImplementedError(type)

        arr = np.asarray(img, np.float32) / 255.0
        if type in ("clip", "clipb"):
            return _normalize(arr, CLIP_MEAN, CLIP_STD)
        if type == "clipa":
            return _normalize(arr, IMAGENET_MEAN, IMAGENET_STD)
        if type == "sd":
            return _normalize(arr, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
        raise NotImplementedError(type)

    return apply
