"""Any-resolution image tiling, pure numpy/PIL (a copy of the pieces of
seedx_tpu/data/anyres.py the port uses, so it imports nothing of the JAX
package; keep the two identical).

Functional port of the reference's anyres logic (src/data/any_res.py):
pick the best grid by both criteria (max effective resolution,
any_res.py:10-37; closest aspect ratio, :39-68) and take the smaller-area
winner (:176-182); resize (:71-108); base-size tiles plus a global
thumbnail (:159-210); per-tile normalized center coordinates (:202-208).
Output is NHWC float32.
"""

from __future__ import annotations

import ast
from typing import Callable, List, Sequence, Tuple

import numpy as np
from PIL import Image


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]
                           ) -> Tuple[int, int]:
    """Max-effective-resolution criterion (reference: any_res.py:10-37)."""
    ow, oh = original_size
    best, max_eff, min_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (w, h)
    return best


def select_best_resolution_v2(original_size: Tuple[int, int],
                              possible_resolutions: Sequence[Tuple[int, int]]
                              ) -> Tuple[int, int]:
    """Closest-aspect-ratio criterion (reference: any_res.py:39-68)."""
    ow, oh = original_size
    o_aspect = oh / ow
    o_area = ow * oh
    best, min_ar, min_area = None, float("inf"), float("inf")
    for w, h in possible_resolutions:
        aspect = h / w
        area = w * h
        ar_diff = max(aspect, o_aspect) / min(aspect, o_aspect)
        area_ratio = max(area, o_area) / min(area, o_area)
        if ar_diff < min_ar or (ar_diff == min_ar and area_ratio < min_area):
            min_ar, min_area, best = ar_diff, area_ratio, (w, h)
    return best


def pick_resolution(original_size, possible_resolutions) -> Tuple[int, int]:
    """Both criteria, smaller-area winner (reference: any_res.py:176-182)."""
    w1, h1 = select_best_resolution(original_size, possible_resolutions)
    w2, h2 = select_best_resolution_v2(original_size, possible_resolutions)
    return (w2, h2) if w1 * h1 > w2 * h2 else (w1, h1)


def resize_and_pad_image(image: Image.Image, target: Tuple[int, int],
                         keep_ratio: bool = False) -> Image.Image:
    """Resize to ``target`` (w, h); with ``keep_ratio`` fit inside it and
    center on black (reference anyres.py:64; any_res.py:71-108)."""
    ow, oh = image.size
    tw, th = target
    if not keep_ratio:
        return image.resize((tw, th))
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(int(np.ceil(oh * scale_w)), th)
    else:
        nh, nw = th, min(int(np.ceil(ow * scale_h)), tw)
    resized = image.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(image: Image.Image,
                      patch_size: int) -> List[Image.Image]:
    """Row-major tiles (reference: any_res.py:111-130)."""
    patches = []
    w, h = image.size
    for top in range(0, h, patch_size):
        for left in range(0, w, patch_size):
            patches.append(image.crop((left, top,
                                       left + patch_size, top + patch_size)))
    return patches


def grid_pinpoints_from_strings(resolution_grids: Sequence[str],
                                base_resolution: int) -> List[List[int]]:
    """'2x1' -> [2*base, 1*base] (reference:
    eval_img2text_seed_x_i.py:125-129)."""
    out = []
    for scale in resolution_grids:
        s1, s2 = scale.split("x")
        out.append([int(s1) * base_resolution, int(s2) * base_resolution])
    return out


def anyres_grid_shape(image_size, grid_pinpoints, patch_size
                      ) -> Tuple[int, int]:
    """(columns, rows) of tiles an image of ``image_size`` (w, h) is cut
    into (reference anyres.py:103; any_res.py:133-155); ``grid_pinpoints``
    a list or its string form."""
    if not isinstance(grid_pinpoints, (list, tuple)):
        grid_pinpoints = ast.literal_eval(grid_pinpoints)
    w, h = pick_resolution(image_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def process_anyres_image(image: Image.Image,
                         image_transform: Callable[[Image.Image], np.ndarray],
                         grid_pinpoints, base_image_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Tiles + thumbnail + per-tile center coords (reference:
    any_res.py:159-210): images [n_tiles + 1, H, W, 3] float32 (thumbnail
    last), patch_pos [n_tiles + 1, 2] float32 (thumbnail at (0.5, 0.5))."""
    best = pick_resolution(image.size, grid_pinpoints)
    patches = divide_to_patches(resize_and_pad_image(image, best),
                                base_image_size)
    thumbnail = image.resize((base_image_size, base_image_size))
    tensors = [image_transform(p) for p in patches + [thumbnail]]

    gw, gh = best[0] // base_image_size, best[1] // base_image_size
    x_idx = (np.tile(np.arange(gw), (gh, 1)) + 0.5) / gw
    y_idx = (np.tile(np.arange(gh)[:, None], (1, gw)) + 0.5) / gh
    patch_pos = np.stack([x_idx, y_idx], axis=-1).reshape(-1, 2)
    patch_pos = np.concatenate([patch_pos, np.array([[0.5, 0.5]])], axis=0)
    return (np.stack(tensors, 0).astype(np.float32),
            patch_pos.astype(np.float32))
