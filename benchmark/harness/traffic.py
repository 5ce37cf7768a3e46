"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``benchmark/traffic/<name>.json``) gives a distribution for each
size a request has; the cell gives the rate (Poisson arrivals; none: the
closed loop) and the run its seed and its window.  Every seed gets
the same set of sizes and the same set of gaps between arrivals, taken
at evenly spaced quantiles of each distribution, and a seed orders them
in blocks of ``mix["block"]`` requests: each block holds one value from
each of that many quantile bands (one image of each grid), in an order
the seed draws.  So a seed changes the order of the work and the
contents of the prompts, never the amount, nor how it is spread over the
window: runs with different seeds spread no more than runs of one seed.

A mix: ``{"sizes": {name: distribution, ...}, "image": {...}}``; each
request gets one value of every size (e.g. ``question_tokens``,
``output_tokens``).  Distributions (each clipped to ``[min, max]`` and
rounded to an int):
``{"kind": "lognormal", "median": m, "sigma": s}``,
``{"kind": "uniform", "min": a, "max": b}``,
``{"kind": "fixed", "value": v}``.  Images: ``{"grids": ["1x1", ...],
"base": 448}``, each grid taken an equal share of the requests.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """``n`` values of ``dist`` at the quantiles (i + 0.5) / n, clipped
    and rounded, ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["kind"]
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    elif kind == "fixed":
        x = np.full(n, float(dist["value"]))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    lo, hi = dist.get("min", -math.inf), dist.get("max", math.inf)
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1),
                                  sum(map(ord, stream)) * 7919])


def in_blocks(vals, block: int, order: np.random.Generator,
              bands=None) -> list:
    """``vals`` reordered so that every run of ``block`` consecutive items
    takes one item from each of ``block`` bands of the sorted values (or
    of the given ``bands``), the bands and each run shuffled by
    ``order``."""
    if bands is None:
        vals = sorted(vals)
        n = len(vals)
        bands = [vals[k * n // block:(k + 1) * n // block]
                 for k in range(block)]
    for b in bands:
        order.shuffle(b)
    out = []
    for j in range(max(len(b) for b in bands)):
        run = [b[j] for b in bands if j < len(b)]
        order.shuffle(run)
        out += run
    return out


def generate(mix: Dict, seed: int, seconds: float, rate: float = 0.0
             ) -> List[Dict]:
    """The requests of one run.  Open loop (``rate`` > 0): every request
    due inside the window, each with ``due`` (s from the window's start);
    closed loop (``rate`` 0): ``mix["closed_requests"]`` requests in
    order, ``due`` None.  Each request carries ``index``, a value of every
    size the mix defines, and ``grid`` (e.g. "2x1") with images."""
    if rate > 0:
        n = max(1, int(round(rate * seconds)))
    else:
        n = int(mix["closed_requests"])
    order = rng_for(seed, "order")
    block = int(mix.get("block", 1))
    reqs = [{"index": i} for i in range(n)]
    for key, dist in sorted(mix.get("sizes", {}).items()):
        for r, v in zip(reqs, in_blocks(quantiles(dist, n).tolist(), block,
                                        order)):
            r[key] = int(v)
    if "image" in mix:
        grids = list(mix["image"]["grids"])
        per = [[g] * len(range(k, n, len(grids))) for k, g in enumerate(grids)]
        for r, g in zip(reqs, in_blocks(None, block, order, per)):
            r["grid"] = g
    if rate > 0:
        u = (np.arange(n) + 0.5) / n
        gaps = np.asarray(in_blocks((-np.log1p(-u) / rate).tolist(), block,
                                    order))
        due = np.cumsum(gaps) - gaps[0]
        keep = []
        for r, d in zip(reqs, due):
            if d < seconds:
                r["due"] = float(d)
                keep.append(r)
        reqs = keep
    else:
        for r in reqs:
            r["due"] = None
    return reqs


def grid_size(grid: str, base: int):
    """'2x1' -> (width, height) in pixels (the runtime's grid strings)."""
    a, b = grid.split("x")
    return int(a) * base, int(b) * base


def make_image(seed: int, key: str, width: int, height: int) -> np.ndarray:
    """A uint8 [height, width, 3] image: a coarse random colour grid
    upsampled (bicubic), so the resizes see real structure."""
    from PIL import Image

    rng = rng_for(seed, "image" + key)
    coarse = rng.integers(0, 256, (max(1, height // 32), max(1, width // 32),
                                   3), dtype=np.uint8)
    return np.asarray(Image.fromarray(coarse).resize((width, height),
                                                     Image.BICUBIC))


def token_ids(seed: int, index: int, n: int, low: int, high: int
              ) -> List[int]:
    """``n`` text token ids in [low, high) for request ``index``."""
    rng = rng_for(seed, f"tokens{index}")
    return rng.integers(low, high, size=n).tolist()
