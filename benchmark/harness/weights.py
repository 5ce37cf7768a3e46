"""Weights drawn from the run's seed, one leaf at a time by its name.

Every floating leaf of a module's state (a stacked ``[L, ...]`` leaf is
one leaf) is drawn by ``draw(seed, name, shape, dtype, device)``: a
generator on ``device`` seeded from the run's seed and the leaf's name,
normal values scaled as a freshly initialised model's are (norm scales
``1 + 0.1 n``, biases ``0.02 n``, kernels, tables and queries
``n * min(0.02, fan_in ** -0.5)``), rounded to the type the leaf is served
in.  The program's modules and the plain references name their leaves
alike, so both sides draw the same values, and neither takes a weight
from the other: the program quantizes what it is given, and the
reference quantizes again by its own rule.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterable, Tuple

import torch


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a leaf name."""
    digest = hashlib.blake2b(f"{int(seed)}:{name}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def leaf_std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(offset, scale) of the normal values of leaf ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return 1.0, 0.1
    if leaf == "bias":
        return 0.0, 0.02
    if leaf == "weight" and len(shape) == 4:       # conv [out, in, kh, kw]
        fan_in = shape[1] * shape[2] * shape[3]
    else:                                           # [..., in, out]
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 0.0, min(0.02, 1.0 / math.sqrt(fan_in))


def draw(seed: int, name: str, shape, dtype: torch.dtype,
         device) -> torch.Tensor:
    """Leaf ``name`` of shape ``shape``, drawn on ``device`` in fp32 and
    rounded to ``dtype``."""
    shape = tuple(int(s) for s in shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name))
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    offset, scale = leaf_std(name, shape)
    x.mul_(scale).add_(offset)
    return x.to(dtype)


def float_leaves(module: torch.nn.Module) -> Iterable[Tuple[str, torch.Tensor]]:
    """The floating leaves of a module's state a checkpoint would hold
    (quantizer scales are derived, not drawn)."""
    for name, t in module.state_dict(keep_vars=True).items():
        if t.is_floating_point() and not name.endswith("kernel_scale"):
            yield name, t


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int, prefix: str = "") -> None:
    """Draw every floating leaf of ``module`` in place, named
    ``prefix + name``."""
    for name, t in float_leaves(module):
        t.copy_(draw(seed, prefix + name, t.shape, t.dtype, t.device))
