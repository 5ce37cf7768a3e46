"""Time K1 (``seedx_tpu_torch/csrc/flash_fwd.cu``) on one GPU at every
block tile it is built with, at each K1 shape of the main path
(``chip_smoke.FLASH_SHAPES``): the times ``tile_shape`` in
``seedx_tpu_torch/ops/flash_attention.py`` is chosen from.

    python3 flash_sweep.py

Each (shape, tile) runs ``chip_smoke.check_flash`` with the tile forced, so
every tile is held to K1's limits against the plain version and timed
beside SDPA in the same way as the smoke's rows.  After check_flash's own
lines, one ``sweep`` line a shape gives the ms at each tile, ``*`` on the
one ``tile_shape`` picks.  Exits non-zero if any tile disagrees with the
plain version.
"""

from __future__ import annotations

import sys

import chip_smoke as c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep: no CUDA device")
    from seedx_tpu_torch.ops import flash_attention as fa

    c.log(f"card: {c.nvidia_smi_line()}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    pick = fa.tile_shape
    bad = 0
    try:
        for shape in c.FLASH_SHAPES:
            name, b, sq, _, h, d, causal = shape[:7]
            chosen = pick(b, sq, h, d, causal, fa.sm_count(0))
            times = []
            for tile in fa.TILES[d]:
                fa.tile_shape = lambda *a, t=tile: t
                r, = c.check_flash(dev, g, shapes=(shape,))
                bad += not r["ok"]
                times.append(f"{tile[0]}x{tile[1]}"
                             f"{'*' if tile == chosen else ''} {r['ms']:.4f}")
            c.log(f"sweep {name}: SDPA {r['library_ms']:.4f} ms | K1 ms "
                  + " | ".join(times))
    finally:
        fa.tile_shape = pick
    c.log(f"flash_sweep: {bad} (shape, tile) pairs disagree with the plain "
          f"version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
