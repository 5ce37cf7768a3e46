"""Time K1 (``seedx_tpu_torch/csrc/flash_fwd.cu``) or, with ``--bwd``, K4
and K5 (``csrc/flash_bwd.cu``) on one GPU at every block tile they are
built with, at each main-path shape (``chip_smoke.FLASH_SHAPES``, or
``chip_smoke.FLASH_BWD_SHAPES``): the times ``tile_shape`` (``bwd_tile_shape``)
in ``seedx_tpu_torch/ops/flash_attention.py`` is chosen from.

    python3 flash_sweep.py [--bwd]

Each (shape, tile) runs ``chip_smoke.check_flash`` (``check_flash_bwd``)
with the tile forced, so every tile is held to the kernel's limits against
the plain version and timed beside SDPA (SDPA's backward) in the same way
as the smoke's rows.  After those lines, one ``sweep`` line a shape (and
kernel) gives the ms at each tile, ``*`` on the one the wrapper picks.
Exits non-zero if any tile disagrees with the plain version.
"""

from __future__ import annotations

import sys

import chip_smoke as c


def sweep_fwd(fa, dev, g) -> int:
    pick, bad = fa.tile_shape, 0
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
    return bad


def sweep_bwd(fa, dev, g) -> int:
    """K4 and K5 tiles are forced in pairs, the i-th of each kernel's list
    together (the shorter list wraps), so every built tile of each runs."""
    pick, bad = fa.bwd_tile_shape, 0
    try:
        for shape in c.FLASH_BWD_SHAPES:
            name, b, s, h, d, causal = shape[:6]
            chosen = pick(b, s, s, h, d, causal, fa.sm_count(0))
            built = fa.BWD_TILES[d]
            n = max(len(built["dq"]), len(built["dkv"]))
            times = {"dq": {}, "dkv": {}}
            for i in range(n):
                pair = (built["dq"][i % len(built["dq"])],
                        built["dkv"][i % len(built["dkv"])])
                fa.bwd_tile_shape = lambda *a, p=pair: p
                rows = c.check_flash_bwd(dev, g, shapes=(shape,))
                bad += sum(not r["ok"] for r in rows)
                for kernel, tile, r in zip(("dq", "dkv"), pair, rows):
                    times[kernel][tile] = r["ms"]
            for j, kernel in enumerate(("dq", "dkv")):
                c.log(f"sweep {name} {kernel}: SDPA backward "
                      f"{rows[0]['library_ms']:.4f} ms | "
                      f"{('K4', 'K5')[j]} ms " + " | ".join(
                          f"{t[0]}x{t[1]}{'*' if t == chosen[j] else ''} "
                          f"{ms:.4f}" for t, ms in times[kernel].items()))
    finally:
        fa.bwd_tile_shape = pick
    return bad


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep: no CUDA device")
    from seedx_tpu_torch.ops import flash_attention as fa

    c.log(f"card: {c.nvidia_smi_line()}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bwd = "--bwd" in argv
    bad = (sweep_bwd if bwd else sweep_fwd)(fa, dev, g)
    c.log(f"flash_sweep: {bad} (shape, tile) pairs disagree with the plain "
          f"version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
