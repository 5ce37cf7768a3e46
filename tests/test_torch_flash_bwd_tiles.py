"""K4 / K5's block tiles and the kernels' build key, on the CPU.

``bwd_tile_shape`` must pick only tiles that ``csrc/flash_bwd.cu`` builds,
and reach every one of them; the ``.cu`` dispatch must list exactly
``BWD_TILES``; and a library's build key must change with the headers its
source includes, so an edit to ``csrc/flash_common.cuh`` alone rebuilds.
"""

import os
import re

import pytest

from seedx_tpu_torch.ops import _build
from seedx_tpu_torch.ops import flash_attention as tflash

GRIDS = [(b, sq, skv, h) for b in (1, 2, 8) for sq in (7, 65, 260, 880, 4096)
         for skv in (sq, 2 * sq + 3) for h in (1, 16, 40)]


@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_bwd_tile_shape_picks_exactly_the_built_tiles(d):
    """Over small and large grids, causal and not, each kernel's picks are
    exactly its built tiles."""
    picks = [tflash.bwd_tile_shape(b, sq, skv, h, d, causal, 132)
             for b, sq, skv, h in GRIDS for causal in (False, True)]
    assert {p[0] for p in picks} == set(tflash.BWD_TILES[d]["dq"])
    assert {p[1] for p in picks} == set(tflash.BWD_TILES[d]["dkv"])


@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_bwd_tiles_fit_the_kernels(d):
    """Every built tile is whole warpgroups (64 rows of the held operand)
    and a wgmma width (64 or 128) for the streamed one, and its shared
    memory fits one H100 block (227 KB)."""
    for kernel, tiles in tflash.BWD_TILES[d].items():
        for q_rows, keys in tiles:
            held, streamed = ((q_rows, keys) if kernel == "dq"
                              else (keys, q_rows))
            assert held % 64 == 0 and streamed in (64, 128), (kernel, held)
            # align slack, the held pair, the 2-stage ring (+ lse / delta)
            smem = 1024 + 2 * held * d * 2 + 4 * streamed * d * 2
            smem += 0 if kernel == "dq" else 4 * streamed * 4
            assert smem <= 232448, (kernel, q_rows, keys)


@pytest.mark.parametrize("kernel,macro", [("dq", "DQ_LAUNCH"),
                                          ("dkv", "DKV_LAUNCH")])
def test_bwd_dispatch_lists_exactly_the_tiles(kernel, macro):
    """csrc/flash_bwd.cu launches (D, q rows, keys) for exactly the tiles
    BWD_TILES names: a tile the wrapper picks is built, and nothing else
    is."""
    with open(os.path.join(_build.CSRC, "flash_bwd.cu")) as f:
        src = f.read()
    built = {tuple(int(x) for x in m) for m in re.findall(
        rf"^\s*{macro}\((\d+), (\d+), (\d+)\)\s*$", src, re.M)}
    want = {(d, *tile) for d in tflash.HEAD_DIMS
            for tile in tflash.BWD_TILES[d][kernel]}
    assert built == want


def test_source_digest_covers_the_headers(tmp_path, monkeypatch):
    """The build key of a source changes when a header under csrc/ changes,
    and not when an unrelated file does."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    path = str(tmp_path / "k.cu")
    first = _build.source_digest(path)
    (tmp_path / "notes.txt").write_text("unrelated\n")
    assert _build.source_digest(path) == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.source_digest(path) != first
