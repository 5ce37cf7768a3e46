"""Kernel K2's launch plan and split-K arithmetic, on the CPU: the host
planner (``seedx_tpu_torch/ops/int4_matmul.py`` ``plan`` and
``split_ranges``, which mirror ``csrc/int4_w4a8.cu``'s grid and group
ranges), and the split-and-merge arithmetic the kernel runs
(``int4_matmul_split_plain``: an fp32 partial per split in group order,
merged in split order) against the JAX package's Pallas ``int4_matmul``
in interpret mode, on numpy inputs from a seed.

Tolerance: the int8 codes and every int32 group dot are exact on both
sides; the fp32 sums differ only in order (split partials against one
running sum) and FMA against mul + add, a few fp32 ULPs; then each side
rounds once to bf16, so an output may sit one bf16 ULP (2^-7 of its
magnitude at most) from the other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.ops import int4_matmul as jint4
from seedx_tpu.utils import quantize as jquant
from seedx_tpu_torch.ops import int4_matmul as tint4

torch.set_num_threads(1)

H100_SMS = 132
# (in, out): the 13B's q / k / v / o, gate / up and down projections, the
# debug agents' (hidden 128 / 256, intermediate 256 / 512)
SHAPES = [(5120, 5120), (5120, 13824), (13824, 5120), (128, 256),
          (256, 128), (256, 512), (512, 256)]


def _live(n_groups, splits):
    """The kernel's rule: ceil(groups / splits) groups a split."""
    per = -(-n_groups // splits)
    return -(-n_groups // per)


@pytest.mark.parametrize("n_in,n_out", SHAPES)
def test_plan_picks_built_tiles_and_fills_the_card(n_in, n_out):
    """Over rows 1-2048: only built row tiles (16 up to 16 rows, then 32 or
    64, whichever pads the rows less, 64 on a tie); a live split count the
    kernel accepts; at least SPLIT_FILL blocks an SM and, on the 16- and
    32-row tiles, at most SPLIT_GROUPS groups a split, unless the groups
    run out."""
    n_groups = n_in // 128
    seen = set()
    for rows in range(1, tint4.MAX_KERNEL_ROWS + 1):
        tile, splits = tint4.plan(rows, n_in, n_out, 128, H100_SMS)
        seen.add(tile)
        assert tile in tint4.ROW_TILES
        if rows <= 16:
            assert tile == 16
        else:
            pad32, pad64 = -(-rows // 32) * 32, -(-rows // 64) * 64
            assert tile == (32 if pad32 < pad64 else 64)
        assert 1 <= splits <= min(n_groups, tint4.MAX_SPLITS)
        assert _live(n_groups, splits) == splits
        tiles = -(-rows // tile) * -(-n_out // tint4.BN)
        want = -(-tint4.SPLIT_FILL * H100_SMS // tiles)
        if tile < 64:
            want = max(want, -(-n_groups // tint4.SPLIT_GROUPS))
        if want <= 1:
            assert splits == 1
        else:
            assert splits == _live(n_groups, min(want, n_groups,
                                                 tint4.MAX_SPLITS))
    assert seen == set(tint4.ROW_TILES)


def test_plan_forced_tile_and_splits():
    assert tint4.plan(1, 5120, 5120, 128, H100_SMS, tile=64) == (64, 7)
    assert tint4.plan(1, 5120, 5120, 128, H100_SMS) == (16, 7)
    assert tint4.plan(1, 13824, 5120, 128, H100_SMS) == (16, 11)
    assert tint4.plan(65, 5120, 13824, 128, H100_SMS) == (32, 4)
    assert tint4.plan(512, 13824, 5120, 128, H100_SMS) == (64, 1)
    assert tint4.plan(512, 5120, 5120, 128, H100_SMS, splits=7) == (64, 7)
    # 40 groups: 12 asked -> 4 groups a split -> 10 live splits
    assert tint4.plan(1, 5120, 5120, 128, H100_SMS, splits=12)[1] == 10
    assert tint4.plan(1, 256, 128, 128, H100_SMS, splits=64)[1] == 2
    with pytest.raises(ValueError):
        tint4.plan(1, 5120, 5120, 128, H100_SMS, tile=48)


@pytest.mark.parametrize("n_groups", [1, 2, 3, 7, 40, 108, 113])
def test_split_ranges_cover_every_group_once_in_order(n_groups):
    for splits in range(1, tint4.MAX_SPLITS + 1):
        ranges = tint4.split_ranges(n_groups, splits)
        assert len(ranges) == _live(n_groups, splits)
        assert [g for g0, g1 in ranges for g in range(g0, g1)] == list(
            range(n_groups))
        assert all(g1 > g0 for g0, g1 in ranges)


def test_workspace_layout():
    # x8 padded to whole 32-k steps per group, xa, partials, 16-byte steps
    assert tint4.workspace_bytes(1, 5120, 5120, 128, 1) == 5120 + 16
    assert tint4.workspace_bytes(3, 384, 256, 96, 2) == (
        3 * 4 * 96 + 16 + 2 * 3 * 256 * 4)
    assert tint4.workspace_bytes(1, 72, 16, 36, 1) == 2 * 64 + 16


def test_row_bands():
    assert [tint4.row_band(r) for r in (1, 2, 16, 17, 64, 65, 2048)] == [
        "1", "2-16", "2-16", "17-64", "17-64", "65-2048", "65-2048"]


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 24, 65])
@pytest.mark.parametrize("n_in,group", [(512, 128), (384, 96)])
def test_split_plain_matches_jax_kernel(rows, n_in, group):
    rng = np.random.default_rng(100 + rows + group)
    n_out = 256
    w = rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.05
    x = rng.standard_normal((rows, n_in)).astype(np.float32)
    packed, scale = jquant.quantize_kernel_int4(w, group)
    assert scale.shape == (n_in // group, n_out)
    xj = jnp.asarray(x, jnp.bfloat16)
    y_j = np.asarray(jint4.int4_matmul(xj, jnp.asarray(packed),
                                       jnp.asarray(scale), group=group,
                                       interpret=True), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    pt, st = torch.from_numpy(packed), torch.from_numpy(scale)
    tol = 2 ** -7 * np.abs(y_j).max()
    planned = tint4.plan(rows, n_in, n_out, group, H100_SMS)[1]
    for splits in sorted({1, 2, planned, n_in // group}):
        y_t = tint4.int4_matmul_split_plain(xt, pt, st, splits)
        assert y_t.dtype == torch.bfloat16 and y_t.shape == (rows, n_out)
        np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=0,
                                   atol=tol)
