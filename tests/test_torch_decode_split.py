"""Kernel K3's window split, on the CPU: the host planner
(``seedx_tpu_torch/ops/decode_attention.py`` ``plan`` and
``split_ranges``, which mirror ``csrc/decode_attn.cu``'s chunking), and
the split-and-merge arithmetic the kernel runs
(``ragged_decode_attention_split_plain``: fp32 partials (m, l, acc) per
chunk, merged in chunk order) against the JAX package's Pallas
``ragged_decode_attention`` in interpret mode, on the inputs of
``tests/test_torch_decode_attention.py``.

Tolerance: each chunk rounds ``p * v_scale`` to bf16 against its own
maximum, the JAX kernel against its tile's running maximum, so a weight
may differ by one bf16 ULP (2^-9 relative) of the largest |v| it
multiplies; plus fp32 noise, plus one bf16 ULP of the output for a bf16
output (the bound of ``test_torch_decode_attention.py``'s ``_check``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.ops.decode_attention import (ragged_decode_attention as
                                            jragged)
from seedx_tpu_torch.models.llama import quantize_kv
from seedx_tpu_torch.ops import decode_attention as tdecode

torch.set_num_threads(1)

H100_SMS = 132

# (B, w, G, Hkv, S): the main path's K3 launches (13B one query at B 1 /
# B 8, its stair at w 8 / 16, the GQA rows, w 64) and a small cache
PLAN_SHAPES = [(1, 1, 1, 40, 1280), (8, 1, 1, 40, 1280), (8, 1, 5, 8, 1280),
               (8, 8, 1, 40, 640), (8, 16, 1, 40, 640), (8, 8, 5, 8, 640),
               (8, 64, 5, 8, 640), (8, 64, 1, 40, 640), (2, 4, 4, 2, 96),
               (1, 1, 8, 1, 64)]
WINDOWS = [(0, 1280), (5, 40), (3, 3), (100, 900), (0, 1), (1279, 1280),
           (640, 1100), (-2, 70), (63, 64), (0, 64), (0, 65)]


@pytest.mark.parametrize("b,w,g,hkv,s", PLAN_SHAPES)
def test_plan_groups_and_fill(b, w, g, hkv, s):
    """Slots split into groups of at most 64 query vectors, evenly; the
    launch fills >= 132 blocks unless S has fewer tiles than that needs."""
    ql, groups, splits = tdecode.plan(b, w, g, hkv, s, H100_SMS)
    assert ql * g <= tdecode.MAX_ROWS
    assert (groups - 1) * ql < w <= groups * ql
    assert groups == -(-w * g // (tdecode.MAX_ROWS // g * g))
    tiles = -(-s // tdecode.TILE)
    assert 1 <= splits <= min(tiles, tdecode.MAX_SPLITS)
    assert (b * hkv * groups * splits >= H100_SMS
            or splits == min(tiles, tdecode.MAX_SPLITS))
    if w * g <= tdecode.MAX_ROWS:
        assert groups == 1      # every position read once for all rows


@pytest.mark.parametrize("b,w,g,hkv,s", PLAN_SHAPES)
def test_split_ranges_cover_each_window_once(b, w, g, hkv, s):
    """Each window is covered exactly once, in order, by whole tiles from
    its start; no live chunk is empty and there are at most `splits`."""
    _, _, planned = tdecode.plan(b, w, g, hkv, s, H100_SMS)
    for splits in (planned, 1, 2, 3, tdecode.MAX_SPLITS):
        for start, end in WINDOWS:
            end = min(end, s)
            ranges = tdecode.split_ranges(start, end, splits)
            assert len(ranges) <= splits
            lo = max(start, 0)
            if end <= lo:
                assert ranges == []
                continue
            assert ranges[0][0] == lo and ranges[-1][1] == end
            for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
                assert a1 == b0
            for i, (a0, a1) in enumerate(ranges):
                assert a1 > a0
                assert (a0 - lo) % tdecode.TILE == 0
                if i < len(ranges) - 1:
                    assert (a1 - a0) == (ranges[0][1] - ranges[0][0])


def test_plan_forced_splits():
    assert tdecode.plan(8, 1, 1, 40, 1280, H100_SMS, splits=3)[2] == 3
    assert tdecode.plan(8, 1, 1, 40, 1280, H100_SMS, splits=32)[2] == 32
    with pytest.raises(ValueError, match="at most 32 splits"):
        tdecode.plan(8, 1, 1, 40, 1280, H100_SMS, splits=33)


def _rand(shape_q, b, s, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal((b, s, hkv * d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv * d)).astype(np.float32)
    return q, k, v


def _pool(x, tables, page):
    b, n_tiles = tables.shape
    out = np.zeros((int(tables.max() + 1) * page,) + x.shape[2:], x.dtype)
    for i in range(b):
        for j in range(n_tiles):
            t = tables[i, j]
            out[t * page:(t + 1) * page] = x[i, j * page:(j + 1) * page]
    return out


def _case(kind, w, seed):
    """Inputs of test_torch_decode_attention.py: q, caches, windows and
    the keyword arguments of both packages."""
    b, s, hq, hkv, d = 3, 64, 4, 4, 32
    starts, ends = [0, 5, 17], [64, 40, 18]
    if kind == "gqa":
        b, s, hq, hkv, d = 2, 32, 8, 2, 16
        starts, ends = [0, 4], [32, 20]
    elif kind == "empty":
        starts, ends = [0, 9, 30], [64, 9, 30]
    elif kind == "int8":
        b, s = 2, 48
        starts, ends = [0, 9], [48, 30]
    elif kind == "paged":
        b = 2
        starts, ends = [0, 10], [64, 39]
    shape_q = (b, hq, d) if w == 0 else (b, w, hq, d)
    q, k, v = _rand(shape_q, b, s, hkv, d, seed)
    if w:
        ends = [max(e - w, 0) for e in ends]   # the stair then steps to e
    v_max = np.abs(v).max()
    kw_t, kw_j = {}, {}
    if kind == "int8":
        kq, ksc = quantize_kv(torch.from_numpy(k.reshape(b, s, hkv, d)))
        vq, vsc = quantize_kv(torch.from_numpy(v.reshape(b, s, hkv, d)))
        k, v = kq.numpy().reshape(b, s, -1), vq.numpy().reshape(b, s, -1)
        ksc, vsc = ksc.numpy().reshape(b, s, hkv), vsc.numpy().reshape(
            b, s, hkv)
        kw_t = dict(k_scale=torch.from_numpy(ksc),
                    v_scale=torch.from_numpy(vsc))
        kw_j = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    if kind == "paged":
        page = 16
        tables = np.random.default_rng(0).permutation(2 * b * 4)[
            :b * 4].reshape(b, 4).astype(np.int32)
        k, v = _pool(k, tables, page), _pool(v, tables, page)
        kw_t = dict(block_tables=torch.from_numpy(tables), page=page)
        kw_j = dict(block_tables=jnp.asarray(tables), block=page)
    return q, k, v, starts, ends, hkv, v_max, kw_t, kw_j


def _to_t(x, bf16):
    t = torch.from_numpy(np.asarray(x))
    return t.to(torch.bfloat16) if bf16 and t.dtype == torch.float32 else t


def _to_j(x, bf16):
    if x.dtype == np.int8:
        return jnp.asarray(x)
    return jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("kind,w", [("ragged", 0), ("empty", 0),
                                    ("gqa", 0), ("int8", 0), ("bf16", 0),
                                    ("paged", 0), ("ragged", 8),
                                    ("int8", 4), ("gqa", 4)])
def test_split_merge_matches_jax(kind, w, splits):
    """The kernel's chunks and merge, in plain torch, against the JAX
    kernel: the one-query cases of test_torch_decode_attention.py and
    stairs over them (stair rows grouped 3 slots at a time for w 8)."""
    q, k, v, starts, ends, hkv, v_max, kw_t, kw_j = _case(kind, w, seed=splits)
    bf16 = kind == "bf16"
    st, en = np.asarray(starts, np.int32), np.asarray(ends, np.int32)
    want = np.asarray(jragged(_to_j(q, bf16), _to_j(k, bf16), _to_j(v, bf16),
                              jnp.asarray(st), jnp.asarray(en),
                              kv_heads=hkv, interpret=True, **kw_j),
                      np.float32)
    got = tdecode.ragged_decode_attention_split_plain(
        _to_t(q, bf16), _to_t(k, bf16), _to_t(v, bf16),
        torch.from_numpy(st), torch.from_numpy(en), splits=splits,
        slots=3 if w == 8 else 0, **kw_t)
    assert got.shape == q.shape
    bound = (2.0 ** -9 * v_max + 1e-5
             + (2.0 ** -8 * np.abs(want) if bf16 else 0.0))
    err = np.abs(got.float().numpy() - want)
    assert (err <= bound).all(), err.max()
    for i, (s_, e_) in enumerate(zip(starts, ends)):
        if e_ <= s_:
            row = got[i] if w == 0 else got[i, 0]
            assert (row == 0).all()


@pytest.mark.parametrize("w", [0, 8])
def test_split_merge_one_split_is_the_plain_version(w):
    """One chunk is the whole window: the plain version, bit for bit."""
    q, k, v, starts, ends, _, _, _, _ = _case("ragged", w, seed=1)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor(starts, dtype=torch.int32),
            torch.tensor(ends, dtype=torch.int32))
    one = tdecode.ragged_decode_attention_split_plain(*args, splits=1)
    plain = tdecode.ragged_decode_attention_plain(*args)
    torch.testing.assert_close(one, plain, rtol=0, atol=1e-6)
