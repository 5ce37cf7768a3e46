"""The port's plain ragged decode attention (the contract of kernel K3,
``seedx_tpu_torch/ops/decode_attention.py``) against the JAX package's
Pallas ``ragged_decode_attention`` run in interpret mode, on the cases of
``tests/test_decode_attention.py`` plus a row with an empty window.

Inputs are made with numpy from a seed and handed to both.  Both sides
round q and k to bf16, take fp32 dot products and round ``p * v_scale``
to bf16 before it weights v; they differ in the order of fp32 sums and in
the softmax running maximum (the TPU kernel rescales tile by tile, the
plain version takes the whole window), which can move a rounded p by one
bf16 ULP.  So the tolerance is one bf16 ULP (2^-9 relative) of the
largest |v| the weights can multiply, plus fp32 noise, plus one bf16 ULP
of the output where the output is bf16: below that file's ``atol=1e-2``
for |v| < 5.12 (checked), before its ``rtol=5e-2``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.models.llama import quantize_kv as jquantize_kv
from seedx_tpu.ops.decode_attention import (ragged_decode_attention as
                                            jragged)
from seedx_tpu_torch.models.llama import quantize_kv
from seedx_tpu_torch.ops import decode_attention as tdecode

torch.set_num_threads(1)


def _rand(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _check(got, want, v_abs_max):
    assert v_abs_max < 5.12
    bf16_out = got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    bound = (2.0 ** -9 * v_abs_max + 1e-5
             + (2.0 ** -8 * np.abs(want) if bf16_out else 0.0))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _both(q, k, v, starts, ends, *, k_scale=None, v_scale=None,
          tables=None, page=0, dtype=np.float32):
    """Port plain version and JAX interpret kernel on the same arrays."""
    hkv = k.shape[-1] // q.shape[-1]
    st, en = np.asarray(starts, np.int32), np.asarray(ends, np.int32)
    to_j = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" \
        else jnp.asarray
    to_t = (lambda x: torch.from_numpy(np.asarray(x)).to(torch.bfloat16)) \
        if dtype == "bf16" else (lambda x: torch.from_numpy(np.asarray(x)))
    kw_j, kw_t = {}, {}
    if k_scale is not None:
        kw_j = dict(k_scale=jnp.asarray(k_scale), v_scale=jnp.asarray(v_scale))
        kw_t = dict(k_scale=torch.from_numpy(k_scale),
                    v_scale=torch.from_numpy(v_scale))
    if tables is not None:
        kw_j.update(block_tables=jnp.asarray(tables, jnp.int32), block=page)
        kw_t.update(block_tables=torch.from_numpy(tables.astype(np.int32)),
                    page=page)
    want = jragged(to_j(q), jnp.asarray(k) if k.dtype == np.int8
                   else to_j(k), jnp.asarray(v) if v.dtype == np.int8
                   else to_j(v), jnp.asarray(st), jnp.asarray(en),
                   kv_heads=hkv, interpret=True, **kw_j)
    got = tdecode.ragged_decode_attention(
        to_t(q), torch.from_numpy(k) if k.dtype == np.int8 else to_t(k),
        torch.from_numpy(v) if v.dtype == np.int8 else to_t(v),
        torch.from_numpy(st), torch.from_numpy(en), **kw_t)
    return got, want


@pytest.mark.parametrize("starts,ends", [
    ([0, 0, 0], [64, 64, 64]),           # full windows
    ([0, 5, 17], [64, 40, 18]),          # ragged, incl. a 1-token row
    ([3, 3, 3], [11, 32, 64]),           # left-padded prompts
    ([0, 9, 30], [64, 9, 30]),           # two empty windows
])
def test_windows_match_jax(starts, ends):
    q, k, v = _rand(3, 64, 4, 4, 32, seed=0)
    got, want = _both(q, k.reshape(3, 64, -1), v.reshape(3, 64, -1),
                      starts, ends)
    assert got.shape == (3, 4, 32) and got.dtype == torch.float32
    _check(got, want, np.abs(v).max())
    for i, (s, e) in enumerate(zip(starts, ends)):
        if e <= s:
            assert (got[i] == 0).all()
            assert (np.asarray(want[i]) == 0).all()


def test_gqa_grouped_heads_match_jax():
    q, k, v = _rand(2, 32, 8, 2, 16, seed=1)
    got, want = _both(q, k.reshape(2, 32, -1), v.reshape(2, 32, -1),
                      [0, 4], [32, 20])
    _check(got, want, np.abs(v).max())


def test_int8_cache_with_scales_matches_jax():
    q, k, v = _rand(2, 48, 4, 4, 32, seed=2)
    kq, ksc = quantize_kv(torch.from_numpy(k))
    vq, vsc = quantize_kv(torch.from_numpy(v))
    # the two packages quantize alike
    jkq, jksc = jquantize_kv(jnp.asarray(k))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ksc.numpy(), np.asarray(jksc))
    got, want = _both(q, kq.numpy().reshape(2, 48, -1),
                      vq.numpy().reshape(2, 48, -1), [0, 9], [48, 30],
                      k_scale=ksc.numpy().reshape(2, 48, 4),
                      v_scale=vsc.numpy().reshape(2, 48, 4))
    _check(got, want, np.abs(v).max())


def test_bf16_cache_matches_jax():
    q, k, v = _rand(2, 32, 4, 4, 32, seed=3)
    got, want = _both(q, k.reshape(2, 32, -1), v.reshape(2, 32, -1),
                      [0, 0], [32, 7], dtype="bf16")
    assert got.dtype == torch.bfloat16
    _check(got, want, np.abs(v).max())


def test_paged_pool_matches_jax_and_dense():
    """Dense rows scattered into a shuffled pool: the block tables give
    the dense result exactly (port) and JAX's within tolerance."""
    page, b, s = 16, 2, 64
    q, k, v = _rand(b, s, 4, 4, 32, seed=4)
    n_tiles = s // page
    rng = np.random.default_rng(0)
    perm = rng.permutation(2 * b * n_tiles)[:b * n_tiles].reshape(b, n_tiles)
    kf, vf = k.reshape(b, s, -1), v.reshape(b, s, -1)
    k_pool = np.zeros((2 * b * n_tiles * page, kf.shape[-1]), np.float32)
    v_pool = np.zeros_like(k_pool)
    for i in range(b):
        for j in range(n_tiles):
            t = perm[i, j]
            k_pool[t * page:(t + 1) * page] = kf[i, j * page:(j + 1) * page]
            v_pool[t * page:(t + 1) * page] = vf[i, j * page:(j + 1) * page]
    got, want = _both(q, k_pool, v_pool, [0, 10], [64, 39], tables=perm,
                      page=page)
    _check(got, want, np.abs(v).max())
    dense = tdecode.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kf), torch.from_numpy(vf),
        torch.tensor([0, 10], dtype=torch.int32),
        torch.tensor([64, 39], dtype=torch.int32))
    assert torch.equal(got, dense)


def test_odd_cache_length_matches_jax():
    q, k, v = _rand(2, 40, 2, 2, 16, seed=5)
    got, want = _both(q, k.reshape(2, 40, -1), v.reshape(2, 40, -1),
                      [0, 3], [40, 21])
    _check(got, want, np.abs(v).max())


def test_contract_errors():
    q = torch.zeros((2, 4, 32))
    k = torch.zeros((2, 16, 4 * 32))
    se = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="both scales"):
        tdecode.ragged_decode_attention(q, k, k, se, se,
                                        k_scale=torch.zeros((2, 16, 4)))
    with pytest.raises(ValueError, match="paged pool"):
        tdecode.ragged_decode_attention(
            q, k.reshape(32, -1), k.reshape(32, -1), se, se,
            block_tables=torch.zeros((2, 2), dtype=torch.int32))


# ---- multi-query "stair" mode (q [B, w, Hq, D]) -----------------------------
#
# One-tile cache lengths (S = 32: the JAX kernel reads it as one 32-row
# tile; paged, one page of 32 per row), so the JAX kernel takes each
# query's softmax maximum over its whole window as the plain version does,
# and p rounds to bf16 against the same maximum: the two then differ only
# in the order of fp32 sums.


def _stair_case(b, w, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, w, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k.reshape(b, s, -1), v.reshape(b, s, -1)


def _pool(x, tables, page):
    """Dense [B, S, ...] rows scattered into a pool at the table's pages."""
    b, n_tiles = tables.shape
    out = np.zeros((int(tables.max() + 1) * page,) + x.shape[2:], x.dtype)
    for i in range(b):
        for j in range(n_tiles):
            t = tables[i, j]
            out[t * page:(t + 1) * page] = x[i, j * page:(j + 1) * page]
    return out


STAIR_WINDOWS = ([0, 5, 17, 0], [28, 9, 18, 1])   # a prefilling row, a
# mid-prompt row, a decoding row and a row at position 0


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "gqa", "paged"])
def test_stair_matches_jax(kind, w):
    """Slot i of row b attends [starts[b], min(ends[b] + i, S)); the last
    slots of the 28-ending row step past S = 32 and are clamped there."""
    b, s, hq, hkv, d = 4, 32, 4, 4, 32
    if kind == "gqa":
        hq, hkv = 8, 2
    q, k, v = _stair_case(b, w, s, hq, hkv, d, seed=10 + w)
    kw = {}
    dtype = "bf16" if kind == "bf16" else np.float32
    if kind == "int8":
        kq, ksc = quantize_kv(torch.from_numpy(k.reshape(b, s, hkv, d)))
        vq, vsc = quantize_kv(torch.from_numpy(v.reshape(b, s, hkv, d)))
        k, v = kq.numpy().reshape(b, s, -1), vq.numpy().reshape(b, s, -1)
        kw = dict(k_scale=ksc.numpy().reshape(b, s, hkv),
                  v_scale=vsc.numpy().reshape(b, s, hkv))
    if kind == "paged":
        page = s
        tables = np.random.default_rng(3).permutation(
            2 * b * (s // page))[:b * (s // page)].reshape(b, s // page)
        k, v = _pool(k, tables, page), _pool(v, tables, page)
        kw = dict(tables=tables.astype(np.int32), page=page)
    got, want = _both(q, k, v, *STAIR_WINDOWS, dtype=dtype, **kw)
    assert got.shape == (b, w, hq, d)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    # both sides: exact bf16 x bf16 products summed in fp32 (the order
    # differs), one bf16 rounding of each weight against the same maximum;
    # a bf16 output rounds the same fp32 value once more
    assert err <= 1e-6, err


def test_stair_w1_equals_one_query_and_slots_are_windows():
    """w == 1 is the one-query call, bit for bit; slot i of a stair is a
    one-query call whose window ends i positions later (to fp32 summation
    order: the einsums batch differently)."""
    b, w, s, hq, hkv, d = 4, 8, 32, 4, 4, 32
    q, k, v = _stair_case(b, w, s, hq, hkv, d, seed=30)
    st, en = (torch.tensor(x, dtype=torch.int32) for x in STAIR_WINDOWS)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    stair = tdecode.ragged_decode_attention(qt, kt, vt, st, en)
    for i in range(w):
        one = tdecode.ragged_decode_attention(qt[:, i].contiguous(), kt, vt,
                                              st, en + i)
        torch.testing.assert_close(stair[:, i], one, rtol=0, atol=1e-6)
    w1 = tdecode.ragged_decode_attention(qt[:, :1].contiguous(), kt, vt, st,
                                         en)
    one = tdecode.ragged_decode_attention(qt[:, 0].contiguous(), kt, vt, st,
                                          en)
    assert w1.shape == (b, 1, hq, d)
    assert torch.equal(w1[:, 0], one)
