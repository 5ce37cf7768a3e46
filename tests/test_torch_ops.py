"""Parity of the PyTorch port's ops with the JAX package's.

Every input comes from ``np.random.default_rng``; the same numpy arrays go
through the JAX function and its port.  The JAX Pallas kernels run as the
JAX package's own CPU tests run them (interpret mode); the port's wrappers
run their plain versions because the tensors lie on the CPU.  The CUDA
kernels are held against their plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.ops import attention as jattn
from seedx_tpu.ops import flash_attention as jflash
from seedx_tpu.ops import int4_matmul as jint4
from seedx_tpu.ops import norms as jnorms
from seedx_tpu.ops import rope as jrope
from seedx_tpu.utils import quantize as jquant
from seedx_tpu_torch.ops import attention as tattn
from seedx_tpu_torch.ops import flash_attention as tflash
from seedx_tpu_torch.ops import int4_matmul as tint4
from seedx_tpu_torch.ops import norms as tnorms
from seedx_tpu_torch.ops import rope as trope
from seedx_tpu_torch.utils import quantize as tquant

torch.set_num_threads(1)

# float32 on both sides: sums run in another order (XLA vs ATen), so
# elementwise results agree to a few fp32 ULPs of the values' magnitude.
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_norms_match_jax():
    rng = _rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        **F32_TOL)
    np.testing.assert_allclose(
        tnorms.layer_norm_fp32_stats(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jnorms.layer_norm_fp32_stats(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), **F32_TOL)


def test_rope_matches_jax():
    rng = _rng(1)
    pos = rng.integers(0, 2000, size=(2, 9))
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 32)
    ct, st = trope.rope_cos_sin(_t(pos), 32)
    # angles up to 2000 rad: cos/sin of a large fp32 argument differ by a
    # few ULP of the argument between libm implementations
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-4)
    np.testing.assert_allclose(
        trope.apply_rope(_t(x), _t(np.asarray(cj)), _t(np.asarray(sj))).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), cj, sj)), **F32_TOL)


def _window(b, kv_len, starts, ends):
    k = np.arange(kv_len)[None]
    return (k >= np.asarray(starts)[:, None]) & (k < np.asarray(ends)[:, None])


@pytest.mark.parametrize("case", ["causal", "prefill_offset", "gqa_window",
                                  "decode"])
def test_plain_attention_matches_jax(case):
    rng = _rng(2)
    b, h, d = 2, 4, 16
    q_len, kv_len, kv_heads, causal = {
        "causal": (24, 24, 4, True), "prefill_offset": (12, 40, 4, True),
        "gqa_window": (24, 24, 2, False), "decode": (1, 40, 4, False)}[case]
    q = rng.standard_normal((b, q_len, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv_len, kv_heads, d)).astype(np.float32)
    v = rng.standard_normal((b, kv_len, kv_heads, d)).astype(np.float32)
    valid = _window(b, kv_len, [3, 0], [kv_len - 2, 18])
    q_offset = 6 if case == "prefill_offset" else None
    out_j = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid=jnp.asarray(valid), causal=causal, impl="xla",
        q_offset=q_offset)
    out_t = tattn.dot_product_attention(
        _t(q), _t(k), _t(v), kv_valid=_t(valid), causal=causal,
        impl="plain", q_offset=q_offset)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32_TOL)


def _flash_inputs(seed, b, sq, skv, h, d):
    rng = _rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s in (sq, skv, skv)]


def test_flash_plain_causal_prefill_left_pad_matches_jax():
    # prefill of a left-padded 128-token bucket into a 256-slot cache:
    # window [start, 128), start > 0, causal from q_offset 0
    b, sq, skv, h, d = 2, 128, 256, 2, 64
    q, k, v = _flash_inputs(3, b, sq, skv, h, d)
    starts = np.array([5, 40], np.int32)
    ends = np.array([128, 128], np.int32)
    scale = d ** -0.5
    out_j, lse_j = jflash._flash_forward_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
        jnp.asarray(ends), jnp.zeros((1,), jnp.int32), True, scale, 128, 128,
        True)
    out_t, lse_t = tflash.flash_fwd(_t(q), _t(k), _t(v), _t(starts),
                                    _t(ends), 0, True, scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32_TOL)
    # rows before the window start see no key: zero output, lse NEG_INF
    np.testing.assert_array_equal(out_t.numpy()[1, :40], 0.0)
    np.testing.assert_array_equal(np.asarray(out_j)[1, :40], 0.0)
    live = np.asarray(lse_j) > -1e30
    np.testing.assert_array_equal(lse_t.numpy() > -1e30, live)
    np.testing.assert_allclose(lse_t.numpy()[live], np.asarray(lse_j)[live],
                               **F32_TOL)
    # the attention dispatch derives the same window from kv_valid
    valid = _window(b, skv, starts, ends)
    out_d = tattn.dot_product_attention(
        _t(q), _t(k), _t(v), kv_valid=_t(valid), causal=True, impl="flash",
        q_offset=0)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(out_j), **F32_TOL)


def test_flash_plain_noncausal_head_dim_104_matches_jax():
    # ViT-bigG's head dim: both dispatches zero-pad 104 -> 128
    b, s, h, d = 2, 128, 2, 104
    q, k, v = _flash_inputs(4, b, s, s, h, d)
    out_j = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), impl="flash")
    out_t = tattn.dot_product_attention(_t(q), _t(k), _t(v), impl="flash")
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32_TOL)


def test_flash_plain_fully_masked_row_gives_zeros():
    b, s, h, d = 2, 128, 1, 64
    q, k, v = _flash_inputs(5, b, s, s, h, d)
    starts = np.array([0, 64], np.int32)
    ends = np.array([128, 64], np.int32)          # batch row 1: empty window
    out_j = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        starts=jnp.asarray(starts), ends=jnp.asarray(ends), causal=False)
    out_t, lse_t = tflash.flash_fwd(_t(q), _t(k), _t(v), _t(starts),
                                    _t(ends), 0, False, d ** -0.5)
    np.testing.assert_array_equal(out_t.numpy()[1], 0.0)
    np.testing.assert_array_equal(lse_t.numpy()[1],
                                  np.float32(tattn.NEG_INF))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32_TOL)


@pytest.mark.parametrize("shape,group", [((256, 96), 128),
                                         ((3, 256, 64), 128),
                                         ((192, 32), 128)])
def test_int4_packer_bit_exact(shape, group):
    w = _rng(6).standard_normal(shape).astype(np.float32) * 0.05
    pj, sj = jquant.quantize_kernel_int4(w, group)
    pt, st = tquant.quantize_kernel_int4(_t(w), group)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(st.numpy(), sj)


def test_int8_packers_bit_exact():
    rng = _rng(7)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32)
    for (qj, sj), (qt, st) in (
            (jquant.quantize_kernel(w), tquant.quantize_kernel(_t(w))),
            (jquant.quantize_embedding(w[0]),
             tquant.quantize_embedding(_t(w[0])))):
        np.testing.assert_array_equal(qt.numpy(), qj)
        np.testing.assert_array_equal(st.numpy(), sj)


@pytest.mark.parametrize("rows", [1, 33, 300])
@pytest.mark.parametrize("n_in,group", [(384, 128), (192, 192)])
def test_w4a8_plain_matches_jax_kernel(rows, n_in, group):
    rng = _rng(8)
    n_out = 256
    w = rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.05
    x = rng.standard_normal((rows, n_in)).astype(np.float32)
    packed, scale = jquant.quantize_kernel_int4(w, 128)
    assert scale.shape[0] == n_in // group
    y_j = np.asarray(jint4.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                       jnp.asarray(scale), group=group,
                                       interpret=True))
    y_t = tint4.int4_matmul(_t(x), _t(packed), _t(scale)).numpy()
    # same int8 codes and exact int32 group dots on both sides; the group
    # scales accumulate in the same order, so only fp32 rounding of the
    # fused multiply-adds can differ: a few ULPs of the row magnitude
    tol = 1e-6 * np.abs(y_j).max()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=tol)


def test_w4a8_plain_bf16_and_w4a16_reference_match_jax():
    rng = _rng(9)
    w = rng.standard_normal((256, 128)).astype(np.float32) * 0.05
    x = rng.standard_normal((5, 256)).astype(np.float32)
    packed, scale = jquant.quantize_kernel_int4(w)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x).to(torch.bfloat16)
    y_j = np.asarray(jint4.int4_matmul(xj, jnp.asarray(packed),
                                       jnp.asarray(scale), interpret=True),
                     np.float32)
    y_t = tint4.int4_matmul(xt, _t(packed), _t(scale)).float().numpy()
    # identical fp32 sums rounded once to bf16: at most one bf16 ULP apart
    np.testing.assert_allclose(y_t, y_j, rtol=2 ** -7, atol=1e-6)
    u_j = np.asarray(jint4.int4_matmul_xla(xj, jnp.asarray(packed),
                                           jnp.asarray(scale)), np.float32)
    u_t = tint4.int4_matmul_unpack(xt, _t(packed), _t(scale)).float().numpy()
    # bf16 dot products: accumulation order differs (XLA vs ATen), so allow
    # a few bf16 ULPs of the output magnitude
    np.testing.assert_allclose(u_t, u_j, rtol=0,
                               atol=4 * 2 ** -8 * np.abs(u_j).max())
