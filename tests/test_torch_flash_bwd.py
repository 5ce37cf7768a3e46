"""The port's flash-attention backward against the JAX package's.

The same numpy inputs (``np.random.default_rng``) go through the JAX
``flash_attention`` (its Pallas forward and backward kernels in interpret
mode, as ``tests/test_ops.py`` runs them on the CPU) and through the
port's ``flash_attention``, whose autograd function runs the plain
versions of K1 (forward) and K4 / K5 (backward) on CPU tensors.  Cases:
the four windows of ``tests/test_ops.py``'s backward test (right pad,
left-pad window, prefill into a cache at q_offset 0, non-causal).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.ops import flash_attention as jflash
from seedx_tpu_torch.ops import attention as tattn
from seedx_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(1)

# float32 on both sides (interpret-mode Pallas and the plain torch
# versions), summed in different orders: 2e-4 of the largest gradient
# leaves room for the softmax backward's cancellation in dp - delta.
REL_JAX = 2e-4
# the autograd function and autograd through plain_attention are two fp32
# torch computations of one function: 1e-5 of the largest value
REL_PLAIN = 1e-5

# (q_len, kv_len, starts, ends, q_offset, causal) -- tests/test_ops.py:182-187
CASES = {
    "right_pad": (128, 128, None, [128, 85], None, True),
    "left_pad_window": (128, 128, [15, 0], [128, 100], None, True),
    "prefill_into_cache": (128, 256, [0, 10], [128, 100], 0, True),
    "non_causal": (128, 128, [0, 5], [128, 90], None, False),
}


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _window(b, kv_len, starts, ends):
    starts = np.zeros(b, np.int32) if starts is None else np.asarray(
        starts, np.int32)
    return starts, np.asarray(ends, np.int32)


def _close(actual, expected, rel):
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=rel * np.abs(expected).max())


def _port_grads(q, k, v, g, starts, ends, q_offset, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, starts=torch.from_numpy(starts),
                                 ends=torch.from_numpy(ends),
                                 q_offset=q_offset, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                (qt, kt, vt))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_grads_match_jax(case, d):
    q_len, kv_len, starts, ends, q_offset, causal = CASES[case]
    b, h = 2, 2
    q, k, v, g = _inputs(20 + d, b, q_len, kv_len, h, d)
    starts, ends = _window(b, kv_len, starts, ends)

    def f(q, k, v):
        out = jflash.flash_attention(q, k, v, starts=jnp.asarray(starts),
                                     ends=jnp.asarray(ends),
                                     q_offset=q_offset, causal=causal)
        return (out * g).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out_t, grads_t = _port_grads(q, k, v, g, starts, ends, q_offset, causal)
    _close(out_t, out_j, REL_JAX)
    for name, got, want in zip("qkv", grads_t, grads_j):
        assert np.abs(np.asarray(want)).max() > 0, name
        _close(got, want, REL_JAX)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_bwd_plain_matches_jax_backward_kernels(case):
    """The plain K4 / K5 contract against the JAX backward kernels, given
    the same lse and delta (from the JAX forward)."""
    q_len, kv_len, starts, ends, q_offset, causal = CASES[case]
    b, h, d = 2, 2, 128
    q, k, v, g = _inputs(7, b, q_len, kv_len, h, d)
    starts, ends = _window(b, kv_len, starts, ends)
    qoff = kv_len - q_len if q_offset is None else q_offset
    scale = d ** -0.5
    args = (jnp.asarray(starts), jnp.asarray(ends),
            jnp.asarray([qoff], jnp.int32))
    out_j, lse_j = jflash._flash_forward_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *args, causal, scale,
        128, 128, True)
    delta = jnp.swapaxes(jnp.sum(jnp.asarray(g) * out_j, axis=-1),
                         1, 2)[:, :, None, :]
    grads_j = jflash._flash_backward_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        lse_j, delta, *args, causal, scale, 128, 128, True)
    t = torch.from_numpy
    grads_t = tflash.flash_bwd_plain(
        t(q), t(k), t(v), t(g), t(np.array(lse_j)), t(np.array(delta)),
        t(starts), t(ends), qoff, causal, scale)
    # delta as the port's autograd function computes it
    delta_t = tflash.row_delta(t(g), t(np.array(out_j)))
    _close(delta_t.numpy(), delta, 1e-6)
    for got, want in zip(grads_t, grads_j):
        _close(got.numpy(), want, REL_JAX)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_matches_plain_attention_autograd(case):
    """FlashAttention (plain K1 forward, plain K4 / K5 backward) against
    ordinary autograd through ``plain_attention``; upstream grads are zero
    on query rows that see no key, where the two define different
    outputs (zeros vs a uniform softmax)."""
    q_len, kv_len, starts, ends, q_offset, causal = CASES[case]
    b, h, d = 2, 2, 64
    q, k, v, g = _inputs(9, b, q_len, kv_len, h, d)
    starts, ends = _window(b, kv_len, starts, ends)
    qoff = kv_len - q_len if q_offset is None else q_offset
    q_pos = np.arange(q_len)[None] + qoff
    k_pos = np.arange(kv_len)[None]
    valid = (k_pos >= starts[:, None]) & (k_pos < ends[:, None])
    sees = (valid[:, None, :] & ((q_pos[..., None] >= k_pos[:, None, :])
                                 | (not causal))).any(-1)
    g = g * sees[:, :, None, None]
    out_f, grads_f = _port_grads(q, k, v, g, starts, ends, q_offset, causal)

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    bias = tattn.make_attention_bias(torch.from_numpy(valid), q_len, kv_len,
                                     causal, q_offset=qoff)
    out_p = tattn.plain_attention(qt, kt, vt, bias, d ** -0.5)
    grads_p = torch.autograd.grad((out_p * torch.from_numpy(g)).sum(),
                                  (qt, kt, vt))
    rows = sees[:, :, None, None]
    _close(out_f * rows, out_p.detach().numpy() * rows, REL_PLAIN)
    for got, want in zip(grads_f, grads_p):
        _close(got, want.numpy(), REL_PLAIN)


def test_attention_dispatch_is_differentiable_through_flash():
    """``dot_product_attention(impl="flash")`` with a right-padded kv_valid
    (the training call) gives the same grads as ``impl="plain"`` on the
    rows that see keys."""
    b, s, h, d = 2, 64, 2, 64
    q, k, v, g = _inputs(11, b, s, s, h, d)
    valid = np.arange(s)[None] < np.array([64, 40])[:, None]
    grads = {}
    for impl in ("flash", "plain"):
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = tattn.dot_product_attention(qt, kt, vt,
                                          kv_valid=torch.from_numpy(valid),
                                          causal=True, impl=impl)
        grads[impl] = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                          (qt, kt, vt))
    for got, want in zip(grads["flash"], grads["plain"]):
        _close(got.numpy(), want.numpy(), REL_PLAIN)
