"""The port's ``int4_matmul_auto`` dispatch against the JAX package's.

The reference (``seedx_tpu/ops/int4_matmul.py`` ``int4_matmul_auto``)
runs the W4A8 kernel up to ``max_kernel_rows`` (2048) rows, under
``FORCE_KERNEL`` or on the TPU, and its W4A16 ``int4_matmul_xla`` (bf16
activations, unpacked bf16 weights, one dense dot) above, on every
backend.  The port must take the same branch at the same row counts.
Inputs come from ``np.random.default_rng`` at tiny widths (in 256, out
128, group 128); the port's tensors lie on the CPU, so its W4A8 branch is
the kernel's plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import seedx_tpu.ops.int4_matmul
from seedx_tpu.ops import int4_matmul as jint4
from seedx_tpu.utils import quantize as jquant
from seedx_tpu_torch.ops import int4_matmul as tint4

N_IN, N_OUT, GROUP = 256, 128, 128


def _inputs(rows, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((N_IN, N_OUT)).astype(np.float32) * 0.05
    x = rng.standard_normal((rows, N_IN)).astype(np.float32)
    packed, scale = jquant.quantize_kernel_int4(w, GROUP)
    return x, packed, scale


@pytest.mark.parametrize("lead", [(2049,), (4096,), (2, 2048)])
def test_auto_above_max_rows_is_w4a16_like_jax(monkeypatch, lead):
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    rows = int(np.prod(lead))
    x, packed, scale = _inputs(rows, 11)
    x = x.reshape(*lead, N_IN)
    assert tint4.int4_branch(rows) == "w4a16"
    y_j = np.asarray(jint4.int4_matmul_auto(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scale)), np.float32)
    y_t = tint4.int4_matmul_auto(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed),
        torch.from_numpy(scale))
    assert y_t.dtype == torch.bfloat16 and y_t.shape == (*lead, N_OUT)
    # the same bf16 weights and activations; the bf16 dots accumulate in
    # another order (XLA vs ATen) and round once to bf16: one bf16 ULP of
    # the output scale
    tol = 2 ** -8 * np.abs(y_j).max()
    np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=0, atol=tol)
    # the W4A8 answer (int8 activations) the port gave here before lies
    # outside that tolerance
    w4a8 = tint4.int4_matmul_plain(
        torch.from_numpy(x.reshape(rows, N_IN)).to(torch.bfloat16),
        torch.from_numpy(packed), torch.from_numpy(scale))
    assert np.abs(w4a8.float().numpy() - y_j.reshape(rows, N_OUT)).max() > tol


def test_auto_at_max_rows_is_w4a8_plain_bit_for_bit():
    rows = tint4.MAX_KERNEL_ROWS
    x, packed, scale = _inputs(rows, 12)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    args = (torch.from_numpy(packed), torch.from_numpy(scale))
    assert tint4.int4_branch(rows) == "w4a8"
    assert torch.equal(tint4.int4_matmul_auto(xt, *args),
                       tint4.int4_matmul_plain(xt, *args))
