"""The W4A16 branch's weight dequantization (``dequant_int4``) on the CPU.

``dequant_int4`` turns the packed int4 weight and its fp32 group scales
into the bf16 weight that ``int4_matmul_unpack`` multiplies by.  For CUDA
tensors it launches ``csrc/int4_dequant.cu`` (held to the plain chain bit
for bit by ``tests/test_torch_cuda.py``); for CPU tensors it runs the plain
chain ``dequant_int4_plain``, checked here against the contract written out
element by element, against the JAX package's ``int4_matmul_xla`` on the
same packed bytes, on the views the model passes (a stacked layer, a
tensor-parallel rank's scale rows), and for the inputs it refuses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.ops import int4_matmul as jint4
from seedx_tpu.utils import quantize as jquant
from seedx_tpu_torch.ops import int4_matmul as tint4
from seedx_tpu_torch.ops._build import launches
from seedx_tpu_torch.utils import quantize as tquant


def _contract(packed: np.ndarray, scale: np.ndarray) -> torch.Tensor:
    """w[k, c] = bf16(code * bf16(scale[k // group, c])), the product taken
    in fp32 (exact: 4 x 8 significant bits) and rounded once, element by
    element from numpy's nibbles."""
    half, n_out = packed.shape
    nib = np.stack([packed & 0xF, packed >> 4], axis=1).reshape(2 * half,
                                                                n_out)
    code = np.where(nib >= 8, nib.astype(np.int32) - 16, nib)
    group = 2 * half // scale.shape[0]
    s = torch.from_numpy(np.repeat(scale, group, axis=0)).to(torch.bfloat16)
    return (torch.from_numpy(code.astype(np.float32)) * s.float()).to(
        torch.bfloat16)


def _random(half, n_out, n_groups, seed):
    """Every byte value (code -8 too, which the quantizer never writes) and
    scales spread over six decades, most not bf16 values."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (half, n_out), dtype=np.uint8)
    scale = (10.0 ** rng.uniform(-5, 1, (n_groups, n_out))).astype(np.float32)
    return packed, scale


@pytest.mark.parametrize("n_in,n_out,group", [(256, 128, 128),
                                              (512, 256, 64),
                                              (192, 48, 192), (96, 16, 32)])
def test_dequant_plain_is_the_contract_bit_for_bit(n_in, n_out, group):
    packed, scale = _random(n_in // 2, n_out, n_in // group, n_in + n_out)
    w = tint4.dequant_int4_plain(torch.from_numpy(packed),
                                 torch.from_numpy(scale))
    assert w.dtype == torch.bfloat16 and w.shape == (n_in, n_out)
    assert torch.equal(w, _contract(packed, scale))
    # the wrapper runs the same chain for CPU tensors
    assert torch.equal(tint4.dequant_int4(torch.from_numpy(packed),
                                          torch.from_numpy(scale)), w)


@pytest.mark.parametrize("n_in,n_out,group", [(256, 128, 128),
                                              (512, 256, 64),
                                              (384, 64, 384)])
def test_dequant_product_matches_jax_xla(n_in, n_out, group):
    """The same packed bytes through JAX's W4A16 ``int4_matmul_xla`` and the
    port's ``x @ dequant_int4(...)``: bit-equal weights (x the identity:
    each output one product, exact in both), and products of random x
    within a few bf16 ULPs (the dots accumulate in another order)."""
    rng = np.random.default_rng(group)
    w = rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.05
    packed, scale = jquant.quantize_kernel_int4(w, group)
    assert scale.shape == (n_in // group, n_out)
    pt, st = torch.from_numpy(packed), torch.from_numpy(scale)
    eye = np.eye(n_in, dtype=np.float32)
    w_j = np.asarray(jint4.int4_matmul_xla(jnp.asarray(eye, jnp.bfloat16),
                                           jnp.asarray(packed),
                                           jnp.asarray(scale), group),
                     np.float32)
    assert np.array_equal(tint4.dequant_int4(pt, st).float().numpy(), w_j)
    x = rng.standard_normal((7, n_in)).astype(np.float32)
    y_j = np.asarray(jint4.int4_matmul_xla(jnp.asarray(x, jnp.bfloat16),
                                           jnp.asarray(packed),
                                           jnp.asarray(scale), group),
                     np.float32)
    y_t = tint4.int4_matmul_unpack(torch.from_numpy(x).to(torch.bfloat16),
                                   pt, st)
    assert torch.equal(y_t, torch.from_numpy(x).to(torch.bfloat16)
                       @ tint4.dequant_int4_plain(pt, st))
    np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=0,
                               atol=4 * 2 ** -8 * np.abs(y_j).max())


@pytest.mark.parametrize("li", [0, 2])
@pytest.mark.parametrize("rank,tensor", [(None, 1), (0, 2), (1, 2), (3, 4)])
def test_dequant_stacked_layer_and_tensor_rank_views(li, rank, tensor):
    """``packed[li]`` of a stacked weight and a rank's row slice of its
    scale (``models/layers.py``'s row-parallel shard): the rows of the whole
    layer's weight, taken from views without a copy."""
    g = torch.Generator().manual_seed(li + 10 * tensor)
    n_in, n_out, group = 1024, 64, 128
    packed, scale = tquant.quantize_kernel_int4(
        torch.randn((3, n_in, n_out), generator=g) * 0.02, group)
    whole = _contract(packed[li].numpy(), scale[li].numpy())
    p, s = packed[li], scale[li]
    rows = slice(None)
    if rank is not None:
        n = n_in // tensor
        rows = slice(rank * n, (rank + 1) * n)
        p = p[rank * n // 2:(rank + 1) * n // 2]
        s = s[rank * n // group:(rank + 1) * n // group]
    assert p._base is not None and s._base is not None     # views
    assert torch.equal(tint4.dequant_int4(p, s), whole[rows])


@pytest.mark.parametrize("packed,scale,what", [
    (torch.zeros((3, 16), dtype=torch.uint8),
     torch.ones((2, 16)), "odd"),                          # group 3
    (torch.zeros((4, 16), dtype=torch.int8),
     torch.ones((1, 16)), "uint8"),
    (torch.zeros((4, 16), dtype=torch.uint8),
     torch.ones((1, 16), dtype=torch.bfloat16), "float32"),
    (torch.zeros((4, 16), dtype=torch.uint8),
     torch.ones((1, 16), dtype=torch.float64), "float32"),
    (torch.zeros((4, 16), dtype=torch.uint8),
     torch.ones((1, 32)), "packed"),                       # columns differ
    (torch.zeros((4, 16), dtype=torch.uint8),
     torch.ones((3, 16)), "packed"),                       # 3 groups of 8 in
    (torch.zeros((4, 16), dtype=torch.uint8),
     torch.ones((0, 16)), "packed"),
    (torch.zeros((2, 4, 16), dtype=torch.uint8),
     torch.ones((2, 1, 16)), "packed"),                    # stacked, not [li]
])
def test_dequant_refuses(packed, scale, what):
    with pytest.raises(ValueError, match=what):
        tint4.dequant_int4(packed, scale)


def test_dequant_counter_registered_and_not_bumped_on_cpu():
    """The kernel's launch counter exists at zero; the CPU path, through
    ``int4_matmul_auto``'s W4A16 branch too, launches nothing."""
    assert launches["int4_dequant"] == 0
    packed, scale = _random(128, 32, 2, 5)
    x = torch.randn((tint4.MAX_KERNEL_ROWS + 1, 256)).to(torch.bfloat16)
    y = tint4.int4_matmul_auto(x, torch.from_numpy(packed),
                               torch.from_numpy(scale))
    assert torch.equal(y, x @ _contract(packed, scale))
    assert launches["int4_dequant"] == 0
