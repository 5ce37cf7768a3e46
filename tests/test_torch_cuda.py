"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the shapes of the image-in comprehension turn.

Every test is marked ``cuda`` and skips without an NVIDIA GPU.  This file
imports no JAX, so it runs on a machine that has none; the suite's
conftest imports JAX, so on the card run it with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py``.
"""

import pytest
import torch

from seedx_tpu_torch.ops import flash_attention as tflash
from seedx_tpu_torch.ops import int4_matmul as tint4
from seedx_tpu_torch.utils import quantize as tquant


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal,start,end,q_offset", [
    (5, 1024, 1024, 16, 128, False, 0, 1024, 0),   # ViT tiles (104 padded)
    (1, 512, 544, 40, 128, True, 300, 512, 0),     # prefill, left-padded
    (1, 65, 544, 40, 128, True, 300, 577, 512),    # forced image chunk
    (2, 200, 200, 4, 64, True, 7, 190, 0)])        # ragged edges, d 64
def test_flash_kernel_matches_plain(cuda_device, b, sq, skv, h, d, causal,
                                    start, end, q_offset):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda_device
                           ).to(torch.bfloat16) for s in (sq, skv, skv))
    starts = torch.full((b,), start, dtype=torch.int32, device=cuda_device)
    ends = torch.full((b,), end, dtype=torch.int32, device=cuda_device)
    out, lse = tflash.flash_fwd(q, k, v, starts, ends, q_offset, causal,
                                d ** -0.5)
    ref, lse_ref = tflash.flash_fwd_plain(q, k, v, starts, ends, q_offset,
                                          causal, d ** -0.5)
    torch.cuda.synchronize()
    # bf16 output: one bf16 ULP of |out| <= ~4 plus the per-tile rescale
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    live = lse_ref > -1e30
    assert torch.equal(lse > -1e30, live)
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 65, 512])
@pytest.mark.parametrize("n_in,n_out", [(5120, 5120), (5120, 13824),
                                        (13824, 5120)])
def test_int4_kernel_matches_plain(cuda_device, rows, n_in, n_out):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((n_in, n_out), generator=g, device=cuda_device) * 0.02
    packed, scale = tquant.quantize_kernel_int4(w)
    x = torch.randn((rows, n_in), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    out = tint4.int4_matmul(x, packed, scale)
    ref = tint4.int4_matmul_plain(x, packed, scale)
    torch.cuda.synchronize()
    # exact int32 group dots on both sides; fp32 split-K order differs,
    # then one bf16 rounding: two bf16 ULPs of the output magnitude
    tol = 2 * 2 ** -7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
