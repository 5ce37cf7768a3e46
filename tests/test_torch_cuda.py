"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the shapes of the image-in comprehension turn, of batched decode,
of the SFT train step and adapter training (the flash backward) and of the
SDXL UNet (K1 in its self-attention, and the UNet with K1 against the
plain attention; its GroupNorm (+ SiLU) and LayerNorm kernels and its
Dense epilogue kernels at the eval's shapes, inside a captured eval and
under autograd; the adapter's
diffusion loss and
grads with K1 / K4 / K5 against the CPU's plain path).

Every test is marked ``cuda`` and skips without an NVIDIA GPU.  This file
imports no JAX, so it runs on a machine that has none; the suite's
conftest imports JAX, so on the card run it with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py``.
"""

import pytest
import torch

from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.sdxl import unet as tunet
from seedx_tpu_torch.ops import attention as tattn
from seedx_tpu_torch.ops import decode_attention as tdecode
from seedx_tpu_torch.ops import epilogue as tepi
from seedx_tpu_torch.ops import flash_attention as tflash
from seedx_tpu_torch.ops import int4_matmul as tint4
from seedx_tpu_torch.ops import norms as tnorms
from seedx_tpu_torch.ops._build import launches
from seedx_tpu_torch.utils import quantize as tquant
from seedx_tpu_torch.utils.quantize import quantize_unet_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda", 0)


def _per_row(x, b):
    return list(x) if isinstance(x, (tuple, list)) else [x] * b


def flash_limit(ref: torch.Tensor) -> float:
    """K1's output limit against its plain version: 2e-2 of the largest
    output, at most 2e-2.  Both round the output to bf16 once; the kernel
    rounds P to bf16 against each tile's running max, the plain version
    against the row's max, so they differ by a few bf16 ULPs of the outputs'
    scale (a softmax over 4096 keys averages v down to |out| ~ 0.02, where a
    fixed 2e-2 would pass anything)."""
    return 2e-2 * min(1.0, ref.float().abs().max().item())


def reachable_tiles(d: int, causal: bool):
    """The block tiles ``tile_shape`` can pick for this head dim and mask:
    its choice at a one-block grid and at a grid that fills the card."""
    sms = tflash.sm_count(0)
    return sorted({tflash.tile_shape(b, sq, h, d, causal, sms)
                   for b, sq, h in ((1, 64, 1), (64, 4096, 64))})


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal,start,end,q_offset", [
    (5, 1024, 1024, 16, 128, False, 0, 1024, 0),   # ViT tiles (104 padded)
    (1, 512, 544, 40, 128, True, 300, 512, 0),     # prefill, left-padded
    (1, 65, 544, 40, 128, True, 300, 577, 512),    # forced image chunk
    (2, 200, 200, 4, 64, True, 7, 190, 0),         # ragged edges, d 64
    # the SFT step: comprehension 2 x 880 and generation 8 x 260, causal,
    # right-padded; the 8-tile train ViT
    (2, 880, 880, 40, 128, True, 0, (880, 611), 0),
    (8, 260, 260, 40, 128, True, 0,
     (260, 211, 174, 260, 143, 238, 197, 160), 0),
    (8, 1024, 1024, 16, 128, False, 0, 1024, 0),
    # the SDXL UNet's self-attention (CFG batch 2) and the D 64 windows the
    # flash backward checks read lse from
    (2, 4096, 4096, 10, 64, False, 0, 4096, 0),
    (2, 1024, 1024, 20, 64, False, 0, 1024, 0),
    # ... and at the edit UNet's CFG batch 3
    (3, 4096, 4096, 10, 64, False, 0, 4096, 0),
    (3, 1024, 1024, 20, 64, False, 0, 1024, 0),
    (2, 512, 512, 16, 64, False, (0, 7), (512, 400), 0),
    # tile edges: q_offset and window start off the 64 grid, Sq < 64, a
    # row with an empty window, causal rows wholly before the window (dead
    # rows), D 64 causal
    (1, 100, 300, 4, 128, True, 37, 290, 171),
    (3, 20, 150, 8, 128, True, (5, 0, 64), (150, 149, 130), 130),
    (2, 7, 64, 2, 64, False, 0, 64, 0),
    (2, 70, 70, 4, 128, False, (0, 30), (70, 30), 0),
    (1, 200, 200, 4, 64, True, 100, 200, 0),
    (2, 333, 333, 6, 64, True, (0, 45), (333, 301), 0)])
def test_flash_kernel_matches_plain(cuda_device, monkeypatch, b, sq, skv, h,
                                    d, causal, start, end, q_offset):
    """K1 against its plain version at every block tile the wrapper can
    pick for this head dim and mask (64 or 128 q rows: one or two
    warpgroups; 64 or 128 keys)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda_device
                           ).to(torch.bfloat16) for s in (sq, skv, skv))
    starts = torch.tensor(_per_row(start, b), dtype=torch.int32,
                          device=cuda_device)
    ends = torch.tensor(_per_row(end, b), dtype=torch.int32,
                        device=cuda_device)
    ref, lse_ref = tflash.flash_fwd_plain(q, k, v, starts, ends, q_offset,
                                          causal, d ** -0.5)
    live = lse_ref > -1e30
    tiles = reachable_tiles(d, causal)
    assert set(tiles) <= set(tflash.TILES[d])
    for tile in tiles:
        monkeypatch.setattr(tflash, "tile_shape", lambda *a, t=tile: t)
        n1 = launches["flash_fwd"]
        out, lse = tflash.flash_fwd(q, k, v, starts, ends, q_offset, causal,
                                    d ** -0.5)
        torch.cuda.synchronize()
        assert launches["flash_fwd"] - n1 == 1
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=flash_limit(ref))
        # the same dead rows, lse exactly NEG_INF there (K4 / K5 read it)
        assert torch.equal(lse > -1e30, live)
        assert (lse[~live] == tattn.NEG_INF).all()
        torch.testing.assert_close(lse[live], lse_ref[live], rtol=0,
                                   atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_descriptor_tile(cuda_device, d):
    """K1's wgmma descriptors and fragment layouts on one tile: S = Q K^T
    (both K-major, swizzled) against torch.matmul, and O = bf16(S) V (P
    from the accumulator registers, V MN-major) against torch.matmul of
    the kernel's own S rounded to bf16."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn((64, d), generator=g, device=cuda_device
                           ).to(torch.bfloat16) for _ in range(3))
    s, o = tflash.wgmma_tile_debug(q, k, v)
    torch.cuda.synchronize()
    # exact bf16 products summed in fp32 in another order
    s_ref = q.float() @ k.float().T
    torch.testing.assert_close(s, s_ref, rtol=0,
                               atol=1e-5 * s_ref.abs().max().item())
    o_ref = s.to(torch.bfloat16).float() @ v.float()
    torch.testing.assert_close(o, o_ref, rtol=0,
                               atol=1e-5 * o_ref.abs().max().item())


def _int4_inputs(dev, rows, n_in, n_out, group=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((n_in, n_out), generator=g, device=dev) * 0.02
    packed, scale = tquant.quantize_kernel_int4(w, group)
    x = torch.randn((rows, n_in), generator=g, device=dev).to(torch.bfloat16)
    return x, packed, scale


def _int4_close(out, ref):
    # exact int32 group dots on both sides; fp32 split-K order and FMA
    # against mul + add differ, then one bf16 rounding: two bf16 ULPs of
    # the output magnitude
    tol = 2 * 2 ** -7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 24, 65, 512, 2048])
@pytest.mark.parametrize("n_in,n_out", [(5120, 5120), (5120, 13824),
                                        (13824, 5120), (128, 256),
                                        (256, 128)])
def test_int4_kernel_matches_plain(cuda_device, rows, n_in, n_out):
    x, packed, scale = _int4_inputs(cuda_device, rows, n_in, n_out)
    out = tint4.int4_matmul(x, packed, scale)
    ref = tint4.int4_matmul_plain(x, packed, scale)
    torch.cuda.synchronize()
    assert out.shape == (rows, n_out) and out.dtype == torch.bfloat16
    _int4_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 17, 65])
@pytest.mark.parametrize("n_in,group", [(384, 96), (192, 192), (640, 128),
                                        (1024, 512)])
@pytest.mark.parametrize("tile", tint4.ROW_TILES)
def test_int4_kernel_groups_and_tiles(cuda_device, rows, n_in, group, tile):
    """Every built row tile, groups that are not a multiple of 128 (96:
    a zero-filled k tail in the last 32-k step of every group; 192: two
    k-tiles a group, the second half empty), a group above 256 (its dots
    converted by I2F), and every split count."""
    x, packed, scale = _int4_inputs(cuda_device, rows, n_in, 256, group)
    ref = tint4.int4_matmul_plain(x, packed, scale)
    for splits in range(1, n_in // group + 1):
        out = tint4.int4_matmul(x, packed, scale, _tile=tile,
                                _splits=splits)
        torch.cuda.synchronize()
        _int4_close(out, ref)


def _b_expected(w):
    """[warp][k-step][lane][n-tile][2] int32: the B registers of the
    m16n8k32 fragments (4 k of one column a register, 16x the codes) the
    kernel should build from the codes w [128 k, 128 columns]: lane (n, q)
    holds column 32 w + 4 n + j of n-tile j, and k 8 q .. 8 q + 3 (first
    register) and 8 q + 4 .. 8 q + 7 (second) of each 32-k step."""
    regs = torch.empty((4, 4, 32, 4, 2, 4), dtype=torch.int8)
    for warp in range(4):
        for s in range(4):
            for lane in range(32):
                q, n = lane & 3, lane >> 2
                for j in range(4):
                    col = 32 * warp + 4 * n + j
                    for h in range(2):
                        k0 = 32 * s + 8 * q + 4 * h
                        regs[warp, s, lane, j, h] = 16 * w[k0:k0 + 4, col]
    return regs.view(torch.int32).reshape(4, 4, 32, 4, 2)


@pytest.mark.cuda
def test_int4_b_fragments(cuda_device):
    """The B registers each lane builds from a known packed tile: the nibble
    unpack (16x codes, no sign extension), the column and k order."""
    g = torch.Generator().manual_seed(3)
    w = torch.randint(-8, 8, (128, 128), generator=g, dtype=torch.int16)
    packed = ((w[0::2] & 0xF) | ((w[1::2] & 0xF) << 4)).to(torch.uint8)
    got = tint4.b_fragments(packed.to(cuda_device)).cpu()
    assert torch.equal(got, _b_expected(w.to(torch.int8)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_in,n_out", [(1, 5120, 5120),
                                             (24, 5120, 13824),
                                             (65, 13824, 5120)])
def test_int4_split_k_bit_equal_over_runs(cuda_device, rows, n_in, n_out):
    """Split-K merges in split order whatever block finishes last: three
    runs at each split count give equal bits (and the tickets are left
    at zero for the next call), each within the tolerance of the plain
    version."""
    x, packed, scale = _int4_inputs(cuda_device, rows, n_in, n_out, seed=9)
    ref = tint4.int4_matmul_plain(x, packed, scale)
    for splits in (0, 2, 7, n_in // 128):
        runs = [tint4.int4_matmul(x, packed, scale, _splits=splits)
                for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0],
                                                             runs[2])
        _int4_close(runs[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 65, 512])
def test_int4_two_launches_a_call(cuda_device, rows):
    """One K2 call is at most two kernels on the card (the row
    quantization and the matmul with its split merge), counted by
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, packed, scale = _int4_inputs(cuda_device, rows, 5120, 5120)
    tint4.int4_matmul(x, packed, scale)          # build, first launch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tint4.int4_matmul(x, packed, scale)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "memset" not in e.name.lower()
               and "memcpy" not in e.name.lower()]
    assert 1 <= len(kernels) <= 2, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("rows,branch", [(2048, "w4a8"), (2049, "w4a16"),
                                         (2560, "w4a16"), (3072, "w4a16"),
                                         (4096, "w4a16")])
def test_int4_auto_dispatch_on_card(cuda_device, rows, branch):
    """int4_matmul_auto on the card: K2 (W4A8) up to MAX_KERNEL_ROWS rows,
    the W4A16 dequant-and-dot above, as the reference dispatches.  A W4A16
    call is one dequant launch and no K2 launch, and its output is the
    plain chain's ``x @ dequant_int4_plain(...)`` bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    w = torch.randn((512, 256), generator=g, device=cuda_device) * 0.02
    packed, scale = tquant.quantize_kernel_int4(w)
    x = torch.randn((rows, 512), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    n2, nd = launches["int4_w4a8"], launches["int4_dequant"]
    out = tint4.int4_matmul_auto(x, packed, scale)
    torch.cuda.synchronize()
    assert tint4.int4_branch(rows) == branch
    assert launches["int4_w4a8"] - n2 == (branch == "w4a8")
    assert launches["int4_dequant"] - nd == (branch == "w4a16")
    if branch == "w4a16":
        assert torch.equal(out, x @ tint4.dequant_int4_plain(packed, scale))


def _dequant_inputs(dev, n_in, n_out, group, lead=(), seed=0):
    """Every byte value (code -8 too) and scales over six decades, most of
    them no bf16 value: the kernel's decode and both roundings."""
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (*lead, n_in // 2, n_out), generator=g,
                           device=dev, dtype=torch.uint8)
    scale = 10.0 ** (6 * torch.rand((*lead, n_in // group, n_out),
                                    generator=g, device=dev) - 5)
    return packed, scale


DEQUANT_7B = [(4096, 4096), (4096, 11008), (11008, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out,group", [
    *[(i, o, 128) for i, o in DEQUANT_7B],
    (5120, 13824, 128), (13824, 5120, 128),     # the 13B's
    (384, 48, 96),        # 3 vectors a row (< 32: one narrow strip, 85
                          # rows deep), so a thread's rows lie in two or
                          # three groups of 48 packed rows
    (200, 640, 200),      # group = in; 100 packed rows, a ragged last chunk;
                          # 40 vectors, a ragged second strip
    (256, 16, 32), (256, 16, 2),
    (256, 24, 128)])      # 3 vectors a row: out a multiple of 8, not 16
def test_int4_dequant_kernel_bit_equal(cuda_device, n_in, n_out, group):
    """The dequant kernel against the plain chain on the card, bit for bit,
    one launch a call."""
    packed, scale = _dequant_inputs(cuda_device, n_in, n_out, group)
    nd = launches["int4_dequant"]
    w = tint4.dequant_int4(packed, scale)
    torch.cuda.synchronize()
    assert launches["int4_dequant"] - nd == 1
    assert w.shape == (n_in, n_out) and w.dtype == torch.bfloat16
    assert torch.equal(w, tint4.dequant_int4_plain(packed, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out", DEQUANT_7B)
@pytest.mark.parametrize("tensor", [1, 2])
def test_int4_dequant_kernel_views(cuda_device, n_in, n_out, tensor):
    """A layer ``packed[li]`` of stacked weights and, at tensor 2, each
    rank's rows of it with its row slice of the scales (the row-parallel
    shard of ``models/layers.py``): the whole layer's rows, bit for bit."""
    packed, scale = _dequant_inputs(cuda_device, n_in, n_out, 128, (2,),
                                    seed=7)
    whole = tint4.dequant_int4_plain(packed[1].contiguous(),
                                     scale[1].contiguous())
    n = n_in // tensor
    for rank in range(tensor):
        p = packed[1][rank * n // 2:(rank + 1) * n // 2]
        s = scale[1][rank * n // 128:(rank + 1) * n // 128]
        w = tint4.dequant_int4(p, s)
        torch.cuda.synchronize()
        assert torch.equal(w, whole[rank * n:(rank + 1) * n])


@pytest.mark.cuda
def test_int4_dequant_kernel_refuses(cuda_device):
    """On the card the wrapper raises where the kernel's layout does not
    hold: columns off the 8-column vector, a view that is not contiguous,
    a misaligned pointer.  Nothing is launched."""
    packed, scale = _dequant_inputs(cuda_device, 256, 64, 128)
    nd = launches["int4_dequant"]
    with pytest.raises(ValueError, match="multiple of 8"):
        tint4.dequant_int4(packed[:, :20].contiguous(),
                           scale[:, :20].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tint4.dequant_int4(packed[:, :32], scale[:, :32].contiguous())
    flat = torch.zeros(128 * 64 + 1, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        tint4.dequant_int4(flat[1:].view(128, 64), scale)
    assert launches["int4_dequant"] == nd


def _quantize_rows(x):
    """Per-(position, head) int8 codes and bf16 scales (llama.quantize_kv)."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    sc = torch.clamp(amax, min=1e-6) / 127.0
    return torch.round(x.float() / sc).to(torch.int8), sc.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,int8,paged,windows", [
    (1, 1280, 40, 40, 128, True, False, [(0, 300)]),
    (8, 1280, 40, 40, 128, True, False,
     [(0, 1280), (5, 6), (3, 3), (100, 900), (0, 1), (1279, 1280),
      (640, 1100), (7, 1000)]),
    (8, 1280, 40, 40, 128, False, False,
     [(0, 1280), (5, 6), (3, 3), (100, 900), (0, 1), (1279, 1280),
      (640, 1100), (7, 1000)]),
    (4, 1280, 40, 40, 128, True, True, [(0, 1280), (9, 10), (0, 0),
                                       (300, 1001)]),
    (3, 512, 40, 8, 128, False, False, [(0, 512), (17, 300), (2, 2)]),
    # Nemotron-H's GQA, G 16, over a 64-slot engine's windows
    (8, 1536, 32, 2, 128, False, False,
     [(0, 1536), (0, 1), (0, 700), (0, 129), (0, 64), (0, 1000), (0, 257),
      (0, 1535)]),
    (3, 200, 8, 2, 64, True, True, [(0, 200), (33, 34), (5, 150)]),
    (2, 96, 4, 4, 32, True, False, [(0, 96), (10, 55)]),
    (2, 96, 4, 4, 32, False, True, [(4, 90), (0, 0)])])
def test_decode_kernel_matches_plain(cuda_device, b, s, hq, hkv, d, int8,
                                     paged, windows):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dev = cuda_device
    q = torch.randn((b, hq, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev)
    v = torch.randn((b, s, hkv, d), generator=g, device=dev)
    kw = {}
    if int8:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        kw = dict(k_scale=ks[..., 0], v_scale=vs[..., 0])
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    k, v = k.reshape(b, s, hkv * d), v.reshape(b, s, hkv * d)
    if paged:
        page = 32 if s % 32 == 0 else 8
        n_tiles = s // page
        perm = torch.randperm(2 * b * n_tiles, generator=g, device=dev)
        tables = perm[:b * n_tiles].reshape(b, n_tiles).to(torch.int32)
        rows = (tables.long()[:, :, None] * page
                + torch.arange(page, device=dev)).reshape(b, s)

        def pool(x):
            out = torch.zeros((2 * b * n_tiles * page,) + x.shape[2:],
                              dtype=x.dtype, device=dev)
            out[rows] = x
            return out

        k, v = pool(k), pool(v)
        kw = {n: pool(t) for n, t in kw.items()}
        kw.update(block_tables=tables.contiguous(), page=page)
    starts = torch.tensor([w[0] for w in windows], dtype=torch.int32,
                          device=dev)
    ends = torch.tensor([w[1] for w in windows], dtype=torch.int32,
                        device=dev)
    out = tdecode.ragged_decode_attention(q, k, v, starts, ends, **kw)
    ref = tdecode.ragged_decode_attention_plain(q, k, v, starts, ends, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (b, hq, d)
    # bf16 output of O(1): one bf16 ULP of |out| plus fp32 summation order
    # and the per-warp online-softmax rescale, as for the flash kernel
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    empty = (ends <= starts).nonzero()[:, 0]
    assert (out[empty] == 0).all()


def _stair_inputs(dev, g, b, w, s, hq, hkv, d, int8, page):
    """q [B, w, Hq, D] and a dense or paged (shuffled pages) cache."""
    q = torch.randn((b, w, hq, d), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=dev)
    v = torch.randn((b, s, hkv, d), generator=g, device=dev)
    kw = {}
    if int8:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
        kw = dict(k_scale=ks[..., 0], v_scale=vs[..., 0])
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    k, v = k.reshape(b, s, hkv * d), v.reshape(b, s, hkv * d)
    if page:
        n_tiles = s // page
        perm = torch.randperm(2 * b * n_tiles, generator=g, device=dev)
        tables = perm[:b * n_tiles].reshape(b, n_tiles).to(torch.int32)
        rows = (tables.long()[:, :, None] * page
                + torch.arange(page, device=dev)).reshape(b, s)

        def pool(x):
            out = torch.zeros((2 * b * n_tiles * page,) + x.shape[2:],
                              dtype=x.dtype, device=dev)
            out[rows] = x
            return out

        k, v = pool(k), pool(v)
        kw = {n: pool(t) for n, t in kw.items()}
        kw.update(block_tables=tables.contiguous(), page=page)
    return q, k, v, kw


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 8, 16, 64])
@pytest.mark.parametrize("b,s,hq,hkv,d,int8,page", [
    (8, 640, 40, 40, 128, True, 0),      # the 13B serving cache, int8
    (8, 640, 40, 40, 128, True, 128),    # the same, paged
    (8, 640, 40, 8, 128, False, 0),      # bf16 GQA, G 5
    (3, 96, 8, 2, 64, True, 32),         # G 4, D 64, paged
    (2, 96, 4, 4, 32, False, 0)])        # D 32
def test_stair_kernel_matches_plain(cuda_device, w, b, s, hq, hkv, d, int8,
                                    page):
    """Multi-query mode: rows prefilling at offsets 0 / 64 / 300, rows
    decoding, a row whose stair steps past the cache end (clamped), an
    empty window."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, kw = _stair_inputs(cuda_device, g, b, w, s, hq, hkv, d, int8,
                                page)
    wins = [(0, 1), (0, 65), (0, 301), (0, s - 3), (5, 40), (7, 7),
            (0, 200 % s), (0, s)][:b]
    starts = torch.tensor([x[0] for x in wins], dtype=torch.int32,
                          device=cuda_device)
    ends = torch.tensor([min(x[1], s) for x in wins], dtype=torch.int32,
                        device=cuda_device)
    out = tdecode.ragged_decode_attention(q, k, v, starts, ends, **kw)
    ref = tdecode.ragged_decode_attention_plain(q, k, v, starts, ends, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (b, w, hq, d)
    # bf16 output of O(1), as for the one-query mode
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    if w == 1:
        one = tdecode.ragged_decode_attention(q[:, 0].contiguous(), k, v,
                                              starts, ends, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[:, 0], one)


# K3's window split: (w, 0 for the one-query mode; B, S, Hq, Hkv, D,
# int8, page, windows).  Windows shorter than a tile and than a split, a
# chunk starting off a page boundary so its tiles cross pages of 32, stair
# rows clamped at S, empty windows, groups of slots (w 64 at G 5), and
# chunks of more pages of 8 than a block keeps in shared memory.
SPLIT_CASES = [
    (0, 8, 1280, 40, 40, 128, True, 0,
     [(0, 1280), (5, 40), (3, 3), (100, 900), (0, 1), (1279, 1280),
      (640, 1100), (7, 1000)]),
    (0, 3, 512, 40, 8, 128, False, 0, [(0, 512), (17, 300), (2, 2)]),
    (0, 4, 256, 8, 2, 64, True, 32, [(17, 100), (0, 256), (31, 33),
                                     (0, 0)]),
    (16, 4, 640, 40, 40, 128, True, 0, [(0, 1), (0, 301), (0, 637),
                                        (9, 9)]),
    (8, 3, 640, 40, 8, 128, False, 32, [(0, 65), (40, 639), (7, 7)]),
    (64, 2, 192, 10, 2, 64, True, 32, [(0, 150), (3, 185)]),
    (0, 2, 1024, 8, 8, 64, True, 8, [(0, 1024), (3, 900)])]


def _split_case(dev, w, b, s, hq, hkv, d, int8, page, windows, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, kw = _stair_inputs(dev, g, b, max(w, 1), s, hq, hkv, d, int8,
                                page)
    if w == 0:
        q = q[:, 0].contiguous()
    starts = torch.tensor([x[0] for x in windows], dtype=torch.int32,
                          device=dev)
    ends = torch.tensor([x[1] for x in windows], dtype=torch.int32,
                        device=dev)
    return q, k, v, starts, ends, kw


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 32])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_decode_kernel_forced_splits_match_plain(cuda_device, case, splits):
    """K3 at a forced split count (32, the most it takes: more splits
    than any window here has tiles) against the plain version; empty
    windows exactly zero."""
    w, b, s, hq, hkv, d, int8, page, windows = SPLIT_CASES[case]
    q, k, v, starts, ends, kw = _split_case(cuda_device, *SPLIT_CASES[case],
                                            seed=case)
    out = tdecode.ragged_decode_attention(q, k, v, starts, ends,
                                          _splits=splits, **kw)
    ref = tdecode.ragged_decode_attention_plain(q, k, v, starts, ends, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    # bf16 output of O(1): one bf16 ULP of |out| plus fp32 summation order
    # and the rounding of p against each split's running maximum
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    empty = (ends <= starts).nonzero()[:, 0]
    if w == 0:
        assert (out[empty] == 0).all()
    else:
        assert (out[empty, 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [0, 3])
def test_decode_kernel_bit_equal_over_runs(cuda_device, splits):
    """The split merge runs in split order whatever block finishes last,
    so two runs (and a run after the tickets were used) give equal bits."""
    for case in (0, 4):
        q, k, v, starts, ends, kw = _split_case(
            cuda_device, *SPLIT_CASES[case], seed=7)
        runs = [tdecode.ragged_decode_attention(q, k, v, starts, ends,
                                                _splits=splits, **kw)
                for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0],
                                                             runs[2])


# (B, Sq, Skv, H, D, causal, starts, ends, q_offset): the SFT batches'
# shapes (comprehension 2 x 880, generation 8 x 260, right-padded), adapter
# training's UNet self-attention at 1024^2 (levels 1 and 2, batch 2), a
# D 64 non-causal window, prefill into a cache, a left-pad window
FLASH_BWD_CASES = [
    (2, 880, 880, 40, 128, True, [0, 0], [880, 611], 0),
    (8, 260, 260, 40, 128, True, [0] * 8,
     [260, 200, 150, 260, 90, 233, 260, 17], 0),
    (2, 4096, 4096, 10, 64, False, [0, 0], [4096, 4096], 0),
    (2, 1024, 1024, 20, 64, False, [0, 0], [1024, 1024], 0),
    (2, 200, 200, 4, 64, False, [7, 0], [190, 200], 0),
    (2, 128, 256, 2, 64, True, [0, 10], [256, 200], 0),
    (2, 256, 256, 2, 128, True, [30, 0], [256, 200], 0)]


def _flash_bwd_inputs(dev, b, sq, skv, h, d, causal, st, en, q_offset):
    g = torch.Generator(device=dev).manual_seed(2)
    q, do = (torch.randn((b, sq, h, d), generator=g, device=dev
                         ).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, skv, h, d), generator=g, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    starts = torch.tensor(st, dtype=torch.int32, device=dev)
    ends = torch.tensor(en, dtype=torch.int32, device=dev)
    out, lse = tflash.flash_fwd(q, k, v, starts, ends, q_offset, causal,
                                d ** -0.5)
    return (q, k, v, do, lse, tflash.row_delta(do, out), starts, ends,
            q_offset, causal, d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal,st,en,q_offset",
                         FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda_device, b, sq, skv, h, d, causal,
                                       st, en, q_offset):
    args = _flash_bwd_inputs(cuda_device, b, sq, skv, h, d, causal, st, en,
                             q_offset)
    n4, n5 = launches["flash_bwd_dq"], launches["flash_bwd_dkv"]
    got = tflash.flash_bwd(*args)
    again = tflash.flash_bwd(*args)
    ref = tflash.flash_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (launches["flash_bwd_dq"] - n4,
            launches["flash_bwd_dkv"] - n5) == (2, 2)
    for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, name
        # one writer per tile, no atomics: two runs give the same bits
        assert torch.equal(a, a2), name
        # P and dS enter the tensor cores as bf16 and the output is
        # rounded to bf16 (2^-8 of it): 1e-2 of the largest gradient
        torch.testing.assert_close(
            a.float(), r.float(), rtol=0,
            atol=1e-2 * r.float().abs().max().item())


# K4 / K5 tile edges: window start and end inside a tile, Sq and Skv off
# every tile with q_offset > 0 and Sq < Skv, fully masked rows (a causal
# window that starts after them, an empty window), Sq below one tile
FLASH_BWD_EDGE_CASES = [
    (2, 200, 200, 4, 128, True, [37, 5], [170, 133], 0),
    (1, 100, 300, 4, 128, True, [37], [290], 171),
    (3, 20, 150, 8, 128, True, [5, 0, 64], [150, 149, 130], 130),
    (2, 333, 333, 6, 64, True, [0, 45], [333, 301], 0),
    (1, 200, 200, 4, 64, True, [100], [200], 0),
    (2, 70, 70, 4, 128, False, [0, 30], [70, 30], 0),
    (2, 7, 64, 2, 64, False, [0, 0], [64, 64], 0),
    (2, 150, 190, 3, 64, False, [11, 0], [180, 77], 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,causal,st,en,q_offset",
                         FLASH_BWD_CASES + FLASH_BWD_EDGE_CASES)
def test_flash_bwd_every_tile_matches_plain(cuda_device, monkeypatch, b, sq,
                                            skv, h, d, causal, st, en,
                                            q_offset):
    """K4 and K5 at every block tile built for the head dim (forced by
    monkeypatch, the i-th of each kernel's list together): within 1e-2 of
    the largest gradient of the plain version, the same bits over two runs,
    and zero grads for dead rows (dq) and for keys no row sees (dk, dv),
    whose outputs start as torch.empty."""
    args = _flash_bwd_inputs(cuda_device, b, sq, skv, h, d, causal, st, en,
                             q_offset)
    ref = tflash.flash_bwd_plain(*args)
    # rows with no live key (dq) and keys no row sees (dk, dv): zero
    mask = tflash._window_mask(args[6], args[7], sq, skv, q_offset, causal,
                               cuda_device).expand(b, 1, sq, skv)[:, 0]
    dead = (~mask.any(-1), ~mask.any(-2), ~mask.any(-2))     # [B, S]
    built = tflash.BWD_TILES[d]
    for i in range(max(len(built["dq"]), len(built["dkv"]))):
        pair = (built["dq"][i % len(built["dq"])],
                built["dkv"][i % len(built["dkv"])])
        monkeypatch.setattr(tflash, "bwd_tile_shape", lambda *a, p=pair: p)
        got = tflash.flash_bwd(*args)
        again = tflash.flash_bwd(*args)
        torch.cuda.synchronize()
        for name, a, a2, r, z in zip(("dq", "dk", "dv"), got, again, ref,
                                     dead):
            assert torch.equal(a, a2), (name, pair)
            torch.testing.assert_close(
                a.float(), r.float(), rtol=0,
                atol=1e-2 * r.float().abs().max().item(),
                msg=lambda m, n=name, p=pair: f"{n} at tiles {p}: {m}")
            assert not a[z].any(), (name, pair)


@pytest.mark.cuda
def test_flash_autograd_matches_plain_autograd_on_card(cuda_device):
    """FlashAttention on the card (K1 forward, K4 / K5 backward) against
    autograd through plain_attention in bf16, right-padded training
    windows; upstream grads zero on padded query rows."""
    dev = cuda_device
    b, s, h, d = 2, 256, 4, 128
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, up = (torch.randn((b, s, h, d), generator=g, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor([256, 170], device=dev)
    valid = torch.arange(s, device=dev)[None] < lens[:, None]
    up = up * valid[:, :, None, None]
    grads = {}
    for impl in ("flash", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tattn.dot_product_attention(*leaves, kv_valid=valid,
                                          causal=True, impl=impl)
        grads[impl] = torch.autograd.grad((out.float() * up).sum(), leaves)
    for a, r in zip(grads["flash"], grads["plain"]):
        torch.testing.assert_close(a.float(), r.float(), rtol=0,
                                   atol=2e-2 * r.float().abs().max().item())


# UNet eps with K1 against the plain attention (or the card against the
# CPU), bf16: each of the attention outputs differs by a few bf16 ULPs,
# carried through the residual stream to the output
UNET_REL = 5e-2


def _unet(cfg, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return init_normal_(tunet.UNet2DCondition(cfg, device).eval(), g)


def _unet_args(cfg, b, hw, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    pooled = (cfg.projection_class_embeddings_input_dim
              - 6 * cfg.addition_time_embed_dim)
    return (torch.randn((b, hw, hw, cfg.in_channels), generator=g,
                        device=device),
            torch.tensor([981.0, 501.0, 21.0][:b], device=device),
            torch.randn((b, 64, cfg.cross_attention_dim), generator=g,
                        device=device),
            torch.randn((b, pooled), generator=g, device=device),
            torch.tensor([[hw * 8.0, hw * 8.0, 0.0, 0.0, hw * 8.0,
                           hw * 8.0]], device=device).expand(b, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["debug", "mid"])
def test_unet_k1_matches_plain_attention(cuda_device, monkeypatch, which):
    """The debug UNet (head dim 32, padded to 64 for K1; 3 CFG branches at
    16 x 16) and a mid-width UNet (one level of 640 channels, 10 heads of
    64, 32 x 32 latents: K1 at 1024 tokens) with K1 against the same
    weights with the plain attention; K1 launches once per self-attention
    and never under the plain path."""
    if which == "debug":
        cfg, b, hw = tunet.sdxl_debug_unet(in_channels=8), 3, 32
    else:
        cfg, b, hw = tunet.UNetConfig(block_out_channels=(640,),
                                      transformer_layers=(2,)), 2, 32
    unet = _unet(cfg, cuda_device)
    args = _unet_args(cfg, b, hw, cuda_device)
    n1 = launches["flash_fwd"]
    with torch.no_grad():
        eps = unet(*args)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] - n1 == tunet.flash_launches_per_eval(
        cfg)
    orig = tunet.dot_product_attention
    monkeypatch.setattr(tunet, "dot_product_attention",
                        lambda *a, **kw: orig(*a, **{**kw, "impl": "plain"}))
    n2 = launches["flash_fwd"]
    with torch.no_grad():
        ref = unet(*args)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] == n2
    assert eps.shape == (b, hw, hw, 4) and torch.isfinite(eps).all()
    torch.testing.assert_close(eps.float(), ref.float(), rtol=0,
                               atol=UNET_REL * ref.float().abs().max().item())


@pytest.mark.cuda
def test_quantize_unet_on_card_matches_cpu(cuda_device):
    """``quantize_unet_params`` on the card gives the CPU's int8 bytes and
    scales, and the int8 debug UNet on the card (K1) the CPU's eps (plain
    attention)."""
    cfg = tunet.sdxl_debug_unet(in_channels=8)
    cpu = _unet(cfg, "cpu")
    card = tunet.UNet2DCondition(cfg, cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    q_cpu = quantize_unet_params(cpu.state_dict())
    q_card = quantize_unet_params(card.state_dict())
    assert set(q_cpu) == set(q_card)
    for k, v in q_cpu.items():
        assert torch.equal(q_card[k].cpu(), v), k
    qcfg = tunet.sdxl_debug_unet(in_channels=8, quantize="int8")
    args = _unet_args(qcfg, 3, 32, "cpu")
    eps = []
    for dev, q in (("cpu", q_cpu), (cuda_device, q_card)):
        unet = tunet.UNet2DCondition(qcfg, dev).eval()
        unet.load_state_dict(q)
        with torch.no_grad():
            eps.append(unet(*(t.to(dev) for t in args)).float().cpu())
    torch.testing.assert_close(eps[1], eps[0], rtol=0,
                               atol=UNET_REL * eps[0].abs().max().item())



# ---- GroupNorm (+ SiLU) and LayerNorm ----------------------------------------

def _norm_inputs(dev, shape, dtype, seed=0):
    """x with a per-channel offset (so E[x^2] - mean^2 cancels), and an
    fp32 scale / bias of the UNet's kind."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 1.5
         + torch.randn(c, generator=g, device=dev)).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
    bias = 0.2 * torch.randn(c, generator=g, device=dev)
    return x, scale, bias


def _norm_close(out, ref):
    """The kernels and the plain chains differ only in the order of their
    fp32 sums.  bf16: within one ULP of the plain output (relative 2^-7),
    plus 1e-5 of the output's scale where normed * scale and bias cancel to
    a value far below it; fp32: within 1e-5 of the output's scale."""
    mag = ref.float().abs().max().item()
    rtol = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    assert out.dtype == ref.dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5 * mag)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,eps,dtype", [
    # the UNet's at 1024^2, CFG 2: level 0 resnets, the 2560 / 1920
    # up-block concatenations, Transformer2D's eps 1e-6
    ((2, 128, 128, 320), 32, 1e-5, torch.bfloat16),
    ((2, 128, 128, 320), 32, 1e-6, torch.bfloat16),
    ((2, 32, 32, 2560), 32, 1e-5, torch.bfloat16),
    ((2, 64, 64, 1920), 32, 1e-5, torch.bfloat16),
    ((2, 64, 64, 1920), 32, 1e-6, torch.bfloat16),
    ((3, 32, 32, 1280), 32, 1e-6, torch.bfloat16),
    # the fp32 VAE (eps 1e-6); ragged: positions off every chunk, 3
    # channels a group, 8 vectors a thread's slots do not fill
    ((1, 256, 256, 512), 32, 1e-6, torch.float32),
    ((1, 64, 64, 2560), 32, 1e-6, torch.float32),
    ((3, 7, 9, 96), 32, 1e-5, torch.bfloat16),
    ((2, 5, 5, 24), 8, 1e-5, torch.float32)])
def test_group_norm_kernel_matches_plain(cuda_device, shape, groups, eps,
                                         dtype):
    """The GroupNorm kernel against ``group_norm_fp32_stats`` (one ULP in
    bf16, 1e-5 in fp32); with SiLU against ``F.silu`` of its own output
    (one ULP: the same fp32 SiLU of the same rounded value); one count a
    call; the same bits over repeated runs."""
    import torch.nn.functional as F

    x, scale, bias = _norm_inputs(cuda_device, shape, dtype)
    ref = tnorms.group_norm_fp32_stats(x, scale, bias, groups, eps)
    n = launches["group_norm"]
    out = tnorms.group_norm(x, scale, bias, groups, eps)
    act = tnorms.group_norm(x, scale, bias, groups, eps, silu=True)
    again = tnorms.group_norm(x, scale, bias, groups, eps, silu=True)
    torch.cuda.synchronize()
    assert launches["group_norm"] - n == 3
    _norm_close(out, ref)
    torch.testing.assert_close(act.float(), F.silu(out).float(),
                               rtol=2.0 ** -7 if dtype == torch.bfloat16
                               else 1e-6, atol=0)
    assert torch.equal(act, again)


@pytest.mark.cuda
def test_group_norm_kernel_reduce_between_passes(cuda_device):
    """``reduce`` sees the [2, B, G] sums between the passes: a sum over
    two identical ranks (x2) with ``parts`` 2 gives the unsplit output bit
    for bit (exact power-of-two scalings), over one rank (identity) too,
    and the doubled sums with one part do not."""
    x, scale, bias = _norm_inputs(cuda_device, (2, 64, 64, 640),
                                  torch.bfloat16)
    seen = []

    def double(sums):
        seen.append(tuple(sums.shape))
        return sums * 2

    ref = tnorms.group_norm(x, scale, bias, 32)
    one = tnorms.group_norm(x, scale, bias, 32, reduce=lambda s: s)
    two = tnorms.group_norm(x, scale, bias, 32, reduce=double, parts=2)
    wrong = tnorms.group_norm(x, scale, bias, 32, reduce=double)
    torch.cuda.synchronize()
    assert seen == [(2, 2, 32)] * 2
    assert torch.equal(one, ref) and torch.equal(two, ref)
    assert not torch.equal(wrong, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 4096, 640), torch.bfloat16), ((2, 1024, 1280), torch.bfloat16),
    ((3, 77, 640), torch.bfloat16), ((2, 256, 320), torch.bfloat16),
    ((5, 33, 1280), torch.float32), ((7, 3, 32), torch.bfloat16)])
def test_layer_norm_kernel_matches_plain(cuda_device, shape, dtype):
    """The LayerNorm kernel against ``layer_norm_fp32_stats`` at the
    UNet's rows (4096 x 640 and 1024 x 1280 at CFG 2), ragged row counts
    (231 rows: not a whole number of 4-row blocks), fp32 and the debug
    width; one launch a call; the same bits over repeated runs."""
    x, scale, bias = _norm_inputs(cuda_device, shape, dtype)
    ref = tnorms.layer_norm_fp32_stats(x, scale, bias, 1e-5)
    n = launches["layer_norm"]
    out = tnorms.layer_norm(x, scale, bias, 1e-5)
    again = tnorms.layer_norm(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert launches["layer_norm"] - n == 2
    _norm_close(out, ref)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_captured_sdxl_eval_counts_its_norms(cuda_device, monkeypatch):
    """A captured eval of the SDXL base-width UNet (CFG batch 2 at 16 x 16
    latents) counts ``norm_launches_per_eval`` (46, 210) GroupNorm and
    LayerNorm calls and ``epilogue_launches_per_eval`` (253, 70)
    bias_residual and bias_geglu calls a replay, as many as the eager eval
    launches, runs no plain norm or epilogue chain, and replays the eager
    eval bit for bit."""
    from seedx_tpu_torch.utils import graphs

    cfg = tunet.sdxl_base_unet()
    unet = _unet(cfg, cuda_device)
    args = _unet_args(cfg, 2, 16, cuda_device)

    def plain(*a, **kw):
        raise AssertionError("a plain norm or epilogue ran on the card")

    monkeypatch.setattr(tnorms, "group_norm_fp32_stats", plain)
    monkeypatch.setattr(tnorms, "layer_norm_fp32_stats", plain)
    monkeypatch.setattr(tepi, "bias_residual_plain", plain)
    monkeypatch.setattr(tepi, "bias_geglu_plain", plain)
    counters = ("group_norm", "layer_norm", "bias_residual", "bias_geglu")

    with torch.no_grad():
        n = [launches[c] for c in counters]
        eager = unet(*args)
        torch.cuda.synchronize()
        eager_per = tuple(launches[c] - k for c, k in zip(counters, n))
        program = graphs.Program(lambda: unet(*args), cuda_device,
                                 graphs.Graphs())
        program()
        n = [launches[c] for c in counters]
        out = program()
    torch.cuda.synchronize()
    per = tuple(launches[c] - k for c, k in zip(counters, n))
    assert per[:2] == tunet.norm_launches_per_eval(cfg) == (46, 210)
    assert per[2:] == tunet.epilogue_launches_per_eval(cfg) == (253, 70)
    assert per == eager_per
    assert {c: v for c, v in program.per_replay.items()
            if c in counters} == {
                "group_norm": 46, "layer_norm": 210, "bias_residual": 253,
                "bias_geglu": 70}
    assert torch.equal(out, eager)
    del unet, program


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,dtype,silu", [
    ("group_norm", (2, 32, 32, 640), torch.bfloat16, False),
    ("group_norm", (2, 32, 32, 640), torch.bfloat16, True),
    ("group_norm", (2, 64, 64, 320), torch.bfloat16, True),
    ("group_norm", (1, 64, 64, 512), torch.float32, True),
    ("group_norm", (3, 7, 9, 96), torch.bfloat16, False),
    ("layer_norm", (2, 1024, 1280), torch.bfloat16, False),
    ("layer_norm", (2, 4096, 640), torch.bfloat16, False),
    ("layer_norm", (5, 33, 1280), torch.float32, False)])
def test_norm_kernel_grads_match_plain_autograd(cuda_device, kind, shape,
                                                dtype, silu):
    """The wrappers' autograd functions (the kernel forward, the
    closed-form backward in plain torch) against autograd through
    ``group_norm_fp32_stats`` (+ ``F.silu``) / ``layer_norm_fp32_stats``
    on the card: dx, dscale and dbias within 1e-5 of each one's largest
    for fp32 x; for bf16 x one ULP plus 1e-3 of it, dscale and dbias too
    (fp32 sums of terms rounded to bf16, where the kernel's rounded norm,
    under SiLU, may lie a ULP from the plain chain's: the two differ only
    in the order of the statistics' sums)."""
    import torch.nn.functional as F

    x, scale, bias = _norm_inputs(cuda_device, shape, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    if kind == "group_norm":
        def kernel(x, s, b):
            return tnorms.group_norm(x, s, b, 32, 1e-6, silu=silu)

        def plain(x, s, b):
            y = tnorms.group_norm_fp32_stats(x, s, b, 32, 1e-6)
            return F.silu(y) if silu else y
    else:
        def kernel(x, s, b):
            return tnorms.layer_norm(x, s, b, 1e-5)

        def plain(x, s, b):
            return tnorms.layer_norm_fp32_stats(x, s, b, 1e-5)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, scale, bias)]
        (fn(*leaves).float() * dy.float()).sum().backward()
        return [t.grad for t in leaves]

    n = launches[kind]
    got = grads(kernel)
    torch.cuda.synchronize()
    assert launches[kind] - n == 1
    bf16 = dtype == torch.bfloat16
    for a, w in zip(got, grads(plain)):
        assert a.dtype == w.dtype and a.shape == w.shape
        mag = w.float().abs().max().item()
        torch.testing.assert_close(a.float(), w.float(),
                                   rtol=2.0 ** -7 if bf16 else 0,
                                   atol=(1e-3 if bf16 else 1e-5) * mag)


@pytest.mark.cuda
def test_unet_under_autograd_runs_the_norm_kernels(cuda_device,
                                                   monkeypatch):
    """With autograd recording (an input that requires grad) the debug
    UNet launches each norm kernel once a norm, and its eps and gradients
    match a run on the plain norms (within the UNet tolerance)."""
    import torch.nn.functional as F

    cfg = tunet.sdxl_debug_unet()
    unet = _unet(cfg, cuda_device)
    args = _unet_args(cfg, 2, 32, cuda_device)

    def grads():
        sample = args[0].clone().requires_grad_(True)
        ctx = args[2].clone().requires_grad_(True)
        eps = unet(sample, args[1], ctx, *args[3:])
        eps.float().square().sum().backward()
        return eps.detach(), sample.grad, ctx.grad

    n = (launches["group_norm"], launches["layer_norm"])
    got = grads()
    torch.cuda.synchronize()
    assert (launches["group_norm"] - n[0],
            launches["layer_norm"] - n[1]) == \
        tunet.norm_launches_per_eval(cfg)

    def plain_gn(x, scale, bias, groups, eps=1e-5, reduce=None, parts=1,
                 silu=False):
        y = tnorms.group_norm_fp32_stats(x, scale, bias, groups, eps,
                                         reduce, parts)
        return F.silu(y) if silu else y

    with monkeypatch.context() as m:
        m.setattr(tunet, "group_norm", plain_gn)
        m.setattr(tunet, "layer_norm", tnorms.layer_norm_fp32_stats)
        want = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=UNET_REL * b.float().abs().max().item())


# ---- the Dense epilogues (bias, scale, residual; bias + GEGLU) -------------

def _ep_inputs(dev, rows, n, dtype, seed=0):
    """(y, bias, residual, scale) of the UNet's kind: y and the residual of
    unit scale, a small bias, an int8 path's per-column scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return ((torch.randn((rows, n), generator=g, device=dev) * 2).to(dtype),
            (0.3 * torch.randn(n, generator=g, device=dev)).to(dtype),
            torch.randn((rows, n), generator=g, device=dev).to(dtype),
            (0.02 * torch.rand(n, generator=g, device=dev) + 1e-3).to(dtype))


def _ulps_apart(a, b):
    """Representable values of a's type between a and b, elementwise."""
    it, top = ((torch.int16, 1 << 15) if a.dtype == torch.bfloat16
               else (torch.int32, 1 << 31))

    def ordered(t):
        i = t.contiguous().view(it).long()
        return torch.where(i < 0, -(i + top), i)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,n,dtype,res,scaled", [
    # the UNet's at 1024^2, CFG 2: to_out / ff_out / proj_out at level 2
    # and level 1, the int8 UNet's, GEGLU's projection at both levels
    ("bias_residual", 2048, 1280, torch.bfloat16, True, False),
    ("bias_residual", 8192, 640, torch.bfloat16, True, False),
    ("bias_residual", 2048, 1280, torch.bfloat16, True, True),
    ("bias_residual", 2048, 1280, torch.bfloat16, False, False),
    ("bias_geglu", 2048, 10240, torch.bfloat16, False, False),
    ("bias_geglu", 8192, 5120, torch.bfloat16, False, False),
    ("bias_geglu", 2048, 10240, torch.bfloat16, False, True),
    # the VAE's mid attention (fp32), the time embeddings' two rows;
    # ragged: rows off every block, a width off the 32-vector strip
    ("bias_residual", 16384, 512, torch.float32, True, False),
    ("bias_residual", 2, 1280, torch.bfloat16, False, False),
    ("bias_residual", 231, 1280, torch.bfloat16, True, True),
    ("bias_residual", 77, 800, torch.bfloat16, True, False),
    ("bias_geglu", 231, 2560, torch.bfloat16, False, False),
    ("bias_geglu", 33, 64, torch.float32, False, True)])
def test_epilogue_kernel_matches_plain(cuda_device, kind, rows, n, dtype,
                                       res, scaled):
    """The epilogue kernels against their plain chains: ``bias_residual``
    bit for bit (it rounds where the chain rounds), ``bias_geglu`` within
    one ULP of its type (GELU's erff may contract differently from
    PyTorch's build); one count a call; the same bits over a rerun."""
    y, bias, resid, scale = _ep_inputs(cuda_device, rows, n, dtype)
    resid = resid if res else None
    scale = scale if scaled else None
    k = launches[kind]
    if kind == "bias_residual":
        out = tepi.bias_residual(y, bias, resid, scale)
        again = tepi.bias_residual(y, bias, resid, scale)
        ref = tepi.bias_residual_plain(y, bias, resid, scale)
    else:
        out = tepi.bias_geglu(y, bias, scale)
        again = tepi.bias_geglu(y, bias, scale)
        ref = tepi.bias_geglu_plain(y, bias, scale)
    torch.cuda.synchronize()
    assert launches[kind] - k == 2
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if kind == "bias_residual":
        assert torch.equal(out, ref)
    else:
        assert _ulps_apart(out, ref).max().item() <= 1
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bias_residual", "bias_geglu"])
def test_epilogue_kernel_refuses_a_ragged_vector(cuda_device, kind):
    """A width that is not a whole number of 16-byte vectors raises on the
    card, before any launch; nothing falls back to the plain chain."""
    y, bias, resid, _ = _ep_inputs(cuda_device, 16, 2 * 1284,
                                   torch.bfloat16)
    k = launches[kind]
    with pytest.raises(ValueError):
        if kind == "bias_residual":
            tepi.bias_residual(y[:, :1284], bias[:1284], resid[:, :1284])
        else:
            tepi.bias_geglu(y, bias)
    assert launches[kind] == k


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,n,dtype,res,scaled", [
    ("bias_residual", 2048, 1280, torch.bfloat16, True, False),
    ("bias_residual", 8192, 640, torch.bfloat16, True, True),
    ("bias_residual", 300, 512, torch.float32, True, True),
    ("bias_geglu", 2048, 2560, torch.bfloat16, False, False),
    ("bias_geglu", 512, 10240, torch.bfloat16, False, True),
    ("bias_geglu", 300, 1024, torch.float32, False, True)])
def test_epilogue_kernel_grads_match_plain_autograd(cuda_device, kind, rows,
                                                    n, dtype, res, scaled):
    """The wrappers' autograd functions (the kernel forward, the
    closed-form backward in plain torch) against autograd through the
    plain chains on the card: the gradients of y, the bias, the residual
    and the scale within 1e-5 of each one's largest for fp32, for bf16
    one ULP plus 1e-3 of it (bf16 sums over rows in another order)."""
    y, bias, resid, scale = _ep_inputs(cuda_device, rows, n, dtype)
    leaves = [y, bias] + ([resid] if res else []) + ([scale] if scaled
                                                      else [])
    n_out = n if kind == "bias_residual" else n // 2
    g = torch.Generator(device=cuda_device).manual_seed(9)
    dy = torch.randn((rows, n_out), generator=g, device=cuda_device).to(
        dtype)

    def call(fn):
        def run(*t):
            y, bias, rest = t[0], t[1], list(t[2:])
            r = rest.pop(0) if res else None
            s = rest.pop(0) if scaled else None
            return (fn(y, bias, r, s) if kind == "bias_residual"
                    else fn(y, bias, s))
        return run

    def grads(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in leaves]
        (fn(*ts).float() * dy.float()).sum().backward()
        return [t.grad for t in ts]

    k = launches[kind]
    got = grads(call(getattr(tepi, kind)))
    torch.cuda.synchronize()
    assert launches[kind] - k == 1
    want = grads(call(getattr(tepi, kind + "_plain")))
    bf16 = dtype == torch.bfloat16
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        mag = w.float().abs().max().item()
        torch.testing.assert_close(a.float(), w.float(),
                                   rtol=2.0 ** -7 if bf16 else 0,
                                   atol=(1e-3 if bf16 else 1e-5) * mag)


@pytest.mark.cuda
def test_unet_under_autograd_runs_the_epilogue_kernels(cuda_device,
                                                       monkeypatch):
    """With autograd recording the debug UNet launches each epilogue
    kernel ``epilogue_launches_per_eval`` times, and its eps and gradients
    match a run on the plain chains (within the UNet tolerance, as adapter
    training's)."""
    cfg = tunet.sdxl_debug_unet()
    unet = _unet(cfg, cuda_device)
    args = _unet_args(cfg, 2, 32, cuda_device)

    def grads():
        sample = args[0].clone().requires_grad_(True)
        ctx = args[2].clone().requires_grad_(True)
        eps = unet(sample, args[1], ctx, *args[3:])
        eps.float().square().sum().backward()
        return eps.detach(), sample.grad, ctx.grad

    n = (launches["bias_residual"], launches["bias_geglu"])
    got = grads()
    torch.cuda.synchronize()
    assert (launches["bias_residual"] - n[0],
            launches["bias_geglu"] - n[1]) == \
        tunet.epilogue_launches_per_eval(cfg)
    with monkeypatch.context() as m:
        m.setattr(tunet, "bias_residual", tepi.bias_residual_plain)
        m.setattr(tunet, "bias_geglu", tepi.bias_geglu_plain)
        want = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=UNET_REL * b.float().abs().max().item())


# ---- the agent's quantizers on the card ------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_in,n_out", [(5120, 5120), (5120, 13824),
                                        (13824, 5120)])
def test_agent_quantizers_on_card_match_cpu(cuda_device, n_in, n_out):
    """``quantize_kernel_int4`` (group 128) and ``quantize_kernel`` at the
    13B's projection shapes give the CPU's codes and scales, byte for
    byte, on the card."""
    g = torch.Generator().manual_seed(n_in + n_out)
    w = torch.empty((n_in, n_out)).normal_(0.0, 0.02, generator=g)
    for fn in (lambda x: tquant.quantize_kernel_int4(x, 128),
               tquant.quantize_kernel):
        want = fn(w)
        got = fn(w.to(cuda_device))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_embedding_quantizer_on_card_matches_cpu(cuda_device):
    """``quantize_embedding`` over the 32330 x 5120 table, card = CPU."""
    g = torch.Generator().manual_seed(1)
    table = torch.empty((32330, 5120)).normal_(0.0, 0.02, generator=g)
    want = tquant.quantize_embedding(table)
    got = tquant.quantize_embedding(table.to(cuda_device))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


# ---- captured programs against the eager path -----------------------------

def _debug_runtime(dev):
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    return SeedXRuntime.debug(device=dev, quantization="int4",
                              kv_quantization="int8")


def _graph_and_eager(rt, fn):
    """``fn()`` with the runtime's programs on (captured, replayed), then
    off (eager): each result with the kernels' launches of its run."""
    out = []
    for enabled in (True, False):
        rt.graphs.enabled = enabled
        before = dict(launches)
        res = fn()
        torch.cuda.synchronize()
        after = dict(launches)
        out.append((res, {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}))
    rt.graphs.enabled = True
    return out


@pytest.mark.cuda
def test_decode_graph_matches_eager_bit_for_bit(cuda_device):
    """The 2-layer int4 / int8-KV agent's decode through its captured step
    (K2 and K3 inside the graph) against the same step run eagerly: the
    same tokens, hidden states and finished flags, bit for bit, greedy with
    a forced ``<img>`` chunk and sampled from a seeded generator (which
    ends in the same state); the launch counters count the replays (the
    same launches as eager)."""
    from seedx_tpu_torch.models import generation as tgen

    rt = _debug_runtime(cuda_device)
    agent, tok = rt.agent, rt.tokenizer
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, p = 3, 24
    embeds = torch.randn((b, p, 128), generator=g, device=cuda_device) * 0.5
    mask = torch.ones((b, p), dtype=torch.bool, device=cuda_device)
    mask[1, :5] = mask[2, :11] = False
    last = torch.tensor([tok.vocab.boi] * b, device=cuda_device)
    n_img = rt.agent_cfg.num_img_out_tokens
    for kw, lead in ((dict(), last),
                     (dict(do_sample=True, temperature=1.0, top_p=0.95),
                      last * 0 + 7)):
        cfg = tgen.GenerationConfig(max_new_tokens=n_img + 20,
                                    num_img_gen_tokens=n_img, **kw)

        def run():
            gen = torch.Generator(device=cuda_device).manual_seed(9)
            timings = {}
            with torch.no_grad():
                out = tgen.generate_tokens(agent, embeds, mask, lead, cfg,
                                           tok.vocab, generator=gen,
                                           timings=timings)
            return out, timings["decode_forwards"], gen.get_state()

        (graph, n_graph), (eager, n_eager) = _graph_and_eager(rt, run)
        assert graph[1] == eager[1]
        assert torch.equal(graph[2], eager[2])
        for key in ("tokens", "hidden", "finished"):
            assert torch.equal(graph[0][key], eager[0][key]), (kw, key)
        assert n_graph == n_eager
        assert n_graph["decode_attn"] > 0
    progs = tgen.decode_programs(agent).programs()
    assert len(progs) == 2 and all(p.graph is not None for p in progs)
    assert sum(p.replays for p in progs) > 0


@pytest.mark.cuda
def test_sampling_noise_gives_multinomial_tokens(cuda_device):
    """On the card, ``_sample`` with a ``SampleNoise`` slot drawn from a
    generator gives ``torch.multinomial``'s tokens from the same generator
    state, and leaves the generator where multinomial does; a slot given
    back returns it to its state before that draw."""
    from seedx_tpu_torch.models import generation as tgen

    cfg = tgen.GenerationConfig(do_sample=True, temperature=0.7, top_p=0.9)
    logits = torch.randn((8, 32330), device=cuda_device) * 4
    noise = tgen.SampleNoise(8, 32330, 4, cuda_device)
    g_ref = torch.Generator(device=cuda_device).manual_seed(11)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    noise.draw(g, 4)
    for j in range(4):
        want = tgen._sample(logits, cfg, g_ref)
        got = tgen._sample(logits, cfg,
                           noise=noise.at(torch.tensor(j, device=cuda_device)))
        assert torch.equal(got, want), j
    assert torch.equal(g.get_state(), g_ref.get_state())
    noise.give_back(1)
    g_one = torch.Generator(device=cuda_device).manual_seed(11)
    tgen._sample(logits, cfg, g_one)
    assert torch.equal(g.get_state(), g_one.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(paged=True),
                                dict(fused_prefill=True, prefill_width=4),
                                dict(fused_prefill=True, prefill_width=4,
                                     paged=True)])
def test_engine_graph_matches_eager(cuda_device, kw):
    """The continuous engine's captured decode / mixed steps against the
    same steps run eagerly: the same results, step counts and launches."""
    from seedx_tpu_torch.inference.continuous import ContinuousEngine

    rt = _debug_runtime(cuda_device)
    tok = rt.tokenizer
    texts = ["hello world", "the cat sat on the mat today", "abc",
             "one two three four five six", "a b c d e f g h"]
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)}
            for t in texts]

    def run():
        eng = ContinuousEngine(rt, slots=2, max_new_tokens=16,
                               chunk_steps=4, prompt_buckets=(32, 64),
                               page_size=16, **kw).warmup()
        ids = [eng.submit(r, max_new_tokens=4 + 2 * i)
               for i, r in enumerate(reqs)]
        res = eng.run()
        st = eng.stats()
        return ([list(res[i]["tokens"]) for i in ids],
                (st["decode_steps"], st["mixed_steps"]))

    (graph, n_graph), (eager, n_eager) = _graph_and_eager(rt, run)
    assert graph == eager
    assert n_graph == n_eager


@pytest.mark.cuda
def test_unet_eval_graph_matches_eager(cuda_device):
    """The denoise loop's captured CFG eval (K1 inside the graph) against
    the eager eval: the same final latents bit for bit at CFG 3 and at the
    2-branch collapse, the same K1 launches."""
    from seedx_tpu_torch.models.sdxl import pipeline as tpipe
    from seedx_tpu_torch.models.sdxl import scheduler as tsched
    from seedx_tpu_torch.utils import graphs

    cfg = tunet.sdxl_debug_unet(in_channels=8)
    unet = _unet(cfg, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    # 32 x 32 latents: no level's token count equals the 64 context
    # tokens (there the cross-attention, q_len == kv_len, takes K1 too)
    lat, img_lat = randn(1, 32, 32, 4), randn(1, 32, 32, 4)
    cond = (randn(1, 64, cfg.cross_attention_dim),
            randn(1, 64, cfg.cross_attention_dim), randn(1, 64),
            randn(1, 64))
    pooled = (cfg.projection_class_embeddings_input_dim
              - 6 * cfg.addition_time_embed_dim)
    cond = cond[:2] + (randn(1, pooled), randn(1, pooled))
    tids = torch.tensor([[256.0, 256.0, 0.0, 0.0, 256.0, 256.0]],
                        device=cuda_device)
    for gi in (1.5, 1.0):
        outs = []
        for enabled in (True, False):
            switch = graphs.Graphs(enabled=enabled)
            n1 = launches["flash_fwd"]
            with torch.no_grad():
                out = tpipe.denoise_edit(
                    unet, tsched.make_schedule(4), lat, img_lat, *cond,
                    tids, guidance_scale=5.0, image_guidance_scale=gi,
                    evals={}, graphs=switch)
            torch.cuda.synchronize()
            outs.append((out, launches["flash_fwd"] - n1))
        assert torch.equal(outs[0][0], outs[1][0]), gi
        assert outs[0][1] == outs[1][1] == 4 * tunet.flash_launches_per_eval(
            cfg)


@pytest.mark.cuda
def test_ticket_buffer_survives_growth_after_capture(cuda_device):
    """K2 captured with a split-K launch (tickets), then an eager launch
    that needs more tickets than the buffer holds: the buffer grows, the
    captured one stays, and a replay still gives the eager bytes."""
    from seedx_tpu_torch.utils import graphs

    tint4._tickets.buffers.pop(cuda_device, None)
    x, packed, scale = _int4_inputs(cuda_device, 1, 5120, 5120)
    assert tint4.plan(1, 5120, 5120, 128, tint4.sm_count(0))[1] > 1
    out = torch.empty((1, 5120), dtype=torch.bfloat16, device=cuda_device)
    prog = graphs.Graphs().program(
        lambda: out.copy_(tint4.int4_matmul(x, packed, scale)), cuda_device)
    prog()                                   # warm run + capture
    want = out.clone()
    held = tint4._tickets.buffers[cuda_device]
    xb, pb, sb = _int4_inputs(cuda_device, 2016, 5120, 13824, seed=1)
    tiles = -(-2016 // 32) * -(-13824 // tint4.BN)
    assert tiles > held.numel()
    big = tint4.int4_matmul(xb, pb, sb)
    assert tint4._tickets.buffers[cuda_device] is not held
    assert any(t is held for t in tint4._tickets.retired)
    out.zero_()
    prog()                                   # a replay
    torch.cuda.synchronize()
    assert prog.replays == 1 and torch.equal(out, want)
    assert torch.equal(big, tint4.int4_matmul(xb, pb, sb))
    assert not held.any()                    # tickets left at zero


@pytest.mark.cuda
def test_graphs_share_one_pool_and_renew_it(cuda_device):
    """Programs captured under one switch share its pool while any of
    their graphs lives; once all are gone, the next capture takes a new
    pool (a released pool's handle cannot be used again) and replays."""
    import gc

    from seedx_tpu_torch.utils import graphs

    switch = graphs.Graphs()
    x = torch.ones(1024, device=cuda_device)
    out = torch.zeros(1024, device=cuda_device)
    a = switch.program(lambda: out.copy_(x * 2), cuda_device)
    b = switch.program(lambda: out.copy_(x * 3), cuda_device)
    a(), b()
    handle = switch.pool(cuda_device)
    assert a.graph is not None and b.graph is not None
    del a, b
    gc.collect()
    c = switch.program(lambda: out.copy_(x * 4), cuda_device)
    c()
    assert switch.pool(cuda_device) != handle
    out.zero_()
    c()
    torch.cuda.synchronize()
    assert c.replays == 1 and torch.equal(out, x * 4)


@pytest.mark.cuda
def test_a_span_under_capture_records_no_event(cuda_device):
    """A device span opened while the stream captures records no CUDA
    event (the graph would hold it); the warm run's and the replay's are
    timed."""
    from seedx_tpu_torch.utils import graphs, profiling

    x = torch.ones(1 << 22, device=cuda_device)
    out = torch.zeros_like(x)

    def step():
        with profiling.annotate("inside", device=True):
            out.copy_(x * 2)

    prog = graphs.Program(step, cuda_device, graphs.Graphs())
    profiling.clear()
    with profiling.recording():
        prog()                      # the warm run, then the capture
        with profiling.annotate("replay", device=True):
            prog()
    recs = profiling.records()
    profiling.clear()
    inside = [r for r in recs if r["name"] == "inside"]
    assert len(inside) == 2         # a replay runs no Python
    assert inside[0]["device_ms"] > 0 and inside[1]["device_ms"] is None
    (replay,) = [r for r in recs if r["name"] == "replay"]
    assert replay["device_ms"] > 0
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2)


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda_device):
    """A step that reads the device from the host cannot be captured: the
    capture raises, and no eager path takes over."""
    from seedx_tpu_torch.utils import graphs

    x = torch.ones(4, device=cuda_device)
    prog = graphs.Graphs().program(lambda: float(x.sum()), cuda_device)
    with pytest.raises(RuntimeError):
        prog()
    assert prog.graph is None


# ---- the rest of generation: speculation, scripts, beams -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 3, 4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize("n_in,n_out", [(5120, 5120), (5120, 13824),
                                        (13824, 5120)])
def test_int4_kernel_verify_and_beam_rows(cuda_device, rows, n_in, n_out):
    """K2 at the row counts a verify forward (k + 1, k 1-8) and a beam
    step (B * K) run it at."""
    x, packed, scale = _int4_inputs(cuda_device, rows, n_in, n_out, seed=3)
    out = tint4.int4_matmul(x, packed, scale)
    ref = tint4.int4_matmul_plain(x, packed, scale)
    torch.cuda.synchronize()
    assert out.shape == (rows, n_out)
    _int4_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 3, 4, 5, 6, 7, 8, 9])
def test_stair_kernel_verify_shape(cuda_device, w):
    """K3's stair at B 1, w = k + 1 over an int8 dense cache, as a verify
    round reads it: a left-padded window whose slot 0 ends at the
    round's first position, slots stepping one further each."""
    g = torch.Generator(device=cuda_device).manual_seed(w)
    q, k, v, kw = _stair_inputs(cuda_device, g, 1, w, 388, 40, 40, 128,
                                True, 0)
    starts = torch.tensor([57], dtype=torch.int32, device=cuda_device)
    ends = torch.tensor([300], dtype=torch.int32, device=cuda_device)
    out = tdecode.ragged_decode_attention(q, k, v, starts, ends, **kw)
    ref = tdecode.ragged_decode_attention_plain(q, k, v, starts, ends, **kw)
    torch.cuda.synchronize()
    assert out.shape == (1, w, 40, 128)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


def _padded_prompt(tok, ids, dev, p=128):
    padded = torch.zeros((1, p), dtype=torch.int64, device=dev)
    padded[0, p - len(ids):] = torch.tensor(ids, device=dev)
    mask = torch.zeros((1, p), dtype=torch.bool, device=dev)
    mask[0, p - len(ids):] = True
    return padded, mask


def _spec_run(rt, ids, cfg, script=None):
    """``generate_tokens`` at B 1 with prompt ids (and a script): (out,
    decode info)."""
    from seedx_tpu_torch.models import generation as tgen

    dev = rt.device
    padded, mask = _padded_prompt(rt.tokenizer, ids, dev)
    info = {}
    with torch.no_grad():
        out = tgen.generate_tokens(
            rt.agent, rt.agent.embed_ids(padded), mask,
            torch.tensor([ids[-1]], device=dev), cfg, rt.tokenizer.vocab,
            timings=info, prompt_ids=padded,
            script_ids=None if script is None else torch.tensor(script))
    info = {k: v for k, v in info.items() if not k.endswith("_s")
            and k not in ("prefill", "decode")}
    return out, info


def _same_runs(graph, eager):
    (g_out, g_info), g_counts = graph
    (e_out, e_info), e_counts = eager
    for key in ("tokens", "hidden", "finished", "spec_rounds",
                "spec_accepted"):
        assert torch.equal(g_out[key], e_out[key]), key
    assert g_info == e_info and g_counts == e_counts
    return g_out, g_info, g_counts


SPEC_PROMPT = ("the cat sat on the mat. the cat sat on the mat. the dog sat "
               "on the log. the cat")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8])
def test_spec_graph_matches_eager(cuda_device, k):
    """The 2-layer int4 / int8-KV agent's speculative decode (its verify
    round a captured program: K3's stair at w = k + 1, K2 at k + 1 rows)
    against the same rounds run eagerly: tokens, hidden states, finished
    flags and counters bit for bit, the same windows and launches."""
    from seedx_tpu_torch.models import generation as tgen

    rt = _debug_runtime(cuda_device)
    tok = rt.tokenizer
    ids = [tok.bos_token_id] + tok.encode(SPEC_PROMPT)
    cfg = tgen.GenerationConfig(max_new_tokens=40, num_img_gen_tokens=64,
                                prompt_buckets=(128,), spec_k=k)
    out, info, counts = _same_runs(*_graph_and_eager(
        rt, lambda: _spec_run(rt, ids, cfg)))
    assert int(out["spec_rounds"]) > 0
    assert counts["decode_attn multi_query"] > 0
    (st,) = [s for s in tgen.decode_programs(rt.agent).states.values()
             if s.spec_k == k]
    assert st.spec_program.graph is not None and st.spec_program.replays > 0


def _flip_script(tok):
    """A prompt and a script whose gate fails in the middle of a window
    (a probe passes on the echo, a later round misses the bar), then
    re-probes after its cooldown."""
    prompt = [tok.bos_token_id] + tok.encode(
        "report: alpha beta gamma delta epsilon zeta eta theta iota kappa "
        "lambda")
    echo = tok.encode("alpha beta gamma delta epsilon zeta eta theta iota "
                      "kappa")
    g = torch.Generator().manual_seed(0)
    return prompt, echo + (torch.randperm(20000, generator=g)[:40]
                           + 5000).tolist()


@pytest.mark.cuda
def test_spec_gate_flip_inside_a_window(cuda_device):
    """A script whose gate turns off inside a window of verify replays
    (the rest of the window no-ops) and on again after the cooldown:
    captured and eager emit the script with the same counters, windows
    and launches."""
    from seedx_tpu_torch.models import generation as tgen

    rt = _debug_runtime(cuda_device)
    prompt, script = _flip_script(rt.tokenizer)
    cfg = tgen.GenerationConfig(
        max_new_tokens=len(script), num_img_gen_tokens=64,
        prompt_buckets=(128,), spec_k=4, spec_probe_rounds=2,
        spec_min_accept=3.0, spec_window=64, spec_reprobe=8)
    out, info, _ = _same_runs(*_graph_and_eager(
        rt, lambda: _spec_run(rt, prompt, cfg, script)))
    assert out["tokens"][0].tolist() == script
    assert info["verify_replays"] > int(out["spec_rounds"])
    assert info["gate_flips"] >= 2


@pytest.mark.cuda
def test_seeded_script_graph_matches_eager(cuda_device):
    """A script drawn from a seeded generator, plain and with k 4: each
    emits its script, captured and eager bit for bit."""
    from seedx_tpu_torch.models import generation as tgen

    rt = _debug_runtime(cuda_device)
    tok = rt.tokenizer
    g = torch.Generator().manual_seed(7)
    script = torch.randint(3, 30000, (48,), generator=g).tolist()
    script[20:36] = script[4:20]                   # an echo to accept
    ids = [tok.bos_token_id] + tok.encode("describe the scene")
    for k in (0, 4):
        cfg = tgen.GenerationConfig(
            max_new_tokens=len(script), num_img_gen_tokens=64,
            prompt_buckets=(128,), spec_k=k, spec_adaptive=False)
        out, _, _ = _same_runs(*_graph_and_eager(
            rt, lambda: _spec_run(rt, ids, cfg, script)))
        assert out["tokens"][0].tolist() == script
        assert (int(out["spec_accepted"]) > 0) == (k > 0)


@pytest.mark.cuda
def test_beam_graph_matches_eager(cuda_device):
    """Beam search, K 4 at B 2 (K3's one-query mode and K2 at 8 rows, the
    cache re-gathered by parent in place, one captured step replayed):
    tokens, parents, scores and hidden states bit for bit, the same
    launches."""
    from seedx_tpu_torch.models import generation as tgen

    rt = _debug_runtime(cuda_device)
    tok, dev = rt.tokenizer, cuda_device
    rows = [_padded_prompt(tok, [tok.bos_token_id] + tok.encode(t), dev)
            for t in ("hello world", "abc abc abc")]
    padded = torch.cat([r[0] for r in rows])
    mask = torch.cat([r[1] for r in rows])
    cfg = tgen.GenerationConfig(max_new_tokens=12, num_img_gen_tokens=64,
                                prompt_buckets=(128,), num_beams=4)

    def run():
        with torch.no_grad():
            return tgen.generate_tokens_beam(
                rt.agent, rt.agent.embed_ids(padded), mask, padded[:, -1],
                cfg, tok.vocab)

    (graph, n_graph), (eager, n_eager) = _graph_and_eager(rt, run)
    for key in ("tokens", "parents", "scores", "hidden", "finished"):
        assert torch.equal(graph[key], eager[key]), key
    assert n_graph == n_eager
    (st,) = [s for s in tgen.decode_programs(rt.agent).states.values()
             if isinstance(s, tgen.BeamState)]
    assert st.program.graph is not None and st.program.replays >= 11


@pytest.mark.cuda
def test_checkpoint_read_to_the_card_equals_the_cpu_read(cuda_device,
                                                        tmp_path):
    """A release file read straight to the card (``device=``) holds the
    CPU read's tensors, bit for bit: a torch pickle and a safetensors file
    (written by the smoke's own writer: the card has no ``safetensors``)."""
    from chip_smoke import write_safetensors
    from seedx_tpu_torch.utils.weights import load_checkpoint_auto

    g = torch.Generator().manual_seed(0)
    sd = {"w": torch.randn(64, 48, generator=g).bfloat16(),
          "b": torch.randn(48, generator=g),
          "q": torch.randint(-127, 127, (7, 5), generator=g,
                             dtype=torch.int8),
          "s": torch.tensor(2.5)}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "st").mkdir()
    write_safetensors(str(tmp_path / "st" / "model.safetensors"), sd)
    for path in (str(tmp_path), str(tmp_path / "st")):
        cpu = load_checkpoint_auto(path)
        card = load_checkpoint_auto(path, device=cuda_device)
        assert sorted(card) == sorted(cpu) == sorted(sd)
        for k, v in cpu.items():
            assert card[k].is_cuda and card[k].dtype == v.dtype
            assert torch.equal(card[k].cpu(), v) and torch.equal(v, sd[k])


@pytest.mark.cuda
def test_adapter_loss_on_card_matches_cpu(cuda_device):
    """``adapter_loss`` of the bf16 debug UNet and ResamplerXL on the card
    (K1 forward, K4 / K5 backward at every self-attention) against the same
    weights, t and noise on the CPU (the plain attention): the loss within
    1e-2 relative and every trainable leaf's grads within 5e-2 of that
    leaf's own largest (the SFT trainer's bf16 tolerance), floored at 1e-3
    of the model's largest gradient, bf16 rounding's level, for a leaf
    whose gradient is near zero; one K1, K4 and K5 launch a
    self-attention, and one GroupNorm / LayerNorm kernel call a norm (the
    kernels' forward under autograd, their plain-torch backward)."""
    import dataclasses

    from seedx_tpu_torch.models import detokenizer as tdet
    from seedx_tpu_torch.models.sdxl.pipeline import (SamplerConfig,
                                                      default_time_ids)
    from seedx_tpu_torch.train import train_adapter as ttrain

    ucfg = tunet.sdxl_debug_unet()
    out2 = (ucfg.projection_class_embeddings_input_dim
            - 6 * ucfg.addition_time_embed_dim)
    rcfg = tdet.DetokenizerConfig(dim=64, depth=1, dim_head=16, heads=4,
                                  num_queries=8, embedding_dim=32,
                                  output2_dim=out2, output1_dim=0, ff_mult=2)
    rcfg = dataclasses.replace(rcfg,
                               output1_dim=ucfg.cross_attention_dim - out2)
    g = torch.Generator().manual_seed(5)
    batch = {"latents": torch.randn((2, 16, 16, 4), generator=g),
             "image_embeds": torch.randn((2, 4, 32), generator=g)}
    t = torch.tensor([17, 803])
    noise = torch.randn((2, 16, 16, 4), generator=g)
    tids = default_time_ids(SamplerConfig(height=128, width=128), 1)[0]
    grads, losses = {}, {}
    for dev in (torch.device("cpu"), cuda_device):
        gen = torch.Generator().manual_seed(0)
        unet = init_normal_(tunet.UNet2DCondition(ucfg).eval(), gen).to(dev)
        res = init_normal_(tdet.ResamplerXL(rcfg).eval(), gen).to(dev)
        init_state, _ = ttrain.make_adapter_train_step(
            unet, res, ttrain.AdapterTrainConfig(), tids)
        state = init_state()
        n = (launches["flash_fwd"], launches["flash_bwd_dq"],
             launches["flash_bwd_dkv"])
        norms = (launches["group_norm"], launches["layer_norm"])
        loss = ttrain.adapter_loss(
            unet, res, {k: v.to(dev) for k, v in batch.items()}, t.to(dev),
            noise.to(dev), ttrain.make_sigma_tables(), tids)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            per = tunet.flash_launches_per_eval(ucfg)
            assert (launches["flash_fwd"] - n[0],
                    launches["flash_bwd_dq"] - n[1],
                    launches["flash_bwd_dkv"] - n[2]) == (per,) * 3
            assert (launches["group_norm"] - norms[0],
                    launches["layer_norm"] - norms[1]) == \
                tunet.norm_launches_per_eval(ucfg)
        losses[dev.type] = float(loss.detach())
        grads[dev.type] = {k: p.grad.float().cpu()
                           for k, p in state.params.items()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-2 * abs(losses["cpu"])
    top = max(g.abs().max().item() for g in grads["cpu"].values()
              if g.numel())
    for k, want in grads["cpu"].items():
        if want.numel():
            torch.testing.assert_close(
                grads["cuda"][k], want, rtol=0,
                atol=max(5e-2 * want.abs().max().item(), 1e-3 * top),
                msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 64, 512])
def test_int4_kernel_row_amax(cuda_device, rows):
    """K2 given each row's absmax from outside (a row-parallel shard's
    whole-row absmax): equal to its plain version at that scale, and bit
    equal to the call without it when it is the rows' own absmax."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(rows)
    n_in, n_out = 1792, 5120          # 13824 / 8 rounded to whole groups
    w = torch.randn((n_in, n_out), generator=g, device=cuda_device)
    packed, scale = tquant.quantize_kernel_int4(w * n_in ** -0.5)
    x = torch.randn((rows, n_in), generator=g, device=cuda_device).to(
        torch.bfloat16)
    own = tint4.row_absmax(x)
    assert torch.equal(tint4.int4_matmul(x, packed, scale, own),
                       tint4.int4_matmul(x, packed, scale))
    amax = own * (1.0 + 3.0 * torch.rand((rows, 1), generator=g,
                                         device=cuda_device))
    out = tint4.int4_matmul(x, packed, scale, amax)
    ref = tint4.int4_matmul_plain(x, packed, scale, amax)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 * 2 ** -7 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_ia3_through_int4_kernel_and_captured_decode(cuda_device):
    """IA3 on an int4 LoRADense through K2 (input scaled before the row
    quantization, output scaled after) against the plain path; and an
    IA3 int4 agent's greedy tokens with decode captured equal to eager."""
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models import layers

    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    for ia3, n_in, n_out in (("in", 1024, 512), ("out", 512, 512)):
        d = layers.LoRADense(n_in, n_out, quantize="int4", ia3=ia3,
                             device=cuda_device)
        with torch.no_grad():
            d.kernel_q4[:], d.kernel_scale[:] = tquant.quantize_kernel_int4(
                torch.randn((n_in, n_out), generator=g,
                            device=cuda_device) * n_in ** -0.5)
            d.ia3_scale[:] = 1.0 + 0.5 * torch.randn(
                d.ia3_scale.shape, generator=g, device=cuda_device)
        x = torch.randn((8, n_in), generator=g, device=cuda_device).to(
            torch.bfloat16)
        before = launches["int4_w4a8"]
        out = d(x)
        assert launches["int4_w4a8"] > before
        xs = x * d.ia3_scale.to(x.dtype) if ia3 == "in" else x
        ref = tint4.int4_matmul_plain(xs, d.kernel_q4, d.kernel_scale)
        if ia3 == "out":
            ref = ref * d.ia3_scale.to(ref.dtype)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2 * 2 ** -7 * ref.float().abs().max().item(), err

    rt = SeedXRuntime.debug(quantization="int4", kv_quantization="int8",
                            device=cuda_device)
    llm_cfg = rt.agent_cfg.llm
    import dataclasses

    from seedx_tpu_torch.models.agent import ContinuousLVLM
    from seedx_tpu_torch.utils.quantize import random_quantized_llama_

    cfg = dataclasses.replace(rt.agent_cfg,
                              llm=dataclasses.replace(llm_cfg, ia3=True))
    agent = init_normal_(ContinuousLVLM(cfg, cuda_device).eval(), g)
    random_quantized_llama_(agent.llm, g)
    rt.agent_cfg, rt.agent = cfg, agent
    ids = [rt.tokenizer.bos_token_id] + rt.tokenizer.encode("hello there")
    streams = []
    for enabled in (True, False):
        rt.graphs.enabled = enabled
        streams.append(list(rt.generate(ids, max_new_tokens=12)["tokens"]))
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_one_rank_nccl_shard_bit_equal(cuda_device):
    """``SeedXRuntime.shard`` on a one-rank NCCL mesh (one-rank collectives
    are the identity): the debug int4 + int8-KV runtime's comprehend tokens
    and continuous-engine streams, with captured programs, bit-equal to the
    unsharded runtime's."""
    import numpy as np
    import torch.distributed as dist
    from PIL import Image

    from seedx_tpu_torch.inference import apps
    from seedx_tpu_torch.inference.continuous import ContinuousEngine
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.parallel import create_mesh

    rng = np.random.default_rng(3)
    image = Image.fromarray(rng.integers(0, 255, (60, 90, 3), np.uint8))
    rt = SeedXRuntime.debug(quantization="int4", kv_quantization="int8",
                            device=cuda_device)
    tok = rt.tokenizer
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)}
            for t in ("hi there", "a red boat", "one two three four")]

    def run():
        turn = apps.comprehend(rt, image, "what?", max_new_tokens=8)
        eng = ContinuousEngine(rt, slots=2, max_new_tokens=8, chunk_steps=4,
                               prompt_buckets=(64,))
        ids = [eng.submit(r) for r in reqs]
        res = eng.run()
        return list(turn["tokens"]), [list(res[i]["tokens"]) for i in ids]

    ref = run()
    try:
        rt.shard(create_mesh(1, 1, 1))
        assert rt.graphs.enabled and rt.mesh is not None
        assert run() == ref
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_split_denoise_bit_equal(cuda_device):
    """``SDXLAdapter.shard`` on a one-rank NCCL mesh splits the denoise
    (every conv's halo, GroupNorm sum, K / V gather and the rows and CFG
    gathers one-rank NCCL calls inside the captured eval): the debug
    adapter's text-to-image and edit images bit-equal to the unsplit
    run's, with K1 on the self-attention and the GroupNorm kernel (its
    sums all-reduced between its passes)."""
    import torch.distributed as dist

    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.parallel import create_mesh

    rt = SeedXRuntime.debug(device=cuda_device, with_adapter=True)
    ad = rt.adapter
    g = torch.Generator(device=cuda_device).manual_seed(2)
    embeds = torch.randn((1, 256, 64), generator=g, device=cuda_device)
    cond = torch.rand((1, 64, 64, 3), generator=g, device=cuda_device) * 2 - 1

    def run():
        return [ad.generate(embeds, from_vit=True, num_inference_steps=3),
                ad.generate(embeds, latent_image=cond, from_vit=True,
                            num_inference_steps=3)]

    ref = run()
    try:
        ad.shard(create_mesh(1, 1, 1))
        assert ad.graphs.enabled
        before = launches["flash_fwd"], launches["group_norm"]
        got = run()
        assert launches["flash_fwd"] > before[0]
        assert launches["group_norm"] > before[1]
        for a, b in zip(got, ref):
            assert (a == b).all()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_train_step_bit_equal(cuda_device):
    """A bf16 tiny agent's train steps (K1 / K4 / K5, LoRA dropout on) on a
    one-rank NCCL mesh: losses, grad norms and every trainable leaf
    bit-equal to the unsharded steps'."""
    import torch.distributed as dist

    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.models.llama import llama_debug
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.mesh import place_params
    from seedx_tpu_torch.train.trainer import (TrainConfig,
                                               create_train_state,
                                               make_train_step)

    cfg = AgentConfig(llm=llama_debug(hidden_size=128, intermediate_size=256,
                                      num_layers=2, num_heads=2,
                                      num_kv_heads=2, lora_rank=8,
                                      lora_dropout=0.1),
                      vit_dim=64, resampler_heads=4, num_img_in_tokens=4,
                      num_img_out_tokens=4)
    b, s = 4, 128
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ids = torch.randint(5, 30000, (b, s), generator=g, device=cuda_device)
    attn = torch.ones((b, s), dtype=torch.bool, device=cuda_device)
    attn[3, 100:] = False
    gen = torch.zeros((b, s), dtype=torch.bool, device=cuda_device)
    gen[2, 2:6] = gen[3, 5:9] = True
    cmp_ = torch.zeros_like(gen)
    cmp_[0, 1:5] = cmp_[1, 3:7] = True
    batch = dict(input_ids=ids, attention_mask=attn,
                 labels=torch.where(attn, ids, -100),
                 image_embeds=torch.randn((b, 16, 64), generator=g,
                                          device=cuda_device),
                 embeds_gen_mask=torch.tensor([False, False, True, True],
                                              device=cuda_device),
                 embeds_cmp_mask=torch.tensor([True, True, False, False],
                                              device=cuda_device),
                 ids_gen_mask=gen, ids_cmp_mask=cmp_,
                 patch_positions=torch.full((b, 2), 0.5, device=cuda_device))
    tcfg = TrainConfig(warmup_steps=0, max_steps=4, learning_rate=1e-3)

    def run(mesh=None):
        agent = init_normal_(ContinuousLVLM(cfg, cuda_device),
                             torch.Generator(device=cuda_device).manual_seed(1))
        if mesh is not None:
            place_params(agent, mesh)
        st = create_train_state(agent, tcfg)
        step = make_train_step(agent, tcfg)
        out = []
        for i in range(2):
            m = step(st, batch, torch.Generator(
                device=cuda_device).manual_seed(100 + i))
            out.append({k: m[k] for k in ("total_loss", "grad_norm")})
        return out, {n: p.detach().clone() for n, p in st.params.items()}

    before = launches["flash_bwd_dq"]
    ref = run()
    assert launches["flash_bwd_dq"] > before
    try:
        got = run(create_mesh(1, 1, 1))
    finally:
        dist.destroy_process_group()
    assert got[0] == ref[0]
    for n, t in ref[1].items():
        assert torch.equal(got[1][n], t), n


def _expert_rows(rows: int, experts: int, zeros, g, device):
    """int32 offsets [E + 1] of ``rows`` rows spread at random over the
    experts, the experts in ``zeros`` given none."""
    live = [e for e in range(experts) if e not in zeros]
    pick = torch.randint(0, len(live), (rows,), generator=g, device=device)
    counts = torch.bincount(torch.tensor(live, device=device)[pick],
                            minlength=experts)
    return torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0)).to(
        torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [192, 24576])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_gemm_kernel_matches_plain(cuda_device, rows, gated):
    """K6 at DeepSeek-V2-Lite's expert widths, at a decode step's rows
    (32 slots x top-6: the 16-row tile) and a 4096-token prefill's (the
    128-row tile), three experts given no rows: against moe_gemm_plain
    (fp32 matmuls, TF32 off), and a rerun bit-equal (no float atomics)."""
    from seedx_tpu_torch.ops import moe as tmoe

    g = torch.Generator(device=cuda_device)
    g.manual_seed(rows + gated)
    e, d, f = 64, 2048, 1408
    k_in, n_out = (d, f) if gated else (f, d)
    offsets = _expert_rows(rows, e, {3, 17, 40}, g, cuda_device)
    x = torch.randn((rows, k_in), generator=g, device=cuda_device).to(
        torch.bfloat16)
    w = (torch.randn((e, k_in, n_out), generator=g, device=cuda_device)
         * 0.02).to(torch.bfloat16)
    w2 = ((torch.randn((e, k_in, n_out), generator=g, device=cuda_device)
           * 0.02).to(torch.bfloat16) if gated else None)
    active = torch.zeros((), dtype=torch.int64, device=cuda_device)
    before = launches["moe_gemm"]
    got = tmoe.moe_gemm(x, w, offsets, w2, active)
    again = tmoe.moe_gemm(x, w, offsets, w2)
    torch.cuda.synchronize()
    assert launches["moe_gemm"] == before + 2
    counts = offsets[1:] - offsets[:-1]
    assert int(counts[[3, 17, 40]].sum()) == 0
    assert int(active) == int((counts > 0).sum())
    assert torch.equal(got, again)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = tmoe.moe_gemm_plain(x, w, offsets, w2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert got.dtype == want.dtype
    # fp32 sums in another order (and the epilogue's exp against F.silu's);
    # a gated output rounds once to bf16, which that may flip by one ULP
    # (2^-7 of the largest value)
    tol = 2 ** -7 if gated else 1e-5
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_captured_moe_mla_decode_step_equals_eager(cuda_device):
    """A small DeepSeek-V2 agent (latent attention, 8 experts top-2 at
    K6-sized widths) served by ContinuousEngine: the captured decode
    chunks give the eager run's tokens and logits, and replays count
    K6's launches and the expert activations."""
    import types

    from seedx_tpu_torch.inference.continuous import ContinuousEngine
    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
    from seedx_tpu_torch.models.llama import LlamaConfig
    from seedx_tpu_torch.text.tokenizer import load_tokenizer

    llm = LlamaConfig(vocab_size=32330, hidden_size=256, intermediate_size=512,
                      num_layers=3, num_heads=4, num_kv_heads=4,
                      kv_lora_rank=128, qk_nope_head_dim=64,
                      qk_rope_head_dim=32, v_head_dim=64, n_routed_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=128,
                      n_shared_experts=1, first_k_dense_replace=1,
                      yarn_factor=40.0, yarn_mscale=0.707,
                      yarn_mscale_all_dim=0.707, rms_eps=1e-6)
    cfg = AgentConfig(llm=llm, num_img_in_tokens=4, num_img_out_tokens=4,
                      vit_dim=64, resampler_heads=4, vit_down=False)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(8)
    agent = init_normal_(ContinuousLVLM(cfg, cuda_device).eval(), g)
    with torch.no_grad():
        agent.llm.layers.router.kernel.normal_(0.0, 0.5, generator=g)
    rt = types.SimpleNamespace(agent=agent, agent_cfg=cfg,
                               tokenizer=load_tokenizer())
    tok = rt.tokenizer
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)}
            for t in ("hello world", "a b c d e f g", "the cat")]
    runs = []
    for enabled in (True, False):
        agent.graphs.enabled = enabled
        eng = ContinuousEngine(rt, slots=4, max_new_tokens=10, chunk_steps=4,
                               prompt_buckets=(32,))
        eng.warmup()
        ids = [eng.submit(r) for r in reqs]
        k6, act = launches["moe_gemm"], int(agent.llm.layers.experts_active)
        res = eng.run()
        runs.append(([list(res[i]["tokens"]) for i in ids],
                     eng.state["prev_logits"].clone(),
                     launches["moe_gemm"] - k6,
                     int(agent.llm.layers.experts_active) - act, eng))
    (tok_c, lg_c, k6_c, act_c, eng_c), (tok_e, lg_e, k6_e, act_e, _) = runs
    assert eng_c.program("decode").graph is not None
    assert tok_c == tok_e
    torch.testing.assert_close(lg_c, lg_e, rtol=0, atol=1e-4)
    # the same steps ran: the same launches and activations counted
    assert k6_c == k6_e > 0 and act_c == act_e > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [384, 6144, 24576])
def test_moe_gemm_relu2_kernel_matches_plain(cuda_device, rows):
    """K6's relu2 epilogue at Nemotron-H's expert widths (E128, d2688,
    f1856: 14.5 column tiles of 128, so the 64- and 128-row tiles end in a
    64-column tile) at a decode step's rows (64 slots x top-6: the 16-row
    tile), a 1024-token prefill's (the 64-row tile) and a 4096-token
    one's (the 128-row tile), two experts given no rows, then the down
    projection over its output: against moe_gemm_plain (fp32 matmuls,
    TF32 off), reruns bit-equal, launches counted under "moe_gemm
    relu2"."""
    from seedx_tpu_torch.ops import moe as tmoe

    g = torch.Generator(device=cuda_device)
    g.manual_seed(rows)
    e, d, f = 128, 2688, 1856
    offsets = _expert_rows(rows, e, {5, 77}, g, cuda_device)
    x = torch.randn((rows, d), generator=g, device=cuda_device).to(
        torch.bfloat16)
    up = (torch.randn((e, d, f), generator=g, device=cuda_device)
          * 0.02).to(torch.bfloat16)
    down = (torch.randn((e, f, d), generator=g, device=cuda_device)
            * 0.02).to(torch.bfloat16)
    active = torch.zeros((), dtype=torch.int64, device=cuda_device)
    before = dict(launches)
    act = tmoe.moe_gemm(x, up, offsets, None, active, "relu2")
    again = tmoe.moe_gemm(x, up, offsets, None, None, "relu2")
    out = tmoe.moe_gemm(act, down, offsets)
    torch.cuda.synchronize()
    assert launches["moe_gemm relu2"] == before["moe_gemm relu2"] + 2
    assert launches["moe_gemm"] == before["moe_gemm"] + 3
    assert int(active) == int(((offsets[1:] - offsets[:-1]) > 0).sum())
    assert torch.equal(act, again) and act.dtype == torch.bfloat16
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = tmoe.moe_gemm_plain(x, up, offsets, None, None, "relu2")
        want_out = tmoe.moe_gemm_plain(act, down, offsets)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    # fp32 sums in another order; the relu2 output rounds once to bf16,
    # which that may flip by one ULP (2^-7 of the largest value); the
    # fp32 down over the same rows to 1e-5 of its largest value
    err = (act.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), err
    err = (out - want_out).abs().max().item()
    assert err <= 1e-5 * want_out.abs().max().item(), err


@pytest.mark.cuda
def test_softmax_route_is_deepseek_v2s_formula(cuda_device):
    """DeepSeek-V2's router beside the sigmoid one: the fp32 softmax's
    top k times the scaling, written out, bit for bit."""
    from seedx_tpu_torch.ops import moe as tmoe

    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    x = torch.randn((192, 2048), generator=g, device=cuda_device).to(
        torch.bfloat16)
    w = (torch.randn((2048, 64), generator=g, device=cuda_device)
         * 0.02).to(torch.bfloat16)
    weights, ids = tmoe.route(x, w, 6, 1.0)
    want_w, want_ids = torch.topk(torch.softmax(x.float() @ w.float(), -1),
                                  6, dim=-1)
    assert torch.equal(ids, want_ids) and torch.equal(weights, want_w * 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 64])
def test_ssm_step_kernel_matches_plain(cuda_device, slots):
    """K7 at Nemotron-H's widths (64 heads of 64, state 128, 8 groups):
    dt a strided view of the in-projection's row as the Mamba block hands
    it, against ssm_step_plain; state and y within 1e-5 of their largest
    values (fp32 sums in another order, expf / log1pf against torch's),
    a rerun bit-equal (no atomics), one launch counted a call."""
    from seedx_tpu_torch.ops import ssm as tssm

    g = torch.Generator(device=cuda_device)
    g.manual_seed(slots)
    h, p, gr, n = 64, 64, 8, 128
    width = h * p + 2 * gr * n
    state0 = torch.randn((slots, h, p, n), generator=g,
                         device=cuda_device) * 0.5
    proj = torch.randn((slots, width + h + 8), generator=g,
                       device=cuda_device).to(torch.bfloat16)
    xbc, dt_raw = proj[:, :width].contiguous(), proj[:, width:width + h]
    params = [(torch.randn((h,), generator=g, device=cuda_device)
               * 0.5).to(torch.bfloat16) for _ in range(3)]
    states = [state0.clone() for _ in range(3)]
    before = launches["ssm_step"]
    ys = [tssm.ssm_step(s, xbc, dt_raw, *params, h, p, gr)
          for s in states[:2]]
    want = tssm.ssm_step_plain(states[2], xbc, dt_raw, *params, h, p, gr)
    torch.cuda.synchronize()
    assert launches["ssm_step"] == before + 2
    assert torch.equal(ys[0], ys[1]) and torch.equal(states[0], states[1])
    assert (states[0] - states[2]).abs().max() <= \
        1e-5 * states[2].abs().max()
    assert (ys[0] - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(ValueError, match="ssm_step"):
        tssm.ssm_step(states[0][..., :64].contiguous(), xbc, dt_raw,
                      *params, h, p, gr)


@pytest.mark.cuda
def test_captured_hybrid_decode_step_equals_eager(cuda_device):
    """A small Nemotron-H agent (pattern ME*EM at K7's state 128 and head
    dim 64, relu2 experts at K6-sized widths, NoPE GQA) served by
    ContinuousEngine over 2 slots, so slots are reused: the captured
    decode chunks give the eager run's tokens and logits, and replays
    count K7's and K6's launches as the eager steps do."""
    import types

    from seedx_tpu_torch.inference.continuous import ContinuousEngine
    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
    from seedx_tpu_torch.models.llama import LlamaConfig
    from seedx_tpu_torch.text.tokenizer import load_tokenizer

    llm = LlamaConfig(vocab_size=32330, hidden_size=256, intermediate_size=128,
                      num_layers=5, num_heads=4, num_kv_heads=2,
                      attn_head_dim=64, rope=False, block_pattern="ME*EM",
                      mamba_heads=8, mamba_head_dim=64, ssm_state_size=128,
                      mamba_groups=2, ssm_chunk=16, n_routed_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=128,
                      n_shared_experts=1, shared_intermediate_size=192,
                      routed_scaling_factor=2.5, expert_act="relu2",
                      router_scoring="sigmoid")
    cfg = AgentConfig(llm=llm, num_img_in_tokens=4, num_img_out_tokens=4,
                      vit_dim=64, resampler_heads=4, vit_down=False)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(9)
    agent = init_normal_(ContinuousLVLM(cfg, cuda_device).eval(), g)
    with torch.no_grad():
        agent.llm.layers.router.kernel.normal_(0.0, 0.5, generator=g)
    rt = types.SimpleNamespace(agent=agent, agent_cfg=cfg,
                               tokenizer=load_tokenizer())
    tok = rt.tokenizer
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)}
            for t in ("hello world", "a b c d e f g", "the cat",
                      "one more request")]
    runs = []
    for enabled in (True, False):
        agent.graphs.enabled = enabled
        eng = ContinuousEngine(rt, slots=2, max_new_tokens=10, chunk_steps=4,
                               prompt_buckets=(32,))
        eng.warmup()
        ids = [eng.submit(r) for r in reqs]
        k7, k6 = launches["ssm_step"], launches["moe_gemm relu2"]
        res = eng.run()
        runs.append(([list(res[i]["tokens"]) for i in ids],
                     eng.state["prev_logits"].clone(),
                     launches["ssm_step"] - k7,
                     launches["moe_gemm relu2"] - k6, eng))
    (tok_c, lg_c, k7_c, k6_c, eng_c), (tok_e, lg_e, k7_e, k6_e, _) = runs
    assert eng_c.program("decode").graph is not None
    assert tok_c == tok_e
    torch.testing.assert_close(lg_c, lg_e, rtol=0, atol=1e-4)
    assert k7_c == k7_e > 0 and k6_c == k6_e > 0
