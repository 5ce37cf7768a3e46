"""The norm wrappers of ``seedx_tpu_torch/ops/norms.py`` on the CPU: the
plain versions they run there, the GroupNorm kernel's launch plan (its
tiling covers every element once), the checks made before a launch, the
autograd functions' plain-torch backward against autograd through the
plain versions (the kernel forward stood in for by the plain one), the
UNet / VAE modules' SiLU flag, and the per-eval norm counts.  The kernels
themselves run in tests/test_torch_cuda.py on the card."""

import pytest
import torch
import torch.nn.functional as F

from seedx_tpu_torch.models.sdxl import unet as tunet
from seedx_tpu_torch.models.sdxl import vae as tvae
from seedx_tpu_torch.ops import norms
from seedx_tpu_torch.ops._build import launches


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g) * 1.5
         + torch.randn(c, generator=g)).to(dtype)
    return (x, 1.0 + 0.2 * torch.randn(c, generator=g),
            0.2 * torch.randn(c, generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_wrapper_on_cpu_is_plain(dtype, silu):
    x, scale, bias = _inputs((2, 6, 5, 64), dtype)
    want = norms.group_norm_fp32_stats(x, scale, bias, 8, 1e-6)
    if silu:
        want = F.silu(want)
    n = launches["group_norm"]
    got = norms.group_norm(x, scale, bias, 8, 1e-6, silu=silu)
    assert torch.equal(got, want) and launches["group_norm"] == n


def test_group_norm_wrapper_passes_reduce_and_parts():
    x, scale, bias = _inputs((2, 4, 4, 32), torch.float32)
    seen = []

    def double(sums):
        seen.append(tuple(sums.shape))
        return sums * 2

    got = norms.group_norm(x, scale, bias, 8, reduce=double, parts=2)
    assert seen == [(2, 2, 8)]
    assert torch.equal(got, norms.group_norm_fp32_stats(x, scale, bias, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_wrapper_on_cpu_is_plain(dtype):
    x, scale, bias = _inputs((3, 7, 64), dtype)
    n = launches["layer_norm"]
    assert torch.equal(norms.layer_norm(x, scale, bias, 1e-5),
                       norms.layer_norm_fp32_stats(x, scale, bias, 1e-5))
    assert launches["layer_norm"] == n


# (batch, positions, channels, itemsize): the SDXL UNet's at 1024^2 and
# 512^2 (CFG 2 and 3), the VAE decoder's fp32 levels, the debug UNet's,
# and ragged ones
PLAN_SHAPES = [
    (2, 16384, 320, 2), (2, 16384, 640, 2), (2, 4096, 640, 2),
    (2, 4096, 960, 2), (2, 4096, 1920, 2), (2, 1024, 1280, 2),
    (2, 1024, 2560, 2), (3, 1024, 1920, 2), (3, 4096, 320, 2),
    (1, 1048576, 128, 4), (1, 262144, 256, 4), (1, 16384, 512, 4),
    (1, 4096, 2560, 4), (2, 256, 1280, 4), (2, 16, 32, 2), (3, 63, 96, 2),
    (2, 25, 24, 4), (1, 1, 8, 2), (2, 7, 4096, 2)]


@pytest.mark.parametrize("b,p,c,item", PLAN_SHAPES)
def test_group_norm_plan_tiles_every_element_once(b, p, c, item):
    """``gn_plan``'s launch as the kernel walks it: each (position,
    16-byte vector) of a batch row read by exactly one thread of one block,
    within the kernel's limits (threads, built slot counts, shared memory,
    splits)."""
    slots, tpr, rows, chunk, splits = norms.gn_plan(b, p, c, item, 132)
    nvec = c * item // 16
    assert slots in norms.GN_SLOTS and tpr * slots >= nvec
    assert rows * tpr <= norms.GN_THREADS and chunk % rows == 0
    assert 8 * rows * c <= norms.GN_SMEM
    assert (splits - 1) * chunk < p <= splits * chunk
    assert splits <= norms.MAX_SPLITS
    if nvec > norms.GN_THREADS:
        assert rows == 1 and tpr % 32 == 0
    # thread t of a block is (r, lane) = divmod(t, tpr): positions
    # p0 + r, p0 + r + rows, ... below the block's end; vectors lane + s *
    # tpr below nvec for each slot s
    pos = torch.tensor([q for k in range(splits) for r in range(rows)
                        for q in range(k * chunk + r,
                                       min((k + 1) * chunk, p), rows)])
    vec = torch.tensor([lane + s * tpr for lane in range(tpr)
                        for s in range(slots) if lane + s * tpr < nvec])
    assert torch.equal(pos.sort().values, torch.arange(p))
    assert torch.equal(vec.sort().values, torch.arange(nvec))


@pytest.mark.parametrize("case", ["dtype", "vector", "scale"])
def test_kernel_args_refuse_what_the_kernels_do_not_take(case):
    x, scale, bias = _inputs((2, 4, 64), torch.float32)
    if case == "dtype":
        x = x.half()
    elif case == "vector":
        x, scale, bias = x[..., :62], scale[:62], bias[:62]
    else:
        scale = scale[:32]
    with pytest.raises(ValueError):
        norms._kernel_args(x, scale, bias, "test")


def test_kernel_args_make_x_contiguous_and_params_fp32():
    x, scale, bias = _inputs((4, 2, 64), torch.bfloat16)
    xt, s, bb = norms._kernel_args(x.transpose(0, 1), scale.bfloat16(),
                                   bias, "test")
    assert xt.is_contiguous() and torch.equal(xt, x.transpose(0, 1))
    assert s.dtype == bb.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_module_silu_flag(dtype):
    """The modules' ``silu`` flag: ``F.silu`` of the plain output, bit for
    bit (what the UNet and VAE ran before the flag)."""
    m = tunet.GroupNorm(64, 8, 1e-6)
    x, scale, bias = _inputs((2, 5, 5, 64), dtype)
    m.scale.copy_(scale)
    m.bias.copy_(bias)
    assert torch.equal(m(x, silu=True), F.silu(m(x)))
    assert torch.equal(m(x), norms.group_norm_fp32_stats(x, scale, bias, 8,
                                                         1e-6))


def _plain_group_norm_kernel(x, scale, bias, groups, eps, reduce, parts,
                             silu):
    """``norms._group_norm_kernel``'s outputs from the plain version: (y,
    x, the [2, B, G] sums after ``reduce``, their count)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    sums = torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))])
    if reduce is not None:
        sums = reduce(sums)
    y = norms.group_norm_fp32_stats(x, scale, bias, groups, eps,
                                    lambda _: sums, parts)
    return (F.silu(y) if silu else y), x, sums, xf[0, :, 0].numel() * parts


def _grads(fn, x, scale, bias, dy):
    """(dx, dscale, dbias) of sum(fn(x, scale, bias) * dy) by autograd."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, scale, bias)]
    (fn(*leaves).float() * dy.float()).sum().backward()
    return [t.grad for t in leaves]


def _close_grads(got, want, dtype):
    """For x of ``dtype``, fp32: within 1e-5 of each gradient's largest
    value; bf16: within one ULP (relative 2^-7) of the plain path's plus
    1e-3 of the largest, for values where fp32 cancellation leaves less
    than a bf16 step (the fp32 dscale / dbias too: sums of bf16-rounded
    terms)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        mag = w.float().abs().max().item()
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), w.float(), rtol=2.0 ** -7,
                                       atol=1e-3 * mag)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 64), 8),
                                          ((3, 7, 96), 32)])
def test_group_norm_function_grads_match_the_plain_path(
        monkeypatch, dtype, silu, shape, groups):
    """``norms._GroupNorm`` (the CUDA wrapper's autograd function, its
    kernel forward stood in for by the plain one) against autograd through
    ``group_norm_fp32_stats`` (+ ``F.silu``): dx, dscale and dbias."""
    monkeypatch.setattr(norms, "_group_norm_kernel",
                        _plain_group_norm_kernel)
    x, scale, bias = _inputs(shape, dtype, seed=3)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(4)
                     ).to(dtype)

    def plain(x, scale, bias):
        y = norms.group_norm_fp32_stats(x, scale, bias, groups, 1e-6)
        return F.silu(y) if silu else y

    got = _grads(lambda *a: norms._GroupNorm.apply(
        *a, groups, 1e-6, None, 1, silu), x, scale, bias, dy)
    _close_grads(got, _grads(plain, x, scale, bias, dy), dtype)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_backward_reduces_over_the_parts(silu):
    """The backward's ``reduce``: two ranks holding the same rows (the sums
    doubled, ``parts`` 2) give each the unsplit gradient, bit for bit
    (exact power-of-two scalings); without the reduce they do not."""
    x, scale, bias = _inputs((2, 9, 5, 64), torch.float32, seed=5)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6))
    _, _, sums, count = _plain_group_norm_kernel(x, scale, bias, 8, 1e-5,
                                                 None, 1, silu)
    want = norms.group_norm_backward(dy, x, sums, scale, bias, count, 1e-5,
                                     silu)
    got = norms.group_norm_backward(dy, x, 2 * sums, scale, bias, 2 * count,
                                    1e-5, silu, lambda s: 2 * s)
    local = norms.group_norm_backward(dy, x, 2 * sums, scale, bias,
                                      2 * count, 1e-5, silu)
    assert torch.equal(got[0], want[0])
    assert not torch.allclose(local[0], want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 7, 64), (5, 1280)])
def test_layer_norm_function_grads_match_the_plain_path(monkeypatch, dtype,
                                                        shape):
    """``norms._LayerNorm`` (kernel forward stood in for by the plain one)
    against autograd through ``layer_norm_fp32_stats``."""
    monkeypatch.setattr(
        norms, "_layer_norm_kernel",
        lambda x, s, b, eps: (norms.layer_norm_fp32_stats(x, s, b, eps), x))
    x, scale, bias = _inputs(shape, dtype, seed=7)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(8)
                     ).to(dtype)
    got = _grads(lambda *a: norms._LayerNorm.apply(*a, 1e-5), x, scale,
                 bias, dy)
    want = _grads(lambda *a: norms.layer_norm_fp32_stats(*a, 1e-5), x,
                  scale, bias, dy)
    _close_grads(got, want, dtype)


def test_norm_functions_count_a_call_and_skip_unneeded_grads(monkeypatch):
    """One count a call, the kernel launch's alone: the autograd function
    adds none of its own (a stood-in kernel counts nothing; the card's
    tests count the launches); no dscale / dbias for buffers that need
    none (the UNet's frozen norms)."""
    monkeypatch.setattr(norms, "_group_norm_kernel",
                        _plain_group_norm_kernel)
    x, scale, bias = _inputs((2, 4, 4, 32), torch.float32)
    x.requires_grad_(True)
    n = launches["group_norm"]
    norms._GroupNorm.apply(x, scale, bias, 8, 1e-5, None, 1, True).sum(
        ).backward()
    assert launches["group_norm"] == n
    assert x.grad is not None and scale.grad is None and bias.grad is None


@pytest.mark.parametrize("make", [tunet.sdxl_base_unet, tunet.sdxl_edit_unet,
                                  tunet.sdxl_debug_unet,
                                  lambda: tunet.UNetConfig(
                                      block_out_channels=(640,),
                                      transformer_layers=(2,))])
def test_norm_launches_per_eval_counts_the_modules(make):
    """One call of every GroupNorm / LayerNorm module an eval: the
    helper's counts are the modules' ((46, 210) for SDXL base)."""
    cfg = make()
    unet = tunet.UNet2DCondition(cfg, device="meta")
    counts = (sum(isinstance(m, tunet.GroupNorm) for m in unet.modules()),
              sum(isinstance(m, tunet.LayerNorm) for m in unet.modules()))
    assert tunet.norm_launches_per_eval(cfg) == counts
    if cfg == tunet.sdxl_base_unet():
        assert counts == (46, 210)


def test_debug_unet_eval_calls_each_norm_once():
    """The debug UNet's forward on the CPU calls the helper's count of
    GroupNorms (each ResnetBlock's two and ``conv_norm_out`` with SiLU)
    and LayerNorms."""
    cfg = tunet.sdxl_debug_unet()
    unet = tunet.UNet2DCondition(cfg).eval()
    calls = {"gn": 0, "silu": 0, "ln": 0}

    def hook(module, args, kwargs, out):
        if isinstance(module, tunet.GroupNorm):
            calls["gn"] += 1
            calls["silu"] += bool(kwargs.get("silu"))
        else:
            calls["ln"] += 1

    for m in unet.modules():
        if isinstance(m, (tunet.GroupNorm, tunet.LayerNorm)):
            m.register_forward_hook(hook, with_kwargs=True)
    pooled = (cfg.projection_class_embeddings_input_dim
              - 6 * cfg.addition_time_embed_dim)
    with torch.no_grad():
        unet(torch.randn(2, 8, 8, 4), torch.tensor([5.0, 9.0]),
             torch.randn(2, 3, cfg.cross_attention_dim),
             torch.randn(2, pooled), torch.zeros(2, 6))
    gn, ln = tunet.norm_launches_per_eval(cfg)
    resnets = sum(isinstance(m, tunet.ResnetBlock) for m in unet.modules())
    assert (calls["gn"], calls["ln"]) == (gn, ln)
    assert calls["silu"] == 2 * resnets + 1


def test_vae_norms_apply_silu_where_the_reference_does():
    """The VAE decoder's GroupNorms: SiLU after each resnet's two and
    ``norm_out``, none after the mid attention's."""
    cfg = tvae.vae_debug()
    dec = tvae.VAEDecoder(cfg).eval()
    flags = []
    for m in dec.modules():
        if isinstance(m, tunet.GroupNorm):
            m.register_forward_hook(
                lambda mod, a, kw, out: flags.append(bool(kw.get("silu"))),
                with_kwargs=True)
    with torch.no_grad():
        dec(torch.randn(1, 4, 4, 4))
    resnets = sum(isinstance(m, tvae.VAEResnet) for m in dec.modules())
    assert flags.count(True) == 2 * resnets + 1 and flags.count(False) == 1


def test_launch_counters_include_the_norms():
    """The norms register their counters in the one registry, which the
    captured programs take back and replay (``utils/graphs.py``)."""
    assert {"group_norm", "layer_norm"} <= set(launches)
