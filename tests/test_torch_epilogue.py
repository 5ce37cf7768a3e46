"""The Dense epilogue wrappers of ``seedx_tpu_torch/ops/epilogue.py`` on the
CPU: their plain chains against the chains the UNet ran before them, bit
for bit; the UNet's transformer blocks with the residual handed to each
Dense against the adds written out; the kernels' launch plan (every
vector of every row once); the checks made before a launch; the autograd
functions' plain-torch backward against autograd through the plain chains
(the kernel forward stood in for by the plain one); and the per-eval
counts.  The kernels themselves run in tests/test_torch_cuda.py on the
card."""

import pytest
import torch
import torch.nn.functional as F

from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.sdxl import unet as tunet
from seedx_tpu_torch.ops import epilogue
from seedx_tpu_torch.ops._build import launches


def _tensors(shape, dtype, seed=0):
    """(y, bias, residual, scale) of the UNet's kind: y and the residual of
    unit scale, a small bias, an int8 path's per-column scale."""
    g = torch.Generator().manual_seed(seed)
    n = shape[-1]
    return ((torch.randn(shape, generator=g) * 2).to(dtype),
            (0.3 * torch.randn(n, generator=g)).to(dtype),
            torch.randn(shape, generator=g).to(dtype),
            (0.02 * torch.rand(n, generator=g) + 1e-3).to(dtype))


# (kind, with a residual, with a scale): GEGLU takes no residual
CASES = [("bias_residual", False, False), ("bias_residual", True, False),
         ("bias_residual", False, True), ("bias_residual", True, True),
         ("bias_geglu", False, False), ("bias_geglu", False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,with_res,with_scale", CASES)
def test_wrappers_on_cpu_are_the_chains_the_unet_ran(dtype, kind, with_res,
                                                     with_scale):
    """The wrappers on the CPU run the plain chains, equal bit for bit to
    what ``Dense`` / ``GEGLU`` computed before the epilogue moved out of
    them, and count no launch."""
    y, bias, res, scale = _tensors((3, 7, 64), dtype)
    s = scale if with_scale else None
    r = res if with_res else None
    proj = y * scale if with_scale else y
    if kind == "bias_residual":
        want = proj + bias
        if with_res:
            want = res + want
        got = epilogue.bias_residual(y, bias, r, s)
    else:
        h, gate = (proj + bias).chunk(2, dim=-1)
        want = h * F.gelu(gate)
        got = epilogue.bias_geglu(y, bias, s)
    n = launches[kind]
    assert got.dtype == dtype and torch.equal(got, want)
    assert launches[kind] == n


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_transformer_block_and_2d_with_the_residual_threaded(quantize):
    """A ``BasicTransformerBlock`` and a ``Transformer2D`` (bf16, int8
    weights too) give, on the same weights, the output of the adds written
    out: ``x + attn1(norm1(x))``, ``x + attn2(norm2(x), ctx)``, ``x +
    ff_out(ff_geglu(norm3(x)))`` and ``proj_out(...).reshape + x``, bit for
    bit."""
    cfg = tunet.sdxl_debug_unet(quantize=quantize)
    c = 64
    t2d = init_normal_(tunet.Transformer2D(c, 2, cfg).eval(),
                       torch.Generator().manual_seed(3))
    if quantize == "int8":
        for m in t2d.modules():
            if isinstance(m, tunet.Dense):
                g = torch.Generator().manual_seed(7)
                m.kernel_q.copy_(torch.randint(-127, 128, m.kernel_q.shape,
                                               generator=g))
                m.kernel_scale.copy_(0.01 * torch.rand(
                    m.kernel_scale.shape, generator=g) + 1e-3)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 4, 5, c), generator=g).to(cfg.dtype)
    ctx = torch.randn((2, 3, cfg.cross_attention_dim), generator=g).to(
        cfg.dtype)

    def block_before(blk, h):
        h = h + blk.attn1(blk.norm1(h))
        h = h + blk.attn2(blk.norm2(h), ctx)
        return h + blk.ff_out(blk.ff_geglu(blk.norm3(h)))

    with torch.no_grad():
        hidden = t2d.proj_in(t2d.norm(x).reshape(2, 20, c))
        blk = t2d.block_0
        assert torch.equal(blk(hidden, ctx), block_before(blk, hidden))
        for i in range(t2d.depth):
            hidden = block_before(getattr(t2d, f"block_{i}"), hidden)
        before = t2d.proj_out(hidden).reshape(x.shape) + x
        assert torch.equal(t2d(x, ctx), before)


# (rows, 16-byte vectors a row): the UNet's at 1024^2, CFG 2 (2048 x 1280,
# 8192 x 640, the GEGLU outputs 2048 x 5120 and 8192 x 2560, the VAE's fp32
# 16384 x 512), the time embeddings' two rows, the debug widths, ragged
# row counts and widths
PLAN_SHAPES = [(2048, 160), (8192, 80), (2048, 640), (8192, 320),
               (16384, 128), (2, 160), (2, 40), (6, 4), (512, 16),
               (3, 1), (231, 160), (1000, 36), (77, 100), (1, 1)]


@pytest.mark.parametrize("rows,nvec", PLAN_SHAPES)
def test_plan_covers_every_vector_once(rows, nvec):
    """``ep_plan``'s launch as the kernels walk it: each (row, vector)
    taken by exactly one thread of one block, within the block's threads
    and the grid's limit, and at most EP_FILL blocks an SM in all (one
    resident wave) unless a strip alone needs more."""
    tx, ty, row_blocks = epilogue.ep_plan(rows, nvec, 132)
    assert tx * ty <= epilogue.EP_THREADS and 1 <= row_blocks <= 65535
    strips = -(-nvec // tx)
    assert strips * row_blocks <= max(strips, epilogue.EP_FILL * 132)
    # thread (x, y) of block (bx, by) takes vector bx * tx + x, if below
    # nvec, of rows by * ty + y, + stride, ... below rows
    stride = row_blocks * ty
    seen = torch.zeros((rows, nvec), dtype=torch.int64)
    for start in range(min(stride, rows)):
        seen[torch.arange(start, rows, stride)] += 1
    cols = torch.tensor([bx * tx + xx for bx in range(strips)
                         for xx in range(tx) if bx * tx + xx < nvec])
    assert torch.equal(cols, torch.arange(nvec))
    assert bool((seen == 1).all())


@pytest.mark.parametrize("case", ["dtype", "width", "bias_dtype",
                                  "geglu_width"])
def test_kernel_args_refuse_what_the_kernels_do_not_take(case):
    """A width that is not a whole number of 16-byte vectors, a type the
    kernels are not built for, or a bias of another type raises; nothing
    falls back."""
    y, bias, _, _ = _tensors((4, 64), torch.float32)
    if case == "dtype":
        y, bias = y.half(), bias.half()
    elif case == "width":
        y, bias = y[:, :62], bias[:62]
    elif case == "bias_dtype":
        bias = bias.bfloat16()
    with pytest.raises(ValueError):
        if case == "geglu_width":
            # halves of 12 bf16 columns: 24 bytes
            epilogue._bias_geglu_kernel(y[:, :24].bfloat16(),
                                        bias[:24].bfloat16(), None)
        else:
            epilogue._bias_residual_kernel(y, bias, None, None)


def test_kernel_args_make_inputs_contiguous():
    y, bias, res, _ = _tensors((8, 4, 64), torch.bfloat16)
    yt, bt, rt, st = epilogue._kernel_args(y.transpose(0, 1), 64, "test",
                                           bias=bias,
                                           residual=res.transpose(0, 1),
                                           scale=None)
    assert yt.is_contiguous() and torch.equal(yt, y.transpose(0, 1))
    assert rt.is_contiguous() and st is None and bt is bias


def _grads(fn, leaves, dy):
    """Gradients of sum(fn(*leaves) * dy) by autograd, for the leaves that
    are tensors (None stays None)."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in leaves]
    (fn(*leaves).float() * dy.float()).sum().backward()
    return [None if t is None else t.grad for t in leaves]


def _close(got, want, dtype):
    """fp32: within 1e-5 of each gradient's largest; bf16: one ULP
    (relative 2^-7) plus 1e-3 of the largest, where the order of a bf16
    sum over rows differs."""
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        mag = w.float().abs().max().item()
        torch.testing.assert_close(
            g.float(), w.float(),
            rtol=2.0 ** -7 if dtype == torch.bfloat16 else 0,
            atol=(1e-3 if dtype == torch.bfloat16 else 1e-5) * mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,with_res,with_scale", CASES)
def test_function_grads_match_the_plain_chain(monkeypatch, dtype, kind,
                                              with_res, with_scale):
    """``epilogue._BiasResidual`` / ``_BiasGeglu`` (the CUDA wrappers'
    autograd functions, the kernel forward stood in for by the plain
    chain) against autograd through ``bias_residual_plain`` /
    ``bias_geglu_plain``: the gradients of y, the bias, the residual and
    the scale.  One count a call is the kernel launch's alone: the
    functions add none of their own (a stood-in kernel counts nothing)."""
    monkeypatch.setattr(epilogue, "_bias_residual_kernel",
                        epilogue.bias_residual_plain)
    monkeypatch.setattr(epilogue, "_bias_geglu_kernel",
                        epilogue.bias_geglu_plain)
    y, bias, res, scale = _tensors((2, 5, 64), dtype, seed=3)
    s = scale if with_scale else None
    out_shape = (2, 5, 64 if kind == "bias_residual" else 32)
    dy = torch.randn(out_shape, generator=torch.Generator().manual_seed(4)
                     ).to(dtype)
    n = launches[kind]
    if kind == "bias_residual":
        leaves = [y, bias, res if with_res else None, s]
        got = _grads(epilogue._BiasResidual.apply, leaves, dy)
        want = _grads(epilogue.bias_residual_plain, leaves, dy)
    else:
        leaves = [y, bias, s]
        got = _grads(epilogue._BiasGeglu.apply, leaves, dy)
        want = _grads(epilogue.bias_geglu_plain, leaves, dy)
    assert launches[kind] == n
    _close(got, want, dtype)


def test_functions_skip_unneeded_grads(monkeypatch):
    """No gradient for a bias or scale that needs none (the UNet's frozen
    buffers), the input's still."""
    monkeypatch.setattr(epilogue, "_bias_residual_kernel",
                        epilogue.bias_residual_plain)
    y, bias, res, scale = _tensors((3, 32), torch.float32)
    y.requires_grad_(True)
    epilogue._BiasResidual.apply(y, bias, res, scale).sum().backward()
    assert y.grad is not None and bias.grad is None and scale.grad is None
    assert torch.equal(y.grad, scale.expand(3, 32))


@pytest.mark.parametrize("make", [tunet.sdxl_base_unet, tunet.sdxl_edit_unet,
                                  tunet.sdxl_debug_unet,
                                  lambda: tunet.UNetConfig(
                                      block_out_channels=(640,),
                                      transformer_layers=(2,))])
def test_epilogue_launches_per_eval_counts_the_modules(make):
    """One call an eval of every Dense with a bias and every GEGLU: the
    helper's counts are the modules' ((253, 70) for SDXL base)."""
    cfg = make()
    unet = tunet.UNet2DCondition(cfg, device="meta")
    gegl = [m for m in unet.modules() if isinstance(m, tunet.GEGLU)]
    projs = {id(m.proj) for m in gegl}
    biased = sum(isinstance(m, tunet.Dense) and m.use_bias
                 and id(m) not in projs for m in unet.modules())
    assert tunet.epilogue_launches_per_eval(cfg) == (biased, len(gegl))
    if cfg == tunet.sdxl_base_unet():
        assert (biased, len(gegl)) == (253, 70)


def test_debug_unet_eval_calls_each_epilogue_once(monkeypatch):
    """The debug UNet's forward on the CPU calls ``bias_residual`` and
    ``bias_geglu`` the helper's number of times, the residual handed to
    three a transformer block and to each ``proj_out``."""
    calls = {"bias_residual": 0, "residual": 0, "bias_geglu": 0}

    def count(name, fn):
        def wrapped(y, bias, *rest):
            calls[name] += 1
            if name == "bias_residual" and rest and rest[0] is not None:
                calls["residual"] += 1
            return fn(y, bias, *rest)
        return wrapped

    monkeypatch.setattr(tunet, "bias_residual",
                        count("bias_residual", epilogue.bias_residual))
    monkeypatch.setattr(tunet, "bias_geglu",
                        count("bias_geglu", epilogue.bias_geglu))
    cfg = tunet.sdxl_debug_unet()
    unet = tunet.UNet2DCondition(cfg).eval()
    pooled = (cfg.projection_class_embeddings_input_dim
              - 6 * cfg.addition_time_embed_dim)
    with torch.no_grad():
        unet(torch.randn(2, 8, 8, 4), torch.tensor([5.0, 9.0]),
             torch.randn(2, 3, cfg.cross_attention_dim),
             torch.randn(2, pooled), torch.zeros(2, 6))
    blocks = tunet.flash_launches_per_eval(cfg)
    transformers = sum(isinstance(m, tunet.Transformer2D)
                       for m in unet.modules())
    assert (calls["bias_residual"], calls["bias_geglu"]) == \
        tunet.epilogue_launches_per_eval(cfg)
    assert calls["residual"] == 3 * blocks + transformers


def test_launch_counters_include_the_epilogues():
    """The epilogues register their counters in the one registry, which
    the captured programs take back and replay (``utils/graphs.py``)."""
    assert {"bias_residual", "bias_geglu"} <= set(launches)
