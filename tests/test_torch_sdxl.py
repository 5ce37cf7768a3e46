"""Parity of the port's SDXL modules with the JAX package's, on the same
weights: schedules, step functions, the UNet (fp32 and int8 weights, one
bf16 case), the VAE and ``ResamplerXL`` (the denoise pipelines:
``tests/test_torch_sdxl_pipeline.py``).  JAX
parameter trees come from ``init`` with every float leaf redrawn from
``np.random.default_rng`` (``randomize``) and load into the port through
``utils/convert.py``; the same numpy inputs go through both.  Float32
configs on both sides, so the comparison is of the algorithm: each output
within ``F32_REL`` of its largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from seedx_tpu.models import detokenizer as jdet
from seedx_tpu.models.sdxl import pipeline as jpipe
from seedx_tpu.models.sdxl import scheduler as jsched
from seedx_tpu.models.sdxl import unet as junet
from seedx_tpu.models.sdxl import vae as jvae
from seedx_tpu.ops.norms import group_norm_fp32_stats as j_group_norm
from seedx_tpu.utils.quantize import quantize_unet_params as j_quantize_unet
from seedx_tpu_torch.models import detokenizer as tdet
from seedx_tpu_torch.models.sdxl import pipeline as tpipe
from seedx_tpu_torch.models.sdxl import scheduler as tsched
from seedx_tpu_torch.models.sdxl import unet as tunet
from seedx_tpu_torch.models.sdxl import vae as tvae
from seedx_tpu_torch.ops.norms import group_norm_fp32_stats as t_group_norm
from seedx_tpu_torch.utils.convert import load_jax_params
from seedx_tpu_torch.utils.quantize import quantize_unet_params
from test_torch_models import _close, randomize

torch.set_num_threads(1)

# fp32 on both sides; XLA and ATen sum in different orders, and the
# differences grow through the UNet's ~40 layers and the 3-step loops
F32_REL = 1e-5
F32_REL_DEEP = 5e-5
# bf16 compute (weights and activations rounded to 8 bits of mantissa,
# summation orders differ): a few bf16 ULPs of the largest output
BF16_REL = 3e-2


def _params(model, seed, *args):
    """A random parameter tree of ``model`` (``randomize`` over the shapes
    of ``model.init``, traced with ``jax.eval_shape``: no init compile)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, args))["params"]
    return randomize(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                                  nn.meta.unbox(shapes)), seed)


def _rng_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---- scheduler ------------------------------------------------------------

@pytest.mark.parametrize("solver", ["euler", "dpmpp_2m", "dpmpp_3m"])
@pytest.mark.parametrize("steps", [3, 14, 30])
def test_schedule_tables_equal_jax(solver, steps):
    got = tsched.make_schedule(steps, solver=solver)
    want = jsched.make_schedule(steps, solver=solver)
    assert got.init_noise_sigma == want.init_noise_sigma
    assert got.solver == want.solver
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("step", ["scale", "euler", "2m_first", "2m_second",
                                  "3m_1", "3m_2", "3m_3", "add_noise"])
def test_step_functions_match_jax(step):
    x, eps, m1, m2 = _rng_inputs(1, *[(2, 8, 8, 4)] * 4)
    sigma, sigma_next = np.float32(3.7), np.float32(2.2)
    r0, r1, c1, c2 = (np.float32(v) for v in (0.8, 1.3, 0.4, -0.05))
    t = [torch.from_numpy(a) for a in (x, eps, m1, m2)]
    j = [jnp.asarray(a) for a in (x, eps, m1, m2)]
    ts = [torch.tensor(v) for v in (sigma, sigma_next, r0, r1, c1, c2)]
    js = [jnp.asarray(v) for v in (sigma, sigma_next, r0, r1, c1, c2)]
    if step == "scale":
        got = tsched.scale_model_input(t[0], ts[0])
        want = jsched.scale_model_input(j[0], js[0])
    elif step == "euler":
        got = tsched.euler_step(t[0], t[1], ts[0], ts[1])
        want = jsched.euler_step(j[0], j[1], js[0], js[1])
    elif step.startswith("2m"):
        second = step == "2m_second"
        got = torch.cat(tsched.dpmpp_2m_step(t[0], t[2], t[1], ts[0], ts[1],
                                             ts[2], second))
        want = jnp.concatenate(jsched.dpmpp_2m_step(
            j[0], j[2], j[1], js[0], js[1], js[2], second))
    elif step.startswith("3m"):
        order = int(step[-1])
        got = torch.cat(tsched.dpmpp_3m_step(t[0], t[2], t[3], t[1], *ts,
                                             order))
        want = jnp.concatenate(jsched.dpmpp_3m_step(j[0], j[2], j[3], j[1],
                                                    *js, order))
    else:
        got = tsched.add_noise(t[0], t[1], ts[0])
        want = jsched.add_noise(j[0], j[1], js[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


# ---- norms ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_fp32_stats_matches_jax(dtype):
    x, scale, bias = _rng_inputs(2, (2, 6, 10, 64), (64,), (64,))
    x = x * 3.0 + 1.5
    want = j_group_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                        jnp.asarray(bias), 8, 1e-6)
    got = t_group_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(scale), torch.from_numpy(bias), 8,
                       1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16: both round one fp32 value once; the fp32 statistics differ in
    # summation order only, so at most one bf16 ULP apart
    _close(got.float().numpy(), np.asarray(want, np.float32),
           F32_REL if dtype == "float32" else 2 ** -7)


# ---- UNet -------------------------------------------------------------------

def _unet_inputs(cfg, b=2, h=16, w=24, seed=3):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((b, h, w, cfg.in_channels)).astype(
        np.float32)
    t = np.array([981.0, 21.0][:b], np.float32)
    ctx = rng.standard_normal((b, 8, cfg.cross_attention_dim)).astype(
        np.float32)
    pooled_dim = (cfg.projection_class_embeddings_input_dim
                  - 6 * cfg.addition_time_embed_dim)
    pooled = rng.standard_normal((b, pooled_dim)).astype(np.float32)
    tids = np.tile(np.array([[64, 96, 0, 0, 64, 96]], np.float32), (b, 1))
    return sample, t, ctx, pooled, tids


def _jax_unet(in_channels, seed=4, **kw):
    cfg = junet.sdxl_debug_unet(in_channels=in_channels, dtype=jnp.float32,
                                **kw)
    model = junet.UNet2DCondition(cfg)
    return cfg, _params(model, seed, *_unet_inputs(cfg, b=1, h=8, w=8))


def _torch_unet(params, in_channels, dtype=torch.float32, **kw):
    cfg = tunet.sdxl_debug_unet(in_channels=in_channels, dtype=dtype, **kw)
    return load_jax_params(tunet.UNet2DCondition(cfg).eval(), params)


@pytest.mark.parametrize("in_channels", [4, 8])
def test_unet_matches_jax(in_channels):
    """eps of the debug UNet (a 1x1 shortcut, a stride-2 downsample, a
    nearest upsample, self- and cross-attention) on non-square latents."""
    cfg_j, params = _jax_unet(in_channels)
    args = _unet_inputs(cfg_j)
    want = jax.jit(junet.UNet2DCondition(cfg_j).apply)({"params": params},
                                              *map(jnp.asarray, args))
    with torch.no_grad():
        got = _torch_unet(params, in_channels)(*map(torch.from_numpy, args))
    assert got.shape == want.shape
    _close(got.numpy(), want, F32_REL_DEEP)


def test_unet_bf16_matches_jax():
    cfg_j, params = _jax_unet(4)
    cfg_j = dataclasses.replace(cfg_j, dtype=jnp.bfloat16)
    args = _unet_inputs(cfg_j)
    want = jax.jit(junet.UNet2DCondition(cfg_j).apply)({"params": params},
                                              *map(jnp.asarray, args))
    with torch.no_grad():
        got = _torch_unet(params, 4, torch.bfloat16)(
            *map(torch.from_numpy, args))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_REL)


def test_int8_unet_matches_jax():
    """``quantize_unet_params`` on both sides gives the same int8 bytes and
    scales (convs too, through the layout change), and the Dense8 / Conv8
    UNets the same eps."""
    cfg_j, params = _jax_unet(8)
    q_j = j_quantize_unet(params)
    q_t = quantize_unet_params(_torch_unet(params, 8).state_dict())
    unet_q = _torch_unet(q_j, 8, quantize="int8")    # the JAX bytes, loaded
    want = unet_q.state_dict()
    assert set(q_t) == set(want)
    assert any(k.endswith("weight_q") for k in want)
    for k, v in want.items():
        assert torch.equal(q_t[k], v), k

    cfg_q = dataclasses.replace(cfg_j, quantize="int8")
    args = _unet_inputs(cfg_j)
    want = jax.jit(junet.UNet2DCondition(cfg_q).apply)({"params": q_j},
                                              *map(jnp.asarray, args))
    with torch.no_grad():
        got = unet_q(*map(torch.from_numpy, args))
    _close(got.numpy(), want, F32_REL_DEEP)


# ---- VAE ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_pair():
    cfg_j = jvae.vae_debug()
    enc_j, dec_j = jvae.VAEEncoder(cfg_j), jvae.VAEDecoder(cfg_j)
    enc_p = _params(enc_j, 5, np.zeros((1, 16, 16, 3), np.float32))
    dec_p = _params(dec_j, 6, np.zeros((1, 8, 8, 4), np.float32))
    cfg_t = tvae.vae_debug()
    enc_t = load_jax_params(tvae.VAEEncoder(cfg_t).eval(), enc_p)
    dec_t = load_jax_params(tvae.VAEDecoder(cfg_t).eval(), dec_p)
    return (enc_j, enc_p, dec_j, dec_p), (enc_t, dec_t)


def test_vae_encoder_moments_and_mode_match_jax(vae_pair):
    (enc_j, enc_p, _, _), (enc_t, _) = vae_pair
    (img,) = _rng_inputs(7, (2, 24, 16, 3))
    want = jax.jit(enc_j.apply)({"params": enc_p}, jnp.asarray(img))
    with torch.no_grad():
        got = enc_t(torch.from_numpy(img))
    assert got.shape == want.shape == (2, 12, 8, 8)
    _close(got.numpy(), want, F32_REL)
    _close(tvae.sample_moments(got).numpy(), jvae.sample_moments(want),
           F32_REL)


def test_vae_decoder_matches_jax(vae_pair):
    (_, _, dec_j, dec_p), (_, dec_t) = vae_pair
    (lat,) = _rng_inputs(8, (2, 12, 8, 4))
    want = jax.jit(dec_j.apply)({"params": dec_p}, jnp.asarray(lat))
    with torch.no_grad():
        got = dec_t(torch.from_numpy(lat))
    assert got.shape == want.shape == (2, 24, 16, 3)
    _close(got.numpy(), want, F32_REL)
    # decode_latents: the scaling, the decoder, the [0, 1] clip
    _close(tpipe.decode_latents(dec_t, torch.from_numpy(lat)).numpy(),
           jpipe.decode_latents(dec_j, dec_p, jnp.asarray(lat)), F32_REL)


# ---- detokenizer ------------------------------------------------------------

def _detok_cfgs(normalize):
    kw = dict(dim=64, depth=2, dim_head=16, heads=4, num_queries=8,
              embedding_dim=48, output1_dim=24, output2_dim=40, ff_mult=2,
              normalize=normalize)
    return (jdet.DetokenizerConfig(dtype=jnp.float32, **kw),
            tdet.DetokenizerConfig(dtype=torch.float32, **kw))


@pytest.mark.parametrize("normalize", [False, True])
def test_resampler_xl_matches_jax(normalize):
    cfg_j, cfg_t = _detok_cfgs(normalize)
    (x,) = _rng_inputs(9, (2, 20, 48))
    x = x * 4.0 + 1.0        # the token-axis norm must not be a no-op
    model = jdet.ResamplerXL(cfg_j)
    params = _params(model, 10, x)
    prompt_j, pooled_j = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    res = load_jax_params(tdet.ResamplerXL(cfg_t).eval(), params)
    with torch.no_grad():
        prompt_t, pooled_t = res(torch.from_numpy(x))
    assert prompt_t.shape == (2, 8, 64) and pooled_t.shape == (2, 40)
    _close(prompt_t.numpy(), prompt_j, F32_REL)
    _close(pooled_t.numpy(), pooled_j, F32_REL)


def test_attention_pool_matches_jax():
    (x,) = _rng_inputs(11, (3, 8, 64))
    model = jdet.AttentionPool2d(num_heads=4, output_dim=40,
                                 dtype=jnp.float32)
    params = _params(model, 12, x)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    pool = load_jax_params(tdet.AttentionPool2d(8, 64, 4, 40,
                                                dtype=torch.float32), params)
    with torch.no_grad():
        got = pool(torch.from_numpy(x))
    _close(got.numpy(), want, F32_REL)
