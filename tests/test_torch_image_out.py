"""Image out, end to end: the JAX package's ``SeedXRuntime.debug(
with_adapter=True)`` weights converted into the port's ``debug(
with_adapter=True)`` runtime must give the same images through
``reconstruct``, ``reconstruct_with_condition`` and the agent-to-image
path (a prompt ending in ``<img>``, the forced span's features through the
adapter).  The serving entry points on the port's debug runtime:
``tests/test_torch_image_serving.py``.

Float32 configs on both sides (the algorithm is the point).  Both packages
start the denoise from the same noise, ``jax.random.normal(PRNGKey(seed),
...)``, injected into the port's ``prepare_latents`` here.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import linen as nn

from seedx_tpu.inference import apps as japps
from seedx_tpu.inference.runtime import SeedXRuntime as JaxRuntime
from seedx_tpu.models import agent as jagent
from seedx_tpu.models.detokenizer import ResamplerXL as JaxResamplerXL
from seedx_tpu.models.sdxl.unet import UNet2DCondition as JaxUNet
from seedx_tpu.models.vit import VisionTransformer as JaxViT
from seedx_tpu_torch.inference import apps as tapps
from seedx_tpu_torch.inference.runtime import SeedXRuntime as TorchRuntime
from seedx_tpu_torch.models import adapter as tadapter
from seedx_tpu_torch.text import prompts as tprompts
from seedx_tpu_torch.utils.convert import load_jax_params
from test_torch_models import randomize

torch.set_num_threads(1)

# images in [0, 1] after fp32 ViT, resampler, 3 UNet steps of 3-way CFG
# and the VAE on both sides: summation orders only
IMAGE_ATOL = 1e-4
STEPS = 3
# new tokens that hold the debug agent's forced image span (its 256 output
# tokens and </img>)
SPAN_BUDGET = 260


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))


def _fast_init(orig):
    """``Module.init`` through ``jax.eval_shape`` (zeros of the parameter
    shapes, no compile): the weights are redrawn by ``randomize``."""
    def init(self, rngs, *args, method=None, **kwargs):
        shapes = jax.eval_shape(functools.partial(orig, self, method=method,
                                                  **kwargs), rngs, *args)
        return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                            nn.meta.unbox(shapes))
    return init


def _jax_runtime():
    """The JAX package's debug runtime with its adapter, every parameter
    redrawn, its modules rebuilt in float32 (the parameters are fp32
    already; only the compute dtype changes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _fast_init(nn.Module.init))
        rt = JaxRuntime.debug(with_adapter=True)
    ad = rt.adapter
    rt.vit_params = randomize(rt.vit_params, 1)
    rt.agent_params = randomize(rt.agent_params, 2)
    ad.unet_params = randomize(ad.unet_params, 3)
    ad.resampler_params = randomize(ad.resampler_params, 4)
    ad.vae_decoder_params = randomize(ad.vae_decoder_params, 5)
    ad.vae_encoder_params = randomize(ad.vae_encoder_params, 6)

    rt.vit_cfg = dataclasses.replace(rt.vit_cfg, dtype=jnp.float32)
    rt.vit = JaxViT(rt.vit_cfg, remat=False)
    llm = dataclasses.replace(rt.agent_cfg.llm, dtype=jnp.float32)
    rt.agent_cfg = dataclasses.replace(rt.agent_cfg, llm=llm,
                                       dtype=jnp.float32)
    rt.agent = jagent.ContinuousLVLM(rt.agent_cfg)
    ad.cfg = dataclasses.replace(
        ad.cfg, unet=dataclasses.replace(ad.cfg.unet, dtype=jnp.float32),
        resampler=dataclasses.replace(ad.cfg.resampler, dtype=jnp.float32))
    ad.unet, ad.resampler = JaxUNet(ad.cfg.unet), JaxResamplerXL(
        ad.cfg.resampler)
    ad.visual_encoder, ad.visual_encoder_params = rt.vit, rt.vit_params
    return rt


@pytest.fixture(scope="module")
def runtimes():
    rt_j = _jax_runtime()
    rt_t = TorchRuntime.debug(dtype=torch.float32, device="cpu",
                              with_adapter=True)
    ad_j, ad_t = rt_j.adapter, rt_t.adapter
    for module, tree in ((rt_t.vit, rt_j.vit_params),
                         (rt_t.agent, rt_j.agent_params),
                         (ad_t.unet, ad_j.unet_params),
                         (ad_t.resampler, ad_j.resampler_params),
                         (ad_t.vae_decoder, ad_j.vae_decoder_params),
                         (ad_t.vae_encoder, ad_j.vae_encoder_params)):
        load_jax_params(module, tree)     # strict: the same geometry
    assert ad_t.visual_encoder is rt_t.vit
    return rt_j, rt_t


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's initial noise taken from ``jax.random.normal``, as the
    JAX package's ``prepare_latents`` draws it."""
    def prepare(generator, batch, cfg, schedule, dtype=torch.float32):
        seed = generator.initial_seed()
        h, w = cfg.latent_hw
        noise = jax.random.normal(jax.random.PRNGKey(seed),
                                  (batch, h, w, cfg.latent_channels))
        return torch.from_numpy(np.array(noise)).to(
            dtype) * schedule.init_noise_sigma
    monkeypatch.setattr(tadapter, "prepare_latents", prepare)


@pytest.mark.parametrize("with_condition", [False, True])
def test_reconstruct_matches_jax(runtimes, jax_noise, with_condition):
    rt_j, rt_t = runtimes
    img, cond = _image(70, 50, 1), _image(40, 60, 2)
    if with_condition:
        want = japps.reconstruct_with_condition(rt_j, img, cond, seed=7,
                                                num_inference_steps=STEPS)
        got = tapps.reconstruct_with_condition(rt_t, img, cond, seed=7,
                                               num_inference_steps=STEPS)
    else:
        want = japps.reconstruct(rt_j, img, seed=7,
                                 num_inference_steps=STEPS)
        got = tapps.reconstruct(rt_t, img, seed=7, num_inference_steps=STEPS)
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert got.dtype == np.float32 and 0.0 <= got.min() and got.max() <= 1.0
    assert np.ptp(want) > 0.1        # an image, not a clipped constant
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)


def test_agent_to_image_matches_jax(runtimes, jax_noise):
    """A prompt ending in ``<img>``: the forced span's ``img_gen_feat``
    through ``rt.adapter.generate`` (3-way CFG on the 8-channel UNet with
    zero condition latents, the pooled negative)."""
    rt_j, rt_t = runtimes
    tok = rt_t.tokenizer
    ids = [tok.bos_token_id] + tok.encode(
        tprompts.generation_prompt("a red bicycle by a lake") + "<img>")
    assert rt_t.agent_cfg.num_img_out_tokens + 1 <= SPAN_BUDGET
    out_j = rt_j.generate(ids, max_new_tokens=SPAN_BUDGET)
    out_t = rt_t.generate(ids, max_new_tokens=SPAN_BUDGET)
    assert out_j["has_img_output"] and out_t["has_img_output"]
    feat_j = np.asarray(out_j["img_gen_feat"])
    np.testing.assert_allclose(out_t["img_gen_feat"].numpy(), feat_j,
                               rtol=0, atol=1e-5 * np.abs(feat_j).max())
    want = rt_j.adapter.generate(out_j["img_gen_feat"], seed=3,
                                 num_inference_steps=STEPS)
    got = rt_t.adapter.generate(out_t["img_gen_feat"], seed=3,
                                num_inference_steps=STEPS)
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
