"""Parity of the port's SDXL denoise pipelines with the JAX package's:
``denoise_text2image`` over 3 steps of each solver (with and without
guidance rescale) and ``denoise_edit``'s 3-way CFG and its 2-branch
collapse at ``image_guidance_scale == 1.0``, on the debug UNets of
``tests/test_torch_sdxl.py`` (same weights, same numpy latents, fp32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.models.sdxl import pipeline as jpipe
from seedx_tpu.models.sdxl import scheduler as jsched
from seedx_tpu.models.sdxl import unet as junet
from seedx_tpu_torch.models.sdxl import pipeline as tpipe
from seedx_tpu_torch.models.sdxl import scheduler as tsched
from test_torch_models import _close
from test_torch_sdxl import F32_REL, F32_REL_DEEP, _jax_unet, _rng_inputs, \
    _torch_unet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def edit_unets():
    """The 8-channel debug UNet on both sides (the edit pipeline; the t2i
    pipeline runs the 4-channel one)."""
    out = {}
    for ch in (4, 8):
        cfg_j, params = _jax_unet(ch, seed=20 + ch)
        out[ch] = (junet.UNet2DCondition(cfg_j), params,
                   _torch_unet(params, ch))
    return out


def _cond(seed, b=1, t=8, ctx=64, pooled=64):
    return _rng_inputs(seed, (b, t, ctx), (b, t, ctx), (b, pooled),
                       (b, pooled))


@pytest.mark.parametrize("solver,rescale", [
    ("euler", 0.0), ("euler", 0.7), ("dpmpp_2m", 0.0), ("dpmpp_3m", 0.7)])
def test_denoise_text2image_matches_jax(edit_unets, solver, rescale):
    unet_j, params, unet_t = edit_unets[4]
    schedule = tsched.make_schedule(3, solver=solver)
    (lat,) = _rng_inputs(30, (1, 8, 8, 4))
    cond = _cond(31)
    tids = np.array([[64, 64, 0, 0, 64, 64]], np.float32)
    want = jpipe.denoise_text2image(
        unet_j, params, jsched.make_schedule(3, solver=solver),
        jnp.asarray(lat * schedule.init_noise_sigma),
        *map(jnp.asarray, cond), jnp.asarray(tids), guidance_scale=5.0,
        guidance_rescale=rescale)
    with torch.no_grad():
        got = tpipe.denoise_text2image(
            unet_t, schedule,
            torch.from_numpy(lat * schedule.init_noise_sigma),
            *map(torch.from_numpy, cond), torch.from_numpy(tids),
            guidance_scale=5.0, guidance_rescale=rescale)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, F32_REL_DEEP)


def test_denoise_edit_matches_jax_and_collapses(edit_unets):
    """3-way CFG against JAX; the gi = 1.0 path (2 branches) against JAX's
    and against the 3-branch combination run by hand at gi = 1.0."""
    unet_j, params, unet_t = edit_unets[8]
    schedule = tsched.make_schedule(3)
    lat, img_lat = _rng_inputs(40, (1, 8, 8, 4), (1, 8, 8, 4))
    lat = lat * schedule.init_noise_sigma
    cond = _cond(41)
    tids = np.array([[64, 64, 0, 0, 64, 64]], np.float32)
    j_args = (jnp.asarray(lat), jnp.asarray(img_lat),
              *map(jnp.asarray, cond), jnp.asarray(tids))
    t_args = (torch.from_numpy(lat), torch.from_numpy(img_lat),
              *map(torch.from_numpy, cond), torch.from_numpy(tids))
    for gi in (1.5, 1.0):
        want = jpipe.denoise_edit(unet_j, params, jsched.make_schedule(3),
                                  *j_args, guidance_scale=5.0,
                                  image_guidance_scale=gi)
        with torch.no_grad():
            got = tpipe.denoise_edit(unet_t, schedule, *t_args,
                                     guidance_scale=5.0,
                                     image_guidance_scale=gi)
        _close(got.numpy(), want, F32_REL_DEEP)

    # the 3 branches [text, image, uncond] by hand at gi = 1.0
    lat_t, img_t, prompt, neg, pooled, neg_pooled, tids_t = t_args
    zeros = torch.zeros_like(img_t)

    def three_branch(x, sigma, t):
        scaled = tsched.scale_model_input(torch.cat([x] * 3), sigma)
        scaled = torch.cat([scaled, torch.cat([img_t, img_t, zeros])], -1)
        eps = unet_t(scaled, t.expand(3), torch.cat([prompt, neg, neg]),
                     torch.cat([pooled, neg_pooled, neg_pooled]),
                     torch.cat([tids_t] * 3))
        e_text, e_image, e_uncond = eps.chunk(3)
        return e_uncond + 5.0 * (e_text - e_image) + 1.0 * (e_image
                                                           - e_uncond)

    with torch.no_grad():
        manual = tpipe._solver_loop(schedule, lat_t, three_branch)
    _close(got.numpy(), manual.numpy(), F32_REL)


def test_generate_spans_its_phases_and_each_unet_eval():
    """Recorded, an image is one ``sdxl.generate`` span over its phases,
    with one ``sdxl.unet_eval`` a step inside ``sdxl.denoise``; the image
    and the ``timings`` keys are those of an unrecorded call."""
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.utils import profiling

    ad = SeedXRuntime.debug(device="cpu", with_adapter=True).adapter
    embeds = torch.from_numpy(_rng_inputs(40, (1, 256, 64))[0])
    off: dict = {}
    want = ad.generate(embeds, num_inference_steps=3, timings=off)
    profiling.clear()
    on: dict = {}
    with profiling.recording():
        got = ad.generate(embeds, num_inference_steps=3, timings=on)
        ad.generate(embeds, num_inference_steps=2)
    recs = profiling.records()
    profiling.clear()
    np.testing.assert_array_equal(got, want)
    assert set(on) == set(off) == {"conditioning", "denoise", "vae_decode"}
    images = [r for r in recs if r["name"] == "sdxl.generate"]
    assert [r["attrs"] for r in images] == [{"b": 1, "steps": 3},
                                            {"b": 1, "steps": 2}]
    for image, steps in zip(images, (3, 2)):
        phases = [r for r in recs if r["parent"] == image["id"]]
        assert [r["name"] for r in phases] == [
            "sdxl.conditioning", "sdxl.denoise", "sdxl.vae_decode",
            "sdxl.to_host"]
        (denoise,) = [r for r in phases if r["name"] == "sdxl.denoise"]
        evals = [r for r in recs if r["name"] == "sdxl.unet_eval"
                 and r["parent"] == denoise["id"]]
        assert [r["attrs"]["i"] for r in evals] == list(range(steps))
        assert all(denoise["t0"] <= r["t0"] <= r["t1"] <= denoise["t1"]
                   for r in evals)
    assert sum(r["name"] == "sdxl.unet_eval" for r in recs) == 5
