"""The split SDXL denoise (``SDXLAdapter.shard``: CFG branches over
``data``, latent rows over ``tensor`` with conv halos; ``models/sdxl/
unet.RowSplit``) on gloo ranks, against the unsharded port and against
the JAX package's denoise on its 8-device virtual mesh at tensor 8
(``tests/test_sharding.py``'s case).

The ranks are processes of ``tests/test_torch_shard_worker.py`` (torch and
the port only, a FileStore under ``tmp_path``, each run killed past its
time limit).  The adapter is the debug runtime's (the 8-channel edit
UNet, 3-way CFG, 64^2 images from 32^2 latents), fp32, with the JAX
runtime's weights; both sides start from the same noise and the same ViT
features; text to image runs with zeros for the condition latents, edit
with a condition image.  Layouts (data, fsdp, tensor): data 2 (3 branches
padded to 4), tensor 2, tensor 4 (8 latent rows a rank, 4 after the
downsample), data 2 x tensor 2.

Tolerances (images in [0, 1]): data 2 bit-equal to the unsharded port
(each branch runs alone through the same kernels); a row split within
2e-5 (the GroupNorm sums and the attention's keys add in another order:
fp32 rounding); against JAX's tensor-8 denoise within 1e-4, tighter than
JAX's own 2e-2 between its sharded and single-device runs.  Two mutants
at tensor 2 must miss the unsharded images by more than 1e-3: zeros in
place of every halo, and GroupNorm with each rank's own statistics.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from seedx_tpu.parallel import create_mesh as jcreate_mesh

from test_torch_image_out import _jax_runtime
from test_torch_sharding import _flat, _image, _join, _start

torch.set_num_threads(1)

STEPS = 3
SPLIT_TOL = 2e-5
JAX_TOL = 1e-4
MUTANT_MISS = 1e-3
LAYOUTS = {"data2": (2, 1, 1), "tensor2": (1, 1, 2), "tensor4": (1, 1, 4),
           "data2_tensor2": (2, 1, 2)}


@pytest.fixture(scope="module")
def denoise_runs(tmp_path_factory):
    """Every layout's gloo run, started together, and JAX's tensor-8
    text-to-image denoise computed while they run."""
    rt_j = _jax_runtime()
    ad = rt_j.adapter
    h, w = ad.cfg.sampler.latent_hw
    noise = np.array(jax.random.normal(jax.random.PRNGKey(42), (
        1, h, w, ad.cfg.sampler.latent_channels)))
    embeds = np.asarray(rt_j.encode_image_single(Image.fromarray(_image())))
    cond = (np.random.default_rng(4).random((1, 64, 64, 3)) * 2 - 1).astype(
        np.float32)
    inputs = {"noise": noise, "embeds": embeds, "cond": cond,
              "steps": np.array(STEPS)}
    for key, tree in (("vit", rt_j.vit_params), ("unet", ad.unet_params),
                      ("resampler", ad.resampler_params),
                      ("vae_decoder", ad.vae_decoder_params),
                      ("vae_encoder", ad.vae_encoder_params)):
        inputs.update(_flat(key, tree))
    root = tmp_path_factory.mktemp("denoise")
    runs = {name: _start("denoise", int(np.prod(layout)), root, dict(
        inputs, mesh=np.array(layout), mutants=np.array(name == "tensor2")),
        name) for name, layout in LAYOUTS.items()}
    ad.shard(jcreate_mesh(data=1, fsdp=1, tensor=8))
    want_j = np.asarray(ad.generate(embeds, from_vit=True,
                                    num_inference_steps=STEPS))
    return want_j, {name: _join(run) for name, run in runs.items()}


@pytest.mark.parametrize("mode", ["t2i", "edit"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_denoise_matches_the_unsharded_port(denoise_runs, layout,
                                                  mode):
    """Every rank returns the whole image: bit-equal to the unsharded port
    over data 2, within SPLIT_TOL on a row split; the same on every
    rank."""
    outs = denoise_runs[1][layout]
    for out in outs:
        want = out[f"{mode}_full"]
        assert out[mode].shape == want.shape == (1, 64, 64, 3)
        if LAYOUTS[layout][2] == 1:
            np.testing.assert_array_equal(out[mode], want)
        else:
            np.testing.assert_allclose(out[mode], want, rtol=0,
                                       atol=SPLIT_TOL)
        np.testing.assert_array_equal(out[mode], outs[0][mode])
        np.testing.assert_array_equal(want, outs[0][f"{mode}_full"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_denoise_matches_jax_tensor8(denoise_runs, layout):
    want_j, outs = denoise_runs
    for out in outs[layout]:
        np.testing.assert_allclose(out["t2i"], want_j, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_denoise_collectives(denoise_runs, layout):
    """The host's collectives (``COLLECTIVES``) of one text-to-image
    generate, 3 UNet evals and the VAE decode, on every layout: one halo
    exchange per 3x3 conv, one all-reduce per GroupNorm, one gather of the
    keys and values per self-attention, and the rows and the CFG branches
    gathered once an eval (the decode: its rows once)."""
    from seedx_tpu_torch.models.sdxl.unet import (UNet2DCondition,
                                                  sdxl_debug_unet)
    from seedx_tpu_torch.models.sdxl.vae import VAEDecoder, vae_debug
    from seedx_tpu_torch.models.sdxl import unet as tunet, vae as tvae

    unet = UNet2DCondition(sdxl_debug_unet(in_channels=8))
    dec = VAEDecoder(vae_debug())

    def convs3(m):
        return sum(isinstance(c, tunet.Conv) and c.kernel_size[0] == 3
                   for c in m.modules())

    def norms(m):
        return sum(isinstance(c, tunet.GroupNorm) for c in m.modules())

    def attn(m):
        return (sum(isinstance(c, tunet.BasicTransformerBlock)
                    for c in m.modules())
                + sum(isinstance(c, tvae.VAEAttention) for c in m.modules()))

    want = {"halo": STEPS * convs3(unet) + convs3(dec),
            "all_reduce": STEPS * norms(unet) + norms(dec),
            "all_gather": STEPS * (attn(unet) + 2) + attn(dec) + 1}
    for out in denoise_runs[1][layout]:
        got = json.loads(str(out["collectives"]))
        assert {k: got[k] for k in want} == want, (got, want)


@pytest.mark.parametrize("mutant", ["zero_halo", "local_gn"])
def test_split_denoise_mutants_fail(denoise_runs, mutant):
    for out in denoise_runs[1]["tensor2"]:
        miss = np.abs(out[f"t2i_{mutant}"] - out["t2i_full"]).max()
        assert miss > MUTANT_MISS, (mutant, miss)
