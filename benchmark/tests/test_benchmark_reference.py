"""Each plain reference agrees with the port's plain paths at debug
widths: the port's modules built in fp32 and given the same values the
harness draws (rounded to the type the program serves them in), against
the references, which draw and quantize by themselves."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import programs
from benchmark.harness.weights import draw, fill_, float_leaves
from benchmark.reference import agent as ref_agent
from benchmark.reference import sdxl as ref_sdxl
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 99


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@torch.no_grad()
def as_fp32(module_bf16, build_fp32):
    """An fp32 copy of a module holding the bf16 module's values."""
    m = build_fp32().eval()
    src = module_bf16.state_dict()
    for name, t in m.state_dict().items():
        t.copy_(src[name].to(t.dtype))
    return m


@pytest.fixture(scope="module")
def agent_cfg():
    return tiny.agent_files()["config"]


@pytest.fixture(scope="module")
def sdxl_cfg():
    return tiny.sdxl_files()["config"]


def test_vit(agent_cfg):
    from seedx_tpu_torch.models.vit import VisionTransformer

    vcfg = programs.vit_config(agent_cfg)
    vit = programs.build_vit(agent_cfg, SEED, CPU)
    vit32 = as_fp32(vit, lambda: VisionTransformer(
        dataclasses.replace(vcfg, dtype=torch.float32), CPU))
    x = torch.randn(3, 56, 56, 3)
    with torch.no_grad():
        got = vit32(x)
    assert rel(got, ref_agent.vit(SEED, agent_cfg, x)) < 1e-5


def test_anyres_tiles_match_the_port(agent_cfg):
    from PIL import Image

    from benchmark.harness import traffic
    from seedx_tpu_torch.data.anyres import (grid_pinpoints_from_strings,
                                             process_anyres_image)
    from seedx_tpu_torch.data.transforms import get_transform

    base = 448
    pins = grid_pinpoints_from_strings(agent_cfg["vision"]["grids"], base)
    for grid in agent_cfg["vision"]["grids"]:
        w, h = traffic.grid_size(grid, base)
        img = traffic.make_image(SEED, grid, w, h)
        tiles, pos = process_anyres_image(
            Image.fromarray(img), get_transform("clip", keep_ratio=False,
                                                image_size=base), pins, base)
        rt, rpos = ref_agent.tiles(img, grid, base)
        np.testing.assert_allclose(rt, tiles, atol=1e-6)
        np.testing.assert_allclose(rpos, pos, atol=1e-7)


@torch.no_grad()
def test_agent_logits_with_an_image(agent_cfg):
    """The port's LLM in fp32, given the reference's quantized values,
    over a prompt with an image spliced in."""
    from seedx_tpu_torch.models.agent import (ContinuousLVLM,
                                              positions_from_mask)
    from seedx_tpu_torch.text import prompts
    from seedx_tpu_torch.utils.quantize import (quantize_embedding,
                                                quantize_kernel,
                                                quantize_kernel_int4)

    acfg = programs.agent_config(agent_cfg, "none", "none")
    acfg = dataclasses.replace(acfg, dtype=torch.float32, llm=dataclasses.
                               replace(acfg.llm, dtype=torch.float32))
    port = ContinuousLVLM(acfg, CPU).eval()
    for name, t in float_leaves(port):
        raw = draw(SEED, "agent." + name, t.shape, torch.bfloat16, CPU)
        if name.startswith("llm.layers.") and name.endswith("_proj.kernel"):
            q, s = zip(*(quantize_kernel_int4(raw[i]) for i in
                         range(raw.shape[0])))
            q, s = torch.stack(q), torch.stack(s)
            lo = (q.to(torch.int16) << 12 >> 12).float()
            hi = (q.to(torch.int16) << 8 >> 12).float()
            codes = torch.stack([lo, hi], dim=-2).reshape(raw.shape)
            g = codes.reshape(raw.shape[0], -1, 128, raw.shape[-1])
            t.copy_((g * s[:, :, None]).reshape(raw.shape))
        elif name == "llm.embed_tokens.embedding":
            q, s = quantize_embedding(raw)
            t.copy_(q.float() * s[:, None])
        elif name == "llm.lm_head.kernel":
            q, s = quantize_kernel(raw)
            t.copy_(q.float() * s[None])
        else:
            t.copy_(raw.float())
    grid = "2x1"
    img = np.random.default_rng(0).integers(0, 256, (56, 112, 3),
                                            dtype=np.uint8)
    arr, pos = ref_agent.tiles(img, grid, 56)
    feats = ref_agent.vit(SEED, agent_cfg, torch.from_numpy(arr))
    tok = programs.wide_tokenizer()
    ids = [1] + tok.encode("[INST] " + prompts.multi_patch_image_string(
        len(arr), 4)) + list(range(100, 130)) + tok.encode(" [/INST]\n")
    cmp = torch.from_numpy(prompts.cmp_mask_from_ids(ids))
    ids_t = torch.tensor([ids])
    emb = port.embed_with_images(ids_t, feats, cmp[None],
                                 torch.ones(len(arr), dtype=torch.bool),
                                 torch.from_numpy(pos))
    mask = torch.ones_like(ids_t, dtype=torch.bool)
    got, _ = port.llm.forward_train(emb, positions_from_mask(mask), mask)
    a = ref_agent.Agent(SEED, agent_cfg, CPU)
    img_tok = a.image_tokens(feats, torch.from_numpy(pos))
    want, = a.logits([{"ids": ids_t[0], "image_tokens": img_tok.reshape(
        -1, img_tok.shape[-1]), "cmp": torch.from_numpy(
            ref_agent.splice_mask(ids, agent_cfg["markers"])),
        "rows": torch.arange(len(ids))}])
    assert torch.equal(torch.from_numpy(ref_agent.splice_mask(
        ids, agent_cfg["markers"])), cmp)
    assert rel(got[0], want) < 1e-4


def test_int4_rule_matches_the_port():
    from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

    w = draw(SEED, "x.kernel", (256, 64), torch.bfloat16, CPU)
    q, s = quantize_kernel_int4(w)
    lo = (q.to(torch.int16) << 12 >> 12).float()
    hi = (q.to(torch.int16) << 8 >> 12).float()
    codes = torch.stack([lo, hi], dim=-2).reshape(256, 64)
    port = (codes.reshape(2, 128, 64) * s[:, None]).reshape(256, 64)
    assert torch.equal(port, ref_agent.int4_groups(w))


@torch.no_grad()
def test_resampler_xl_unet_vae(sdxl_cfg):
    from seedx_tpu_torch.models.detokenizer import ResamplerXL
    from seedx_tpu_torch.models.sdxl.unet import UNet2DCondition
    from seedx_tpu_torch.models.sdxl.vae import VAEDecoder

    acfg = programs.adapter_config(sdxl_cfg)
    ad = programs.build_adapter(sdxl_cfg, SEED, CPU)
    res32 = as_fp32(ad.resampler, lambda: ResamplerXL(dataclasses.replace(
        acfg.resampler, dtype=torch.float32), CPU))
    x = torch.randn(2, 4, 128)
    p, pooled = res32(x)
    rp, rpooled = ref_sdxl.resampler_xl(SEED, sdxl_cfg, x)
    assert rel(p, rp) < 1e-5 and rel(pooled, rpooled) < 1e-5

    unet32 = as_fp32(ad.unet, lambda: UNet2DCondition(dataclasses.replace(
        acfg.unet, dtype=torch.float32), CPU))
    lat = torch.randn(2, 8, 8, 4)
    t = torch.tensor(501.0)
    ctx, pool = torch.randn(2, 4, 64), torch.randn(2, 32)
    tid = torch.tensor([64., 64, 0, 0, 64, 64]).expand(2, 6)
    got = unet32(lat, t, ctx, pool, tid)
    want = ref_sdxl.UNet(SEED, sdxl_cfg, CPU)(lat, t, ctx, pool, tid)
    assert rel(got, want) < 1e-5

    vae = VAEDecoder(programs.vae_config(sdxl_cfg), CPU).eval()
    fill_(vae, SEED, "vae_decoder.")
    z = torch.randn(1, 8, 8, 4)
    from seedx_tpu_torch.models.sdxl.pipeline import decode_latents
    assert rel(decode_latents(vae, z, 0.13025),
               ref_sdxl.vae_decode(SEED, sdxl_cfg, z)) < 1e-5


def test_euler_schedule_matches_the_port():
    from seedx_tpu_torch.models.sdxl.scheduler import make_schedule

    for n in (4, 30, 50):
        port = make_schedule(n)
        ts, sig, init = ref_sdxl.euler_schedule(n)
        np.testing.assert_array_equal(ts, port.timesteps)
        np.testing.assert_array_equal(sig, port.sigmas)
        assert init == port.init_noise_sigma
