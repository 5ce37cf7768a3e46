"""The port's factories, runtime constructors, tokenizer, CLI, config graph
and serving artifacts against the JAX package's, on release artifacts
written to ``tmp_path`` at small geometry (tests/torch_weight_fixtures.py).

Weights: every leaf a factory loads equals, bit for bit, the JAX
builder's parameter tree put into the same port module by
``load_jax_params`` (bf16 state widened to fp32; the int4 agent against
JAX ``convert_llama_hf`` + ``quantize_llama_params``).  Outputs: both
sides rebuilt in fp32 from those weights, at the slice tests'
tolerances: ViT features within 1e-5 of their magnitude (``F32_REL``)
and the agent's prefill logits within 2e-5 (tests/test_torch_models.py),
greedy tokens equal or parted only at a tie of ``TIE_ULPS`` fp32 steps of
the teacher-forced logits (tests/test_torch_slice.py).  The int4 agent is held by its stream
only: W4A8 re-quantizes every projection's input to int8, and an fp32
ULP of difference in a norm's output flips a code on a rounding edge, a
jump the layers amplify (1.4% of the logit scale on these weights).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference import eval_cli as jcli
from seedx_tpu.inference.runtime import SeedXRuntime as JaxRuntime
from seedx_tpu.models import agent as jagent
from seedx_tpu.models import factory as jfactory
from seedx_tpu.models import generation as jgen
from seedx_tpu.models.vit import VisionTransformer as JaxViT
from seedx_tpu.text import tokenizer as jtok
from seedx_tpu.utils.quantize import (quantize_llama_params,
                                      quantize_vit_params)
from seedx_tpu_torch.inference import eval_cli as tcli
from seedx_tpu_torch.inference.runtime import SeedXRuntime as TorchRuntime
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models import factory as tfactory
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.models import vit as tvit
from seedx_tpu_torch.text import tokenizer as ttok
from seedx_tpu_torch.utils.convert import from_jax_params, load_jax_params

from test_torch_slice import _teacher_forced_logits, assert_same_tokens
from torch_weight_fixtures import (DETOK_SMALL, LLM_SMALL, UNET_SMALL,
                                   VAE_SMALL, VIT_SMALL,
                                   peft_order, small_state, torch_state,
                                   write_safetensors_dir)

torch.set_num_threads(1)
F32_REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(actual, expected, rel):
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=rel * np.abs(expected).max())


def _numpy(tree):
    from flax import linen as nn
    import jax

    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _f32_copy(module, make):
    """``make()`` (an fp32 twin of ``module``) holding ``module``'s state."""
    twin = make().eval()
    with torch.no_grad():
        twin.load_state_dict(module.state_dict(), strict=True)
    return twin


def _same_state(loaded, ref):
    """Every leaf of ``loaded`` equals ``ref``'s, bit for bit, once both
    are widened to fp32."""
    want = ref.state_dict()
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = want[k]
        assert v.dtype == w.dtype or v.is_floating_point(), k
        assert torch.equal(v.float() if v.is_floating_point() else v,
                           w.float() if w.is_floating_point() else w), k


# ---------------------------------------------------------------------------
# The ViT
# ---------------------------------------------------------------------------

# 16 heads: the JAX builder de-interleaves the packed qkv rows with the
# release's 16 heads whatever its ``heads`` argument says
VIT_KW = dict(image_size=56, layers=2, **VIT_SMALL)


def _vit_file(tmp_path, wrapped=False):
    sd = torch_state(small_state("qwen_vit", seed=20, num_layers=2))
    path = str(tmp_path / "qwen_vit_G.pt")
    torch.save({"state_dict": sd} if wrapped else sd, path)
    return path


@pytest.mark.parametrize("wrapped", [False, True])
def test_build_visual_encoder_matches_jax(tmp_path, wrapped):
    path = _vit_file(tmp_path, wrapped)
    model_j, params_j = jfactory.build_visual_encoder(path, remat=False,
                                                      **VIT_KW)
    vit = tfactory.build_visual_encoder(path, device="cpu", **VIT_KW)
    assert vit.cfg.dtype == torch.bfloat16
    cfg32 = dataclasses.replace(vit.cfg, dtype=torch.float32)
    _same_state(vit, load_jax_params(tvit.VisionTransformer(cfg32),
                                     _numpy(params_j)))
    images = np.random.default_rng(21).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    out_j = JaxViT(dataclasses.replace(model_j.cfg, dtype=jnp.float32),
                   remat=False).apply({"params": params_j},
                                      jnp.asarray(images))
    with torch.no_grad():
        out_t = _f32_copy(vit, lambda: tvit.VisionTransformer(cfg32))(
            torch.from_numpy(images))
    _close(out_t.numpy(), out_j, F32_REL)


def test_quantize_vit_matches_jax(tmp_path):
    from seedx_tpu_torch.models.adapter import AdapterConfig, SDXLAdapter
    from seedx_tpu_torch.models.detokenizer import DetokenizerConfig
    from seedx_tpu_torch.models.llama import llama_debug
    from seedx_tpu_torch.models.sdxl.unet import sdxl_debug_unet

    path = _vit_file(tmp_path)
    _, params_j = jfactory.build_visual_encoder(path, remat=False, **VIT_KW)
    vit = tfactory.build_visual_encoder(path, device="cpu", **VIT_KW)
    agent = tagent.ContinuousLVLM(tagent.AgentConfig(
        llm=llama_debug(num_layers=1), vit_dim=128, resampler_heads=4))
    adapter = SDXLAdapter(AdapterConfig(unet=sdxl_debug_unet(),
                                        resampler=DetokenizerConfig()),
                          None, None, None, visual_encoder=vit)
    rt = TorchRuntime(tokenizer=ttok.load_tokenizer(), vit_cfg=vit.cfg,
                      vit=vit, agent_cfg=agent.cfg, agent=agent,
                      adapter=adapter)
    assert rt.quantize_vit() is rt
    assert rt.vit_cfg.quantization == "int8" and rt.vit is not vit
    assert adapter.visual_encoder is rt.vit       # the shared ViT re-pointed
    want = from_jax_params(quantize_vit_params(_numpy(params_j)))
    got = rt.vit.state_dict()
    q = [k for k in got if k.endswith("kernel_q")]
    assert len(q) == 4
    for k in q + [k.replace("kernel_q", "kernel_scale") for k in q]:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert rt.quantize_vit().vit is rt.vit


# ---------------------------------------------------------------------------
# The agent
# ---------------------------------------------------------------------------

def _agent_files(tmp_path, shrink=None):
    """An HF shard dir (fp32 safetensors, 2 shards, the JAX reader takes
    no bf16 safetensors) and the agent's pytorch_model.bin (bf16, PEFT's
    key order), 2 layers."""
    llm_dir = str(tmp_path / "llm")
    write_safetensors_dir(llm_dir, torch_state(
        small_state("llm", seed=22, num_layers=2, shrink=shrink),
        torch.float32))
    agent_bin = str(tmp_path / "agent.bin")
    torch.save(torch_state(peft_order(small_state(
        "agent", seed=23, num_layers=2, shrink=shrink))), agent_bin)
    return llm_dir, agent_bin


def _jax_agent(llm_dir, agent_bin, quantization="none"):
    llm = jfactory.build_llm_config(lora_rank=4, num_layers=2,
                                    quantization=quantization, **LLM_SMALL)
    return jfactory.build_agent(llm, llm_dir, agent_bin, vit_dim=128)


def _torch_agent(llm_dir, agent_bin, quantization="none"):
    llm = tfactory.build_llm_config(lora_rank=4, num_layers=2,
                                    quantization=quantization, **LLM_SMALL)
    return tfactory.build_agent(llm, llm_dir, agent_bin, vit_dim=128,
                                device="cpu")


def _f32_agent_cfg(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32, llm=dataclasses.
                               replace(cfg.llm, dtype=torch.float32))


def _jax_f32(model):
    cfg = model.cfg
    return jagent.ContinuousLVLM(dataclasses.replace(
        cfg, dtype=jnp.float32,
        llm=dataclasses.replace(cfg.llm, dtype=jnp.float32)))


def _greedy_both(model_j, params_j, agent_t, n=12):
    """Greedy tokens of a text prompt from both agents, the port's held
    to JAX's by the tie rule."""
    tok = ttok.load_tokenizer()
    ids = [tok.bos_token_id] + tok.encode("[INST] Describe a lake. [/INST]")
    out_j = jgen.generate(model_j, {"params": params_j}, jtok.load_tokenizer(),
                          ids, gen_cfg=jgen.GenerationConfig(
                              max_new_tokens=n, eos_token_id=-1))
    out_t = tgen.generate(agent_t, tok, ids, gen_cfg=tgen.GenerationConfig(
        max_new_tokens=n, eos_token_id=-1))
    assert len(out_t["tokens"]) == n
    with torch.no_grad():
        pe = agent_t.embed_ids(torch.as_tensor(ids)[None])
    assert_same_tokens(out_t["tokens"], out_j["tokens"],
                       _teacher_forced_logits(
                           agent_t, pe, torch.ones((1, len(ids)), dtype=bool),
                           out_j["tokens"], ids[-1], 64))
    return out_t["tokens"]


def test_build_agent_matches_jax(tmp_path):
    llm_dir, agent_bin = _agent_files(tmp_path)
    model_j, params_j = _jax_agent(llm_dir, agent_bin)
    agent = _torch_agent(llm_dir, agent_bin)
    assert agent.cfg.llm.dtype == torch.bfloat16
    make = functools.partial(tagent.ContinuousLVLM,
                             _f32_agent_cfg(agent.cfg))
    params_j = _numpy(params_j)
    _same_state(agent, load_jax_params(make(), params_j))
    agent32, model_j = _f32_copy(agent, make), _jax_f32(model_j)
    _greedy_both(model_j, params_j, agent32)
    # prefill logits, fp32 both sides: 2e-5 of their magnitude, the
    # slice tests' bound for the unquantized LLaMA with LoRA
    # (tests/test_torch_models.py)
    from seedx_tpu.models import llama as jllama
    from seedx_tpu_torch.models import llama as tllama

    llm_j = jllama.LlamaForCausalLM(model_j.cfg.llm)
    vars_j = {"params": params_j["llm"]}
    ids = np.arange(3, 40)[None]
    pos = np.arange(ids.shape[1])[None]
    valid = np.ones(ids.shape, bool)
    logits_j, _, _ = llm_j.apply(
        vars_j, llm_j.apply(vars_j, jnp.asarray(ids), method="embed"),
        jnp.asarray(pos), jnp.asarray(valid),
        jllama.init_kv_cache(model_j.cfg.llm, 1, ids.shape[1]), 0)
    with torch.no_grad():
        llm_t = agent32.llm
        logits_t, _, _ = llm_t(
            llm_t.embed(torch.from_numpy(ids)), torch.from_numpy(pos),
            torch.from_numpy(valid),
            tllama.init_kv_cache(llm_t.cfg, 1, ids.shape[1]), 0)
    _close(logits_t.numpy(), logits_j, 2e-5)


def test_int4_load_is_convert_then_quantize(tmp_path, monkeypatch):
    """The int4 agent's bytes equal JAX convert_llama_hf +
    quantize_llama_params of the same files, and its greedy stream the
    JAX int4 model's on those bytes (the JAX int4 build itself leaves
    every quantized leaf 0: next test)."""
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    llm_dir, agent_bin = _agent_files(tmp_path)
    model_j, params_j = _jax_agent(llm_dir, agent_bin)
    params_j = _numpy(params_j)
    params_j["llm"] = quantize_llama_params(params_j["llm"], mode="int4")
    agent = _torch_agent(llm_dir, agent_bin, quantization="int4")
    make = functools.partial(tagent.ContinuousLVLM,
                             _f32_agent_cfg(agent.cfg))
    _same_state(agent, load_jax_params(make(), params_j))
    codes = agent.state_dict()["llm.layers.q_proj.kernel_q4"]
    assert codes.dtype == torch.uint8 and codes.any()
    model_j = _jax_f32(model_j)
    model_j = jagent.ContinuousLVLM(dataclasses.replace(
        model_j.cfg, llm=dataclasses.replace(model_j.cfg.llm,
                                             quantization="int4")))
    agent32 = _f32_copy(agent, make)
    _greedy_both(model_j, params_j, agent32)


def test_jax_int4_build_zero_fills_where_the_port_quantizes(tmp_path):
    """The JAX package's fault, kept for the record (ROADMAP Queue 3):
    ``build_agent`` with an int4 LLM config merges the converter's
    ``kernel`` leaves into an init tree of ``kernel_q4`` / ``kernel_scale``
    leaves; the names do not match, so every quantized leaf stays 0."""
    llm_dir, agent_bin = _agent_files(tmp_path)
    _, params_j = _jax_agent(llm_dir, agent_bin, quantization="int4")
    llm = _numpy(params_j)["llm"]
    zero = [llm["embed_tokens"]["embedding_q"], llm["lm_head"]["kernel_q"],
            llm["model"]["layers"]["layer"]["q_proj"]["kernel_q4"],
            llm["model"]["layers"]["layer"]["q_proj"]["kernel_scale"]]
    assert all(not np.any(z) for z in zero)
    agent = _torch_agent(llm_dir, agent_bin, quantization="int4")
    state = agent.state_dict()
    for k in ("llm.embed_tokens.embedding_q", "llm.lm_head.kernel_q",
              "llm.layers.q_proj.kernel_q4", "llm.layers.q_proj.kernel_scale"):
        assert state[k].any(), k


# ---------------------------------------------------------------------------
# The SDXL adapter
# ---------------------------------------------------------------------------

def _small_sdxl(monkeypatch):
    """The port's SDXL configs at the small geometry inside the factory."""
    from seedx_tpu_torch.models.sdxl import unet as tunet
    from seedx_tpu_torch.models.sdxl import vae as tvae

    cfg = tunet.UNetConfig(**UNET_SMALL)
    monkeypatch.setattr(tunet, "sdxl_base_unet", lambda: cfg)
    monkeypatch.setattr(tunet, "sdxl_edit_unet",
                        lambda: dataclasses.replace(cfg, in_channels=8))
    monkeypatch.setattr(tvae, "VAEConfig",
                        functools.partial(tvae.VAEConfig, **VAE_SMALL))


@pytest.mark.parametrize("variant", ["base_deltas", "edit_full",
                                     "edit_widen"])
def test_build_sdxl_adapter_matches_jax(tmp_path, monkeypatch, variant):
    """First stage with to_k / to_v deltas over the base UNet; the edit
    variant with a full fine-tuned 8-channel UNet in its detokenizer
    checkpoint; the edit variant widening the base UNet's conv_in."""
    from seedx_tpu_torch.models.detokenizer import (DetokenizerConfig,
                                                    ResamplerXL)
    from seedx_tpu_torch.models.sdxl.unet import UNet2DCondition, UNetConfig
    from seedx_tpu_torch.models.sdxl.vae import (VAEConfig, VAEDecoder,
                                                 VAEEncoder)
    from safetensors.torch import save_file

    edit = variant != "base_deltas"
    unet_dir, vae_dir = tmp_path / "unet", tmp_path / "vae"
    unet_dir.mkdir()
    vae_dir.mkdir()
    save_file(torch_state(small_state("sdxl_unet", seed=24), torch.float32),
              str(unet_dir / "diffusion_pytorch_model.safetensors"))
    save_file(torch_state(small_state("sdxl_vae", seed=25), torch.float32),
              str(vae_dir / "diffusion_pytorch_model.safetensors"))
    detok = small_state("detokenizer", seed=26,
                        deltas=variant == "base_deltas")
    if variant == "edit_full":
        full = small_state("sdxl_unet", seed=27)
        full["conv_in.weight"] = np.concatenate(
            [full["conv_in.weight"], full["conv_in.weight"]], axis=1)
        detok.update({f"unet.{k}": v for k, v in full.items()})
    detok_bin = str(tmp_path / "detok.bin")
    torch.save(torch_state(detok), detok_bin)

    paths = dict(detokenizer_path=detok_bin, sdxl_unet_path=str(unet_dir),
                 sdxl_vae_path=str(vae_dir), with_latent_image=edit)
    ad_j = jfactory.build_sdxl_adapter(resampler=dict(DETOK_SMALL), **paths)
    _small_sdxl(monkeypatch)
    rcfg = DetokenizerConfig(**DETOK_SMALL)
    ad_t = tfactory.build_sdxl_adapter(resampler=rcfg, device="cpu",
                                       **paths)
    assert ad_t.cfg.with_latent_image == edit
    assert ad_t.unet.conv_in.weight.shape[1] == (8 if edit else 4)
    ucfg = UNetConfig(in_channels=8 if edit else 4, dtype=torch.float32,
                      **UNET_SMALL)
    _same_state(ad_t.unet, load_jax_params(UNet2DCondition(ucfg),
                                           _numpy(ad_j.unet_params)))
    _same_state(ad_t.resampler, load_jax_params(
        ResamplerXL(dataclasses.replace(rcfg, dtype=torch.float32)),
        _numpy(ad_j.resampler_params)))
    vcfg = VAEConfig(**VAE_SMALL)
    _same_state(ad_t.vae_decoder, load_jax_params(
        VAEDecoder(vcfg), _numpy(ad_j.vae_decoder_params)))
    _same_state(ad_t.vae_encoder, load_jax_params(
        VAEEncoder(vcfg), _numpy(ad_j.vae_encoder_params)))
    assert ad_t.unet.conv_in.weight.dtype == torch.bfloat16
    assert ad_t.vae_decoder.conv_in.weight.dtype == torch.float32


# ---------------------------------------------------------------------------
# from_pretrained, the CLI, the tokenizer
# ---------------------------------------------------------------------------

def test_from_pretrained_reports_missing_artifacts_as_jax(tmp_path):
    for model in ("seed_x_i", "seed_x_edit"):
        with pytest.raises(FileNotFoundError) as mine:
            TorchRuntime.from_pretrained(root=str(tmp_path), model=model,
                                         device="cpu")
        with pytest.raises(FileNotFoundError) as ref:
            JaxRuntime.from_pretrained(root=str(tmp_path), model=model)
        assert str(mine.value) == str(ref.value)
        msg = str(mine.value)
        assert "QwenViT/qwen_vit_G.pt" in msg
        assert os.path.join(model, "llm") in msg
        assert "stable-diffusion-xl-base-1.0" in msg
        assert ("second_stage" in msg) == (model == "seed_x_edit")
    with pytest.raises(ValueError, match="model must be one of"):
        TorchRuntime.from_pretrained(root=str(tmp_path), model="nope")
    assert TorchRuntime.RELEASE_MODELS == JaxRuntime.RELEASE_MODELS


def _release_tree(root, shrink, vit=None):
    """The from_pretrained layout, without the adapter's artifacts."""
    os.makedirs(os.path.join(root, "QwenViT"))
    torch.save(vit or {"unused": torch.zeros(1)},
               os.path.join(root, "QwenViT", "qwen_vit_G.pt"))
    model = os.path.join(root, "seed_x_i")
    os.makedirs(os.path.join(model, "agent"))
    llm_dir, agent_bin = _agent_files_at(model, shrink)
    return llm_dir, agent_bin


def _agent_files_at(model_dir, shrink):
    llm_dir = os.path.join(model_dir, "llm")
    write_safetensors_dir(llm_dir, torch_state(
        small_state("llm", seed=28, num_layers=2, shrink=shrink),
        torch.float32))
    agent_bin = os.path.join(model_dir, "agent", "pytorch_model.bin")
    torch.save(torch_state(peft_order(small_state(
        "agent", seed=29, num_layers=2, shrink=shrink))), agent_bin)
    return llm_dir, agent_bin


def test_from_pretrained_debug_matches_jax(tmp_path, monkeypatch):
    """SEEDX_DEBUG=1: both packages build the debug geometry (the ViT
    random, the 2-layer LLaMA with LoRA r32 and the agent from the
    files); their greedy streams agree."""
    debug = {5120: 256, 13824: 512, 15360: 768, 4096: 128, 12288: 384}
    _release_tree(str(tmp_path), debug)
    monkeypatch.setenv("SEEDX_DEBUG", "1")
    rt_j = JaxRuntime.from_pretrained(str(tmp_path), with_adapter=False,
                                      validate=False)
    rt_t = TorchRuntime.from_pretrained(str(tmp_path), with_adapter=False,
                                        validate=False, device="cpu")
    assert rt_t.adapter is None and rt_t.vit_cfg.width == 128
    assert rt_t.agent_cfg.llm.lora_rank == 32
    make = functools.partial(tagent.ContinuousLVLM,
                             _f32_agent_cfg(rt_t.agent_cfg))
    params_j = _numpy(rt_j.agent_params)
    _same_state(rt_t.agent, load_jax_params(make(), params_j))
    _greedy_both(_jax_f32(rt_j.agent), params_j, _f32_copy(rt_t.agent, make))


def _small_factories(monkeypatch):
    """Both packages' factories at the small geometry and in fp32 (for
    the runtimes ``from_pretrained`` builds), without the adapter."""
    small = dict(VIT_KW, image_size=448, validate=False)
    orig = {"jv": jfactory.build_visual_encoder, "ja": jfactory.build_agent,
            "jl": jfactory.build_llm_config, "tv": tfactory.build_visual_encoder,
            "ta": tfactory.build_agent, "tl": tfactory.build_llm_config}

    def jvit(**kw):
        model, params = orig["jv"](**{**kw, **small, "remat": False})
        return JaxViT(dataclasses.replace(model.cfg, dtype=jnp.float32),
                      remat=False), params

    def jagent_(llm, **kw):
        model, params = orig["ja"](llm, **{**kw, "vit_dim": 128,
                                           "validate": False})
        return _jax_f32(model), params

    def tvit_(**kw):
        vit = orig["tv"](**{**kw, **small})
        cfg = dataclasses.replace(vit.cfg, dtype=torch.float32)
        return _f32_copy(vit, lambda: tvit.VisionTransformer(cfg))

    def tagent_(llm, **kw):
        agent = orig["ta"](llm, **{**kw, "vit_dim": 128, "validate": False})
        cfg = _f32_agent_cfg(agent.cfg)
        return _f32_copy(agent, lambda: tagent.ContinuousLVLM(cfg))

    llm_kw = dict(LLM_SMALL, num_layers=2, lora_rank=4)
    monkeypatch.setattr(jfactory, "build_visual_encoder", jvit)
    monkeypatch.setattr(jfactory, "build_agent", jagent_)
    monkeypatch.setattr(jfactory, "build_llm_config",
                        lambda **kw: orig["jl"](**{**kw, **llm_kw}))
    monkeypatch.setattr(tfactory, "build_visual_encoder", tvit_)
    monkeypatch.setattr(tfactory, "build_agent", tagent_)
    monkeypatch.setattr(tfactory, "build_llm_config",
                        lambda **kw: orig["tl"](**{**kw, **llm_kw}))
    for f in (jfactory, tfactory):
        monkeypatch.setattr(f, "build_sdxl_adapter", lambda **kw: None)


def test_eval_cli_img2text_ckpt_root_matches_jax(tmp_path, monkeypatch,
                                                 capsys):
    root = str(tmp_path / "pretrained")
    vit = torch_state(small_state("qwen_vit", seed=30, num_layers=2))
    _release_tree(root, None, vit=vit)
    for sub in ("seed_detokenizer/first_stage/pytorch_model.bin",
                "stable-diffusion-xl-base-1.0/unet",
                "stable-diffusion-xl-base-1.0/vae"):
        os.makedirs(os.path.join(root, sub))    # present; not loaded here
    _small_factories(monkeypatch)
    monkeypatch.delenv("SEEDX_DEBUG", raising=False)
    img = str(tmp_path / "img.png")
    Image.fromarray((np.random.default_rng(31).random((90, 120, 3)) * 255
                     ).astype(np.uint8)).save(img)
    from seedx_tpu.inference import apps as japps
    from seedx_tpu_torch.inference import apps as tapps

    tokens = {}
    for name, apps in (("jax", japps), ("port", tapps)):
        def recorded(*a, _f=apps.comprehend, _n=name, **kw):
            out = _f(*a, **kw)
            tokens[_n] = [int(t) for t in out["tokens"]]
            return out
        monkeypatch.setattr(apps, "comprehend", recorded)
    argv = ["img2text", "--ckpt_root", root, "--image", img,
            "--question", "What is it?", "--max_new_tokens", "8"]
    assert jcli.main(argv) in (0, None)
    ref = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref
    assert len(tokens["port"]) == 8 and tokens["port"] == tokens["jax"]


def test_eval_cli_names_ckpt_root():
    import argparse

    with pytest.raises(SystemExit, match="--ckpt_root"):
        tcli._load_runtime(argparse.Namespace(debug=False, ckpt_root=None,
                                              device="cpu"))
    assert "--ckpt_root" in subprocess.run(
        [sys.executable, "-m", "seedx_tpu_torch.inference.eval_cli", "-h"],
        capture_output=True, text=True, cwd=REPO).stdout


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """tests/test_hf_tokenizer.py's fixture: a fast WordLevel tokenizer
    over the 32000 base ids, the multimodal specials registered in
    reverse order."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB

    path = tmp_path_factory.mktemp("hf_tok")
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2,
             "hello": 3, "world": 4, "a": 5, "red": 6, "car": 7}
    vocab.update({f"w{i}": i for i in range(8, 32000)})
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>", pad_token="<unk>")
    fast.add_tokens(list(reversed(DEFAULT_VOCAB.special_token_strings())),
                    special_tokens=True)
    fast.save_pretrained(str(path))
    return str(path)


def test_hf_tokenizer_matches_jax(hf_dir):
    mine, ref = ttok.load_tokenizer(hf_dir), jtok.load_tokenizer(hf_dir)
    assert isinstance(mine, ttok.HFTokenizer)
    assert (mine.bos_token_id, mine.eos_token_id, mine.pad_token_id,
            mine.vocab_size) == (ref.bos_token_id, ref.eos_token_id,
                                 ref.pad_token_id, ref.vocab_size)
    for text in ("hello world", "a red car <img><img_00000></img> w42",
                 "<patch><img_00063></patch> <loc-0><loc-223> unknownword",
                 "<box_start>hello<box_end>", ""):
        for bos in (False, True):
            ids = mine.encode(text, add_bos=bos)
            assert ids == ref.encode(text, add_bos=bos)
            for skip in (False, True):
                assert mine.decode(ids, skip) == ref.decode(ids, skip)
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteFallbackTokenizer)


def test_tokenizer_dir_without_transformers_raises(hf_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        ttok.load_tokenizer(hf_dir)


# ---------------------------------------------------------------------------
# Serving artifacts
# ---------------------------------------------------------------------------

def test_export_serving_roundtrip_is_bit_exact(tmp_path):
    """export_serving of a loaded bf16 LLM equals the JAX quantizer's
    bytes, and restore_pytree into the int4 model gives them back; the
    vit and unet families round-trip too."""
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.models.llama import LlamaForCausalLM
    from seedx_tpu_torch.models.sdxl.unet import (UNet2DCondition,
                                                  sdxl_debug_unet)
    from seedx_tpu_torch.train.checkpoints import restore_pytree
    from seedx_tpu_torch.utils.export import export_serving

    llm_dir, agent_bin = _agent_files(tmp_path)
    agent = _torch_agent(llm_dir, agent_bin)
    state = {k[len("llm."):]: v for k, v in agent.state_dict().items()
             if k.startswith("llm.")}
    path = str(tmp_path / "llm_int4.pt")
    q = export_serving(state, path, "llama", mode="int4")
    _, params_j = _jax_agent(llm_dir, agent_bin)
    want = from_jax_params(quantize_llama_params(
        _numpy(params_j)["llm"], mode="int4"))
    for k in ("layers.q_proj.kernel_q4", "layers.q_proj.kernel_scale",
              "embed_tokens.embedding_q", "lm_head.kernel_q"):
        np.testing.assert_array_equal(q[k].numpy(), want[k], err_msg=k)
    cfg = dataclasses.replace(agent.cfg.llm, quantization="int4")
    fresh = restore_pytree(path, LlamaForCausalLM(cfg))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, q[k]), k
    assert sorted(restore_pytree(path)) == sorted(q)

    vit = tfactory.build_visual_encoder(_vit_file(tmp_path), device="cpu",
                                        **VIT_KW)
    qv = export_serving(vit.state_dict(), str(tmp_path / "vit.pt"), "vit")
    back = restore_pytree(str(tmp_path / "vit.pt"), tvit.VisionTransformer(
        dataclasses.replace(vit.cfg, quantization="int8")))
    for k, v in back.state_dict().items():
        assert torch.equal(v, qv[k]), k

    ucfg = sdxl_debug_unet(dtype=torch.float32)
    unet = init_normal_(UNet2DCondition(ucfg), torch.Generator().manual_seed(0))
    qu = export_serving(unet.state_dict(), str(tmp_path / "unet.pt"), "unet")
    back = restore_pytree(str(tmp_path / "unet.pt"), UNet2DCondition(
        dataclasses.replace(ucfg, quantize="int8")))
    for k, v in back.state_dict().items():
        assert torch.equal(v, qu[k]), k
    assert qu["down_1_attn_0.proj_in.kernel_q"].dtype == torch.int8
    with pytest.raises(ValueError, match="unknown family"):
        export_serving({}, str(tmp_path / "x.pt"), "nope")


def test_export_merged_folds_lora(tmp_path):
    from seedx_tpu_torch.train.checkpoints import restore_pytree
    from seedx_tpu_torch.utils.export import export_merged, merge_lora

    g = torch.Generator().manual_seed(0)
    frozen = {"layers.q_proj.kernel": torch.randn(2, 8, 6, generator=g),
              "norm.scale": torch.ones(8)}
    train = {"layers.q_proj.lora_a": torch.randn(2, 8, 4, generator=g),
             "layers.q_proj.lora_b": torch.randn(2, 4, 6, generator=g)}
    path = str(tmp_path / "merged.pt")
    merged = export_merged(train, frozen, path, lora_alpha=16.0)
    want = merge_lora({**frozen, **train}, alpha=16.0)
    back = restore_pytree(path)
    assert sorted(back) == sorted(want) == ["layers.q_proj.kernel",
                                            "norm.scale"]
    for k in want:
        assert torch.equal(back[k], want[k]) and torch.equal(merged[k],
                                                             want[k])


# ---------------------------------------------------------------------------
# The config graph, and no JAX in the port
# ---------------------------------------------------------------------------

_CONFIGS = """
import pathlib, sys
from seedx_tpu_torch.config import instantiate, load_config, resolve_target
root = pathlib.Path({repo!r}) / "configs"
done = []
for sub in ("visual_encoder", "tokenizer", "sdxl_adapter", "processer",
            "clm_models"):
    for f in sorted((root / sub).glob("*.yaml")):
        cfg = load_config(str(f))
        kw = {{"device": "cpu"}} if cfg["_target_"].rsplit(".", 1)[-1] in (
            "build_visual_encoder", "build_agent", "build_sdxl_adapter") else {{}}
        obj = instantiate(cfg, **kw)
        assert obj is not None, f
        done.append(f"{{f.parent.name}}/{{f.name}}:{{type(obj).__name__}}")
assert resolve_target("seedx_tpu.models.factory.build_agent").__module__ \\
    == "seedx_tpu_torch.models.factory"
assert resolve_target("seedx_tpu.data.datasets.build_multi_datapipes"
                      ).__module__ == "seedx_tpu_torch.data.datasets"
assert resolve_target("seedx_tpu.parallel.mesh.create_mesh").__module__ \
    == "seedx_tpu_torch.parallel.mesh"
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "jaxlib", "flax", "seedx_tpu.")) or m == "seedx_tpu")
assert not bad, bad[:5]
print("\\n".join(done))
"""


def _run(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO, **env})


def test_repo_configs_instantiate_through_the_port():
    """Every YAML of configs/ that targets a factory, a transform or the
    tokenizer, through the port's config graph (SEEDX_DEBUG: the tiny
    models), in a process that then holds no module of JAX or of the JAX
    package."""
    out = _run(_CONFIGS.format(repo=REPO), SEEDX_DEBUG="1")
    assert out.returncode == 0, out.stderr[-3000:]
    done = out.stdout.split()
    assert len(done) == 12, done
    assert "clm_models/agent_seed_x_i.yaml:ContinuousLVLM" in done
    assert "clm_models/llm_seed_x_lora.yaml:LlamaConfig" in done
    assert "visual_encoder/qwen_vitg_448.yaml:VisionTransformer" in done


_NO_JAX = """
import importlib, pkgutil, sys
import seedx_tpu_torch
names = [m.name for m in pkgutil.walk_packages(seedx_tpu_torch.__path__,
                                               "seedx_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "jaxlib", "flax", "seedx_tpu.")) or m == "seedx_tpu")
assert not bad, bad[:5]
print(len(names))
"""


def test_port_imports_no_jax():
    """No module of seedx_tpu_torch/, nor chip_smoke.py, imports JAX or
    the JAX package: read from their syntax (imports, and string
    arguments of importlib.import_module / __import__), then by
    importing every one in a fresh process."""
    import ast

    files = [os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(REPO, "seedx_tpu_torch")) for f in fs
        if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]

    def banned(name):
        top = name.split(".")[0]
        return top in ("jax", "jaxlib", "flax", "seedx_tpu")

    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                fn = node.func
                called = (fn.attr if isinstance(fn, ast.Attribute)
                          else getattr(fn, "id", ""))
                if called in ("import_module", "__import__"):
                    names = [node.args[0].value]
            found += [(path, n) for n in names if banned(n)]
    assert not found, found
    out = _run(_NO_JAX)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 40
