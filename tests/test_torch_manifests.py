"""The port's release manifests (seedx_tpu_torch/utils/manifest.py and
its six JSON files) against the JAX package's, and every manifest at
full geometry through the port's converters into the full-geometry port
module, all on the ``meta`` device (shapes only, no bytes): 48-layer
ViT-bigG, the 40-layer 13B from the llm and the agent layouts (bf16 and
int4), the detokenizer with its UNet deltas, the base and the 8-channel
edit UNet, the VAE.  Each load must be strict: no key of the module
missing, no converted key unused, no shape mismatched.
"""

import os

import pytest
import torch

import test_manifests as jax_manifest_tests
from seedx_tpu.utils import manifest as jmanifest
from seedx_tpu_torch.models.factory import _merge_loaded
from seedx_tpu_torch.utils import manifest as tmanifest
from seedx_tpu_torch.utils import sdxl_weights as tsw
from seedx_tpu_torch.utils import weights as tw
from seedx_tpu_torch.utils.quantize import quantize_llama_params

from torch_weight_fixtures import manifest, small_state


def test_manifest_files_are_byte_identical():
    for name in tmanifest.MANIFEST_NAMES:
        with open(os.path.join(tmanifest._MANIFEST_DIR, name + ".json"),
                  "rb") as f:
            mine = f.read()
        with open(os.path.join(jmanifest._MANIFEST_DIR, name + ".json"),
                  "rb") as f:
            assert mine == f.read(), name
    assert tmanifest.MANIFEST_NAMES == jmanifest.MANIFEST_NAMES
    assert os.path.dirname(tmanifest._MANIFEST_DIR) == os.path.dirname(
        tmanifest.__file__)


@pytest.mark.parametrize("case", [
    "test_manifests_present_and_wellformed",
    "test_manifest_geometry_spotchecks",
    "test_validate_state_dict_clean",
    "test_validate_state_dict_detects_problems",
    "test_validate_optional_and_extra_optional_tolerated"])
def test_jax_manifest_cases_pass_on_the_port(monkeypatch, case):
    """tests/test_manifests.py's manifest cases, run against the port's
    module."""
    for name in ("MANIFEST_NAMES", "load_manifest", "validate_or_raise",
                 "validate_state_dict"):
        monkeypatch.setattr(jax_manifest_tests, name,
                            getattr(tmanifest, name))
    getattr(jax_manifest_tests, case)()


def test_reports_equal_the_jax_package_on_a_broken_artifact():
    sd = {k: tuple(v) for k, v in manifest("sdxl_vae")["keys"].items()}
    sd = {k: torch.empty(s, device="meta") for k, s in sd.items()}
    victim = sorted(sd)[3]
    sd["renamed.key"] = sd.pop(sorted(sd)[0])
    sd[victim] = torch.empty((7,), device="meta")
    mine = tmanifest.validate_state_dict(sd, "sdxl_vae")
    ref = jmanifest.validate_state_dict(sd, "sdxl_vae")
    assert (mine.missing, mine.unexpected, mine.mismatched) == \
        (ref.missing, ref.unexpected, ref.mismatched)
    assert mine.summary() == ref.summary()
    with pytest.raises(ValueError, match="MANIFEST MISMATCH"):
        tmanifest.validate_or_raise(sd, "sdxl_vae")


@pytest.mark.parametrize("name,depth", [("llm", 4), ("agent", 4),
                                        ("qwen_vit", 2)])
def test_depth_cut_validates_against_its_layers(name, depth):
    """``num_layers`` holds the first layers of an artifact to the
    manifest's keys of those layers; deeper keys present are tolerated."""
    m = manifest(name)
    cut = small_state(name, num_layers=depth)
    full = {k: torch.empty(s, device="meta") for k, s in m["keys"].items()}
    sd = {k: full[k] for k in cut}
    assert not tmanifest.validate_state_dict(sd, name).ok
    rep = tmanifest.validate_state_dict(sd, name, num_layers=depth)
    assert rep.ok, rep.summary()
    assert rep.n_checked < len(m["keys"])
    assert tmanifest.validate_state_dict(full, name, num_layers=depth).ok
    sd.pop(sorted(sd)[-1])
    assert tmanifest.validate_state_dict(sd, name,
                                         num_layers=depth).missing


def _meta_sd(name):
    return {k: torch.empty(s, dtype=torch.bfloat16, device="meta")
            for k, s in manifest(name)["keys"].items()}


def _strict(reports):
    """Several loads into one module: no key left unfilled by all of them,
    none unused or mismatched by any."""
    missing = set.intersection(*(set(r.missing) for r in reports))
    unexpected = [k for r in reports for k in r.unexpected]
    mismatched = [m for r in reports for m in r.mismatched]
    assert not missing and not unexpected and not mismatched, (
        sorted(missing)[:5], unexpected[:5], mismatched[:5])


def _meta_agent(quantization):
    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
    from seedx_tpu_torch.models.llama import llama2_13b

    return ContinuousLVLM(AgentConfig(llm=llama2_13b(
        lora_rank=32, quantization=quantization)), torch.device("meta"))


def _quantizer(mode):
    if mode == "none":
        return None
    return lambda piece: quantize_llama_params(piece, mode=mode)


@pytest.mark.parametrize("quantization", ["none", "int4"])
def test_full_geometry_agent_layout_loads_strictly(quantization):
    sd = _meta_sd("agent")
    assert tmanifest.validate_state_dict(sd, "agent").ok
    parts = tw.convert_agent_checkpoint(sd)
    llm_sd = parts.pop("llm_state_dict")
    agent = _meta_agent(quantization)
    _strict([_merge_loaded(agent, parts, "agent"),
             _merge_loaded(agent, tw.convert_llama_hf(llm_sd), "agent-llm",
                           prefix="llm.", quantize=_quantizer(quantization))])


@pytest.mark.parametrize("quantization", ["none", "int4"])
def test_full_geometry_llm_layout_loads_strictly(quantization):
    from seedx_tpu_torch.models.llama import LlamaForCausalLM, llama2_13b

    sd = _meta_sd("llm")
    assert tmanifest.validate_state_dict(sd, "llm").ok
    llm = LlamaForCausalLM(llama2_13b(quantization=quantization),
                           torch.device("meta"))
    _strict([_merge_loaded(llm, tw.convert_llama_hf(sd), "llm",
                           quantize=_quantizer(quantization))])


def test_full_geometry_vit_loads_strictly():
    from seedx_tpu_torch.models.vit import VisionTransformer, qwen_vitg_448

    sd = _meta_sd("qwen_vit")
    assert tmanifest.validate_state_dict(sd, "qwen_vit").ok
    vit = VisionTransformer(qwen_vitg_448(), torch.device("meta"))
    assert vit.cfg.layers == 48
    _strict([_merge_loaded(vit, tw.convert_qwen_vit(sd), "qwen_vit")])


@pytest.mark.parametrize("edit", [False, True])
def test_full_geometry_unet_and_detokenizer_load_strictly(edit):
    from seedx_tpu_torch.models.detokenizer import (DetokenizerConfig,
                                                    ResamplerXL)
    from seedx_tpu_torch.models.sdxl.unet import (UNet2DCondition,
                                                  sdxl_base_unet,
                                                  sdxl_edit_unet)

    sd = _meta_sd("sdxl_unet")
    assert tmanifest.validate_state_dict(sd, "sdxl_unet").ok
    cfg = sdxl_edit_unet() if edit else sdxl_base_unet()
    unet = UNet2DCondition(cfg, torch.device("meta"))
    _strict([_merge_loaded(unet, tsw.convert_sdxl_unet(
        sd, widen_conv_in_to=8 if edit else None), "sdxl_unet")])
    assert unet.state_dict()["conv_in.weight"].shape[1] == (8 if edit else 4)

    detok = _meta_sd("detokenizer")
    unet_keys = manifest("sdxl_unet")["keys"]
    opt = [k for k in manifest("detokenizer")["optional"]
           if k.startswith("unet.")]
    detok.update({k: torch.empty(unet_keys[k[len("unet."):]],
                                 device="meta") for k in opt})
    assert tmanifest.validate_state_dict(detok, "detokenizer",
                                         extra_optional=("unet.*",)).ok
    res = ResamplerXL(DetokenizerConfig(), torch.device("meta"))
    _strict([_merge_loaded(res, tw.convert_detokenizer_resampler(detok),
                           "detokenizer")])
    parted = tsw.convert_sdxl_unet_deltas(
        {k[len("unet."):]: v for k, v in detok.items()
         if k.startswith("unet.")})
    assert not parted["skipped"] and len(parted["deltas"]) == len(opt)
    rep = _merge_loaded(unet, parted["deltas"], "detokenizer-unet")
    assert not rep.unexpected and not rep.mismatched


def test_full_geometry_vae_loads_strictly():
    from seedx_tpu_torch.models.sdxl.vae import (VAEConfig, VAEDecoder,
                                                 VAEEncoder)

    sd = _meta_sd("sdxl_vae")
    assert tmanifest.validate_state_dict(sd, "sdxl_vae").ok
    vae = tsw.convert_sdxl_vae(sd)
    for part, cls in (("encoder", VAEEncoder), ("decoder", VAEDecoder)):
        _strict([_merge_loaded(cls(VAEConfig(), torch.device("meta")),
                               vae[part], part)])
