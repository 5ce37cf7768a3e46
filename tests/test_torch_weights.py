"""The port's checkpoint readers and converters against the JAX package's
(seedx_tpu/utils/weights.py, sdxl_weights.py) on the same synthetic
release state dicts (tests/torch_weight_fixtures.py: the manifests' keys
at small widths, bf16-exact values from a seed).

Converters are held bit for bit: the port's output (torch tensors in the
file dtype, stacked leaves as ``LayerStack``) widened to fp32 must equal
the JAX converter's numpy tree after ``utils/convert.from_jax_params``;
the SDXL trees, whose conv layouts differ, are compared as the fp32
modules each fills (``load_jax_params`` against the factories'
``_merge_loaded``).  Readers: the port's own safetensors reader against
the ``safetensors`` package, and ``load_checkpoint_auto`` against the
JAX package's on every directory layout it probes.
"""

import json
import os

import numpy as np
import pytest
import torch

from seedx_tpu.utils import sdxl_weights as jsw
from seedx_tpu.utils import weights as jw
from seedx_tpu_torch.models.factory import _merge_loaded
from seedx_tpu_torch.utils import sdxl_weights as tsw
from seedx_tpu_torch.utils import weights as tw
from seedx_tpu_torch.utils.convert import from_jax_params, load_jax_params

from torch_weight_fixtures import (UNET_SMALL, VAE_SMALL, peft_order,
                                   small_state, torch_state)

torch.set_num_threads(1)


def assert_same(port, jax_tree):
    """Port converter output == JAX tree through from_jax_params, bit for
    bit, same key set."""
    want = from_jax_params(jax_tree)
    got = {k: (v.tensor() if isinstance(v, tw.LayerStack) else v
               ).float().numpy() for k, v in port.items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def assert_same_module(make, port, jax_tree):
    """The module ``make()`` filled by the factories' loader == the one
    filled from the JAX tree by ``load_jax_params``, bit for bit, with no
    key missing or unused."""
    mine = make()
    rep = _merge_loaded(mine, port, "port")
    assert rep.ok, rep.summary()
    ref = load_jax_params(make(), jax_tree)
    want = ref.state_dict()
    for k, v in mine.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# ViT, LLaMA, agent, detokenizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patch_pos", [False, True])
def test_convert_qwen_vit_matches_jax(patch_pos):
    sd = small_state("qwen_vit", seed=1, num_layers=2)
    if patch_pos:
        sd["patch_pos_embed"] = np.full((4, 128), 0.25, np.float32)
    assert_same(tw.convert_qwen_vit(torch_state(sd), num_layers=2,
                                    num_heads=4),
                jw.convert_qwen_vit(sd, num_layers=2, num_heads=4))


def test_deinterleave_qkv_matches_jax():
    w = np.arange(24 * 5, dtype=np.float32).reshape(24, 5)
    for heads in (1, 2, 4):
        np.testing.assert_array_equal(
            tw._deinterleave_qkv(torch.from_numpy(w), heads).numpy(),
            jw._deinterleave_qkv(w, heads))


def test_extract_qwen_vit_from_qwen_vl_matches_jax():
    vit = small_state("qwen_vit", seed=2, num_layers=1)
    full = {f"transformer.visual.{k}": v for k, v in vit.items()}
    full["transformer.wte.weight"] = np.zeros((8, 4), np.float32)
    full["lm_head.weight"] = np.zeros((8, 4), np.float32)
    mine = tw.extract_qwen_vit_from_qwen_vl(torch_state(full))
    ref = jw.extract_qwen_vit_from_qwen_vl(full)
    assert sorted(mine) == sorted(ref) == sorted(vit)
    assert_same(tw.convert_qwen_vit(mine, num_layers=1, num_heads=4),
                jw.convert_qwen_vit(ref, num_layers=1, num_heads=4))


def _llm_state(kind):
    """An HF LLaMA state dict of ``kind``: the llm manifest's keys, the
    agent's PEFT-wrapped ``llm.*`` keys (LoRA, modules_to_save norms, in
    PEFT's order), with ``.base_layer`` projections, or shorter vocab
    tables (the resize)."""
    if kind in ("agent", "base_layer"):
        sd = small_state("agent", seed=3, num_layers=2)
        sd = peft_order({k[len("llm."):]: v for k, v in sd.items()
                         if k.startswith("llm.")})
        if kind == "base_layer":
            sd = {k.replace("_proj.weight", "_proj.base_layer.weight"): v
                  for k, v in sd.items()}
        return sd
    sd = small_state("llm", seed=4, num_layers=2)
    if kind == "resize":
        sd["model.embed_tokens.weight"] = sd["model.embed_tokens.weight"][
            :32000]
        sd["lm_head.weight"] = sd["lm_head.weight"][:32000]
    return sd


@pytest.mark.parametrize("kind,pad_to", [
    ("llm", 0), ("agent", 0), ("base_layer", 0), ("resize", 0),
    ("llm", 32384)])
def test_convert_llama_hf_matches_jax(kind, pad_to):
    sd = _llm_state(kind)
    mine = tw.convert_llama_hf(torch_state(sd), num_layers=2,
                               vocab_size=32330, pad_to=pad_to)
    ref = jw.convert_llama_hf(sd, num_layers=2, vocab_size=32330,
                              pad_to=pad_to)
    assert_same(mine, ref)
    if kind in ("agent", "base_layer"):
        assert "layers.q_proj.lora_a" in mine and \
            "layers.down_proj.lora_b" in mine
    if kind == "resize":      # computed in fp32, as the JAX converter does
        assert mine["embed_tokens.embedding"].dtype == torch.float32


def test_peft_norms_keep_the_trained_copy_in_any_order():
    """Where a PEFT wrapper holds both copies of a norm, the port keeps
    ``modules_to_save.default`` (the trained one) whatever the key order;
    the JAX converter keeps the later key, which is that copy in PEFT's
    own order (the order the test above holds it to)."""
    sd = {k: v for k, v in _llm_state("agent").items()}
    key = "model.layers.1.input_layernorm"
    sd[f"{key}.modules_to_save.default.weight"] = np.full(64, 2.0,
                                                          np.float32)
    sd[f"{key}.original_module.weight"] = np.ones(64, np.float32)
    ordered = dict(sorted(sd.items()))        # trained copy first
    mine = tw.convert_llama_hf(torch_state(ordered), num_layers=2)
    assert torch.all(mine["layers.input_layernorm.scale"].get(1) == 2.0)


def test_convert_agent_checkpoint_matches_jax():
    sd = peft_order(small_state("agent", seed=5, num_layers=2))
    mine = tw.convert_agent_checkpoint(torch_state(sd))
    ref = jw.convert_agent_checkpoint(sd)
    llm_mine, llm_ref = mine.pop("llm_state_dict"), ref.pop("llm_state_dict")
    assert_same(mine, ref)
    assert list(llm_mine) == list(llm_ref)
    assert_same(tw.convert_llama_hf(llm_mine, num_layers=2),
                jw.convert_llama_hf(llm_ref, num_layers=2))


def test_convert_resampler_matches_jax():
    sd = small_state("agent", seed=6, num_layers=0)
    mine = tw.convert_resampler(torch_state(sd), "output_resampler.")
    ref = jw.convert_resampler(sd, "output_resampler.")
    assert_same(mine, ref)


def test_convert_detokenizer_resampler_matches_jax():
    sd = small_state("detokenizer", seed=7)
    assert_same(tw.convert_detokenizer_resampler(torch_state(sd), depth=4),
                jw.convert_detokenizer_resampler(sd, depth=4))


# ---------------------------------------------------------------------------
# SDXL
# ---------------------------------------------------------------------------

def _unet(in_channels=4):
    from seedx_tpu_torch.models.sdxl.unet import UNet2DCondition, UNetConfig

    return lambda: UNet2DCondition(UNetConfig(
        in_channels=in_channels, dtype=torch.float32, **UNET_SMALL)).eval()


def test_widen_conv_in_matches_jax():
    w = np.random.default_rng(8).standard_normal((6, 4, 3, 3)).astype(
        np.float32)
    mine = tsw.widen_conv_in(torch.from_numpy(w), 8)
    ref = jsw.widen_conv_in(w.transpose(2, 3, 1, 0), 8)
    assert mine.shape == (6, 8, 3, 3)
    np.testing.assert_array_equal(mine.numpy(), ref.transpose(3, 2, 0, 1))
    assert tsw.widen_conv_in(torch.from_numpy(w), 4).shape == w.shape


@pytest.mark.parametrize("widen", [None, 8])
def test_convert_sdxl_unet_matches_jax(widen):
    sd = small_state("sdxl_unet", seed=9)
    kw = dict(block_out_channels=UNET_SMALL["block_out_channels"],
              widen_conv_in_to=widen)
    assert_same_module(_unet(widen or 4),
                       tsw.convert_sdxl_unet(torch_state(sd), **kw),
                       jsw.convert_sdxl_unet(sd, **kw))


def test_convert_sdxl_unet_deltas_matches_jax():
    """The detokenizer's optional to_k / to_v deltas and a stray key."""
    detok = small_state("detokenizer", seed=10, deltas=True)
    unet_sd = {k[len("unet."):]: v for k, v in detok.items()
               if k.startswith("unet.")}
    unet_sd["conv_in.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    mine = tsw.convert_sdxl_unet_deltas(torch_state(unet_sd))
    ref = jsw.convert_sdxl_unet_deltas(unet_sd)
    assert mine["skipped"] == ref["skipped"] == ["conv_in.weight"]
    assert len(mine["deltas"]) == 140
    assert_same(mine["deltas"], ref["deltas"])
    for key in unet_sd:
        name = tsw._map_attn_key(key)
        path = jsw._map_attn_key(key)
        assert (name is None) == (path is None)
        if name is not None:
            assert name == ".".join(path)


def test_convert_sdxl_vae_matches_jax():
    from seedx_tpu_torch.models.sdxl.vae import (VAEConfig, VAEDecoder,
                                                 VAEEncoder)

    sd = small_state("sdxl_vae", seed=11)
    mine = tsw.convert_sdxl_vae(torch_state(sd),
                                channels=VAE_SMALL["channels"])
    ref = jsw.convert_sdxl_vae(sd, channels=VAE_SMALL["channels"])
    cfg = VAEConfig(**VAE_SMALL)
    assert_same_module(lambda: VAEEncoder(cfg), mine["encoder"],
                       ref["encoder"])
    assert_same_module(lambda: VAEDecoder(cfg), mine["decoder"],
                       ref["decoder"])


def test_old_vae_attention_names_match_jax():
    sd = small_state("sdxl_vae", seed=12)
    old = {}
    for k, v in sd.items():
        for new, was in (("to_q", "query"), ("to_k", "key"),
                         ("to_v", "value"), ("to_out.0", "proj_attn")):
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{was}.")
        old[k] = v
    mine = tsw.convert_sdxl_vae(torch_state(old),
                                channels=VAE_SMALL["channels"])
    ref = jsw.convert_sdxl_vae(sd, channels=VAE_SMALL["channels"])
    for part in ("encoder", "decoder"):
        got = {k: v for k, v in mine[part].items() if "mid_attn" in k}
        want = {"mid_attn": ref[part]["mid_attn"]}
        assert_same(got, want)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def test_read_safetensors_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    sd = {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
          "f16": torch.randn(7, generator=g).half(),
          "f32": torch.randn(2, 2, 2, generator=g),
          "f64": torch.randn(3, generator=g).double(),
          "i8": torch.randint(-128, 127, (9,), generator=g,
                              dtype=torch.int8),
          "u8": torch.randint(0, 255, (4, 2), generator=g,
                              dtype=torch.uint8),
          "i32": torch.arange(5, dtype=torch.int32),
          "i64": torch.arange(3, dtype=torch.int64) - 1,
          "bool": torch.tensor([True, False, True]),
          "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    mine = tw.read_safetensors(path)
    ref = load_file(path)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert mine[k].dtype == v.dtype and mine[k].shape == v.shape, k
        assert torch.equal(mine[k], v), k
    assert torch.equal(tw.load_torch_checkpoint(path, device="cpu")["f32"],
                       sd["f32"])


def _assert_reads_equal(path):
    mine = tw.load_checkpoint_auto(path)
    ref = jw.load_checkpoint_auto(path)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].float().numpy(), v,
                                      err_msg=k)
    return mine


def test_load_checkpoint_auto_matches_jax(tmp_path):
    from safetensors.torch import save_file

    sd = torch_state(small_state("sdxl_vae", seed=13), torch.float32)
    keys = sorted(sd)
    # an HF shard dir: index JSON + 2 safetensors shards (probed first)
    d = tmp_path / "index"
    d.mkdir()
    wmap = {}
    for i, part in enumerate((keys[::2], keys[1::2])):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: sd[k] for k in part}, str(d / name))
        wmap.update({k: name for k in part})
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": wmap}))
    save_file({"decoy": torch.zeros(1)}, str(d / "model.safetensors"))
    assert sorted(_assert_reads_equal(str(d))) == keys
    # a diffusers single-file dir (fp16)
    d = tmp_path / "single"
    d.mkdir()
    save_file({k: v.half() for k, v in sd.items()},
              str(d / "diffusion_pytorch_model.safetensors"))
    assert _assert_reads_equal(str(d))[keys[0]].dtype == torch.float16
    # an index-less dump of several .bin files, merged in name order
    d = tmp_path / "lone"
    d.mkdir()
    torch.save({k: sd[k] for k in keys[:5]}, str(d / "a.bin"))
    torch.save({k: sd[k] for k in keys[5:]}, str(d / "b.bin"))
    assert sorted(_assert_reads_equal(str(d))) == keys
    # a .pt with and without the {"state_dict": ...} wrapper, bf16
    bf = {k: v.bfloat16() for k, v in sd.items()}
    torch.save(bf, str(tmp_path / "plain.pt"))
    torch.save({"state_dict": bf, "step": 3}, str(tmp_path / "wrapped.pt"))
    for name in ("plain.pt", "wrapped.pt"):
        got = _assert_reads_equal(str(tmp_path / name))
        assert got[keys[0]].dtype == torch.bfloat16
    # nothing to read
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no weight files"):
        tw.load_checkpoint_auto(str(tmp_path / "empty"))


def test_load_torch_checkpoint_reads_legacy_pickles(tmp_path):
    """A torch pickle in the pre-zip format cannot be mapped: read whole."""
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    path = str(tmp_path / "old.bin")
    torch.save(sd, path, _use_new_zipfile_serialization=False)
    assert torch.equal(tw.load_torch_checkpoint(path)["w"], sd["w"])


def test_readers_do_not_widen(tmp_path):
    """Tensors keep the file dtype: a bf16 checkpoint reads as bf16, with
    no fp32 copy made (the JAX readers return fp32 numpy)."""
    sd = torch_state(small_state("llm", seed=14, num_layers=1))
    path = str(tmp_path / "m.bin")
    torch.save(sd, path)
    got = tw.load_checkpoint_auto(path)
    assert {v.dtype for v in got.values()} == {torch.bfloat16}
    from torch_weight_fixtures import write_safetensors_dir

    write_safetensors_dir(str(tmp_path / "llm"), sd)
    got = tw.load_checkpoint_auto(str(tmp_path / "llm"))
    assert {v.dtype for v in got.values()} == {torch.bfloat16}
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    assert os.path.exists(str(tmp_path / "llm" /
                              "model-00002-of-00002.safetensors"))


def test_smoke_writer_matches_the_package(tmp_path):
    """chip_smoke's own safetensors writer (the card has no safetensors
    package) writes what the package reads, and the port's reader too."""
    from safetensors.torch import load_file

    from chip_smoke import write_safetensors

    sd = torch_state(small_state("sdxl_vae", seed=15))
    sd["i8"] = torch.arange(-5, 5, dtype=torch.int8)
    sd["f32"] = torch.linspace(0, 1, 7)
    sd["empty"] = torch.zeros(0, 3)
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, sd)
    for got in (load_file(path), tw.read_safetensors(path)):
        assert list(got) == list(sd) or sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
