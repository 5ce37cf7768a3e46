"""Parity of the PyTorch port's modules with the JAX package's, on the
same weights: JAX parameter trees (structure from ``init``, values from
``np.random.default_rng``) go through ``seedx_tpu_torch.utils.convert``
into the port.  Float32 configs on both sides, so the comparison is of the
algorithm; the JAX int4 projections run the Pallas W4A8 kernel in
interpret mode (``FORCE_KERNEL``), the port its plain W4A8 version.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

import seedx_tpu.ops.int4_matmul
from seedx_tpu.models import llama as jllama
from seedx_tpu.models import resampler as jres
from seedx_tpu.models import vit as jvit
from seedx_tpu.utils.quantize import (quantize_llama_params,
                                      quantize_vit_params)
from seedx_tpu_torch.models import llama as tllama
from seedx_tpu_torch.models import resampler as tres
from seedx_tpu_torch.models import vit as tvit
from seedx_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


def randomize(params, seed):
    """Unboxed numpy copy of a flax tree with every float leaf redrawn:
    norm scales 1 + N(0, 0.1), biases N(0, 0.02), other leaves N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return x
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name == "bias":
            v = 0.02 * rng.standard_normal(x.shape)
        else:
            v = 0.05 * rng.standard_normal(x.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, nn.meta.unbox(params))


def _close(actual, expected, rel):
    """|actual - expected| <= rel * max|expected|, elementwise."""
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=rel * np.abs(expected).max())


# float32 on both sides; XLA and ATen sum in different orders, and the
# errors grow through a few layers: 1e-5 of the output magnitude.
F32_REL = 1e-5


@pytest.mark.parametrize("patch_pos,quant", [(False, "none"), (True, "none"),
                                            (False, "int8")])
def test_vit_matches_jax(patch_pos, quant):
    cfg_j = jvit.vit_tiny_debug(image_size=56, output_dim=64,
                                patch_pos=patch_pos, dtype=jnp.float32)
    cfg_t = tvit.vit_tiny_debug(image_size=56, output_dim=64,
                                patch_pos=patch_pos, quantization=quant,
                                dtype=torch.float32)
    model = jvit.VisionTransformer(cfg_j, remat=False)
    rng = np.random.default_rng(10)
    images = rng.standard_normal((3, 56, 56, 3)).astype(np.float32)
    ppos = rng.random((3, 2)).astype(np.float32)
    params = randomize(model.init(jax.random.PRNGKey(0), jnp.asarray(images),
                                  jnp.asarray(ppos))["params"], 11)
    if quant == "int8":     # the trunk's projections as int8 + scales
        params = quantize_vit_params(params)
        model = jvit.VisionTransformer(
            dataclasses.replace(cfg_j, quantization="int8"), remat=False)
    out_j = model.apply({"params": params}, jnp.asarray(images),
                        jnp.asarray(ppos) if patch_pos else None)
    vit = load_jax_params(tvit.VisionTransformer(cfg_t), params)
    with torch.no_grad():
        out_t = vit(torch.from_numpy(images),
                    torch.from_numpy(ppos) if patch_pos else None)
    _close(out_t.numpy(), out_j, F32_REL)
    _close(tvit.vit_downsample(out_t).numpy(),
           jvit.vit_downsample(out_j), F32_REL)


def test_resampler_matches_jax():
    # 36 kv tokens on a 4x4 query grid: the sincos table is resized 4 -> 6
    model = jres.Resampler(grid_size=4, embed_dim=32, num_heads=4, kv_dim=24,
                           dtype=jnp.float32)
    x = np.random.default_rng(12).standard_normal((2, 36, 24)).astype(
        np.float32)
    params = randomize(model.init(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"], 13)
    out_j = model.apply({"params": params}, jnp.asarray(x))
    res = load_jax_params(tres.Resampler(4, 32, 4, kv_dim=24,
                                         dtype=torch.float32), params)
    with torch.no_grad():
        out_t = res(torch.from_numpy(x))
    _close(out_t.numpy(), out_j, F32_REL)


def _llama_cfgs(quant, kv_quant, lora_rank):
    kw = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, lora_rank=lora_rank,
              quantization=quant, kv_quantization=kv_quant)
    return (jllama.llama_debug(dtype=jnp.float32, **kw),
            tllama.llama_debug(dtype=torch.float32, **kw))


# int4 + int8 KV: the W4A8 activation codes and the int8 KV codes round
# x / scale; an fp32-ULP difference in x flips a code that sits on a
# rounding edge, moving an output by up to one code step (~1/127 of the
# row's scale) -- so 2e-3 of the logit magnitude instead of 1e-5.
@pytest.mark.parametrize("quant,kv_quant,lora_rank,rel", [
    ("none", "none", 2, 2e-5), ("int4", "int8", 0, 2e-3)])
def test_llama_prefill_and_cached_decode_match_jax(monkeypatch, quant,
                                                   kv_quant, lora_rank, rel):
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    cfg_j, cfg_t = _llama_cfgs("none", "none", lora_rank)
    model_j = jllama.LlamaForCausalLM(cfg_j)
    b, p, t = 2, 12, 4
    rng = np.random.default_rng(14)
    ids = rng.integers(3, 512, size=(b, p))
    mask = np.ones((b, p), bool)
    mask[1, :4] = False                               # left-padded row
    positions = np.maximum(np.cumsum(mask, -1) - 1, 0)
    params = randomize(model_j.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(positions),
        method="init_all")["params"], 15)
    if quant != "none":
        cfg_j, cfg_t = _llama_cfgs(quant, kv_quant, lora_rank)
        model_j = jllama.LlamaForCausalLM(cfg_j)
        params = quantize_llama_params(params, mode=quant)
    vars_j = {"params": params}
    llm_t = load_jax_params(tllama.LlamaForCausalLM(cfg_t), params)

    cache_j = jllama.init_kv_cache(cfg_j, b, p + t)
    cache_t = tllama.init_kv_cache(cfg_t, b, p + t)
    kv_valid = np.concatenate([mask, np.zeros((b, t), bool)], -1)
    emb_j = model_j.apply(vars_j, jnp.asarray(ids), method="embed")
    logits_j, hid_j, cache_j = model_j.apply(
        vars_j, emb_j, jnp.asarray(positions), jnp.asarray(kv_valid),
        cache_j, 0)
    with torch.no_grad():
        emb_t = llm_t.embed(torch.from_numpy(ids))
        _close(emb_t.numpy(), emb_j, 1e-6)
        logits_t, hid_t, _ = llm_t(emb_t, torch.from_numpy(positions),
                                   torch.from_numpy(kv_valid), cache_t, 0)
    _close(logits_t.numpy()[mask], np.asarray(logits_j)[mask], rel)
    _close(hid_t.numpy()[mask], np.asarray(hid_j)[mask], rel)

    pos = positions[:, -1]
    tok = np.array(jnp.argmax(logits_j[:, -1], -1))
    for n in range(3):                                # cached decode steps
        pos = pos + 1
        kv_valid[:, p:p + n + 1] = True
        step_j = model_j.apply(vars_j, jnp.asarray(tok[:, None]),
                               method="embed")
        logits_j, _, cache_j = model_j.apply(
            vars_j, step_j, jnp.asarray(pos[:, None]), jnp.asarray(kv_valid),
            cache_j, p + n)
        with torch.no_grad():
            logits_t, _, _ = llm_t(llm_t.embed(torch.tensor(tok[:, None])),
                                   torch.from_numpy(pos[:, None]),
                                   torch.from_numpy(kv_valid), cache_t, p + n)
        _close(logits_t.numpy(), logits_j, rel)
        tok = np.array(jnp.argmax(logits_j[:, -1], -1))
    if kv_quant == "int8":
        nh = cfg_t.num_kv_heads
        codes_j = np.asarray(cache_j[0])[:, :, :p + 3]
        codes_t = cache_t[0].numpy()[:, :, :p + 3]
        # the stored int8 KV codes agree except where a rounding edge flips
        assert np.mean(codes_j != codes_t) < 1e-3
        _close(cache_t[2].numpy()[:, :, :p + 3],
               np.asarray(cache_j[2])[..., :nh][:, :, :p + 3], rel)


@pytest.mark.parametrize("mode", ["int4", "int8_full"])
def test_quantize_llama_params_matches_jax(mode):
    from seedx_tpu_torch.utils.convert import from_jax_params
    from seedx_tpu_torch.utils.quantize import (
        quantize_llama_params as tquantize)

    cfg_j, _ = _llama_cfgs("none", "none", 0)
    model_j = jllama.LlamaForCausalLM(cfg_j)
    params = randomize(model_j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 4), jnp.int32), method="init_all")["params"], 16)
    want = from_jax_params(quantize_llama_params(params, mode=mode))
    got = tquantize({k: torch.from_numpy(v)
                     for k, v in from_jax_params(params).items()}, mode)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_llama_config_fields_mirror_jax():
    # every field the port keeps has the JAX package's default
    jf = {f.name: f.default for f in dataclasses.fields(jllama.LlamaConfig)}
    for f in dataclasses.fields(tllama.LlamaConfig):
        if f.name not in ("dtype", "attention_impl"):
            assert jf[f.name] == f.default, f.name


def test_agent_splice_helpers_match_jax():
    from seedx_tpu.models import agent as jagent
    from seedx_tpu_torch.models import agent as tagent

    rng = np.random.default_rng(17)
    rows = rng.standard_normal((4, 3, 8)).astype(np.float32)
    slots = np.array([False, True, False, True])
    np.testing.assert_array_equal(
        tagent._compact_rows(torch.from_numpy(rows),
                             torch.from_numpy(slots)).numpy(),
        np.asarray(jagent._compact_rows(jnp.asarray(rows),
                                        jnp.asarray(slots))))
    base = rng.standard_normal((2, 7, 8)).astype(np.float32)
    mask = rng.random((2, 7)) < 0.5
    flat = rows.reshape(-1, 8)[:5]      # fewer rows than mask positions
    np.testing.assert_array_equal(
        tagent._scatter_to_positions(torch.from_numpy(base),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(flat)).numpy(),
        np.asarray(jagent._scatter_to_positions(
            jnp.asarray(base), jnp.asarray(mask), jnp.asarray(flat))))
    for slots_n, per_slot in ((2, 2), (3, 3)):   # positions dropped / padded
        np.testing.assert_array_equal(
            tagent._gather_from_positions(torch.from_numpy(base),
                                          torch.from_numpy(mask), slots_n,
                                          per_slot).numpy(),
            np.asarray(jagent._gather_from_positions(
                jnp.asarray(base), jnp.asarray(mask), slots_n, per_slot)))
