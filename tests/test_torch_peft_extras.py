"""IA3 and prompt tuning in the port (``models/layers.LoRADense(ia3=...)``,
``LlamaConfig(ia3=True)``, ``models/peft_extras.py``) against the JAX
package's on the same weights: the cases of tests/test_peft_extras.py.

Float32 on both sides; the JAX int4 projections run the Pallas W4A8 kernel
in interpret mode (``FORCE_KERNEL``), the port its plain W4A8 version.
Tolerances: 1e-5 of the output scale for float / int8 weights; 2e-3 under
int4, where an fp32-ULP difference in a quantized row flips a code on a
rounding edge (tests/test_torch_models.py); soft-prompt values exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn as tnn

import jax
import jax.numpy as jnp
from flax import linen as nn

import seedx_tpu.ops.int4_matmul
from seedx_tpu.models import agent as jagent
from seedx_tpu.models import generation as jgen
from seedx_tpu.models import peft_extras as jpeft
from seedx_tpu.models.layers import LoRADense as JLoRADense
from seedx_tpu.models.llama import LlamaForCausalLM as JLlama
from seedx_tpu.models.llama import llama_debug as jllama_debug
from seedx_tpu.text.tokenizer import load_tokenizer
from seedx_tpu.utils.quantize import quantize_llama_params
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.models import peft_extras as tpeft
from seedx_tpu_torch.models.layers import LoRADense, set_trainable_
from seedx_tpu_torch.models.llama import LlamaForCausalLM
from seedx_tpu_torch.models.llama import llama_debug as tllama_debug
from seedx_tpu_torch.train.partition import path_labels
from seedx_tpu_torch.utils.convert import from_jax_params, load_jax_params

from test_torch_slice import assert_same_tokens, _teacher_forced_logits

torch.set_num_threads(1)


def _numpy(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _close(actual, expected, rel):
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=rel * np.abs(expected).max())


def _dense_params(quant, ia3, n_in, n_out, rng):
    """A JAX LoRADense tree with random values for every leaf."""
    layer = JLoRADense(n_out, kernel_axes=("embed", "mlp"), quantize=quant,
                       ia3=ia3, lora_rank=2, dtype=jnp.float32)
    p = _numpy(layer.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, n_in)))["params"])
    out = {}
    for k, v in p.items():
        if k == "kernel_q4":
            out[k] = rng.integers(0, 256, v.shape).astype(np.uint8)
        elif k == "kernel_q":
            out[k] = rng.integers(-127, 128, v.shape).astype(np.int8)
        elif k == "kernel_scale":
            out[k] = (0.01 + 0.02 * rng.random(v.shape)).astype(np.float32)
        elif k == "ia3_scale":
            out[k] = (1.0 + 0.5 * rng.standard_normal(v.shape)).astype(
                np.float32)
        else:
            out[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
    return layer, out


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("ia3", ["out", "in"])
def test_ia3_dense_matches_jax(monkeypatch, ia3, quant):
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    rng = np.random.default_rng(1)
    n_in, n_out = 256, 128
    layer_j, p = _dense_params(quant, ia3, n_in, n_out, rng)
    assert p["ia3_scale"].shape == ((n_in,) if ia3 == "in" else (n_out,))
    layer_t = load_jax_params(
        LoRADense(n_in, n_out, lora_rank=2, quantize=quant, ia3=ia3,
                  dtype=torch.float32), p)
    x = rng.standard_normal((2, 5, n_in)).astype(np.float32)
    want = layer_j.apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = layer_t(torch.from_numpy(x))
    _close(got.numpy(), want, 2e-3 if quant == "int4" else 1e-5)
    # ones: the layer without IA3
    p1 = dict(p, ia3_scale=np.ones_like(p["ia3_scale"]))
    base = {k: v for k, v in p.items() if k != "ia3_scale"}
    plain = load_jax_params(LoRADense(n_in, n_out, lora_rank=2,
                                      quantize=quant, dtype=torch.float32),
                            base)
    with torch.no_grad():
        np.testing.assert_array_equal(
            load_jax_params(layer_t, p1)(torch.from_numpy(x)).numpy(),
            plain(torch.from_numpy(x)).numpy())


def test_llama_ia3_leaves_and_logits_match_jax():
    cfg_j = jllama_debug(hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=4, ia3=True,
                         dtype=jnp.float32)
    cfg_t = tllama_debug(hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=4, ia3=True,
                         dtype=torch.float32)
    model_j = JLlama(cfg_j)
    ids = np.random.default_rng(2).integers(3, 500, (1, 8))
    pos = np.arange(8)[None]
    params = _numpy(model_j.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                 jnp.asarray(pos), method="init_all")
                    ["params"])
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(
            np.float32) if path[-1].key == "ia3_scale" else v, params)
    llm = LlamaForCausalLM(cfg_t)
    names = {k: tuple(v.shape) for k, v in llm.state_dict().items()
             if "ia3_scale" in k}
    assert names == {"layers.k_proj.ia3_scale": (2, 64),
                     "layers.v_proj.ia3_scale": (2, 64),
                     "layers.down_proj.ia3_scale": (2, 128)}
    assert set(names) == {k for k in from_jax_params(params)
                          if "ia3_scale" in k}
    load_jax_params(llm, params)
    emb = model_j.apply({"params": params}, jnp.asarray(ids), method="embed")
    want = model_j.apply({"params": params}, emb, jnp.asarray(pos))[0]
    with torch.no_grad():
        got = llm(llm.embed(torch.from_numpy(ids)), torch.from_numpy(pos))[0]
    assert got.shape == (1, 8, cfg_t.padded_vocab_size)
    _close(got.numpy(), want, 2e-5)
    labels = path_labels(llm.state_dict(), tpeft.IA3_TRAINABLE_PATTERNS)
    assert {k for k, v in labels.items() if v == "trainable"} == set(names)


def test_ia3_int4_agent_greedy_tokens_match_jax(monkeypatch):
    """The debug int4 + int8-KV agent with random IA3 scales: greedy tokens
    equal to JAX's (or a tie at the first divergence, test_torch_slice)."""
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    kw = dict(hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=4, ia3=True)
    q = dict(quantization="int4", kv_quantization="int8")
    cfg_j = jagent.AgentConfig(llm=jllama_debug(dtype=jnp.float32, **kw),
                               vit_dim=64, resampler_heads=4,
                               dtype=jnp.float32)
    model = jagent.ContinuousLVLM(cfg_j)
    b, s, n = 1, 80, 1
    ids = jnp.zeros((b, s), jnp.int32)
    attn = jnp.ones((b, s), bool)
    idsm = jnp.zeros((b, s), bool).at[0, 1:65].set(True)
    params = _numpy(model.init(
        jax.random.PRNGKey(1), ids, attn, jnp.where(attn, ids, -100),
        jnp.zeros((n, 256, 64), jnp.float32), jnp.zeros((n,), bool),
        jnp.zeros((n,), bool), idsm, idsm, jnp.full((n, 2), 0.5),
        method="init_all")["params"])
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(
            np.float32) if path[-1].key == "ia3_scale" else v, params)
    params["llm"] = quantize_llama_params(params["llm"], mode="int4")
    model_j = jagent.ContinuousLVLM(dataclasses.replace(
        cfg_j, llm=jllama_debug(dtype=jnp.float32, **kw, **q)))
    cfg_t = tagent.AgentConfig(llm=tllama_debug(dtype=torch.float32, **kw,
                                                **q),
                               vit_dim=64, resampler_heads=4,
                               dtype=torch.float32)
    agent_t = load_jax_params(tagent.ContinuousLVLM(cfg_t).eval(), params)
    tok = load_tokenizer()
    ids = [tok.bos_token_id] + tok.encode("[INST] Describe a cat. [/INST]\n")
    out_j = jgen.generate(model_j, {"params": params}, tok, ids,
                          gen_cfg=jgen.GenerationConfig(max_new_tokens=8))
    out_t = tgen.generate(agent_t, tok, ids,
                          gen_cfg=tgen.GenerationConfig(max_new_tokens=8))
    with torch.no_grad():
        pe = agent_t.embed_ids(torch.as_tensor(ids)[None])
    assert_same_tokens(out_t["tokens"], out_j["tokens"],
                       _teacher_forced_logits(
                           agent_t, pe, torch.ones((1, len(ids)), dtype=bool),
                           out_j["tokens"], ids[-1], 64))


def test_soft_prompt_prepend_matches_jax():
    sp_j = jpeft.SoftPrompt(num_virtual_tokens=4, hidden_size=16)
    p = _numpy(sp_j.init(jax.random.PRNGKey(0), 2)["params"])
    sp_t = tpeft.SoftPrompt(4, 16)
    assert tuple(sp_t.embedding.shape) == (4, 16)
    assert sp_t.embedding.dtype == torch.float32
    with torch.no_grad():
        sp_t.embedding.copy_(torch.from_numpy(np.array(p["embedding"])))
    prompt_j = sp_j.apply({"params": p}, 2)
    prompt_t = sp_t(2)
    np.testing.assert_array_equal(prompt_t.detach().numpy(),
                                  np.asarray(prompt_j))
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((2, 6, 16)).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    labels = np.arange(12).reshape(2, 6)
    want = jpeft.apply_soft_prompt(prompt_j, jnp.asarray(embeds),
                                   jnp.asarray(mask), jnp.asarray(labels))
    got = tpeft.apply_soft_prompt(prompt_t, torch.from_numpy(embeds),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(labels))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.detach().numpy(), np.asarray(w_))
    e, m, lab = tpeft.apply_soft_prompt(prompt_t, torch.from_numpy(embeds))
    assert m is None and lab is None and e.shape == (2, 10, 16)
    # the generator draws normal(0, 0.02)
    g = torch.Generator().manual_seed(0)
    big = tpeft.SoftPrompt(64, 256, generator=g).embedding
    assert abs(big.std().item() - 0.02) < 1e-3


def test_soft_prompt_loss_and_grad_match_jax():
    """The soft-prompt loss through the frozen LLaMA and its gradient in
    the prompt, against ``jax.grad`` (rel 1e-5 of the largest value); the
    pattern preset trains exactly the prompt."""
    cfg_j = jllama_debug(hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=2, num_kv_heads=2, dtype=jnp.float32)
    cfg_t = tllama_debug(hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=2, num_kv_heads=2, dtype=torch.float32)
    model_j = JLlama(cfg_j)
    sp_j = jpeft.SoftPrompt(num_virtual_tokens=3, hidden_size=32)
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 5), 0,
                                        100))
    pos = np.arange(5 + 3)[None]
    lm_params = _numpy(model_j.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                                    jnp.arange(5)[None],
                                    method="init_all")["params"])
    sp_params = _numpy(sp_j.init(jax.random.PRNGKey(2), 2)["params"])

    def loss_j(spp):
        prompt = sp_j.apply({"params": spp}, 2)
        tok = model_j.apply({"params": lm_params}, jnp.asarray(ids),
                            method="embed")
        e, _, _ = jpeft.apply_soft_prompt(prompt, tok)
        logits = model_j.apply({"params": lm_params}, e, jnp.asarray(pos))[0]
        return jnp.mean(logits.astype(jnp.float32) ** 2)

    want_loss, want_grad = jax.value_and_grad(loss_j)(sp_params)

    class Tuned(tnn.Module):
        def __init__(self):
            super().__init__()
            self.llm = load_jax_params(LlamaForCausalLM(cfg_t), lm_params)
            self.soft_prompt = tpeft.SoftPrompt(3, 32)

    model = Tuned()
    labels = path_labels(model.state_dict(), tpeft.PROMPT_TRAINABLE_PATTERNS)
    train = [k for k, v in labels.items() if v == "trainable"]
    assert train == ["soft_prompt.embedding"]
    set_trainable_(model, train)
    with torch.no_grad():
        model.soft_prompt.embedding.copy_(
            torch.from_numpy(sp_params["embedding"]))
    e, _, _ = tpeft.apply_soft_prompt(model.soft_prompt(2),
                                      model.llm.embed(torch.from_numpy(ids)))
    loss = model.llm(e, torch.from_numpy(pos))[0].float().square().mean()
    loss.backward()
    assert [n for n, p in model.named_parameters()] == train
    _close(loss.item(), float(want_loss), 1e-5)
    _close(model.soft_prompt.embedding.grad.numpy(),
           want_grad["embedding"], 1e-5)
    assert float(np.abs(want_grad["embedding"]).sum()) > 0.0
