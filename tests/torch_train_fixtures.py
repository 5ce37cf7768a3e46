"""Shared inputs of the port's training tests (``tests/test_torch_train*.py``):
the tiny agent on both sides, random weights as numpy arrays, and SFT
batches.

The JAX parameter tree is built from the port's state names and shapes
(the inverse of ``seedx_tpu_torch.utils.convert.from_jax_params``), so no
``model.init`` trace is needed; the same numpy arrays load into the port.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.models import agent as jagent
from seedx_tpu.models.llama import llama_debug as jllama_debug
from seedx_tpu.train import partition as jpart
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models.llama import llama_debug as tllama_debug

BATCH_KEYS = ("input_ids", "attention_mask", "labels", "image_embeds",
              "embeds_gen_mask", "embeds_cmp_mask", "ids_gen_mask",
              "ids_cmp_mask", "patch_positions")
# the tiny_agent_cfg widths (tests/conftest.py) with LoRA rank 4
LLM_KW = dict(hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=4, lora_rank=4)


def tiny_agents(dtype="float32", lora_dropout=0.0, **llm_kw):
    """(JAX ContinuousLVLM, port AgentConfig) of the tiny agent.  The JAX
    side runs without remat (the same function; it only compiles faster)."""
    kw = dict(LLM_KW, lora_dropout=lora_dropout, **llm_kw)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg_j = jagent.AgentConfig(llm=jllama_debug(dtype=jdt, remat=False, **kw),
                               vit_dim=64, resampler_heads=4, dtype=jdt)
    cfg_t = tagent.AgentConfig(llm=tllama_debug(dtype=tdt, **kw), vit_dim=64,
                               resampler_heads=4, dtype=tdt)
    return jagent.ContinuousLVLM(cfg_j), cfg_t


def random_state(agent, seed):
    """{port state name: fp32 numpy array}: norm scales 1 + N(0, 0.1),
    biases N(0, 0.02), every other float leaf N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in agent.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if leaf == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias":
            v = 0.02 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        out[name] = v.astype(np.float32)
    return out


def jax_tree(state):
    """Port state names -> the JAX agent's nested parameter tree (the
    flax ``model.layers.layer`` and ``model.norm`` levels put back)."""
    tree = {}
    for name, v in state.items():
        if name.startswith("llm.layers."):
            name = "llm.model.layers.layer." + name[len("llm.layers."):]
        elif name.startswith("llm.norm."):
            name = "llm.model." + name[len("llm."):]
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def sft_batch(seed, images=True, b=2, s=80, n=2, t=256, vit_dim=64):
    """A right-padded SFT batch: row 0 holds a 64-token comprehension span,
    row 1 a 64-token generation span (image slots [cmp, gen]); without
    ``images`` the image keys are left out and the span masks are False."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 32000, (b, s)).astype(np.int32)
    am = np.ones((b, s), np.int32)
    am[1, s - 10:] = 0
    labels = np.where(am > 0, ids, -100).astype(np.int32)
    labels[0, :10] = -100
    gen = np.zeros((b, s), bool)
    cmp_ = np.zeros((b, s), bool)
    out = dict(input_ids=ids, attention_mask=am, labels=labels)
    if images:
        gen[1, 2:66] = True
        cmp_[0, 1:65] = True
        out.update(image_embeds=rng.standard_normal((n, t, vit_dim)).astype(
                       np.float32),
                   embeds_gen_mask=np.array([False, True]),
                   embeds_cmp_mask=np.array([True, False]),
                   patch_positions=rng.random((n, 2)).astype(np.float32))
    out.update(ids_gen_mask=gen, ids_cmp_mask=cmp_)
    return out


def to_torch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_value_and_grad(model):
    """jitted (trainable, frozen, batch) -> ((loss, losses), grads) over
    the JAX package's trainable subtree."""
    def loss_fn(trainable, frozen, batch):
        out = model.apply({"params": jpart.merge_params(trainable, frozen)},
                          *[batch.get(k) for k in BATCH_KEYS])
        return out["total_loss"], out

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def split_jax(tree):
    labels = jpart.path_labels(tree)
    return jpart.split_params(tree, labels)


def close_rel(actual, expected, rel, floor=0.0):
    """|actual - expected| <= rel * max(max|expected|, floor)."""
    expected = np.asarray(expected, np.float32)
    atol = rel * max(float(np.abs(expected).max()), floor)
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=atol)
