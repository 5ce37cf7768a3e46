"""The image-in comprehension turn, end to end: the JAX package's
``SeedXRuntime.debug()`` weights converted into the port's ``debug()``
runtime must give the same token streams through ``comprehend`` and the
forced ``<img>`` chunk, and the int4 + int8-KV agent the same tokens.

Float32 configs on both sides (the algorithm is the point).  Token streams
are compared tie-aware: equal, or at the first divergence the port's two
candidate logits are within ``TIE_ULPS`` fp32 ULPs of each other.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import linen as nn

import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference import apps as japps
from seedx_tpu.inference.runtime import SeedXRuntime as JaxRuntime
from seedx_tpu.models import agent as jagent
from seedx_tpu.models import generation as jgen
from seedx_tpu.models.llama import llama_debug as jllama_debug
from seedx_tpu.models.vit import VisionTransformer as JaxViT
from seedx_tpu.text.tokenizer import load_tokenizer
from seedx_tpu.utils.quantize import quantize_llama_params
from seedx_tpu_torch.inference import apps as tapps
from seedx_tpu_torch.inference.runtime import SeedXRuntime as TorchRuntime
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.models.llama import llama_debug as tllama_debug
from seedx_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

# fp32 logits of O(1): a tie is two candidates within a few ULPs
TIE_ULPS = 8


def _numpy_tree(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))


def assert_same_tokens(got, want, logits_at):
    """Equal streams, or a tie at the first divergence: ``logits_at(i)``
    gives the port's constrained logits that decided token i."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    i = int(diff[0])
    lg = np.asarray(logits_at(i), np.float32)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    bound = TIE_ULPS * float(np.spacing(np.abs(lg).max()))
    assert gap <= bound, (f"token {i}: port {got[i]} vs JAX {want[i]}, "
                          f"logit gap {gap} > {bound}")


def _teacher_forced_logits(agent, prompt_embeds, prompt_mask, tokens,
                           last_prompt_token, n_img):
    """The port's constrained logits for output position i, from one
    uncached forward over the prompt and ``tokens[:i]``."""
    def at(i):
        with torch.no_grad():
            ids = torch.as_tensor(np.asarray(tokens[:i]))[None]
            embeds = torch.cat([prompt_embeds, agent.embed_ids(ids)], 1)
            mask = torch.cat([prompt_mask, torch.ones_like(ids, dtype=bool)],
                             1)
            pos = torch.clamp(torch.cumsum(mask.long(), -1) - 1, min=0)
            logits, _, _ = agent.llm_step(embeds, pos, mask)
            prev = int(tokens[i - 1]) if i else int(last_prompt_token)
            return tgen.constrain_image_tokens(
                torch.tensor([prev]), logits[:, -1].float(),
                load_tokenizer().vocab, n_img)[0].numpy()
    return at


def _f32_jax_runtime():
    """JAX ``debug()`` runtime with its modules rebuilt in float32 (the
    parameters are fp32 already; only the compute dtype changes)."""
    rt = JaxRuntime.debug()
    rt.vit_cfg = dataclasses.replace(rt.vit_cfg, dtype=jnp.float32)
    rt.vit = JaxViT(rt.vit_cfg, remat=False)
    llm = dataclasses.replace(rt.agent_cfg.llm, dtype=jnp.float32)
    rt.agent_cfg = dataclasses.replace(rt.agent_cfg, llm=llm,
                                       dtype=jnp.float32)
    rt.agent = jagent.ContinuousLVLM(rt.agent_cfg)
    return rt


@pytest.fixture(scope="module")
def runtimes():
    rt_j = _f32_jax_runtime()
    rt_t = TorchRuntime.debug(dtype=torch.float32)
    load_jax_params(rt_t.vit, _numpy_tree(rt_j.vit_params))
    load_jax_params(rt_t.agent, _numpy_tree(rt_j.agent_params))
    return rt_j, rt_t


def test_comprehend_matches_jax(runtimes):
    rt_j, rt_t = runtimes
    img = _image(120, 90, seed=120)     # 4 anyres tiles + the thumbnail
    emb_j, _ = rt_j.encode_image_anyres(img)
    emb_t, _ = rt_t.encode_image_anyres(img)
    # ViT over the anyres tiles: fp32, 2 layers + the attention pool
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(emb_j)).max())
    out_j = japps.comprehend(rt_j, img, "What is this?", max_new_tokens=4)
    out_t = tapps.comprehend(rt_t, img, "What is this?", max_new_tokens=4)

    ids, cmp, emb, ecm, ppos = tapps._prepare_image_prompt(
        rt_t, img, "What is this?")
    with torch.no_grad():
        pe = rt_t.agent.embed_with_images(
            torch.as_tensor(ids)[None], emb, torch.as_tensor(cmp)[None],
            torch.as_tensor(ecm), ppos)
    assert_same_tokens(out_t["tokens"], out_j["tokens"],
                       _teacher_forced_logits(
                           rt_t.agent, pe, torch.ones_like(
                               torch.as_tensor(cmp)[None]),
                           out_j["tokens"], ids[-1],
                           rt_t.agent_cfg.num_img_out_tokens))
    assert out_t["text"] == out_j["text"]


def _tiny_int4_agents():
    """The tiny agent with int4 projections and an int8 KV cache, 64-token
    output spans (so an <img> prompt runs the 65-token chunk)."""
    kw = dict(hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=4)
    cfg_j = jagent.AgentConfig(llm=jllama_debug(dtype=jnp.float32, **kw),
                               vit_dim=64, resampler_heads=4,
                               dtype=jnp.float32)
    model = jagent.ContinuousLVLM(cfg_j)
    b, s, n = 1, 80, 1
    ids = jnp.zeros((b, s), jnp.int32)
    attn = jnp.ones((b, s), bool)
    idsm = jnp.zeros((b, s), bool).at[0, 1:65].set(True)
    params = model.init(
        jax.random.PRNGKey(1), ids, attn, jnp.where(attn, ids, -100),
        jnp.zeros((n, 256, 64), jnp.float32), jnp.zeros((n,), bool),
        jnp.zeros((n,), bool), idsm, idsm, jnp.full((n, 2), 0.5),
        method="init_all")["params"]
    params = _numpy_tree(params)
    params["llm"] = quantize_llama_params(params["llm"], mode="int4")
    q = dict(quantization="int4", kv_quantization="int8")
    cfg_j = dataclasses.replace(cfg_j, llm=jllama_debug(
        dtype=jnp.float32, **kw, **q))
    cfg_t = tagent.AgentConfig(llm=tllama_debug(dtype=torch.float32, **kw,
                                                **q),
                               vit_dim=64, resampler_heads=4,
                               dtype=torch.float32)
    agent_t = load_jax_params(tagent.ContinuousLVLM(cfg_t).eval(), params)
    return jagent.ContinuousLVLM(cfg_j), {"params": params}, agent_t


def test_int4_int8kv_agent_tokens_and_forced_chunk_match_jax(monkeypatch):
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    model_j, vars_j, agent_t = _tiny_int4_agents()
    tok = load_tokenizer()
    vocab = tok.vocab
    feats = np.random.default_rng(20).standard_normal((2, 16, 64)).astype(
        np.float32)
    ppos = np.array([[0.25, 0.5], [0.5, 0.5]], np.float32)
    text = ("<patch>" + "".join(vocab.img_token(i) for i in range(64))
            + "</patch><img>" + "".join(vocab.img_token(i) for i in range(64))
            + "</img>[INST] Describe. [/INST]\n")
    ids = [tok.bos_token_id] + tok.encode(text)
    from seedx_tpu.text.prompts import cmp_mask_from_ids
    cmp = cmp_mask_from_ids(ids)
    ecm = np.ones(2, bool)

    def both(input_ids, max_new, **img):
        gen_j = jgen.GenerationConfig(max_new_tokens=max_new)
        gen_t = tgen.GenerationConfig(max_new_tokens=max_new)
        img_j = {k: (jnp.asarray(v) if k in ("image_embeds",
                                              "patch_positions") else v)
                 for k, v in img.items()}
        img_t = {k: (torch.from_numpy(v) if k in ("image_embeds",
                                                  "patch_positions") else v)
                 for k, v in img.items()}
        out_j = jgen.generate(model_j, vars_j, tok, input_ids,
                              gen_cfg=gen_j, **img_j)
        out_t = tgen.generate(agent_t, tok, input_ids, gen_cfg=gen_t,
                              **img_t)
        return out_j, out_t

    # image in, text out
    out_j, out_t = both(ids, 4, image_embeds=feats, embeds_cmp_mask=ecm,
                        ids_cmp_mask=cmp, patch_positions=ppos)
    with torch.no_grad():
        pe = agent_t.embed_with_images(
            torch.as_tensor(ids)[None], torch.from_numpy(feats),
            torch.as_tensor(cmp)[None], torch.as_tensor(ecm),
            torch.from_numpy(ppos))
    assert_same_tokens(out_t["tokens"], out_j["tokens"],
                       _teacher_forced_logits(
                           agent_t, pe, torch.ones((1, len(ids)), dtype=bool),
                           out_j["tokens"], ids[-1], 64))

    # a prompt ending in <img>: the forced 65-token chunk, then 2 free steps
    ids = [tok.bos_token_id] + tok.encode("[INST] Draw a cat. [/INST]\n<img>")
    out_j, out_t = both(ids, 67)
    assert out_t["has_img_output"] and out_j["has_img_output"]
    forced = list(range(vocab.img_token_start, vocab.img_token_start + 64))
    assert list(out_t["tokens"][:65]) == forced + [vocab.eoi]
    with torch.no_grad():
        pe = agent_t.embed_ids(torch.as_tensor(ids)[None])
    assert_same_tokens(out_t["tokens"], out_j["tokens"],
                       _teacher_forced_logits(
                           agent_t, pe, torch.ones((1, len(ids)), dtype=bool),
                           out_j["tokens"], ids[-1], 64))
    feat_j = np.asarray(out_j["img_gen_feat"])
    # the output resampler over the chunk's 64 hidden states: int4 W4A8
    # and int8 KV codes can flip on a rounding edge (see
    # test_torch_models.py), so 2e-3 of the feature magnitude
    np.testing.assert_allclose(out_t["img_gen_feat"].numpy(), feat_j,
                               rtol=0, atol=2e-3 * np.abs(feat_j).max())


def test_constrain_image_tokens_matches_jax():
    vocab = load_tokenizer().vocab
    n = 64
    img0 = vocab.img_token_start
    prev = np.array([vocab.boi, img0, img0 + 30, img0 + n - 1, 5, vocab.eoi])
    logits = np.random.default_rng(21).standard_normal(
        (len(prev), vocab.vocab_size)).astype(np.float32)
    got = tgen.constrain_image_tokens(torch.from_numpy(prev),
                                      torch.from_numpy(logits), vocab, n)
    want = jgen.constrain_image_tokens(jnp.asarray(prev),
                                       jnp.asarray(logits), vocab, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eos_exit_and_top_p_sampling(runtimes):
    _, rt_t = runtimes
    tok = rt_t.tokenizer
    gen_cfg = tgen.GenerationConfig(max_new_tokens=6, num_img_gen_tokens=256,
                                    eos_token_id=tok.eos_token_id,
                                    pad_token_id=tok.pad_token_id)
    agent = rt_t.agent
    head = agent.llm.lm_head.kernel
    saved = head.clone()
    try:
        head[:, tok.eos_token_id] += 100.0    # EOS wins the first step
        ids = torch.as_tensor([[tok.bos_token_id] + tok.encode("Hi")])
        with torch.no_grad():
            out = tgen.generate_tokens(
                agent, agent.embed_ids(ids), torch.ones_like(ids, dtype=bool),
                ids[:, -1], gen_cfg)
    finally:
        head.copy_(saved)
    # the loop stops at EOS: later slots keep their initial values (pad
    # tokens, not finished), as in the JAX engine's early exit
    assert out["tokens"][0].tolist() == [tok.eos_token_id] + [0] * 5
    assert out["finished"][0].tolist() == [True] + [False] * 5
    res = tgen.build_result(*tgen._trim_and_spans(
        out["tokens"][0].numpy(), gen_cfg, tok.vocab), None, tok, tok.vocab,
        256)
    assert res["tokens"].tolist() == [tok.eos_token_id]
    # top-p keeps only the smallest head of the distribution reaching p
    logits = torch.tensor([[4.0, 1.0, 0.5, 0.0], [0.0, 3.0, 2.9, -5.0]])
    cfg = tgen.GenerationConfig(do_sample=True, temperature=1.0, top_p=0.5)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tgen._sample(logits, cfg, gen) for _ in range(50)])
    assert set(draws[:, 0].tolist()) == {0}
    assert set(draws[:, 1].tolist()) <= {1, 2}


def test_tile_buckets_and_single_crop_match(runtimes):
    rt_j, rt_t = runtimes
    img = _image(60, 200, seed=60)
    exact, ppos = rt_t.encode_image_anyres(img)
    padded, ppos_b = rt_t.encode_image_anyres(img, tile_buckets=(5, 9))
    assert padded.shape == exact.shape
    # tiles are independent through the ViT: zero tiles change nothing
    # beyond batched-matmul summation order
    np.testing.assert_allclose(padded.numpy(), exact.numpy(), rtol=0,
                               atol=1e-5 * exact.abs().max().item())
    np.testing.assert_array_equal(ppos_b.numpy(), ppos.numpy())
    single_j = np.asarray(rt_j.encode_image_single(img))
    single_t = rt_t.encode_image_single(img).numpy()
    np.testing.assert_allclose(single_t, single_j, rtol=0,
                               atol=1e-5 * np.abs(single_j).max())


@pytest.mark.parametrize("keep_ratio", [False, True])
def test_host_copies_match_jax_package(keep_ratio):
    """The port's copies of the pure-Python host modules behave as the
    JAX package's originals."""
    from seedx_tpu.data import anyres as janyres
    from seedx_tpu.data import transforms as jtf
    from seedx_tpu.text import prompts as jprompts
    from seedx_tpu_torch.data import anyres as tanyres
    from seedx_tpu_torch.data import transforms as ttf
    from seedx_tpu_torch.text import prompts as tprompts
    from seedx_tpu_torch.text.tokenizer import load_tokenizer as tload

    tok_j, tok_t = load_tokenizer(), tload()
    text = (tprompts.multi_patch_image_string(3, 4)
            + tprompts.INSTRUCTION_PROMPT.format(instruction="Où? <loc-7>"))
    assert text == (jprompts.multi_patch_image_string(3, 4)
                    + jprompts.INSTRUCTION_PROMPT.format(
                        instruction="Où? <loc-7>"))
    ids = tok_t.encode(text, add_bos=True)
    assert ids == tok_j.encode(text, add_bos=True)
    assert tok_t.decode(ids) == tok_j.decode(ids)
    np.testing.assert_array_equal(tprompts.cmp_mask_from_ids(ids),
                                  jprompts.cmp_mask_from_ids(ids))
    assert tprompts.strip_markup(text) == jprompts.strip_markup(text)
    grids = ("1x1", "1x2", "1x3", "2x1", "3x1", "1x4", "4x1", "2x2")
    for hw in ((120, 90), (60, 200), (56, 56)):
        img = _image(*hw, seed=hw[1])
        got = tanyres.process_anyres_image(
            img, ttf.get_transform("clip", keep_ratio, 56),
            tanyres.grid_pinpoints_from_strings(grids, 56), 56)
        want = janyres.process_anyres_image(
            img, jtf.get_transform("clip", keep_ratio, 56),
            janyres.grid_pinpoints_from_strings(grids, 56), 56)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_port_imports_no_jax():
    code = ("import sys, seedx_tpu_torch, seedx_tpu_torch.inference.apps, "
            "seedx_tpu_torch.utils.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'seedx_tpu')]; "
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=env, timeout=120)
