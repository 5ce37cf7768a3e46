"""Multi-turn chat with the KV prefix cache (``seedx_tpu_torch/inference/
chat.py``) against the JAX package's ``ChatSession`` on the same weights,
and the session's own rules (tests/test_chat.py): the prefix-cached replies
equal a full re-prefill's, reuse stops before a generated image span,
the cache regrows, a generated span is upsampled as ``jax.image.resize``
does.  Float32 configs on both sides (the algorithm is the point).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.inference.chat import ChatSession as JaxChatSession
from seedx_tpu.inference.chat import Turn as JaxTurn
from seedx_tpu_torch.inference.chat import ChatSession, Turn
from test_torch_slice import _image, runtimes  # noqa: F401

torch.set_num_threads(1)

SENDS = [("describe", True), ("more detail", False), ("and now?", False)]


def test_three_turns_match_jax_and_full_prefill(runtimes):  # noqa: F811
    """Three turns, an image in the first: the port's prefix-cached
    session gives the JAX session's replies and reuses the same prefix
    lengths, and the port's full-prefill session gives the same replies."""
    rt_j, rt_t = runtimes
    img = _image(64, 48, seed=5)
    jax_s = JaxChatSession(rt_j, prefix_cache=True, cache_capacity=512)
    cached = ChatSession(rt_t, prefix_cache=True, cache_capacity=512)
    full = ChatSession(rt_t, prefix_cache=False)
    for i, (text, with_img) in enumerate(SENDS):
        im = img if with_img else None
        want = jax_s.send(text, image=im, max_new_tokens=5)
        got = cached.send(text, image=im, max_new_tokens=5)
        ref = full.send(text, image=im, max_new_tokens=5)
        assert got["text"] == want["text"] == ref["text"], i
        assert got["num_gen_imgs"] == want["num_gen_imgs"]
        assert got["images"] is None
        assert cached.last_reused == jax_s.last_reused, i
        if i:
            assert cached.last_reused > 0, i     # a delta prefill
            assert cached.last_prefill_tokens < full.last_prefill_tokens
    assert cached._cached_ids == jax_s._cached_ids
    assert cached._cached_cmp == jax_s._cached_cmp
    assert len(cached.turns) == len(full.turns) == 6


def test_build_prompt_matches_jax(runtimes):  # noqa: F811
    rt_j, rt_t = runtimes
    turns = [("user", "hi", 0), ("assistant", "hello", 0),
             ("user", "again", 2), ("assistant", "", 1)]
    a = ChatSession(rt_t, system_message="sys")
    b = JaxChatSession(rt_j, system_message="sys")
    a.turns = [Turn(*t) for t in turns]
    b.turns = [JaxTurn(*t) for t in turns]
    assert a._build_prompt() == b._build_prompt()
    assert a._build_prompt().startswith("sys\n[INST] hi [/INST]\n")


def test_add_generated_matches_jax_resize(runtimes):  # noqa: F811
    """The 2-D bilinear upsample of a generated span onto the context token
    grid, against ``jax.image.resize`` (half-pixel centers)."""
    rt_j, rt_t = runtimes
    nq, d = rt_t.vit_cfg.n_queries, rt_t.agent_cfg.vit_dim
    feat = np.random.default_rng(4).standard_normal(
        (1, nq // 4, d)).astype(np.float32)
    a = ChatSession(rt_t)
    b = JaxChatSession(rt_j)
    assert a._add_generated(torch.from_numpy(feat)) == 1
    b._add_generated(jnp.asarray(feat))
    got, want = a._image_embeds[-1], np.asarray(b._image_embeds[-1])
    assert tuple(got.shape) == want.shape == (1, nq, d)
    # fp32 weights of 1/4 and 3/4: the two differ in summation order only
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a._patch_positions[-1].numpy(),
                                  np.asarray(b._patch_positions[-1]))
    same = torch.ones((1, nq, d))
    a._add_generated(same)                    # already on the grid: as is
    assert torch.equal(a._image_embeds[-1], same)


def test_prefix_cache_reembeds_generated_image_spans(runtimes):  # noqa: F811
    """A reply with an image span writes the span's KV from token-id
    embeddings during decode; the next turn's history is token-identical
    through the span but must re-embed it with the image's features, so
    reuse stops at the span (tests/test_chat.py:86-130)."""
    _, rt_t = runtimes
    a = ChatSession(rt_t, prefix_cache=True, cache_capacity=1024)
    b = ChatSession(rt_t, prefix_cache=False)
    assert a.send("hi", max_new_tokens=4)["text"] == b.send(
        "hi", max_new_tokens=4)["text"]
    feat = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, rt_t.agent_cfg.num_img_out_tokens,
         rt_t.agent_cfg.vit_dim)).astype(np.float32))
    for s in (a, b):
        s._add_generated(feat)
        s.turns[-1] = Turn("assistant", "", 1)
    # fill a's cache for the span as decode would have: from token-id
    # embeddings, then record it as decode-produced
    tok = rt_t.tokenizer
    ids = [tok.bos_token_id] + tok.encode(a._build_prompt())
    a._generate_cached(ids, None, None, None, max_new_tokens=1)
    a._cached_ids, a._cached_cmp = list(ids), [False] * len(ids)
    ra = a.send("what about it?", max_new_tokens=5)
    rb = b.send("what about it?", max_new_tokens=5)
    assert ra["text"] == rb["text"]
    assert 0 < a.last_reused <= ids.index(tok.vocab.boi) + 1


def test_prefix_cache_capacity_regrow(runtimes):  # noqa: F811
    """A turn past the cache's capacity rebuilds it (a full prefill) with
    the same replies."""
    _, rt_t = runtimes
    a = ChatSession(rt_t, prefix_cache=True, cache_capacity=64)
    b = ChatSession(rt_t, prefix_cache=False)
    caps = []
    for text in ("hi", "word " * 40):
        assert a.send(text, max_new_tokens=4)["text"] == b.send(
            text, max_new_tokens=4)["text"]
        caps.append(a._cache[0].shape[2])
    assert caps[0] == 128 and caps[1] > caps[0]
    assert a.last_reused == 0               # the regrown cache was fresh


def test_speculative_chat_matches_jax(runtimes):  # noqa: F811
    """Three prefix-cached turns with ``spec_k=4`` (an image in the first)
    against the JAX session's: the same replies, prefix reuse and cache
    capacity (the headroom rule: the prompt, the reply budget and the
    draft length), and the port's greedy replies; the session's decode
    state speculates over a history the cache's length."""
    rt_j, rt_t = runtimes
    img = _image(64, 48, seed=5)
    jax_s = JaxChatSession(rt_j, prefix_cache=True, cache_capacity=64)
    spec = ChatSession(rt_t, prefix_cache=True, cache_capacity=64)
    plain = ChatSession(rt_t, prefix_cache=True, cache_capacity=64)
    for i, (text, with_img) in enumerate(SENDS):
        im = img if with_img else None
        want = jax_s.send(text, image=im, max_new_tokens=6, spec_k=4)
        got = spec.send(text, image=im, max_new_tokens=6, spec_k=4)
        ref = plain.send(text, image=im, max_new_tokens=6)
        assert got["text"] == want["text"] == ref["text"], i
        assert spec.last_reused == jax_s.last_reused, i
        cap = spec._cache[0].shape[2]
        assert cap == jax_s._cache[0].shape[2], i
        prompt = len(spec._cached_ids) - len(got["tokens"])
        assert cap >= prompt + 6 + 4 and cap % 128 == 0
        assert spec._decode.spec_k == 4
        assert spec._decode.hist.shape == (cap,)
        assert plain._decode.spec_k == 0 and plain._decode.hist is None
    assert spec._cached_ids == jax_s._cached_ids
    assert int(spec._decode.sp[0]) > 0          # the last turn's rounds
