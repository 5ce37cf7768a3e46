"""Beam search in the port (``seedx_tpu_torch/models/generation.py``:
``generate_tokens_beam``, one captured ``beam_step`` replayed, and
``_backtrack_beam``) against the JAX package's and against
``transformers``' ``LlamaForCausalLM.generate(num_beams=3)``.

The tiny int4 + int8-KV agent of ``tests/test_torch_slice.py`` (ragged
attention forced on, float32 compute, the same weights on both sides).
Tokens and parents must equal JAX's.  The beams' scores (sums of six
fp32 log-softmax values over the 32330-id vocabulary, ~-57) lie within
``SCORE_REL`` of their magnitude (6.3e-5 measured), the image features of
the winning beam within ``FEAT_REL`` of theirs (2.7e-3 measured): int4
W4A8 and int8 KV codes flip on a rounding edge between the two packages'
summation orders, and a beam step reads each row's re-gathered cache
through the JAX package's stacked decode kernel on one side and the
ragged kernel's plain version on the other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from seedx_tpu.models import agent as jagent
from seedx_tpu.models import generation as jgen
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.models.llama import llama_debug as tllama_debug
from seedx_tpu_torch.utils.convert import load_jax_params
from test_torch_spec_decode import (BUCKET, N_IMG, TOK, VOCAB,  # noqa
                                    _cfgs, agents)

torch.set_num_threads(1)

SCORE_REL = 1e-4
FEAT_REL = 5e-3


def _prompt(agents, ids):
    """(JAX, port) embeds, mask and last token of one left-padded prompt."""
    model_j, vars_j, agent_t = agents
    pad = BUCKET[0] - len(ids)
    ids_p = np.asarray([[TOK.pad_token_id] * pad + ids])
    mask = np.asarray([[False] * pad + [True] * len(ids)])
    emb_j = model_j.apply(vars_j, jnp.asarray(ids_p, jnp.int32),
                          method="embed_ids")
    with torch.no_grad():
        emb_t = agent_t.embed_ids(torch.from_numpy(ids_p))
    return ((emb_j, jnp.asarray(mask), jnp.asarray([ids[-1]], jnp.int32)),
            (emb_t, torch.from_numpy(mask), torch.tensor([ids[-1]])))


def _batch(agents, texts):
    """The same for several prompts (batch rows)."""
    parts = [_prompt(agents, [TOK.bos_token_id] + TOK.encode(t))
             for t in texts]
    j = tuple(jnp.concatenate([p[0][i] for p in parts]) for i in range(3))
    t = tuple(torch.cat([p[1][i] for p in parts]) for i in range(3))
    return j, t


def _beams(agents, prompt, **kw):
    model_j, vars_j, agent_t = agents
    cfg_j, cfg_t = _cfgs(**kw)
    want = jgen.generate_tokens_beam(model_j, vars_j, *prompt[0], cfg_j,
                                     VOCAB)
    got = tgen.generate_tokens_beam(agent_t, *prompt[1], cfg_t, VOCAB)
    return got, want, cfg_t


def test_beam_k1_matches_greedy(agents):
    """One beam is the greedy stream, and its hidden states are the
    greedy loop's."""
    ids = [TOK.bos_token_id] + TOK.encode("the quick brown")
    prompt = _prompt(agents, ids)
    got, want, cfg = _beams(agents, prompt, max_new_tokens=6, num_beams=1)
    seq, hidden, best = tgen._backtrack_beam(got, cfg, 0)
    greedy = tgen.generate_tokens(agents[2], *prompt[1], cfg, VOCAB)
    assert list(seq) == greedy["tokens"][0].tolist()
    assert best == 0
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    hid = greedy["hidden"][0]
    torch.testing.assert_close(hidden, hid, rtol=0,
                               atol=1e-5 * float(hid.abs().max()))


@pytest.mark.parametrize("texts", [("hello",), ("hello", "abc abc")])
def test_beam_k4_matches_jax(agents, texts):
    """K 4 at B 1 and B 2: the joint top-k's tokens and parents equal
    JAX's at every step, the scores within ``SCORE_REL``, and the
    backtracked winners equal."""
    prompt = _batch(agents, texts)
    got, want, cfg = _beams(agents, prompt, max_new_tokens=6, num_beams=4)
    for key in ("tokens", "parents", "finished"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    scores_j = np.asarray(want["scores"])
    np.testing.assert_allclose(got["scores"].numpy(), scores_j, rtol=0,
                               atol=SCORE_REL * np.abs(scores_j).max())
    assert got["hidden"].shape == (6, 4 * len(texts), 128)
    for i in range(len(texts)):
        seq, _, best = tgen._backtrack_beam(got, cfg, i)
        seq_j, _, best_j = jgen._backtrack_beam(want, _cfgs()[0], i)
        assert list(seq) == [int(x) for x in seq_j] and best == best_j
    # the best beam's score beats the greedy path's (one beam)
    one, _, _ = _beams(agents, prompt, max_new_tokens=6, num_beams=1)
    assert float(got["scores"].max()) >= float(one["scores"].max()) - 1e-4


def test_beam_forced_image_span_k3(agents):
    """A prompt ending in ``<img>``: the constrainer forces the span on
    every beam; ``generate_batch`` with 3 beams gives JAX's tokens, text
    and (within ``FEAT_REL``) image features."""
    model_j, vars_j, agent_t = agents
    ids = [TOK.bos_token_id] + TOK.encode("make an image: ") + [VOCAB.boi]
    kw = dict(max_new_tokens=N_IMG + 2, num_img_gen_tokens=N_IMG,
              num_beams=3)
    cfg_j, cfg_t = _cfgs(**kw)
    want = jgen.generate(model_j, vars_j, TOK, ids, gen_cfg=cfg_j)
    got = tgen.generate(agent_t, TOK, ids, gen_cfg=cfg_t)
    assert [int(x) for x in got["tokens"]] == \
        [int(x) for x in want["tokens"]]
    assert list(got["tokens"][:N_IMG + 1]) == [
        VOCAB.img_token_id(i) for i in range(N_IMG)] + [VOCAB.eoi]
    assert got["text"] == want["text"] and got["has_img_output"]
    assert "spec_rounds" not in got
    feat_j = np.asarray(want["img_gen_feat"])
    np.testing.assert_allclose(got["img_gen_feat"].numpy(), feat_j, rtol=0,
                               atol=FEAT_REL * np.abs(feat_j).max())


def test_generate_batch_beams_match_jax(agents):
    """``generate_batch`` with 4 beams over two prompts: JAX's results."""
    model_j, vars_j, agent_t = agents
    reqs = [{"input_ids": [TOK.bos_token_id] + TOK.encode("hello world")},
            {"input_ids": [TOK.bos_token_id] + TOK.encode("abc abc abc")}]
    cfg_j, cfg_t = _cfgs(max_new_tokens=8, num_beams=4)
    want = jgen.generate_batch(model_j, vars_j, TOK, reqs, gen_cfg=cfg_j)
    got = tgen.generate_batch(agent_t, TOK, reqs, gen_cfg=cfg_t)
    for g, w in zip(got, want):
        assert [int(x) for x in g["tokens"]] == \
            [int(x) for x in w["tokens"]]
        assert g["text"] == w["text"]


BACKTRACK_CASES = {
    # T 4, K 3: slot 1 ends in EOS at step 1 (length 2 beats the others
    # under the length penalty), slot 0 has the best raw score
    "eos_shortens": (
        [[5, 6, 7], [8, 2, 9], [0, 0, 10], [0, 0, 11]],
        [[0, 0, 0], [0, 1, 2], [0, 1, 1], [0, 1, 2]],
        [-3.0, -2.5, -3.5], 1.0),
    # no length penalty: the raw best score wins
    "raw_scores": (
        [[5, 6, 7], [8, 2, 9], [0, 0, 10], [0, 0, 11]],
        [[0, 0, 0], [0, 1, 2], [0, 1, 1], [0, 1, 2]],
        [-3.0, -2.5, -3.5], 0.0),
    # parents cross over: every final slot descends from slot 2
    "crossing_parents": (
        [[1, 3, 4], [5, 6, 7], [8, 9, 12]],
        [[0, 0, 0], [2, 2, 2], [1, 0, 2]],
        [-1.0, -0.5, -0.75], 1.0),
}


@pytest.mark.parametrize("case", sorted(BACKTRACK_CASES))
def test_backtrack_beam_matches_jax(case):
    """Hand-made parents: the winner, its chain and its hidden-state rows
    equal JAX's."""
    tokens, parents, scores, alpha = BACKTRACK_CASES[case]
    t, k = len(tokens), len(tokens[0])
    hidden = np.arange(t * k * 2, dtype=np.float32).reshape(t, k, 2)
    out = {"tokens": np.asarray(tokens)[:, None],
           "parents": np.asarray(parents)[:, None],
           "scores": np.asarray(scores, np.float32)[None],
           "hidden": hidden}
    cfg_j = jgen.GenerationConfig(length_penalty=alpha)
    cfg_t = tgen.GenerationConfig(length_penalty=alpha)
    seq_j, hid_j, best_j = jgen._backtrack_beam(
        {**out, "hidden": jnp.asarray(hidden)}, cfg_j)
    seq, hid, best = tgen._backtrack_beam(
        {k_: torch.from_numpy(v) for k_, v in out.items()}, cfg_t)
    assert best == best_j
    assert list(seq) == [int(x) for x in seq_j]
    np.testing.assert_array_equal(hid.numpy(), np.asarray(hid_j))


def test_beam_search_matches_transformers_generate():
    """Beam search (3 beams, length penalty 1) against ``transformers``'
    ``LlamaForCausalLM.generate`` on the same weights (converted by the
    JAX package's ``convert_llama_hf`` and loaded into the port's agent):
    token-exact, as tests/test_llama_parity.py holds the JAX package."""
    from transformers import LlamaConfig as HFConfig
    from transformers.models.llama.modeling_llama import \
        LlamaForCausalLM as HFLlama

    from seedx_tpu.models.llama import llama_debug as jllama_debug
    from seedx_tpu.utils.weights import convert_llama_hf

    torch.manual_seed(0)
    hf = HFLlama(HFConfig(
        vocab_size=500, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        attn_implementation="eager", tie_word_embeddings=False)).eval()
    llm = dict(vocab_size=500, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=4)
    agent_kw = dict(vit_dim=16, resampler_heads=2, num_img_in_tokens=4,
                    num_img_out_tokens=4, vit_down=False)
    model_j = jagent.ContinuousLVLM(jagent.AgentConfig(
        llm=jllama_debug(dtype=jnp.float32, param_dtype=jnp.float32,
                         **llm), **agent_kw))
    av = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                      jnp.ones((1, 8), bool), jnp.zeros((1, 8), jnp.int32),
                      jnp.zeros((1, 4, 16), jnp.float32),
                      jnp.zeros((1,), bool), jnp.zeros((1,), bool),
                      jnp.zeros((1, 8), bool), jnp.zeros((1, 8), bool),
                      jnp.full((1, 2), 0.5), method="init_all")
    params = jax.tree.map(np.asarray, nn.meta.unbox(av["params"]))
    params["llm"] = jax.tree.map(np.asarray, convert_llama_hf(
        dict(hf.state_dict()), num_layers=2, vocab_size=500))
    agent_t = load_jax_params(tagent.ContinuousLVLM(tagent.AgentConfig(
        llm=tllama_debug(dtype=torch.float32, **llm), dtype=torch.float32,
        **agent_kw)).eval(), params)
    cfg = tgen.GenerationConfig(max_new_tokens=8, num_beams=3,
                                num_img_gen_tokens=4, eos_token_id=2,
                                pad_token_id=0)
    for ids in ([1, 17, 42, 99, 7], [1, 3, 250, 111]):
        with torch.no_grad():
            ref = hf.generate(torch.tensor([ids]), max_new_tokens=8,
                              num_beams=3, do_sample=False,
                              length_penalty=1.0,
                              early_stopping=False)[0].tolist()[len(ids):]
        res = tgen.generate_batch(agent_t, TOK, [{"input_ids": ids}],
                                  gen_cfg=cfg)[0]
        assert [int(x) for x in res["tokens"]] == ref, ids
