"""The continuous engine's fused (Sarathi-style chunked) prefill in the
port, against the JAX package's fused engine and against the port's own
non-fused engine.

The port's mixed step has one layout, *packed* (slots + w real tokens a
step).  On the tiny unquantized agent, in float32 on both sides, it is
held to the JAX engine's *windowed* layout (a ``[slots, w]`` window per
step: the JAX engine packs only its int4 agent): the schedules differ,
the token streams must not.  On the tiny int4 + int8-KV agent with the
ragged attention forced on, its stair goes through the ragged kernel's
multi-query mode (its plain version here; the JAX kernel in interpret
mode), against the JAX engine's packed layout.  Those engines use a cache
of ``max(prompt_buckets) + max_new_tokens`` = 64 positions, one tile for
the JAX kernel, so both round the softmax weights against the same
maximum (see test_torch_continuous.py) and the token streams must be
equal.
"""

import types

import numpy as np
import pytest
import torch

import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference.continuous import (ContinuousEngine as
                                            JaxContinuousEngine)
from seedx_tpu.models.llama import (LlamaForCausalLM as JaxLlama,
                                    init_kv_cache as jinit_kv_cache,
                                    llama_debug as jllama_debug)
from seedx_tpu.text.tokenizer import load_tokenizer as jload_tokenizer
from seedx_tpu_torch.inference.continuous import ContinuousEngine
from seedx_tpu_torch.models.llama import (LlamaForCausalLM, init_kv_cache,
                                          llama_debug)
from seedx_tpu_torch.ops import decode_attention as tdecode
from seedx_tpu_torch.text import prompts
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.utils.convert import load_jax_params
from test_torch_slice import _numpy_tree, _tiny_int4_agents, runtimes  # noqa

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TEXTS = ["hello world", "the cat sat on the mat today",
         "one two three four five six", "abc"]
BUDGETS = [8, 3, 6, 8]
PACKED = dict(slots=2, max_new_tokens=8, chunk_steps=4,
              prompt_buckets=(24, 56), page_size=8)


@pytest.fixture(scope="module")
def int4_agents():
    mp = pytest.MonkeyPatch()
    mp.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    model_j, vars_j, agent_t = _tiny_int4_agents(ragged=True)
    rt_j = types.SimpleNamespace(agent=model_j,
                                 agent_params=vars_j["params"],
                                 agent_cfg=model_j.cfg,
                                 tokenizer=jload_tokenizer())
    rt_t = types.SimpleNamespace(agent=agent_t, agent_cfg=agent_t.cfg,
                                 tokenizer=load_tokenizer())
    yield rt_j, rt_t
    mp.undo()


def _requests(tok, texts=TEXTS):
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)} for t in texts]
    # a prompt ending in <img>: the first sampled step is forced, which
    # holds only if admission leaves the LAST PROMPT token as prev_token
    reqs.append({"input_ids": [tok.bos_token_id] + tok.encode(
        prompts.generation_prompt("a cat") + tok.vocab.BOI_TOKEN)})
    return reqs


def _drain(rt, cls=ContinuousEngine, budgets=BUDGETS + [6], **kw):
    eng = cls(rt, **kw)
    ids = [eng.submit(r, max_new_tokens=b)
           for r, b in zip(_requests(rt.tokenizer), budgets)]
    res = eng.run()
    return [[int(x) for x in res[i]["tokens"]] for i in ids], eng


def test_windowed_matches_jax_fused_engine(runtimes):  # noqa: F811
    """The port's packed mixed steps on the unquantized agent against the
    JAX engine's windowed ones: the same streams."""
    rt_j, rt_t = runtimes
    kw = dict(slots=2, max_new_tokens=8, chunk_steps=3,
              prompt_buckets=(56,), fused_prefill=True, prefill_width=4)
    want, eng_j = _drain(rt_j, JaxContinuousEngine, **kw)
    assert not eng_j._packed
    got, eng = _drain(rt_t, **kw)
    assert got == want
    st = eng.stats()
    assert st["mixed_steps"] > 0 and st["decode_steps"] > 0
    vocab = rt_t.tokenizer.vocab
    assert got[-1][0] == vocab.img_token_start   # the forced span began


def test_packed_matches_jax_fused_engine(int4_agents):
    rt_j, rt_t = int4_agents
    kw = dict(PACKED, fused_prefill=True, prefill_width=4)
    want, _ = _drain(rt_j, JaxContinuousEngine, **kw)
    stairs = []
    plain = tdecode.ragged_decode_attention_plain

    def counting(q, *a, **k):
        stairs.append(q.dim() == 4)
        return plain(q, *a, **k)

    tdecode.ragged_decode_attention_plain = counting
    try:
        got, eng = _drain(rt_t, **kw)
    finally:
        tdecode.ragged_decode_attention_plain = plain
    assert got == want
    # the mixed steps' stair went through the ragged attention's
    # multi-query mode, one call per layer and step
    n_layers = rt_t.agent_cfg.llm.num_layers
    assert sum(stairs) == n_layers * eng.stats()["mixed_steps"] > 0


@pytest.mark.parametrize("agent", ["int4", "dense"])
@pytest.mark.parametrize("width", [1, 64])
def test_fused_matches_non_fused_with_mid_flight_submit(request, agent,
                                                        width):
    """Widths 1 (a prompt trickles in one token a step) and 64 (a whole
    prompt in one step): the same streams as the bucket-prefill engine,
    with half the requests submitted while the first half runs; on the
    int4 agent and on the unquantized one (the same packed layout)."""
    _, rt_t = request.getfixturevalue(
        "int4_agents" if agent == "int4" else "runtimes")
    want, _ = _drain(rt_t, **PACKED)
    eng = ContinuousEngine(rt_t, **PACKED, fused_prefill=True,
                           prefill_width=width)
    reqs, budgets = _requests(rt_t.tokenizer), BUDGETS + [6]
    ids = [eng.submit(r, max_new_tokens=b)
           for r, b in zip(reqs[:2], budgets[:2])]
    eng.step()
    assert eng.stats()["mixed_chunks"] == 1
    ids += [eng.submit(r, max_new_tokens=b)
            for r, b in zip(reqs[2:], budgets[2:])]
    res = eng.run()
    assert [[int(x) for x in res[i]["tokens"]] for i in ids] == want


def test_fused_paged_equals_fused_dense(int4_agents):
    _, rt_t = int4_agents
    kw = dict(PACKED, fused_prefill=True, prefill_width=4)
    dense, _ = _drain(rt_t, **kw)
    paged, eng = _drain(rt_t, paged=True, **kw)
    assert paged == dense
    st = eng.stats()
    assert st["kv_tiles_free"] == st["kv_tiles_total"]   # all pages back
    assert not eng.state["tables"].any()


def test_packed_budget_contention(int4_agents):
    """Several rows prefilling at once share the step's prompt budget in
    row order; after every chunk the host's replay must equal the device's
    ``p_len - p_pos`` (a divergence would strand a row mid-prompt in the
    pure-decode chunk)."""
    _, rt_t = int4_agents
    tok = rt_t.tokenizer
    texts = ["one two three four five six seven eight",
             "the quick brown fox jumps over the dog", "tiny"]
    budgets = [4, 4, 6]
    for w in (2, 4):
        eng = ContinuousEngine(rt_t, slots=3, max_new_tokens=8,
                               chunk_steps=3, prompt_buckets=(56,),
                               fused_prefill=True, prefill_width=w)
        ids = [eng.submit({"input_ids": [tok.bos_token_id] + tok.encode(t)},
                          max_new_tokens=b) for t, b in zip(texts, budgets)]
        saw_contention = False
        for _ in range(64):
            eng.step()
            dev_rem = (eng.state["p_len"] - eng.state["p_pos"]).tolist()
            live = [i for i, rid in enumerate(eng._slot_req)
                    if rid is not None]
            host = [eng._prefill_remaining[i] for i in live]
            assert host == [max(0, dev_rem[i]) for i in live], (w, host)
            saw_contention |= sum(r > 0 for r in host) >= 2
            if len(eng._results) == 3:
                break
        assert saw_contention
        results = eng.run()
        assert eng._prefill_remaining == [0] * 3
        for rid, b in zip(ids, budgets):
            assert 0 < len(results[rid]["tokens"]) <= b


def test_window_write_drops_slots_past_the_width():
    """Slots past a row's width are dropped, never clamped onto the cache
    tail: a clamp would corrupt a row's last cell exactly when another
    row's real write lands there (tests/test_fused_prefill.py:223-257).
    The written cells equal the JAX package's."""
    cfg_kw = dict(hidden_size=64, intermediate_size=128, num_layers=1,
                  num_heads=2, num_kv_heads=2)
    model_j = JaxLlama(jllama_debug(dtype=jnp.float32, **cfg_kw))
    b, w, s_max = 2, 4, 8
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((b, w), jnp.int32),
                          jnp.zeros((b, w), jnp.int32),
                          method="init_all")["params"]
    model_t = load_jax_params(
        LlamaForCausalLM(llama_debug(dtype=torch.float32, **cfg_kw)).eval(),
        _numpy_tree(params))
    offs, widths = np.array([5, 0]), np.array([3, 2])
    embeds = np.random.default_rng(1).standard_normal((b, w, 64)).astype(
        np.float32)
    positions = offs[:, None] + np.arange(w)[None, :]
    _, _, cache_j = model_j.apply(
        {"params": params}, jnp.asarray(embeds), jnp.asarray(positions),
        None, jinit_kv_cache(model_j.cfg, b, s_max),
        jnp.asarray(offs, jnp.int32), write_widths=jnp.asarray(widths))
    cache_t = init_kv_cache(model_t.cfg, b, s_max, dtype=torch.float32)
    with torch.no_grad():
        model_t(torch.from_numpy(embeds), torch.from_numpy(positions), None,
                cache_t, torch.from_numpy(offs),
                write_widths=torch.from_numpy(widths))
    k = cache_t[0].numpy()                              # [L, b, s_max, f]
    assert np.abs(k[0, 0, 5:8]).sum() > 0 and np.abs(k[0, 0, :5]).sum() == 0
    assert np.abs(k[0, 1, :2]).sum() > 0 and np.abs(k[0, 1, 2:]).sum() == 0
    for got, want in zip(cache_t, cache_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
