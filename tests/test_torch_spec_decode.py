"""n-gram speculative decoding, its adaptive gate and ``script_ids``
forcing in the port (``seedx_tpu_torch/models/generation.py``:
``spec_step`` and the gate's mode windows of ``_decode_loop``) against the
JAX package's ``generate`` / ``generate_tokens`` / ``generate_tokens_cached``,
case for case with ``tests/test_spec_decode.py``.

The tiny int4 + int8-KV agent of ``tests/test_torch_slice.py`` with the
ragged attention forced on, float32 compute, the same weights on both
sides.  Emitted tokens and the counters ``spec_rounds`` /
``spec_accepted`` must equal JAX's exactly; hidden-state features within
``FEAT_REL`` of their magnitude (int4 W4A8 and int8 KV codes flip on a
rounding edge between the two packages' summation orders, see
``tests/test_torch_decode_program.py``).  Here, on the CPU, the verify
step runs eagerly; the captured replays are held to it bit for bit on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import seedx_tpu.ops.int4_matmul
from seedx_tpu.models import agent as jagent
from seedx_tpu.models import generation as jgen
from seedx_tpu.models.llama import init_kv_cache as jinit_kv_cache
from seedx_tpu.models.llama import llama_debug as jllama_debug
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.models.llama import init_kv_cache
from seedx_tpu_torch.models.llama import llama_debug as tllama_debug
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.utils.convert import load_jax_params
from test_torch_slice import _numpy_tree, _tiny_int4_agents

torch.set_num_threads(1)

TOK = load_tokenizer()
VOCAB = TOK.vocab
N_IMG = 64                 # the tiny agent's output span
FEAT_REL = 2e-3            # img_gen_feat, of its magnitude
BUCKET = (128,)


@pytest.fixture(scope="module")
def agents():
    mp = pytest.MonkeyPatch()
    mp.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    yield _tiny_int4_agents(ragged=True)
    mp.undo()


@pytest.fixture(scope="module")
def f32_agents():
    """The same tiny agent unquantized (fp32 weights and KV cache; the
    port's ragged attention forced on), for the cached engine: with int8
    KV codes the JAX package's verify forward (XLA attention over the
    dequantized cache) and its one-token step (its ragged kernel) part at
    rounding ties (the second turn's token 1 below: logits 0.7549 and
    0.7535), so JAX's spec stream leaves JAX's greedy one there while the
    port's stays on it."""
    kw = dict(hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=4)
    cfg_j = jagent.AgentConfig(llm=jllama_debug(dtype=jnp.float32, **kw),
                               vit_dim=64, resampler_heads=4,
                               dtype=jnp.float32)
    model = jagent.ContinuousLVLM(cfg_j)
    ids = jnp.zeros((1, 80), jnp.int32)
    attn = jnp.ones((1, 80), bool)
    idsm = jnp.zeros((1, 80), bool).at[0, 1:65].set(True)
    params = _numpy_tree(model.init(
        jax.random.PRNGKey(1), ids, attn, jnp.where(attn, ids, -100),
        jnp.zeros((1, 256, 64), jnp.float32), jnp.zeros((1,), bool),
        jnp.zeros((1,), bool), idsm, idsm, jnp.full((1, 2), 0.5),
        method="init_all")["params"])
    cfg_t = tagent.AgentConfig(
        llm=tllama_debug(dtype=torch.float32, decode_attention="force",
                         **kw),
        vit_dim=64, resampler_heads=4, dtype=torch.float32)
    agent_t = load_jax_params(tagent.ContinuousLVLM(cfg_t).eval(), params)
    return model, {"params": params}, agent_t


def _cfgs(**kw):
    kw = {"num_img_gen_tokens": 4, "prompt_buckets": BUCKET, **kw}
    return jgen.GenerationConfig(**kw), tgen.GenerationConfig(**kw)


def _generate(agents, ids, **kw):
    """(port, JAX) ``generate`` results for one prompt."""
    model_j, vars_j, agent_t = agents
    want = jgen.generate(model_j, vars_j, TOK, ids, gen_cfg=_cfgs(**kw)[0])
    return _port(agents, ids, **kw), want


def _port(agents, ids, **kw):
    """The port's ``generate`` result for one prompt."""
    return tgen.generate(agents[2], TOK, ids, gen_cfg=_cfgs(**kw)[1])


def _same(got, want, counters=True):
    assert [int(x) for x in got["tokens"]] == \
        [int(x) for x in want["tokens"]]
    assert got["text"] == want["text"]
    if counters:
        assert got["spec_rounds"] == int(want["spec_rounds"])
        assert got["spec_accepted"] == int(want["spec_accepted"])


ECHO = "the cat sat on the mat. the cat sat on the mat. the cat"


# ---- _ngram_draft, the gate and the script forcing ------------------------

DRAFT_CASES = {
    # ... 5 6 7 8 9 ... 5 6 | token0 = 7 -> drafts 8 9 2
    "previous_continuation": ([1, 5, 6, 7, 8, 9, 2, 3, 5, 6, -1, -1, -1, -1],
                              10, 7, 3, 3, [8, 9, 2]),
    # a 4-gram (2, 3, 4, token0 = 5) must match at all four positions
    "higher_order": ([9, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, -1, -1, -1],
                     11, 5, 2, 4, [6, 7]),
    "higher_order_broken": ([9, 9, 3, 4, 5, 6, 7, 1, 2, 3, 4, -1, -1, -1],
                            11, 5, 2, 4, [-1, -1]),
    "no_match": ([1, 2, 3, 4, -1, -1], 4, 9, 2, 3, [-1, -1]),
    # the only bigram match lies in the unfilled region (j >= m)
    "ignores_unfilled_region": ([1, 2, 3, 7, 2, 3, -1, -1], 4, 3, 2, 2,
                                [-1, -1]),
    # a match near the end: the window start clips to L - k
    "start_clipped": ([4, 5, 6, 4, 5, -1], 5, 6, 3, 3, [4, 5, -1]),
}


@pytest.mark.parametrize("case", sorted(DRAFT_CASES))
def test_ngram_draft_matches_jax(case):
    hist, m, token0, k, ngram, expect = DRAFT_CASES[case]
    got = tgen._ngram_draft(torch.tensor(hist), torch.tensor(m),
                            torch.tensor(token0), k, ngram)
    want = jgen._ngram_draft(jnp.asarray(hist, jnp.int32), m,
                             jnp.int32(token0), k, ngram)
    assert got.tolist() == np.asarray(want).tolist() == expect


def test_ngram_draft_rejects_unigrams():
    with pytest.raises(ValueError):
        tgen._ngram_draft(torch.tensor([1, 2, 3]), 2, torch.tensor(1), 1, 1)


GATE_CFGS = [dict(), dict(spec_adaptive=False),
             dict(spec_probe_rounds=2, spec_min_accept=1.5, spec_reprobe=5,
                  spec_window=6)]


@pytest.mark.parametrize("ci", range(len(GATE_CFGS)))
def test_gate_update_and_cooldown_match_jax(ci):
    """A random walk of rounds (accepted 0..4) and plain steps through the
    gate: the port's [6] state equals JAX's tuple at every step."""
    cfg_j, cfg_t = _cfgs(spec_k=4, **GATE_CFGS[ci])
    rng = np.random.default_rng(ci)
    sp_j = (jnp.int32(0),) * 5 + (jnp.bool_(True),)
    sp_t = torch.tensor([0, 0, 0, 0, 0, 1])
    for _ in range(200):
        if bool(sp_j[5]):
            a = int(rng.integers(0, 5)) if rng.random() < 0.6 else 0
            sp_j = jgen._spec_gate_update(sp_j, jnp.int32(a), cfg_j)
            sp_t = tgen._spec_gate_update(sp_t, torch.tensor(a), cfg_t)
        else:
            sp_j = jgen._spec_cooldown_tick(sp_j)
            sp_t = tgen._spec_cooldown_tick(sp_t)
        assert sp_t.tolist() == [int(x) for x in sp_j]


def test_force_script_matches_jax():
    rng = np.random.default_rng(3)
    t = 6
    script = rng.integers(3, 500, size=(t,))
    logits = rng.standard_normal((4, 500)).astype(np.float32)
    pos = np.array([0, 5, 6, 9])            # the last two past t: untouched
    got = tgen._force_script(torch.from_numpy(logits), torch.from_numpy(pos),
                             torch.from_numpy(script), t)
    want = jgen_force_script(logits, pos, script, t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:2].argmax(-1).tolist() == [script[0], script[5]]


def jgen_force_script(logits, pos, script, t):
    """The JAX package's ``_force_script`` (a closure of generate_tokens),
    written out with jnp as there (generation.py:288-297)."""
    tokw = jnp.asarray(script)[jnp.clip(jnp.asarray(pos), 0, t - 1)]
    lg = jnp.asarray(logits)
    win = jnp.max(lg, axis=-1, keepdims=True) + 10.0
    forced = jnp.where(jax.nn.one_hot(tokw, lg.shape[-1], dtype=bool), win,
                       jnp.asarray(-1e9, lg.dtype))
    return np.asarray(jnp.where((jnp.asarray(pos) < t)[:, None], forced, lg))


# ---- generate: text, the image span, draft lengths -------------------------

def test_spec_decode_matches_jax_text(agents):
    """Repetitive prompt: token-exact against JAX's spec run and the plain
    greedy stream, with JAX's counters."""
    ids = [TOK.bos_token_id] + TOK.encode(ECHO)
    got, want = _generate(agents, ids, max_new_tokens=24, spec_k=4)
    _same(got, want)
    plain = _port(agents, ids, max_new_tokens=24)
    assert list(plain["tokens"]) == list(got["tokens"])
    assert plain["spec_rounds"] == plain["spec_accepted"] == 0
    assert got["spec_rounds"] > 0


def test_spec_decode_matches_jax_image_span(agents):
    """A prompt ending in ``<img>``: the spec round hands over to the
    forced chunk, and the span's features stay aligned."""
    ids = [TOK.bos_token_id] + TOK.encode("make an image: ") + [VOCAB.boi]
    kw = dict(max_new_tokens=N_IMG + 2, num_img_gen_tokens=N_IMG)
    got, want = _generate(agents, ids, spec_k=3, **kw)
    _same(got, want)
    plain = _port(agents, ids, **kw)
    assert list(plain["tokens"]) == list(got["tokens"])
    assert list(got["tokens"][:N_IMG]) == [VOCAB.img_token_id(i)
                                           for i in range(N_IMG)]
    assert got["has_img_output"] and want["has_img_output"]
    feat_j = np.asarray(want["img_gen_feat"])
    np.testing.assert_allclose(got["img_gen_feat"].numpy(), feat_j, rtol=0,
                               atol=FEAT_REL * np.abs(feat_j).max())
    # the same arithmetic as the plain loop: bit-equal features
    assert torch.equal(got["img_gen_feat"], plain["img_gen_feat"])


@pytest.mark.parametrize("k", [1, 2, 8])
def test_spec_decode_various_k(agents, k):
    ids = [TOK.bos_token_id] + TOK.encode("abc abc abc ab")
    got, want = _generate(agents, ids, max_new_tokens=12, spec_k=k)
    _same(got, want)
    plain = _port(agents, ids, max_new_tokens=12)
    assert list(plain["tokens"]) == list(got["tokens"])


def test_spec_decode_disabled_for_batch(agents):
    """spec_k silently no-ops at B > 1: the same tokens as JAX's and as
    the plain batch, no rounds."""
    model_j, vars_j, agent_t = agents
    reqs = [{"input_ids": [TOK.bos_token_id] + TOK.encode("hello world")},
            {"input_ids": [TOK.bos_token_id] + TOK.encode("abc abc abc")}]
    cfg_j, cfg_t = _cfgs(max_new_tokens=8, spec_k=4)
    want = jgen.generate_batch(model_j, vars_j, TOK, reqs, gen_cfg=cfg_j)
    got = tgen.generate_batch(agent_t, TOK, reqs, gen_cfg=cfg_t)
    plain = tgen.generate_batch(agent_t, TOK, reqs,
                                gen_cfg=_cfgs(max_new_tokens=8)[1])
    for g, w, p in zip(got, want, plain):
        _same(g, w)
        assert list(g["tokens"]) == list(p["tokens"])
        assert g["spec_rounds"] == 0


def test_spec_decode_disabled_for_sampling(agents):
    """spec_k with sampling: the same draws as without it, no rounds."""
    _, _, agent_t = agents
    ids = [TOK.bos_token_id] + TOK.encode(ECHO)
    outs = []
    for k in (0, 4):
        cfg = _cfgs(max_new_tokens=10, do_sample=True, temperature=1.0,
                    top_p=0.95, spec_k=k)[1]
        outs.append(tgen.generate(agent_t, TOK, ids, gen_cfg=cfg,
                                  generator=torch.Generator().manual_seed(5)))
    assert list(outs[0]["tokens"]) == list(outs[1]["tokens"])
    assert outs[1]["spec_rounds"] == 0


# ---- the cached (chat) engine ----------------------------------------------

def _cached_turns(agents, spec_k, port: bool):
    """Two prefix-cached turns (the first ending in ``<img>``, the second
    reusing its prefix), as tests/test_spec_decode.py runs them."""
    model_j, vars_j, agent_t = agents
    n, cap, sb = 4, 256, 32
    cfg_j, cfg_t = _cfgs(max_new_tokens=n + 3, num_img_gen_tokens=n,
                         spec_k=spec_k)
    cache = (init_kv_cache(agent_t.cfg.llm, 1, cap) if port
             else jinit_kv_cache(model_j.cfg.llm, 1, cap))
    ids = [TOK.bos_token_id] + TOK.encode("make: ") + [VOCAB.boi]
    start, outs = 0, []
    for turn in range(2):
        delta = ids[start:]
        padded = np.zeros((1, sb), np.int64)
        padded[0, :len(delta)] = delta
        hist = np.full((cap,), -1, np.int64)
        hist[:len(ids)] = ids
        if port:
            emb = agent_t.embed_ids(torch.from_numpy(padded))
            out, cache, total = tgen.generate_tokens_cached(
                agent_t, cache, emb, start, len(delta), ids[-1], cfg_t,
                VOCAB, hist_ids=torch.from_numpy(hist) if spec_k else None)
        else:
            emb = model_j.apply(vars_j, jnp.asarray(padded, jnp.int32),
                                method="embed_ids")
            out, cache, total = jgen.generate_tokens_cached(
                model_j, vars_j, cache, emb, jnp.int32(start),
                jnp.int32(len(delta)), jnp.int32(ids[-1]),
                jax.random.PRNGKey(0), cfg_j, VOCAB,
                hist_ids=jnp.asarray(hist, jnp.int32) if spec_k else None)
        tokens = [int(x) for x in np.asarray(out["tokens"][0])]
        outs.append((tokens, int(out["spec_rounds"]),
                     int(out["spec_accepted"]), int(total)))
        if turn == 0:
            start = len(ids)
            ids = ids + tokens[:int(total) - len(ids)] + TOK.encode(" more")
    return outs


def test_cached_engine_spec_matches_jax_with_image_span(f32_agents):
    """Spec rounds at absolute cache positions, the hand-over to the
    chunk at ``<img>``, a second turn on the first's prefix: tokens,
    counters and lengths equal JAX's; the streams equal the plain ones."""
    got = _cached_turns(f32_agents, 3, port=True)
    assert got == _cached_turns(f32_agents, 3, port=False)
    plain = _cached_turns(f32_agents, 0, port=True)
    assert [o[0] for o in got] == [o[0] for o in plain]
    assert got[0][0][:4] == [VOCAB.img_token_id(i) for i in range(4)]


def test_cached_engine_spec_int4_equals_greedy(agents):
    """The int4 + int8-KV agent: the port's spec stream equals its greedy
    one and JAX's greedy one (see ``f32_agents`` for JAX's spec stream)."""
    got = _cached_turns(agents, 3, port=True)
    plain = _cached_turns(agents, 0, port=True)
    want = _cached_turns(agents, 0, port=False)
    assert [o[0] for o in got] == [o[0] for o in plain] == \
        [o[0] for o in want]
    assert got[1][1] > 0


# ---- the adaptive gate -----------------------------------------------------

def test_spec_adaptive_gate_disables_below_breakeven(agents):
    """An unreachable bar: probe spec_probe_rounds rounds, then plain
    steps; still the exact greedy stream."""
    ids = [TOK.bos_token_id] + TOK.encode("adversarial zqx vw kjh unique")
    got, want = _generate(agents, ids, max_new_tokens=24, spec_k=4,
                          spec_adaptive=True, spec_probe_rounds=3,
                          spec_min_accept=5.0)
    _same(got, want)
    assert got["spec_rounds"] == 3


def test_spec_adaptive_keeps_speculating_when_accepting(agents):
    ids = [TOK.bos_token_id] + TOK.encode(ECHO)
    got, want = _generate(agents, ids, max_new_tokens=24, spec_k=4,
                          spec_adaptive=True, spec_probe_rounds=2,
                          spec_min_accept=0.0)
    _same(got, want)
    assert got["spec_rounds"] > 2
    assert 0 <= got["spec_accepted"] <= 4 * got["spec_rounds"]
