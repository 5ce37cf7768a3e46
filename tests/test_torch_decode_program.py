"""Decode and denoise as device programs (``seedx_tpu_torch/utils/
graphs.py``): the predicated one-token step over static buffers, read by
the host once every ``CHECK_EVERY`` steps, against the JAX package's
``generate_tokens`` / ``generate_tokens_cached`` and against the eager
loop the port ran before (kept below as ``_eager_decode_loop``: one
forward a token, the host reading ``prev_token`` and ``finished`` at every
step); the continuous engines' chunks of predicated steps and their
``warmup`` against the JAX engine; the denoise loop's static-buffer CFG
eval against JAX ``denoise_text2image`` / ``denoise_edit``.  Here, on the
CPU, every program runs its step eagerly; the captured replays are held
to the eager path bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The tiny int4 + int8-KV agent with the ragged attention forced on (64-token
output spans, so an ``<img>`` runs the 65-token chunk), float32 compute.
Token streams are forced where a case needs an EOS or an ``<img>`` at a
given step: the JAX package's ``script_ids`` on its side, a scripted
``_sample`` on the port's.  Tokens must be equal, and hidden states
bit-equal to the port's eager loop (the same arithmetic on the same
values).  Against JAX, hidden states lie within ``HIDDEN_REL`` of their
magnitude: each decode step re-quantizes every projection's input to int8
(W4A8) and writes int8 KV codes, so a one-ulp fp32 difference of the two
packages' summation orders flips a code and moves that step's hidden
state (0.3% of the magnitude measured on a 64-position cache); past 64
positions (the 65-token chunk needs them) the JAX kernel's 8-row tiles
also round the softmax weights to bf16 against running maxima, not the
window's (tests/test_torch_serving.py): 0.7% measured, from the first
decode step on.
"""

import ast
import ctypes
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference.continuous import (ContinuousEngine as
                                            JaxContinuousEngine)
from seedx_tpu.models import generation as jgen
from seedx_tpu.models.llama import init_kv_cache as jinit_kv_cache
from seedx_tpu.models.sdxl import pipeline as jpipe
from seedx_tpu.models.sdxl import scheduler as jsched
from seedx_tpu.text.tokenizer import load_tokenizer as jload_tokenizer
from seedx_tpu_torch.inference import continuous
from seedx_tpu_torch.inference.continuous import ContinuousEngine
from seedx_tpu_torch.models import generation as tgen
from seedx_tpu_torch.models.llama import init_kv_cache
from seedx_tpu_torch.models.sdxl import pipeline as tpipe
from seedx_tpu_torch.models.sdxl import scheduler as tsched
from seedx_tpu_torch import ops
from seedx_tpu_torch.ops import _build, decode_attention, int4_matmul
from seedx_tpu_torch.ops._build import launches
from seedx_tpu_torch.text import prompts
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.utils import graphs
from test_torch_models import _close
from test_torch_sdxl import F32_REL_DEEP, _rng_inputs
from test_torch_sdxl_pipeline import edit_unets  # noqa: F401
from test_torch_slice import _tiny_int4_agents

torch.set_num_threads(1)

VOCAB = load_tokenizer().vocab
N_IMG = 64
T = 77                     # one JAX compile for every scripted case
P = 12                     # prompt length (left-padded rows below it)
HIDDEN_REL = 2e-2


@pytest.fixture(scope="module")
def agents():
    mp = pytest.MonkeyPatch()
    mp.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    yield _tiny_int4_agents(ragged=True)
    mp.undo()


# ---- the eager loop the port ran before (the reference of the counts) ----

def _eager_decode_loop(model, cache, valid_upto, base, prev_logits,
                       prev_hidden, prev_pos, prev_token, gen_cfg, vocab,
                       sample):
    """One forward a token, the host reading prev_token and finished at
    every step; ``sample(constrained, n)`` picks token n.  Returns (out,
    forwards, n)."""
    b = prev_logits.shape[0]
    t = gen_cfg.max_new_tokens
    n_img = gen_cfg.num_img_gen_tokens
    out_tokens = torch.full((b, t), gen_cfg.pad_token_id, dtype=torch.int64)
    out_hidden = torch.zeros((b, t, prev_hidden.shape[-1]),
                             dtype=prev_hidden.dtype)
    out_finished = torch.zeros((b, t), dtype=torch.bool)
    finished = torch.zeros((b,), dtype=torch.bool)
    forced_ids = torch.cat([
        torch.arange(vocab.img_token_start, vocab.img_token_start + n_img),
        torch.tensor([vocab.eoi])])
    steps = n = 0
    while n < t:
        tok_host, fin_host = prev_token.numpy(), finished.numpy()
        if fin_host.all():
            break
        if (n + n_img + 1 <= t
                and np.all((tok_host == vocab.boi) & ~fin_host)):
            c = n_img + 1
            ids = forced_ids[None, :].expand(b, c)
            pos = prev_pos[:, None] + 1 + torch.arange(c)[None, :]
            logits, hidden, _ = model.llm_step(model.embed_ids(ids), pos,
                                               valid_upto(n + c), cache,
                                               base + n)
            out_tokens[:, n:n + c] = ids
            out_hidden[:, n] = prev_hidden
            out_hidden[:, n + 1:n + c] = hidden[:, :n_img]
            out_finished[:, n:n + c] = finished[:, None]
            prev_logits = logits[:, -1].float()
            prev_hidden = hidden[:, -1]
            prev_pos = prev_pos + c
            prev_token = torch.full((b,), vocab.eoi, dtype=torch.int64)
            n += c
            steps += 1
            continue
        constrained = tgen.constrain_image_tokens(prev_token, prev_logits,
                                                  vocab, n_img)
        token = sample(constrained, n)
        token = torch.where(finished, gen_cfg.pad_token_id, token)
        finished = finished | (token == gen_cfg.eos_token_id)
        out_tokens[:, n] = token
        out_hidden[:, n] = prev_hidden
        out_finished[:, n] = finished
        pos = prev_pos + 1
        logits, hidden, _ = model.llm_step(model.embed_ids(token[:, None]),
                                           pos[:, None], valid_upto(n + 1),
                                           cache, base + n)
        prev_logits = logits[:, 0].float()
        prev_hidden = hidden[:, 0]
        prev_pos = pos
        prev_token = token
        n += 1
        steps += 1
    return ({"tokens": out_tokens, "hidden": out_hidden,
             "finished": out_finished}, steps, n)


@torch.no_grad()
def _eager_generate(model, embeds, mask, last, gen_cfg, sample):
    b, p, _ = embeds.shape
    t = gen_cfg.max_new_tokens
    cache = init_kv_cache(model.cfg.llm, b, p + t)
    positions = tgen.positions_from_mask(mask)
    kv_valid = torch.cat([mask, torch.zeros((b, t), dtype=torch.bool)], -1)
    logits, hidden, _ = model.llm_step(embeds, positions, kv_valid, cache, 0)

    def valid_upto(m):
        valid = kv_valid.clone()
        valid[:, p:p + m] = True
        return valid

    return _eager_decode_loop(model, cache, valid_upto, p,
                              logits[:, -1].float(), hidden[:, -1],
                              positions[:, -1], last, gen_cfg, VOCAB, sample)


@torch.no_grad()
def _eager_generate_cached(model, cache, seg, start, seg_len, last, gen_cfg):
    c = cache[0].shape[2]
    sb = seg.shape[1]
    positions = (start + torch.arange(sb))[None]
    kv_valid = (torch.arange(c) < start + seg_len)[None]
    logits, hidden, _ = model.llm_step(seg, positions, kv_valid, cache, start)
    p_total = start + seg_len
    span = torch.arange(c)
    out, steps, n = _eager_decode_loop(
        model, cache, lambda m: (span < p_total + m)[None], p_total,
        logits[:, seg_len - 1].float(), hidden[:, seg_len - 1],
        torch.full((1,), p_total - 1), torch.full((1,), last), gen_cfg,
        VOCAB, lambda c_, n_: torch.argmax(c_, dim=-1))
    return out, steps, p_total + n


# ---- scripted token streams ----------------------------------------------

class Script:
    """The port's ``_sample`` along a script: row r's token n is
    ``script[r, n]`` (what JAX ``script_ids`` forces).  ``n`` is read from
    the decode state the step runs on."""

    def __init__(self, script):
        self.script = torch.as_tensor(np.asarray(script), dtype=torch.int64)
        self.state = None

    def at(self, n: int) -> torch.Tensor:
        return self.script[:, min(n, self.script.shape[1] - 1)].clone()

    def sample(self, logits, cfg, generator=None, noise=None):
        return self.at(int(self.state.n))


def _script(b_rows, rng, eos_at=None, boi_at=None):
    """[rows, T] text ids; EOS at ``eos_at[r]``; ``<img>`` at ``boi_at``
    followed by the forced span ids (what the constrainer forces, so the
    JAX script and the constrainer agree)."""
    s = rng.integers(3, 30000, size=(b_rows, T))
    for r in range(b_rows):
        if eos_at is not None and eos_at[r] is not None:
            s[r, eos_at[r]] = 2
        if boi_at is not None:
            s[r, boi_at] = VOCAB.boi
            span = [VOCAB.img_token_start + i for i in range(N_IMG)]
            span.append(VOCAB.eoi)
            tail = s[r, boi_at + 1:boi_at + 1 + len(span)]
            s[r, boi_at + 1:boi_at + 1 + len(tail)] = span[:len(tail)]
    return s


def _prompt(b, seed):
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((b, P, 128)) * 0.5).astype(np.float32)
    mask = np.ones((b, P), bool)
    for r in range(1, b):
        mask[r, :r * 3] = False              # left padding
    last = rng.integers(3, 30000, size=(b,))
    return embeds, mask, last


def _gen_cfgs(t=T, **kw):
    return (jgen.GenerationConfig(max_new_tokens=t, num_img_gen_tokens=N_IMG,
                                  **kw),
            tgen.GenerationConfig(max_new_tokens=t, num_img_gen_tokens=N_IMG,
                                  **kw))


def _run_port(monkeypatch, agent, embeds, mask, last, gen_t, script=None,
              generator=None):
    """The device-state loop (run eagerly on the CPU): (out, forwards,
    n)."""
    if script is not None:
        orig = tgen.decode_step

        def step(model, st, *a, **kw):
            script.state = st
            return orig(model, st, *a, **kw)

        monkeypatch.setattr(tgen, "decode_step", step)
        monkeypatch.setattr(tgen, "_sample", script.sample)
    timings = {}
    with torch.no_grad():
        out = tgen.generate_tokens(
            agent, torch.from_numpy(embeds), torch.from_numpy(mask),
            torch.from_numpy(last), gen_t, VOCAB, generator=generator,
            timings=timings)
    monkeypatch.undo()
    return out, timings["decode_forwards"], timings["decode_tokens"]


SCRIPTED = {
    # EOS at n = 11: decode stops inside the second 8-step check window
    "eos_mid_window": dict(eos_at=[11]),
    # <img> emitted at n = 3: the chunk fires at n = 4, not a multiple of
    # k, runs n = 4..68, then free steps to t
    "img_chunk_at_4": dict(boi_at=3),
    # <img> at n = 20: no room for the 65-token chunk before t = 77, so
    # the forced ids are single-stepped until n reaches t
    "img_without_room": dict(boi_at=20),
    # no EOS: n reaches t = 77 (the last window holds 5 steps)
    "n_reaches_t": dict(),
}


@pytest.mark.parametrize("case", sorted(SCRIPTED))
def test_scripted_decode_matches_jax_and_eager(agents, monkeypatch, case):
    model_j, vars_j, agent_t = agents
    embeds, mask, last = _prompt(1, seed=3)
    script = _script(1, np.random.default_rng(4), **SCRIPTED[case])
    gen_j, gen_t = _gen_cfgs()
    want = jgen.generate_tokens(
        model_j, vars_j, jnp.asarray(embeds), jnp.asarray(mask),
        jnp.asarray(last, jnp.int32), jax.random.PRNGKey(0), gen_j, VOCAB,
        script_ids=jnp.asarray(script[0], jnp.int32))
    got, forwards, n = _run_port(monkeypatch, agent_t, embeds, mask, last,
                                 gen_t, Script(script))
    s = Script(script)
    ref, ref_forwards, ref_n = _eager_generate(
        agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
        torch.from_numpy(last), gen_t, lambda c, n_: s.at(n_))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["finished"].numpy(),
                                  np.asarray(want["finished"]))
    hid_j = np.asarray(want["hidden"])
    np.testing.assert_allclose(got["hidden"].numpy(), hid_j, rtol=0,
                               atol=HIDDEN_REL * np.abs(hid_j).max())
    for key in ("tokens", "hidden", "finished"):
        assert torch.equal(got[key], ref[key]), key
    assert (forwards, n) == (ref_forwards, ref_n)
    expect = {"eos_mid_window": (12, 12), "img_chunk_at_4": (T - 64, T),
              "img_without_room": (T, T), "n_reaches_t": (T, T)}[case]
    assert (forwards, n) == expect


def test_multi_row_eos_and_chunk_match_eager(agents, monkeypatch):
    """Two left-padded rows: EOS of row 0 at n = 5 and of row 1 at n = 13
    (decode ends inside a window); then both rows at <img> together at
    n = 9 (the chunk at n = 10)."""
    _, _, agent_t = agents
    embeds, mask, last = _prompt(2, seed=5)
    rng = np.random.default_rng(6)
    _, gen_t = _gen_cfgs()
    for kw, expect in ((dict(eos_at=[5, 13]), (14, 14)),
                       (dict(boi_at=9), (T - 64, T))):
        script = _script(2, rng, **kw)
        got, forwards, n = _run_port(monkeypatch, agent_t, embeds, mask,
                                     last, gen_t, Script(script))
        s = Script(script)
        ref, ref_forwards, ref_n = _eager_generate(
            agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
            torch.from_numpy(last), gen_t, lambda c, n_: s.at(n_))
        for key in ("tokens", "hidden", "finished"):
            assert torch.equal(got[key], ref[key]), (kw, key)
        assert (forwards, n) == (ref_forwards, ref_n) == expect
    # (the EOS script) after its EOS at n = 5 row 0 emits pad tokens
    assert got["tokens"][0, 6:].eq(0).all() or kw.get("boi_at")


def test_sampling_with_a_seeded_generator_matches_eager(agents, monkeypatch):
    """Temperature / top-p sampling from a seeded generator: the same
    draws, one for one, as the eager loop's."""
    _, _, agent_t = agents
    embeds, mask, last = _prompt(2, seed=8)
    _, gen_t = _gen_cfgs(t=19, do_sample=True, temperature=1.0, top_p=0.95)
    got, forwards, n = _run_port(monkeypatch, agent_t, embeds, mask, last,
                                 gen_t,
                                 generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    ref, ref_forwards, ref_n = _eager_generate(
        agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
        torch.from_numpy(last), gen_t,
        lambda c, n_: tgen._sample(c, gen_t, gen))
    assert (forwards, n) == (ref_forwards, ref_n)
    for key in ("tokens", "hidden", "finished"):
        assert torch.equal(got[key], ref[key]), key
    # the draws really were random: not the greedy stream
    greedy, _, _ = _eager_generate(
        agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
        torch.from_numpy(last), gen_t, lambda c, n_: torch.argmax(c, -1))
    assert not torch.equal(greedy["tokens"], got["tokens"])


def test_sampling_across_an_image_chunk_matches_eager(agents, monkeypatch):
    """Sampling with an ``<img>`` at n = 3 (a bias on its logit then): the
    chunk fires at n = 4, inside the first 8-step window, whose last four
    replays are no-ops.  Their draws go back to the generator, so the
    sampled tokens after the chunk and the generator's state at the end
    equal the eager loop's, one ``torch.multinomial`` a sampled token."""
    _, _, agent_t = agents
    embeds, mask, last = _prompt(2, seed=8)
    _, gen_t = _gen_cfgs(do_sample=True, temperature=1.0, top_p=0.95)

    def bias(logits, n):
        if n == 3:
            logits = logits.clone()
            logits[:, VOCAB.boi] += 1e4
        return logits

    seen = {}
    orig_step, orig_sample = tgen.decode_step, tgen._sample

    def step(model, st, *a, **kw):
        seen["st"] = st
        return orig_step(model, st, *a, **kw)

    def sample(logits, cfg, generator=None, noise=None):
        return orig_sample(bias(logits, int(seen["st"].n)), cfg, generator,
                           noise)

    monkeypatch.setattr(tgen, "decode_step", step)
    monkeypatch.setattr(tgen, "_sample", sample)
    gen = torch.Generator().manual_seed(3)
    timings = {}
    with torch.no_grad():
        got = tgen.generate_tokens(
            agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
            torch.from_numpy(last), gen_t, VOCAB, generator=gen,
            timings=timings)
    monkeypatch.undo()
    ref_gen = torch.Generator().manual_seed(3)
    ref, ref_forwards, ref_n = _eager_generate(
        agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
        torch.from_numpy(last), gen_t,
        lambda c, n_: tgen._sample(bias(c, n_), gen_t, ref_gen))
    assert (timings["decode_forwards"], timings["decode_tokens"]) == (
        ref_forwards, ref_n) == (4 + 1 + T - 69, T)
    assert (got["tokens"][:, 3] == VOCAB.boi).all()
    for key in ("tokens", "hidden", "finished"):
        assert torch.equal(got[key], ref[key]), key
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def test_chat_turns_match_jax_and_eager_cache_bytes(agents):
    """Three prefix-cached turns through ``generate_tokens_cached``; every
    turn runs to n == t and the last one ends in the cache's last cell, so
    the steps after it must change nothing.  Tokens equal JAX's and the
    eager loop's; the cache below the next turn's prefix equals the eager
    loop's byte for byte."""
    model_j, vars_j, agent_t = agents
    rng = np.random.default_rng(9)
    sb, t = 12, 10
    seg_lens, lasts = [12, 10, 12], [101, 202, 303]
    cap = sum(seg_lens) + 3 * t           # 64: one tile of the JAX kernel
    segs = [(rng.standard_normal((1, sb, 128)) * 0.5).astype(np.float32)
            for _ in seg_lens]
    gen_j, gen_t = _gen_cfgs(t=t)
    cache_j = jinit_kv_cache(model_j.cfg.llm, 1, cap)
    cache_t = init_kv_cache(agent_t.cfg.llm, 1, cap)
    cache_e = init_kv_cache(agent_t.cfg.llm, 1, cap)
    start = 0
    for seg, seg_len, last in zip(segs, seg_lens, lasts):
        out_j, cache_j, len_j = jgen.generate_tokens_cached(
            model_j, vars_j, cache_j, jnp.asarray(seg), jnp.int32(start),
            jnp.int32(seg_len), jnp.int32(last), jax.random.PRNGKey(0),
            gen_j, VOCAB)
        with torch.no_grad():
            out, cache_t, length = tgen.generate_tokens_cached(
                agent_t, cache_t, torch.from_numpy(seg), start, seg_len,
                last, gen_t, VOCAB)
        ref, _, ref_len = _eager_generate_cached(
            agent_t, cache_e, torch.from_numpy(seg), start, seg_len, last,
            gen_t)
        assert length == ref_len == int(len_j) == start + seg_len + t
        np.testing.assert_array_equal(out["tokens"].numpy(),
                                      np.asarray(out_j["tokens"]))
        hid_j = np.asarray(out_j["hidden"])
        np.testing.assert_allclose(out["hidden"].numpy(), hid_j, rtol=0,
                                   atol=HIDDEN_REL * np.abs(hid_j).max())
        for key in ("tokens", "hidden", "finished"):
            assert torch.equal(out[key], ref[key]), key
        for a, b in zip(cache_t, cache_e):
            assert torch.equal(a[:, :, :length], b[:, :, :length])
        start = length
    assert start == cap                    # the last token in the last cell


# ---- the continuous engines -----------------------------------------------

TEXTS = ["hello world", "the cat sat on the mat today",
         "one two three four five six", "abc"]
BUDGETS = [8, 3, 6, 8, 6]
ENGINE = dict(slots=2, max_new_tokens=8, chunk_steps=4,
              prompt_buckets=(24, 56), page_size=8)


def _requests(tok):
    reqs = [{"input_ids": [tok.bos_token_id] + tok.encode(t)} for t in TEXTS]
    reqs.append({"input_ids": [tok.bos_token_id] + tok.encode(
        prompts.generation_prompt("a cat") + tok.vocab.BOI_TOKEN)})
    return reqs


def _drain(rt, cls=ContinuousEngine, warm=False, **kw):
    eng = cls(rt, **{**ENGINE, **kw})
    if warm:
        eng.warmup(buckets=(24,)) if cls is JaxContinuousEngine \
            else eng.warmup()
    ids = [eng.submit(r, max_new_tokens=b)
           for r, b in zip(_requests(rt.tokenizer), BUDGETS)]
    res = eng.run()
    return [[int(x) for x in res[i]["tokens"]] for i in ids], eng


@pytest.fixture(scope="module")
def engines(agents):
    model_j, vars_j, agent_t = agents
    rt_j = types.SimpleNamespace(agent=model_j, agent_params=vars_j["params"],
                                 agent_cfg=model_j.cfg,
                                 tokenizer=jload_tokenizer())
    rt_t = types.SimpleNamespace(agent=agent_t, agent_cfg=agent_t.cfg,
                                 tokenizer=load_tokenizer())
    want = {fused: _drain(rt_j, JaxContinuousEngine, fused_prefill=fused,
                          **({"prefill_width": 4} if fused else {}))[0]
            for fused in (False, True)}
    return rt_j, rt_t, want


def _steps_seen(monkeypatch, kind):
    """Record, before every ``kind`` step, whether some row was running
    (the steps the eager chunk loop would have run)."""
    seen = []
    orig = getattr(continuous, kind)

    def step(model, state, *a, **kw):
        seen.append(bool(state["running"].any()))
        return orig(model, state, *a, **kw)

    monkeypatch.setattr(continuous, kind, step)
    return seen


@pytest.mark.parametrize("layout", ["decode", "packed"])
@pytest.mark.parametrize("paged", [False, True])
def test_engine_chunks_match_jax_and_eager_step_counts(engines, monkeypatch,
                                                       layout, paged):
    _, rt_t, want = engines
    fused = layout != "decode"
    kw = dict(paged=paged)
    if fused:
        kw.update(fused_prefill=True, prefill_width=4)
    decode = _steps_seen(monkeypatch, "decode_step")
    mixed = _steps_seen(monkeypatch, "mixed_step")
    got, eng = _drain(rt_t, **kw)
    assert got == want[fused]
    st = eng.stats()
    k = ENGINE["chunk_steps"]
    # every chunk replays k steps; the counters hold the steps some row ran
    assert len(decode) == k * (st["chunks"] - st["mixed_chunks"])
    assert len(mixed) == k * st["mixed_chunks"]
    assert st["decode_steps"] == sum(decode) > 0
    assert st["mixed_steps"] == sum(mixed)
    assert (st["mixed_steps"] > 0) == fused
    assert sum(decode) < len(decode)       # some replays were no-ops
    if paged:
        assert st["kv_tiles_free"] == st["kv_tiles_total"]
    # a step with no running row changes nothing but frozen rows' cells
    before = {n: v.clone() for n, v in eng.state.items() if n != "cache"}
    for kind in ("decode",) + (("mixed",) if fused else ()):
        eng.program(kind)()
    for name, value in before.items():
        if name != "steps":
            assert torch.equal(eng.state[name], value), name


@pytest.mark.parametrize("fused", [False, True])
def test_warmup_leaves_results_unchanged(engines, fused):
    """``warmup`` (the admission grid and the step programs, on a free
    slot's inert rows) changes no result: against the JAX engine with and
    without its own warmup."""
    rt_j, rt_t, want = engines
    kw = dict(paged=True, fused_prefill=fused,
              **({"prefill_width": 4} if fused else {}))
    got, eng = _drain(rt_t, warm=True, **kw)
    assert got == want[fused]
    warm_j, _ = _drain(rt_j, JaxContinuousEngine, warm=True, **kw)
    assert got == warm_j
    st = eng.stats()
    assert st["kv_tiles_free"] == st["kv_tiles_total"]
    assert not eng.state["tables"].any()
    assert set(eng._programs) == ({"decode", "mixed"} if fused
                                  else {"decode"})


@pytest.mark.parametrize("layout", ["decode", "packed"])
def test_sampled_engine_matches_the_eager_chunk_loop(engines, monkeypatch,
                                                     layout):
    """A sampling engine, five requests on two slots: chunks run on after
    every slot stopped (no-op replays), and later admissions sample again.
    Tokens and step counts equal the eager chunk loop's (a host check
    before every step, one ``torch.multinomial`` from the seeded generator
    a step that ran)."""
    _, rt_t, want = engines
    kw = dict(do_sample=True, temperature=1.0, top_p=0.95, seed=7)
    if layout == "packed":
        kw.update(fused_prefill=True, prefill_width=4)
    decode = _steps_seen(monkeypatch, "decode_step")
    got, eng = _drain(rt_t, **kw)
    monkeypatch.undo()
    assert sum(decode) < len(decode)       # some replays were no-ops
    assert got != want[layout == "packed"]  # the draws really were random

    ref_gen = torch.Generator().manual_seed(7)
    orig_sample = tgen._sample

    def eager_chunk(program, state, k, noise=None, generator=None):
        state["steps"].zero_()
        for _ in range(k):
            if not bool(state["running"].any()):
                break
            program()
        return int(state["steps"])

    monkeypatch.setattr(continuous, "run_chunk", eager_chunk)
    monkeypatch.setattr(continuous, "_sample",
                        lambda logits, cfg, generator=None, noise=None:
                        orig_sample(logits, cfg, ref_gen))
    ref, ref_eng = _drain(rt_t, **kw)
    monkeypatch.undo()
    assert got == ref
    for key in ("decode_steps", "mixed_steps", "completed",
                "generated_tokens"):
        assert eng.stats()[key] == ref_eng.stats()[key], key
    assert torch.equal(eng._generator.get_state(), ref_gen.get_state())


# ---- the denoise loop -----------------------------------------------------

def test_denoise_static_eval_matches_jax_across_images(edit_unets):  # noqa
    """One ``evals`` table kept across two images of each pipeline (the
    adapter's): the second image reuses the first's eval buffers with new
    conditioning and latents, and both equal JAX's."""
    evals, switch = {}, graphs.Graphs()
    tids = np.array([[64, 64, 0, 0, 64, 64]], np.float32)
    for seed in (50, 60):
        schedule = tsched.make_schedule(3, solver="dpmpp_2m")
        lat, img_lat = _rng_inputs(seed, (1, 8, 8, 4), (1, 8, 8, 4))
        lat = lat * schedule.init_noise_sigma
        cond = _rng_inputs(seed + 1, (1, 8, 64), (1, 8, 64), (1, 64),
                           (1, 64))
        unet_j, params, unet_t = edit_unets[4]
        want = jpipe.denoise_text2image(
            unet_j, params, jsched.make_schedule(3, solver="dpmpp_2m"),
            jnp.asarray(lat), *map(jnp.asarray, cond), jnp.asarray(tids),
            guidance_scale=5.0, guidance_rescale=0.7)
        with torch.no_grad():
            got = tpipe.denoise_text2image(
                unet_t, schedule, torch.from_numpy(lat),
                *map(torch.from_numpy, cond), torch.from_numpy(tids),
                guidance_scale=5.0, guidance_rescale=0.7, evals=evals,
                graphs=switch)
        _close(got.numpy(), want, F32_REL_DEEP)
        unet_j, params, unet_t = edit_unets[8]
        euler = tsched.make_schedule(3)
        want = jpipe.denoise_edit(
            unet_j, params, jsched.make_schedule(3), jnp.asarray(lat),
            jnp.asarray(img_lat), *map(jnp.asarray, cond),
            jnp.asarray(tids), guidance_scale=5.0, image_guidance_scale=1.5)
        with torch.no_grad():
            got = tpipe.denoise_edit(
                unet_t, euler, torch.from_numpy(lat),
                torch.from_numpy(img_lat), *map(torch.from_numpy, cond),
                torch.from_numpy(tids), guidance_scale=5.0,
                image_guidance_scale=1.5, evals=evals, graphs=switch)
        _close(got.numpy(), want, F32_REL_DEEP)
        if seed == 50:
            first = dict(evals)
    assert len(evals) == 2
    assert all(evals[k] is ev for k, ev in first.items())


# ---- the program cache and the wrappers' capture-safe state ---------------

def test_programs_run_eagerly_off_the_card_or_switched_off():
    """On the CPU a Program runs its step every call; on the card it is
    captured only while its switch is on."""
    switch = graphs.Graphs()
    calls = []
    prog = switch.program(lambda: calls.append(1) or len(calls), "cpu")
    assert not prog.graphed
    assert [prog(), prog(), prog()] == [1, 2, 3]
    assert prog.graph is None and prog.replays == 0
    assert switch.active("cuda") and not switch.active("cpu")
    assert switch.program(lambda: None, "cuda").graphed
    switch.enabled = False
    assert not switch.active("cuda")
    assert not switch.program(lambda: None, "cuda").graphed
    assert not graphs.Program(lambda: None, "cuda", None).graphed


class _KeptOnCPU(graphs.Graphs):
    """A switch that keeps the agent's decode states on the CPU (its
    programs still run eagerly: a Program captures on the card only)."""

    def active(self, device):
        return True


def test_decode_programs_share_one_kv_storage(agents, monkeypatch):
    """``generate_tokens``' kept decode states: one a shape, their caches
    views of one storage that a larger shape replaces (dropping every
    state).  A state reused after another shape wrote the storage gives
    the fresh cache's tokens and hidden states bit for bit."""
    _, _, agent_t = agents
    _, gen_t = _gen_cfgs(t=10)

    def run(b, seed, gen_cfg=gen_t):
        embeds, mask, last = _prompt(b, seed)
        with torch.no_grad():
            return tgen.generate_tokens(
                agent_t, torch.from_numpy(embeds), torch.from_numpy(mask),
                torch.from_numpy(last), gen_cfg, VOCAB)

    fresh = {b: run(b, seed=20 + b) for b in (1, 2)}
    vars(agent_t).pop("decode_programs", None)
    monkeypatch.setattr(agent_t, "graphs", _KeptOnCPU())
    try:
        store = tgen.decode_programs(agent_t)
        outs = [run(2, seed=22), run(1, seed=21), run(2, seed=22)]
        assert len(store.states) == 2
        ptrs = {st.cache[0].data_ptr() for st in store.states.values()}
        assert ptrs == {store._storage[0].data_ptr()}
        for out, b in zip(outs, (2, 1, 2)):
            for key in ("tokens", "hidden", "finished"):
                assert torch.equal(out[key], fresh[b][key]), (b, key)
        # the outputs are the caller's: the next call leaves them be
        assert outs[0]["tokens"].data_ptr() != outs[2]["tokens"].data_ptr()
        kept = next(iter(store.states.values()))
        _, longer = _gen_cfgs(t=20)
        run(2, seed=22, gen_cfg=longer)
        assert list(store.states) == [(2, P + 20, longer, VOCAB, 0, False)]
        assert kept.cache[0].data_ptr() != store._storage[0].data_ptr()
        store.reserve(agent_t, 2, P + 20, "cpu")       # fits: kept
        assert len(store.states) == 1
    finally:
        vars(agent_t).pop("decode_programs", None)


# a kernel entry point's C signature: one int argument, then the stream
_ENTRY = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


@pytest.fixture
def toy_counters(monkeypatch):
    """The CPU's stand-in for the card's current stream (``cuda_stream``
    1234), and the counters "toy" and "toy wide" registered for a toy
    kernel, taken out of the registry after the test."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=1234))
    _build.register("toy", "toy wide")
    yield
    for name in ("toy", "toy wide"):
        launches.pop(name)


def _replaying(per_replay, monkeypatch):
    """A Program standing for a captured one on the CPU: a graph whose
    replay runs nothing, and the given counts a replay."""
    monkeypatch.setattr(graphs.Program, "graphed",
                        property(lambda self: True))
    prog = graphs.Program(lambda: None, "cpu", None)
    prog.graph = types.SimpleNamespace(replay=lambda: None)
    prog.per_replay = per_replay
    return prog


def test_launch_counts_take_back_a_capture_and_add_replays(monkeypatch):
    """What a capture does to the kernels' counters: the wrappers' Python
    increments under capture are taken back and kept per replay; a replay
    adds them, and ``stats`` counts the whole kernels' launches."""
    before = dict(launches)
    assert {"int4_w4a8", "int4_w4a8 m16", "decode_attn"} <= set(before)
    per_replay = {}
    with graphs._taken_back(per_replay):
        launches["int4_w4a8"] += 3
        launches["int4_w4a8 m16"] += 2
        launches["decode_attn"] += 1
    assert per_replay == {"int4_w4a8": 3, "int4_w4a8 m16": 2,
                          "decode_attn": 1}
    assert launches == before
    try:
        prog = _replaying(per_replay, monkeypatch)
        prog()
        prog()
        assert launches["int4_w4a8"] == before["int4_w4a8"] + 6
        assert launches["int4_w4a8 m16"] == before["int4_w4a8 m16"] + 4
        assert prog.replays == 2
        assert prog.stats()["launches_per_replay"] == 4
    finally:
        launches.update(before)


def test_a_wrapper_registered_counter_is_taken_back_and_replayed(
        monkeypatch, toy_counters):
    """A kernel added later needs no edit of ``utils/graphs.py``: a wrapper
    defined here registers its counters and launches through
    ``_build.launch`` (a fake ctypes entry point); the capture bookkeeping
    takes its counts back and every replay adds them."""
    calls = []
    lib = types.SimpleNamespace(
        toy_kernel=_ENTRY(lambda n, stream: calls.append((n, stream)) or 0))

    def toy(x):
        _build.launch(lib, "toy_kernel", x.device, x.numel(),
                      counts=("toy", "toy wide") if x.numel() > 4
                      else ("toy",))
        return x

    per_replay = {}
    with graphs._taken_back(per_replay):
        toy(torch.zeros(8))
        toy(torch.zeros(2))
    assert calls == [(8, 1234), (2, 1234)]
    assert per_replay == {"toy": 2, "toy wide": 1}
    assert launches["toy"] == launches["toy wide"] == 0
    prog = _replaying(per_replay, monkeypatch)
    for _ in range(3):
        prog()
    assert (launches["toy"], launches["toy wide"]) == (6, 3)
    assert prog.stats()["launches_per_replay"] == 2


def test_launch_raises_under_the_kernel_name_and_counts_nothing(
        toy_counters):
    """A nonzero error from the entry point raises with the entry point's
    name and the code; no counter moves."""
    calls = []
    lib = types.SimpleNamespace(
        toy_kernel=_ENTRY(lambda n, stream: calls.append((n, stream)) or 700))
    with pytest.raises(RuntimeError, match="^toy_kernel: CUDA error 700$"):
        _build.launch(lib, "toy_kernel", torch.device("cpu"), 5,
                      counts=("toy", "toy wide"))
    assert calls == [(5, 1234)]
    assert launches["toy"] == launches["toy wide"] == 0


def test_graphs_imports_no_kernel_module():
    """``utils/graphs.py`` reads the registry in ``ops/_build.py`` and
    imports no kernel wrapper module, so no kernel is named there."""
    kernels = {f"seedx_tpu_torch.ops.{m.name}"
               for m in pkgutil.iter_modules(ops.__path__)}
    kernels.discard("seedx_tpu_torch.ops._build")
    assert "seedx_tpu_torch.ops.int4_matmul" in kernels
    imported = set()
    for node in ast.walk(ast.parse(inspect.getsource(graphs))):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            imported.add(node.module)
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    assert "seedx_tpu_torch.ops._build" in imported
    assert not imported & kernels


@pytest.mark.parametrize("module", [int4_matmul, decode_attention])
def test_ticket_buffers_grow_without_freeing(module):
    """A launch that needs more tickets gets a larger buffer; the outgrown
    one is kept (a captured graph's launches point at it).  K2 and K3
    each keep their own pool."""
    dev = torch.device("cpu")
    pool = module._tickets
    assert pool is not (int4_matmul._tickets if module is decode_attention
                        else decode_attention._tickets)
    pool.buffers.pop(dev, None)
    small = pool.get(dev, 10)
    ptr = small.data_ptr()
    assert pool.get(dev, 4096) is small
    big = pool.get(dev, 5000)
    assert big.numel() >= 5000 and big is not small
    assert any(b is small for b in pool.retired)
    assert small.data_ptr() == ptr and not small.any()
    assert pool.get(dev, 20) is big
    pool.buffers.pop(dev, None)


@pytest.mark.parametrize("module", [int4_matmul, decode_attention])
def test_ticket_pool_refuses_to_grow_under_capture(module, monkeypatch):
    """Under stream capture a pool that would grow raises (its zeros
    would not exist before the first replay); one large enough is
    handed out."""
    dev = torch.device("cpu")
    pool = module._tickets
    pool.buffers.pop(dev, None)
    held = pool.get(dev, 100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    try:
        assert pool.get(dev, held.numel()) is held
        with pytest.raises(RuntimeError, match="under stream capture"):
            pool.get(dev, held.numel() + 1)
        assert pool.buffers[dev] is held
    finally:
        pool.buffers.pop(dev, None)
