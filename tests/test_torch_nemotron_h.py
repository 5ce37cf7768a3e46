"""Nemotron-H in the port (a hybrid stack of Mamba-2 mixers, relu2
sparse experts with a sigmoid router and NoPE GQA attention; its
recurrent state in the continuous engine's cache) against the plain fp32
reference ``plain_nemotron_h.py``, at a tiny size: pattern ``ME*EM``,
hidden 64, Mamba 4 heads of 16 with state 16 in 2 groups, conv 4, scan
chunk 8, attention 4 heads of 16 over 2 KV heads, 8 experts of 32 top-2
and a shared expert of 48.  The model runs in fp32 here, so what separates
it from the reference is the order of fp32 sums -- above all the chunked
scan's matmuls against the reference's token-by-token recurrence: each
tolerance below says so, and ``test_a_bf16_state_fails_the_tolerance``
shows that a state kept in bf16 lies well outside it.  The router is
drawn wide (std 0.5) so that no top-k choice sits on a near-tie that
such rounding could flip.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import plain_nemotron_h as plain
from benchmark.drivers import serve_nemotron_h
from benchmark.drivers.serve_nemotron_h import llm_config as bench_config
from seedx_tpu_torch.inference.continuous import ContinuousEngine
from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
from seedx_tpu_torch.models.generation import (BeamState, DecodeState,
                                               GenerationConfig)
from seedx_tpu_torch.models import llama as tllama
from seedx_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          init_kv_cache, init_paged_kv_pool,
                                          llama_debug)
from seedx_tpu_torch.models.mamba import Mamba2Mixers
from seedx_tpu_torch.ops import moe as tmoe
from seedx_tpu_torch.ops import ssm as tssm
from seedx_tpu_torch.text.tokenizer import load_tokenizer

torch.set_num_threads(2)

HF = dict(hidden_size=64, hybrid_override_pattern="ME*EM",
          num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, mamba_num_heads=4, mamba_head_dim=16,
          ssm_state_size=16, n_groups=2, conv_kernel=4, chunk_size=8,
          n_routed_experts=8, num_experts_per_tok=2,
          moe_intermediate_size=32, moe_shared_expert_intermediate_size=48,
          n_shared_experts=1, routed_scaling_factor=2.5, norm_eps=1e-5,
          vocab_size=32330, intermediate_size=32,
          max_position_embeddings=4096, rope_theta=10000)
# fp32 sums in another order -- the chunked scan's matmuls against the
# token-by-token recurrence, the batched experts against a per-expert
# loop: logits of magnitude ~1-3 agree to this (a bf16 state misses it by
# far: test_a_bf16_state_fails_the_tolerance)
TOL = 2e-5


def llm_config(**kw) -> LlamaConfig:
    """The benchmark driver's mapping of the published keys, in fp32."""
    return dataclasses.replace(bench_config(HF), dtype=torch.float32, **kw)


def fill(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            n = torch.randn(t.shape, generator=g)
            std = 0.5 if ("router" in name or "correction" in name) else 0.08
            t.copy_(1 + 0.1 * n if name.endswith("scale") else n * std)
    return module


def params(model):
    return {k: v for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def model():
    return fill(LlamaForCausalLM(llm_config())).eval()


@pytest.fixture(scope="module")
def runtime():
    cfg = AgentConfig(llm=llm_config(), num_img_in_tokens=4,
                      num_img_out_tokens=4, vit_dim=32, resampler_heads=4,
                      vit_down=False, dtype=torch.float32)
    agent = fill(ContinuousLVLM(cfg), seed=1).eval()
    return types.SimpleNamespace(agent=agent, agent_cfg=cfg,
                                 tokenizer=load_tokenizer())


def test_config_maps_the_published_keys():
    cfg = llm_config()
    assert cfg.hybrid and not cfg.rope and cfg.head_dim == 16
    assert cfg.mamba_inner == 64 and cfg.conv_dim == 64 + 2 * 2 * 16
    assert cfg.shared_width == 48 and cfg.dense_layers == 0
    assert [cfg.kind_index(i) for i in range(5)] == [0, 0, 0, 1, 1]
    cache = init_kv_cache(cfg, 3, 10)
    assert [tuple(c.shape) for c in cache] == [
        (1, 3, 10, 32), (1, 3, 10, 32), (2, 3, 3, 128), (2, 3, 4, 16, 16)]
    assert cache[3].dtype == torch.float32
    with pytest.raises(ValueError, match="block_pattern"):
        llm_config(block_pattern="ME*E")


@pytest.mark.parametrize("length", [1, 9, 33])
def test_forward_matches_plain_reference(model, length):
    x = torch.randn(1, length, 64, generator=torch.Generator().manual_seed(
        length))
    with torch.no_grad():
        got, _, _ = model(x, torch.arange(length)[None])
    want = plain.forward(HF, params(model), x[0])
    assert want.abs().max() > 0.5
    torch.testing.assert_close(got[0], want, rtol=0, atol=TOL)


def _sequential(x, dt, a, bm, cm, initial=None):
    """The recurrence token by token (the published definition)."""
    b, l, h, p = x.shape
    rep = h // bm.shape[2]
    s = (initial.clone() if initial is not None
         else x.new_zeros(b, h, p, bm.shape[-1]))
    ys = []
    for t in range(l):
        bh = bm[:, t].repeat_interleave(rep, 1)
        ch = cm[:, t].repeat_interleave(rep, 1)
        s = torch.exp(dt[:, t] * a)[..., None, None] * s \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, :, None]
        ys.append((s @ ch[..., None])[..., 0])
    return torch.stack(ys, 1), s


@pytest.mark.parametrize("length", [1, 7, 8, 9, 37])
@pytest.mark.parametrize("initial", [False, True])
def test_chunked_scan_equals_the_sequential_recurrence(length, initial):
    """ssd_scan at chunk 8, within a chunk, at its edge, one past it and
    over several, from zeros and from a given state."""
    g = torch.Generator().manual_seed(length)
    b, h, p, gr, n = 2, 4, 8, 2, 16
    x = torch.randn(b, length, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, length, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g) * 0.5)
    bm = torch.randn(b, length, gr, n, generator=g)
    cm = torch.randn(b, length, gr, n, generator=g)
    s0 = torch.randn(b, h, p, n, generator=g) if initial else None
    y, s = tssm.ssd_scan(x, dt, a, bm, cm, 8, s0)
    y_ref, s_ref = _sequential(x, dt, a, bm, cm, s0)
    # fp32 sums in another order, values of magnitude ~10
    torch.testing.assert_close(y, y_ref, rtol=0, atol=2e-5 * max(
        1.0, y_ref.abs().max().item()))
    torch.testing.assert_close(s, s_ref, rtol=0, atol=2e-5 * max(
        1.0, s_ref.abs().max().item()))


def test_a_bf16_state_fails_the_tolerance(model):
    """The tolerance is tight enough: the recurrence with its state
    rounded to bf16 at every token parts from the fp32 one by far more
    than TOL, in the states and in the model's logits."""
    g = torch.Generator().manual_seed(4)
    b, l, h, p, gr, n = 1, 33, 4, 16, 2, 16
    x = torch.randn(b, l, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=g))
    a = -torch.exp(torch.randn(h, generator=g) * 0.5)
    bm, cm = (torch.randn(b, l, gr, n, generator=g) for _ in range(2))
    y32, _ = _sequential(x, dt, a, bm, cm)
    s = x.new_zeros(b, h, p, n)
    ys = []
    for t in range(l):
        s = (torch.exp(dt[:, t] * a)[..., None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None]
             * bm[:, t].repeat_interleave(2, 1)[:, :, None]
             ).to(torch.bfloat16).float()
        ys.append((s @ cm[:, t].repeat_interleave(2, 1)[..., None])[..., 0])
    assert (torch.stack(ys, 1) - y32).abs().max() > 10 * 2e-5 * max(
        1.0, y32.abs().max().item())
    # the model with a bf16 state step: its decode logits miss TOL
    x = torch.randn(1, 12, 64, generator=g)
    want = plain.forward(HF, params(model), x[0])
    real = tssm.ssm_step_plain

    def bf16_state(state, *a, **kw):
        y = real(state, *a, **kw)
        state.copy_(state.to(torch.bfloat16).float())
        return y

    tssm_step = tssm.ssm_step
    import seedx_tpu_torch.models.mamba as tmamba
    tmamba.ssm_step = bf16_state
    try:
        got = _prefill_then_decode(model, x, [4])[0]
    finally:
        tmamba.ssm_step = tssm_step
    assert (got - want).abs().max() > 10 * TOL


def _prefill_then_decode(model, x, lens, per_row=True):
    """Rows of x [B, total, hidden]: a right-padded prefill of ``lens``,
    then one-token steps through the cache; each row's logits over its
    whole sequence."""
    b, total = x.shape[:2]
    cache = init_kv_cache(model.cfg, b, total)
    span = torch.arange(total)
    got = [[] for _ in range(b)]
    with torch.no_grad():
        p = max(lens)
        kvv = span[None, :] < torch.tensor(lens)[:, None]
        lg, _, _ = model(x[:, :p], span[None, :p].repeat(b, 1), kvv, cache, 0)
        for r in range(b):
            got[r].append(lg[r, :lens[r]])
        pos = torch.tensor(lens)
        for _ in range(total - max(lens)):
            kvv = span[None, :] <= pos[:, None]
            xt = x[torch.arange(b), pos][:, None]
            lg, _, _ = model(xt, pos[:, None], kvv, cache,
                             pos if per_row else int(pos[0]))
            for r in range(b):
                got[r].append(lg[r])
            pos = pos + 1
    return [torch.cat(g) for g in got]


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_then_decode_through_the_recurrent_state(model, per_row):
    """A 2-row right-padded prefill (the states at each row's real end),
    then one-token steps (the conv shift and the state step), each row's
    logits against the reference's full forward over its own sequence."""
    g = torch.Generator().manual_seed(5)
    lens, total = ([6, 11] if per_row else [11, 11]), 20
    x = torch.randn(2, total, 64, generator=g)
    got = _prefill_then_decode(model, x, lens, per_row)
    for r in range(2):
        n = lens[r] + total - max(lens)
        want = plain.forward(HF, params(model), x[r, :n])
        torch.testing.assert_close(got[r], want, rtol=0, atol=TOL)


def test_row_groups_equal_the_whole_step(model, monkeypatch):
    """A multi-row prefill past ``HYBRID_ROWS_TOKENS`` runs its rows in
    groups (here of 2 rows, then 1), each writing its rows' views of the
    cache: over right-padded rows with ``last=`` given, its logits, hidden
    states, KV and conv / SSM states lie within TOL of the step run whole
    (the experts' sorted rows differ by group: fp32 sums in another
    order)."""
    g = torch.Generator().manual_seed(31)
    lens, p, total = [12, 5, 9, 1, 12], 12, 16
    b = len(lens)
    x = torch.randn(b, p, 64, generator=g)
    span = torch.arange(total)
    kvv = span[None] < torch.tensor(lens)[:, None]
    last = torch.tensor(lens) - 1
    grouped = LlamaForCausalLM._row_groups
    calls = []

    def spy(self, *a):
        calls.append(a[0].shape[0])
        return grouped(self, *a)

    monkeypatch.setattr(LlamaForCausalLM, "_row_groups", spy)
    runs = []
    for limit in (b * p, 2 * p):
        monkeypatch.setattr(tllama, "HYBRID_ROWS_TOKENS", limit)
        cache = init_kv_cache(model.cfg, b, total)
        with torch.no_grad():
            lg, hid, _ = model(x, span[None, :p].repeat(b, 1), kvv, cache, 0,
                               last=last)
        runs.append((lg, hid, cache))
    assert calls == [b]
    (lg0, hid0, cache0), (lg1, hid1, cache1) = runs
    assert lg0.shape == (b, 1, model.cfg.vocab_size)
    torch.testing.assert_close(lg1, lg0, rtol=0, atol=TOL)
    torch.testing.assert_close(hid1, hid0, rtol=0, atol=TOL)
    for c1, c0 in zip(cache1, cache0):
        assert c0.abs().max() > 0
        torch.testing.assert_close(c1, c0, rtol=0, atol=TOL)


def test_padded_row_state_equals_its_unpadded_state_exactly():
    """A row right-padded from 12 to 16 positions (pads of arbitrary
    values, the last chunk half real) leaves the Mamba block the same
    conv and SSM state, bit for bit, as the row alone at length 12: dt is
    0 and the conv input zero at every pad, and the conv state is
    gathered at the real end.  (8 heads of 8: on the CPU an elementwise
    op computes what lies past a multiple of its vector loop's width, 32
    floats, in scalar code, whose exp may round otherwise; 12 and 16
    positions of dt, 96 and 128 values, leave no such tail.)"""
    cfg = llm_config(mamba_heads=8, mamba_head_dim=8)
    mix = fill(Mamba2Mixers(cfg, 1))
    g = torch.Generator().manual_seed(11)
    c, h = cfg.conv_dim, cfg.mamba_heads
    xbc = torch.randn(1, 16, c, generator=g)
    dt = torch.randn(1, 16, h, generator=g)
    states = []
    for s, keep in ((12, None), (16, torch.arange(16)[None] < 12)):
        cache = init_kv_cache(cfg, 1, 16)
        state = (cache[2][0], cache[3][0])
        mix._scan(0, xbc[:, :s], dt[:, :s], state, 0, keep)
        states.append(state)
    assert torch.equal(states[0][0], states[1][0])
    assert torch.equal(states[0][1], states[1][1])
    assert states[0][1].abs().max() > 0


def _requests(tok, texts):
    return [{"input_ids": [tok.bos_token_id] + tok.encode(t)} for t in texts]


def _served_gaps(rt, requests, results):
    """Per request, the widest gap of a served token below the
    reference's best at every served position."""
    agent = rt.agent
    gaps = []
    for req, res in zip(requests, results):
        toks = [int(t) for t in res["tokens"]]
        ids = list(req["input_ids"]) + toks[:-1]
        with torch.no_grad():
            emb = agent.embed_with_images(torch.tensor([ids]))[0]
        lg = plain.forward(HF, params(agent.llm), emb)
        lg = lg[len(req["input_ids"]) - 1:]
        tok = torch.tensor(toks)
        gaps.append(float((lg.max(-1).values
                           - lg.gather(1, tok[:, None])[:, 0]).max()))
    return gaps


def test_engine_serves_ragged_prompts(runtime):
    """ContinuousEngine (bucket prefill handing each slot the state at its
    prompt's real end, captured-shape decode chunks, rolling admission
    over 2 slots, so slots are reused) serves 4 ragged prompts greedily:
    every served token is the reference's best, to the fp32 tolerance."""
    tok = runtime.tokenizer
    reqs = _requests(tok, ["hello world", "abc abc abc abc abc",
                           "the cat sat on the mat", "x"])
    eng = ContinuousEngine(runtime, slots=2, max_new_tokens=6, chunk_steps=3,
                           prompt_buckets=(16, 32))
    eng.warmup()
    ids = [eng.submit(r) for r in reqs]
    res = eng.run()
    out = [res[i] for i in ids]
    assert all(len(r["tokens"]) == 6 for r in out)
    assert int(runtime.agent.llm.layers.experts_active) > 0
    assert max(_served_gaps(runtime, reqs, out)) <= TOL


def test_reused_slot_gives_a_fresh_engines_logits(runtime):
    """A slot that served one request and then another gives the second
    the logits a fresh engine gives it: admission overwrites the slot's
    recurrent state."""
    tok = runtime.tokenizer
    first, second = _requests(tok, ["a long first prompt of many words",
                                    "second"])
    logits = []
    for reqs in ([first, second], [second]):
        eng = ContinuousEngine(runtime, slots=1, max_new_tokens=4,
                               chunk_steps=2, prompt_buckets=(16, 64))
        for r in reqs:
            eng.submit(r)
        eng.run()
        logits.append(eng.state["prev_logits"][0].clone())
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-6)


def test_sigmoid_router_follows_the_selection_bias():
    """The correction bias picks the experts and does not weigh them: a
    bias that lifts an expert past the top-k puts it in, with its own
    sigmoid score renormalised."""
    x = torch.eye(4)
    router = torch.zeros(4, 4)
    router[0] = torch.tensor([3.0, 2.0, 1.0, -1.0])
    w0, ids0 = tmoe.route(x[:1], router, 2, 2.5, torch.zeros(4))
    assert sorted(ids0[0].tolist()) == [0, 1]
    bias = torch.tensor([0.0, 0.0, 0.0, 5.0])
    w1, ids1 = tmoe.route(x[:1], router, 2, 2.5, bias)
    assert sorted(ids1[0].tolist()) == [0, 3]
    s = torch.sigmoid(router[0])
    want = {0: s[0] / (s[0] + s[3]) * 2.5, 3: s[3] / (s[0] + s[3]) * 2.5}
    for wt, e in zip(w1[0].tolist(), ids1[0].tolist()):
        assert wt == pytest.approx(float(want[e]), rel=1e-6)
    assert float(w1.sum()) == pytest.approx(2.5, rel=1e-6)
    # the softmax path is DeepSeek-V2's, untouched: no renormalisation
    ws, _ = tmoe.route(x[:1], router, 2, 1.0)
    assert float(ws.sum()) < 1.0


def test_check_readings_of_the_sampled_gaps():
    """The cell's two checked readings from per-request gaps over the
    free positions: the widest mean gap, and the share of all the
    positions whose token is not the reference's first choice."""
    gaps = [torch.tensor([0.0, 0.0, 3.0, 1.0]), torch.tensor([0.0, 0.5])]
    assert serve_nemotron_h._readings(gaps) == {
        "token_gap_mean": 1.0, "argmax_miss_share": 0.5}
    gaps = [torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.tensor([2.0, 0.5])]
    assert serve_nemotron_h._readings(gaps) == {
        "token_gap_mean": 1.25, "argmax_miss_share": 0.5}
    assert set(serve_nemotron_h.READINGS) == set(
        serve_nemotron_h._readings(gaps))


def test_moe_gemm_plain_relu2_matches_a_per_expert_loop():
    """moe_gemm_plain(act="relu2") over expert-sorted rows, experts 1, 4
    and 6 given no rows, against each expert's rows through
    torch.matmul: relu(x w)^2 rounded to bf16 once."""
    g = torch.Generator().manual_seed(3)
    counts = [3, 0, 5, 1, 0, 7, 0, 2]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    x = torch.randn(sum(counts), 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(8, 64, 32, generator=g) * 0.1).to(torch.bfloat16)
    active = torch.zeros((), dtype=torch.int64)
    got = tmoe.moe_gemm(x, w, offsets, None, active, "relu2")
    assert int(active) == 5 and got.dtype == torch.bfloat16
    at = 0
    for e, n in enumerate(counts):
        want = torch.relu(x[at:at + n].float() @ w[e].float()).square()
        # the same fp32 products: equal bits
        assert torch.equal(got[at:at + n], want.to(torch.bfloat16))
        at += n
    with pytest.raises(ValueError, match="w2"):
        tmoe.moe_gemm(x, w, offsets, w, None, "relu2")


def test_relu2_experts_match_the_reference_layer(model):
    """One expert block of the port (sorted rows, the relu2 epilogue, the
    fp32 combine, the shared expert) against the reference's per-expert
    loop."""
    h = torch.randn(9, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.layers._experts(1, h[None])[0]
    want = plain.experts(HF, lambda n, j=None: params(model)[n].float()
                         if j is None else params(model)[n][j].float(),
                         1, h)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_ssm_step_plain_is_one_step_of_the_recurrence():
    """ssm_step_plain (K7's contract) from a random state against one
    step of the recurrence written out, with the D term, its xbc a
    strided view as the engine hands it."""
    g = torch.Generator().manual_seed(7)
    b, h, p, gr, n = 3, 4, 16, 2, 16
    width = h * p + 2 * gr * n
    wide = torch.randn(b, width + 8, generator=g)
    xbc, dt_raw = wide[:, :width], wide[:, width:width + h]
    dt_bias, a_log, d = (torch.randn(h, generator=g) * 0.5 for _ in range(3))
    s0 = torch.randn(b, h, p, n, generator=g)
    state = s0.clone()
    y = tssm.ssm_step(state, xbc, dt_raw, dt_bias, a_log, d, h, p, gr)
    x = xbc[:, :h * p].reshape(b, h, p)
    bm = xbc[:, h * p:h * p + gr * n].reshape(b, gr, n)
    cm = xbc[:, h * p + gr * n:].reshape(b, gr, n)
    dt = torch.nn.functional.softplus(dt_raw + dt_bias)
    want_s = torch.empty_like(s0)
    want_y = torch.empty(b, h, p)
    for r in range(b):
        for hh in range(h):
            gg = hh // (h // gr)
            want_s[r, hh] = torch.exp(dt[r, hh] * -torch.exp(a_log[hh])) \
                * s0[r, hh] + dt[r, hh] * torch.outer(x[r, hh], bm[r, gg])
            want_y[r, hh] = want_s[r, hh] @ cm[r, gg] + d[hh] * x[r, hh]
    torch.testing.assert_close(state, want_s, rtol=0, atol=1e-6)
    torch.testing.assert_close(y, want_y, rtol=0, atol=1e-5)


def _refusals():
    def engine(**kw):
        return lambda rt: ContinuousEngine(rt, slots=2, max_new_tokens=4,
                                           prompt_buckets=(16,), **kw)

    def spec(rt):
        gen = GenerationConfig(max_new_tokens=4, spec_k=2)
        cache = init_kv_cache(rt.agent_cfg.llm, 1, 8)
        DecodeState(rt.agent, cache, 1, gen, rt.tokenizer.vocab, None,
                    spec_k=2, hist_len=8)

    def beam(rt):
        gen = GenerationConfig(max_new_tokens=4, num_beams=2)
        cache = init_kv_cache(rt.agent_cfg.llm, 2, 8)
        BeamState(rt.agent, cache, 1, 4, gen, rt.tokenizer.vocab, None)

    def mesh(rt):
        from seedx_tpu_torch.parallel.mesh import place_params

        place_params(rt.agent, None)

    def train(rt):
        rt.agent.llm.forward_train(torch.zeros(1, 4, 64),
                                   torch.arange(4)[None])

    def fused_step(rt):
        cfg = rt.agent_cfg.llm
        rt.agent.llm(torch.zeros(2, 2, 64),
                     torch.zeros(2, 2, dtype=torch.long),
                     torch.ones(2, 8, dtype=torch.bool),
                     init_kv_cache(cfg, 2, 8),
                     torch.zeros(2, dtype=torch.long),
                     write_widths=torch.ones(2, dtype=torch.long))

    return {
        "int4": lambda rt: llm_config(quantization="int4"),
        "int8": lambda rt: llm_config(quantization="int8"),
        "int8_kv": lambda rt: llm_config(kv_quantization="int8"),
        "lora": lambda rt: llm_config(lora_rank=4),
        "paged": engine(paged=True, page_size=4),
        "fused_prefill": engine(fused_prefill=True),
        "paged_pool": lambda rt: init_paged_kv_pool(rt.agent_cfg.llm, 16),
        "fused_step": fused_step,
        "spec_decode": spec,
        "beam": beam,
        "mesh": mesh,
        "training": train,
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_unsupported_combinations_are_refused(runtime, case):
    with pytest.raises(ValueError, match="state-space mixers"):
        _refusals()[case](runtime)


def test_refuse_names_only_listed_features():
    cfg = llm_config()
    with pytest.raises(KeyError):
        cfg.refuse("teleportation")
    # a plain LLaMA configuration refuses nothing
    llama_debug().refuse("training")


# Logits of seeded tiny models as the parent commit computed them, before
# the hybrid stack: the LLaMA layer loop and DeepSeek-V2's MLA + softmax
# SwiGLU experts must not move
_GOLDEN = {
    "llama": [
        -1.187461, -0.2263213, -0.3380105, 0.2192929, 0.9476541, 0.2455766,
        -0.4182423, 0.3081293, -0.8245144, -1.04498, -0.5045213, 0.4775998,
        -0.02859469, -0.09112819, -0.7155951, 0.04331749, -0.8035249,
        0.3186429, -1.081384, 1.000237, 0.07324983, 0.3971834, 0.4461262,
        -0.7479874, 0.7693339, 0.8138404, 0.002377057, 0.1151222, 0.665641,
        -0.8920689, 0.1006966, -0.5679371, -0.0632512, 0.1783663,
        -0.4889873, 0.4933763, 0.4223493, 0.06410327, 0.4613915, 0.4104033,
        -0.4870058, -1.096268],
    "deepseek_v2": [
        0.5318425, 0.2818876, -0.5280386, -0.01865055, -1.467492, 0.5953439,
        -0.2028655, 0.23351, -0.1052169, -0.1364128, -0.1476115, 0.001131509,
        -0.1135156, 0.03198465, -0.8814895, -0.8544243, -0.5791842,
        0.8094921, -0.3394016, 0.9339615, 0.7438767, -0.3475609, 0.4345399,
        -0.4934248, 0.6541588, -0.8717464, -0.503901, -0.04004312,
        0.02843528, -0.6054392, -0.3912269, -0.1725029, 0.1963137, 0.1223754,
        -0.9015712, 0.5805792, 0.22551, -1.17979, -1.097424, -0.8316596,
        0.2419573, 0.4421355],
}


def _golden_models():
    from test_torch_deepseek_v2 import llm_config as dsv2_config

    llama = llama_debug(num_layers=2, hidden_size=64, intermediate_size=128,
                        num_heads=4, num_kv_heads=2, dtype=torch.float32)
    return {"llama": llama, "deepseek_v2": dsv2_config()}


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_existing_configs_keep_their_defaults_and_outputs(name):
    """The fields the hybrid stack added default to what changes nothing,
    and seeded tiny LLaMA / DeepSeek-V2 models give the logits they gave
    before it (fp32 on the CPU: the same operations in the same order)."""
    cfg = _golden_models()[name]
    assert (cfg.block_pattern, cfg.rope, cfg.attn_head_dim,
            cfg.mamba_heads, cfg.expert_act, cfg.router_scoring,
            cfg.shared_intermediate_size) == ("", True, 0, 0, "swiglu",
                                              "softmax", 0)
    assert not cfg.hybrid and cfg.head_dim == cfg.hidden_size // \
        cfg.num_heads
    m = fill(LlamaForCausalLM(cfg), seed=12).eval()
    x = torch.randn(1, 7, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(13))
    with torch.no_grad():
        lg, _, _ = m(x, torch.arange(7)[None])
    got = lg[0, :, :6].reshape(-1).tolist()
    torch.testing.assert_close(torch.tensor(got),
                               torch.tensor(_GOLDEN[name]), rtol=1e-5,
                               atol=1e-6)


def test_plain_reference_matches_the_benchmarks():
    """tests/plain_nemotron_h.py and benchmark/reference/nemotron_h.py
    hold the same equations, and the benchmark's reference names the
    program's leaves: on weights drawn by leaf name from one seed, their
    logits agree (fp32 sums in another order: the benchmark's reference
    computes a block of experts at a time)."""
    from benchmark.harness.weights import draw
    from benchmark.reference import nemotron_h as bref

    shapes = bref.leaf_shapes(HF)
    program = {n: tuple(t.shape) for n, t in
               LlamaForCausalLM(llm_config()).state_dict().items()
               if t.is_floating_point()}
    assert shapes == program
    ref = bref.NemotronH(7, HF, torch.device("cpu"))
    ids = torch.tensor([1, 500, 20, 7, 900, 33, 4, 18, 2000, 11, 12])
    got = ref.logits([{"ids": ids, "rows": torch.arange(len(ids))}])[0]
    params = {name: draw(7, "agent.llm." + name, shape,
                         torch.float32 if "correction" in name
                         else torch.bfloat16, "cpu")
              for name, shape in shapes.items()}
    emb = params["embed_tokens.embedding"][ids].float()
    want = plain.forward(HF, params, emb)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_generate_tokens_left_padded(runtime):
    """The single-batch generation path (``generate_tokens``: LEFT-padded
    prompts, one-token steps at a scalar offset, finished rows masked)
    serves the hybrid stack too: every served token is the reference's
    best, to the fp32 tolerance."""
    from seedx_tpu_torch.models.generation import generate_tokens

    tok = runtime.tokenizer
    agent = runtime.agent
    reqs = _requests(tok, ["a short one", "a rather longer prompt here"])
    p = max(len(r["input_ids"]) for r in reqs)
    ids = torch.full((2, p), tok.pad_token_id, dtype=torch.long)
    mask = torch.zeros((2, p), dtype=torch.bool)
    for i, r in enumerate(reqs):
        n = len(r["input_ids"])
        ids[i, p - n:] = torch.tensor(r["input_ids"])
        mask[i, p - n:] = True
    gen = GenerationConfig(max_new_tokens=6, eos_token_id=-1,
                           pad_token_id=tok.pad_token_id)
    with torch.no_grad():
        out = generate_tokens(agent, agent.embed_ids(ids), mask, ids[:, -1],
                              gen, runtime.tokenizer.vocab)
    results = [{"tokens": out["tokens"][i].tolist()} for i in range(2)]
    assert max(_served_gaps(runtime, reqs, results)) <= TOL


def test_write_mask_keeps_a_rows_recurrent_state(model):
    """A one-token step's ``write_mask`` (the predicated decode step of
    the single-batch path) leaves a masked row's conv and SSM state as
    they were and steps the other row's."""
    cfg = model.cfg
    g = torch.Generator().manual_seed(21)
    cache = init_kv_cache(cfg, 2, 8)
    for c in cache:
        c.copy_(torch.randn(c.shape, generator=g))
    before = [c.clone() for c in cache]
    x = torch.randn(2, 1, 64, generator=g)
    pos = torch.tensor([3, 5])
    kvv = torch.arange(8)[None] <= pos[:, None]
    with torch.no_grad():
        model(x, pos[:, None], kvv, cache, pos,
              write_mask=torch.tensor([True, False]))
    for c, c0 in zip(cache[2:], before[2:]):
        assert torch.equal(c[:, 1], c0[:, 1])
        assert not torch.equal(c[:, 0], c0[:, 0])
