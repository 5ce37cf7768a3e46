"""The port's ``ContinuousEngine`` (slot pool, rolling admission, dense and
paged KV) against the JAX package's, on the tiny int4 + int8-KV agent with
the ragged decode attention forced on (the paged configuration).

The cache length is ``max(prompt_buckets) + max_new_tokens`` = 64, one
tile for the JAX kernel, so both packages round the softmax weights
against the same maximum (see test_torch_serving.py) and the token streams
must be equal.  Paged and dense runs of the port must agree exactly: the
same arithmetic reads the same values through the block tables.
"""

import types

import pytest
import torch

import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference.continuous import (ContinuousEngine as
                                            JaxContinuousEngine)
from seedx_tpu.text.tokenizer import load_tokenizer as jload_tokenizer
from seedx_tpu_torch.inference.continuous import ContinuousEngine
from seedx_tpu_torch.inference.runtime import SeedXRuntime
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.utils import profiling
from test_torch_slice import _tiny_int4_agents

torch.set_num_threads(1)

TEXTS = ["hello world", "abc abc abc", "the cat sat on the mat",
         "one two three four"]
BUDGETS = [8, 3, 6, 8]
ENGINE = dict(slots=2, max_new_tokens=8, chunk_steps=4,
              prompt_buckets=(24, 56), page_size=8)


@pytest.fixture(scope="module")
def agents():
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
    return [{"input_ids": [tok.bos_token_id] + tok.encode(t)} for t in texts]


def _drain(rt, cls=ContinuousEngine, **kw):
    eng = cls(rt, **{**ENGINE, **kw})
    ids = [eng.submit(r, max_new_tokens=b)
           for r, b in zip(_requests(rt.tokenizer), BUDGETS)]
    res = eng.run()
    return [list(res[i]["tokens"]) for i in ids], eng


def test_dense_matches_jax_and_paged_matches_dense(agents):
    rt_j, rt_t = agents
    want, _ = _drain(rt_j, JaxContinuousEngine)
    dense, eng = _drain(rt_t)
    assert dense == [[int(t) for t in w] for w in want]
    # per-request budgets hold (EOS may end a row earlier)
    assert all(len(d) <= b for d, b in zip(dense, BUDGETS))
    assert eng.stats()["completed"] == len(TEXTS)
    assert eng.stats()["decode_steps"] > 0
    paged, eng = _drain(rt_t, paged=True)
    assert paged == dense
    st = eng.stats()
    assert st["kv_tiles_free"] == st["kv_tiles_total"]   # all pages back
    # harvested slots point at the dump page, so their frozen rows' writes
    # cannot land in pages handed to a live request
    assert not eng.state["tables"].any()


def test_small_pool_defers_and_drains(agents):
    _, rt_t = agents
    dense, _ = _drain(rt_t)
    # 5 usable pages of 8 rows: "the cat sat on the mat" (24 tokens + 6)
    # needs 4, so it waits until both slots' pages are back
    eng = ContinuousEngine(rt_t, **ENGINE, paged=True, pool_tokens=6 * 8)
    ids = [eng.submit(r, max_new_tokens=b)
           for r, b in zip(_requests(rt_t.tokenizer), BUDGETS)]
    deferred = False
    while eng.stats()["pending"] or eng.stats()["active_slots"]:
        eng.step()
        st = eng.stats()
        deferred |= st["pending"] > 0 and st["active_slots"] < st["slots"]
    assert deferred
    res = eng._results
    assert [list(res[i]["tokens"]) for i in ids] == dense
    st = eng.stats()
    assert st["kv_tiles_free"] == st["kv_tiles_total"] == 5


def test_run_raises_when_the_pool_cannot_admit(agents):
    _, rt_t = agents
    eng = ContinuousEngine(rt_t, **ENGINE, paged=True, pool_tokens=6 * 8)
    eng.submit(_requests(rt_t.tokenizer)[2], max_new_tokens=6)   # 4 pages
    del eng._free_tiles[1:]        # as if the pool had been sized too small
    with pytest.raises(RuntimeError, match="pool too small"):
        eng.run()


def test_oversized_request_raises(agents):
    _, rt_t = agents
    eng = ContinuousEngine(rt_t, **ENGINE, paged=True, pool_tokens=3 * 8)
    with pytest.raises(ValueError, match="KV tiles"):
        eng.submit(_requests(rt_t.tokenizer, ["the cat sat on the mat"])[0])
    with pytest.raises(ValueError, match="largest prompt bucket"):
        eng.submit({"input_ids": [1] * 57})


def test_mid_flight_submit_is_answered(agents):
    _, rt_t = agents
    dense, _ = _drain(rt_t)
    eng = ContinuousEngine(rt_t, **ENGINE, paged=True, pool_tokens=12 * 8)
    reqs = _requests(rt_t.tokenizer)
    first = [eng.submit(r, max_new_tokens=b)
             for r, b in zip(reqs[:2], BUDGETS[:2])]
    eng.step()
    late = [eng.submit(r, max_new_tokens=b)
            for r, b in zip(reqs[2:], BUDGETS[2:])]
    res = eng.run()
    assert [list(res[i]["tokens"]) for i in first + late] == dense


def test_paged_requires_int4_and_the_ragged_kernel():
    for kw in ({}, dict(quantization="int4", kv_quantization="int8",
                        decode_attention="never")):
        rt = SeedXRuntime.debug(device="cpu", **kw)
        with pytest.raises(ValueError, match="paged KV"):
            ContinuousEngine(rt, slots=2, paged=True)
        # the model refuses block tables on its own as well
        cfg = rt.agent_cfg.llm
        with pytest.raises(ValueError, match="paged KV"):
            rt.agent.llm_step(
                torch.zeros((1, 1, cfg.hidden_size)),
                torch.zeros((1, 1), dtype=torch.long),
                torch.ones((1, 8), dtype=torch.bool), None,
                torch.zeros((1,), dtype=torch.long),
                block_tables=torch.zeros((1, 1), dtype=torch.int32))


def test_sampling_follows_its_seed(agents):
    """``do_sample`` draws from the engine's own torch.Generator: the same
    seed gives the same streams, and budgets still hold."""
    _, rt_t = agents
    runs = [_drain(rt_t, do_sample=True, temperature=1.0, top_p=0.9,
                   seed=s)[0] for s in (5, 5)]
    assert runs[0] == runs[1]
    assert all(len(r) <= b for r, b in zip(runs[0], BUDGETS))
    assert runs[0] != _drain(rt_t)[0]        # not the greedy streams


# ---------------------------------------------------------------------------
# The engine's spans (utils/profiling.py)
# ---------------------------------------------------------------------------

def _recorded(rt, **kw):
    """The four requests drained under ``profiling.recording()``:
    (engine, ids, results, records)."""
    profiling.clear()
    eng = ContinuousEngine(rt, **{**ENGINE, **kw})
    with profiling.recording():
        ids = [eng.submit(r, max_new_tokens=b)
               for r, b in zip(_requests(rt.tokenizer), BUDGETS)]
        res = eng.run()
    recs = profiling.records()
    profiling.clear()
    return eng, ids, res, recs


def _named(recs, name):
    return [r for r in recs if r["name"] == name]


def test_each_request_is_queued_once(agents):
    """Two slots for four requests: every request gets one queued span,
    from its submission to the admission that took it, and the later two
    wait for a slot to free."""
    _, rt_t = agents
    eng, ids, res, recs = _recorded(rt_t)
    by_id = {r["id"]: r for r in recs}
    queued = {r["rid"]: r for r in _named(recs, "request.queued")}
    assert len(_named(recs, "request.queued")) == len(queued) == len(ids)
    assert set(queued) == set(ids)
    reqs = _requests(rt_t.tokenizer)
    for rid, req, budget in zip(ids, reqs, BUDGETS):
        q = queued[rid]
        assert q["attrs"] == {"p_len": len(req["input_ids"]),
                              "budget": budget}
        assert q["t0"] <= q["t1"]
        assert by_id[q["parent"]]["name"] == "engine.admit"
    harvests = _named(recs, "engine.harvest")
    first_done = min(h["t1"] for h in harvests if h["attrs"]["harvested"])
    assert min(queued[i]["t1"] for i in ids[2:]) > first_done
    assert sum(r["attrs"]["admitted"] for r in _named(recs, "engine.admit")) \
        == sum(r["attrs"]["harvested"]
               for r in _named(recs, "engine.harvest")) == len(ids)


@pytest.mark.parametrize("kw", [{}, {"paged": True},
                                {"fused_prefill": True, "prefill_width": 4}],
                         ids=["dense", "paged", "fused"])
def test_chunk_spans_count_the_steps_that_ran(agents, kw):
    """Over the engine.chunk spans, the steps that ran add up to the
    engine's own counters, by program kind, and the tokens to what it
    generated."""
    _, rt_t = agents
    eng, _, _, recs = _recorded(rt_t, **kw)
    st = eng.stats()
    chunks = _named(recs, "engine.chunk")
    ran = {kind: sum(c["attrs"]["ran"] for c in chunks
                     if c["attrs"]["kind"] == kind)
           for kind in ("decode", "mixed")}
    assert ran == {"decode": st["decode_steps"], "mixed": st["mixed_steps"]}
    assert st["decode_steps"] > 0
    assert (st["mixed_steps"] > 0) == bool(kw.get("fused_prefill"))
    assert sum(c["attrs"]["tokens"] for c in chunks) == \
        st["generated_tokens"]
    steps = _named(recs, "engine.step")
    assert len(steps) >= st["chunks"]
    by_id = {r["id"]: r for r in recs}
    assert all(by_id[c["parent"]]["name"] == "engine.step" for c in chunks)


def test_chunk_spans_count_every_replay(agents):
    """``replayed`` is the chunk's k, whether or not a row ran: no-op
    steps show as replayed minus ran."""
    _, rt_t = agents
    eng, _, _, recs = _recorded(rt_t)
    chunks = _named(recs, "engine.chunk")
    st = eng.stats()
    assert len(chunks) == st["chunks"]
    assert sum(c["attrs"]["replayed"] for c in chunks) == \
        st["chunks"] * ENGINE["chunk_steps"]
    assert all(0 < c["attrs"]["ran"] <= c["attrs"]["replayed"]
               for c in chunks)
    # one request of budget 3 in chunks of 4: its chunk's last step is a
    # no-op
    profiling.clear()
    eng = ContinuousEngine(rt_t, **ENGINE)
    with profiling.recording():
        eng.submit(_requests(rt_t.tokenizer)[0], max_new_tokens=3)
        eng.run()
    (chunk,) = _named(profiling.records(), "engine.chunk")
    profiling.clear()
    assert chunk["attrs"]["replayed"] == 4
    assert chunk["attrs"]["ran"] == eng.stats()["decode_steps"] <= 3

