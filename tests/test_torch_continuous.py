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
