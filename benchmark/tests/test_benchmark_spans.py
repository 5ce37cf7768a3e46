"""The readers of the program's own spans (``profiling.records()``):
each on synthetic records and a synthetic profile, spans the profiled
sub-window cuts left out, and None where there is nothing to read (no
records, nothing profiled, or a program that keeps none).  The engine's
own spans carry what the serving benchmark's spans around the same calls
carry."""

import pytest

from benchmark.harness import core
from benchmark.harness.trace import Profile
from seedx_tpu_torch.utils import profiling

NEW = ("noop_steps.serve", "step_device_ms.serve", "step_idle.serve",
       "denoise_idle.t2i")


def rec(name, t0, t1, device_ms=None, **attrs):
    return {"name": name, "id": 0, "parent": None, "rid": None, "t0": t0,
            "t1": t1, "device_ms": device_ms, "attrs": attrs}


def readings(window=(1000, 9000), busy=()):
    p = Profile()
    p.window = window
    p.kernels = [(t0, t1, "k") for t0, t1 in busy]
    return core.Readings(None, p, {}, {"config": {}, "cell": {}})


def read(name, records, r, monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: records)
    return core.load_module("metrics", name).read(r)


def test_noop_steps_and_step_device_time(monkeypatch):
    records = [rec("engine.chunk", 1000, 2000, 40.0, replayed=4, ran=4),
               rec("engine.chunk", 3000, 4000, 30.0, replayed=4, ran=1),
               rec("engine.chunk", 8000, 9500, 99.0, replayed=4, ran=0)]
    r = readings()
    assert read("noop_steps.serve", records, r, monkeypatch) == \
        pytest.approx(100.0 * 3 / 8)
    assert read("step_device_ms.serve", records, r, monkeypatch) == \
        pytest.approx(70.0 / 8)
    # no device time (a machine without a card): nothing to read
    records = [rec("engine.chunk", 1000, 2000, None, replayed=4, ran=4)]
    assert read("step_device_ms.serve", records, r, monkeypatch) is None
    assert read("noop_steps.serve", records, r, monkeypatch) == 0.0


@pytest.mark.parametrize("name,span", [("step_idle.serve", "engine.step"),
                                       ("denoise_idle.t2i", "sdxl.denoise")])
def test_idle_share_inside_the_spans(name, span, monkeypatch):
    # spans [1000, 3000) and [4000, 5000); busy [500, 1500), [2000, 2500),
    # [4200, 4400) and [4300, 6000) (merged to [4200, 6000))
    records = [rec(span, 1000, 3000), rec(span, 4000, 5000),
               rec(span, 8500, 9500),                  # cut by the end
               rec("other", 1000, 9000)]
    r = readings(busy=[(500, 1500), (2000, 2500), (4200, 4400),
                       (4300, 6000)])
    # idle: 2000 - (500 + 500) in the first, 1000 - 800 in the second
    assert read(name, records, r, monkeypatch) == \
        pytest.approx(100.0 * (1000 + 200) / 3000)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    assert read(name, [], readings(), monkeypatch) is None
    cut = [rec(n, 0, 20_000, 1.0, replayed=4, ran=4)
           for n in ("engine.chunk", "engine.step", "sdxl.denoise")]
    assert read(name, cut, readings(), monkeypatch) is None
    unprofiled = core.Readings(None, None, {}, {"config": {}, "cell": {}})
    assert read(name, cut, unprofiled, monkeypatch) is None
    # the parent commit's program keeps no records
    monkeypatch.delattr(profiling, "records")
    assert core.load_module("metrics", name).read(readings()) is None


def test_engine_spans_match_the_probes():
    """Under the serving benchmark's ``EngineProbe.instrument`` the engine
    answers as it does without, and its own prefill-group and chunk spans
    carry what the benchmark's spans around the same calls carry."""
    from benchmark.harness.engine import EngineProbe
    from benchmark.harness.trace import Spans
    from benchmark.tests.tiny import few_threads
    from seedx_tpu_torch.inference.continuous import ContinuousEngine
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    rt = SeedXRuntime.debug(device="cpu")
    tok = rt.tokenizer
    texts = ["hello world", "abc abc abc", "the cat sat on the mat",
             "one two three four"]
    budgets = [8, 3, 6, 8]

    def drain(instrument):
        eng = ContinuousEngine(rt, slots=2, max_new_tokens=8, chunk_steps=4,
                               prompt_buckets=(24, 56))
        spans = Spans(False)
        undo = EngineProbe(eng).instrument(spans) if instrument else None
        profiling.clear()
        try:
            with profiling.recording():
                ids = [eng.submit({"input_ids": [tok.bos_token_id]
                                   + tok.encode(t)}, max_new_tokens=b)
                       for t, b in zip(texts, budgets)]
                res = eng.run()
        finally:
            if undo is not None:
                undo()
        recs = profiling.records()
        profiling.clear()
        return [list(res[i]["tokens"]) for i in ids], recs, spans

    with few_threads():
        plain, _, _ = drain(False)
        tokens, recs, spans = drain(True)
    assert tokens == plain
    keys = ("b", "bucket", "p_lens", "images")
    groups = [r for r in recs if r["name"] == "engine.prefill_group"]
    assert len(groups) >= 2
    assert [{k: g["attrs"][k] for k in keys} for g in groups] == \
        [{k: s[k] for k in keys} for s in spans.of("prefill_group")]
    chunks = [r for r in recs if r["name"] == "engine.chunk"]
    assert chunks
    assert [(c["attrs"]["ran"], c["attrs"]["tokens"],
             c["attrs"]["kv_positions"]) for c in chunks] == \
        [(s["steps"], s["tokens"], s["kv_positions"])
         for s in spans.of("decode_chunk")]
    assert sum(r["attrs"]["admitted"] for r in recs
               if r["name"] == "engine.admit") == \
        sum(s["admitted"] for s in spans.of("admit")) == len(texts)
