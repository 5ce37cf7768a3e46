"""The port's profiling utilities and metric writers against the JAX
package's (seedx_tpu/utils/profiling.py, trackers.py): ``check_finite``,
``StepTimer``, a ``trace`` that writes an openable file, and the wandb
writer, which warns and leaves the run going without the package."""

import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedx_tpu.utils import profiling as jprof
from seedx_tpu_torch.utils import profiling as tprof
from seedx_tpu_torch.utils.trackers import MetricWriters


def test_check_finite_matches_jax():
    tree = {"ok": np.ones((3, 4), np.float32),
            "nan": np.array([1.0, np.nan], np.float32),
            "nested": {"inf": np.array([[np.inf]], np.float32),
                       "fine": np.zeros(2, np.float32)},
            "bf16": np.array([2.0, -np.inf], np.float32)}
    want = jprof.check_finite({k: (jnp.asarray(v) if not isinstance(v, dict)
                                   else {a: jnp.asarray(b)
                                         for a, b in v.items()})
                               for k, v in tree.items()})
    got = tprof.check_finite(
        {"ok": torch.from_numpy(tree["ok"]),
         "nan": torch.from_numpy(tree["nan"]),
         "nested": {k: torch.from_numpy(v)
                    for k, v in tree["nested"].items()},
         "bf16": torch.from_numpy(tree["bf16"]).to(torch.bfloat16)})
    assert got == want == {"nan": False, "nested/inf": False, "bf16": False}
    assert tprof.check_finite({"a": torch.ones(2)}) == {}
    assert tprof.check_finite({}) == {}
    assert tprof.check_finite(torch.tensor(float("nan"))) == {"value": False}


def test_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.0, 0.5, 0.5, 1.5, 1.5, 1.75, 1.75, 3.75, 3.75])
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    timers = (tprof.StepTimer(ema=0.8), jprof.StepTimer(ema=0.8))
    for steps in (1, 2, 1, 4):
        got, want = (t.tick(steps) for t in timers)
        assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(0.8 * (0.8 * (0.8 * 2 + 0.2 * 2) + 0.2 * 4)
                                + 0.2 * 2, rel=1e-12)


def test_trace_writes_an_openable_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("my_region"):
            (x @ x).sum()
    path = tmp_path / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)


def test_wandb_writer_warns_and_the_run_goes_on(tmp_path, monkeypatch,
                                                caplog):
    """Without the package (as on the card's machine) the wandb writer is
    disabled with a warning; the jsonl record is written as always."""
    monkeypatch.setitem(sys.modules, "wandb", None)   # import raises
    monkeypatch.delenv("WANDB_MODE", raising=False)
    with caplog.at_level(logging.WARNING):
        with MetricWriters(str(tmp_path), trackers=("jsonl", "wandb"),
                           expr_name="x") as w:
            w.log({"total_loss": 2.0}, 0)
    assert any("wandb tracker disabled" in r.message for r in caplog.records)
    rows = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert rows == [{"total_loss": 2.0, "step": 0}]


def test_wandb_disabled_by_env_is_not_tried(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    with caplog.at_level(logging.WARNING):
        with MetricWriters(str(tmp_path), trackers=("wandb",)) as w:
            w.log({"total_loss": 1.0}, 3)
    assert not caplog.records
    assert not os.path.exists(tmp_path / "metrics.jsonl")


# ---------------------------------------------------------------------------
# The span recorder
# ---------------------------------------------------------------------------

@pytest.fixture
def spans():
    """A clean record store, recording off on entry and exit."""
    assert not tprof.enabled()
    tprof.clear()
    yield
    tprof.clear()
    assert not tprof.enabled()


def test_off_records_nothing_and_calls_nothing(spans, monkeypatch):
    """Off, a span site gets the one shared null record: no profiler
    range, no CUDA event, no clock read, no record, and no memory kept or
    taken per call."""
    import time
    import tracemalloc

    calls = []

    def counting(name, real):
        def f(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return f

    for mod, name in ((torch._C._profiler, "_RecordFunctionFast"),
                      (torch.profiler, "record_function"),
                      (torch.cuda, "Event"), (time, "time_ns"),
                      (time, "perf_counter")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    assert tprof.annotate("a") is tprof.annotate("b", rid=3, device=True)
    with tprof.annotate("engine.chunk", device=True) as span:
        span["ran"] = 4
        span.end_device()
    assert not span
    tracemalloc.start()
    try:
        for _ in range(3):
            with tprof.annotate("engine.chunk", device=True) as span:
                span["ran"] = 4
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(10000):
            with tprof.annotate("engine.chunk", device=True) as span:
                span["ran"] = 4
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert calls == []
    assert tprof.records() == []
    # a record a call would take ~100 bytes each: 1 MB over the loop
    assert now - before < 1024 and peak - before < 1024


def test_recording_keeps_spans_with_parents_and_attributes(spans):
    with tprof.recording():
        assert tprof.enabled()
        with tprof.annotate("outer", rid=7, n=1) as outer:
            outer["m"] = 2
            with tprof.annotate("inner", device=True) as inner:
                inner["k"] = 3
        t = tprof.now()
        with tprof.annotate("request.queued", rid=7, start=t - 5000):
            pass
        with tprof.annotate("load", name="flash_fwd"):
            pass
    with tprof.annotate("later"):
        pass
    recs = {r["name"]: r for r in tprof.records()}
    assert set(recs) == {"outer", "inner", "request.queued", "load"}
    assert recs["load"]["attrs"] == {"name": "flash_fwd"}
    o, i, q = recs["outer"], recs["inner"], recs["request.queued"]
    assert o["attrs"] == {"n": 1, "m": 2} and o["rid"] == 7
    assert o["parent"] is None and i["parent"] == o["id"]
    assert i["attrs"] == {"k": 3} and i["device_ms"] is None
    assert o["t0"] <= i["t0"] <= i["t1"] <= o["t1"]
    assert q["t0"] == t - 5000 and q["t1"] >= t and q["parent"] is None
    # records are kept in the order they closed
    assert [r["name"] for r in tprof.records()] == [
        "inner", "outer", "request.queued", "load"]


def test_records_past_the_limit_are_dropped_and_counted(spans,
                                                       monkeypatch):
    monkeypatch.setattr(tprof, "MAX_RECORDS", 3)
    with tprof.recording():
        for k in range(5):
            with tprof.annotate("s", k=k):
                pass
    assert [r["attrs"]["k"] for r in tprof.records()] == [0, 1, 2]
    assert tprof.dropped() == 2
    tprof.clear()
    assert tprof.records() == [] and tprof.dropped() == 0


def test_on_while_the_profiler_records(spans):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert tprof.enabled()
        with tprof.annotate("profiled", b=2):
            pass
    assert not tprof.enabled()
    with tprof.annotate("after"):
        pass
    assert [(r["name"], r["attrs"]) for r in tprof.records()] == [
        ("profiled", {"b": 2})]


def test_parents_and_rids_across_two_threads(spans):
    """Each thread's spans nest under its own open span, though the two
    threads' spans interleave in time."""
    import threading

    both_open = threading.Barrier(2, timeout=30)

    def serve(rid):
        with tprof.annotate("request", rid=rid):
            both_open.wait()
            with tprof.annotate("work", rid=rid):
                both_open.wait()

    with tprof.recording():
        threads = [threading.Thread(target=serve, args=(rid,))
                   for rid in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = tprof.records()
    by = {(r["name"], r["rid"]): r for r in recs}
    assert len(recs) == 4 and len(by) == 4
    for rid in (1, 2):
        assert by["request", rid]["parent"] is None
        assert by["work", rid]["parent"] == by["request", rid]["id"]
    assert len({r["id"] for r in recs}) == 4


def test_span_agrees_with_the_profilers_range(spans):
    """A span's host start and end are on the clock of the profiler's own
    events: its range in the trace holds the span within 0.1 ms."""
    from torch.autograd import profiler

    x = torch.randn(128, 128)
    prof = profiler.profile(use_kineto=True)
    prof._prepare_trace()
    prof._start_trace()
    for k in range(5):
        with tprof.annotate(f"probe{k}"):
            for _ in range(20):
                x = torch.tanh(x @ x)
    events = torch.autograd._disable_profiler().events()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if e.name().startswith("probe")}
    recs = tprof.records()
    assert len(recs) == 5
    for r in recs:
        t0, t1 = ranges[r["name"]]
        assert abs(r["t0"] - t0) < 100_000 and abs(r["t1"] - t1) < 100_000
        assert t1 - t0 > 0


def test_trace_writes_the_spans_beside_the_trace(spans, tmp_path):
    with tprof.annotate("before"):
        pass
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("engine.step", pending=1) as span:
            span["active"] = 2
    assert (tmp_path / "trace.json").exists()
    rows = [json.loads(x) for x in open(tmp_path / "spans.jsonl")]
    assert [(r["name"], r["attrs"]) for r in rows] == [
        ("engine.step", {"pending": 1, "active": 2})]
    assert rows[0]["t1"] >= rows[0]["t0"] and rows[0]["device_ms"] is None


def test_each_trace_writes_its_own_spans(spans, tmp_path):
    """Two ``trace()`` blocks in a row each write the spans that closed in
    them, and take them out of the kept records; what was kept before the
    first stays."""
    with tprof.recording():
        with tprof.annotate("kept"):
            pass
    for k in range(2):
        with tprof.trace(str(tmp_path / str(k))):
            for i in range(k + 1):
                with tprof.annotate(f"block{k}", i=i):
                    pass
    for k in range(2):
        rows = [json.loads(x) for x in open(tmp_path / str(k) / "spans.jsonl")]
        assert [(r["name"], r["attrs"]) for r in rows] == [
            (f"block{k}", {"i": i}) for i in range(k + 1)]
    assert [r["name"] for r in tprof.records()] == ["kept"]
