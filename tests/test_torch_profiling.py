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
