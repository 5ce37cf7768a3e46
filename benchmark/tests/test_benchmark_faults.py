"""A run whose timed path is broken underneath comes out not correct:
the rest of a run (``core.run``, past the look for a chip) at debug
widths on the CPU, once for each fault the cell can have, and once
unbroken."""

import pytest

from benchmark.harness import core
from benchmark.tests import tiny


def in_window(monkeypatch, target, name, value):
    """Break ``target.name`` from the window's start on: set-up and its
    warm-up run the sound program."""
    load = core.load_module

    def patched(kind, mod_name):
        mod = load(kind, mod_name)
        if kind == "drivers":
            window = mod.Driver.window

            def faulty(self, *a, **kw):
                monkeypatch.setattr(target, name, value)
                return window(self, *a, **kw)

            monkeypatch.setattr(mod.Driver, "window", faulty)
        return mod

    monkeypatch.setattr(core, "load_module", patched)


@pytest.fixture(scope="module")
def doc():
    f = tiny.agent_files("ds7b_longdoc_serve")
    f["cell"]["rate"] = 4.0
    return f


@pytest.fixture(scope="module")
def images():
    """The VQA cell's files (not declared in BENCHMARK.json: PERF.md
    says why), for the serving driver's image path."""
    f = tiny.agent_files("ds7b_vqa_serve")
    f["cell"]["rate"] = 4.0
    return f


@pytest.fixture(scope="module")
def t2i():
    return tiny.sdxl_files()


REPORTED = {"doc": {"ttft_p95_ms", "tpot_p95_ms", "setup_s"},
            "images": {"setup_s"},
            "t2i": {"image_s", "setup_s"}}


@pytest.mark.parametrize("cell", sorted(REPORTED))
def test_sound_runs_are_correct(cell, request):
    out = tiny.run(request.getfixturevalue(cell))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == REPORTED[cell]
    assert list(out)[-1] == "checks"


def test_a_token_altered_where_produced(doc, monkeypatch):
    from seedx_tpu_torch.inference import continuous

    sample = continuous._sample

    def wrong(logits, *a, **kw):
        tok = sample(logits, *a, **kw)
        return (tok + 1) % logits.shape[-1]

    in_window(monkeypatch, continuous, "_sample", wrong)
    out = tiny.run(doc)
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > \
        out["checks"]["token_gap"]["limit"]


def test_a_decode_step_that_returns_its_state_unchanged(doc, monkeypatch):
    from seedx_tpu_torch.inference import continuous

    def frozen(model, state, *a, **kw):
        state["steps"].add_(1)

    in_window(monkeypatch, continuous, "decode_step", frozen)
    out = tiny.run(doc)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["unfinished"]["value"] > 0


def test_a_denoise_step_that_returns_its_state_unchanged(t2i, monkeypatch):
    from seedx_tpu_torch.models.sdxl import pipeline

    in_window(monkeypatch, pipeline, "euler_step",
              lambda sample, eps, sigma, sigma_next: sample)
    out = tiny.run(t2i)
    assert not out["correct"]
    assert out["checks"]["step"]["value"] > out["checks"]["step"]["limit"]


def test_an_image_altered_where_produced(t2i, monkeypatch):
    from seedx_tpu_torch.models import adapter

    decode = adapter.decode_latents
    in_window(monkeypatch, adapter, "decode_latents",
              lambda *a, **kw: 1.0 - decode(*a, **kw))
    out = tiny.run(t2i)
    assert not out["correct"]
    assert out["checks"]["image"]["value"] > out["checks"]["image"]["limit"]


def test_a_noise_prediction_altered_where_produced(t2i, monkeypatch):
    from seedx_tpu_torch.models.sdxl import pipeline

    cfg_eps = pipeline.cfg_eps
    in_window(monkeypatch, pipeline, "cfg_eps",
              lambda *a, **kw: cfg_eps(*a, **kw) * 1.5)
    out = tiny.run(t2i)
    assert not out["correct"]
    assert out["checks"]["eps"]["value"] > out["checks"]["eps"]["limit"]
