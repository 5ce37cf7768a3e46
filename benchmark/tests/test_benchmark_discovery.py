"""The harness finds every cell, configuration, mix, driver and metric
by name, and a new one is found with no edit to any file there."""

import importlib.util
import json
import os
import shutil

import pytest

from benchmark.harness import core

ROOT = core.ROOT


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_declared_name_has_its_file():
    s = spec()
    for c in s["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in s["workloads"]:
        f = core.cell_files(w["name"])
        assert f["cell"]["config"] == w["config"]
        assert f["cell"]["traffic"] == w["traffic"]
        assert f["cell"]["chips"] == w["chips"]
        assert os.path.isfile(os.path.join(core.BENCH, "drivers",
                                           f["cell"]["driver"] + ".py"))
    for m in s["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_declared_metrics_of_each_cell(cell):
    d = core.declared(cell)
    names = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert d["per_layer"]
    for m in d["per_layer"]:
        assert m["moves"] in names


def load_core(root):
    path = os.path.join(root, "benchmark", "harness", "core.py")
    sp = importlib.util.spec_from_file_location("core_copy", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    s = spec()
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (root / "benchmark").rglob("*")
               if x.is_file())}
    cell = json.load(open(root / "benchmark/workloads/ds7b_longdoc_serve.json"))
    cell["rate"] = 1.5
    (root / "benchmark/workloads/ds7b_doc_slow.json").write_text(
        json.dumps(cell))
    (root / "benchmark/metrics/requests_seen.serve.py").write_text(
        "def read(r):\n    return float(len(r.spans.of('admit')))\n")
    s["workloads"].append({"name": "ds7b_doc_slow",
                           "config": "seedx_agent_deepseek7b",
                           "traffic": "longdoc_poisson", "chips": 1,
                           "why": "x"})
    s["per_layer"].append({"name": "requests_seen.serve", "unit": "1",
                           "better": "higher", "source": "program_span",
                           "layer": "x", "moves": "ttft_p95_ms",
                           "workloads": ["ds7b_doc_slow"]})
    for m in s["end_to_end"]:
        if "ds7b_longdoc_serve" in m.get("workloads", ()):
            m["workloads"].append("ds7b_doc_slow")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    mod = load_core(str(root))
    files = mod.cell_files("ds7b_doc_slow")
    assert files["cell"]["rate"] == 1.5
    assert files["config"]["hidden_size"] == 4096
    d = mod.declared("ds7b_doc_slow")
    assert [m["name"] for m in d["per_layer"]] == ["requests_seen.serve"]
    assert "ttft_p95_ms" in [m["name"] for m in d["end_to_end"]]
    assert mod.load_module("metrics", "requests_seen.serve").read
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_a_missing_cell_fails():
    with pytest.raises(FileNotFoundError):
        core.cell_files("no_such_cell")
