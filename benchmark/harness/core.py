"""One run of one cell: find its files by name, set up, measure, check,
print one result line.

Everything that belongs to a cell is found by name under ``benchmark/``:
``workloads/<cell>.json`` (its configuration, traffic mix, driver, rate
and engine settings), ``configs/<config>.json`` (the model's sizes),
``traffic/<mix>.json`` (the generator's parameters), ``drivers/<driver>.py``
(the loop that drives the program) and ``metrics/<metric>.py`` (one
per-layer metric's reader).  Which metrics a cell reports is read from
``BENCHMARK.json`` at the checkout's root.  Adding a cell, a mix, a
configuration or a metric adds files and edits none.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "seedx_tpu")


def load_json(*parts: str) -> Dict:
    path = os.path.join(BENCH, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such benchmark file: {path}")
    mod_name = "benchmark_" + kind + "_" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_files(name: str) -> Dict[str, Any]:
    """The cell, its configuration and its traffic mix, by name."""
    cell = load_json("workloads", name + ".json")
    return {"name": name, "cell": cell,
            "config": load_json("configs", cell["config"] + ".json"),
            "mix": load_json("traffic", cell["traffic"] + ".json")}


def declared(cell: str) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` gives
    ``cell`` (a metric without ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if cell in m.get("workloads", ())
           or ("workloads" not in m and m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) the run
    may not hold, compared whole (``seedx_tpu_torch`` is not
    ``seedx_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(names or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Readings:
    """What a per-layer metric's reader gets: the spans, the profiled
    sub-window (or None), the driver's counts of the work it did, the
    configuration and the cell."""

    def __init__(self, spans, profile, work, files):
        self.spans = spans
        self.profile = profile
        self.work = work
        self.config = files["config"]
        self.cell = files["cell"]


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def main(argv: List[str], t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="offer this rate instead of the cell's (a sweep)")
    args = ap.parse_args(argv)

    files = cell_files(args.workload)
    cell = files["cell"]
    metrics_spec = declared(args.workload)

    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{smi_line()}", file=sys.stderr)
    out = run(files, metrics_spec, args, torch.device("cuda", 0), chips,
              t_process)

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


def run(files: Dict, metrics_spec: Dict, args, device, chips: int,
        t_process: float) -> Dict[str, Any]:
    """Everything of a run after the look for a chip: set-up, the window,
    the check and the result line's object (its checks printed last on
    standard error)."""
    import torch

    from benchmark.harness.programs import set_precision
    from benchmark.harness.trace import sync

    cuda = device.type == "cuda"
    set_precision(files["config"])
    driver = load_module("drivers", files["cell"]["driver"]).Driver(
        files, seed=args.seed, device=device, rate=args.rate,
        seconds=args.seconds)
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_process
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = driver.window(args.seconds, bool(args.trace))
    sync()
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    t_check = time.perf_counter() - t_check

    correct = bool(checks) and all(finite(c["value"])
                                   and c["value"] <= c["limit"]
                                   for c in checks)
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": chips,
            "memory_peak_bytes": memory_peak}
    out: Dict[str, Any] = {"correct": correct,
                           "attempted": int(window["attempted"]),
                           "failed": int(window["failed"])}
    metrics: Dict[str, Dict] = {}
    notes = dict(window.get("notes", {}), check_s=f"{t_check:.3f}")
    if not args.trace:
        values = dict(window["end_to_end"], setup_s=setup_s)
        for m in metrics_spec["end_to_end"]:
            if m["name"] in values and finite(values[m["name"]]):
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        prof = window.get("profile")
        readings = Readings(window["spans"], prof, window["work"], files)
        for m in metrics_spec["per_layer"]:
            value = load_module("metrics", m["name"]).read(readings)
            if value is not None and finite(value):
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if prof is not None:
            notes["profile"] = dict(prof.counts, window_s=prof.window_s)
            info["busy_s"] = prof.busy_s
            info["window_s"] = prof.window_s
            out["breakdown"] = prof.breakdown()
    out["metrics"] = metrics
    out["device"] = info
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    notes.update(getattr(driver, "checked", {}))
    for name, info in notes.items():
        print(f"benchmark: {name}: {info}", file=sys.stderr)
    for c in checks:
        verdict = "ok" if finite(c["value"]) and c["value"] <= c["limit"] \
            else "FAIL"
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{verdict}", file=sys.stderr)
    sys.stderr.flush()
    return out
