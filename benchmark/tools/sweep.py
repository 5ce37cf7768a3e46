"""A serving cell's rate sweep on the card, in one process: the cell's
program set up once, then one window a rate, each at its own load, and
for each the end-to-end metrics, the requests done and the backlog (due,
not admitted) over the window's thirds: a backlog that grows to the last
third marks a rate above what the program sustains.

    python3 benchmark/tools/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates <r>,<r>,...

Prints one JSON line a rate.  The benchmark's own runs never sweep.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import core, traffic  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness.programs import set_precision

    files = core.cell_files(args.workload)
    set_precision(files["config"])
    mod = core.load_module("drivers", files["cell"]["driver"])
    print(f"sweep: {args.workload} on {core.smi_line()}", file=sys.stderr)
    d = mod.Driver(files, seed=args.seed, device=torch.device("cuda", 0),
                   seconds=args.seconds)
    t0 = time.perf_counter()
    d.setup()
    print(f"sweep: set up in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    for rate in (float(r) for r in args.rates.split(",")):
        d.rate = rate
        d.reqs = traffic.generate(d.mix, args.seed, args.seconds, rate)
        for r in d.reqs:
            r["ids"] = d._prompt(r)
        w = d.window(args.seconds, False)
        print(json.dumps({"rate": rate, "attempted": w["attempted"],
                          "failed": w["failed"], **w["end_to_end"],
                          "notes": w["notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
