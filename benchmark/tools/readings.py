"""The two readings a cell's limits are set from, on the card, in one
process: for each seed, a short window of the cell at its own load, then
the program's checked numbers and the control's on the same sample.

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s> \\
        --seeds <n>,<n>,... [--control-seeds <n>,...]

Prints one JSON line a seed: {"seed", "program": {...}, "control":
{...}}.  The benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import core  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="seeds that also read the control (default all)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness.programs import set_precision

    files = core.cell_files(args.workload)
    set_precision(files["config"])
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = (set(seeds) if args.control_seeds is None
           else {int(s) for s in args.control_seeds.split(",")})
    mod = core.load_module("drivers", files["cell"]["driver"])
    print(f"readings: {args.workload} on {core.smi_line()}", file=sys.stderr)
    for seed in seeds:
        t0 = time.perf_counter()
        d = mod.Driver(files, seed=seed, device=torch.device("cuda", 0),
                       seconds=args.seconds)
        d.setup()
        w = d.window(args.seconds, False)
        d.release()
        out = {"seed": seed, "attempted": w["attempted"],
               "failed": w["failed"],
               "program": {c["name"]: c["value"] for c in d.check()}}
        if seed in ctl:
            out["control"] = {c["name"]: c["value"] for c in d.control()}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del d, w
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
