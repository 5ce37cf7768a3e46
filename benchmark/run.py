"""The benchmark of ``seedx_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell's model from the seed on the card, warms up the shapes
its traffic uses, drives the traffic for ``--seconds``, checks what the
timed path produced against the plain reference under
``benchmark/reference``, and prints one JSON line last on standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from spans and a profiled sub-window.  Every kernel and
compiler cache lives inside the checkout, at fixed paths.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, "benchmark", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
