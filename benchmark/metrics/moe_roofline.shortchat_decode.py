"""K6's share of its roofline in decode over Nemotron-H's two-matrix
relu2 experts: the least time of the routed experts' work in the profiled
decode chunks (the engine's ``engine.chunk`` spans: each (block, step)
expert with rows, ``experts_active``, its up and down weights read once;
every replayed step's routed rows, slots x top-k an expert block),
divided by K6's device time inside those chunks.  Layer: ops/moe.py
(K6).  Moves tpot_p95_ms."""

from benchmark.harness.program_spans import spans
from benchmark.roofline import counts, nemotron_h as nh
from benchmark.roofline.deepseek_v2 import kernel_seconds_in


def read(r):
    chunks = [c for c in spans(r, "engine.chunk") or ()
              if "experts_active" in c["attrs"]]
    if not chunks:
        return None
    m = nh.dims(r.config)
    slots = r.cell["engine"]["slots"]
    active = sum(c["attrs"]["experts_active"] for c in chunks)
    rows = sum(c["attrs"]["replayed"] for c in chunks) * m["Le"] * slots \
        * m["k"]
    t = kernel_seconds_in(r.profile, counts.kernel_patterns("k6"),
                          [(c["t0"], c["t1"]) for c in chunks])
    if t <= 0 or not active:
        return None
    return 100.0 * nh.k6_decode_bound_s(r.config, active, rows) / t
