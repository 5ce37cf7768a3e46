"""K7's share of its roofline in decode: the least time of the Mamba
state steps of the profiled decode chunks (the engine's ``engine.chunk``
spans: every replayed step runs K7 once a Mamba block for every slot,
each slot's fp32 state read and written once), divided by K7's device
time inside those chunks.  Layer: ops/ssm.py (K7).  Moves
tpot_p95_ms."""

from benchmark.harness.program_spans import spans
from benchmark.roofline import counts, nemotron_h as nh
from benchmark.roofline.deepseek_v2 import kernel_seconds_in


def read(r):
    chunks = spans(r, "engine.chunk")
    if not chunks:
        return None
    slot_steps = sum(c["attrs"]["replayed"] for c in chunks) \
        * r.cell["engine"]["slots"]
    t = kernel_seconds_in(r.profile, counts.kernel_patterns("k7"),
                          [(c["t0"], c["t1"]) for c in chunks])
    if t <= 0 or not slot_steps:
        return None
    return 100.0 * nh.k7_bound_s(r.config, slot_steps) / t
