"""No-op steps, % of the steps replayed: 100 x (1 - ran / replayed)
over the engine's own ``engine.chunk`` spans in the profiled
sub-window (``run_chunk`` replays all its steps; those after the last
row stopped do nothing but cost device time).  Layer:
inference/continuous.py engine loop.  Moves ttft_p95_ms."""

from benchmark.harness.program_spans import spans


def read(r):
    chunks = spans(r, "engine.chunk")
    replayed = sum(c["attrs"]["replayed"] for c in chunks or ())
    if not replayed:
        return None
    ran = sum(c["attrs"]["ran"] for c in chunks)
    return 100.0 * (1.0 - ran / replayed)
