"""Device ms a replayed decode step: the device time of the engine's own
``engine.chunk`` spans in the profiled sub-window (CUDA events around a
chunk's replays, no synchronize), over the steps they replayed, no-op
steps included.  Layer: model step: models/llama.py under
utils/graphs.py.  Moves tpot_p95_ms."""

from benchmark.harness.program_spans import spans


def read(r):
    chunks = [c for c in spans(r, "engine.chunk") or ()
              if c["device_ms"] is not None]
    replayed = sum(c["attrs"]["replayed"] for c in chunks)
    if not replayed:
        return None
    return sum(c["device_ms"] for c in chunks) / replayed
