"""Decode ms per step: the serving driver's ``decode_chunk`` spans (one
``run_chunk`` of captured decode steps, ended by the chunk's host read),
divided by the steps that ran in them.  Layer: the model step,
models/llama.py under utils/graphs.py.  Moves tpot_p95_ms."""


def read(r):
    steps = sum(s["steps"] for s in r.spans.of("decode_chunk"))
    return r.spans.seconds("decode_chunk") * 1e3 / steps if steps else None
