"""K2's share of its roofline in decode: the least time of the profiled
decode chunks' projection work (each step's live rows through the seven
int4 projections of every layer: codes and scales read once a step),
divided by K2's device time inside those chunks.  Layer: ops/int4_matmul.py
(K2).  Moves tpot_p95_ms."""

from benchmark.roofline import counts


def read(r):
    prof = r.profile
    if prof is None:
        return None
    ids = set(prof.span_ids(["decode_chunk"]))
    chunks = [r.spans.items[i] for i in ids]
    calls = []
    for c in chunks:
        if c["steps"]:
            calls += [c["tokens"] / c["steps"]] * c["steps"]
    t = prof.kernel_seconds(counts.kernel_patterns("k2"), ids=ids)
    if not calls or t <= 0:
        return None
    return 100.0 * counts.k2_bound_s(r.config, calls) / t
