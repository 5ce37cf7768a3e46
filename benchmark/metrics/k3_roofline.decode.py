"""K3's share of its roofline in decode: the least time of the profiled
decode chunks' attention (each live row's valid window of the int8 KV
cache read once a step), divided by K3's device time inside those
chunks.  Layer: ops/decode_attention.py (K3).  Moves tpot_p95_ms."""

from benchmark.roofline import counts


def read(r):
    prof = r.profile
    if prof is None:
        return None
    ids = set(prof.span_ids(["decode_chunk"]))
    chunks = [r.spans.items[i] for i in ids]
    bound = sum(counts.k3_bound_s(r.config, c["tokens"], c["kv_positions"])
                for c in chunks)
    t = prof.kernel_seconds(counts.kernel_patterns("k3"), ids=ids)
    return 100.0 * bound / t if bound > 0 and t > 0 else None
