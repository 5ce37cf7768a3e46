"""K1's share of its roofline in prefill: the least time of the causal
attention of the profiled prefill groups (each prompt's real tokens),
divided by K1's device time inside those groups.  Layer:
ops/flash_attention.py (K1, causal).  Moves ttft_p95_ms."""

from benchmark.roofline import counts


def read(r):
    prof = r.profile
    if prof is None:
        return None
    ids = set(prof.span_ids(["prefill_group"]))
    bound = counts.k1_prefill_bound_s(
        r.config, [r.spans.items[i]["p_lens"] for i in ids])
    t = prof.kernel_seconds(counts.kernel_patterns("k1"), ids=ids)
    return 100.0 * bound / t if bound > 0 and t > 0 else None
