"""K6's share of its roofline in prefill: the least time of the routed
experts' work of the profiled prefill groups (each prompt's real tokens,
top-k rows each, through every MoE layer; the weights of every expert a
row reaches read once), divided by K6's device time inside those groups.
Layer: ops/moe.py (K6).  Moves ttft_p95_ms."""

from benchmark.roofline import counts, deepseek_v2 as dsv2


def read(r):
    prof = r.profile
    if prof is None:
        return None
    ids = set(prof.span_ids(["prefill_group"]))
    groups = [r.spans.items[i] for i in ids]
    bound = sum(dsv2.k6_prefill_bound_s(r.config, g["p_lens"])
                for g in groups)
    t = prof.kernel_seconds(counts.kernel_patterns("k6"), ids=ids)
    return 100.0 * bound / t if bound > 0 and t > 0 else None
