"""K2's share of its roofline in prefill: the least time of the
projection work of the profiled prefill groups in which K2 ran (counted
over the prompts' real tokens), divided by K2's device time inside those
groups.  A group K2 did not serve (the port takes a W4A16 branch past
2048 rows) is left out here and seen by ``mfu.prefill``; once K2 serves
it, it counts here with no change to this file.  Layer:
ops/int4_matmul.py (K2).  Moves ttft_p95_ms."""

from benchmark.roofline import counts


def read(r):
    prof = r.profile
    if prof is None:
        return None
    by_group = prof.kernel_seconds_by_span(
        counts.kernel_patterns("k2"), set(prof.span_ids(["prefill_group"])))
    calls = [sum(r.spans.items[i]["p_lens"]) for i in by_group]
    t = sum(by_group.values())
    if not calls or t <= 0:
        return None
    return 100.0 * counts.k2_bound_s(r.config, calls) / t
