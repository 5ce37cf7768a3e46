"""Admission's share of the card's bf16 peak: the least time the model
operations of every prefill need (real prompt tokens through the
parameters they activate and the recurrence, causal attention in the
attention blocks, one LM-head row a prompt), divided by the time of the
admission spans.  Layer: the whole step.  Moves ttft_p95_ms."""

from benchmark.roofline import nemotron_h as nh


def read(r):
    groups = r.spans.of("prefill_group")
    t = r.spans.seconds("admit")
    least = sum(nh.prefill_least_s(r.config, g["p_lens"]) for g in groups)
    return 100.0 * least / t if least > 0 and t > 0 else None
