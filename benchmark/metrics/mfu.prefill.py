"""Admission's share of the card's peak: the least time the model
operations of every prefill need (real prompt tokens through the
projections at the int8 peak; causal attention, one row of logits a
prompt and the input resampler at bf16), divided by the time of the
admission spans.  Layer: the whole step.  Moves ttft_p95_ms."""

from benchmark.roofline import counts


def read(r):
    groups = r.spans.of("prefill_group")
    t = r.spans.seconds("admit")
    least = sum(counts.prefill_least_s(r.config, g["p_lens"], g["images"])
                for g in groups)
    return 100.0 * least / t if least > 0 and t > 0 else None
