"""Admission ms per admitted request: the engine's bucket prefill of the
requests that came due and their copy into free slots
(``ContinuousEngine._admit_pending`` inside ``step()``), from the
serving driver's ``admit`` spans, each closed by a synchronize.
Layer: inference/continuous.py engine admission.  Moves ttft_p95_ms."""


def read(r):
    spans = r.spans.of("admit")
    n = sum(s["admitted"] for s in spans)
    return r.spans.seconds("admit") * 1e3 / n if n else None
