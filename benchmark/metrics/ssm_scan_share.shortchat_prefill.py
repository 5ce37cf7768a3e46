"""Share of the prefill groups' time spent in the Mamba blocks' chunked
scan: the device time (CUDA events) of the program's ``llm.ssm_scan``
spans (one a Mamba block of an eager prefill: the conv, the scan, the
state written) that lie inside the harness's profiled prefill groups,
divided by those groups' time (host spans closed by a synchronize, so
each holds its scans' events whole: the share cannot pass 100).  Layer:
models/mamba.py + ops/ssm.py (the chunked scan).  Moves ttft_p95_ms."""

from benchmark.harness.program_spans import spans


def read(r):
    prof = r.profile
    scans = spans(r, "llm.ssm_scan")
    if prof is None or not scans:
        return None
    ids = set(prof.span_ids(["prefill_group"]))
    groups = [(s0, s1) for s0, s1, _, sid in prof.spans if sid in ids]
    inside = [s["device_ms"] for s in scans
              if s["device_ms"] is not None
              and any(a <= s["t0"] and s["t1"] <= b for a, b in groups)]
    t = sum(b - a for a, b in groups) * 1e-9
    if not inside or t <= 0:
        return None
    return 100.0 * sum(inside) * 1e-3 / t
