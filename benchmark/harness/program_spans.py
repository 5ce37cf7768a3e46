"""The program's own spans (``seedx_tpu_torch.utils.profiling.records()``)
as the per-layer readers see them: those of one name that the profiled
sub-window holds whole, and the share of their time in which the card
was idle.  A program that keeps no span records (an older commit) gives
None, as does a run that profiled nothing."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional


def spans(r, name: str) -> Optional[List[Dict]]:
    """The program's ``name`` spans wholly inside the profiled
    sub-window; None where the program keeps no span records or nothing
    was profiled."""
    from seedx_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    prof = r.profile
    if records is None or prof is None or prof.window_s <= 0:
        return None
    lo, hi = prof.window
    return [s for s in records()
            if s["name"] == name and lo <= s["t0"] and s["t1"] <= hi]


def idle_share(r, name: str) -> Optional[float]:
    """Share (%) of the time of the program's ``name`` spans in which no
    kernel, copy or set ran on the card."""
    inside = spans(r, name)
    if not inside:
        return None
    busy = r.profile.busy_intervals()
    starts = [b[0] for b in busy]
    total = idle = 0
    for s in inside:
        t0, t1 = s["t0"], s["t1"]
        covered = 0
        for b0, b1 in busy[max(bisect.bisect_right(starts, t0) - 1, 0):]:
            if b0 >= t1:
                break
            covered += max(0, min(b1, t1) - max(b0, t0))
        total += t1 - t0
        idle += t1 - t0 - covered
    return 100.0 * idle / total if total > 0 else None
