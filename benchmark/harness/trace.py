"""Spans from the harness's own files, and the profiler's device trace.

``Spans`` records host intervals around the calls a driver makes into
each layer: name, start, end (s on ``time.perf_counter``) and attributes.
In a traced run each span is also a ``torch.profiler.record_function``
annotation and ends with a ``torch.cuda.synchronize()`` (unless it is a
host span, ``wait=False``), so the kernels a span launched run inside it
on the profiler's clock; an untraced run adds no synchronize.  Spans may
be opened from more than one thread.

``Profile`` runs ``torch.profiler`` (CPU and CUDA activity) over a steady
sub-window of a traced run and reduces it to: the device activity
intervals (kernels, copies, sets), each kernel's name, the annotated
spans on the same clock, the window's length and its busy time (the
union of device activity), and a breakdown of the device operations that
took most time and the longest idle gaps, labelled by the span the host
was in.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bench:"


def sync() -> None:
    """Wait for the card (nothing on a machine without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.items: List[Dict] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, wait: bool = True, **attrs):
        """A span; its id is its index in ``items`` and its annotation
        ``bench:<name>#<id>``.  ``wait=False``: a host span, which a traced
        run does not close with a synchronize."""
        with self._lock:
            item = {"name": name, "id": len(self.items), **attrs}
            self.items.append(item)
        rec = None
        if self.traced:
            rec = torch.profiler.record_function(
                f"{PREFIX}{name}#{item['id']}")
            rec.__enter__()
        item["t0"] = item["t1"] = time.perf_counter()
        try:
            yield item
        finally:
            if self.traced and wait:
                sync()
            item["t1"] = time.perf_counter()
            if rec is not None:
                rec.__exit__(None, None, None)

    def of(self, name: str) -> List[Dict]:
        return [s for s in self.items if s["name"] == name]

    def seconds(self, name: str) -> float:
        return sum(s["t1"] - s["t0"] for s in self.of(name))


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def _device_kind(ev) -> str:
    return str(ev.device_type()).rsplit(".", 1)[-1].upper()


class Profile:
    """One profiled sub-window: ``start()`` ... ``stop()``."""

    def __init__(self):
        self.prof = None
        self.kernels: List[Tuple[int, int, str]] = []   # (start, end, name)
        self.spans: List[Tuple[int, int, str, int]] = []  # (.., name, id)
        self.window: Tuple[int, int] = (0, 0)
        self.counts: Dict[str, int] = {}

    def start(self) -> None:
        from torch.autograd import profiler

        self.prof = profiler.profile(
            use_device="cuda" if torch.cuda.is_available() else None,
            use_kineto=True)
        self.prof._prepare_trace()
        self.prof._start_trace()
        self._mark = torch.profiler.record_function(PREFIX + "profiled")
        self._mark.__enter__()

    def stop(self) -> None:
        """Stop recording; the events are read at the first reduction
        (after the window: reading a million events takes seconds)."""
        sync()
        self._mark.__exit__(None, None, None)
        self._results = torch.autograd._disable_profiler()
        self.prof = None
        self._loaded = False

    def _load(self) -> None:
        if getattr(self, "_loaded", True):
            return
        self._loaded = True
        events = self._results.events()
        last = 0
        for ev in events:
            name = ev.name()
            t0 = _ns(ev, "start")
            t1 = t0 + _ns(ev, "duration")
            last = max(last, t1)
            if _device_kind(ev) == "CUDA":
                if not name.startswith(PREFIX):     # gpu user annotations
                    self.kernels.append((t0, t1, name))
            elif name.startswith(PREFIX):
                label, _, sid = name[len(PREFIX):].partition("#")
                if label == "profiled":
                    self.window = (t0, t1)
                else:
                    self.spans.append((t0, t1, label, int(sid)))
        # the window: from the annotation's start to the last event the
        # profiler recorded (an annotation open across the whole profile
        # may come back shortened)
        self.window = (self.window[0], max(self.window[1], last))
        self.kernels.sort()
        self.spans.sort()
        self.counts = {"kernels": len(self.kernels), "spans": len(self.spans),
                       "events": len(events)}
        self._results = None

    # ---- reductions -------------------------------------------------------

    @property
    def window_s(self) -> float:
        self._load()
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the window."""
        self._load()
        lo, hi = self.window
        out: List[List[int]] = []
        for t0, t1, _ in self.kernels:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 <= t0:
                continue
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals()) * 1e-9

    def span_at(self, t: int) -> str:
        """The innermost annotated span covering host time ``t``."""
        self._load()
        best = None
        for s0, s1, label, _ in self.spans:
            if s0 <= t < s1 and (best is None or s0 >= best[0]):
                best = (s0, s1, label)
        return "host" if best is None else best[2]

    def span_ids(self, labels: List[str]) -> List[int]:
        """Ids of the spans named in ``labels`` the profile holds whole."""
        self._load()
        lo, hi = self.window
        return [sid for s0, s1, label, sid in self.spans
                if label in labels and lo <= s0 and s1 <= hi]

    def kernel_seconds(self, patterns: List[str],
                       inside: Optional[List[str]] = None,
                       ids: Optional[set] = None) -> float:
        """Device seconds of the kernels whose name matches any of
        ``patterns`` (regular expressions), limited to those that start
        inside a span named in ``inside`` (or with an id in ``ids``) when
        given."""
        self._load()
        rx = re.compile("|".join(patterns))
        ranges = None
        if inside is not None or ids is not None:
            ranges = sorted((s0, s1) for s0, s1, label, sid in self.spans
                            if (inside is None or label in inside)
                            and (ids is None or sid in ids))
            starts = [r[0] for r in ranges]
        total = 0
        for t0, t1, name in self.kernels:
            if not rx.search(name):
                continue
            if ranges is not None:
                i = bisect.bisect_right(starts, t0) - 1
                if i < 0 or t0 >= ranges[i][1]:
                    continue
            total += t1 - t0
        return total * 1e-9

    def kernel_seconds_by_span(self, patterns: List[str],
                               ids: set) -> Dict[int, float]:
        """Device seconds of the kernels matching ``patterns`` that start
        inside each span of ``ids`` (spans that do not nest), by span id;
        spans where none ran are left out."""
        self._load()
        rx = re.compile("|".join(patterns))
        ranges = sorted((s0, s1, sid) for s0, s1, _, sid in self.spans
                        if sid in ids)
        starts = [r[0] for r in ranges]
        out: Dict[int, float] = {}
        for t0, t1, name in self.kernels:
            if not rx.search(name):
                continue
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t0 < ranges[i][1]:
                sid = ranges[i][2]
                out[sid] = out.get(sid, 0.0) + (t1 - t0) * 1e-9
        return out

    def breakdown(self, top: int = 10) -> Dict:
        self._load()
        by_name: Dict[str, int] = {}
        lo, hi = self.window
        for t0, t1, name in self.kernels:
            if t1 > lo and t0 < hi:
                by_name[name] = by_name.get(name, 0) + (t1 - t0)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        prev = lo
        for t0, t1 in self.busy_intervals() + [(hi, hi)]:
            if t0 > prev:
                gaps.append((t0 - prev, (prev + t0) // 2))
            prev = max(prev, t1)
        longest = sorted(gaps, key=lambda g: -g[0])[:top]
        return {"device_ops": [[short(n), v * 1e-9] for n, v in ops],
                "idle_gaps": [[self.span_at(mid), g * 1e-9]
                              for g, mid in longest]}


def short(name: str, limit: int = 120) -> str:
    """A kernel name cut to its function and first template arguments."""
    return name if len(name) <= limit else name[:limit]
