"""The port's span recorder, profiling and numerical-health utilities
(reference: seedx_tpu/utils/profiling.py, which wraps ``jax.profiler``).

The reference has no first-party tracing (SURVEY.md §5: tqdm step timing
only) and relies on print-probes for NaN/Inf in the LLM forward
(modeling_llama_xformer.py:702-714,731-735).  Here:

  * ``annotate(name, rid=None, device=False, start=None, **attrs)`` — the
    program's one span API, a context manager the port's loops call at their
    layer boundaries (the span names and their attributes: README.md,
    "Tracing the port"). It is **off** by default: a span site then costs
    one check and gets back a shared null record that takes attributes and
    keeps none (no clock read, no CUDA event, no profiler range, no
    allocation). It is **on** inside ``recording()`` and, on the thread that
    started it, while a ``torch.profiler`` session records. On, a span keeps
    a record: its name, an id, the id of the innermost span open on the same
    thread (its parent), ``rid`` for the spans of one request, its
    attributes (the yielded record takes more: counts are set where the work
    happens), and its host start and end in ns on ``now()``'s clock, the one
    ``torch.profiler`` stamps its events with, so a kernel of the same
    profile can be placed inside a span. With ``device=True`` two
    ``torch.cuda.Event``s recorded on the current stream at open and close
    (or at ``end_device()``) give the device time between them, read when
    the records are read, never by a synchronize at the site; a span opened
    while the stream is capturing a CUDA graph records no event. An on span
    is also a range in the profiler's trace (a function-scope record
    function: it adds no annotation to the device's timeline, where it would
    read as device work),
  * ``records()`` — the records kept (at most ``MAX_RECORDS``; past that
    they are dropped and counted in ``dropped()``), device ms resolved;
    they stay until ``clear()``, so a caller that records under its own
    profiler or ``recording()`` reads them and then clears them,
  * ``trace(logdir)`` — ``torch.profiler`` over the block (the host and,
    on the card, the device), written as a chrome trace
    ``<logdir>/trace.json`` that ``chrome://tracing`` or Perfetto opens,
    and the spans that closed in the block, taken out of the kept records,
    as ``<logdir>/spans.jsonl``,
  * ``check_finite(tensors)`` — an all-finite probe over a dict of tensors
    with one host sync for the whole dict,
  * ``StepTimer`` — wall-clock steps/sec with EMA, the tqdm analogue.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional

import torch

MAX_RECORDS = 1 << 20


class _Recorder:
    """What the module records: the switch's depth, the kept spans, the
    ids, each thread's open spans."""

    def __init__(self):
        self.depth = 0
        self.spans: List["Span"] = []
        self.dropped = 0
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()


_rec = _Recorder()


def now() -> int:
    """ns on the clock ``torch.profiler`` stamps its events with (the Unix
    time its approximate clock is converted to)."""
    return time.time_ns()


def enabled() -> bool:
    """Whether span sites on this thread record."""
    return _rec.depth > 0 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn span recording on for the block, on every thread."""
    with _rec.lock:
        _rec.depth += 1
    try:
        yield
    finally:
        with _rec.lock:
            _rec.depth -= 1


class _Off:
    """The shared record of a span site while recording is off: it takes
    attributes and keeps none, and is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def end_device(self) -> None:
        pass


_OFF = _Off()


class Span:
    """One recorded span (see the module docstring); ``span[key] = value``
    sets an attribute."""

    __slots__ = ("name", "id", "parent", "rid", "attrs", "t0", "t1",
                 "_device", "_events", "_range", "_ms")

    def __init__(self, name: str, rid, device: bool, start: Optional[int],
                 attrs: Dict[str, Any]):
        self.name, self.rid, self.attrs = name, rid, attrs
        self._device = device
        self.t0 = start
        self._events = self._range = self._ms = None

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        stack = getattr(_rec.local, "stack", None)
        if stack is None:
            stack = _rec.local.stack = []
        self.id = next(_rec.ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        # a span given its start began before the block: it has no range
        # in the profiler's trace
        opens_now = self.t0 is None
        if opens_now:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        if self._device and torch.cuda.is_available() and \
                not torch.cuda.is_current_stream_capturing():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events = [ev]
        if opens_now:
            self.t0 = now()
        return self

    def end_device(self) -> None:
        """Record the closing device event now (the span's device work has
        been enqueued; what the block does after is host work)."""
        if self._events is not None and len(self._events) == 1:
            if torch.cuda.is_current_stream_capturing():
                self._events = None
                return
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)

    def __exit__(self, *exc) -> bool:
        self.end_device()
        self.t1 = now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = _rec.local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        with _rec.lock:
            if len(_rec.spans) < MAX_RECORDS:
                _rec.spans.append(self)
            else:
                _rec.dropped += 1
        return False

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's two events (waits for the second);
        None without events."""
        if self._ms is None and self._events is not None:
            ev0, ev1 = self._events
            ev1.synchronize()
            self._ms = ev0.elapsed_time(ev1)
            self._events = None
        return self._ms

    def as_dict(self) -> Dict[str, Any]:
        """The record; an attribute set as a device tensor (a counter's
        growth, taken without a synchronize at the site) is read here,
        once."""
        for k, v in self.attrs.items():
            if torch.is_tensor(v):
                self.attrs[k] = v.item()
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "rid": self.rid, "t0": self.t0, "t1": self.t1,
                "device_ms": self.device_ms(), "attrs": dict(self.attrs)}


def annotate(name: str, /, rid=None, device: bool = False,
             start: Optional[int] = None, **attrs):
    """A span around the block (see the module docstring): ``with
    annotate("engine.chunk", device=True) as span: ... span["ran"] = n``.
    The record is false while recording is off, so work done only for an
    attribute goes under ``if span:``.  ``start`` (ns on ``now()``) opens
    a span that began before the block, as a request's wait does."""
    if not enabled():
        return _OFF
    return Span(name, rid, device, start, attrs)


def records() -> List[Dict[str, Any]]:
    """The kept span records as dicts (``name``, ``id``, ``parent``,
    ``rid``, ``t0`` / ``t1`` ns on ``now()``'s clock, ``device_ms`` or
    None, ``attrs``), in the order they closed."""
    with _rec.lock:
        spans = list(_rec.spans)
    return [s.as_dict() for s in spans]


def dropped() -> int:
    """Spans not kept since the last ``clear()``: past ``MAX_RECORDS``."""
    return _rec.dropped


def clear() -> None:
    """Forget the kept records."""
    with _rec.lock:
        _rec.spans = []
        _rec.dropped = 0


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``<logdir>/trace.json`` and the
    spans that closed in the block, one JSON object a line, as
    ``<logdir>/spans.jsonl``.  Those spans leave the kept records, so each
    block writes its own and a long-lived process does not fill the store.
    CUDA activity is recorded when the card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with _rec.lock:
        n0 = len(_rec.spans)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with _rec.lock:
        mine, _rec.spans = _rec.spans[n0:], _rec.spans[:n0]
    with open(os.path.join(logdir, "spans.jsonl"), "w") as f:
        for s in mine:
            f.write(json.dumps(s.as_dict()) + "\n")


def _flatten(tree: Any, prefix: str = "") -> dict:
    if not isinstance(tree, Mapping):
        return {prefix or "value": tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def check_finite(tree: Any) -> dict:
    """{path: False} for every leaf with a NaN or Inf (empty = healthy);
    nested dicts are joined with '/', as the JAX package's.  One host sync
    for the whole dict: the per-leaf flags are stacked on the device and
    read once."""
    flat = _flatten(tree)
    if not flat:
        return {}
    leaves = [torch.as_tensor(v) for v in flat.values()]
    dev = leaves[0].device
    ok = torch.stack([torch.isfinite(t).all().to(dev)
                      for t in leaves]).tolist()
    return {k: False for k, good in zip(flat, ok) if not good}


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._rate: Optional[float] = None
        self._last = time.perf_counter()

    def tick(self, steps: int = 1) -> float:
        now = time.perf_counter()
        rate = steps / max(now - self._last, 1e-9)
        self._last = now
        self._rate = rate if self._rate is None else (
            self._ema * self._rate + (1 - self._ema) * rate)
        return self._rate
