"""Profiling and numerical-health utilities (reference:
seedx_tpu/utils/profiling.py, which wraps ``jax.profiler``).

The reference has no first-party tracing (SURVEY.md §5: tqdm step timing
only) and relies on print-probes for NaN/Inf in the LLM forward
(modeling_llama_xformer.py:702-714,731-735).  Here:

  * ``trace(logdir)`` — ``torch.profiler`` over the block (the host and,
    on the card, the device), written as a chrome trace
    ``<logdir>/trace.json`` that ``chrome://tracing`` or Perfetto opens,
  * ``annotate(name)`` — ``torch.profiler.record_function``, a labelled
    region in that trace,
  * ``check_finite(tensors)`` — an all-finite probe over a dict of tensors
    with one host sync for the whole dict,
  * ``StepTimer`` — wall-clock steps/sec with EMA, the tqdm analogue.

Kept for parity with the JAX package's API, for a caller's own loop: the
port's loops do not call them (``train_loop`` times its phases itself,
and ``chip_smoke.py`` profiles through its own ``profile_window``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Mapping, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write ``<logdir>/trace.json``.  CUDA
    activity is recorded when the card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


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
