"""Learning-rate schedules as plain Python functions of the step (reference:
seedx_tpu/train/schedule.py, which builds them from optax).

``cosine_with_min_lr`` is the reference's custom cosine schedule
(src/train/schedular.py:18-30): a linear warmup 0 -> lr over
``warmup_steps``, then ``lr * 0.5 * ((1 + r) + (1 - r) * cos(pi *
progress))`` with floor ``r * lr``.  The others follow optax's
``constant_schedule``, ``linear_schedule`` (held at its initial value
when it has no steps to anneal over) and ``join_schedules``.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_with_min_lr(learning_rate: float, warmup_steps: int,
                       total_steps: int, min_lr_ratio: float = 0.0,
                       num_cycles: float = 0.5) -> Schedule:
    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return learning_rate * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        cos = 0.5 * ((1.0 + min_lr_ratio) + (1.0 - min_lr_ratio)
                     * math.cos(math.pi * num_cycles * 2.0 * progress))
        return learning_rate * max(0.0, cos)

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda step: init

    def schedule(step: int) -> float:
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def get_schedule(name: str, learning_rate: float, warmup_steps: int = 0,
                 total_steps: int = 0, min_lr_ratio: float = 0.0) -> Schedule:
    """Registry mirroring the reference's get_scheduler
    (src/train/schedular.py:83-128)."""
    if name == "cosine":
        return cosine_with_min_lr(learning_rate, warmup_steps, total_steps,
                                  min_lr_ratio)
    if name == "constant":
        return lambda step: learning_rate
    if name == "constant_with_warmup":
        return _linear(0.0, learning_rate, warmup_steps)
    if name == "linear":
        up = _linear(0.0, learning_rate, warmup_steps)
        down = _linear(learning_rate, 0.0, max(1, total_steps - warmup_steps))
        return lambda step: (up(step) if step < warmup_steps
                             else down(step - warmup_steps))
    raise ValueError(f"unknown schedule {name!r}")
