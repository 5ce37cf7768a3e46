"""Metric writers: jsonl + tensorboard events (reference:
seedx_tpu/utils/trackers.py; the reference logs through Accelerate's
trackers, src/train/train_seed_x_sft.py:147-156).

One ``log(metrics, step)`` call fans out to ``metrics.jsonl`` (one JSON
object per logged step, always on), to tensorboard event files under
``<output_dir>/tb/`` when ``torch.utils.tensorboard`` imports, and to
wandb in offline mode when ``wandb`` imports and ``WANDB_MODE`` is not
"disabled" (the reference's offline-mode tracker).  A writer that fails to
start is disabled with a warning and the run goes on unchanged: a tracker
must not end a run.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Sequence

logger = logging.getLogger(__name__)


class MetricWriters:
    def __init__(self, output_dir: str,
                 trackers: Sequence[str] = ("jsonl", "tensorboard"),
                 expr_name: str = ""):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if "jsonl" in trackers:
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if "tensorboard" in trackers:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    log_dir=os.path.join(output_dir, "tb"),
                    filename_suffix=("." + expr_name) if expr_name else "")
            except Exception as e:   # missing package, read-only fs, ...
                logger.warning("tensorboard tracker disabled: %s", e)
        if "wandb" in trackers and os.environ.get(
                "WANDB_MODE", "offline") != "disabled":
            try:
                import wandb

                # offline + local dir, like the reference's hardcoded
                # offline-mode tracker (train_seed_x_sft.py:232-241)
                self._wandb = wandb.init(
                    project=expr_name or "seedx_tpu", dir=output_dir,
                    mode=os.environ.get("WANDB_MODE", "offline"))
            except Exception as e:   # not installed, no local dir, ...
                logger.warning("wandb tracker disabled: %s", e)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(dict(metrics, step=step)) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), global_step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
