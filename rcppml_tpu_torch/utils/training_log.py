"""Training logger callback object (R/training_log.R:34-281).

Collects per-iteration (iter, train, test, wall_ms) snapshots via the
``on_iteration`` callback mechanism; supports snapshots of factor matrices
and export to dict/CSV.  A copy of ``rcppml_tpu/utils/training_log.py``.
"""

from __future__ import annotations

import csv
import time
from typing import Any, Dict, List, Optional


class TrainingLogger:
    def __init__(self, *, snapshot_every: int = 0):
        self.records: List[Dict[str, Any]] = []
        self.snapshots: Dict[int, Any] = {}
        self.snapshot_every = snapshot_every
        self._t0 = time.perf_counter()

    def __call__(self, iteration: int, train_loss: float,
                 test_loss: float = float("nan"), model=None):
        self.records.append({
            "iter": int(iteration),
            "train_loss": float(train_loss),
            "test_loss": float(test_loss),
            "wall_ms": (time.perf_counter() - self._t0) * 1000.0,
        })
        if (self.snapshot_every and model is not None
                and iteration % self.snapshot_every == 0):
            self.snapshots[iteration] = model

    def attach_history(self, result):
        """Populate from a fitted NMFResult's loss histories."""
        hist = result.loss_history
        test = result.test_loss_history
        if hist is None:
            return self
        for i, tl in enumerate(hist):
            self.records.append({
                "iter": i + 1,
                "train_loss": float(tl),
                "test_loss": float(test[i]) if test is not None else float("nan"),
                "wall_ms": float("nan"),
            })
        return self

    def export(self) -> List[Dict[str, Any]]:
        return list(self.records)

    def to_csv(self, path: str) -> None:
        # an empty logger still writes a header-only file, like the
        # reference's empty data.frame export (R/training_log.R)
        fields = (list(self.records[0].keys()) if self.records
                  else ["iteration", "train_loss", "test_loss"])
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(self.records)

    def __len__(self):
        return len(self.records)


def training_logger(**kw) -> TrainingLogger:
    return TrainingLogger(**kw)


def export_log(logger: "TrainingLogger", path: str):
    """Write a logger's records as CSV and return them
    (R/training_log.R export_log returns the data.frame)."""
    logger.to_csv(path)
    return logger.export()
