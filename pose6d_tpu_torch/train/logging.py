"""Training scalars as JSON lines (port of pose6d_tpu/train/logging.py,
metrics.jsonl only: the record keys are the JAX package's)."""
from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir, comment: str = "", run_dir=None):
        if run_dir is not None:
            self.dir = Path(run_dir)
        else:
            stamp = datetime.now().strftime("%b%d_%H-%M-%S")
            self.dir = Path(log_dir) / (
                stamp + ("_" + comment if comment else ""))
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self.step = 0

    def _write(self, rec: dict) -> None:
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log(self, scalars: dict, step: int | None = None):
        step = self.step if step is None else step
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._write(rec)
        self.step = step + 1

    def log_epoch(self, records: list[dict], epoch: int):
        if not records:
            return
        rec = {"epoch": epoch, "time": time.time()}
        rec.update({k + "_epoch": float(np.mean([r[k] for r in records]))
                    for k in records[0]})
        self._write(rec)

    def close(self):
        self._jsonl.close()
