"""Run logging (counterpart of ``st3d/utils/logging.py``): the reference's
``log.txt`` format plus ``metrics.jsonl`` records with timing fields. In a
world of several ranks only rank 0 logs: the others' loggers are built
with ``active=False`` and write nothing."""

from __future__ import annotations

import json
import os
import time


class RunLogger:
    def __init__(self, output_path: str, jsonl: bool = True,
                 active: bool = True):
        self._fh = self._jsonl = None
        if not active:
            return
        os.makedirs(output_path, exist_ok=True)
        self.path = os.path.join(output_path, "log.txt")
        self._fh = open(self.path, "w")
        self._fh.write("Logger:\n")
        self._fh.flush()
        if jsonl:
            self._jsonl = open(os.path.join(output_path, "metrics.jsonl"), "w")
        self._t0 = time.time()

    def log_step(self, batch: int, step: int, loss: float, **extra) -> None:
        """First-approach format: ``Batch i, Step s, Loss v``."""
        if self._fh is None:
            return
        self._fh.write(f"Batch {batch}, Step {step}, Loss {loss}\n")
        self._fh.flush()
        self._metric(dict(batch=batch, step=step, loss=loss, **extra))

    def log_epoch(self, epoch: int, loss: float, **extra) -> None:
        """Second-approach format: ``Epoch e, Loss v``."""
        if self._fh is None:
            return
        self._fh.write(f"Epoch {epoch}, Loss {loss}\n")
        self._fh.flush()
        self._metric(dict(epoch=epoch, loss=loss, **extra))

    def _metric(self, record: dict) -> None:
        if self._jsonl is None:
            return
        record["t"] = round(time.time() - self._t0, 4)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._jsonl is not None:
            self._jsonl.close()
