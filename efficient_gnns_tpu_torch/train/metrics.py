"""Per-epoch metrics writer and reader (counterpart of
``efficient_gnns_tpu/train/metrics.py``), with the same JSONL schema: one
record per epoch, ``{"step": epoch, "loss/train": ..., "acc/valid": ...}``,
and optional TensorBoard event files under the same scalar names.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, tensorboard: bool = False,
                 filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._f = open(os.path.join(log_dir, filename), "a")
        self._tb = None
        if tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(log_dir: str, filename: str = "metrics.jsonl"):
    """All records of a metrics JSONL file, in order (blank lines skipped)."""
    with open(os.path.join(log_dir, filename)) as f:
        return [json.loads(line) for line in f if line.strip()]
