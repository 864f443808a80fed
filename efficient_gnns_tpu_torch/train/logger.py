"""Run logger (counterpart of ``efficient_gnns_tpu/train/logger.py``), with
the reference's ``Logger`` conventions (``arxiv_pyg/logger.py:4-44``):
per-run (train, valid, test) history, best-validation-epoch selection, and
mean +/- std aggregation across runs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class Logger:
    def __init__(self, runs: int):
        self.results: List[List[Tuple[float, float, float]]] = [
            [] for _ in range(runs)
        ]

    def add_result(self, run: int, result: Tuple[float, float, float]) -> None:
        assert 0 <= run < len(self.results)
        self.results[run].append(tuple(float(v) for v in result))

    def best_epoch(self, run: int) -> int:
        r = np.asarray(self.results[run])
        return int(r[:, 1].argmax())

    def run_statistics(self, run: int) -> dict:
        r = np.asarray(self.results[run])
        best = self.best_epoch(run)
        return {
            "highest_train": float(r[:, 0].max()),
            "highest_valid": float(r[:, 1].max()),
            "final_train": float(r[best, 0]),
            "final_test": float(r[best, 2]),
            "best_epoch": best,
        }

    def statistics(self) -> dict:
        """Across-run aggregation at each run's best-validation epoch."""
        per_run = []
        for run, res in enumerate(self.results):
            if not res:
                continue
            s = self.run_statistics(run)
            per_run.append(
                [s["highest_train"], s["highest_valid"], s["final_train"], s["final_test"]]
            )
        a = np.asarray(per_run)
        keys = ["highest_train", "highest_valid", "final_train", "final_test"]
        out = {}
        for i, k in enumerate(keys):
            out[f"{k}_mean"] = float(a[:, i].mean())
            out[f"{k}_std"] = float(a[:, i].std())
        return out

    def print_statistics(self, run: Optional[int] = None) -> None:
        if run is not None:
            s = self.run_statistics(run)
            print(
                f"Run {run + 1:02d}: "
                f"Highest Train: {100 * s['highest_train']:.2f}, "
                f"Highest Valid: {100 * s['highest_valid']:.2f}, "
                f"Final Train: {100 * s['final_train']:.2f}, "
                f"Final Test: {100 * s['final_test']:.2f}"
            )
        else:
            s = self.statistics()
            print("All runs:")
            print(
                f"Highest Valid: {100 * s['highest_valid_mean']:.2f} "
                f"± {100 * s['highest_valid_std']:.2f}"
            )
            print(
                f"Final Test: {100 * s['final_test_mean']:.2f} "
                f"± {100 * s['final_test_std']:.2f}"
            )
