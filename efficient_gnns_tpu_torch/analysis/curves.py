"""Learning-curve plots from metrics JSONL (counterpart of
``efficient_gnns_tpu/analysis/curves.py``): a two-panel loss | accuracy PNG
from the stream that :class:`~efficient_gnns_tpu_torch.train.metrics.MetricsWriter`
writes. Reading the records needs nothing; the plot needs matplotlib,
imported only when a plot is drawn.

    python -m efficient_gnns_tpu_torch.analysis.curves <log_dir> [--out curves.png]
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

from efficient_gnns_tpu_torch.train.metrics import read_jsonl


def _series(rows: List[dict], key: str):
    """``(steps, values)`` of ``key`` over the records that hold it; a record
    without ``step`` takes its index among them."""
    xs, ys = [], []
    for r in rows:
        if key in r:
            xs.append(r.get("step", len(xs)))
            ys.append(r[key])
    return xs, ys


def plot_curves(
    log_dir: str,
    out_path: Optional[str] = None,
    loss_keys: Iterable[str] = ("loss/train", "loss/cls", "loss/aux"),
    acc_keys: Iterable[str] = ("acc/train", "acc/valid", "acc/test"),
) -> str:
    """Write a two-panel (loss | accuracy) learning-curve PNG of
    ``<log_dir>/metrics.jsonl``; returns its path (``<log_dir>/curves.png``
    by default). Raises ``ImportError`` where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plot_curves needs matplotlib, which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = read_jsonl(log_dir)
    if not rows:
        raise FileNotFoundError(f"no metrics.jsonl rows under {log_dir}")
    fig, (ax_l, ax_a) = plt.subplots(1, 2, figsize=(11, 4))
    for ax, keys, label in ((ax_l, loss_keys, "loss"), (ax_a, acc_keys, "accuracy")):
        for k in keys:
            xs, ys = _series(rows, k)
            if xs:
                ax.plot(xs, ys, label=k)
        ax.set_xlabel("epoch")
        ax.set_ylabel(label)
        ax.legend()
    fig.tight_layout()
    out_path = out_path or os.path.join(log_dir, "curves.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="plot learning curves from metrics.jsonl")
    p.add_argument("log_dir")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    print(plot_curves(args.log_dir, args.out))


if __name__ == "__main__":
    main()
