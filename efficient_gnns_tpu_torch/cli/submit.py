"""Result aggregator (counterpart of ``efficient_gnns_tpu/cli/submit.py``):
walk a results directory, group the JSON result files that the port's CLIs
write by experiment, print mean +/- std.

    python -m efficient_gnns_tpu_torch.cli.submit --out_dir results [--expt_name X]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict


def collect(out_dir: str, expt_name: str | None = None):
    """``{experiment key: [result dicts]}`` over every JSON file under
    ``out_dir`` that holds ``statistics`` (the key is the file's stem)."""
    groups: dict[str, list[dict]] = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(out_dir, "**", "*.json"), recursive=True)):
        try:
            with open(path) as f:
                blob = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        if "statistics" not in blob:
            continue
        args = blob.get("args", {})
        if expt_name and args.get("expt_name") != expt_name:
            continue
        groups[os.path.splitext(os.path.basename(path))[0]].append(blob)
    return groups


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", type=str, default="results")
    p.add_argument("--expt_name", type=str, default=None)
    p.add_argument("--metric", type=str, default="final_test",
                   help="statistic stem to report (final_test, highest_valid)")
    args = p.parse_args(argv)

    groups = collect(args.out_dir, args.expt_name)
    if not groups:
        print(f"no result files under {args.out_dir}")
        return

    rows = []
    for key, blobs in sorted(groups.items()):
        # newest file wins if an experiment was re-run
        stats = blobs[-1]["statistics"]
        mean = stats.get(f"{args.metric}_mean")
        std = stats.get(f"{args.metric}_std")
        n_runs = len(blobs[-1].get("runs", [])) or blobs[-1].get(
            "args", {}).get("runs", "?")
        if mean is None:
            continue
        rows.append((key, mean, std, n_runs))

    width = max(len(r[0]) for r in rows)
    print(f"{'experiment':<{width}}  {args.metric} (mean ± std)  runs")
    for key, mean, std, n in rows:
        print(f"{key:<{width}}  {100 * mean:.2f} ± {100 * std:.2f}        {n}")


if __name__ == "__main__":
    main()
