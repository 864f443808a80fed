"""Experiment sweep runner (counterpart of ``efficient_gnns_tpu/cli/sweep.py``),
driven by the same JSON grids in ``experiments/``: each names a workload (a
module of ``efficient_gnns_tpu_torch.cli``), shared base flags, per-config
overrides and ``seed_shards``, one subprocess per shard, run ``--procs`` at a
time.

    python -m efficient_gnns_tpu_torch.cli.sweep experiments/arxiv_gcn.json
    python -m efficient_gnns_tpu_torch.cli.sweep experiments/mag.json --dry_run
    python -m efficient_gnns_tpu_torch.cli.sweep experiments/ppi.json \\
        --only supervised kd --extra --epochs 5
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List


def _flag(key: str, val) -> List[str]:
    key = key if key.startswith("-") else f"--{key}"
    if isinstance(val, bool):
        return [key] if val else []
    return [key, str(val)]


def build_commands(spec: Dict, only=None, extra=None) -> List[List[str]]:
    """One command a (config, seed shard) of ``spec``: ``python -m
    efficient_gnns_tpu_torch.cli.<workload>`` with the base flags, the
    config's (keys starting with ``_`` left out), ``--seed`` and ``extra``;
    ``only`` keeps the configs whose ``expt_name`` holds one of its
    substrings."""
    workload = spec["workload"]
    base = spec.get("base", {})
    shards = spec.get("seed_shards", [0])
    cmds = []
    for cfg in spec["configs"]:
        name = cfg.get("expt_name") or cfg.get("expt-name") or ""
        if only and not any(o in name for o in only):
            continue
        merged = {**base, **cfg}
        for seed in shards:
            cmd = [sys.executable, "-m", f"efficient_gnns_tpu_torch.cli.{workload}"]
            for k, v in merged.items():
                if not k.startswith("_"):
                    cmd += _flag(k, v)
            cmd += _flag("seed", seed)
            cmd += list(extra or [])
            cmds.append(cmd)
    return cmds


def main(argv=None):
    p = argparse.ArgumentParser(description="experiment sweep runner")
    p.add_argument("experiment", type=str, help="experiments/*.json spec")
    p.add_argument("--dry_run", action="store_true", help="print commands only")
    p.add_argument("--procs", type=int, default=1, help="concurrent shard processes")
    p.add_argument("--only", nargs="*", default=None, help="substring filter on expt_name")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=None,
                   help="extra flags appended to every command")
    args = p.parse_args(argv)

    with open(args.experiment) as f:
        spec = json.load(f)
    cmds = build_commands(spec, only=args.only, extra=args.extra)
    if args.dry_run:
        for c in cmds:
            print(" ".join(c))
        return 0

    failures = 0
    running: List[subprocess.Popen] = []
    t0 = time.time()
    for i, cmd in enumerate(cmds):
        while len(running) >= args.procs:
            for proc in list(running):
                if proc.poll() is not None:
                    running.remove(proc)
                    failures += proc.returncode != 0
            time.sleep(0.5)
        print(f"[{time.time() - t0:7.1f}s] launch {i + 1}/{len(cmds)}: {' '.join(cmd)}",
              flush=True)
        running.append(subprocess.Popen(cmd, cwd=os.getcwd()))
    for proc in running:
        proc.wait()
        failures += proc.returncode != 0
    print(f"sweep done: {len(cmds) - failures}/{len(cmds)} ok in {time.time() - t0:.1f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
