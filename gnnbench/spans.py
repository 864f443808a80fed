"""The program's span recorder (``efficient_gnns_tpu_torch/tracing.py``) in
one cell, outside ``gnnbench.run``, which never turns it on:

    python -m gnnbench.spans --workload <cell> --seed <n> --seconds <s> --pairs 6

Set-up (the harness's ``prepare``) runs with the recorder on; its spans are
written to ``out/spans-<cell>.json`` and the graph build's are printed on
one ``set-up spans s:`` line. Then ``pairs`` pairs of windows of
``seconds`` each (the harness's ``window``, the profiler off) run with the
recorder off and on in turns, off first in even pairs and on first in odd
ones; each pair prints both ``epoch_ms``, and the last line the median of
on over off, the recorder's cost when on.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

from gnnbench import harness
from gnnbench.spec import HERE, Spec

GRAPH_SPANS = ("graph.build", "graph.sort", "graph.hub_partition", "graph.row_split")


def setup_line(records, phases: dict) -> str:
    """``set-up spans s:`` with the seconds of each graph span (summed over
    the builds) and the harness's set-up phases."""
    s = dict.fromkeys(GRAPH_SPANS, 0.0)
    for r in records:
        if r.name in s:
            s[r.name] += (r.t1_ns - r.t0_ns) / 1e9
    return ("set-up spans s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.items())
            + "; harness: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from efficient_gnns_tpu_torch import tracing

    device = torch.device(args.device)
    tracing.reset()
    tracing.enable()
    try:
        s = harness.prepare(Spec(), args.workload, args.seed, device)
    finally:
        tracing.enable(False)
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    tracing.export(os.path.join(HERE, "out", f"spans-{args.workload}.json"))
    print(setup_line(tracing.records(), s.phases), flush=True)

    start, est, ratios = s.traffic["check_steps"], s.est, []
    for i in range(args.pairs):
        ms = {}
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            tracing.reset()
            tracing.enable(on)
            try:
                done, elapsed, _, _ = harness.window(s.prog, start, args.seconds, est,
                                                     s.traffic["epoch_chunk"], device)
            finally:
                tracing.enable(False)
            start += done
            est = elapsed / done
            ms[on] = elapsed * 1e3 / done
            if on:
                spans = len(tracing.records()) / done
        ratios.append(ms[True] / ms[False])
        print(f"pair {i}: epoch_ms recorder off {ms[False]:.4f}, on {ms[True]:.4f} "
              f"({spans:.2f} spans an epoch)", flush=True)
    print(f"recorder cost: median on/off - 1 = {100 * (statistics.median(ratios) - 1):+.3f}% "
          f"over {args.pairs} pairs of {args.seconds} s ({args.workload})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
