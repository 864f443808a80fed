"""Readings that the correctness limits are set from, on the card.

    python -m gnnbench.calibrate --workload <cell> --seeds 1,2,3 [--control tf32,fp8_messages]
        [--half-batch] [--state-unchanged]

For each seed: the program's first steps against the reference's (the
lower readings), and the reference put in the program's place computed in
TF32 (``--control tf32``) or with its hub messages in float8
(``fp8_messages``, the teacher), with each loss over half of its rows
(``--half-batch``), or with its steps leaving the state as it was
(``--state-unchanged``): the upper readings. One JSON line a seed, with
where the program's gaps sit. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gnnbench import check, harness
from gnnbench.spec import Spec


CONTROLS = {"tf32": {"tf32": True}, "fp8_messages": {"msg_dtype": "float8_e4m3fn"}}


def readings(spec: Spec, name: str, seed: int, device, controls=(), half_batch=False,
             frozen=False):
    """The program's numbers against the reference (``program``), and those
    of each control in ``controls`` (names of ``CONTROLS``) and of the
    half-batch and unchanged-state faults put in its place."""
    s = harness.prepare(spec, name, seed, device)
    harness.free(s, device)
    ref = harness.reference(s, seed, device)
    out = {"program": check.numbers(s.got, ref)}
    for c in controls:
        out[f"control_{c}"] = check.numbers(harness.reference(s, seed, device, **CONTROLS[c]),
                                            ref)
    if half_batch:
        out["half_batch"] = check.numbers(
            harness.reference(s, seed, device, half_batch=True), ref)
    if frozen:
        out["state_unchanged"] = check.numbers(
            harness.reference(s, seed, device, frozen=True), ref)
    out["still_leaves"] = check.still_leaves(ref)
    out["detail"] = _detail(s.got, ref)
    return out


def _detail(got: dict, ref: dict) -> dict:
    """Where the program's gaps sit: each step's loss gap, each evaluation's
    largest and norm gaps, each leaf's gradient and change gap, the first
    layer's largest gap, and the parts of ``best`` with the reference's
    validation losses."""
    med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    still = check.still_leaves(ref)
    ev = [(check.max_gap(p, r), check.norm_gap(p, r)) for p, r in zip(got["eval"], ref["eval"])]
    out = {"loss": [abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])],
           "eval_max_rms": ev,
           "first_layer_max": [check.max_gap(p, r)
                               for p, r in zip(got["first_layer"], ref["first_layer"])],
           "grad": {k: abs(got["grad"][k] - v) / max(v, med) for k, v in ref["grad"].items()},
           "change": {k: abs(got["change"][k] - v) / max(v, 1e-30)
                      for k, v in ref["change"].items() if k not in still}}
    if "best" in ref:
        out["best"] = check.best_gaps(got, ref)
        out["ref_val_loss"] = ref["val_losses"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="", help="comma-separated names of CONTROLS")
    p.add_argument("--half-batch", action="store_true")
    p.add_argument("--state-unchanged", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    spec = Spec()
    for seed in (int(x) for x in args.seeds.split(",")):
        controls = [c for c in args.control.split(",") if c]
        out = readings(spec, args.workload, seed, device, controls, args.half_batch,
                       args.state_unchanged)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
