"""The comparison that decides ``correct`` for a training cell.

The program's first ``steps`` epochs (run in set-up through the window's own
``run_epochs``) against the reference's, from the same initial state and
inputs. Six numbers, each a relative gap; a cell's limits file names those it
holds to a limit:

* ``loss``: the largest gap of a step's training loss, over the reference's;
  ``loss1`` the same of the first step alone;
* ``grad``: the worst leaf's gap between the norms of the first gradient
  (the program's read from its optimizer's state after one step), over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``change``: the same of each leaf's change over the steps, leaving out
  the leaves whose reference gradient is under a thousandth of the median
  leaf's (a bias that BatchNorm cancels moves under Adam by round-off);
* ``eval``: the largest gap of an evaluation's logits over the largest
  reference logit, the worst of the steps; ``eval_rms`` the norm of the
  logits' difference over the norm of the reference's;
* ``first_layer``: the norm of the first layer's output difference in the
  first forward, over the norm of the reference's. Its inputs are the same
  on both sides, so it reads the rounding of one layer, where a lower
  precision of the matrix products shows before any later rounding (the
  teacher's bfloat16 messages) hides it;
* ``best`` (where the program tracks a best-validation evaluation): the
  worst of the gap of its validation loss, over the reference's lowest, and
  the norm gaps of its logits and its penultimate features, over the norms
  of the reference's at the lowest validation loss (a largest gap among
  750 features a node swings from run to run with one node's rounding).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

NAMES = ("loss", "loss1", "grad", "change", "eval", "eval_rms", "first_layer", "best")


def _worst(gaps) -> float:
    """The largest gap; infinite where any is not finite (a NaN compares
    false and would drop out of ``max``)."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return _worst(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def max_gap(p, r) -> float:
    """The largest entry of ``|p - r|`` over the largest of ``|r|``."""
    if p.shape != r.shape:
        return math.inf
    return float((p.to(r.device).float() - r).abs().max() / r.abs().max().clamp_min(1e-30))


def norm_gap(p, r) -> float:
    """The norm of ``p - r`` over the norm of ``r``."""
    if p is None or r is None or p.shape != r.shape:
        return math.inf
    return float((p.to(r.device).float() - r).norm() / r.norm().clamp_min(1e-30))


def best_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The parts of ``best``: validation loss, logits, features."""
    p, r = prog["best"], ref["best"]
    return {"val_loss": abs(p["val_loss"] - r["val_loss"]) / max(abs(r["val_loss"]), 1e-30),
            "logits": norm_gap(p["logits"], r["logits"]),
            "feats": norm_gap(p["feats"], r["feats"])}


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number of ``NAMES`` (``best`` only where the reference tracks
    one); infinite where the program's readings are missing."""
    names = [k for k in NAMES if k != "best" or "best" in ref]
    if (not prog["loss"] or len(prog["loss"]) != len(ref["loss"])
            or len(prog["eval"]) != len(ref["eval"])
            or len(prog["first_layer"]) != len(ref["first_layer"])
            or ("best" in ref and "best" not in prog)):
        return {k: math.inf for k in names}
    loss = _worst(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    still = still_leaves(ref)
    moved = [k for k in ref["grad"] if k not in still]
    evals = list(zip(prog["eval"], ref["eval"]))
    out = {"loss": loss,
           "loss1": abs(prog["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]), 1e-30),
           "grad": _leaf_gap(prog["grad"], ref["grad"], ref["grad"]),
           "change": _leaf_gap(prog["change"], ref["change"], moved),
           "eval": _worst(max_gap(p, r) for p, r in evals),
           "eval_rms": _worst(norm_gap(p, r) for p, r in evals),
           "first_layer": _worst(norm_gap(p, r)
                                 for p, r in zip(prog["first_layer"], ref["first_layer"]))}
    if "best" in ref:
        out["best"] = _worst(best_gaps(prog, ref).values())
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """``correct`` (every number that ``limits`` names finite and within its
    limit) and one line a number, those not compared first."""
    ok = True
    lines = [f"not compared: {k} {values[k]!r}" for k in NAMES
             if k in values and k not in limits]
    for k in NAMES:
        if k not in limits:
            continue
        v, lim = values.get(k, math.inf), limits[k]
        passed = math.isfinite(v) and v <= lim
        ok &= passed
        lines.append(f"check {k} {v!r} limit {lim!r} {'ok' if passed else 'FAIL'}")
    return ok, lines


def still_leaves(ref: dict) -> List[str]:
    """The leaves left out of ``change``."""
    gmed = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    return [k for k, g in ref["grad"].items() if g < 1e-3 * gmed]
