"""Port vs JAX: the sweep runner, the result aggregator and the RESULTS.md
renderer (``cli/sweep.py``, ``cli/submit.py``, ``cli/results.py``).

The sweep builds, from every spec in ``experiments/``, the commands of the
JAX runner with the port's module in place of the JAX one, and each parses
with the port CLI's own parser. The aggregator and the renderer read the
same result files as the JAX ones and give the same groups and markdown,
apart from the title lines (the package's name) and one known difference:
the SIGN CLIs write their run count as ``num_runs``, which the port's
renderer reads and the JAX one does not (it prints ``?``).
"""

import glob
import importlib
import json
import os

import pytest

from efficient_gnns_tpu.cli import results as jax_results
from efficient_gnns_tpu.cli import submit as jax_submit
from efficient_gnns_tpu.cli import sweep as jax_sweep
from efficient_gnns_tpu_torch.cli import results, submit, sweep

SPECS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments", "*.json")))


@pytest.mark.parametrize("path", SPECS, ids=[os.path.basename(p) for p in SPECS])
def test_build_commands_match_jax(path):
    with open(path) as f:
        spec = json.load(f)
    for only, extra in ((None, None), (["kd"], ["--epochs", "5"])):
        got = sweep.build_commands(spec, only=only, extra=extra)
        want = jax_sweep.build_commands(spec, only=only, extra=extra)
        module = f"efficient_gnns_tpu_torch.cli.{spec['workload']}"
        assert [c[2] for c in got] == [module] * len(want)
        assert [c[:2] + c[3:] for c in got] == [c[:2] + c[3:] for c in want]
    parser = importlib.import_module(module).build_parser()
    for cmd in sweep.build_commands(spec):
        parser.parse_args(cmd[3:])


def test_sweep_dry_run_prints_every_command(capsys):
    spec = next(p for p in SPECS if p.endswith("gat_teachers.json"))
    assert sweep.main([spec, "--dry_run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4  # two configs x two seed shards
    assert all("efficient_gnns_tpu_torch.cli.gat_teacher" in ln for ln in lines)


def _stats(valid, test):
    return {"highest_valid_mean": valid, "highest_valid_std": 0.01,
            "final_test_mean": test, "final_test_std": 0.02}


def _write_results(root):
    """Result files of the shapes the port's CLIs write."""
    files = {
        "gat_teacher_flagship.json": {
            "args": {"n_epochs": 3}, "val_accs": [0.7, 0.72], "test_accs": [0.69, 0.7],
            "runs": [{"run": 0}, {"run": 1}]},
        "hard-gcn-kd.json": {
            "args": {"training": "kd", "kd_and_aux": False, "gnn": "gcn", "num_layers": 2,
                     "hidden_channels": 256, "runs": 2, "epochs": 10, "expt_name": "hard"},
            "runs": [{"run": r, "highest_valid": 0.6 + r / 100, "final_test": 0.59,
                      "seconds": 12.0} for r in range(2)],
            "statistics": _stats(0.605, 0.59)},
        "mag-t-supervised.json": {
            "args": {"runs": 1, "expt_name": "t"}, "statistics": _stats(0.4, 0.38),
            "epoch_seconds": {"run0": [8.4, 8.6, {"device_step_ms": 88.0}]}},
        "ppi-t-kd.json": {"args": {"runs": 2}, "runs": [{}, {}],
                          "statistics": _stats(0.9, 0.91)},
        "mol-t-gine.json": {"args": {"runs": 3}, "statistics": _stats(0.75, 0.74),
                            "seconds": [1.0, 2.0, 3.0]},
        "sign-t-kd.json": {"args": {"num_runs": 3, "expt_name": "t"},
                           "runs": [{}, {}, {}], "statistics": _stats(0.71, 0.7)},
        "notes.json": {"args": {}},  # no statistics: not a result
    }
    for name, blob in files.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(blob, f)
    with open(os.path.join(root, "broken.json"), "w") as f:
        f.write("{")


def test_collect_and_main_match_jax(tmp_path, capsys):
    _write_results(tmp_path)
    for expt in (None, "t", "hard"):
        assert submit.collect(str(tmp_path), expt) == jax_submit.collect(str(tmp_path), expt)
    assert sorted(submit.collect(str(tmp_path))) == [
        "hard-gcn-kd", "mag-t-supervised", "mol-t-gine", "ppi-t-kd", "sign-t-kd"]
    for metric in ("final_test", "highest_valid"):
        submit.main(["--out_dir", str(tmp_path), "--metric", metric])
        got = capsys.readouterr().out
        jax_submit.main(["--out_dir", str(tmp_path), "--metric", metric])
        assert got == capsys.readouterr().out


def test_render_matches_jax_but_reads_num_runs(tmp_path):
    _write_results(tmp_path)
    got = results.render(str(tmp_path)).splitlines()
    want = jax_results.render(str(tmp_path)).splitlines()
    assert got[0] == "# RESULTS — GPU runs (efficient_gnns_tpu_torch)"
    assert want[0] == "# RESULTS — TPU runs (efficient_gnns_tpu)"
    assert got[2] == want[2].replace("efficient_gnns_tpu.cli", "efficient_gnns_tpu_torch.cli")
    assert len(got) == len(want)
    differ = [(g, w) for g, w in zip(got[3:], want[3:]) if g != w]
    # the one known difference: the SIGN file's run count
    assert differ == [("| sign-t-kd | 3 | 71.00 ± 1.00 | 70.00 ± 2.00 | — |",
                       "| sign-t-kd | ? | 71.00 ± 1.00 | 70.00 ± 2.00 | — |")]
    assert "| mag-t-supervised | **1 (single seed)** |" in "\n".join(got)
