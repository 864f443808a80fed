"""The harness on the CPU: the result line, names and units, discovery by
file name, the work counters against hand counts, the trace reader, the
comparison's numbers, and what a run imports."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from gnnbench import check, harness, spec as specmod, trace, work
from gnnbench.spec import ROOT, Spec
from gnnbench.tests.conftest import small_spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "efficient_gnns_tpu"}


def test_result_line_keys_and_checks_last():
    spec = small_spec("student-kd-arxiv")
    out = harness.run_cell(spec, "student-kd-arxiv", 2**31 + 7, 0.5, False, "cpu",
                           time.perf_counter())
    out.pop("_lines"), out.pop("_numbers")
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"epoch_ms", "setup_s"}  # no peak on the CPU
    assert set(out["checks"]) == set(spec.limits(spec.cell("student-kd-arxiv")))
    json.loads(json.dumps(out))


def test_student_tail_is_read_per_layer_from_the_window():
    spec = Spec()
    [metric] = [m for m in spec.doc["per_layer"] if m["name"] == "epoch_p95_ms.student"]
    assert metric["moves"] == "epoch_ms"
    for name in metric["workloads"]:
        assert metric in spec.metrics("per_layer", spec.cell(name))
        assert "epoch_p95_ms" not in {m["name"] for m in spec.metrics("end_to_end",
                                                                       spec.cell(name))}
    ctx = harness.Context(1.0, 1.0, 100, [0.01] * 90 + [0.03] * 10, 0, {})
    assert spec.reader(metric)(ctx) == pytest.approx(30.0)
    assert spec.reader(metric)(harness.Context(1.0, 1.0, 0, [], 0, {})) is None


def test_benchmark_names_and_units_are_valid():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    assert specmod.check_names(doc) == []
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in doc[k]]
    assert len(names) == len(set(names))
    for m in doc["per_layer"]:
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}


@pytest.mark.parametrize("entry", [
    {"name": "has space"}, {"name": "a/b"}, {"name": "x,y"}, {"name": "-lead"},
    {"name": "μs"}, {"name": "a" * 65}, {"name": "ok", "unit": "tokens per s"},
    {"name": "ok", "unit": "µs"}, {"name": "ok", "reduced": ["bad key"]},
])
def test_bad_names_and_units_are_found(entry):
    assert specmod.check_names({"configs": [entry]})


def test_every_cell_and_metric_is_found_by_name():
    spec = Spec()
    for name, cell in spec.cells.items():
        cfg = spec.config(cell)
        assert cfg["name"] == cell["config"]
        assert spec.traffic(cell)["epoch_chunk"] > 0
        assert set(spec.limits(cell)) <= set(check.NAMES)
        assert hasattr(spec.driver(cfg), "Program")
    for kind in ("end_to_end", "per_layer"):
        for m in spec.doc[kind]:
            assert callable(spec.reader(m))


def test_a_new_metric_is_one_new_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "twice_epoch_ms.py").write_text(
        "def read(ctx):\n    return 2 * ctx.epoch_ms\n")
    doc = {"configs": [], "workloads": [{"name": "c", "config": "x", "traffic": "y", "chips": 1}],
           "end_to_end": [], "per_layer": [{"name": "twice_epoch_ms", "unit": "ms"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = Spec(str(tmp_path / "BENCHMARK.json"), here=str(tmp_path))
    ctx = harness.Context(1.0, 2.0, 4, [0.5] * 4, 0, {})
    [metric] = spec.metrics("per_layer", spec.cell("c"))
    assert spec.reader(metric)(ctx) == 1000.0


def test_gcn_work_against_a_hand_count():
    n, e, tr = 10, 30, 4
    kd = work.gcn_epoch(n, e, [8, 16, 3], tr, {"training": "kd"}, 5)
    # train: fwd 2n(8*16 + 16*3), bwd dW1 2n*8*16, dW2 + dX2 2*2n*16*3; eval fwd again
    mm = 2 * n * (8 * 16 + 16 * 3) * 2 + 2 * n * 8 * 16 + 4 * n * 16 * 3
    sp = 2 * e * (16 + 3) * 3
    assert kd["flops"] == mm + sp and kd["spmm_calls"] == 6
    nce = work.gcn_epoch(n, e, [8, 16, 3], tr,
                         {"training": "nce", "proj_dim": 6, "max_samples": 2}, 5)
    heads = 3 * 2 * tr * 16 * 6 + 2 * 2 * tr * 5 * 6 + 3 * 2 * 2 * 6 * 2
    assert nce["flops"] == kd["flops"] + heads
    # bytes of one weighted float32 SpMM of width 16: x, senders, offsets, weights, out
    b = n * 16 * 4 + e * 4 + (n + 1) * 4 + e * 4 + n * 16 * 4
    assert work.spmm_bytes(n, e, 16, 4, True) == b
    assert work.least_seconds(2 * e * 16, b) == max(2 * e * 16 / 67e12, b / 3.35e12)


def test_gat_hub_work_against_a_hand_count():
    cfg = {"n_heads": 2, "n_hidden": 3, "n_layers": 2, "num_classes": 4,
           "hub_message_dtype": "bfloat16", "n_label_iters": 1}
    n, e, d0 = 5, 12, 7
    got = work.gat_hub_epoch(n, e, d0, cfg)
    # forward: layer 0 fc + res 2 * 2n*7*6, logits 2n*6; layer 1 (one head of 4)
    # fc + res 2 * 2n*6*4, logits 2n*4; SpMMs 2e*2*(3+1) and 2e*(4+1)
    fwd = 2 * 2 * n * 7 * 6 + 2 * n * 6 + 2 * 2 * n * 6 * 4 + 2 * n * 4
    spf = 2 * e * 8 + 2 * e * 5
    # backward: layer 0 dW of fc and res, layer 1 dW and dX of both; logits dW + dX
    bwd = 2 * 2 * n * 7 * 6 + 4 * 2 * n * 6 * 4 + 2 * 2 * n * 6 + 2 * 2 * n * 4
    assert got["flops"] == 4 * (fwd + spf) + bwd + spf
    assert got["spmm_calls"] == 10  # a layer: 2 forwards and 1 backward train, 2 eval
    least = 3 * work.least_seconds(2 * e * 8, work.spmm_bytes(n, e, 8, 2, True))
    least += 2 * work.least_seconds(2 * e * 8, work.spmm_bytes(n, e, 8, 2, False))
    least += 3 * work.least_seconds(2 * e * 5, work.spmm_bytes(n, e, 5, 2, True))
    least += 2 * work.least_seconds(2 * e * 5, work.spmm_bytes(n, e, 5, 2, False))
    assert got["spmm_least_s"] == pytest.approx(least, rel=1e-12)


def _trace_file(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 55, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "run_epochs", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_trace_union_idle_gaps_and_kernels(tmp_path):
    t = trace.read(_trace_file(tmp_path))
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)  # [10, 40] and [90, 100], clipped
    assert [n for n, _ in t.kernels] == ["sm90_xmma_gemm_f32", "elementwise_kernel"]
    assert t.idle_gaps[0] == ("aten::copy_", pytest.approx(50e-6))
    assert t.idle_gaps[1] == ("aten::mm", pytest.approx(10e-6))
    ctx = harness.Context(1.0, 1.0, 1, [], 0, {"spmm_calls": 0}, t, 1)
    spec = Spec()
    read = {m["name"]: spec.reader(m) for m in spec.doc["per_layer"]}
    assert read["kernels_per_epoch"](ctx) == 2
    assert read["gemm_ms"](ctx) == pytest.approx(0.02)
    assert read["elementwise_ms"](ctx) == pytest.approx(0.02)
    assert read["idle_pct"](ctx) == pytest.approx(60.0)
    assert read["spmm_roofline"](ctx) is None  # no SpMM work, nothing to read


def test_numbers_catch_non_finite_and_leave_out_still_leaves():
    ev = [torch.ones(3, 2)]
    best = {"val_loss": 1.0, "logits": torch.ones(3, 2), "feats": torch.ones(3, 4)}
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9}, "change": {"a": 1.0, "b": 1.0,
           "c": 5.0}, "eval": ev, "first_layer": [torch.ones(3, 4)], "best": best}
    prog = {"loss": [1.0], "grad": dict(ref["grad"]), "change": dict(ref["change"], c=0.0),
            "eval": [torch.ones(3, 2)], "first_layer": [torch.ones(3, 4)], "best": dict(best)}
    assert check.still_leaves(ref) == ["c"]
    assert set(check.numbers(prog, ref)) == set(check.NAMES)
    assert set(check.numbers(prog, ref).values()) == {0.0}
    ref_untracked = {k: v for k, v in ref.items() if k != "best"}
    assert "best" not in check.numbers(prog, ref_untracked)
    # a best never tracked: the trainer's initial bundle
    untracked = {"val_loss": math.inf, "logits": torch.zeros(3, 2), "feats": torch.zeros(3, 4)}
    for broken in ({"loss": [math.nan]}, {"grad": dict(ref["grad"], a=math.nan)},
                   {"eval": [torch.full((3, 2), math.nan)]},
                   {"first_layer": [torch.full((3, 4), math.nan)]}, {"best": untracked},
                   {"best": dict(best, feats=torch.zeros(3, 4))}):
        vals = check.numbers(dict(prog, **broken), ref)
        ok, _ = check.judge(vals, dict.fromkeys(check.NAMES, 0.5))
        assert not ok


IMPORT_CHECK = r"""
import sys
import {modules}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_loaded(modules):
    code = IMPORT_CHECK.format(modules=", ".join(modules))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _top_level_loaded([
        "gnnbench.run", "gnnbench.harness", "gnnbench.calibrate",
        "gnnbench.drivers.gat_teacher", "gnnbench.drivers.node_student",
        "efficient_gnns_tpu_torch.train.gat_teacher", "efficient_gnns_tpu_torch.train.node_trainer",
        "efficient_gnns_tpu_torch.graphs.preprocess", "efficient_gnns_tpu_torch.models.gnns"])
    assert "efficient_gnns_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_loaded(["gnnbench.reference.train", "gnnbench.reference.graph",
                                "gnnbench.reference.nn"])
    assert not loaded & (FORBIDDEN | {"efficient_gnns_tpu_torch"})
