"""``norm_ms``: MaskedBatchNorm's kernels by name in a hand-written trace,
and None for a program that has none of them."""

import json

import pytest

from gnnbench import harness, trace
from gnnbench.spec import Spec


def _trace(tmp_path, names):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 1000,
           "tid": 1, "pid": 1, "args": {}}]
    for i, name in enumerate(names):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": 10 + 100 * i, "dur": 40,
                   "tid": 7, "pid": 1, "args": {}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return harness.Context(1.0, 1.0, 1, [], 0, {"spmm_calls": 0}, trace.read(str(path)), 2)


def test_norm_ms_reads_the_batchnorm_kernels_by_name(tmp_path):
    [m] = [m for m in Spec().doc["per_layer"] if m["name"] == "norm_ms"]
    read = Spec().reader(m)
    ctx = _trace(tmp_path, ["void (anonymous namespace)::masked_bn_partials_kernel(Fwd, ...)",
                            "(anonymous namespace)::masked_bn_apply_kernel(Fwd, ...)",
                            "void at::native::reduce_kernel<512, 1>(...)",
                            "masked_bn_grad_fused_kernel"])
    assert read(ctx) == pytest.approx(3 * 0.04 / 2)  # 3 kernels of 40 us over 2 epochs
    elementwise = Spec().reader({"name": "elementwise_ms"})
    assert elementwise(ctx) == pytest.approx(4 * 0.04 / 2)  # they count there too
    assert read(_trace(tmp_path, ["void at::native::reduce_kernel<512, 1>(...)"])) is None
    assert read(harness.Context(1.0, 1.0, 1, [], 0, {}, None, 1)) is None


def test_norm_ms_is_declared_for_every_cell():
    """Without a ``workloads`` list: every cell that reports ``epoch_ms``
    reports it (each of them runs the BatchNorm kernels)."""
    spec = Spec()
    [m] = [m for m in spec.doc["per_layer"] if m["name"] == "norm_ms"]
    assert m["layer"] == "models and criteria" and m["moves"] == "epoch_ms"
    assert m["source"] == "device_trace" and "workloads" not in m
    assert all(m in spec.metrics("per_layer", cell) for cell in spec.cells.values())
