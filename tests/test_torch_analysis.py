"""Port vs JAX: the analysis tooling (``analysis/correlation.py``,
``curves.py``, ``timing.py``, ``microbench.py``) and ``train/metrics.py``'s
``read_jsonl``.

Correlations and CKA agree to rtol 1e-5 (float32 Gram blocks on both sides,
float64 statistics). The timing helpers run on the CPU here when asked
for, where there is no device metric: ``device_memory_stats("cpu")`` is
empty and a trace holds no device track; without a device they raise here,
since their default is the card. ``microbench gat-step`` runs at a tiny size on the CPU; its
first step's loss is held to the JAX trainer's on the same graph with every
dropout 0 and a label split that draws nothing (the randomness of the two
packages differs): rtol 1e-4 in float32, as ``tests/test_torch_gat_teacher.py``
holds the trainers. With bfloat16 messages, against the JAX trainer's fused
Pallas attention in interpret mode with bfloat16 messages, rtol 5e-4: the
Pallas K2 also rounds each ``w * x`` product to bfloat16. The largest gaps
measured were 9.3e-8 (float32) and 1.3e-5 (bfloat16) relative.
"""

import gzip
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_gnns_tpu.analysis import correlation as jax_corr
from efficient_gnns_tpu.analysis import curves as jax_curves
from efficient_gnns_tpu.analysis import timing as jax_timing
from efficient_gnns_tpu.data import synthetic_node_dataset as jax_synthetic
from efficient_gnns_tpu.ops import dispatch as jax_dispatch
from efficient_gnns_tpu.train import metrics as jax_metrics
from efficient_gnns_tpu.train.gat_teacher import GATTeacherTrainer as JaxTrainer
from efficient_gnns_tpu.train.gat_teacher import TeacherConfig as JaxTeacherConfig
from efficient_gnns_tpu_torch.analysis import correlation, curves, microbench, timing
from efficient_gnns_tpu_torch.models import GCN, from_jax_params
from efficient_gnns_tpu_torch.ops import dispatch
from efficient_gnns_tpu_torch.train.gat_teacher import TeacherConfig
from efficient_gnns_tpu_torch.train.metrics import MetricsWriter, read_jsonl

to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture
def restore_dispatch():
    yield
    jax_dispatch.set_backend("auto", interpret=False, message_dtype=jnp.float32,
                             hub_message_dtype=jnp.bfloat16)
    dispatch.set_message_dtype(torch.float32)
    dispatch.set_hub_message_dtype(torch.bfloat16)


def _feats(rng, n=50, d=12):
    t = rng.normal(size=(n, d)).astype(np.float32)
    s = (0.6 * t + 0.4 * rng.normal(size=(n, d))).astype(np.float32)
    return t, s


def test_distances_match_jax(rng):
    t, _ = _feats(rng)
    got = correlation.pairwise_cosine_distance_condensed(torch.from_numpy(t), block=16)
    want = jax_corr.pairwise_cosine_distance_condensed(jnp.asarray(t), block=16)
    assert got.shape == want.shape == (50 * 49 // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    s, r = rng.integers(0, 50, size=80), rng.integers(0, 50, size=80)
    np.testing.assert_allclose(correlation.edge_cosine_distance(t, s, r),
                               jax_corr.edge_cosine_distance(jnp.asarray(t), s, r),
                               rtol=1e-5, atol=1e-6)


def test_mantel_and_cka_match_jax(rng):
    t, s = _feats(rng)
    a, b = rng.normal(size=300), rng.normal(size=300) + 0.3 * np.arange(300) / 300
    np.testing.assert_allclose(correlation.mantel_correlation(torch.from_numpy(a), b),
                               jax_corr.mantel_correlation(a, b), rtol=1e-5)
    np.testing.assert_allclose(correlation.linear_cka(torch.from_numpy(t), s),
                               jax_corr.linear_cka(t, s), rtol=1e-5)
    assert correlation.mantel_correlation(np.ones(5), np.arange(5)) == 0.0


@pytest.mark.parametrize("max_nodes", [30, 4096])
def test_structure_report_matches_jax(rng, max_nodes):
    t, s = _feats(rng)
    snd, rcv = rng.integers(0, 50, size=120), rng.integers(0, 50, size=120)
    got = correlation.structure_report(torch.from_numpy(t), torch.from_numpy(s), snd, rcv,
                                       max_nodes=max_nodes, seed=3)
    want = jax_corr.structure_report(jnp.asarray(t), jnp.asarray(s), snd, rcv,
                                     max_nodes=max_nodes, seed=3)
    assert set(got) == set(want) == {"global_corr", "cka", "local_corr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="rows"):
        correlation.structure_report(t, s[:-1])


def test_read_jsonl_and_series_match_jax(tmp_path):
    with MetricsWriter(str(tmp_path)) as w:
        for epoch in range(3):
            w.write(epoch, {"loss/train": 1.0 / (epoch + 1), "acc/valid": 0.1 * epoch})
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write("\n" + json.dumps({"acc/valid": 0.9}) + "\n")  # no step, a blank line
    rows = read_jsonl(str(tmp_path))
    assert rows == jax_metrics.read_jsonl(str(tmp_path))
    assert len(rows) == 4 and rows[0] == {"step": 0, "loss/train": 1.0, "acc/valid": 0.0}
    for key in ("loss/train", "acc/valid", "acc/test"):
        assert curves._series(rows, key) == jax_curves._series(rows, key)
    assert curves._series(rows, "acc/valid") == ([0, 1, 2, 3], [0.0, 0.1, 0.2, 0.9])


def test_plot_curves_names_matplotlib_when_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.raises(ImportError, match="matplotlib"):
        curves.plot_curves(str(tmp_path))


def test_timing_on_the_cpu(tmp_path):
    x = torch.ones(8, 8)
    assert timing.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():  # no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            timing.device_memory_stats()
    got = timing.time_inference(lambda a: a @ a, x, runs=3, warmup=1, device="cpu")
    want = jax_timing.time_inference(lambda a: a @ a, jnp.ones((8, 8)), runs=3, warmup=1)
    assert set(got) == set(want) == {"mean_s", "min_s", "max_s", "runs"}
    assert got["runs"] == 3 and 0 <= got["min_s"] <= got["mean_s"] <= got["max_s"]
    calls = []
    trace_dir = timing.capture_trace(lambda a: calls.append(a @ a), x,
                                     trace_dir=str(tmp_path / "t"), steps=2, device="cpu")
    assert len(calls) == 3  # one warm-up, two traced steps
    with open(tmp_path / "t" / "trace.json") as f:
        assert any(ev.get("name") == "step 1" for ev in json.load(f)["traceEvents"])
    assert timing.summarize_trace(trace_dir) == {"__total__": 0.0}  # no device track


def test_summarize_trace_sums_device_events_by_name(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "split_sddmm_kernel", "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "split_sddmm_kernel", "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 250.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    (tmp_path / "a").mkdir()
    with open(tmp_path / "a" / "trace.json", "w") as f:
        json.dump({"traceEvents": events[:2]}, f)
    with gzip.open(tmp_path / "b.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events[2:]}, f)
    got = timing.summarize_trace(str(tmp_path))
    assert got == {"split_sddmm_kernel": 2.0, "Memcpy HtoD": 0.25, "__total__": 2.25}


def test_count_params_matches_jax(rng):
    from efficient_gnns_tpu.graphs import build_graph as jax_build_graph
    from efficient_gnns_tpu.models import GCN as JaxGCN

    s, r = rng.integers(0, 30, size=60), rng.integers(0, 30, size=60)
    jg = jax_build_graph(s, r, 30, gcn_norm=True)
    params = JaxGCN(hidden=16, out_feats=5, num_layers=3).init(
        jax.random.PRNGKey(0), jg, jnp.ones((30, 12)))["params"]
    model = GCN(12, 16, 5, 3, device="cpu")
    assert timing.count_params(model) == jax_timing.count_params(params)
    assert timing.count_params(from_jax_params(to_np(params), {})) == timing.count_params(model)


def test_bench_chain_threads_the_carry():
    seen = []

    def step(c):
        seen.append(float(c["x"][0]))
        return {"x": c["x"] + 1.0, "n": c["n"]}

    ms = microbench.bench_chain(step, {"x": torch.zeros(3), "n": torch.arange(3)}, iters=4)
    assert ms > 0 and len(seen) == 12  # two warm-ups and the timed run
    assert seen[:4] == [0.0, 1.0, 2.0, 3.0] and seen[8] == pytest.approx(1e-12)
    aux = microbench.bench_chain(lambda k, c: (c * k, c.sum()), torch.ones(2), iters=3,
                                 const=2.0, has_aux=True)
    assert aux > 0


def test_cached_graph_builds_once(tmp_path, monkeypatch):
    monkeypatch.setattr(microbench, "_CACHE_DIR", str(tmp_path))
    builds = []

    def build():
        builds.append(1)
        return microbench.gat_dataset(120, 400, hub=0)

    first = microbench.cached_graph("tiny", build)
    again = microbench.cached_graph("tiny", build)
    assert len(builds) == 1 and (tmp_path / "tiny.pt").exists()
    assert torch.equal(first.graph.row_offsets, again.graph.row_offsets)
    np.testing.assert_array_equal(first.x, again.x)


DATA = dict(num_nodes=300, num_edges=1200)
NARROW = dict(n_hidden=6, n_layers=2, n_heads=2, dropout=0.0, input_drop=0.0,
              attn_drop=0.0, edge_drop=0.0, use_labels=True, n_label_iters=1,
              mask_rate=0.0, no_attn_dst=True, use_norm=True, lr=0.05)


@pytest.mark.parametrize("msg_dtype, rtol", [("float32", 1e-4), ("bfloat16", 5e-4)])
def test_gat_step_first_loss_matches_jax(restore_dispatch, msg_dtype, rtol):
    jd = jax_synthetic(**DATA, seed=42, hub_dense=0, gcn_norm=False, label_smoothing_hops=0)
    td = microbench.gat_dataset(**DATA, hub=0)
    assert td.graph.hub is None
    np.testing.assert_array_equal(td.x, np.asarray(jd.x))
    if msg_dtype == "bfloat16":  # the JAX trainer's fused attention reads bf16 there
        jax_dispatch.set_backend("pallas", interpret=True, message_dtype=jnp.bfloat16)
    microbench.set_message_dtype(msg_dtype)
    jtr = JaxTrainer(JaxTeacherConfig(**NARROW), jd.graph, jd.x, jd.y, jd.split_idx,
                     jd.num_classes)
    ttr = microbench.teacher_trainer(td, "cpu", TeacherConfig(**NARROW))
    ttr.model.load_state_dict(from_jax_params(to_np(jtr.state.params),
                                              to_np(jtr.state.batch_stats)))
    want_eval = jtr.evaluate()[3][0]
    got_eval = microbench.gat_step(ttr, "eval", iters=1, repeats=1)
    np.testing.assert_allclose(got_eval["first_loss"], want_eval, rtol=rtol)
    got = microbench.gat_step(ttr, "train", iters=1, repeats=1)
    np.testing.assert_allclose(got["first_loss"], jtr.train_epoch(0)["loss"], rtol=rtol)
    assert len(got["step_ms"]) == 1 and "trace" not in got


@pytest.mark.parametrize("msg_dtype", ["float32", "bfloat16"])
def test_gat_step_cli_on_the_cpu(restore_dispatch, capsys, msg_dtype, tmp_path, monkeypatch):
    monkeypatch.setattr(microbench, "TRACE_DIR", str(tmp_path))
    microbench.main(["gat-step", "--device", "cpu", "--num-nodes", "200", "--num-edges",
                     "600", "--hub", "0", "--iters", "1", "--msg-dtype", msg_dtype,
                     "--which", "eval", "--trace"])
    out = capsys.readouterr().out
    assert "hub=off" in out and "params 1441580" in out  # the 3 x 3 x 250 teacher
    assert out.count("eval step: ") == 3 and (tmp_path / "gat_step_eval" / "trace.json").exists()
    assert dispatch.message_dtype() == dispatch.hub_message_dtype() == getattr(torch, msg_dtype)


def test_spmm_cli_prints_its_bound(capsys):
    microbench.main(["spmm", "--device", "cpu", "--num-nodes", "200", "--num-edges", "600",
                     "--feat-dim", "8"])
    out = capsys.readouterr().out
    assert "SpMM fwd+bwd" in out and "3.35 TB/s" in out and "on cpu" in out
