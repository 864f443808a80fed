#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``PATH``) and this checkout;
it imports nothing of JAX. Phases, each of which must pass:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA source of the port, compiled for ``sm_90a``;
3. K1 (``csr_segment_sum``) against its plain PyTorch version at the
   ogbn-arxiv shape the student gives it (169,343 nodes, the bidirected
   self-looped synthetic edge set, F = 256 and 40, float32 and bfloat16,
   the forward CSR and the transpose CSR of the backward), with its time,
   the plain version's, one library call's (``torch.sparse`` CSR matmul,
   timed only) and its bound;
4. small-input reference: the student trainer on the card against the same
   trainer on the CPU (which the tests hold against the JAX package);
5. the slice: ``efficient_gnns_tpu_torch.cli.arxiv`` trains the 2 x 256 GCN
   student at arxiv width in ``supervised`` and ``kd`` mode, with K1's
   launch counter read around each run.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``; a failed phase exits non-zero before them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5  # |kernel - plain| <= TOL + TOL * sum_e |w_e x_e| (summation order)
ARXIV = ["--dataset", "synthetic", "--num_nodes", "169343", "--num_edges",
         "1166243", "--gnn", "gcn", "--hidden_channels", "256", "--num_layers", "2"]
EPOCHS = 10
DEVICE = "cuda"
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke")


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from efficient_gnns_tpu_torch.ops.cuda import build

    t0 = time.time()
    logs = build.build()
    print(f"build: {', '.join(logs)} in {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def phase_k1(graph):
    """K1 against its plain version at the main path's shapes."""
    import torch

    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum, csr_segment_sum_plain

    g = graph.to(DEVICE)
    n, e = g.num_nodes, g.n_edge
    deg = (g.row_offsets[1:] - g.row_offsets[:-1]).long()
    top = torch.topk(deg, 5).values.tolist()
    print(f"K1 graph: N={n} E={e} max row degree={top[0]} top-5={top} "
          f"mean={e / n:.1f}", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    records, failures = [], []
    for f in (256, 40):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, f, generator=gen, device=DEVICE).to(dtype)
            for direction, src, ro, w in (
                ("fwd", g.senders, g.row_offsets, g.edge_weight),
                ("bwd", g.t_senders, g.t_row_offsets, g.t_edge_weight),
            ):
                got = csr_segment_sum(x, src, ro, w)
                want = csr_segment_sum_plain(x, src, ro, w)
                abs_sum = csr_segment_sum_plain(x.abs(), src, ro, w.abs())
                torch.cuda.synchronize()
                diff = (got - want).abs()
                err = float(diff.max())
                ok = bool((diff <= TOL + TOL * abs_sum).all()) and got.shape == (n, f)
                ms = _time_ms(lambda: csr_segment_sum(x, src, ro, w), 20)
                plain_ms = _time_ms(lambda: csr_segment_sum_plain(x, src, ro, w), 5)
                library_ms = None
                try:  # the yardstick: one cuSPARSE call through torch.sparse
                    a = torch.sparse_csr_tensor(ro, src[:e], w[:e].to(dtype), (n, n))
                    library_ms = _time_ms(lambda: a @ x, 20)
                except (RuntimeError, NotImplementedError) as exc:
                    print(f"  library call unavailable for {dtype}: {exc}")
                item = x.element_size()
                unique_bytes = n * f * item + n * f * 4 + e * 8 + (n + 1) * 4
                gathered_bytes = e * f * item + n * f * 4 + e * 8 + (n + 1) * 4
                flops = 2 * e * f
                t_bytes = unique_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / FP32_FLOP_PER_S * 1e3
                name = f"K1 csr_segment_sum {direction} F={f} {str(dtype)[6:]}"
                records.append({
                    "name": name,
                    "route": "cuda",
                    "source": "efficient_gnns_tpu_torch/ops/cuda/csrc/segment_sum.cu",
                    "replaces": "efficient_gnns_tpu/ops/pallas/segment_matmul.py:162",
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms,
                    "gathered_bound_ms": gathered_bytes / HBM_BYTES_PER_S * 1e3,
                    "on_main_path": dtype == torch.float32,
                    "shape": {"N": n, "E": e, "F": f},
                })
                print(f"  {name}: max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'} "
                      f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms} "
                      f"bound_ms={records[-1]['bound_ms']:.4f} "
                      f"gathered_bound_ms={records[-1]['gathered_bound_ms']:.4f}",
                      flush=True)
                if not ok:
                    failures.append(name)
    # padding edges lie past row_offsets[N]: poisoned, they must change nothing
    x = torch.randn(n, 40, generator=gen, device=DEVICE)
    poisoned = g.senders.clone()
    poisoned[e:] = 2**31 - 1
    if not torch.equal(csr_segment_sum(x, poisoned, g.row_offsets, g.edge_weight),
                       csr_segment_sum(x, g.senders, g.row_offsets, g.edge_weight)):
        failures.append("K1 read a padding edge")
    torch.cuda.synchronize()
    return records, failures


def phase_reference():
    """The trainer on the card against the CPU trainer, same start, dropout 0."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.models import GCN
    from efficient_gnns_tpu_torch.train import DistillConfig, NodeDistillTrainer

    ds = synthetic_node_dataset(num_nodes=3000, num_edges=15000, seed=5)
    hist = {}
    for device in ("cpu", DEVICE):
        model = GCN(128, 64, 40, 2, dropout=0.0, seed=0, device=device)
        trainer = NodeDistillTrainer(
            model, DistillConfig(hidden=64, dropout=0.0), ds.graph, ds.x, ds.y,
            ds.split_idx, device=device)
        hist[device] = trainer.run_epochs(1, 3)
    err = float(np.abs(hist[DEVICE][:, :3] - hist["cpu"][:, :3]).max())
    print(f"reference: cuda vs cpu trainer, 3 epochs, loss max_abs_err={err:.3e}",
          flush=True)
    return np.allclose(hist[DEVICE][:, :3], hist["cpu"][:, :3], rtol=1e-4, atol=1e-6)


def phase_slice():
    """The port's CLI at arxiv width; returns K1 launches in its runs."""
    import math

    from efficient_gnns_tpu_torch.cli import arxiv
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum

    launches, failures = 0, []
    for training in ("supervised", "kd"):
        argv = ARXIV + ["--training", training, "--epochs", str(EPOCHS),
                        "--runs", "1", "--log_steps", "1", "--epoch_chunk",
                        str(EPOCHS), "--device", DEVICE, "--out_dir", OUT_DIR,
                        "--expt_name", "chip_smoke"]
        csr_segment_sum.launches = 0
        summary = arxiv.main(argv)
        n = csr_segment_sum.launches
        launches += n
        path = os.path.join(OUT_DIR, "chip_smoke", f"gcn-{training}", "seed0",
                            "metrics.jsonl")
        with open(path) as f:
            records = [json.loads(line) for line in f][-EPOCHS:]
        losses = [r["loss/train"] for r in records]
        step_s = summary["runs"][0]["seconds"] / EPOCHS
        print(f"slice {training}: K1 launches={n} (expected {6 * EPOCHS}) "
              f"mean epoch (train step + eval) {step_s * 1e3:.1f} ms "
              f"losses {[round(v, 4) for v in losses]}", flush=True)
        if n != 6 * EPOCHS:  # per epoch: 2 forward + 2 backward + 2 eval
            failures.append(f"{training}: {n} K1 launches")
        if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
            failures.append(f"{training}: losses not finite and falling")
    return launches, failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from efficient_gnns_tpu_torch.data import synthetic_node_dataset

    failures = []
    smi = phase_device()
    phase_build()
    t0 = time.time()
    ds = synthetic_node_dataset(num_nodes=169343, num_edges=1166243, seed=42)
    print(f"arxiv-shaped dataset built in {time.time() - t0:.1f} s", flush=True)
    try:
        records, k1_failures = phase_k1(ds.graph)
        failures += k1_failures
    except Exception:  # report, then run the other phases
        traceback.print_exc()
        records, failures = [], failures + ["K1 phase raised"]
    del ds
    try:
        if not phase_reference():
            failures.append("cuda trainer disagrees with the cpu trainer")
    except Exception:
        traceback.print_exc()
        failures.append("reference phase raised")
    launches, slice_failures = phase_slice()
    failures += slice_failures
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    for r in records:
        r["launches"] = launches
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
