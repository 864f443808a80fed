#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``PATH``) and this checkout;
it imports nothing of JAX. Phases, each of which must pass:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA source of the port, compiled for ``sm_90a``;
3. K1 (``csr_segment_sum``) against its plain PyTorch version at the
   ogbn-arxiv shape the student gives it (169,343 nodes, the bidirected
   self-looped synthetic edge set, F = 256, 128 and 40, float32 and bfloat16,
   the forward CSR and the transpose CSR of the backward) and at the two
   shapes of the flagship teacher's hub attention (F = 768 and 128 in
   bfloat16 with 0/1 edge-drop weights), with its time, the plain version's,
   one library call's (``torch.sparse`` CSR matmul, timed only) and its
   bound; two launches must give the same bits, and a call without the
   graph's row split the same as one with it;
4. small-input reference: the student trainer on the card against the same
   trainer on the CPU (which the tests hold against the JAX package), for
   the GCN in ``supervised``, the GCN in ``nce`` composed with logit KD and
   the SAGE student;
5. the slice: ``efficient_gnns_tpu_torch.cli.arxiv`` trains the 2 x 256 GCN
   student at arxiv width in ``supervised`` and ``kd`` mode and the 2 x 256
   SAGE student in ``supervised`` mode, with K1's launch counter read around
   each run;
6. K2, K4, K5, K6 and K7 (the GAT attention kernels) against their plain
   versions at the teacher's arxiv shapes (H = 3 heads of D = 250 and the
   last layer's H = 1, D = 40; forward and transpose CSR), with their times,
   the plain versions', one library yardstick's each and their bounds; K2,
   K4, K5 and K6 are held to the same bits over two launches and without the
   row split (K4 also with chunks of 32 edges); K5-K7, a few microseconds
   each, are also timed with the host's cost of a call hidden (``device
   alone``), beside an empty launch;
7. small-input reference: the teacher trainer on the card against the same
   trainer on the CPU (dropouts 0, no label split), with attn-dst on the
   edge softmax and without it on the hub attention path; then
   ``hub_gat_attention`` on the card against the CPU on a graph of over
   200k edges with the hub partition, at the teacher's widths, with and without
   edge-drop (the same keep set on both devices; float32 and the bfloat16
   default hub messages);
8. the teacher slice: ``efficient_gnns_tpu_torch.cli.gat_teacher`` trains
   the 3 x 3 x 250 GAT teacher at arxiv shape with the flags of
   ``experiments/arxiv_hard.sh`` (``--no-attn-dst``: the hub attention path,
   K1 alone) and dumps it, then the same teacher with attn-dst on (K2,
   K4-K7), with every kernel's launch counter read around each run; then
   ``cli.arxiv`` trains the GCN student from the flagship dump in ``kd``,
   ``nce`` (MLP projection heads, 8192 sampled rows) and ``gcd``
   (graph-conditioned heads) mode;
9. a profile of one epoch of each teacher, of a chunk of GCN ``supervised``
   student epochs and of one SIGN epoch at arxiv shape (``torch.profiler``):
   device busy and idle share, the device time by kernel, the host calls
   that wait for the device, the tables written to ``OUT_DIR``; and the
   steady epoch time of the four trainers without the profiler;
10. K3 (``csr_sddmm``, the weight gradient of ``spmm`` with per-call
    weights) against its plain version at the arxiv shape, F = 256 and 40,
    float32 and bfloat16, with its time, the plain version's, one library
    call's (``torch.sparse.sampled_addmm``, timed only) and its bound, held
    to the same bits over two launches, without the split and with another;
11. the runtime-weight path: ``sum(sin(spmm(graph, x, edge_weight=w)))``
    forward and backward on the card at arxiv shape, F = 256, with K1's and
    K3's launch counters read around it, ``dx`` and ``dw`` held against the
    same call on the CPU, and ``weight_grad=False`` (zero ``dw``, no K3);
12. the row split's edges: K1-K6 on small made-up graphs on the card
    against their plain versions (one row holding every edge; rows of
    exactly T, T + 1, 2T and 2T + 1 edges; empty rows before, between and
    after long rows; the last row long; F in {1, 33, 40, 250, 256}, float32
    and bfloat16 for K1 (weighted and unweighted) and K3; (H, D) in {(1,
    40), (3, 250), (4, 33)} for K2 and K4; H in {1, 3, 8} for K5 and K6),
    each launched twice for the same bits; K7 on the same graphs with an
    ``E_pad`` that is no multiple of 4 and ``dst`` at an address that is not
    16-byte aligned;
13. K1, K2 and K5 at other chunk sizes than the one the graph is built with
    (times only: what ``ROW_SPLIT_THRESHOLD`` was chosen from);
14. K5 and K6 rebuilt with other lane-group widths and loads in flight
    (times only: what the constants of ``csrc/segment_thin.cu`` were chosen
    from);
15. small-input reference: the SIGN trainer on the card against the same
    trainer on the CPU (``supervised``, and ``nce`` composed with logit KD),
    and the card's hop features against the CPU's;
16. the SIGN slice: ``efficient_gnns_tpu_torch.cli.sign`` at arxiv shape and
    the reference's full width (R = 5 hops, 6 FFNs 128 -> 512 -> 512, batches
    of 50,000) in ``kd`` from the flagship teacher's dump, then ``nce`` with
    ``--kd_and_aux`` at the ``sign-aux/nce`` grid point, every kernel's
    counter read around each run (K1 once a hop, nothing else);
17. checkpoints: ``cli.arxiv`` trains the GCN student at arxiv shape 6
    epochs unbroken, and 3 epochs with ``--checkpoint_every 3`` then
    ``--resume`` to 6; epochs 4-6 must give the same losses; then
    ``cli.gat_teacher --save-pred`` at a small size, whose best-validation
    checkpoint must reproduce its dump's logits in a fresh teacher;
18. the OGB raw cache: the arxiv-shaped dataset written as an ogbn-arxiv
    ``csv.gz`` cache, read back by ``data/ogb.py`` (the graph equal to the
    one built from the same edges), and the GCN student trained 3 epochs on
    it through ``cli.arxiv --dataset ogbn-arxiv``;
19. small-input reference: the PPI trainer on the card against the same
    trainer on the CPU (``supervised``, ``kd``, ``nce``, ``lpw`` composed with
    logit KD);
20. K2 and K4-K7 against their plain versions on the largest graph of the
    PPI-shaped data (20 / 2 / 2 graphs of 591-3,480 nodes, padded to 3,584
    nodes and 101,376 edges; no long row, so both row splits are empty) at
    the PPI models' shapes (H x D = 4 x 256, 6 x 121, 2 x 68, 2 x 121), with
    the records of phase 6;
21. the PPI slice: that data written as the torch-geometric raw files and
    read back by ``data/ppi.py``, then ``efficient_gnns_tpu_torch.cli.ppi``
    trains TeacherNet (3 layers of 4 x 256, a 6-head mean) with
    ``--train_teacher`` and StudentNet (5 layers of 2 x 68) in ``kd`` and
    ``nce --kd_and_aux`` from its checkpoint, 3 epochs each, every kernel's
    counter read around each run;
22. a profile of one TeacherNet and one StudentNet ``kd`` train epoch at the
    PPI shape, with the steady epoch and evaluation times.

``--only a,b`` runs the named phases alone (see ``main``). The last lines
are the kernels' JSON record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``; a failed phase exits non-zero before them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import warnings

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5  # |kernel - plain| <= TOL + TOL * sum_e |w_e x_e| (summation order)
RT_TOL = 1e-4  # card vs CPU through sin(): the cotangent carries the forward's rounding
ARXIV = ["--dataset", "synthetic", "--num_nodes", "169343", "--num_edges",
         "1166243", "--hidden_channels", "256", "--num_layers", "2"]
HARD_U = ["--signal", "0.3", "--label_noise", "0.15"]
# experiments/arxiv_hard.sh step 2, the G-CRD grid point
NCE = ["--beta", "0.05", "--nce_T", "0.075", "--proj_dim", "256", "--max_samples", "8192"]
EPOCHS = 10
# K1 launches of one student epoch (train step + eval), from the code:
# GCN: 2 forward + 2 backward + 2 eval. SAGE: the first layer aggregates the
# input features, which take no gradient: 2 + 1 + 2. gcd: the GCN's 6 plus
# the forward and backward of each projection head's GCNConv.
K1_PER_EPOCH = {("gcn", "supervised"): 6, ("gcn", "kd"): 6, ("gcn", "nce"): 6,
                ("sage", "supervised"): 5, ("gcn", "gcd"): 10}
# experiments/arxiv_hard.sh step 1 at arxiv shape: the flagship teacher
# (--no-attn-dst, the hub attention path at this size), and beside it the
# same teacher with attn-dst on (the edge-softmax path, K2 and K4-K7)
HARD = ["--num-nodes", "169343", "--num-edges", "1166243", "--signal", "0.3",
        "--label-noise", "0.15"]
TEACHER_FLAGS = ["--use-labels", "--n-label-iters", "1", "--use-norm", "--edge-drop", "0.3",
                 "--input-drop", "0.25", "--n-runs", "1", "--seed", "0"]
TEACHER = HARD + TEACHER_FLAGS + ["--no-attn-dst", "--save-pred", "--expt-name",
                                  "chip_smoke_teacher"]
TEACHER_ATTN_DST = HARD + TEACHER_FLAGS + ["--expt-name", "chip_smoke_teacher_attn_dst"]
TEACHER_EPOCHS = 3
# kernel launches of one teacher epoch (3 layers, n_label_iters 1): 12 layer
# forwards (2 train + 2 eval per layer) and 3 layer backwards.
# --no-attn-dst on the hub path: one spmm a forward (K1), its transpose a
# backward (K1), nothing else.
TEACHER_LAUNCHES = {"K1": 12 + 3, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
# attn-dst: forward K2 1, K5 1, K6 1, K7 3 (er, max, 1/sum); backward K2 1,
# K4 1, K5 3 (softmax VJP, der, del), K7 1
TEACHER_ATTN_DST_LAUNCHES = {"K1": 0, "K2": 12 + 3, "K3": 0, "K4": 3, "K5": 12 + 3 * 3,
                             "K6": 12, "K7": 12 * 3 + 3}
HEADS = ((3, 250), (1, 40))  # the teacher's hidden layers and its last layer
# experiments/all_workloads.sh:11-13 (the hard task) at the reference's full
# SIGN width (arxiv_dgl/sign.py defaults), cut in time only: 10 epochs, 1 run
SIGN = ["--num_nodes", "169343", "--num_edges", "1166243", "--signal", "0.3",
        "--label_noise", "0.15", "--R", "5", "--num_hidden", "512", "--ff_layer", "2",
        "--batch_size", "50000", "--eval_batch_size", "100000", "--num_runs", "1",
        "--num_epochs", "10", "--eval_every", "10"]
SIGN_AUX_NCE = ["--kd_and_aux", "--beta", "0.1", "--nce_T", "0.075", "--max_samples",
                "16384", "--proj_dim", "256"]  # experiments/sign.json, sign-aux/nce
SIGN_HOPS = 5
DEVICE = "cuda"
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke")
TEACHER_DUMP = os.path.join(OUT_DIR, "teacher_dumps", "chip_smoke_teacher")


def _counters():
    """Every kernel's wrapper by its number: each counts its own launches."""
    from efficient_gnns_tpu_torch.ops import cuda as K

    return {"K1": K.csr_segment_sum, "K2": K.csr_segment_sum_heads, "K3": K.csr_sddmm,
            "K4": K.csr_sddmm_heads, "K5": K.csr_segment_sum_thin,
            "K6": K.csr_segment_max_thin, "K7": K.csr_tile_rows_thin}


def _time_ms(fn, reps=None, budget_ms=1500.0):
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up;
    ``reps=None`` picks as many as fit the budget (at most 20) from the
    warm-up's time, so slow kernels are timed fewer times."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    if reps is None:
        reps = int(max(1, min(20, budget_ms // max(start.elapsed_time(end), 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps=50):
    """Mean device time of ``fn`` over ``reps`` launches (the least of three
    such means) that are queued behind a few milliseconds of device sleep, so
    that the host's cost of a call (checks, allocation, the launch itself) is
    hidden and the events time the device alone, launch gaps included. For
    kernels of a few microseconds, whose back-to-back time (``_time_ms``) is
    the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):  # the least of three: a stall of the host shows as a longer one
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(8_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _host_us(fn, reps=200):
    """Host clock per call of ``fn`` while the device keeps up (no wait
    inside): what the caller's thread pays to queue one launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


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
    for name, log in logs.items():  # ptxas -v, one line per source
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
        stack = [int(v) for v in re.findall(r"(\d+) bytes stack frame", log)]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"  {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"stack frame up to {max(stack)} B, spill stores up to {max(spills)} B")


def phase_k1(graph):
    """K1 against its plain version at the main path's shapes."""
    import torch

    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum, csr_segment_sum_plain

    g = graph.to(DEVICE)
    n, e = g.num_nodes, g.n_edge
    deg = (g.row_offsets[1:] - g.row_offsets[:-1]).long()
    top = torch.topk(deg, 5).values.tolist()
    import numpy

    print(f"K1 graph: N={n} E={e} max row degree={top[0]} top-5={top} "
          f"mean={e / n:.1f} (drawn by numpy {numpy.__version__})", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    records, failures = [], []
    # the hub teacher's spmm: y = [z * x | z] in bfloat16, 768 wide at the
    # hidden layers and 128 at the last, 0/1 edge-drop weights (keep 0.7)
    keep = ((torch.rand(g.num_edges_padded, generator=gen, device=DEVICE) < 0.7)
            & g.edge_mask).float()
    keep_t = keep[g.csc_perm.long()].contiguous()
    f32, bf16 = torch.float32, torch.bfloat16
    for f, dtype, hub in ((256, f32, False), (256, bf16, False), (128, f32, False),
                          (128, bf16, False), (40, f32, False), (40, bf16, False),
                          (768, bf16, True), (128, bf16, True)):
        x = torch.randn(n, f, generator=gen, device=DEVICE).to(dtype)
        for direction, src, ro, w, sp in (
            ("fwd", g.senders, g.row_offsets, keep if hub else g.edge_weight, g.row_split),
            ("bwd", g.t_senders, g.t_row_offsets, keep_t if hub else g.t_edge_weight,
             g.t_row_split),
        ):
            got = csr_segment_sum(x, src, ro, w, sp)
            want = csr_segment_sum_plain(x, src, ro, w)
            abs_sum = csr_segment_sum_plain(x.abs(), src, ro, w.abs())
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = float(diff.max())
            ok = bool((diff <= TOL + TOL * abs_sum).all()) and got.shape == (n, f)
            same_bits = torch.equal(got, csr_segment_sum(x, src, ro, w, sp))
            no_split = torch.equal(got, csr_segment_sum(x, src, ro, w))
            ms = _time_ms(lambda: csr_segment_sum(x, src, ro, w, sp), 20)
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
            gathered_ms = gathered_bytes / HBM_BYTES_PER_S * 1e3
            name = (f"K1 csr_segment_sum {direction} F={f} {str(dtype)[6:]}"
                    + (" hub" if hub else ""))
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
                # the input features carry no gradient: no backward at F=128
                "on_main_path": hub or (dtype == torch.float32
                                        and not (f == 128 and direction == "bwd")),
                "shape": {"N": n, "E": e, "F": f},
                "redesigned": "row split",
            })
            print(f"  {name}: max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms} "
                  f"bound_ms={records[-1]['bound_ms']:.4f} "
                  f"gathered_bound_ms={gathered_ms:.4f} "
                  f"two launches {'equal' if same_bits else 'DIFFER'} "
                  f"without split {'equal' if no_split else 'DIFFERS'}", flush=True)
            if not ok:
                failures.append(name)
            if not (same_bits and no_split):
                failures.append(f"{name}: not the same bits twice or without the split")
    # padding edges lie past row_offsets[N]: poisoned, they must change nothing
    x = torch.randn(n, 40, generator=gen, device=DEVICE)
    poisoned = g.senders.clone()
    poisoned[e:] = 2**31 - 1
    if not torch.equal(
            csr_segment_sum(x, poisoned, g.row_offsets, g.edge_weight, g.row_split),
            csr_segment_sum(x, g.senders, g.row_offsets, g.edge_weight, g.row_split)):
        failures.append("K1 read a padding edge")
    torch.cuda.synchronize()
    return records, failures


def phase_reference():
    """The trainer on the card against the CPU trainer, same start, dropout 0:
    the GCN in ``supervised``, the GCN in ``nce`` composed with logit KD
    (1,620 train rows, below ``max_samples``: no row sampling, whose draws
    differ between the devices' generators) and SAGE in ``supervised``."""
    import numpy as np

    from efficient_gnns_tpu_torch.cli.arxiv import (
        oracle_teacher_features,
        oracle_teacher_logits,
    )
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.models import GCN, SAGE
    from efficient_gnns_tpu_torch.train import DistillConfig, NodeDistillTrainer

    ds = synthetic_node_dataset(num_nodes=3000, num_edges=15000, seed=5)
    teacher = dict(teacher_feat=oracle_teacher_features(ds.y, ds.num_classes),
                   teacher_logits=oracle_teacher_logits(ds.y, ds.num_classes))
    ok = True
    for tag, model_cls, cfg in (
        ("gcn supervised", GCN, {}),
        ("gcn nce+kd", GCN, dict(training="nce", kd_and_aux=True, beta=0.05, proj_dim=32)),
        ("sage supervised", SAGE, {}),
    ):
        hist = {}
        for device in ("cpu", DEVICE):
            model = model_cls(128, 64, 40, 2, dropout=0.0, seed=0, device=device)
            trainer = NodeDistillTrainer(
                model, DistillConfig(hidden=64, dropout=0.0, **cfg), ds.graph, ds.x, ds.y,
                ds.split_idx, device=device, **(teacher if cfg else {}))
            hist[device] = trainer.run_epochs(1, 3)
        got, want = hist[DEVICE][:, :3], hist["cpu"][:, :3]
        print(f"reference {tag}: cuda vs cpu trainer, 3 epochs, losses "
              f"{got[:, 0].tolist()} max_abs_err={float(np.abs(got - want).max()):.3e}",
              flush=True)
        ok = ok and bool(np.isfinite(got).all()
                         and np.allclose(got, want, rtol=1e-4, atol=1e-6))
    return ok


def _student(expt, gnn, training, extra=()):
    """One 10-epoch run of the student CLI at arxiv width with K1's counter
    read around it; returns (K1 launches, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import arxiv
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum

    argv = ARXIV + ["--gnn", gnn, "--training", training, *extra,
                    "--epochs", str(EPOCHS), "--runs", "1", "--log_steps", str(EPOCHS),
                    "--epoch_chunk", str(EPOCHS), "--device", DEVICE,
                    "--out_dir", OUT_DIR, "--expt_name", expt]
    csr_segment_sum.launches = 0
    summary = arxiv.main(argv)
    n = csr_segment_sum.launches
    with open(os.path.join(OUT_DIR, expt, f"{gnn}-{training}", "seed0",
                           "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss/train"] for line in f][-EPOCHS:]
    expected = K1_PER_EPOCH[gnn, training] * EPOCHS
    tag = f"{expt} {gnn} {training}"
    print(f"student {tag}: K1 launches={n} (expected {expected}) "
          f"mean epoch (train step + eval) "
          f"{summary['runs'][0]['seconds'] / EPOCHS * 1e3:.1f} ms "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    failures = []
    if n != expected:
        failures.append(f"{tag}: {n} K1 launches")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        failures.append(f"{tag}: losses not finite and falling")
    return n, failures


def phase_slice():
    """The port's student CLI at arxiv width with the oracle teacher: the GCN
    in ``supervised`` and ``kd``, SAGE in ``supervised``. Returns K1's
    launches in its runs."""
    launches, failures = 0, []
    for gnn, training in (("gcn", "supervised"), ("gcn", "kd"), ("sage", "supervised")):
        n, fails = _student("chip_smoke", gnn, training, HARD_U if gnn == "sage" else ())
        launches, failures = launches + n, failures + fails
    return launches, failures


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_ms(what, fn):
    """Time one PyTorch yardstick; None (with the reason) where it refuses."""
    try:
        return _time_ms(fn)
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
        print(f"  library call {what} unavailable: {exc}")
        return None


def phase_attention_kernels(graph, heads=HEADS, suffix=""):
    """K2, K4-K7 against their plain versions on ``graph`` at the ``heads``
    (H, D) pairs (K5-K7 once for each H); ``suffix`` ends the records'
    names. The teacher's arxiv shapes by default."""
    import torch

    from efficient_gnns_tpu_torch.graphs import build_row_split
    from efficient_gnns_tpu_torch.ops import cuda as K

    g = graph.to(DEVICE)
    n, e, e_pad = g.num_nodes, g.n_edge, g.num_edges_padded
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    records, failures = [], []
    source = "efficient_gnns_tpu_torch/ops/cuda/csrc/"
    pallas = "efficient_gnns_tpu/ops/pallas/"

    def record(kernel, name, src_file, replaces, err, ok, fn, plain, library, n_bytes, n_ops,
               shape):
        ms = _time_ms(fn)
        plain_ms = _time_ms(plain)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        records.append({
            "name": f"{kernel} {name}{suffix}", "route": "cuda", "source": source + src_file,
            "replaces": pallas + replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library, "shape": shape,
        })
        print(f"  {kernel} {name}{suffix}: max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library} "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        if not ok:
            failures.append(f"{kernel} {name}{suffix}")

    directions = (
        ("fwd", g.senders, g.receivers, g.row_offsets, None, g.row_split),
        ("bwd", g.t_senders, g.t_receivers, g.t_row_offsets, g.csc_perm.long(),
         g.t_row_split))
    thin_heads = set()  # K5-K7 run once for each H
    for h, d in heads:
        hd = h * d
        x = torch.randn(n, hd, generator=gen, device=DEVICE)
        gg = torch.randn(n, hd, generator=gen, device=DEVICE)
        w = torch.rand(e_pad, h, generator=gen, device=DEVICE)
        v = torch.randn(e_pad, h, generator=gen, device=DEVICE)
        vals = torch.randn(n, h, generator=gen, device=DEVICE)
        for direction, src, dst, ro, perm, sp in directions:
            wd = w if perm is None else w[perm].contiguous()
            shape = {"N": n, "E": e, "H": h, "D": d}
            tag = f"{direction} H={h} D={d}"
            # K2: multi-head segment sum; tolerance on each row's sum of |terms|
            got = K.csr_segment_sum_heads(x, wd, src, ro, sp)
            want = K.csr_segment_sum_heads_plain(x, wd, src, ro)
            scale = K.csr_segment_sum_heads_plain(x.abs(), wd.abs(), src, ro)
            diff = (got - want).abs()
            same_bits = torch.equal(got, K.csr_segment_sum_heads(x, wd, src, ro, sp))
            no_split = torch.equal(got, K.csr_segment_sum_heads(x, wd, src, ro))
            print(f"  K2 {tag}: two launches {'equal' if same_bits else 'DIFFER'}, "
                  f"without split {'equal' if no_split else 'DIFFERS'}", flush=True)
            if not (same_bits and no_split):
                failures.append(f"K2 {tag}: not the same bits twice or without the split")
            xs = [x.view(n, h, d)[:, j].contiguous() for j in range(h)]
            mats = [torch.sparse_csr_tensor(ro, src[:e], wd[:e, j].contiguous(), (n, n))
                    for j in range(h)]
            lib = _library_ms(f"K2 ({h} CSR matmuls)",
                              lambda: [a @ xj for a, xj in zip(mats, xs)])
            record("K2", f"csr_segment_sum_heads {tag}", "segment_heads.cu",
                   "segment_matmul.py:92", float(diff.max()),
                   bool((diff <= TOL + TOL * scale).all()),
                   lambda: K.csr_segment_sum_heads(x, wd, src, ro, sp),
                   lambda: K.csr_segment_sum_heads_plain(x, wd, src, ro), lib,
                   2 * n * hd * 4 + e * 4 + e * h * 4 + (n + 1) * 4, 2 * e * hd, shape)
            records[-1].update(redesigned="row split", device_ms=_device_ms(
                lambda: K.csr_segment_sum_heads(x, wd, src, ro, sp)))
            print(f"  K2 {tag}: device alone ms={records[-1]['device_ms']:.4f}", flush=True)
            del got, want, scale, diff
            # K4: per-edge head dots; tolerance on each dot's sum of |terms|
            got = K.csr_sddmm_heads(gg, x, src, ro, h, sp)
            want = K.csr_sddmm_heads_plain(gg, x, src, ro, h)
            scale = K.csr_sddmm_heads_plain(gg.abs(), x.abs(), src, ro, h)
            diff = (got - want).abs()
            # each dot has one owner and one order: the same bits twice, without
            # the split and with chunks of 32 edges
            same_bits = torch.equal(got, K.csr_sddmm_heads(gg, x, src, ro, h, sp))
            no_split = torch.equal(got, K.csr_sddmm_heads(gg, x, src, ro, h))
            other = torch.equal(got, K.csr_sddmm_heads(gg, x, src, ro, h,
                                                       build_row_split(ro, 32).to(DEVICE)))
            print(f"  K4 {tag}: two launches {'equal' if same_bits else 'DIFFER'}, "
                  f"without split {'equal' if no_split else 'DIFFERS'}, "
                  f"chunks of 32 {'equal' if other else 'DIFFER'}", flush=True)
            if not (same_bits and no_split and other):
                failures.append(f"K4 {tag}: not the same bits twice, without the split "
                                "or with another")
            pattern = torch.sparse_csr_tensor(ro, src[:e], torch.zeros(e, device=DEVICE),
                                              (n, n))
            gs = [gg.view(n, h, d)[:, j].contiguous() for j in range(h)]
            xts = [xj.t().contiguous() for xj in xs]
            lib = _library_ms(f"K4 ({h} sampled_addmm calls)", lambda: [
                torch.sparse.sampled_addmm(pattern, gj, xtj, beta=0.0)
                for gj, xtj in zip(gs, xts)])
            record("K4", f"csr_sddmm_heads {tag}", "segment_heads.cu",
                   "segment_matmul.py:250", float(diff.max()),
                   bool((diff <= TOL + TOL * scale).all()),
                   lambda: K.csr_sddmm_heads(gg, x, src, ro, h, sp),
                   lambda: K.csr_sddmm_heads_plain(gg, x, src, ro, h), lib,
                   2 * n * hd * 4 + e * 4 + (n + 1) * 4 + e_pad * h * 4, 2 * e * hd, shape)
            records[-1].update(redesigned="row walk, g once per row", device_ms=_device_ms(
                lambda: K.csr_sddmm_heads(gg, x, src, ro, h, sp)))
            print(f"  K4 {tag}: device alone ms={records[-1]['device_ms']:.4f}", flush=True)
            del got, want, scale, diff, pattern, mats
            # K5 / K6: thin segment sum and max; K7: rows back to the edges
            offsets = ro.long()
            thin_bytes = e * h * 4 + (n + 1) * 4 + n * h * 4
            thin_shape = {"N": n, "E": e, "H": h}

            def thin(kernel, name, replaces, design, err, ok, fn, plain, lib_name, lib_fn,
                     n_bytes, n_ops):
                """One record of K5-K7, with the device-only times beside the
                back-to-back ones (which, at these sizes, are the host's)."""
                record(kernel, f"{name} {tag}", "segment_thin.cu", replaces, err, ok, fn,
                       plain, _library_ms(f"{kernel} ({lib_name})", lib_fn), n_bytes, n_ops,
                       thin_shape)
                records[-1].update(redesigned=design, device_ms=_device_ms(fn),
                                   library_device_ms=_device_ms(lib_fn))
                print(f"  {kernel} {tag}: device alone ms={records[-1]['device_ms']:.4f} "
                      f"{lib_name} {records[-1]['library_device_ms']:.4f}", flush=True)

            if (h, direction) in thin_heads:
                continue
            thin_heads.add((h, direction))
            for kernel, fn, op, line in (("K5", K.csr_segment_sum_thin, "sum", 114),
                                         ("K6", K.csr_segment_max_thin, "max", 186)):
                got = fn(v, ro, sp)
                want = K.csr_segment_reduce_thin_plain(v, ro, op)
                diff = (got - want).abs()
                if op == "sum":  # tolerance on each row's sum of |terms|
                    scale = K.csr_segment_reduce_thin_plain(v.abs(), ro, "sum")
                    ok = bool((diff <= TOL + TOL * scale).all())
                else:
                    ok = torch.equal(got, want)
                same_bits = torch.equal(got, fn(v, ro, sp))
                no_split = torch.equal(got, fn(v, ro))
                print(f"  {kernel} {tag}: two launches {'equal' if same_bits else 'DIFFER'}, "
                      f"without split {'equal' if no_split else 'DIFFERS'}", flush=True)
                if not (same_bits and no_split):
                    failures.append(
                        f"{kernel} {tag}: not the same bits twice or without the split")
                thin(kernel, fn.__name__, f"segment_thin.py:{line}", "row split, lane groups",
                     float(diff.max()), ok, lambda: fn(v, ro, sp),
                     lambda: K.csr_segment_reduce_thin_plain(v, ro, op),
                     f"segment_reduce {op}",
                     lambda: torch.segment_reduce(v[:e], op, offsets=offsets),
                     thin_bytes, e * h)
            got = K.csr_tile_rows_thin(vals, dst, ro)
            want = K.csr_tile_rows_thin_plain(vals, dst, ro)
            thin("K7", "csr_tile_rows_thin", "segment_thin.py:145", "four floats a thread",
                 float((got - want).abs().max()), torch.equal(got, want),
                 lambda: K.csr_tile_rows_thin(vals, dst, ro),
                 lambda: K.csr_tile_rows_thin_plain(vals, dst, ro),
                 "index_select", lambda: vals.index_select(0, dst[:e]),
                 n * h * 4 + e * 4 + e_pad * h * 4, 0)
            if h == heads[0][0] and direction == "fwd":
                host = {k: _host_us(f) for k, f in (
                    ("empty launch", lambda: K.segment_thin.empty_launch(DEVICE)),
                    ("K5", lambda: K.csr_segment_sum_thin(v, ro, sp)),
                    ("K7", lambda: K.csr_tile_rows_thin(vals, dst, ro)),
                    ("index_select", lambda: vals.index_select(0, dst[:e])))}
                print(f"  launch floor: an empty kernel takes "
                      f"{_device_ms(lambda: K.segment_thin.empty_launch(DEVICE), 200) * 1e3:.2f}"
                      f" us of device time back to back; host time to queue one call, us: "
                      + ", ".join(f"{k} {us:.1f}" for k, us in host.items()), flush=True)
            del got, want
    # padding edges lie past row_offsets[N]: poisoned, they must change nothing
    h, d = heads[-1]
    x = torch.randn(n, h * d, generator=gen, device=DEVICE)
    w = torch.rand(e_pad, h, generator=gen, device=DEVICE)
    src, dst = g.senders.clone(), g.receivers.clone()
    src[e:] = 2**31 - 1
    dst[e:] = 2**31 - 1
    nan_w = w.clone()
    nan_w[e:] = float("nan")
    checks = {
        "K2": torch.equal(
            K.csr_segment_sum_heads(x, nan_w, src, g.row_offsets, g.row_split),
            K.csr_segment_sum_heads(x, w, g.senders, g.row_offsets, g.row_split)),
        "K4": torch.equal(K.csr_sddmm_heads(x, x, src, g.row_offsets, h, g.row_split),
                          K.csr_sddmm_heads(x, x, g.senders, g.row_offsets, h, g.row_split)),
        "K5": torch.equal(K.csr_segment_sum_thin(nan_w, g.row_offsets, g.row_split),
                          K.csr_segment_sum_thin(w, g.row_offsets, g.row_split)),
        "K6": torch.equal(K.csr_segment_max_thin(nan_w, g.row_offsets, g.row_split),
                          K.csr_segment_max_thin(w, g.row_offsets, g.row_split)),
        "K7": torch.equal(K.csr_tile_rows_thin(w[:n], dst, g.row_offsets),
                          K.csr_tile_rows_thin(w[:n], g.receivers, g.row_offsets)),
    }
    failures += [f"{k} read a padding edge" for k, ok in checks.items() if not ok]
    # a split of other offsets with the same rows and edges (the degrees in
    # reverse order; this graph is symmetric, so its transpose order will not
    # do): only its content tells, and the wrapper must refuse it. Without a
    # long row every offsets' split is the same empty schedule, rightly taken
    if g.row_split.num_long:
        reverse = torch.zeros_like(g.row_offsets)
        reverse[1:] = torch.cumsum((g.row_offsets[1:] - g.row_offsets[:-1]).flip(0), 0)
        try:
            K.csr_segment_sum_thin(w, g.row_offsets, build_row_split(reverse).to(DEVICE))
            failures.append("K5 took the row split of other offsets")
        except ValueError:
            pass
    torch.cuda.synchronize()
    return records, failures


def phase_k3(graph):
    """K3 against its plain version at the arxiv shape of the runtime-weight
    ``spmm`` backward (the cotangent's rows by receiver, x's by sender)."""
    import torch

    from efficient_gnns_tpu_torch.graphs import build_row_split
    from efficient_gnns_tpu_torch.ops.cuda import csr_sddmm, csr_sddmm_plain

    g = graph.to(DEVICE)
    n, e, e_pad = g.num_nodes, g.n_edge, g.num_edges_padded
    args = (g.senders, g.row_offsets)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    records, failures = [], []
    other_split = build_row_split(g.row_offsets, 32).to(DEVICE)
    for f in (256, 40):
        for dtype in (torch.float32, torch.bfloat16):
            cot = torch.randn(n, f, generator=gen, device=DEVICE).to(dtype)
            x = torch.randn(n, f, generator=gen, device=DEVICE).to(dtype)
            got = csr_sddmm(cot, x, *args, g.row_split)
            want = csr_sddmm_plain(cot, x, *args)
            # tolerance on each dot's sum of |terms| (summation order)
            scale = csr_sddmm_plain(cot.abs(), x.abs(), *args)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            ok = bool((diff <= TOL + TOL * scale).all()) and got.shape == (e_pad,)
            # one owner and one order per dot: the same bits twice, without the
            # split and with chunks of 32 edges
            same_bits = (torch.equal(got, csr_sddmm(cot, x, *args, g.row_split))
                         and torch.equal(got, csr_sddmm(cot, x, *args))
                         and torch.equal(got, csr_sddmm(cot, x, *args, other_split)))
            ms = _time_ms(lambda: csr_sddmm(cot, x, *args, g.row_split))
            plain_ms = _time_ms(lambda: csr_sddmm_plain(cot, x, *args))
            xt = x.t().contiguous()
            library_ms = None
            try:  # the yardstick's sampling pattern, in the inputs' dtype
                pattern = torch.sparse_csr_tensor(
                    g.row_offsets, g.senders[:e],
                    torch.zeros(e, dtype=dtype, device=DEVICE), (n, n))
            except (RuntimeError, NotImplementedError) as exc:
                print(f"  library call K3 ({dtype} CSR pattern) unavailable: {exc}")
            else:
                library_ms = _library_ms(
                    f"K3 (sampled_addmm, {dtype})",
                    lambda: torch.sparse.sampled_addmm(pattern, cot, xt, beta=0.0))
            item = x.element_size()
            bound_ms, bound_by = _bound(
                2 * n * f * item + e * 4 + (n + 1) * 4 + e_pad * 4, 2 * e * f)
            gathered_ms = (n * f * item + e * f * item + e * 4 + (n + 1) * 4
                           + e_pad * 4) / HBM_BYTES_PER_S * 1e3
            name = f"K3 csr_sddmm F={f} {str(dtype)[6:]}"
            records.append({
                "name": name, "route": "cuda",
                "source": "efficient_gnns_tpu_torch/ops/cuda/csrc/segment_sddmm.cu",
                "replaces": "efficient_gnns_tpu/ops/pallas/segment_matmul.py:315",
                "launches": None, "max_abs_err": float(diff.max()), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "on_main_path": dtype == torch.float32 and f == 256,
                "shape": {"N": n, "E": e, "F": f},
                "redesigned": "row walk, g once per row",
            })
            print(f"  {name}: max_abs_err={records[-1]['max_abs_err']:.3e} "
                  f"{'ok' if ok else 'MISMATCH'} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms} bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"gathered_bound_ms={gathered_ms:.4f} two launches, without split and "
                  f"with chunks of 32 {'equal' if same_bits else 'DIFFER'}", flush=True)
            if not ok:
                failures.append(name)
            if not same_bits:
                failures.append(f"{name}: not the same bits twice, without the split "
                                "or with another")
            del got, want, scale, diff
    # padding edges lie past row_offsets[N]: poisoned, they must change nothing
    cot = torch.randn(n, 40, generator=gen, device=DEVICE)
    src = g.senders.clone()
    src[e:] = 2**31 - 1
    got = csr_sddmm(cot, cot, src, g.row_offsets, g.row_split)
    if not torch.equal(got, csr_sddmm(cot, cot, *args, g.row_split)) or bool(got[e:].any()):
        failures.append("K3 read a padding edge")
    torch.cuda.synchronize()
    return records, failures


def phase_runtime_spmm(graph):
    """``spmm`` with per-call trainable edge weights on the card at arxiv
    shape, F = 256: ``loss = sum(sin(spmm(graph, x, edge_weight=w)))``,
    forward and backward, with K1's and K3's counters read around it.
    Returns (launches by kernel, failures)."""
    import torch

    from efficient_gnns_tpu_torch.ops import spmm
    from efficient_gnns_tpu_torch.ops.cuda import (
        csr_sddmm,
        csr_sddmm_plain,
        csr_segment_sum,
        csr_segment_sum_plain,
    )

    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn(graph.num_nodes, 256, generator=gen)
    # the GCN norm times a factor near 1: row sums of order 1 under the sin
    w0 = graph.edge_weight * (0.5 + torch.rand(graph.num_edges_padded, generator=gen))

    def run(device, weight_grad=True):
        g = graph.to(device)
        x = x0.to(device, copy=True).requires_grad_()
        w = w0.to(device, copy=True).requires_grad_()
        out = spmm(g, x, edge_weight=w, weight_grad=weight_grad)
        loss = torch.sin(out).sum()
        loss.backward()
        return loss.detach(), out.detach(), x.grad, w.grad

    failures = []
    csr_segment_sum.launches = csr_sddmm.launches = 0
    t0 = time.time()
    loss, out, dx, dw = run(DEVICE)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {"K1": csr_segment_sum.launches, "K3": csr_sddmm.launches}
    if launches != {"K1": 2, "K3": 1}:
        failures.append(f"runtime spmm: launches {launches}, expected K1 2, K3 1")

    csr_sddmm.launches = 0
    _, _, dx_off, dw_off = run(DEVICE, weight_grad=False)
    if csr_sddmm.launches or bool(dw_off.any()) or not torch.equal(dx_off, dx):
        failures.append("runtime spmm: weight_grad=False launched K3 or changed dx / dw")

    ref_loss, ref_out, ref_dx, ref_dw = (t.to(DEVICE) for t in run("cpu"))
    # tolerance on each output's sum of |terms|, computed on the card
    g = graph.to(DEVICE)
    cot, xd, wd = torch.cos(out), x0.to(DEVICE), w0.to(DEVICE)
    out_scale = csr_segment_sum_plain(xd.abs(), g.senders, g.row_offsets, wd.abs())
    dx_scale = csr_segment_sum_plain(cot.abs(), g.t_senders, g.t_row_offsets,
                                     wd[g.csc_perm.long()].abs())
    dw_scale = csr_sddmm_plain(cot.abs(), xd.abs(), g.senders, g.row_offsets)
    errs = {}
    for name, got, want, scale in (("out", out, ref_out, out_scale),
                                   ("dx", dx, ref_dx, dx_scale),
                                   ("dw", dw, ref_dw, dw_scale)):
        diff = (got - want).abs()
        errs[name] = float(diff.max())
        if not bool((diff <= RT_TOL + RT_TOL * scale).all()) or got.shape != want.shape:
            failures.append(f"runtime spmm: {name} disagrees with the CPU")
    if not bool(torch.isfinite(loss)) or bool(dw[graph.n_edge:].any()):
        failures.append("runtime spmm: loss not finite or dw on padding edges")
    print(f"runtime spmm F=256: launches {launches} forward+backward "
          f"{seconds * 1e3:.1f} ms (first call) loss {float(loss):.4f} "
          f"(cpu {float(ref_loss):.4f}) max_abs_err vs cpu {errs}", flush=True)
    return launches, failures


def phase_split_edges():
    """K1-K6 at the edges of the row split, on small made-up graphs on the
    card: each case against the plain version (``TOL + TOL * sum|terms|``;
    the max exactly) and launched twice for the same bits. Padding edges
    carry an out-of-range sender and a NaN weight or value. K7
    on the same graphs, exactly, with an out-of-range ``dst`` on the padding,
    an ``E_pad`` that is no multiple of 4, and ``dst``
    as a view that is not 16-byte aligned. Returns the failures."""
    import torch

    from efficient_gnns_tpu_torch.graphs import ROW_SPLIT_THRESHOLD as T
    from efficient_gnns_tpu_torch.graphs import build_row_split
    from efficient_gnns_tpu_torch.ops import cuda as K
    from efficient_gnns_tpu_torch.ops.segment import csr_row_ids

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    cases = {
        "one row holds every edge": [5 * T + 3],
        "rows of T, T+1, 2T, 2T+1 among empty rows":
            [0, T, 0, T + 1, 0, 0, 2 * T, 2 * T + 1, 0, 3, 0],
        "the last row long": [2, 0, 7, 3 * T + 5],
    }
    n_src, pad, checks, failures = 97, 37, 0, []

    def hold(tag, got, again, want, scale=None):
        """``scale``: each output's sum of |terms|; None for an exact match."""
        nonlocal checks
        checks += 1
        if not (torch.equal(got, want) if scale is None
                else bool(((got - want).abs() <= TOL + TOL * scale).all())):
            failures.append(f"split edges: {tag} disagrees with the plain version")
        if not torch.equal(got, again):
            failures.append(f"split edges: {tag} differs between two launches")

    for case, degrees in cases.items():
        deg = torch.tensor(degrees)
        e = int(deg.sum())
        ro = torch.zeros(len(degrees) + 1, dtype=torch.int32)
        ro[1:] = torch.cumsum(deg, 0)
        split = build_row_split(ro).to(DEVICE)
        assert split.num_long == sum(d > T for d in degrees)
        ro = ro.to(DEVICE)
        src = torch.randint(0, n_src, (e + pad,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        src[e:] = 2**31 - 1
        for f in (1, 33, 40, 250, 256):
            w = torch.randn(e + pad, generator=gen, device=DEVICE)
            w[e:] = float("nan")
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n_src, f, generator=gen, device=DEVICE).to(dtype)
                for wt in (w, None):
                    hold(f"K1 {case} F={f} {str(dtype)[6:]} "
                         f"{'weighted' if wt is not None else 'unweighted'}",
                         K.csr_segment_sum(x, src, ro, wt, split),
                         K.csr_segment_sum(x, src, ro, wt, split),
                         K.csr_segment_sum_plain(x, src, ro, wt),
                         K.csr_segment_sum_plain(x.abs(), src, ro,
                                                 None if wt is None else wt.abs()))
                # K3: g has one row per CSR row, x one per sender
                g = torch.randn(len(degrees), f, generator=gen, device=DEVICE).to(dtype)
                hold(f"K3 {case} F={f} {str(dtype)[6:]}", K.csr_sddmm(g, x, src, ro, split),
                     K.csr_sddmm(g, x, src, ro, split), K.csr_sddmm_plain(g, x, src, ro),
                     K.csr_sddmm_plain(g.abs(), x.abs(), src, ro))
        for h, d in ((1, 40), (3, 250), (4, 33)):
            x = torch.randn(n_src, h * d, generator=gen, device=DEVICE)
            w = torch.randn(e + pad, h, generator=gen, device=DEVICE)
            w[e:] = float("nan")
            hold(f"K2 {case} H={h} D={d}",
                 K.csr_segment_sum_heads(x, w, src, ro, split),
                 K.csr_segment_sum_heads(x, w, src, ro, split),
                 K.csr_segment_sum_heads_plain(x, w, src, ro),
                 K.csr_segment_sum_heads_plain(x.abs(), w.abs(), src, ro))
            g = torch.randn(len(degrees), h * d, generator=gen, device=DEVICE)
            hold(f"K4 {case} H={h} D={d}", K.csr_sddmm_heads(g, x, src, ro, h, split),
                 K.csr_sddmm_heads(g, x, src, ro, h, split),
                 K.csr_sddmm_heads_plain(g, x, src, ro, h),
                 K.csr_sddmm_heads_plain(g.abs(), x.abs(), src, ro, h))
        pad7 = pad + ((e + pad) % 4 == 0)  # K7: E_pad no multiple of 4
        dst = torch.full((e + pad7 + 1,), 2**31 - 1, dtype=torch.int32, device=DEVICE)
        dst[1:e + 1] = csr_row_ids(ro, e)
        for h in (1, 3, 8):
            v = torch.randn(e + pad, h, generator=gen, device=DEVICE)
            v[e:] = float("nan")
            hold(f"K5 {case} H={h}", K.csr_segment_sum_thin(v, ro, split),
                 K.csr_segment_sum_thin(v, ro, split),
                 K.csr_segment_reduce_thin_plain(v, ro, "sum"),
                 K.csr_segment_reduce_thin_plain(v.abs(), ro, "sum"))
            hold(f"K6 {case} H={h}", K.csr_segment_max_thin(v, ro, split),
                 K.csr_segment_max_thin(v, ro, split),
                 K.csr_segment_reduce_thin_plain(v, ro, "max"))
            vals = torch.randn(len(degrees), h, generator=gen, device=DEVICE)
            for tag, d in (("aligned dst", dst[1:].clone()), ("dst view off by 4 bytes",
                                                              dst[1:])):
                assert (d.data_ptr() % 16 == 0) == (tag == "aligned dst") and d.shape[0] % 4
                hold(f"K7 {case} H={h} {tag}", K.csr_tile_rows_thin(vals, d, ro),
                     K.csr_tile_rows_thin(vals, d, ro),
                     K.csr_tile_rows_thin_plain(vals, d, ro))
    torch.cuda.synchronize()
    print(f"split edges: {checks} cases at T={T}, {len(failures)} failed", flush=True)
    return failures


def phase_threshold_sweep(graph):
    """K1 (F = 256 and 40), K2 (H = 3, D = 250) and K5 (H = 3) at arxiv shape
    with the row split built at other chunk sizes: times only."""
    import torch

    from efficient_gnns_tpu_torch.graphs import ROW_SPLIT_THRESHOLD, build_row_split
    from efficient_gnns_tpu_torch.ops import cuda as K

    g = graph.to(DEVICE)
    n = g.num_nodes
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    xs = {f: torch.randn(n, f, generator=gen, device=DEVICE) for f in (256, 40, 750)}
    wh = torch.rand(g.num_edges_padded, 3, generator=gen, device=DEVICE)
    for t in (32, 64, 128, 256, 512, 2048):
        sp = build_row_split(graph.row_offsets, t).to(DEVICE)
        ms = [_time_ms(lambda: K.csr_segment_sum(xs[f], g.senders, g.row_offsets,
                                                 g.edge_weight, sp), 20)
              for f in (256, 40)]
        ms.append(_time_ms(lambda: K.csr_segment_sum_heads(
            xs[750], wh, g.senders, g.row_offsets, sp), 20))
        ms.append(_device_ms(lambda: K.csr_segment_sum_thin(wh, g.row_offsets, sp)))
        print(f"threshold {t}{' (built in)' if t == ROW_SPLIT_THRESHOLD else ''}: "
              f"{sp.num_long} long rows, {sp.num_chunks} chunks; K1 F=256 {ms[0]:.4f} ms, "
              f"K1 F=40 {ms[1]:.4f} ms, K2 H=3 D=250 {ms[2]:.4f} ms, "
              f"K5 H=3 {ms[3]:.4f} ms (device alone)", flush=True)


# (row group, chunk group, loads in flight) of csrc/segment_thin.cu; the first
# is the one built in
THIN_VARIANTS = ((4, 32, 4), (1, 32, 4), (2, 32, 4), (8, 32, 4), (16, 32, 4), (32, 32, 4),
                 (4, 8, 4), (4, 32, 1), (4, 32, 2), (4, 32, 8))


def phase_thin_group_sweep(graph):
    """K5 and K6 at arxiv shape (forward CSR, H = 3 and 1) rebuilt with other
    lane-group widths and loads in flight: device times only, and each
    variant's sum against the built-in kernel's (another summation order, so
    within the tolerance, not the same bits). What the constants of
    ``csrc/segment_thin.cu`` were chosen from."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from efficient_gnns_tpu_torch.ops import cuda as K
    from efficient_gnns_tpu_torch.ops.cuda import build

    def defines(variant):
        return tuple(f"-DEGT_THIN_{k}={v}" for k, v in
                     zip(("ROW_GROUP", "CHUNK_GROUP", "LOADS"), variant))

    t0 = time.time()
    with ThreadPoolExecutor(len(THIN_VARIANTS)) as pool:  # one nvcc each, all at once
        list(pool.map(lambda v: build.build(["segment_thin"], defines(v)), THIN_VARIANTS))
    print(f"thin group sweep: {len(THIN_VARIANTS)} variants built in "
          f"{time.time() - t0:.1f} s", flush=True)
    g = graph.to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    vs = {h: torch.randn(g.num_edges_padded, h, generator=gen, device=DEVICE) for h in (3, 1)}
    want = {h: K.csr_segment_sum_thin(v, g.row_offsets, g.row_split) for h, v in vs.items()}
    scale = {h: K.csr_segment_reduce_thin_plain(v.abs(), g.row_offsets, "sum")
             for h, v in vs.items()}
    failures = []
    try:
        for variant in THIN_VARIANTS:
            K.segment_thin.BUILD_DEFINES = defines(variant)
            ms = []
            for h, v in vs.items():
                got = K.csr_segment_sum_thin(v, g.row_offsets, g.row_split)
                if not bool(((got - want[h]).abs() <= TOL + TOL * scale[h]).all()):
                    failures.append(f"thin group sweep: variant {variant} H={h} disagrees")
                ms += [_device_ms(lambda: fn(v, g.row_offsets, g.row_split))
                       for fn in (K.csr_segment_sum_thin, K.csr_segment_max_thin)]
            print(f"thin groups row={variant[0]} chunk={variant[1]} loads={variant[2]}"
                  f"{' (built in)' if variant == THIN_VARIANTS[0] else ''}: "
                  f"K5 H=3 {ms[0]:.4f} ms, K6 H=3 {ms[1]:.4f} ms, K5 H=1 {ms[2]:.4f} ms, "
                  f"K6 H=1 {ms[3]:.4f} ms (device alone)", flush=True)
    finally:
        K.segment_thin.BUILD_DEFINES = ()
    torch.cuda.synchronize()
    return failures


def _teacher_config(no_attn_dst, **kw):
    from efficient_gnns_tpu_torch.train import TeacherConfig

    return TeacherConfig(no_attn_dst=no_attn_dst, **kw)


def phase_teacher_reference():
    """The teacher trainer on the card against the CPU trainer, same start,
    every dropout 0 and no label split (mask_rate 0): with attn-dst on a
    graph without hubs (the edge softmax), and without attn-dst on a graph
    with 64 hubs (the hub attention path, float32 hub messages)."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.ops import dispatch
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum, csr_segment_sum_heads
    from efficient_gnns_tpu_torch.train import GATTeacherTrainer

    ok = True
    for tag, no_attn_dst, hub_dense in (("attn-dst", False, 0), ("hub", True, 64)):
        ds = synthetic_node_dataset(num_nodes=3000, num_edges=15000, seed=5, gcn_norm=False,
                                    hub_dense=hub_dense)
        cfg = _teacher_config(no_attn_dst, n_hidden=32, dropout=0.0, input_drop=0.0,
                              edge_drop=0.0, mask_rate=0.0, lr=0.01)
        hist = {}
        dispatch.set_hub_message_dtype(torch.float32)
        try:
            for device in ("cpu", DEVICE):
                csr_segment_sum.launches = csr_segment_sum_heads.launches = 0
                trainer = GATTeacherTrainer(cfg, ds.graph, ds.x, ds.y, ds.split_idx,
                                            ds.num_classes, device=device)
                hist[device] = trainer.run_epochs(1, 3)[1]
        finally:
            dispatch.set_hub_message_dtype(torch.bfloat16)
        # the hub path runs K1 and never K2; the edge softmax the other way round
        path_ok = ((csr_segment_sum.launches > 0) == no_attn_dst
                   and (csr_segment_sum_heads.launches > 0) != no_attn_dst)
        losses = [0, 5, 6, 7]
        got, want = hist[DEVICE][:, losses], hist["cpu"][:, losses]
        print(f"teacher reference {tag}: cuda vs cpu trainer, 3 epochs, losses "
              f"{got[:, 0].tolist()} max_abs_err={float(np.abs(got - want).max()):.3e} "
              f"K1 launches {csr_segment_sum.launches} K2 {csr_segment_sum_heads.launches}",
              flush=True)
        ok = ok and path_ok and bool(np.isfinite(got).all()
                                     and np.allclose(got, want, rtol=1e-4, atol=1e-6))
    return ok


def _hub_scales(feat, el, mags, negative_slope=0.2):
    """Each entry's sum of |terms| for ``hub_gat_attention``'s out, dfeat and
    del, from ``mags``: the CPU path's out, dfeat and del run on |feat| and
    |cot| with the same ``el``. Then out and dfeat are such sums already
    (the softmax weights are positive); del = L * z * (sum_c x_c * gy_c +
    gy_den) with L the leaky_relu slope, and on the |.| inputs its first part
    P = L * sum_c |x_c| * dfeat_c is >= 0 and the rest del - P (the
    denominator's cotangent) <= 0, so |P| + |del - P| is del's."""
    import torch

    out_abs, dfeat_abs, del_abs = mags
    slope = torch.where(el > 0, 1.0, negative_slope)
    p = slope * (feat.abs() * dfeat_abs).sum(-1)
    return [out_abs, dfeat_abs, p.abs() + (del_abs - p).abs()]


def phase_hub_attention():
    """``hub_gat_attention`` on the card against the CPU on a graph of 20,000
    nodes whose edges (over 200k) switch the hub partition on
    (``hub_dense="auto"``: 512 hubs), at the teacher's widths (H = 3, D = 250; H = 1, D = 40), with
    edge-drop 0.3 from a seed near 2**32 and without: the same keep set on
    both devices; values and gradients in float32 hub messages entry by
    entry within 1e-6 + 1e-4 of the entry's sum of |terms| (``_hub_scales``:
    the orders of the sums differ, and a hub sender's gradient sums the
    cotangents of thousands of receivers with cancellation, so an entry's own
    size is no scale); and the card's bfloat16 default within 1e-2 of
    max|out| of the float32 CPU result. K1 twice (forward, transpose
    backward), nothing else. Returns the failures."""
    import torch

    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.ops import dispatch
    from efficient_gnns_tpu_torch.ops import hub_attention as hub

    graph = synthetic_node_dataset(num_nodes=20000, num_edges=120000, seed=7,
                                   gcn_norm=False).graph
    if not hub.supports_hub_attention(graph):
        return ["hub attention: the graph has no hub partition"]
    print(f"hub attention graph: N={graph.num_nodes} E={graph.n_edge} hubs "
          f"{graph.hub.hub_src.shape[0]}: {graph.hub.src_eids.shape[0]} sender-hub edges, "
          f"{graph.hub.dst_eids.shape[0]} receiver-hub edges", flush=True)
    failures = []
    gen = torch.Generator().manual_seed(8)
    n, seed = graph.num_nodes, 2**32 - 9
    keep = {dev: hub.hub_keep_weights(graph.to(dev), torch.tensor(seed, device=dev), 0.7)
            for dev in ("cpu", DEVICE)}
    if not torch.equal(keep["cpu"], keep[DEVICE].cpu()):
        failures.append("hub attention: the keep set differs between the devices")
    counters = _counters()
    for h, d in HEADS:
        feat = torch.randn(n, h, d, generator=gen)
        el = torch.randn(n, h, generator=gen) * 2
        cot = torch.randn(n, h, d, generator=gen)
        for drop in (None, seed):
            def run(dev, dtype, feat=feat, cot=cot):
                dispatch.set_hub_message_dtype(dtype)
                try:
                    f = feat.to(dev, copy=True).requires_grad_()
                    e = el.to(dev, copy=True).requires_grad_()
                    out = hub.hub_gat_attention(
                        graph.to(dev), f, e, edge_drop=0.3,
                        drop_seed=None if drop is None else torch.tensor(drop, device=dev))
                    (out * cot.to(dev)).sum().backward()
                finally:
                    dispatch.set_hub_message_dtype(torch.bfloat16)
                return [t.detach().cpu() for t in (out, f.grad, e.grad)]

            want = run("cpu", torch.float32)
            scales = _hub_scales(feat, el, run("cpu", torch.float32, feat.abs(), cot.abs()))
            for c in counters.values():
                c.launches = 0
            got = run(DEVICE, torch.float32)
            launches = {k: c.launches for k, c in counters.items()}
            bf16 = run(DEVICE, torch.bfloat16)
            errs = [(a - b).abs() for a, b in zip(got, want)]
            # entries that no kept edge reaches have scale 0 and error 0
            ratios = [float((err / scale.clamp_min(1e-30)).max())
                      for err, scale in zip(errs, scales)]
            bf16_err = float((bf16[0] - want[0]).abs().max())
            tag = f"H={h} D={d} {'edge-drop 0.3' if drop else 'no drop'}"
            print(f"hub attention {tag}: card vs cpu out / dfeat / del max_abs_err "
                  + " / ".join(f"{float(err.max()):.3e}" for err in errs)
                  + ", max err / sum|terms| "
                  + " / ".join(f"{r:.3e}" for r in ratios)
                  + f", bfloat16 messages out {bf16_err:.3e} (max|out| "
                  f"{float(want[0].abs().max()):.3f}), launches {launches}", flush=True)
            if launches != {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}:
                failures.append(f"hub attention {tag}: launches {launches}")
            for name, err, scale in zip(("out", "dfeat", "del"), errs, scales):
                if not bool((err <= 1e-6 + 1e-4 * scale).all()):
                    failures.append(f"hub attention {tag}: {name} disagrees with the CPU")
            if not (bf16_err <= 1e-2 * float(want[0].abs().max())
                    and all(bool(torch.isfinite(t).all()) for t in bf16)):
                failures.append(f"hub attention {tag}: bfloat16 messages too far")
    torch.cuda.synchronize()
    return failures


def _teacher_run(argv, expected):
    """One run of the teacher CLI at arxiv shape with every kernel's counter
    read around it; returns (launches by kernel, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import gat_teacher

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    summary = gat_teacher.main(argv + [
        "--n-epochs", str(TEACHER_EPOCHS), "--epoch-chunk", str(TEACHER_EPOCHS),
        "--log-every", "1", "--out-dir", OUT_DIR, "--device", DEVICE])
    launches = {k: c.launches for k, c in counters.items()}
    run = summary["runs"][0]
    tag = "no-attn-dst (hub)" if "--no-attn-dst" in argv else "attn-dst"
    print(f"teacher slice {tag}: launches {launches} (expected per epoch {expected}) "
          f"mean epoch (train step + eval) {run['seconds'] / TEACHER_EPOCHS * 1e3:.1f} ms "
          f"losses {run['losses']}", flush=True)
    failures = [f"teacher {tag}: {launches[k]} {k} launches"
                for k, per_epoch in expected.items()
                if launches[k] != per_epoch * TEACHER_EPOCHS]
    if not all(math.isfinite(v) for v in run["losses"]):
        failures.append(f"teacher {tag}: losses not finite")
    return launches, failures


def phase_teacher_slice():
    """The teacher CLI at arxiv shape with the flags of
    ``experiments/arxiv_hard.sh`` step 1 (``--no-attn-dst``: the hub attention
    path, K1 alone) and again with attn-dst on (K2, K4-K7), every kernel
    counted; then the student from the flagship teacher's dump in ``kd``,
    ``nce`` and ``gcd`` mode (K1 counted). The dump stays for the SIGN slice.
    Returns (launches by kernel, summed over the runs, and failures)."""
    import numpy as np

    from efficient_gnns_tpu_torch.distill import load_teacher_dump

    launches, failures = _teacher_run(TEACHER, TEACHER_LAUNCHES)
    more, fails = _teacher_run(TEACHER_ATTN_DST, TEACHER_ATTN_DST_LAUNCHES)
    launches = {k: v + more[k] for k, v in launches.items()}
    failures += fails
    feats, logits = load_teacher_dump(TEACHER_DUMP, 0)
    print(f"teacher dump: features {feats.shape} logits {logits.shape}", flush=True)
    if (feats.shape != (169343, 750) or logits.shape != (169343, 40)
            or not (np.isfinite(feats).all() and np.isfinite(logits).all())):
        failures.append("teacher dump not finite [N, 750] / [N, 40]")
    del feats, logits
    for training, extra in (("kd", ["--alpha", "0.9", "--kd_T", "4"]),
                            ("nce", NCE), ("gcd", NCE)):
        n, fails = _student("chip_smoke_dump", "gcn", training,
                            HARD_U + extra + ["--teacher_dir", TEACHER_DUMP])
        launches["K1"] += n
        failures += fails
    return launches, failures


# host calls that wait for the device (or, for the copies, may)
_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
          "cudaMemcpyAsync", "cudaMemcpy", "aten::item", "aten::_local_scalar_dense",
          "aten::nonzero")


def _profile(tag, chunk, epochs, also=()):
    """``chunk()`` (``epochs`` epochs of a trainer, ending in its one host
    copy) under torch.profiler: wall time, device busy time and idle share,
    device time by kernel (the 14 largest, and every kernel whose name holds
    one of ``also``), the host calls that wait for the device and the host
    ops of most self CPU time. The tables, by device and by host time, go to
    ``OUT_DIR/<tag>_profile.txt``; returns the device busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3

    def self_device_us(ev):  # named self_cuda_time_total before torch 2.4
        us = getattr(ev, "self_device_time_total", None)
        return ev.self_cuda_time_total if us is None else us

    # device-side entries only: a kernel launched through ctypes is also
    # charged to the host-side op around it (e.g. _GATAttention), and a user
    # annotation (the optimizer's step) spans its kernels and the gaps
    # between them
    averages = prof.key_averages()
    events = [ev for ev in averages
              if ev.device_type == DeviceType.CUDA and self_device_us(ev) > 0
              and not getattr(ev, "is_user_annotation", False)]
    device_ms = sum(self_device_us(ev) for ev in events) / 1e3
    events.sort(key=lambda ev: -self_device_us(ev))
    host = sorted((ev for ev in averages if ev.device_type == DeviceType.CPU),
                  key=lambda ev: -ev.self_cpu_time_total)
    waits = {ev.key: ev.count for ev in host if ev.key in _WAITS}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{tag}_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
        f.write(averages.table(sort_by="self_cpu_time_total", row_limit=40))
    print(f"{tag} profile, {epochs} epoch(s) in one chunk: wall {wall_ms:.1f} ms "
          f"(profiled), device busy {device_ms:.1f} ms in "
          f"{sum(ev.count for ev in events)} device calls "
          f"({100 * (1 - device_ms / wall_ms):.1f}% idle); host calls that wait for "
          f"the device, the closing synchronize included: {waits}", flush=True)
    for i, ev in enumerate(events):
        if i < 14 or any(name in ev.key for name in also):
            print(f"  {self_device_us(ev) / 1e3:9.3f} ms  {ev.count:4d}x  {ev.key[:90]}")
    print(f"  host, self CPU time (profiled) {sum(ev.self_cpu_time_total for ev in host) / 1e3:.1f}"
          " ms, the largest: " + ", ".join(f"{ev.key} {ev.self_cpu_time_total / 1e3:.1f} ms "
                                          f"{ev.count}x" for ev in host[:8]), flush=True)
    return device_ms


def _steady_ms(chunk, epochs):
    """Host clock around ``chunk()`` (``epochs`` warm epochs ending in a host
    copy), per epoch, without the profiler."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    chunk()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / epochs


def phase_teacher_profile(ds):
    """One epoch of each teacher at arxiv shape under torch.profiler (the
    flagship ``--no-attn-dst`` on the hub path, then attn-dst on the edge
    softmax), and the steady epoch time of each over three more."""
    from efficient_gnns_tpu_torch.train import GATTeacherTrainer

    for tag, no_attn_dst, also in (
            ("teacher", True, ("split_segment_sum", "split_reduce")),
            ("teacher_attn_dst", False, ("thin_reduce", "tile_rows_thin", "split_sddmm"))):
        cfg = _teacher_config(no_attn_dst, input_drop=0.25, edge_drop=0.3)
        trainer = GATTeacherTrainer(cfg, ds.graph, ds.x, ds.y, ds.split_idx,
                                    ds.num_classes, device=DEVICE)
        best, _ = trainer.run_epochs(1, 1)  # warm-up
        _profile(tag, lambda: trainer.run_epochs(2, 1, best), 1, also=also)
        ms = _steady_ms(lambda: trainer.run_epochs(3, 3, best), 3)
        print(f"{tag} steady epoch (3 warm epochs, one chunk, host clock): {ms:.2f} ms",
              flush=True)
        del trainer, best


def phase_student_profile(ds):
    """A chunk of five GCN ``supervised`` epochs at arxiv shape (2 x 256, the
    CLI's defaults) under torch.profiler, and the steady epoch time over
    twenty more."""
    from efficient_gnns_tpu_torch.models import GCN
    from efficient_gnns_tpu_torch.train import DistillConfig, NodeDistillTrainer

    model = GCN(ds.x.shape[1], 256, ds.num_classes, 2, dropout=0.5, seed=0, device=DEVICE)
    trainer = NodeDistillTrainer(model, DistillConfig(hidden=256, num_layers=2), ds.graph,
                                 ds.x, ds.y, ds.split_idx, device=DEVICE)
    trainer.run_epochs(1, 2)  # warm-up
    _profile("student", lambda: trainer.run_epochs(3, 5), 5)
    ms = _steady_ms(lambda: trainer.run_epochs(8, 20), 20)
    print(f"student gcn supervised steady epoch (20 warm epochs, one chunk, host "
          f"clock): {ms:.2f} ms", flush=True)



def phase_sign_reference():
    """The SIGN trainer on the card against the same trainer on the CPU, same
    start, dropout 0, 3 epochs of batches of 512 over 1,620 train rows (the
    last batch padded): ``supervised``, and ``nce`` composed with logit KD
    with ``max_samples`` at the batch rows (no row subset, whose draws differ
    between the devices' generators). The hop features (R = 3) on the card
    against the CPU's first, each entry within 1e-5 of its sum of |terms|
    (the same hops over ``|x|``: the weights are positive), so that a late
    hop's small entries are held as tightly as the first's."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.cli.arxiv import oracle_teacher_logits
    from efficient_gnns_tpu_torch.cli.sign import oracle_teacher_prototypes
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.sampling import neighbor_average_features
    from efficient_gnns_tpu_torch.train import DistillConfig, SIGNTrainer

    ds = synthetic_node_dataset(num_nodes=3000, num_edges=15000, seed=5)
    x = torch.from_numpy(ds.x)
    feats = neighbor_average_features(ds.graph, x, 3)
    card = neighbor_average_features(ds.graph.to(DEVICE), x.to(DEVICE), 3)
    terms = neighbor_average_features(ds.graph, x.abs(), 3)
    hop_err = max(float((c.cpu() - f).abs().max()) for c, f in zip(card, feats))
    # the largest error of each hop over its limit; 1 or less passes
    hop_ratio = max(float(((c.cpu() - f).abs() / (1e-5 * t).clamp_min(1e-30)).max())
                    for c, f, t in zip(card, feats, terms))
    failures = []
    if not hop_ratio <= 1:  # NaN fails too
        failures.append("SIGN hop features on the card disagree with the CPU")
    teacher = dict(teacher_feat=oracle_teacher_prototypes(ds.y, ds.num_classes),
                   teacher_logits=oracle_teacher_logits(ds.y, ds.num_classes))
    for tag, cfg in (("supervised", {}),
                     ("nce+kd", dict(training="nce", kd_and_aux=True, beta=0.1,
                                     max_samples=512, proj_dim=32))):
        hist = {}
        for device in ("cpu", DEVICE):
            trainer = SIGNTrainer(DistillConfig(hidden=64, dropout=0.0, lr=0.001, **cfg),
                                  feats, ds.y, ds.split_idx, ds.num_classes, batch_size=512,
                                  eval_batch_size=1024, device=device, **teacher)
            hist[device] = np.array([trainer.train_epoch(e)["loss"] for e in (1, 2, 3)])
        got, want = hist[DEVICE], hist["cpu"]
        print(f"sign reference {tag}: cuda vs cpu trainer, 3 epochs, losses {got.tolist()} "
              f"max_abs_err={float(np.abs(got - want).max()):.3e}; hop features "
              f"max_abs_err={hop_err:.3e}, worst error / (1e-5 sum|terms|) "
              f"{hop_ratio:.3e}", flush=True)
        if not (np.isfinite(got).all() and np.allclose(got, want, rtol=1e-4, atol=1e-6)):
            failures.append(f"sign reference {tag}: the card's losses disagree with the CPU")
    return failures


def _sign_run(expt, training, extra):
    """One run of the SIGN CLI at arxiv shape with every kernel's counter read
    around it; returns (K1 launches, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import sign

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    summary = sign.main(SIGN + ["--training", training, *extra, "--device", DEVICE,
                                "--out_dir", OUT_DIR, "--expt_name", expt])
    launches = {k: c.launches for k, c in counters.items()}
    run = summary["runs"][0]
    epochs = len(run["losses"])
    print(f"sign slice {expt} {training}: launches {launches} (expected K1 {SIGN_HOPS}, "
          f"no other) hop precompute {summary['precompute_seconds'] * 1e3:.2f} ms "
          f"mean epoch (train batches, one evaluation in {epochs}) "
          f"{run['seconds'] / epochs * 1e3:.1f} ms final test {run['final_test']:.4f} "
          f"losses {[round(v, 4) for v in run['losses']]}", flush=True)
    failures = []
    if launches != {**{k: 0 for k in counters}, "K1": SIGN_HOPS}:
        failures.append(f"sign {training}: launches {launches}")
    losses = run["losses"]
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        failures.append(f"sign {training}: losses not finite and falling")
    return launches["K1"], failures


def phase_sign_slice(ds):
    """The hop precompute's steady device time on the arxiv-shaped graph (the
    SIGN CLI's: the edges are drawn first, whatever the signal), beside one
    K1 launch at F=128 and its bound; then the SIGN CLI at arxiv shape and
    full width: ``kd`` from the flagship teacher's dump (the oracle teacher
    when that phase did not run), then ``nce`` with ``--kd_and_aux`` at the
    ``sign-aux/nce`` grid point. Returns (K1 launches, failures)."""
    import torch

    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
    from efficient_gnns_tpu_torch.sampling import neighbor_average_features

    g = ds.graph.to(DEVICE)
    x = torch.from_numpy(ds.x).to(DEVICE)
    neighbor_average_features(g, x, SIGN_HOPS)  # the one-time split check
    hops_ms = _time_ms(lambda: neighbor_average_features(g, x, SIGN_HOPS), 10)
    k1_ms = _time_ms(lambda: csr_segment_sum(x, g.senders, g.row_offsets, g.edge_weight,
                                             g.row_split), 20)
    n, e, f = g.num_nodes, g.n_edge, x.shape[1]
    # a hop: K1 (x read, out written, indices and weights) + the division
    # (out read, written)
    bound_ms = SIGN_HOPS * (4 * n * f * 4 + e * 8 + (n + 1) * 4) / HBM_BYTES_PER_S * 1e3
    print(f"sign hop precompute (R={SIGN_HOPS}, F={f}, steady, CUDA events): {hops_ms:.4f} ms; "
          f"one K1 launch {k1_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes)", flush=True)
    del g, x
    teacher = (["--teacher_dir", TEACHER_DUMP]
               if os.path.exists(os.path.join(TEACHER_DUMP, "teacher_seed0.npz")) else [])
    print(f"sign slice teacher: {'the flagship dump' if teacher else 'the oracle'}", flush=True)
    launches, failures = 0, []
    for training, extra in (("kd", []), ("nce", SIGN_AUX_NCE)):
        n, fails = _sign_run("chip_smoke_sign", training, extra + teacher)
        launches, failures = launches + n, failures + fails
    return launches, failures


def _metrics(expt):
    with open(os.path.join(OUT_DIR, expt, "gcn-supervised", "seed0", "metrics.jsonl")) as f:
        return {r["step"]: r["loss/train"] for r in map(json.loads, f)}


def phase_checkpoint(ds):
    """``cli.arxiv`` trains the GCN student at arxiv shape 6 epochs unbroken,
    and 3 epochs with ``--checkpoint_every 3`` then ``--resume`` to 6 (K1
    counted: 6 an epoch); epochs 4-6 must give the same losses. The save and
    restore of a trainer's checkpoint timed on the host clock. Then the
    teacher CLI's ``--save-pred`` at a small size: its best-validation
    checkpoint loaded into a fresh teacher must give its dump's logits.
    Returns (K1 launches, failures)."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.cli import arxiv, gat_teacher
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset
    from efficient_gnns_tpu_torch.distill import load_teacher_dump
    from efficient_gnns_tpu_torch.models import GCN
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
    from efficient_gnns_tpu_torch.train import (
        DistillConfig,
        GATTeacherTrainer,
        NodeDistillTrainer,
        TeacherConfig,
    )
    from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint

    base = ARXIV + ["--gnn", "gcn", "--training", "supervised", "--runs", "1", "--log_steps",
                    "3", "--epoch_chunk", "3", "--device", DEVICE, "--out_dir", OUT_DIR]
    csr_segment_sum.launches = 0
    for argv in (["--expt_name", "chip_smoke_ck_a", "--epochs", "6"],
                 ["--expt_name", "chip_smoke_ck_b", "--epochs", "3", "--checkpoint_every", "3"],
                 ["--expt_name", "chip_smoke_ck_b", "--epochs", "6", "--checkpoint_every", "3",
                  "--resume"]):
        arxiv.main(base + argv)
    launches = csr_segment_sum.launches
    unbroken, resumed = _metrics("chip_smoke_ck_a"), _metrics("chip_smoke_ck_b")
    got = np.array([resumed[e] for e in (4, 5, 6)])
    want = np.array([unbroken[e] for e in (4, 5, 6)])
    err = float(np.abs(got - want).max())
    print(f"checkpoint: GCN supervised epochs 4-6 unbroken {want.tolist()} resumed "
          f"{got.tolist()} max_abs_diff={err:.3e} bitwise {'equal' if err == 0 else 'DIFFER'}; "
          f"K1 launches {launches} (expected {6 * 12})", flush=True)
    failures = []
    if not np.allclose(got, want, rtol=1e-5, atol=0) or sorted(resumed) != list(range(1, 7)):
        failures.append("checkpoint: the resumed run's losses differ from the unbroken run's")
    if launches != 6 * 12:
        failures.append(f"checkpoint: {launches} K1 launches")

    model = GCN(ds.x.shape[1], 256, ds.num_classes, 2, seed=0, device=DEVICE)
    trainer = NodeDistillTrainer(model, DistillConfig(hidden=256), ds.graph, ds.x, ds.y,
                                 ds.split_idx, device=DEVICE)
    trainer.run_epochs(1, 1)
    path = os.path.join(OUT_DIR, "chip_smoke_ck_timing", "checkpoint.pt")
    t0 = time.perf_counter()
    trainer.save_checkpoint(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.restore_checkpoint(path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    print(f"checkpoint of the 2 x 256 GCN student: {os.path.getsize(path)} bytes, save "
          f"{save_ms:.2f} ms, restore {load_ms:.2f} ms (host clock)", flush=True)
    shutil.rmtree(os.path.dirname(path))

    dump_dir, ckpt_dir = (os.path.join(OUT_DIR, d, "chip_smoke_ck_teacher")
                          for d in ("teacher_dumps", "checkpoints"))
    try:
        gat_teacher.main(["--num-nodes", "3000", "--num-edges", "15000", "--n-hidden", "32",
                          "--n-epochs", "3", "--n-runs", "1", "--seed", "2", "--use-labels",
                          "--n-label-iters", "1", "--save-pred", "--expt-name",
                          "chip_smoke_ck_teacher", "--out-dir", OUT_DIR, "--device", DEVICE])
        state = load_checkpoint(os.path.join(ckpt_dir, "2.pt"), map_location=DEVICE)
        _, logits = load_teacher_dump(dump_dir, 2)
        small = synthetic_node_dataset(num_nodes=3000, num_edges=15000, seed=42,
                                       hub_dense="auto", gcn_norm=False)
        fresh = GATTeacherTrainer(
            TeacherConfig(n_hidden=32, use_labels=True, n_label_iters=1, no_attn_dst=False,
                          use_norm=False),
            small.graph, small.x, small.y, small.split_idx, small.num_classes, seed=9,
            device=DEVICE)
        fresh.model.load_state_dict(state)
        again = fresh.evaluate()[0].cpu().numpy()
        err = float(np.abs(again - logits).max())
        print(f"teacher checkpoint: a fresh teacher from 2.pt gives the dump's logits "
              f"{logits.shape}, max_abs_err={err:.3e}", flush=True)
        if not np.allclose(again, logits, rtol=1e-5, atol=1e-5):
            failures.append("teacher checkpoint does not reproduce its dump")
    finally:  # nothing of the small teacher is kept among the run's outputs
        for d in (dump_dir, ckpt_dir):
            shutil.rmtree(d, ignore_errors=True)
    return launches, failures


def _write_csv_gz(path, arr, fmt):
    import gzip

    import numpy as np

    with gzip.open(path, "wt", compresslevel=1) as f:
        np.savetxt(f, arr, fmt=fmt, delimiter=",")


def phase_ogbn_cache(ds):
    """The arxiv-shaped dataset written as an ogbn-arxiv raw cache (gzip level
    1) and read back by ``data/ogb.py``: the graph must equal the one built
    from the same edges, the features the written ones; then the GCN student
    trains 3 epochs on it through ``cli.arxiv --dataset ogbn-arxiv`` (K1
    counted: 6 an epoch). Returns (K1 launches, failures)."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.cli import arxiv
    from efficient_gnns_tpu_torch.data import load_ogbn_arxiv
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum

    root = os.path.join(OUT_DIR, "ogbn_cache")
    raw = os.path.join(root, "ogbn_arxiv", "raw")
    split = os.path.join(root, "ogbn_arxiv", "split", "time")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(split, exist_ok=True)
    failures = []
    try:
        t0 = time.perf_counter()
        _write_csv_gz(os.path.join(raw, "edge.csv.gz"),
                      np.stack([ds.senders, ds.receivers], 1), "%d")
        _write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), ds.x, "%.6f")
        _write_csv_gz(os.path.join(raw, "node-label.csv.gz"), ds.y[:, None], "%d")
        for k, v in ds.split_idx.items():
            _write_csv_gz(os.path.join(split, f"{k}.csv.gz"), v[:, None], "%d")
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        t0 = time.perf_counter()
        got = load_ogbn_arxiv(root=root)
        load_s = time.perf_counter() - t0
        print(f"ogbn cache: {len(ds.senders)} edges, x {ds.x.shape}, {size} bytes; write "
              f"{write_s:.1f} s (gzip level 1), load {load_s:.1f} s (gzip + np.loadtxt, "
              f"graph build included)", flush=True)
        same = [name for name in ("senders", "receivers", "t_senders", "t_receivers",
                                  "csc_perm", "row_offsets", "t_row_offsets", "edge_weight")
                if torch.equal(getattr(got.graph, name), getattr(ds.graph, name))]
        if len(same) != 8 or got.graph.n_edge != ds.graph.n_edge:
            failures.append(f"ogbn cache: graph differs from build_graph's (equal: {same})")
        x_err = float(np.abs(got.x - ds.x).max())
        if x_err > 1e-6 or not np.array_equal(got.y, ds.y) or any(
                not np.array_equal(got.split_idx[k], v) for k, v in ds.split_idx.items()):
            failures.append(f"ogbn cache: x (max err {x_err:.2e}), y or splits differ")
        print(f"ogbn cache: graph arrays equal to build_graph's: {len(same)}/8; x within "
              f"{x_err:.2e} of the written values", flush=True)
        del got
        csr_segment_sum.launches = 0
        summary = arxiv.main(["--dataset", "ogbn-arxiv", "--data_root", root, "--gnn", "gcn",
                              "--training", "supervised", "--hidden_channels", "256",
                              "--epochs", "3", "--runs", "1", "--log_steps", "3",
                              "--device", DEVICE, "--out_dir", OUT_DIR, "--expt_name",
                              "chip_smoke_ogbn"])
        launches = csr_segment_sum.launches
        run = summary["runs"][0]
        print(f"ogbn cache: GCN supervised 3 epochs, K1 launches {launches} (expected 18), "
              f"mean epoch {run['seconds'] / 3 * 1e3:.1f} ms, final test "
              f"{run['final_test']:.4f}", flush=True)
        if launches != 18:
            failures.append(f"ogbn cache: {launches} K1 launches")
    finally:  # about 0.1 GB: too large to keep among the run's outputs
        shutil.rmtree(root)
    return launches, failures


def phase_sign_profile(ds):
    """One SIGN ``kd`` epoch (the oracle teacher) at arxiv shape and full
    width under torch.profiler, then the steady time of three more epochs
    (train batches only) and of one evaluation over every node."""
    import torch

    from efficient_gnns_tpu_torch.cli.arxiv import oracle_teacher_logits
    from efficient_gnns_tpu_torch.sampling import neighbor_average_features
    from efficient_gnns_tpu_torch.train import DistillConfig, SIGNTrainer

    feats = neighbor_average_features(ds.graph.to(DEVICE), torch.from_numpy(ds.x).to(DEVICE),
                                      SIGN_HOPS)
    trainer = SIGNTrainer(DistillConfig(training="kd", hidden=512, lr=0.001), feats, ds.y,
                          ds.split_idx, ds.num_classes,
                          teacher_logits=oracle_teacher_logits(ds.y, ds.num_classes),
                          device=DEVICE)
    trainer.train_epoch(1)  # warm-up
    _profile("sign", lambda: trainer.train_epoch(2), 1)
    ms = _steady_ms(lambda: [trainer.train_epoch(e) for e in (3, 4, 5)], 3)
    eval_ms = _steady_ms(trainer.evaluate, 1)
    print(f"sign kd steady epoch (2 train batches of 50,000, 3 warm epochs, host clock): "
          f"{ms:.2f} ms; one evaluation (2 batches of 100,000): {eval_ms:.2f} ms", flush=True)


# the PPI workload (ppi_pyg/gnn.py:305-310): 20 train, 2 valid and 2 test
# graphs of 591-3,480 nodes, about 28 edges a node both ways, 50 features,
# 121 labels; every graph padded to 3,584 nodes and 101,376 edges
PPI_SHAPE = dict(n_train=20, n_valid=2, n_test=2, min_nodes=591, max_nodes=3480, avg_deg=14)
# TeacherNet's hidden layers and its last layer, StudentNet's hidden and last
PPI_HEADS = ((4, 256), (6, 121), (2, 68), (2, 121))
PPI_EPOCHS = 3
PPI_NCE = ["--beta", "0.1", "--nce_T", "0.075", "--max_samples", "16384", "--proj_dim",
           "256"]  # experiments/ppi.json, the nce grid point
PPI_ROOT = os.path.join(OUT_DIR, "ppi_cache")


def _ppi_launches(student_convs, teacher_convs=0, n_train=20, n_eval=24):
    """Kernel launches of one PPI epoch, from the code: each ``gat_attention``
    forward launches K7 (er), K6, K7 (max), K5, K7 (1 / sum), K2; each
    backward K4, K5, K7, K5 (der), K5 (del), K2. A train step runs the
    student's convs forward and backward and the teacher's forward; the
    evaluation forwards every graph once."""
    fwd = n_train * (student_convs + teacher_convs) + n_eval * student_convs
    bwd = n_train * student_convs
    return {"K1": 0, "K2": fwd + bwd, "K3": 0, "K4": bwd, "K5": fwd + 3 * bwd,
            "K6": fwd, "K7": 3 * fwd + bwd}


def phase_ppi_kernels(ds):
    """K2 and K4-K7 against their plain versions on the largest PPI graph
    (no row above the split threshold: both row splits empty), forward and
    transpose CSR, at the PPI models' (H, D) pairs, with the records of
    ``phase_attention_kernels``."""
    graph = max(ds.train + ds.valid + ds.test, key=lambda g: g.graph.n_edge).graph
    splits = (graph.row_split, graph.t_row_split)
    deg = (graph.row_offsets[1:] - graph.row_offsets[:-1]).max()
    print(f"ppi kernels graph: N={graph.num_nodes} (padded) E={graph.n_edge} "
          f"E_pad={graph.num_edges_padded} max row degree={int(deg)} long rows "
          f"{[sp.num_long for sp in splits]} chunks {[sp.num_chunks for sp in splits]}",
          flush=True)
    failures = []
    if any(sp.num_long or sp.num_chunks for sp in splits):
        failures.append("ppi kernels: the largest PPI graph has long rows")
    records, fails = phase_attention_kernels(graph, PPI_HEADS, " ppi")
    return records, failures + fails


def phase_ppi_reference():
    """``PPITrainer`` on the card against the same trainer on the CPU (which
    the tests hold against the JAX package), same start, 3 epochs on small
    PPI-shaped graphs: ``supervised``, ``kd``, ``nce`` and ``lpw`` composed
    with logit KD, ``max_samples`` at the padded rows (no row subset, whose
    draws differ between the devices' generators). Per-epoch losses to the
    ``reference`` phase's tolerance."""
    import numpy as np

    from efficient_gnns_tpu_torch.data import synthetic_ppi_dataset
    from efficient_gnns_tpu_torch.models import PPIGAT
    from efficient_gnns_tpu_torch.train import DistillConfig, PPITrainer

    ds = synthetic_ppi_dataset(n_train=4, n_valid=1, n_test=1, min_nodes=300, max_nodes=600,
                               avg_deg=14, seed=5)
    n_pad = ds.train[0].graph.num_nodes
    failures = []
    for tag, cfg in (("supervised", {}), ("kd", dict(training="kd")),
                     ("nce", dict(training="nce", beta=0.1, proj_dim=32)),
                     ("lpw+kd", dict(training="lpw", kd_and_aux=True))):
        hist, f1 = {}, {}
        for device in ("cpu", DEVICE):
            teacher = PPIGAT(ds.feat_dim, 16, ds.num_labels, 3, heads=4, final_heads=6,
                             seed=1, device=device)
            student = PPIGAT(ds.feat_dim, 8, ds.num_labels, 3, heads=2, seed=0, device=device)
            trainer = PPITrainer(
                DistillConfig(**{"lr": 0.005, "alpha": 0.5, "kd_T": 1.0, "beta": 100.0,
                                 "max_samples": n_pad, **cfg}),
                ds, student, teacher=teacher, teacher_feat_dim=64, seed=0, device=device)
            hist[device] = np.array([[m["loss"], m["loss_cls"], m["loss_aux"]] for m in (
                trainer.train_epoch(e) for e in (1, 2, 3))])
            f1[device] = trainer.evaluate_all()
        got, want = hist[DEVICE], hist["cpu"]
        print(f"ppi reference {tag}: cuda vs cpu trainer, 3 epochs, losses "
              f"{got[:, 0].tolist()} max_abs_err={float(np.abs(got - want).max()):.3e}; "
              f"micro-F1 cuda {f1[DEVICE]} cpu {f1['cpu']}", flush=True)
        if not (np.isfinite(got).all() and np.allclose(got, want, rtol=1e-4, atol=1e-6)):
            failures.append(f"ppi reference {tag}: the card's losses disagree with the CPU")
    return failures


def _write_ppi_cache(root, ds):
    """``ds`` as the torch-geometric raw files: per split, node-link JSON
    whose ``links`` hold each undirected edge once (the built graph's edges
    with sender < receiver: the loader adds the reverse and the self loops),
    the features and labels of the real nodes, and each node's graph id."""
    import numpy as np

    os.makedirs(root, exist_ok=True)
    for split in ("train", "valid", "test"):
        links, feats, labels, gid, start = [], [], [], [], 0
        for k, g in enumerate(getattr(ds, split)):
            e = g.graph.n_edge
            s = g.graph.senders[:e].numpy().astype(np.int64)
            r = g.graph.receivers[:e].numpy().astype(np.int64)
            links.append(np.stack([s[s < r], r[s < r]], 1) + start)
            feats.append(g.x[:g.num_nodes])
            labels.append(g.y[:g.num_nodes])
            gid.append(np.full(g.num_nodes, k + 1, np.int64))
            start += g.num_nodes
        with open(os.path.join(root, f"{split}_graph.json"), "w") as f:
            json.dump({"directed": False, "multigraph": False, "graph": {},
                       "nodes": [{"id": i} for i in range(start)],
                       "links": [{"source": a, "target": b}
                                 for a, b in np.concatenate(links).tolist()]}, f)
        for part, arr in (("feats", feats), ("labels", labels), ("graph_id", gid)):
            np.save(os.path.join(root, f"{split}_{part}.npy"), np.concatenate(arr))


def _ppi_run(tag, argv, expected):
    """One run of the PPI CLI on the raw cache, every kernel's counter read
    around it; returns (launches by kernel, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import ppi

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    summary = ppi.main(["--dataset", "ppi", "--data_root", PPI_ROOT, "--epochs",
                        str(PPI_EPOCHS), "--runs", "1", "--out_dir", OUT_DIR, "--expt_name",
                        "chip_smoke_ppi", "--device", DEVICE, *argv])
    launches = {k: c.launches for k, c in counters.items()}
    run = summary["runs"][0]
    want = {k: v * PPI_EPOCHS for k, v in expected.items()}
    print(f"ppi slice {tag}: launches {launches} (expected {want}) mean epoch (20 steps "
          f"and 24 evaluation forwards) {run['seconds'] / PPI_EPOCHS * 1e3:.1f} ms; "
          f"micro-F1 train/valid/test by epoch "
          f"{[[round(v, 4) for v in f1] for f1 in run['f1']]}; losses "
          f"{[round(v, 4) for v in run['losses']]}", flush=True)
    failures = []
    if launches != want:
        failures.append(f"ppi slice {tag}: launches {launches}")
    if not all(math.isfinite(v) for v in run["losses"]):
        failures.append(f"ppi slice {tag}: losses not finite")
    return launches, failures


def phase_ppi_slice(ds):
    """The PPI-shaped data written as the torch-geometric raw files and read
    back by ``data/ppi.py`` (each graph's real edges, features and labels
    equal to the written ones); then ``cli.ppi`` on that cache at the full
    width of the reference's nets: TeacherNet with ``--train_teacher``, then
    StudentNet in ``kd`` and in ``nce --kd_and_aux`` (the ``experiments/
    ppi.json`` nce grid point) from its checkpoint; cut in time only, 3 epochs
    and 1 run each. Every kernel counted around each run. The cache and the
    checkpoint are removed. Returns (launches by kernel, failures)."""
    import numpy as np

    from efficient_gnns_tpu_torch.cli.ppi import teacher_checkpoint_path
    from efficient_gnns_tpu_torch.data import load_ppi

    failures = []
    launches = {k: 0 for k in _counters()}
    try:
        t0 = time.perf_counter()
        _write_ppi_cache(PPI_ROOT, ds)
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(PPI_ROOT, f)) for f in os.listdir(PPI_ROOT))
        t0 = time.perf_counter()
        got = load_ppi(PPI_ROOT)
        load_s = time.perf_counter() - t0
        same = all(
            a.num_nodes == b.num_nodes and a.graph.n_edge == b.graph.n_edge
            and np.array_equal(a.x[:a.num_nodes], b.x[:b.num_nodes])
            and np.array_equal(a.y[:a.num_nodes], b.y[:b.num_nodes])
            and all(np.array_equal(getattr(a.graph, k)[:a.graph.n_edge].numpy(),
                                   getattr(b.graph, k)[:b.graph.n_edge].numpy())
                    for k in ("senders", "receivers", "t_senders", "t_receivers"))
            for split in ("train", "valid", "test")
            for a, b in zip(getattr(got, split), getattr(ds, split)))
        g0 = got.train[0].graph
        print(f"ppi cache: {size} bytes, write {write_s:.1f} s, load with the graph builds "
              f"{load_s:.1f} s; padded to {g0.num_nodes} nodes, {g0.num_edges_padded} edges; "
              f"real edges, features and labels equal to the written ones: {same}",
              flush=True)
        if not same:
            failures.append("ppi cache: the loaded graphs differ from the written ones")
        del got
        student = _ppi_launches(5, 3)
        for tag, argv, expected in (
                ("teacher", ["--train_teacher"], _ppi_launches(3)),
                ("student kd", ["--training", "kd"], student),
                ("student nce --kd_and_aux", ["--training", "nce", "--kd_and_aux", *PPI_NCE],
                 student)):
            if tag != "teacher":
                argv += ["--teacher_path", os.path.join(OUT_DIR, "ppi_teacher",
                                                        "chip_smoke_ppi")]
            more, fails = _ppi_run(tag, argv, expected)
            launches = {k: v + more[k] for k, v in launches.items()}
            failures += fails
            if tag == "teacher" and not os.path.exists(
                    teacher_checkpoint_path(OUT_DIR, "chip_smoke_ppi", 0)):
                failures.append("ppi slice: no teacher checkpoint")
                break
    finally:  # about 0.1 GB of cache and a 12 MB checkpoint: not kept
        for d in (PPI_ROOT, os.path.join(OUT_DIR, "ppi_teacher")):
            shutil.rmtree(d, ignore_errors=True)
    return launches, failures


def phase_ppi_profile(ds):
    """TeacherNet (``supervised``) and StudentNet in ``kd`` (a TeacherNet of
    random weights online) at the PPI shape: after a warm-up epoch and
    evaluation, the steady time of three train epochs and of one evaluation
    of the 24 graphs (host clock), then one train epoch under torch.profiler
    with the port-kernel launches it makes, then three train epochs again
    (what the profiler leaves behind). The idle share is taken against the
    steady epoch, which the profiler does not slow."""
    from efficient_gnns_tpu_torch.models import ppi_student, ppi_teacher
    from efficient_gnns_tpu_torch.train import DistillConfig, PPITrainer

    counters = _counters()
    trainers = {}
    for tag, training, student in (("ppi_teacher", "supervised", False),
                                   ("ppi_student_kd", "kd", True)):
        model = (ppi_student if student else ppi_teacher)(ds.feat_dim, ds.num_labels,
                                                           device=DEVICE)
        teacher = ppi_teacher(ds.feat_dim, ds.num_labels, seed=1, device=DEVICE)
        trainer = PPITrainer(DistillConfig(training=training, lr=0.005, alpha=0.5, kd_T=1.0),
                             ds, model, teacher=teacher, device=DEVICE)
        trainer.train_epoch(1)  # warm-up: the first use of each graph checks its splits
        trainer.evaluate_all()
        ms = _steady_ms(lambda: [trainer.train_epoch(e) for e in (2, 3, 4)], 3)
        eval_ms = _steady_ms(trainer.evaluate_all, 1)
        trainers[tag] = trainer, ms
        print(f"{tag} steady train epoch (20 steps, 3 warm epochs, host clock, before any "
              f"PPI profile): {ms:.2f} ms; one evaluation of the 24 graphs: {eval_ms:.2f} ms",
              flush=True)
    for tag, (trainer, ms) in trainers.items():
        for c in counters.values():
            c.launches = 0
        busy = _profile(tag, lambda: trainer.train_epoch(5), 1,
                        also=("split_segment_sum", "thin_reduce", "tile_rows_thin",
                              "split_sddmm"))
        print(f"{tag}: port-kernel launches in the profiled train epoch "
              f"{ {k: c.launches for k, c in counters.items()} }; device busy {busy:.1f} ms "
              f"of the steady {ms:.2f} ms epoch: {100 * (1 - busy / ms):.1f}% idle", flush=True)
        after = _steady_ms(lambda: [trainer.train_epoch(e) for e in (6, 7, 8)], 3)
        print(f"{tag} steady train epoch after the profile: {after:.2f} ms", flush=True)
    del trainers


PHASES = ("k1", "attention_kernels", "k3", "split_edges", "threshold_sweep",
          "thin_group_sweep", "reference", "teacher_reference", "hub_attention",
          "sign_reference", "slice", "teacher_slice", "sign_slice", "checkpoint",
          "ogbn_cache", "runtime_spmm", "teacher_profile", "student_profile", "sign_profile",
          "ppi_kernels", "ppi_reference", "ppi_slice", "ppi_profile")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="",
                        help="comma-separated phases to run alone, of " + ", ".join(PHASES)
                        + " (device and build always run); default: all")
    only = [p for p in parser.parse_args(argv).only.split(",") if p]
    if any(p not in PHASES for p in only):
        parser.error(f"--only takes {', '.join(PHASES)}")
    chosen = set(only or PHASES)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the library yardsticks build sparse CSR tensors: one warning per call
    warnings.filterwarnings("ignore", message="Sparse (CSR tensor support|invariant checks)")

    from efficient_gnns_tpu_torch.data import synthetic_node_dataset

    failures = []

    def run(name, phase, *args):
        """Run one phase if chosen; report a raise and go on with the others."""
        if name not in chosen:
            return None
        try:
            return phase(*args)
        except Exception:  # report, then run the other phases
            traceback.print_exc()
            failures.append(f"{name} phase raised")
            return None

    smi = phase_device()
    phase_build()
    t0 = time.time()
    ds = synthetic_node_dataset(num_nodes=169343, num_edges=1166243, seed=42)
    print(f"arxiv-shaped dataset built in {time.time() - t0:.1f} s", flush=True)
    records = []
    for name, phase in (("k1", phase_k1), ("attention_kernels", phase_attention_kernels),
                        ("k3", phase_k3)):
        recs, fails = run(name, phase, ds.graph) or ([], [])
        records, failures = records + recs, failures + fails
    failures += run("split_edges", phase_split_edges) or []
    run("threshold_sweep", phase_threshold_sweep, ds.graph)
    failures += run("thin_group_sweep", phase_thin_group_sweep, ds.graph) or []
    if run("reference", phase_reference) is False:
        failures.append("cuda trainer disagrees with the cpu trainer")
    if run("teacher_reference", phase_teacher_reference) is False:
        failures.append("cuda teacher trainer disagrees with the cpu trainer")
    failures += run("hub_attention", phase_hub_attention) or []
    failures += run("sign_reference", phase_sign_reference) or []
    k1_launches, slice_failures = run("slice", phase_slice) or (0, [])
    try:
        launches, teacher_failures = run("teacher_slice", phase_teacher_slice) or ({}, [])
        sign_launches, sign_failures = run("sign_slice", phase_sign_slice, ds) or (0, [])
    finally:  # the teacher's dump is 0.5 GB: too large to keep among the run's outputs
        for name in ("teacher_dumps", "checkpoints"):
            shutil.rmtree(os.path.join(OUT_DIR, name), ignore_errors=True)
    ck_launches, ck_failures = run("checkpoint", phase_checkpoint, ds) or (0, [])
    ogbn_launches, ogbn_failures = run("ogbn_cache", phase_ogbn_cache, ds) or (0, [])
    rt_launches, rt_failures = run("runtime_spmm", phase_runtime_spmm, ds.graph) or ({}, [])
    failures += (slice_failures + teacher_failures + sign_failures + ck_failures
                 + ogbn_failures + rt_failures)
    failures += run("ppi_reference", phase_ppi_reference) or []
    ppi_launches = {}
    if chosen & {"ppi_kernels", "ppi_slice", "ppi_profile"}:
        from efficient_gnns_tpu_torch.data import synthetic_ppi_dataset

        t0 = time.time()
        ppi = synthetic_ppi_dataset(**PPI_SHAPE, seed=42)
        print(f"PPI-shaped dataset built in {time.time() - t0:.1f} s: "
              f"{sum(g.num_nodes for g in ppi.train)} train nodes, "
              f"{sum(g.graph.n_edge for g in ppi.train)} train edges", flush=True)
        recs, fails = run("ppi_kernels", phase_ppi_kernels, ppi) or ([], [])
        records, failures = records + recs, failures + fails
        ppi_launches, fails = run("ppi_slice", phase_ppi_slice, ppi) or ({}, [])
        failures += fails
        run("ppi_profile", phase_ppi_profile, ppi)
        del ppi
    run("student_profile", phase_student_profile, ds)
    run("sign_profile", phase_sign_profile, ds)
    if "teacher_profile" in chosen:
        # the teacher's graph, as its CLI builds it: unweighted, with the hub
        # partition that the flagship teacher's hub attention path needs
        del ds
        ds = synthetic_node_dataset(num_nodes=169343, num_edges=1166243, seed=42,
                                    gcn_norm=False)
        run("teacher_profile", phase_teacher_profile, ds)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches["K1"] = (k1_launches + launches.get("K1", 0) + rt_launches.get("K1", 0)
                      + sign_launches + ck_launches + ogbn_launches)
    launches["K3"] = launches.get("K3", 0) + rt_launches.get("K3", 0)
    for k, n in ppi_launches.items():
        launches[k] = launches.get(k, 0) + n
    for r in records:  # a shape that the paths never launch counts 0
        on_path = r.get("on_main_path", True)
        r["launches"] = launches.get(r["name"].split()[0], 0) if on_path else 0
    if not only and any(r["launches"] == 0 for r in records if r.get("on_main_path", True)):
        print("chip_smoke FAILED: a kernel of the main paths was never launched",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
