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
   row split (K4 also with chunks of 32 edges); each is also timed with the
   host's cost of a call hidden (``device alone``: K5-K7 take a few
   microseconds), beside an empty launch, and the host's time to queue one
   call of K1, K5, K7 and ``masked_batch_norm`` (the ``launch floor`` line);
7. small-input reference: the teacher trainer on the card against the same
   trainer on the CPU (dropouts 0, no label split), with attn-dst on the
   edge softmax and without it on the hub attention path; then
   ``hub_gat_attention`` on the card against the CPU on a graph of over
   200k edges with the hub partition, at the teacher's widths, with and without
   edge-drop (the same keep set on both devices; float32 and the bfloat16
   default hub messages), and the fused hub layer (``sqrt(deg_in)`` scale
   and residual) against the chain of PyTorch passes it replaces: the output,
   dfeat and dres the same bits; then (``hub_fused``) each of the layer's
   four fused passes against its plain version at arxiv N and the teacher's
   widths, with its time beside its byte bound;
8. the teacher slice: ``efficient_gnns_tpu_torch.cli.gat_teacher`` trains
   the 3 x 3 x 250 GAT teacher at arxiv shape with the flags of
   ``experiments/arxiv_hard.sh`` (``--no-attn-dst``: the hub attention path,
   K1 and the hub layer's fused passes) and dumps it, then the same teacher with attn-dst on (K2,
   K4-K7), with every kernel's launch counter read around each run; then
   ``cli.arxiv`` trains the GCN student from the flagship dump in ``kd``,
   ``nce`` (MLP projection heads, 8192 sampled rows) and ``gcd``
   (graph-conditioned heads) mode;
9. a profile of one SIGN epoch at arxiv shape (``torch.profiler``): device
   busy and idle share, the device time by kernel, the host calls that wait
   for the device, the tables written to ``OUT_DIR``; and the steady epoch
   time without the profiler (the teacher and the GCN students are the
   benchmark's cells, ``gnnbench/``);
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
13. small-input reference: the SIGN trainer on the card against the same
    trainer on the CPU (``supervised``, and ``nce`` composed with logit KD),
    and the card's hop features against the CPU's;
14. the SIGN slice: ``efficient_gnns_tpu_torch.cli.sign`` at arxiv shape and
    the reference's full width (R = 5 hops, 6 FFNs 128 -> 512 -> 512, batches
    of 50,000) in ``kd`` from the flagship teacher's dump, then ``nce`` with
    ``--kd_and_aux`` at the ``sign-aux/nce`` grid point, every kernel's
    counter read around each run (K1 once a hop, nothing else);
15. checkpoints: ``cli.arxiv`` trains the GCN student at arxiv shape 6
    epochs unbroken, and 3 epochs with ``--checkpoint_every 3`` then
    ``--resume`` to 6; epochs 4-6 must give the same losses; then
    ``cli.gat_teacher --save-pred`` at a small size, whose best-validation
    checkpoint must reproduce its dump's logits in a fresh teacher;
16. the OGB raw cache: the arxiv-shaped dataset written as an ogbn-arxiv
    ``csv.gz`` cache, read back by ``data/ogb.py`` (the graph equal to the
    one built from the same edges), and the GCN student trained 3 epochs on
    it through ``cli.arxiv --dataset ogbn-arxiv``;
17. small-input reference: the PPI trainer on the card against the same
    trainer on the CPU (``supervised``, ``kd``, ``nce``, ``lpw`` composed with
    logit KD);
18. K2 and K4-K7 against their plain versions on the largest graph of the
    PPI-shaped data (20 / 2 / 2 graphs of 591-3,480 nodes, padded to 3,584
    nodes and 101,376 edges; no long row, so both row splits are empty) at
    the PPI models' shapes (H x D = 4 x 256, 6 x 121, 2 x 68, 2 x 121), with
    the records of phase 6;
19. the PPI slice: that data written as the torch-geometric raw files and
    read back by ``data/ppi.py``, then ``efficient_gnns_tpu_torch.cli.ppi``
    trains TeacherNet (3 layers of 4 x 256, a 6-head mean) with
    ``--train_teacher`` and StudentNet (5 layers of 2 x 68) in ``kd`` and
    ``nce --kd_and_aux`` from its checkpoint, 3 epochs each, every kernel's
    counter read around each run;
20. a profile of one TeacherNet and one StudentNet ``kd`` train epoch at the
    PPI shape, with the steady epoch and evaluation times;
21. small-input reference: the MAG trainer on the card against the same
    trainer on the CPU (``supervised``, ``kd``, ``nce``, ``lpw``, each on the
    typed square layout and on the masked path) and its layer-wise logits;
22. the MAG slice: the synthetic ogbn-mag at ``MAG_CACHE_PAPERS`` papers
    written as ogbn-mag's raw cache and read back by ``data/mag.py``, then
    ``cli.mag`` trains the 3 x 512 R-GCN teacher (``--save_ckpt``,
    ``--time_steps``) and the 2 x 32 student from its checkpoint in ``kd``
    and ``nce --kd_and_aux``, 2 epochs of 30 GraphSAINT steps each, K1's
    launches checked against ``_mag_launches``; the checkpoint reloaded;
23. K1 at the MAG shapes on GraphSAINT samples of the full-shape synthetic
    ogbn-mag (1,939,743 nodes, 22,322,316 edges): the typed square graph
    forward into its node budget (``dst_rows``) and backward over its
    transpose at F = 512, 349 (teacher) and 32, 349 (student), the masked
    path's 0/1 weights at F = 128 and 1, one layer-wise chunk at F = 128 and
    512 (``... mag ...`` records), with one sample's host time by function;
24. the full-shape MAG epochs through ``MagTrainer``: the teacher and the
    student ``kd``, a steady epoch, the prefetch thread's host time a
    sample, one layer-wise evaluation, one profiled epoch (busy and idle
    share), the device-only step and the peak device memory;
25. small-input reference: ``MolGNN`` on the card against the same module
    on the CPU (GIN-E with the virtual node, GIN, GCN, PNA: forward,
    BatchNorm statistics, every gradient), ``MolTrainer`` on the card
    against the CPU (``supervised``, ``kd``, ``nce --kd_and_aux``, ``gpw``),
    and one train step of the 300 x 5 GIN-E and PNA taken twice from one
    state, which must give the same bits (no float atomics on the path);
26. K1 at the molhiv shapes on a packed batch of the full-count synthetic
    ogbg-molhiv (batch 32: 1,024 nodes, 3,072 edges; and batch 128): a
    conv's aggregation and the senders gather's backward at F = 300 and 64,
    the pool over the graphs at F = 300, against their plain versions and
    one PyTorch call each (``torch.segment_reduce``, ``index_add_``);
27. the molhiv slice: ``cli.mol`` on a quarter of ogbg-molhiv's train
    molecules (8,225) and its whole valid and test splits (4,113 each) trains the GIN-E teacher (300 x 5, virtual node) with
    its checkpoint, the GCN student (2 x 64) from it in ``kd`` and ``nce
    --kd_and_aux``, then the PNA teacher (300 x 5), ``MOL_EPOCHS`` each,
    K1's and the encoder kernels' launches checked against the model calls
    that ran in Python (``_mol_expected``: eager steps and graph captures);
28. the full-count set written as OGB's ogbg-molhiv raw cache, read back
    by ``data/molhiv.py`` (every molecule equal) and trained on one epoch
    through ``cli.mol --dataset ogbg-molhiv``;
29. a chunk of GIN-E teacher and GCN ``kd`` student steps through
    ``MolTrainer``: the steady step, the host's pack time a batch, an
    evaluation, and one profiled chunk (busy and idle share, top ops);
30. K2 and K4 reading bfloat16 messages against their plain versions at
    the teacher's arxiv shapes (H x D = 3 x 250 and 1 x 40, forward and
    transpose CSR), the same bits twice and without the split, with their
    times, bounds (the bfloat16 bytes), the plain versions' and the library
    calls' where cuSPARSE takes bfloat16 (``K2 bf16`` / ``K4 bf16`` records,
    their launches those of phase 31's bfloat16 run);
31. ``analysis/microbench.py``: ``gat-step --hub 0`` (every teacher layer on
    ``gat_attention``) train and eval at arxiv shape in float32 and in
    bfloat16 messages, every kernel's launches counted against
    ``GAT_STEP_LAUNCHES``, the first-step losses of the two dtypes within
    ``MICROBENCH_LOSS_RTOL``, the trace of the bfloat16 train step naming
    K2's and K4's bfloat16 kernels; ``microbench spmm`` at F = 128 with its
    bound; ``sddmm_dot`` forward (K3) and backward (K1 twice) on the card
    against the plain versions;
32. the multi-device layer (``efficient_gnns_tpu_torch/parallel``): the
    synthetic arxiv graph padded to 169,344 nodes and partitioned for D = 4
    (``halo_stats``); a world of one NCCL rank on cuda:0 holding
    ``spmm_sharded`` and ``spmm_halo`` forward and backward at F = 256 to the
    single-device ``ops.spmm`` (every entry within 1e-5 + 1e-5 * its sum of
    |terms|); ``parallel.dryrun`` at arxiv shape on a gloo world of 4 ranks,
    all on cuda:0 (NCCL refuses two ranks on one card): the data-parallel
    GCN-KD steps (2 x 256, ``kd``) and evaluation on a (2, 2) ``("data",
    "model")`` mesh and the SIGN dp x tp step (6 hops x 512, batch 50,000),
    each step's loss against the single-device loss (rtol 1e-5) and the
    replicated parameters the same bits on every rank, with each rank's
    exchange bytes and the SIGN step's collectives timed inside its last
    run; the halo GCN step
    against the single-device loss (rtol 1e-5), the exchange alone, both
    SpMMs at F = 256, ring NCE at 8,192 x 256, the two-level step (the flat
    step's bits) and the MAG step with sharded tables, each rank's K1
    launches checked against ``PARALLEL_LAUNCHES`` and its section times
    printed with the card's name and power limit; every distillation mode
    of the row-sharded trainer (``parallel.modes``: ``fitnet``, ``at``,
    ``gpw``, ``lpw``, ``nce``, ``gcd``, ``nce-labels``, ``nce-edges``,
    ``nce-labels-edges`` and ``nce --kd_and_aux``; 2 x 256 GCN, teacher
    features 750 wide, ``proj_dim`` 256, ``max_samples`` 8,192) on another
    gloo world of 4 on cuda:0, 2 steps each, every loss against the card's
    single device (rtol 1e-5), each rank's K1 launches checked against
    ``PARALLEL_MODE_LAUNCHES``, its ms and bytes a step printed; K1 on rank
    0's local and halo CSRs (of D = 4, and of the GCN-KD section's D = 2 at
    its F = 256 and 40) against its plain version and one cuSPARSE call,
    and at ``lpw``'s shapes on the train subgraph (its softmax sums at F = 1,
    its edge gathers' backward at F = 256) against its plain version and
    ``torch.segment_reduce`` / ``index_add_`` (``K1 parallel ...`` records);
33. OGB's atom and bond encoders' kernels (``categorical``) at the molhiv
    batch's shapes, 1,280 atoms over 9 tables and 4,096 bonds over 3, F =
    300: the forward against the chain of ``F.embedding`` and adds (the same
    bits), the backward against a float64 sum (within 1e-5 of each output's
    sum of |terms|), two launches the same bits, beside the chain and its
    autograd backward (``categorical fwd|bwd ...`` records).

``--only a,b`` runs the named phases alone (see ``main``). The last lines
are the kernels' JSON record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``; a failed phase exits non-zero before them.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import os
import pstats
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
# MaskedBatchNorm kernels of one student epoch (every BatchNorm here has more
# than 2,048 rows: the two-kernel path): the model's one BatchNorm a train
# forward, a backward and an eval forward; nce and gcd add the two heads'
# BatchNorms (91,445 train rows, or the whole graph), a forward and a backward each.
BN_PER_EPOCH = {"supervised": (1, 1), "kd": (1, 1), "nce": (3, 1), "gcd": (3, 1)}


def _bn_expected(train_fwd, eval_fwd, epochs):
    return {"bn_fused": 0, "bn_partials": train_fwd * epochs, "bn_apply": train_fwd * epochs,
            "bn_eval": eval_fwd * epochs, "bn_grad_fused": 0,
            "bn_grad_partials": train_fwd * epochs, "bn_grad_apply": train_fwd * epochs}
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
# Around each K1 launch the hub layer's fused passes: the messages and the
# epilogue a forward, the cotangent and the message gradient a backward.
# The two MaskedBatchNorms (N = 169,343: the two-kernel path): 2 train
# forwards (the step and its label-reuse run) and 2 eval forwards each, and
# one backward each.
TEACHER_BN_LAUNCHES = {"bn_fused": 0, "bn_partials": 4, "bn_apply": 4, "bn_eval": 4,
                       "bn_grad_fused": 0, "bn_grad_partials": 2, "bn_grad_apply": 2}
TEACHER_LAUNCHES = {"K1": 12 + 3, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0,
                    "hub_messages": 12, "hub_epilogue": 12, "hub_cotangent": 3,
                    "hub_message_grad": 3, **TEACHER_BN_LAUNCHES}
# attn-dst: forward K2 1, K5 1, K6 1, K7 3 (er, max, 1/sum); backward K2 1,
# K4 1, K5 3 (softmax VJP, der, del), K7 1
TEACHER_ATTN_DST_LAUNCHES = {"K1": 0, "K2": 12 + 3, "K3": 0, "K4": 3, "K5": 12 + 3 * 3,
                             "K6": 12, "K7": 12 * 3 + 3, "hub_messages": 0,
                             "hub_epilogue": 0, "hub_cotangent": 0, "hub_message_grad": 0,
                             **TEACHER_BN_LAUNCHES}
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


def _counters(*prefixes):
    """Launch counters from the registry of the counted wrappers
    (``ops/cuda/launch.py``: K1-K7 by number, the hub passes and the
    BatchNorm kernels by name), those whose labels start with ``prefixes``
    (``"K"``, ``"hub_"``, ``"bn_"``)."""
    from efficient_gnns_tpu_torch.ops.cuda import launch

    return {k: fn for k, fn in sorted(launch.COUNTED.items()) if k.startswith(prefixes)}


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
        item = x.element_size()
        for direction, src, ro, w, sp in (
            ("fwd", g.senders, g.row_offsets, keep if hub else g.edge_weight, g.row_split),
            ("bwd", g.t_senders, g.t_row_offsets, keep_t if hub else g.t_edge_weight,
             g.t_row_split),
        ):
            def library():  # one cuSPARSE call through torch.sparse
                a = torch.sparse_csr_tensor(ro, src[:e], w[:e].to(dtype), (n, n))
                return lambda: a @ x

            gathered = e * f * item + n * f * 4 + e * 8 + (n + 1) * 4
            rec, fails = _kernel_case(
                f"K1 csr_segment_sum {direction} F={f} {str(dtype)[6:]}" + (" hub" if hub else ""),
                lambda: csr_segment_sum(x, src, ro, w, sp),
                lambda: csr_segment_sum_plain(x, src, ro, w),
                tol_terms=lambda: csr_segment_sum_plain(x.abs(), src, ro, w.abs()),
                same={"two launches": lambda: csr_segment_sum(x, src, ro, w, sp),
                      "without split": lambda: csr_segment_sum(x, src, ro, w)},
                times=FIXED_REPS, library=(f"CSR matmul {dtype}", library),
                source="segment_sum.cu", replaces=PALLAS + "segment_matmul.py:162",
                shape={"N": n, "E": e, "F": f},
                n_bytes=n * f * item + n * f * 4 + e * 8 + (n + 1) * 4, n_ops=2 * e * f,
                note=f"gathered_bound_ms={gathered / HBM_BYTES_PER_S * 1e3:.4f}",
                # the input features carry no gradient: no backward at F=128
                on_main_path=hub or (dtype == torch.float32
                                     and not (f == 128 and direction == "bwd")),
                redesigned="row split")
            records.append(rec)
            failures += fails
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
    bn = _counters("bn_")
    for c in (csr_segment_sum, *bn.values()):
        c.launches = 0
    summary = arxiv.main(argv)
    n = csr_segment_sum.launches
    bn_launches = {k: c.launches for k, c in bn.items()}
    with open(os.path.join(OUT_DIR, expt, f"{gnn}-{training}", "seed0",
                           "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss/train"] for line in f][-EPOCHS:]
    expected = K1_PER_EPOCH[gnn, training] * EPOCHS
    bn_expected = _bn_expected(*BN_PER_EPOCH[training], EPOCHS)
    tag = f"{expt} {gnn} {training}"
    print(f"student {tag}: K1 launches={n} (expected {expected}) "
          f"BatchNorm launches {bn_launches} (expected {bn_expected}) "
          f"mean epoch (train step + eval) "
          f"{summary['runs'][0]['seconds'] / EPOCHS * 1e3:.1f} ms "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    failures = []
    if n != expected:
        failures.append(f"{tag}: {n} K1 launches")
    if bn_launches != bn_expected:
        failures.append(f"{tag}: BatchNorm launches {bn_launches}")
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


CSRC = "efficient_gnns_tpu_torch/ops/cuda/csrc/"
PALLAS = "efficient_gnns_tpu/ops/pallas/"
# timers of 20 kernel launches and 5 runs of the plain version
FIXED_REPS = (lambda fn: _time_ms(fn, 20), lambda fn: _time_ms(fn, 5))


def _equal(a, b):
    """``torch.equal``, output by output for a tuple of them."""
    import torch

    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _kernel_case(name, fn, plain, *, source, replaces, shape, n_bytes, n_ops=0,
                 tol_terms=None, rule=None, same=None, library=None, times=None,
                 device_ms=False, note="", **keys):
    """One kernel against its plain version: a record of ``PERF.md``'s kernel
    table, and the failures.

    Runs ``fn`` (the kernel) and ``plain``. The error is held to ``TOL + TOL
    * tol_terms()`` per output (``tol_terms()``: each output's sum of
    |terms|), or to the case's own ``rule(got, want) -> (max_abs_err, ok)``,
    or else must be none. Each call of ``same`` (label -> call: two launches,
    without the row split, ...) must give ``fn``'s bits. Times the kernel and
    the plain version (``times``: their two timers, ``_time_ms`` by default)
    and the library yardstick that ``library[1]()`` makes (``"plain"``: the
    plain version is it); ``device_ms`` adds the device-only times of both.
    Bounds the time by ``n_bytes`` and ``n_ops``. Prints one line (``note``
    at its end) and returns ``(record, failures)``; ``keys`` join the
    record."""
    got, want = fn(), plain()
    if rule is not None:
        err, ok = rule(got, want)
    else:
        diff = (got - want).abs()
        err = float(diff.max())
        ok = (got.shape == want.shape and bool((diff <= TOL + TOL * tol_terms()).all())
              if tol_terms is not None else _equal(got, want))
    same_bits = {label: _equal(got, call()) for label, call in (same or {}).items()}
    del got, want
    timer, plain_timer = times or (_time_ms, _time_ms)
    ms, plain_ms = timer(fn), plain_timer(plain)
    library_ms = library_device_ms = None
    if library == "plain":
        library_ms = plain_ms
    elif library is not None:
        try:
            yardstick = library[1]()
            library_ms = _time_ms(yardstick)
            if device_ms:
                library_device_ms = _device_ms(yardstick)
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
            print(f"  library call {library[0]} unavailable: {exc}")
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_FLOP_PER_S * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    record = {"name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
              "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
              "shape": shape}
    if library_ms is None and library is not None:
        record["library"] = "refused"
    line = ""
    if device_ms:
        record["device_ms"] = _device_ms(fn)
        line = f" device alone ms={record['device_ms']:.4f}"
        if library not in (None, "plain"):
            record["library_device_ms"] = library_device_ms
            line += f" (library {library_device_ms})"
    record.update(keys)
    if same_bits:
        line += " same bits: " + ", ".join(
            f"{label} {'equal' if eq else 'DIFFER'}" for label, eq in same_bits.items())
    print(f"  {name}: max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} ({plain_ms / ms:.2f}x) library_ms={library_ms} "
          f"bound_ms={bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of it){line}"
          + (f" {note}" if note else ""), flush=True)
    failures = [] if ok else [f"{name}: max_abs_err {err:.3e}"]
    failures += [f"{name}: not the same bits ({label})"
                 for label, eq in same_bits.items() if not eq]
    return record, failures


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

    def case(name, fn, plain, **kw):
        rec, fails = _kernel_case(f"{name}{suffix}", fn, plain, **kw)
        records.append(rec)
        failures.extend(fails)

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
        xs = [x.view(n, h, d)[:, j].contiguous() for j in range(h)]
        for direction, src, dst, ro, perm, sp in directions:
            wd = w if perm is None else w[perm].contiguous()
            shape = {"N": n, "E": e, "H": h, "D": d}
            tag = f"{direction} H={h} D={d}"

            def k2_library():  # one CSR matmul a head
                mats = [torch.sparse_csr_tensor(ro, src[:e], wd[:e, j].contiguous(), (n, n))
                        for j in range(h)]
                return lambda: [a @ xj for a, xj in zip(mats, xs)]

            # K2: multi-head segment sum; tolerance on each row's sum of |terms|
            case(f"K2 csr_segment_sum_heads {tag}",
                 lambda: K.csr_segment_sum_heads(x, wd, src, ro, sp),
                 lambda: K.csr_segment_sum_heads_plain(x, wd, src, ro),
                 tol_terms=lambda: K.csr_segment_sum_heads_plain(x.abs(), wd.abs(), src, ro),
                 same={"two launches": lambda: K.csr_segment_sum_heads(x, wd, src, ro, sp),
                       "without split": lambda: K.csr_segment_sum_heads(x, wd, src, ro)},
                 library=(f"K2 ({h} CSR matmuls)", k2_library), device_ms=True,
                 source="segment_heads.cu", replaces=PALLAS + "segment_matmul.py:92",
                 shape=shape, n_bytes=2 * n * hd * 4 + e * 4 + e * h * 4 + (n + 1) * 4,
                 n_ops=2 * e * hd, redesigned="row split")

            def k4_library():  # one sampled_addmm a head
                pattern = torch.sparse_csr_tensor(ro, src[:e], torch.zeros(e, device=DEVICE),
                                                  (n, n))
                gs = [gg.view(n, h, d)[:, j].contiguous() for j in range(h)]
                xts = [xj.t().contiguous() for xj in xs]
                return lambda: [torch.sparse.sampled_addmm(pattern, gj, xtj, beta=0.0)
                                for gj, xtj in zip(gs, xts)]

            # K4: per-edge head dots; tolerance on each dot's sum of |terms|; each
            # dot has one owner and one order: the same bits twice, without the
            # split and with chunks of 32 edges
            other = build_row_split(ro, 32).to(DEVICE)
            case(f"K4 csr_sddmm_heads {tag}",
                 lambda: K.csr_sddmm_heads(gg, x, src, ro, h, sp),
                 lambda: K.csr_sddmm_heads_plain(gg, x, src, ro, h),
                 tol_terms=lambda: K.csr_sddmm_heads_plain(gg.abs(), x.abs(), src, ro, h),
                 same={"two launches": lambda: K.csr_sddmm_heads(gg, x, src, ro, h, sp),
                       "without split": lambda: K.csr_sddmm_heads(gg, x, src, ro, h),
                       "chunks of 32": lambda: K.csr_sddmm_heads(gg, x, src, ro, h, other)},
                 library=(f"K4 ({h} sampled_addmm calls)", k4_library), device_ms=True,
                 source="segment_heads.cu", replaces=PALLAS + "segment_matmul.py:250",
                 shape=shape, n_bytes=2 * n * hd * 4 + e * 4 + (n + 1) * 4 + e_pad * h * 4,
                 n_ops=2 * e * hd, redesigned="row walk, g once per row")
            if (h, direction) in thin_heads:
                continue
            thin_heads.add((h, direction))
            # K5 / K6: thin segment sum and max, with the device-only times
            # beside the back-to-back ones (which, at these sizes, are the
            # host's); K7: rows back to the edges
            offsets = ro.long()
            thin = dict(source="segment_thin.cu", shape={"N": n, "E": e, "H": h},
                        device_ms=True)
            for kernel, fn, op, line in (("K5", K.csr_segment_sum_thin, "sum", 114),
                                         ("K6", K.csr_segment_max_thin, "max", 186)):
                case(f"{kernel} {fn.__name__} {tag}", lambda: fn(v, ro, sp),
                     lambda: K.csr_segment_reduce_thin_plain(v, ro, op),
                     # the sum within its tolerance, the max exactly
                     tol_terms=(lambda: K.csr_segment_reduce_thin_plain(v.abs(), ro, "sum"))
                     if op == "sum" else None,
                     same={"two launches": lambda: fn(v, ro, sp),
                           "without split": lambda: fn(v, ro)},
                     library=(f"{kernel} (segment_reduce {op})", lambda: (
                         lambda: torch.segment_reduce(v[:e], op, offsets=offsets))),
                     replaces=PALLAS + f"segment_thin.py:{line}", n_bytes=e * h * 4
                     + (n + 1) * 4 + n * h * 4, n_ops=e * h, redesigned="row split, lane groups",
                     **thin)
            case(f"K7 csr_tile_rows_thin {tag}", lambda: K.csr_tile_rows_thin(vals, dst, ro),
                 lambda: K.csr_tile_rows_thin_plain(vals, dst, ro),
                 library=("K7 (index_select)", lambda: (
                     lambda: vals.index_select(0, dst[:e]))),
                 replaces=PALLAS + "segment_thin.py:145",
                 n_bytes=n * h * 4 + e * 4 + e_pad * h * 4, redesigned="four floats a thread",
                 **thin)
            if h == heads[0][0] and direction == "fwd":
                bn = (vals, None, torch.ones(h, device=DEVICE), torch.zeros(h, device=DEVICE),
                      torch.zeros(h, device=DEVICE), torch.ones(h, device=DEVICE))
                host = {k: _host_us(f) for k, f in (
                    ("empty launch", lambda: K.segment_thin.empty_launch(DEVICE)),
                    ("K1", lambda: K.csr_segment_sum(x, src, ro, None, sp)),
                    ("K5", lambda: K.csr_segment_sum_thin(v, ro, sp)),
                    ("K7", lambda: K.csr_tile_rows_thin(vals, dst, ro)),
                    ("masked_batch_norm", lambda: K.masked_batch_norm(
                        *bn, training=True, momentum=0.9, epsilon=1e-5, relu=True)),
                    ("index_select", lambda: vals.index_select(0, dst[:e])))}
                print(f"  launch floor: an empty kernel takes "
                      f"{_device_ms(lambda: K.segment_thin.empty_launch(DEVICE), 200) * 1e3:.2f}"
                      f" us of device time back to back; host time to queue one call, us: "
                      + ", ".join(f"{k} {us:.1f}" for k, us in host.items()), flush=True)
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
            item = x.element_size()

            def library():  # the yardstick's sampling pattern, in the inputs' dtype
                pattern = torch.sparse_csr_tensor(
                    g.row_offsets, g.senders[:e],
                    torch.zeros(e, dtype=dtype, device=DEVICE), (n, n))
                xt = x.t().contiguous()
                return lambda: torch.sparse.sampled_addmm(pattern, cot, xt, beta=0.0)

            gathered = n * f * item + e * f * item + e * 4 + (n + 1) * 4 + e_pad * 4
            # tolerance on each dot's sum of |terms| (summation order); one owner
            # and one order per dot: the same bits twice, without the split and
            # with chunks of 32 edges
            rec, fails = _kernel_case(
                f"K3 csr_sddmm F={f} {str(dtype)[6:]}",
                lambda: csr_sddmm(cot, x, *args, g.row_split),
                lambda: csr_sddmm_plain(cot, x, *args),
                tol_terms=lambda: csr_sddmm_plain(cot.abs(), x.abs(), *args),
                same={"two launches": lambda: csr_sddmm(cot, x, *args, g.row_split),
                      "without split": lambda: csr_sddmm(cot, x, *args),
                      "chunks of 32": lambda: csr_sddmm(cot, x, *args, other_split)},
                library=(f"K3 (sampled_addmm, {dtype})", library),
                source="segment_sddmm.cu", replaces=PALLAS + "segment_matmul.py:315",
                shape={"N": n, "E": e, "F": f},
                n_bytes=2 * n * f * item + e * 4 + (n + 1) * 4 + e_pad * 4, n_ops=2 * e * f,
                note=f"gathered_bound_ms={gathered / HBM_BYTES_PER_S * 1e3:.4f}",
                on_main_path=dtype == torch.float32 and f == 256,
                redesigned="row walk, g once per row")
            records.append(rec)
            failures += fails
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
    backward) and each of the layer's four fused passes once, nothing else.
    Returns the failures."""
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
    counters = _counters("K", "hub_")
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
            if launches != {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0,
                            **{k: 1 for k in _counters("hub_")}}:
                failures.append(f"hub attention {tag}: launches {launches}")
            for name, err, scale in zip(("out", "dfeat", "del"), errs, scales):
                if not bool((err <= 1e-6 + 1e-4 * scale).all()):
                    failures.append(f"hub attention {tag}: {name} disagrees with the CPU")
            if not (bf16_err <= 1e-2 * float(want[0].abs().max())
                    and all(bool(torch.isfinite(t).all()) for t in bf16)):
                failures.append(f"hub attention {tag}: bfloat16 messages too far")
            failures += _hub_layer_vs_chain(graph, feat, el, cot, drop, tag)
    torch.cuda.synchronize()
    return failures


def _hub_chain(graph, feat_src, el, *, edge_drop, drop_seed, dst_scale, residual):
    """The hub layer before its fused kernels: separate PyTorch passes around
    one ``spmm`` (K1): messages concatenated in float32 and cast by the
    SpMM, a strided split, ``_Normalize``, the scale's broadcast multiply
    and the residual's add."""
    import torch

    from efficient_gnns_tpu_torch.ops import dispatch
    from efficient_gnns_tpu_torch.ops import hub_attention as hub
    from efficient_gnns_tpu_torch.ops.spmm import spmm

    n, h, d = feat_src.shape
    dp = -(-d // 128) * 128
    hp = 0 if d < dp else -(-h // 128) * 128
    e = torch.nn.functional.leaky_relu(el.float(), 0.2)
    m = e.detach().max(0, keepdim=True).values
    z = torch.exp(torch.clamp_min(e - m, -60.0))
    zx = feat_src.float() * z[:, :, None]
    if hp == 0:
        y = torch.cat([zx, z[:, :, None], zx.new_zeros(n, h, dp - d - 1)], -1).reshape(n, h * dp)
    else:
        y = torch.cat([zx.reshape(n, h * dp), torch.nn.functional.pad(z, (0, hp - h))], -1)
    weight = None
    if drop_seed is not None and edge_drop > 0.0:
        weight = hub.hub_keep_weights(graph, drop_seed, 1.0 - edge_drop)
    total = spmm(graph, y, edge_weight=weight, weight_grad=False,
                 message_dtype=dispatch.hub_message_dtype())
    if hp == 0:
        num, den, _ = total.view(n, h, dp).split([d, 1, dp - d - 1], -1)
        den = den[:, :, 0]
    else:
        num, den, _ = total.split([h * dp, h, hp - h], -1)
        num = num.view(n, h, dp)
    return hub._Normalize.apply(num, den) * dst_scale[:, None, None] + residual


def _hub_layer_vs_chain(graph, feat, el, cot, drop, tag):
    """The fused hub layer (with the ``sqrt(deg_in)`` scale and a residual,
    bfloat16 messages) against :func:`_hub_chain` on the card: the output,
    dfeat and dres the same bits (the backward's message columns are
    elementwise), del within 2**-8 of its largest entry (the cotangent's
    scalar column sums over D in another order before its bfloat16 cast, so
    an entry may round to the neighbouring bfloat16). Returns the failures."""
    import torch

    from efficient_gnns_tpu_torch.ops import hub_attention as hub

    g = graph.to(DEVICE)
    res = torch.randn(feat.shape, generator=torch.Generator().manual_seed(9))
    scale = torch.sqrt(g.in_degrees().clamp_min(1.0))
    seed = None if drop is None else torch.tensor(drop, device=DEVICE)
    outs = []
    for fn in (hub.hub_gat_attention, _hub_chain):
        f, e, r = (t.to(DEVICE, copy=True).requires_grad_() for t in (feat, el, res))
        out = fn(g, f, e, edge_drop=0.3, drop_seed=seed, dst_scale=scale, residual=r)
        (out * cot.to(DEVICE)).sum().backward()
        outs.append([t.detach() for t in (out, f.grad, r.grad, e.grad)])
    (fused, chain) = outs
    same = [torch.equal(a, b) for a, b in zip(fused[:3], chain[:3])]
    del_err = float((fused[3] - chain[3]).abs().max() / chain[3].abs().max())
    print(f"hub layer {tag}: fused vs the chain, bfloat16 messages: out / dfeat / dres "
          + " / ".join("same bits" if x else "DIFFER" for x in same)
          + f", del max err / max|del| {del_err:.3e}", flush=True)
    if not all(same) or not del_err <= 2**-8:
        return [f"hub layer {tag}: fused layer differs from the chain"]
    return []


def phase_hub_fused(graph):
    """The hub attention layer's four fused passes (``ops/cuda/hub_fused.py``)
    against their plain versions, the PyTorch chain they replace,
    on the card at the teacher's shapes (N of ``graph``; H = 3, D = 250: F =
    768; H = 1, D = 40: F = 128; bfloat16 messages): the forward passes and
    the backward's elementwise columns the same bits, the two sums over D
    (the cotangent's scalar column, dz) within 1e-5 of their sums of
    |terms|; each kernel's device time beside its byte bound and the chain's
    time. Returns (records, failures)."""
    import torch

    from efficient_gnns_tpu_torch.ops.cuda import hub_fused as H

    n = graph.num_nodes
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    records, failures = [], []
    bf16, f32 = torch.bfloat16, torch.float32
    for h, d in HEADS:
        dp, hp = H.hub_layout(h, d)
        w = h * dp + hp

        def rand(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE)

        x, g, res = rand(n, h, d), rand(n, h, d), rand(n, h, d)
        z = torch.rand(n, h, generator=gen, device=DEVICE) + 1e-3
        total, dy = rand(n, w), rand(n, w)
        H._unfold(total, h, d)[1].abs_().add_(0.5)
        scale = torch.sqrt(torch.randint(1, 50, (n,), generator=gen, device=DEVICE).float())
        xd, hd, sd = n * h * d * 4, n * h * 4, n * 4  # bytes of [N, H, D], [N, H], [N]

        def body_bits(got, want):  # the message columns of the cotangent
            got, want = H._unfold(got, h, d)[0], H._unfold(want, h, d)[0]
            return float((got.float() - want.float()).abs().max()), torch.equal(got, want)

        def dx_bits(got, want):
            return float((got[0] - want[0]).abs().max()), torch.equal(got[0], want[0])

        cases = {
            "hub_messages": (lambda: H.hub_messages(x, z, bf16),
                             lambda: H.hub_messages_plain(x, z, bf16), xd + hd + n * w * 2,
                             None),
            "hub_epilogue": (lambda: H.hub_epilogue(total, h, d, scale, res),
                             lambda: H.hub_epilogue_plain(total, h, d, scale, res),
                             (xd + hd) + sd + xd + xd, None),
            "hub_cotangent": (lambda: H.hub_cotangent(g, total, scale, bf16),
                              lambda: H.hub_cotangent_plain(g, total, scale, bf16),
                              xd + (xd + hd) + sd + n * w * 2, body_bits),
            "hub_message_grad": (lambda: H.hub_message_grad(dy, x, z),
                                 lambda: H.hub_message_grad_plain(dy, x, z),
                                 (xd + hd) + xd + hd + xd + hd, dx_bits),
        }
        # the sums over D against their sums of |terms|; the float32
        # cotangent's message columns the chain's bits
        ct = H.hub_cotangent(g, total, scale, f32)
        ct_want = H.hub_cotangent_plain(g, total, scale, f32)
        ct_terms = H.hub_cotangent_plain(g.abs(), total.abs(), scale, f32)
        dz = H.hub_message_grad(dy, x, z)[1]
        dz_want = H.hub_message_grad_plain(dy, x, z)[1]
        dz_terms = H.hub_message_grad_plain(dy.abs(), x.abs(), z)[1]
        (cb, cc), (wb, wc) = H._unfold(ct, h, d), H._unfold(ct_want, h, d)
        sum_err = [float((cc - wc).abs().max()), float((dz - dz_want).abs().max())]
        sums_ok = (bool(((cc - wc).abs() <= 1e-5 * H._unfold(ct_terms, h, d)[1].abs()).all())
                   and bool(((dz - dz_want).abs() <= 1e-5 * dz_terms).all()))
        if not torch.equal(cb, wb):
            failures.append(f"hub_cotangent H={h} D={d} f32: not the chain's bits")
        for name, (kernel, plain, n_bytes, rule) in cases.items():
            # the same bits as the chain of PyTorch passes, which is also the yardstick
            rec, fails = _kernel_case(
                f"{name} F={w} H={h} D={d} bf16", kernel, plain, rule=rule, times=FIXED_REPS,
                library="plain", source="hub_fused.cu",
                replaces="none: the elementwise chain around K1 of "
                         "efficient_gnns_tpu/ops/hub_attention.py::hub_gat_attention",
                shape={"N": n, "H": h, "D": d, "W": w}, n_bytes=n_bytes)
            rec["same_bits"] = not fails
            records.append(rec)
            failures += fails
        print(f"  hub fused H={h} D={d}: sums over D max_abs_err cotangent / dz "
              f"{sum_err[0]:.3e} / {sum_err[1]:.3e} {'ok' if sums_ok else 'TOO FAR'}",
              flush=True)
        if not sums_ok:
            failures.append(f"hub fused H={h} D={d}: a sum over D too far from the chain's")
    torch.cuda.synchronize()
    return records, failures


# MaskedBatchNorm at the cells' shapes: (rows, features, rows outside the mask)
BN_SHAPES = ((1280, 600, 460), (1280, 300, 460), (32, 600, 9), (32, 300, 9),
             (169343, 750, 0), (169343, 256, 0), (91445, 256, None))


def phase_masked_bn():
    """MaskedBatchNorm + ReLU's kernels (``ops/cuda/masked_bn.py``) at the
    cells' shapes (the molhiv batch's GIN-E MLP and post-conv BatchNorms
    with padding rows, its virtual node's over padded graphs, the teacher's
    and the GCN's [N, F], a head's train rows without a mask): the training
    forward, its backward and the eval forward, each against the plain
    chain (one-pass statistics, as the seed ran), with max |kernel - plain|;
    device times beside the byte bound (x and y forward, dy, x and dx
    backward). Returns (records, failures)."""
    import torch

    from efficient_gnns_tpu_torch.ops.cuda import masked_bn as M

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    records, failures = [], []
    for n, f, pad in BN_SHAPES:
        x = torch.randn(n, f, generator=gen, device=DEVICE) * 2 + 1
        dy = torch.randn(n, f, generator=gen, device=DEVICE)
        mask = None
        if pad is not None:
            mask = torch.ones(n, dtype=torch.bool, device=DEVICE)
            mask[torch.randperm(n, generator=gen, device=DEVICE)[:pad]] = False
        scale = 1 + 0.1 * torch.randn(f, generator=gen, device=DEVICE)
        bias = 0.1 * torch.randn(f, generator=gen, device=DEVICE)
        rm, rv = torch.zeros(f, device=DEVICE), torch.ones(f, device=DEVICE)
        small = n <= M.SMALL_ROWS
        kw = dict(momentum=0.9, epsilon=1e-5, relu=True)

        def fwd():
            if small:
                return M.bn_fused(x, mask, scale, bias, rm, rv, 0.9, 1e-5, True)
            return M.bn_apply(x, M.bn_partials(x, mask), scale, bias, rm, rv, 0.9, 1e-5, True)

        y, mean, rstd = fwd()
        args = (dy, x, mask, mean, rstd, scale, bias, True, False)

        def bwd():
            if small:
                return M.bn_grad_fused(*args)
            return M.bn_grad_apply(dy, x, mask, M.bn_grad_partials(*args), *args[3:])

        def evl():
            return M.bn_eval(x, scale, bias, rm, rv, 1e-5, True)

        def plain(training):
            return M.masked_batch_norm_plain(x, mask, scale, bias, rm.clone(), rv.clone(),
                                             training=training, **kw)

        xr = x.clone().requires_grad_(True)
        sc, bi = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)

        def plain_grads(relu_mask=None):
            out = M.masked_batch_norm_plain(xr, mask, sc, bi, rm.clone(), rv.clone(),
                                            training=True, momentum=0.9, epsilon=1e-5,
                                            relu=relu_mask is None)
            if relu_mask is not None:
                out = out * relu_mask
            return torch.autograd.grad(out, (xr, sc, bi), dy)

        relu_mask = (y > 0).float()
        limit = {"fwd": 1e-3, "eval": 1e-3, "bwd": 1e-3 * float(bwd()[0].abs().max())}
        timer = _device_ms if small else _time_ms
        big = n * f * 4
        cases = {"fwd": (fwd, lambda: plain(True), 2 * big + n),
                 "bwd": (bwd, plain_grads, 3 * big + n),
                 "eval": (evl, lambda: plain(False), 2 * big)}
        for what, (kernel, ref, n_bytes) in cases.items():
            def rule(got, want, what=what):
                if what == "bwd":
                    # the plain chain's gradient through the kernel's ReLU mask: a z
                    # within rounding of 0 on the other side would move its element
                    # by dy * scale * rstd
                    want = plain_grads(relu_mask)[0]
                err = float((got[0] - want).abs().max())
                return err, err <= limit[what]

            key = {"fwd": "bn_fused" if small else "bn_apply",
                   "bwd": "bn_grad_fused" if small else "bn_grad_apply", "eval": "bn_eval"}[what]
            rec, fails = _kernel_case(
                f"masked_bn {what} N={n} F={f} {'mask' if mask is not None else 'no mask'}",
                kernel, ref, rule=rule, times=(timer, timer), library="plain",
                source="masked_bn.cu",
                replaces="none: models/layers.py::MaskedBatchNorm + ReLU's chain of "
                         "PyTorch passes (the JAX layer's XLA work)",
                shape={"N": n, "F": f, "padding": pad}, n_bytes=n_bytes, launch_key=key,
                on_main_path=not small)  # the mol steps replay graphs: not counted here
            records.append(rec)
            failures += fails
    torch.cuda.synchronize()
    return records, failures


def phase_categorical():
    """OGB's atom and bond encoders' kernels (``ops/cuda/categorical.py``) at
    the molhiv batch's shapes: the forward against the chain of
    ``F.embedding`` and adds (the same bits), the backward against a float64
    sum of the rows by category (within ``TOL`` of each output's sum of
    |terms|), each twice; ids drawn one past each end of the vocabularies, so
    some are clipped. Times beside the byte bound (ids, tables and out
    forward; dy, ids and the gradients backward) and the chain with its
    autograd backward. Returns (records, failures)."""
    import torch

    from efficient_gnns_tpu_torch.models.mol import ATOM_FEATURE_DIMS, BOND_FEATURE_DIMS
    from efficient_gnns_tpu_torch.ops.cuda import categorical as C

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    records, failures = [], []
    f = 300
    for what, rows, vocab in (("atoms", 1280, ATOM_FEATURE_DIMS),
                              ("bonds", 4096, BOND_FEATURE_DIMS)):
        ids = torch.stack([torch.randint(-1, v + 1, (rows,), generator=gen, device=DEVICE)
                           for v in vocab], 1).int()
        tables = [torch.randn(v, f, generator=gen, device=DEVICE) / f ** 0.5 for v in vocab]
        dy = torch.randn(rows, f, generator=gen, device=DEVICE)
        leaves = [w.clone().requires_grad_(True) for w in tables]
        chain = C.categorical_encode_plain(ids, leaves)  # kept for its backward alone

        def chain_bwd():
            return torch.autograd.grad(chain, leaves, dy, retain_graph=True)

        def bwd_rule(got, want):
            worst, ok = 0.0, True
            for t, (g, v) in enumerate(zip(got, vocab)):
                k = ids[:, t].long().clamp(0, v - 1)
                ref = torch.zeros(v, f, dtype=torch.float64, device=DEVICE).index_add_(
                    0, k, dy.double())
                terms = torch.zeros_like(ref).index_add_(0, k, dy.double().abs())
                diff = (g.double() - ref).abs()
                worst, ok = max(worst, float(diff.max())), ok and bool((diff <= TOL * terms).all())
            return worst, ok

        n_ids, n_tab, n_rows = rows * len(vocab) * 4, sum(vocab) * f * 4, rows * f * 4
        shape = {"rows": rows, "tables": len(vocab), "vocab": list(vocab), "F": f}
        cases = {
            "fwd": (lambda: C.categorical_fwd(ids, tables),
                    lambda: C.categorical_encode_plain(ids, tables), None, n_ids + n_tab + n_rows),
            "bwd": (lambda: C.categorical_bwd(dy, ids, tuple(vocab)), chain_bwd, bwd_rule,
                    n_rows + n_ids + n_tab)}
        for direction, (kernel, plain, rule, n_bytes) in cases.items():
            rec, fails = _kernel_case(
                f"categorical {direction} {what} R={rows} T={len(vocab)} F={f}", kernel, plain,
                rule=rule, same={"two launches": kernel}, device_ms=True,
                library=("F.embedding chain" + (" and its autograd backward"
                                                if direction == "bwd" else ""), lambda p=plain: p),
                source="categorical.cu",
                replaces="none: models/mol.py::CategoricalEncoder's F.embedding lookups and adds "
                         "(the JAX encoder's XLA gathers and adds)",
                shape=shape, n_bytes=n_bytes, launch_key=f"categorical_{direction}")
            records.append(rec)
            failures += fails
    torch.cuda.synchronize()
    return records, failures


def _teacher_run(argv, expected):
    """One run of the teacher CLI at arxiv shape with every kernel's counter
    read around it; returns (launches by kernel, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import gat_teacher

    counters = _counters("K", "hub_", "bn_")
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
    path, K1 and the hub layer's fused passes) and again with attn-dst on (K2, K4-K7), every kernel
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

    counters = _counters("K")
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

    counters = _counters("K")
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
    launches = {k: 0 for k in _counters("K")}
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

    counters = _counters("K")
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


# the ogbn-mag workload (mag_pyg/): ogbn-mag's node counts, 128 paper
# features, 349 classes; synthetic relations (3 writes an author, 2 topics a
# paper, 7 cites a paper) give 22,322,316 edges after the 7-relation
# augmentation. GraphSAINT: 20,000 roots, walks of 3 (teacher) and 2 (student)
MAG_SHAPE = dict(n_paper=736389, n_author=1134649, n_inst=8740, n_field=59965, feat_dim=128,
                 num_classes=349, avg_cites=7)
MAG_TEACHER = ["--num_layers", "3", "--hidden_channels", "512", "--training", "supervised"]
MAG_AUX_NCE = ["--kd_and_aux", "--beta", "0.1", "--nce_T", "0.075", "--max_samples",
               "24576"]  # experiments/mag.json, graph_saint-aux/nce
MAG_EPOCHS = 2
MAG_STEPS = 30
MAG_TIME_STEPS = 5
# the raw cache is written and read as CSV text (gzip + np.savetxt / np.loadtxt):
# at full shape that is over 90 s, so it holds a cut of the papers, every
# other count cut in the same ratio; the full shape trains in mag_profile
MAG_CACHE_PAPERS = 100_000
MAG_ROOT = os.path.join(OUT_DIR, "mag_cache")
MAG_CKPT = os.path.join(OUT_DIR, "mag_ckpt")


def _mag_chunks(num_nodes):
    """Chunks of the layer-wise evaluation (``MagTrainer``'s chunk rule)."""
    c = min(16384, max(256, (num_nodes // 8) // 256 * 256))
    return -(-num_nodes // c)


def _mag_launches(layers, teacher_layers=0, chunks=119, epochs=MAG_EPOCHS, steps=MAG_STEPS,
                  time_steps=0):
    """K1 launches of a typed-square MAG run, from the code: a step runs each
    student layer's typed spmm forward and backward and each layer of the
    online teacher forward; the layer-wise evaluation after each epoch runs
    one K1 a chunk a layer; ``--time_steps`` takes one warm step and N more."""
    step = 2 * layers + teacher_layers
    return epochs * (steps * step + layers * chunks) + (time_steps + (1 if time_steps else 0)) * step


def _mag_dataset(n_paper=MAG_SHAPE["n_paper"], seed=42):
    """The synthetic ogbn-mag at ``n_paper`` papers, every other count in the
    same ratio to ogbn-mag's."""
    from efficient_gnns_tpu_torch.data import synthetic_mag_dataset

    k = n_paper / MAG_SHAPE["n_paper"]
    return synthetic_mag_dataset(**{**MAG_SHAPE, "n_paper": n_paper,
                                    "n_author": round(MAG_SHAPE["n_author"] * k),
                                    "n_inst": round(MAG_SHAPE["n_inst"] * k),
                                    "n_field": round(MAG_SHAPE["n_field"] * k)}, seed=seed)


def _k1_case(name, inp, src, ro, w, split, dense_shape, on_main_path=True, extra=None):
    """K1 on ``inp`` as ``_kernel_case`` holds a kernel, beside one cuSPARSE
    CSR matmul. The bound counts what this data needs: the weights of every
    edge, the senders and the distinct input rows of the edges of non-zero
    weight, every output row once. Returns (record, failures)."""
    import torch

    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum, csr_segment_sum_plain

    e = int(ro[-1])
    rows, f = ro.numel() - 1, inp.shape[1]
    live = w[:e] != 0
    e_live = int(live.sum())
    in_rows = int(torch.unique(src[:e][live]).numel())

    def library():
        a = torch.sparse_csr_tensor(ro, src[:e], w[:e], dense_shape)
        return lambda: a @ inp

    return _kernel_case(
        name, lambda: csr_segment_sum(inp, src, ro, w, split),
        lambda: csr_segment_sum_plain(inp, src, ro, w),
        tol_terms=lambda: csr_segment_sum_plain(inp.abs(), src, ro, w.abs()),
        same={"two launches": lambda: csr_segment_sum(inp, src, ro, w, split)},
        times=FIXED_REPS, library=("cuSPARSE CSR matmul", library),
        source="segment_sum.cu", replaces=PALLAS + "segment_matmul.py:162",
        shape={"rows": rows, "E": e, "E_live": e_live, "F": f, "in_rows": in_rows,
               **(extra or {})},
        n_bytes=e * 4 + e_live * 4 + in_rows * f * inp.element_size() + rows * f * 4
        + (rows + 1) * 4, n_ops=2 * e_live * f, on_main_path=on_main_path)


def phase_mag_kernels(ds):
    """K1 at the MAG paths' shapes on a teacher-shaped (walks of 3) and a
    student-shaped (walks of 2) GraphSAINT sample of the full-shape data:
    the typed square graph forward into its ``node_budget`` rows
    (``dst_rows``) and backward over its transpose, at the teacher's F = 512
    and 349 and the student's F = 32 and 349; the masked fallback's K1 (0/1
    weights of the cites relation) at F = 128 and 1; one chunk of the
    layer-wise evaluation at F = 128 and 512. Returns (records, failures)."""
    import torch

    from efficient_gnns_tpu_torch.native import host
    from efficient_gnns_tpu_torch.sampling import GraphSaintRandomWalkSampler
    from efficient_gnns_tpu_torch.train import RGCNLayerwiseInference
    from efficient_gnns_tpu_torch.train.mag_trainer import upload_bytes

    g = ds.grouped
    n = g.node_type.shape[0]
    nr = ds.num_edge_types
    cites = g.key2int[("paper", "cites", "paper")]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    records, failures = [], []
    print(f"mag kernels: N={n} E={g.edge_index.shape[1]} walker={host.walker()}", flush=True)
    for tag, walk, widths in (("teacher", 3, (512, 349)), ("student", 2, (32, 349))):
        t0 = time.perf_counter()
        sampler = GraphSaintRandomWalkSampler(
            g.edge_index[0], g.edge_index[1], n, batch_size=20000, walk_length=walk,
            edge_type=g.edge_type, num_edge_types=nr, seed=0, typed_square=True)
        init_s = time.perf_counter() - t0
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        sub = sampler.sample()
        prof.disable()
        sample_ms = (time.perf_counter() - t0) * 1e3
        top = pstats.Stats(prof).sort_stats("tottime")
        print(f"mag {tag} sample, host functions by own time (cProfile): " + ", ".join(
            f"{fn[2]} {st[2] * 1e3:.1f} ms" for fn, st in sorted(
                top.stats.items(), key=lambda kv: -kv[1][2])[:8]), flush=True)
        t = sub.typed_graph.to(DEVICE)
        nb = t.max_dst
        longest = [int((o[1:] - o[:-1]).max()) for o in (t.row_offsets, t.t_row_offsets)]
        print(f"mag {tag} sample: {sub.num_nodes} nodes (budget {nb}), {t.n_edge} edges "
              f"(E_pad {t.num_edges_padded}), longest row fwd / bwd {longest}, long rows "
              f"{[t.row_split.num_long, t.t_row_split.num_long]}; sampler init {init_s:.1f} s, "
              f"one sample {sample_ms:.0f} ms on the host (under cProfile), upload {upload_bytes(sub)} bytes "
              f"(both graphs)", flush=True)
        for f in widths:
            x = torch.randn(nr * nb, f, generator=gen, device=DEVICE)
            gy = torch.randn(nb, f, generator=gen, device=DEVICE)
            for direction, args, shape in (
                    ("fwd", (x, t.senders, t.row_offsets[:nb + 1], t.edge_weight,
                             t.dst_row_split), (nb, nr * nb)),
                    ("bwd", (gy, t.t_senders, t.t_row_offsets, t.t_edge_weight,
                             t.t_row_split), (nr * nb, nb))):
                rec, fails = _k1_case(f"K1 csr_segment_sum mag {tag} typed {direction} F={f}",
                                      *args, shape, extra={"node_budget": nb})
                records.append(rec)
                failures += fails
        if tag == "teacher":  # the masked fallback (--no_typed_square) on this sample
            m = sub.graph.to(DEVICE)
            sel = (m.edge_type == cites).float()
            for f in (128, 1):
                x = torch.randn(nb, f, generator=gen, device=DEVICE)
                rec, fails = _k1_case(f"K1 csr_segment_sum mag masked fwd F={f}", x, m.senders,
                                      m.row_offsets, sel, m.row_split, (nb, nb),
                                      on_main_path=False)
                records.append(rec)
                failures += fails
            del m
        del t, sub, sampler
    t0 = time.perf_counter()
    lw = RGCNLayerwiseInference(g.edge_index[0], g.edge_index[1], g.edge_type, n, nr,
                                chunk_nodes=min(16384, max(256, (n // 8) // 256 * 256)),
                                device=DEVICE)
    print(f"mag layer-wise: {lw.n_chunks} chunks of {lw.chunk_nodes} nodes, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    snd, wgt, ro, split = lw.chunks[0]
    for f in (128, 512):
        h = torch.randn(n, f, generator=gen, device=DEVICE)
        rec, fails = _k1_case(f"K1 csr_segment_sum mag layerwise chunk F={f}", h, snd, ro, wgt,
                              split, (ro.numel() - 1, n), extra={"chunks": lw.n_chunks})
        records.append(rec)
        failures += fails
        del h
    del lw
    torch.cuda.synchronize()
    return records, failures


def phase_mag_reference():
    """``MagTrainer`` on the card against the same trainer on the CPU (which
    the tests hold against the JAX package), same start (the modules are
    initialised on the CPU from their seeds), dropout 0, ``max_samples``
    above the node budget (no row subset), 2 epochs of 3 steps on a small
    synthetic MAG: ``supervised``, ``kd``, ``nce``, ``lpw``, each on the typed
    square layout and with ``--no_typed_square``. Per-epoch losses within
    rtol 1e-4; the layer-wise logits of the trained students within rtol 1e-4
    / atol 1e-4."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.data import synthetic_mag_dataset
    from efficient_gnns_tpu_torch.train import DistillConfig, MagTrainer

    ds = synthetic_mag_dataset(n_paper=400, n_author=200, n_inst=10, n_field=40, feat_dim=32,
                               num_classes=8, seed=5)
    failures = []
    for mode in ("supervised", "kd", "nce", "lpw"):
        for typed in (True, False):
            hist, logits = {}, {}
            for device in ("cpu", DEVICE):
                tr = MagTrainer(DistillConfig(training=mode, hidden=16, num_layers=2,
                                              dropout=0.0, lr=0.01, beta=1.0,
                                              max_samples=4096, proj_dim=16),
                                ds, batch_size=64, num_steps=3, teacher_hidden=24,
                                teacher_layers=3, typed_square=typed, device=device)
                try:
                    hist[device] = np.array([[m["loss"], m["loss_cls"], m["loss_aux"]]
                                             for m in (tr.train_epoch(e) for e in (1, 2))])
                    logits[device] = tr.logits().cpu()
                finally:
                    tr.close()
            got, want = hist[DEVICE], hist["cpu"]
            lerr = float((logits[DEVICE] - logits["cpu"]).abs().max())
            tag = f"{mode} {'typed' if typed else 'masked'}"
            print(f"mag reference {tag}: cuda vs cpu trainer, 2 epochs, losses "
                  f"{got[:, 0].tolist()} max_abs_err={float(np.abs(got - want).max()):.3e}; "
                  f"layer-wise logits max_abs_err={lerr:.3e}", flush=True)
            if not (np.isfinite(got).all() and np.allclose(got, want, rtol=1e-4, atol=1e-6)):
                failures.append(f"mag reference {tag}: the card's losses disagree with the CPU")
            if not torch.allclose(logits[DEVICE], logits["cpu"], rtol=1e-4, atol=1e-4):
                failures.append(f"mag reference {tag}: the card's logits disagree with the CPU")
    return failures


def _write_mag_cache(root, ds):
    """``ds`` as ogbn-mag's raw cache: the four relations of the data (not
    the reverse ones that the loader adds), local ids, one directory each;
    the node counts; paper features, labels and splits."""
    import gzip

    import numpy as np

    from efficient_gnns_tpu_torch.data.mag import MAG_RELATIONS, mag_raw_files

    g = ds.grouped
    files = mag_raw_files(root)
    for rel in MAG_RELATIONS:
        src, _, dst = rel
        os.makedirs(os.path.dirname(files["___".join(rel)]), exist_ok=True)
        ei = g.edge_index[:, g.edge_type == g.key2int[rel]]
        off = np.array([[g.local2global[src][0]], [g.local2global[dst][0]]])
        _write_csv_gz(files["___".join(rel)], (ei - off).T, "%d")
    names = sorted(ds.num_nodes_dict)
    with gzip.open(files["num_nodes"], "wt", compresslevel=1) as f:
        f.write(",".join(names) + "\n" + ",".join(str(ds.num_nodes_dict[k]) for k in names)
                + "\n")
    for key, arr, fmt in (("feat", ds.x_paper, "%.6f"), ("label", ds.y_paper[:, None], "%d")):
        os.makedirs(os.path.dirname(files[key]), exist_ok=True)
        _write_csv_gz(files[key], arr, fmt)
    for k, v in ds.split_idx.items():
        os.makedirs(os.path.dirname(files[k]), exist_ok=True)
        _write_csv_gz(files[k], v[:, None], "%d")


def _mag_run(tag, argv, expected):
    """One run of ``cli.mag`` on the raw cache with every kernel's counter
    read around it; returns (summary, launches by kernel, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import mag

    counters = _counters("K")
    for c in counters.values():
        c.launches = 0
    summary = mag.main(["--dataset", "ogbn-mag", "--data_root", MAG_ROOT, "--epochs",
                        str(MAG_EPOCHS), "--runs", "1", "--num_steps", str(MAG_STEPS),
                        "--batch_size", "20000", "--out_dir", OUT_DIR, "--expt_name",
                        "chip_smoke_mag", "--device", DEVICE, *argv])
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want["K1"] = expected
    secs = [v for v in summary["epoch_seconds"]["run0"] if not isinstance(v, dict)]
    steps = [v["device_step_ms"] for v in summary["epoch_seconds"]["run0"]
             if isinstance(v, dict)]
    losses = summary["losses"]["run0"]
    print(f"mag slice {tag}: launches {launches} (expected K1 {expected} and nothing else); "
          f"epochs (30 steps, host clock) {[round(v, 2) for v in secs]} s; device-only step "
          f"{[round(v, 2) for v in steps]} ms; losses {[round(v, 4) for v in losses]}; "
          f"train/valid/test by epoch "
          f"{[[round(a, 4) for a in accs] for accs in summary['accuracies']['run0']]}",
          flush=True)
    failures = []
    if launches != want:
        failures.append(f"mag slice {tag}: launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        failures.append(f"mag slice {tag}: losses not finite")
    return summary, launches, failures


def phase_mag_slice():
    """The synthetic MAG at ``MAG_CACHE_PAPERS`` papers (every count in
    ogbn-mag's ratios) written as ogbn-mag's raw cache and read back by
    ``data/mag.py`` (every array equal to the written dataset's); then
    ``cli.mag --dataset ogbn-mag`` on it: the 3 x 512 R-GCN teacher with
    ``--save_ckpt`` and ``--time_steps``, the checkpoint loaded into a fresh
    trainer (its evaluation equal to the CLI's last), then the 2 x 32 student
    from ``--teacher_path`` in ``kd`` and in ``nce --kd_and_aux`` at
    ``experiments/mag.json``'s point. Cut in time: 2 epochs of 30 steps, 1
    run each. K1 counted around each run against ``_mag_launches``, nothing
    else launched. The cache and the checkpoint are removed. Returns (K1
    launches, failures)."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.cli.mag import checkpoint_path
    from efficient_gnns_tpu_torch.data import load_ogbn_mag
    from efficient_gnns_tpu_torch.train import DistillConfig, MagTrainer
    from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint

    failures, k1 = [], 0
    try:
        t0 = time.perf_counter()
        ds = _mag_dataset(MAG_CACHE_PAPERS)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _write_mag_cache(MAG_ROOT, ds)
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(MAG_ROOT)
                   for f in fs)
        t0 = time.perf_counter()
        got = load_ogbn_mag(MAG_ROOT)
        load_s = time.perf_counter() - t0
        x_err = float(np.abs(got.x_paper - ds.x_paper).max())
        same = (all(np.array_equal(getattr(got.grouped, k), getattr(ds.grouped, k))
                    for k in ("edge_index", "edge_type", "node_type", "local_node_idx"))
                and np.array_equal(got.y_paper, ds.y_paper) and x_err <= 1e-6
                and all(np.array_equal(got.split_idx[k], v) for k, v in ds.split_idx.items()))
        n = ds.grouped.node_type.shape[0]
        print(f"mag cache: {ds.num_nodes_dict} ({n} nodes, {ds.grouped.edge_index.shape[1]} "
              f"edges after augmentation), built {build_s:.1f} s; {size} bytes, write "
              f"{write_s:.1f} s (gzip level 1), load {load_s:.1f} s (gzip + np.loadtxt, "
              f"relations augmented); arrays equal to the written ones: {same} (x within "
              f"{x_err:.1e})", flush=True)
        if not same:
            failures.append("mag cache: the loaded dataset differs from the written one")
        del got
        chunks = _mag_chunks(n)
        summary, launches, fails = _mag_run(
            "teacher 3 x 512 supervised",
            MAG_TEACHER + ["--save_ckpt", MAG_CKPT, "--time_steps", str(MAG_TIME_STEPS)],
            _mag_launches(3, chunks=chunks, time_steps=MAG_TIME_STEPS))
        k1, failures = k1 + launches["K1"], failures + fails
        ckpt = checkpoint_path(MAG_CKPT, 0)
        if not os.path.exists(ckpt):
            return k1, failures + ["mag slice: no teacher checkpoint"]
        # the checkpoint holds the model after its last epoch: a fresh
        # trainer that loads it evaluates as the CLI's last epoch did
        tr = MagTrainer(DistillConfig(num_layers=3, hidden=512), ds, device=DEVICE)
        tr.model.load_state_dict(load_checkpoint(ckpt, map_location=DEVICE))
        accs = tr.evaluate()
        want = tuple(summary["accuracies"]["run0"][-1])
        print(f"mag checkpoint: {os.path.getsize(ckpt)} bytes; reloaded teacher evaluates "
              f"{accs}, the CLI's last epoch {want}", flush=True)
        if accs != want:
            failures.append("mag checkpoint: the reloaded teacher evaluates otherwise")
        del tr
        student = _mag_launches(2, 3, chunks=chunks)
        for tag, argv in (("student kd", ["--training", "kd"]),
                          ("student nce --kd_and_aux", ["--training", "nce", *MAG_AUX_NCE])):
            _, launches, fails = _mag_run(tag, argv + ["--teacher_path", MAG_CKPT], student)
            k1, failures = k1 + launches["K1"], failures + fails
    finally:  # the cache and the checkpoint are not kept
        for d in (MAG_ROOT, MAG_CKPT):
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    return k1, failures


def phase_mag_profile(ds):
    """The teacher (3 x 512, ``supervised``) and the student (2 x 32, ``kd``
    with a random 3 x 512 teacher online) at the full shape, in memory,
    through ``MagTrainer``: a warm epoch, then one steady epoch (host clock,
    before any profile, the recorder on) with the prefetch thread's host ms a
    sample (its ``sampler.sample`` and ``sampler.upload`` spans, ``sample()``
    and the upload), one layer-wise evaluation, one profiled
    epoch (device busy and idle share, top device ops), the device-only step
    (``device_step_ms``, as ``--time_steps``) and the peak device memory.
    Returns the K1 launches of the steady epochs (checked against
    ``_mag_launches``) and the failures."""
    import torch

    from efficient_gnns_tpu_torch import tracing
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
    from efficient_gnns_tpu_torch.train import DistillConfig, MagTrainer
    from efficient_gnns_tpu_torch.train.mag_trainer import upload_bytes

    def span_ms(name):
        """Mean ms of the recorder's ``name`` spans."""
        ns = [r.t1_ns - r.t0_ns for r in tracing.records() if r.name == name]
        return sum(ns) / 1e6 / max(len(ns), 1)

    failures, k1 = [], 0
    for tag, cfg, teacher_layers in (
            ("mag_teacher", DistillConfig(num_layers=3, hidden=512), 0),
            ("mag_student_kd", DistillConfig(training="kd", num_layers=2, hidden=32), 3)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = MagTrainer(cfg, ds, device=DEVICE)
        init_s = time.perf_counter() - t0
        try:
            tr.train_epoch(1)  # warm-up
            csr_segment_sum.launches = 0
            tracing.reset()
            tracing.enable()
            try:
                ms = _steady_ms(lambda: tr.train_epoch(2), 1)
            finally:
                tracing.enable(False)
            launches = csr_segment_sum.launches
            sample_ms, upload_ms = span_ms("sampler.sample"), span_ms("sampler.upload")
            eval_ms = _steady_ms(tr.evaluate, 1)
            k1 += launches
            want = _mag_launches(cfg.num_layers, teacher_layers, epochs=1, chunks=0)
            print(f"{tag} steady train epoch (30 steps, host clock, before any MAG profile): "
                  f"{ms:.1f} ms; the prefetch thread's host time a sample: sample() "
                  f"{sample_ms:.1f} ms, upload {upload_ms:.1f} ms; K1 launches {launches} "
                  f"(expected {want}); one layer-wise evaluation {eval_ms:.1f} ms; trainer "
                  f"built in {init_s:.1f} s", flush=True)
            if launches != want:
                failures.append(f"{tag}: {launches} K1 launches in a train epoch")
            busy = _profile(tag, lambda: tr.train_epoch(3), 1,
                            also=("split_segment_sum", "index", "gemm"))
            print(f"{tag}: device busy {busy:.1f} ms of the steady {ms:.1f} ms epoch: "
                  f"{100 * (1 - busy / ms):.1f}% idle", flush=True)
            step_ms = tr.device_step_ms(MAG_TIME_STEPS)
            sub = tr._resident(tr.upload(tr.sampler.sample()))
            print(f"{tag}: device-only train step {step_ms:.2f} ms ({MAG_TIME_STEPS} chained "
                  f"steps on one resident sample); a step's upload {upload_bytes(sub)} bytes "
                  f"(graphs uploaded: typed {sub.typed_graph is not None}, own "
                  f"{sub.graph is not None}); peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        finally:
            tr.close()
        del tr
    return k1, failures


MOL_COUNTS = dict(n_train=32901, n_valid=4113, n_test=4113)  # OGB's scaffold split
# cut in time: cli.mol trains on a quarter of the train split (a GIN-E epoch
# of the full split is 38 s of host time on the card); valid and test whole
MOL_SLICE = dict(n_train=8225, n_valid=4113, n_test=4113)
MOL_DATA = [a for k, v in MOL_SLICE.items() for a in (f"--{k}", str(v))]
MOL_BATCH = 32  # the CLI's default, and MolTrainer's max_atoms=32: 1,024 nodes, 3,072 edges
MOL_TEACHER = ["--hidden_channels", "300", "--num_layers", "5", "--training", "supervised"]
MOL_STUDENT = ["--gnn", "gcn", "--hidden_channels", "64", "--num_layers", "2",
               "--teacher_gnn", "gine", "--teacher_hidden", "300", "--teacher_layers", "5"]
MOL_NCE = ["--training", "nce", "--kd_and_aux", "--beta", "0.5",
           "--nce_T", "0.075"]  # experiments/molhiv.json, gcn-gine/nce
MOL_EPOCHS = 1
MOL_PROFILE_STEPS = 50
MOL_ROOT = os.path.join(OUT_DIR, "mol_cache")
MOL_EXPT = "chip_smoke_mol"


def _mol_model_launches(conv, layers, vn):
    """K1 launches of one ``MolGNN`` forward and of its backward, from the
    code (``models/mol.py``): a forward sums each layer's messages (PNA: the
    mean and then the variance), pools after each layer but the last for the
    virtual node and pools the mean at the end; a backward sums the senders
    gather of each layer (PNA: also its receivers gather and its mean
    gather) and the virtual node's gather before each layer. The sums'
    backward is a gather, not K1."""
    fwd = (2 if conv == "pna" else 1) * layers + (layers - 1 if vn else 0) + 1
    bwd = (3 if conv == "pna" else 1) * layers + (layers if vn else 0)
    return fwd, bwd


def _mol_dataset():
    from efficient_gnns_tpu_torch.data import synthetic_molhiv_dataset

    t0 = time.time()
    ds = synthetic_molhiv_dataset(**MOL_COUNTS, seed=42)
    atoms = [m.num_nodes for m in ds.train]
    bonds = [len(m.senders) for m in ds.train]
    print(f"molhiv-shaped dataset built in {time.time() - t0:.1f} s: "
          f"{len(ds.train)}/{len(ds.valid)}/{len(ds.test)} molecules, atoms mean "
          f"{sum(atoms) / len(atoms):.2f} max {max(atoms)}, directed bonds mean "
          f"{sum(bonds) / len(bonds):.2f} max {max(bonds)}, "
          f"{100 * sum(m.label for m in ds.train) / len(ds.train):.1f}% positive, "
          f"mean_log_degree {ds.mean_log_degree:.4f}", flush=True)
    return ds


def phase_mol_reference():
    """``MolGNN`` on the card against the same module on the CPU (which the
    tests hold against the JAX package), same start, dropout 0, on a packed
    batch of 16 synthetic molecules, 3 layers of 16, for ``gine`` with the
    virtual node, ``gin``, ``gcn`` and ``pna``: the forward (rtol 1e-5 / atol
    1e-5), the train-mode BatchNorm statistics (the same) and every
    parameter's gradient (rtol 1e-4, atol 1e-5 times the largest). Then
    ``MolTrainer`` on the card against the CPU, 2 epochs each of
    ``supervised`` (GIN-E with the virtual node), ``kd`` (GCN), ``nce
    --kd_and_aux`` (GCN) and ``gpw`` (GIN) from a 2 x 24 GIN-E teacher,
    per-epoch losses within rtol 1e-4. Then, at the teacher's width (300 x 5,
    dropout 0.5) on a batch of 32, one ``supervised`` train step taken twice
    from one state (two trainers of one seed) gives the same bits, for
    GIN-E with the virtual node and for PNA, with K1's launches of the step
    checked. Then the evaluation path at that width: a GIN-E takes 4 train
    steps on the card, and its eval-mode scores of the batch of 32 it keeps
    on the card agree with the CPU's from the same weights and running
    statistics (rtol / atol 1e-4). Returns failures."""
    import numpy as np
    import torch

    from efficient_gnns_tpu_torch.data import MolBatcher, roc_auc, synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models import MolGNN
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
    from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer

    failures = []
    ds = synthetic_molhiv_dataset(n_train=48, n_valid=16, n_test=16, seed=2)
    mb = next(MolBatcher(ds.train, 16, 24).epoch(1))
    for conv, vn in (("gine", True), ("gin", False), ("gcn", False), ("pna", False)):
        res = {}
        for dev in ("cpu", DEVICE):
            model = MolGNN(conv, 16, 1, 3, dropout=0.0, virtual_node=vn, pna_towers=4,
                           pna_delta=ds.mean_log_degree, seed=3, device=dev)
            b = mb.to(dev)
            out, feat = model(b.batch, b.atoms, b.bonds)
            (torch.sin(out).sum() + torch.sin(feat).sum()).backward()
            res[dev] = ({"out": out.detach().cpu(), "feat": feat.detach().cpu(),
                         **{k: v.cpu() for k, v in model.named_buffers() if "running" in k}},
                        {k: p.grad.cpu() for k, p in model.named_parameters()})
        (vals, grads), (cvals, cgrads) = res[DEVICE], res["cpu"]
        scale = max(float(g.abs().max()) for g in cgrads.values())
        v_err = max(float((vals[k] - cvals[k]).abs().max()) for k in cvals)
        g_err = max(float((grads[k] - cgrads[k]).abs().max()) for k in cgrads)
        ok = (all(torch.allclose(vals[k], cvals[k], rtol=1e-5, atol=1e-5) for k in cvals)
              and all(torch.allclose(grads[k], cgrads[k], rtol=1e-4, atol=1e-5 * scale)
                      for k in cgrads))
        print(f"mol reference {conv}{' +vn' if vn else ''}: cuda vs cpu module, forward and "
              f"BN statistics max_abs_err={v_err:.3e}, {len(grads)} gradients max_abs_err="
              f"{g_err:.3e} (largest gradient {scale:.3e}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            failures.append(f"mol reference {conv}: the card's module disagrees with the CPU")
    for mode, kd_aux, conv in (("supervised", False, "gine"), ("kd", False, "gcn"),
                               ("nce", True, "gcn"), ("gpw", False, "gin")):
        hist = {}
        for dev in ("cpu", DEVICE):
            cfg = DistillConfig(training=mode, kd_and_aux=kd_aux, lr=0.003, alpha=0.5,
                                kd_T=1.0, beta=0.5, max_samples=16, proj_dim=8)
            teacher = MolGNN("gine", 24, 1, 2, virtual_node=True, seed=1, device=dev)
            student = MolGNN(conv, 16, 1, 2, dropout=0.0, virtual_node=conv == "gine",
                             seed=0, device=dev)
            tr = MolTrainer(cfg, ds, student, teacher=teacher, batch_size=16, max_atoms=24,
                            seed=0, device=dev)
            hist[dev] = np.array([[m["loss"], m["loss_cls"], m["loss_aux"]]
                                  for m in (tr.train_epoch(e) for e in (1, 2))])
        got, want = hist[DEVICE], hist["cpu"]
        print(f"mol reference trainer {mode}{' --kd_and_aux' if kd_aux else ''} ({conv}): "
              f"cuda vs cpu, 2 epochs, losses {got[:, 0].tolist()} max_abs_err="
              f"{float(np.abs(got - want).max()):.3e}", flush=True)
        if not (np.isfinite(got).all() and np.allclose(got, want, rtol=1e-4, atol=1e-7)):
            failures.append(f"mol reference trainer {mode}: the card's losses disagree")
    wide = synthetic_molhiv_dataset(n_train=64, n_valid=1, n_test=1, seed=4)
    for conv, vn in (("gine", True), ("pna", False)):
        steps = []
        for _ in range(2):
            model = MolGNN(conv, 300, 1, 5, dropout=0.5, virtual_node=vn, pna_towers=4,
                           pna_delta=wide.mean_log_degree, seed=7, device=DEVICE)
            tr = MolTrainer(DistillConfig(lr=0.001), wide, model, seed=0, device=DEVICE)
            b = next(tr.batcher.epoch(1)).to(DEVICE)
            tr.modules.train()
            tr.generator.manual_seed(11)
            csr_segment_sum.launches = 0
            loss = tr._train_step(b)
            torch.cuda.synchronize()
            steps.append((loss.cpu(), [p.detach().cpu() for p in model.parameters()],
                          csr_segment_sum.launches))
        same = torch.equal(steps[0][0], steps[1][0]) and all(
            torch.equal(a, b) for a, b in zip(steps[0][1], steps[1][1]))
        want = sum(_mol_model_launches(conv, 5, vn))
        print(f"mol reference {conv}{' +vn' if vn else ''} 300 x 5: one train step twice from "
              f"one state: {'the same bits' if same else 'DIFFERENT BITS'} (loss "
              f"{steps[0][0][0].item():.6f}, {len(steps[0][1])} parameters); K1 launches a "
              f"step {steps[0][2]} (expected {want})", flush=True)
        if not same:
            failures.append(f"mol reference {conv}: a repeated train step gives other bits")
        if steps[0][2] != want:
            failures.append(f"mol reference {conv}: {steps[0][2]} K1 launches a step")
    evald = synthetic_molhiv_dataset(n_train=128, n_valid=32, n_test=1, seed=5)
    model = MolGNN("gine", 300, 1, 5, dropout=0.5, virtual_node=True, seed=7, device=DEVICE)
    tr = MolTrainer(DistillConfig(lr=0.001), evald, model, seed=0, device=DEVICE)
    tr.train_epoch(1)
    scores, labels = tr.scores("valid")
    cpu = MolGNN("gine", 300, 1, 5, dropout=0.5, virtual_node=True, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval()
    with torch.no_grad():
        c_scores = torch.cat([cpu(mb.batch, mb.atoms, mb.bonds)[0][:mb.batch.n_graph, 0]
                              for mb in MolBatcher(evald.valid, 32, 32, shuffle=False).epoch(0)])
    c_scores = c_scores.numpy()
    err = float(np.abs(scores - c_scores).max())
    ok = scores.shape == c_scores.shape and np.allclose(scores, c_scores, rtol=1e-4, atol=1e-4)
    print(f"mol reference gine +vn 300 x 5 evaluation: after 4 train steps on the card, the "
          f"eval-mode scores of its kept batch of 32 against the same weights and running "
          f"statistics on the cpu: max_abs_err={err:.3e} (std {scores.std():.4f} / "
          f"{c_scores.std():.4f}), ROC-AUC {roc_auc(scores, labels):.4f} / "
          f"{roc_auc(c_scores, labels):.4f} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        failures.append("mol reference gine 300 x 5: the card's evaluation disagrees")
    return failures


def _mol_k1_case(name, inp, src, ro, split, library, on_main_path=True, extra=None):
    """K1 (no weights) on ``inp`` as ``_kernel_case`` holds a kernel, beside
    one PyTorch call (``library``: ``torch.segment_reduce`` for a sum over
    consecutive rows, ``index_add_`` for a gather's backward), whose result
    must be within the kernel's tolerance too, with both device-only times.
    The bound: each summed input row read once (the real ones, ``ro[-1]``),
    the index and offsets, every output row written once. Returns (record,
    failures)."""
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum, csr_segment_sum_plain

    e = int(ro[-1])
    rows, f = ro.numel() - 1, inp.shape[1]

    def rule(got, want):
        terms = TOL + TOL * csr_segment_sum_plain(inp.abs(), src, ro)
        lib_diff = (library() - got).abs()
        diff = (got - want).abs()
        print(f"  {name}: library max_abs_err={float(lib_diff.max()):.3e}", flush=True)
        return float(diff.max()), (got.shape == want.shape and bool((diff <= terms).all())
                                   and bool((lib_diff <= terms).all()))

    return _kernel_case(
        name, lambda: csr_segment_sum(inp, src, ro, None, split),
        lambda: csr_segment_sum_plain(inp, src, ro), rule=rule,
        same={"two launches": lambda: csr_segment_sum(inp, src, ro, None, split)},
        times=FIXED_REPS, library=(name, lambda: library), device_ms=True,
        source="segment_sum.cu", replaces=PALLAS + "segment_matmul.py:162",
        shape={"rows": rows, "E": e, "F": f, **(extra or {})},
        n_bytes=e * f * inp.element_size() + e * 4 + (rows + 1) * 4 + rows * f * 4,
        n_ops=e * f, on_main_path=on_main_path)


def phase_mol_kernels(ds):
    """K1 at the mol paths' shapes on the first packed train batch of the
    full-count data (batch 32: 1,024 nodes, 3,072 edges; and batch 128 of
    ``experiments/r5_workloads2.sh:36``, off the CLI's path): a conv's
    aggregation (the edges' messages summed into their receivers, K1 with
    the identity) at F = 300 (teachers) and 64 (student), the senders
    gather's backward over the transpose CSR at the same widths, the pool
    over ``graph_offsets`` at F = 300. Each against its plain version and
    one PyTorch call (``torch.segment_reduce`` with the CSR offsets; for the
    gather's backward ``index_add_``, what ``index_select``'s backward runs).
    Returns (records, failures)."""
    import torch

    from efficient_gnns_tpu_torch.data import MolBatcher

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    records, failures = [], []
    for batch, widths, on_path in ((MOL_BATCH, (300, 64), True), (128, (300,), False)):
        t0 = time.perf_counter()
        mb = next(MolBatcher(ds.train, batch, 32).epoch(1))
        pack_ms = (time.perf_counter() - t0) * 1e3
        b = mb.batch.to(DEVICE)
        g = b.graph
        print(f"mol kernels, batch {batch}: {b.n_graph} molecules, {g.n_edge} bonds of "
              f"E_pad {g.num_edges_padded}, {int(b.graph_offsets[-1])} atoms of N_pad "
              f"{g.num_nodes}; longest row fwd / bwd / pool "
              f"{[int((o[1:] - o[:-1]).max()) for o in (g.row_offsets, g.t_row_offsets, b.graph_offsets)]}"
              f"; packed in {pack_ms:.1f} ms (first batch, host)", flush=True)
        e, n = g.n_edge, int(b.graph_offsets[-1])
        for f in widths:
            msg = torch.randn(g.num_edges_padded, f, generator=gen, device=DEVICE)
            ro64 = g.row_offsets.long()
            cases = [
                (f"K1 csr_segment_sum mol b{batch} aggregate F={f}", msg,
                 b.ident[:g.num_edges_padded], g.row_offsets, g.row_split,
                 lambda msg=msg, ro64=ro64: torch.segment_reduce(msg[:e], "sum",
                                                                 offsets=ro64, axis=0)),
                (f"K1 csr_segment_sum mol b{batch} senders gather bwd F={f}", msg, g.csc_perm,
                 g.t_row_offsets, g.t_row_split,
                 lambda msg=msg: torch.zeros(g.num_nodes, f, device=DEVICE).index_add_(
                     0, g.senders[:e].long(), msg[:e])),
            ]
            if f == 300:
                x = torch.randn(g.num_nodes, f, generator=gen, device=DEVICE)
                go64 = b.graph_offsets.long()
                cases.append((f"K1 csr_segment_sum mol b{batch} pool F={f}", x,
                              b.ident[:g.num_nodes], b.graph_offsets, b.graph_split,
                              lambda x=x, go64=go64: torch.segment_reduce(
                                  x[:n], "sum", offsets=go64, axis=0)))
            for name, inp, src, ro, split, lib in cases:
                rec, fails = _mol_k1_case(name, inp, src, ro, split, lib, on_main_path=on_path,
                                          extra={"batch": batch})
                records.append(rec)
                failures += fails
    torch.cuda.synchronize()
    return records, failures


@contextlib.contextmanager
def _mol_expected():
    """Yields the launches, by counter, that the model calls made inside the
    block call for. A ``MolGNN`` call on the card that runs in Python (an
    eager step or evaluation, or the capture of a step's or the
    evaluation's graph; a replay runs none) launches K1 as
    ``_mol_model_launches`` says, forward and, where it takes gradients,
    backward; each encoder call launches ``categorical_fwd`` once and, where
    it takes gradients, ``categorical_bwd`` once; K2-K7 never launch."""
    import torch

    from efficient_gnns_tpu_torch.models.mol import CategoricalEncoder, MolGNN

    want = {k: 0 for k in _counters("K", "categorical_")}

    def expect(module, args, out):
        if not isinstance(module, (MolGNN, CategoricalEncoder)):
            return
        params = list(module.parameters())
        if not params[0].is_cuda:
            return
        grad = torch.is_grad_enabled() and any(p.requires_grad for p in params)
        if isinstance(module, MolGNN):
            fwd, bwd = _mol_model_launches(module.conv, module.num_layers, module.virtual_node)
            want["K1"] += fwd + (bwd if grad else 0)
        else:
            want["categorical_fwd"] += 1
            want["categorical_bwd"] += int(grad)

    hook = torch.nn.modules.module.register_module_forward_hook(expect)
    try:
        yield want
    finally:
        hook.remove()


def _mol_run(tag, argv):
    """One run of ``cli.mol`` with K1's and the encoder kernels' counters
    read around it, against ``_mol_expected``; the encoder kernels have to
    launch. Returns (summary, launches by counter, failures)."""
    import math

    from efficient_gnns_tpu_torch.cli import mol

    counters = _counters("K", "categorical_")
    for c in counters.values():
        c.launches = 0
    with _mol_expected() as want:
        summary = mol.main(["--epochs", str(MOL_EPOCHS), "--runs", "1", "--out_dir", OUT_DIR,
                            "--expt_name", MOL_EXPT, "--device", DEVICE, *argv])
    launches = {k: c.launches for k, c in counters.items()}
    secs = summary["seconds"]["run0"]
    losses = summary["losses"]["run0"]
    print(f"mol slice {tag}: launches {launches} (expected {want}); epochs, train and "
          f"evaluation (host clock) {[round(s['epoch'], 2) for s in secs]} s; losses "
          f"{[round(v, 4) for v in losses]}; "
          f"AUC train/valid/test by epoch "
          f"{[[round(a, 4) for a in aucs] for aucs in summary['aucs']['run0']]}", flush=True)
    failures = []
    if launches != want or not launches["categorical_fwd"]:
        failures.append(f"mol slice {tag}: launches {launches}, expected {want}")
    if not all(math.isfinite(v) for v in losses) or not all(
            math.isfinite(a) for aucs in summary["aucs"]["run0"] for a in aucs):
        failures.append(f"mol slice {tag}: losses or AUCs not finite")
    return summary, launches, failures


def _add(total, more):
    """``total`` with each count of ``more`` added."""
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def phase_mol_slice():
    """``cli.mol`` on the synthetic set at ``MOL_SLICE``'s counts (a quarter
    of ogbg-molhiv's 32,901 train molecules, its 4,113 valid and 4,113 test
    ones), full width, batch 32, one run of ``MOL_EPOCHS`` epochs each: the GIN-E teacher (300 x 5, virtual node) writing its
    best-validation checkpoint, the GCN student (2 x 64) from it in ``kd``
    and in ``nce --kd_and_aux`` (``experiments/molhiv.json``'s
    ``gcn-gine/kd`` and ``gcn-gine/nce`` points), then the PNA teacher (300 x
    5, 4 towers). K1 and the encoder kernels counted around each run
    (``_mol_run``). The checkpoint is removed. Returns (launches by
    counter, failures)."""
    from efficient_gnns_tpu_torch.cli.mol import checkpoint_path

    failures, launches = [], {}
    try:
        _, n, fails = _mol_run("teacher gine 300 x 5 supervised",
                               MOL_DATA + ["--gnn", "gine"] + MOL_TEACHER)
        launches, failures = _add(launches, n), failures + fails
        ckpt = checkpoint_path(OUT_DIR, MOL_EXPT, "gine", 0)
        if not os.path.exists(ckpt):
            return launches, failures + ["mol slice: no teacher checkpoint"]
        print(f"mol checkpoint: {os.path.getsize(ckpt)} bytes", flush=True)
        for tag, argv in (("student gcn 2 x 64 kd", ["--training", "kd"]),
                          ("student gcn 2 x 64 nce --kd_and_aux", MOL_NCE)):
            _, n, fails = _mol_run(tag, MOL_DATA + MOL_STUDENT + argv + [
                "--teacher_path", os.path.dirname(ckpt)])
            launches, failures = _add(launches, n), failures + fails
        _, n, fails = _mol_run("teacher pna 300 x 5 supervised",
                               MOL_DATA + ["--gnn", "pna"] + MOL_TEACHER)
        launches, failures = _add(launches, n), failures + fails
    finally:  # the checkpoints are not kept
        shutil.rmtree(os.path.join(OUT_DIR, "mol_ckpt"), ignore_errors=True)
    return launches, failures


def _write_ints_gz(path, arr):
    """An int table as gzip CSV text (level 1), formatted in one ``%`` pass
    (``np.savetxt`` formats row by row: 13 s at ogbg-molhiv's size)."""
    import gzip

    import numpy as np

    arr = np.asarray(arr).reshape(len(arr), -1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    line = ",".join(["%d"] * arr.shape[1]) + "\n"
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write((line * arr.shape[0]) % tuple(arr.ravel().tolist()))


def phase_mol_cache(ds):
    """``ds`` (the full-count synthetic set) written as OGB's ogbg-molhiv raw
    cache (train, valid, test in order, the splits their positions), read
    back by ``data/molhiv.py::load_molhiv`` (every molecule equal to the
    written one), then ``cli.mol --dataset ogbg-molhiv`` trains the GCN
    student (2 x 64, ``supervised``) one epoch on it, K1 and the encoder
    kernels counted (``_mol_run``). The cache is removed. Returns (launches
    by counter, failures)."""
    import numpy as np

    from efficient_gnns_tpu_torch.data import load_molhiv
    from efficient_gnns_tpu_torch.data.molhiv import molhiv_raw_files

    files = molhiv_raw_files(os.path.join(MOL_ROOT, "ogbg_molhiv"))
    mols = ds.train + ds.valid + ds.test
    failures, launches = [], {}
    try:
        t0 = time.perf_counter()
        _write_ints_gz(files["edge.csv.gz"], np.concatenate(
            [np.stack([m.senders, m.receivers], 1) for m in mols]))
        _write_ints_gz(files["edge-feat.csv.gz"], np.concatenate([m.bond_feats for m in mols]))
        _write_ints_gz(files["node-feat.csv.gz"], np.concatenate([m.atom_feats for m in mols]))
        _write_ints_gz(files["num-node-list.csv.gz"], [m.num_nodes for m in mols])
        _write_ints_gz(files["num-edge-list.csv.gz"], [len(m.senders) for m in mols])
        _write_ints_gz(files["graph-label.csv.gz"], [int(m.label) for m in mols])
        start = 0
        for split in ("train", "valid", "test"):
            k = len(getattr(ds, split))
            _write_ints_gz(files[split], np.arange(start, start + k))
            start += k
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in files.values())
        t0 = time.perf_counter()
        got = load_molhiv(MOL_ROOT)
        load_s = time.perf_counter() - t0
        same = True
        for split in ("train", "valid", "test"):
            a, b = getattr(ds, split), getattr(got, split)
            same = same and len(a) == len(b) and [m.num_nodes for m in a] == [
                m.num_nodes for m in b] and [m.label for m in a] == [m.label for m in b]
            for f in ("senders", "receivers", "atom_feats", "bond_feats"):
                same = same and np.array_equal(np.concatenate([getattr(m, f) for m in a]),
                                               np.concatenate([getattr(m, f) for m in b]))
        print(f"mol cache: {len(mols)} molecules, {size} bytes; write {write_s:.2f} s (gzip "
              f"level 1), read {load_s:.2f} s (gzip + np.loadtxt); every molecule equal to "
              f"the written one: {same}; mean_log_degree {got.mean_log_degree:.4f} (the "
              f"loader's, over 1,000 train molecules; the generator's over 100: "
              f"{ds.mean_log_degree:.4f})", flush=True)
        if not same:
            failures.append("mol cache: the loaded dataset differs from the written one")
        del got
        _, launches, fails = _mol_run("cache gcn 2 x 64 supervised", [
            "--dataset", "ogbg-molhiv", "--data_root", MOL_ROOT, "--gnn", "gcn"])
        failures += fails
    finally:  # the cache and the run's checkpoint are not kept
        shutil.rmtree(MOL_ROOT, ignore_errors=True)
        shutil.rmtree(os.path.join(OUT_DIR, "mol_ckpt"), ignore_errors=True)
    return launches, failures


def phase_mol_profile(ds):
    """A chunk of ``MOL_PROFILE_STEPS`` train steps (batch 32, the first
    molecules of the full-count set) of the GIN-E teacher (300 x 5, virtual
    node, ``supervised``) and of the GCN student (2 x 64, ``kd`` with a
    random GIN-E teacher online) through ``MolTrainer``: a warm chunk, then
    one steady chunk (host clock, before any profile; K1 counted against
    ``_mol_expected``), the host's pack time a batch alone, one evaluation
    of the valid split (kept on the device), the host functions of one
    chunk by own time (cProfile), and one profiled chunk (device busy and
    idle share, top device ops). Returns (K1 launches of the steady chunks
    by counter, failures)."""
    import torch

    from efficient_gnns_tpu_torch.data import MolDataset
    from efficient_gnns_tpu_torch.models import MolGNN
    from efficient_gnns_tpu_torch.ops.cuda import csr_segment_sum
    from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer

    chunk = MolDataset(train=ds.train[: MOL_PROFILE_STEPS * MOL_BATCH], valid=ds.valid,
                       test=ds.test, num_tasks=1, mean_log_degree=ds.mean_log_degree)
    gine, gcn = ("gine", 5, True), ("gcn", 2, False)
    failures, k1 = [], 0
    for tag, cfg, student, teacher in (
            ("mol_teacher", DistillConfig(hidden=300, num_layers=5, lr=0.001), gine, None),
            ("mol_student_kd", DistillConfig(training="kd", hidden=64, num_layers=2, lr=0.001,
                                             alpha=0.5, kd_T=1.0), gcn, gine)):
        conv, layers, vn = student
        model = MolGNN(conv, cfg.hidden, 1, layers, virtual_node=vn, device=DEVICE)
        online = (MolGNN("gine", 300, 1, 5, virtual_node=True, seed=1, device=DEVICE)
                  if teacher else None)
        tr = MolTrainer(cfg, chunk, model, teacher=online, device=DEVICE)
        tr.train_epoch(1)  # warm-up
        csr_segment_sum.launches = 0
        with _mol_expected() as expected:  # a step graph's replay launches nothing here
            ms = _steady_ms(lambda: tr.train_epoch(2), MOL_PROFILE_STEPS)
        launches, want = csr_segment_sum.launches, expected["K1"]
        k1 += launches
        t0 = time.perf_counter()
        n = sum(1 for _ in tr.batcher.epoch(3))
        pack_ms = (time.perf_counter() - t0) * 1e3 / n
        tr.evaluate("valid")  # packs and keeps the valid batches
        eval_ms = _steady_ms(lambda: tr.evaluate("valid"), 1)
        print(f"{tag} steady train step (a chunk of {MOL_PROFILE_STEPS}, host clock, packing "
              f"included, before any mol profile): {ms:.3f} ms; the host's pack time a batch "
              f"alone {pack_ms:.3f} ms; K1 launches {launches} (expected {want}); one "
              f"evaluation of the valid split ({len(chunk.valid)} molecules, batches on the "
              f"device) {eval_ms:.1f} ms", flush=True)
        if launches != want:
            failures.append(f"{tag}: {launches} K1 launches in a chunk")
        prof = cProfile.Profile()
        prof.enable()
        tr.train_epoch(4)
        prof.disable()
        top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:10]
        print(f"{tag} host functions by own time (cProfile, one chunk of "
              f"{MOL_PROFILE_STEPS} steps): " + ", ".join(
                  f"{fn[2] if fn[0] == '~' else f'{os.path.basename(fn[0])}:{fn[1]} {fn[2]}'} "
                  f"{st[2] * 1e3:.1f} ms {st[1]}x" for fn, st in top), flush=True)
        busy = _profile(tag, lambda: tr.train_epoch(3), 1,
                        also=("split_segment_sum", "categorical", "index"))
        print(f"{tag}: device busy {busy:.1f} ms of the steady {ms * MOL_PROFILE_STEPS:.1f} ms "
              f"chunk: {100 * (1 - busy / (ms * MOL_PROFILE_STEPS)):.1f}% idle", flush=True)
        del tr, model, online
    return {"K1": k1}, failures

def phase_heads_bf16_kernels(graph):
    """K2 and K4 reading bfloat16 messages against their plain versions at the
    teacher's arxiv shapes (``HEADS``; forward and transpose CSR). The plain
    versions form the same float32 products of the bfloat16 values, so the
    tolerance is float32's (summation order); the same bits twice and
    without the row split. Each record has the kernel's time, its bound on
    the bfloat16 bytes, the plain version's time and, where cuSPARSE takes
    bfloat16, the library call's (else "refused", with the reason)."""
    import torch

    from efficient_gnns_tpu_torch.ops import cuda as K

    g = graph.to(DEVICE)
    n, e, e_pad = g.num_nodes, g.n_edge, g.num_edges_padded
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    records, failures = [], []
    directions = (
        ("fwd", g.senders, g.row_offsets, None, g.row_split),
        ("bwd", g.t_senders, g.t_row_offsets, g.csc_perm.long(), g.t_row_split))
    times = (lambda fn: _time_ms(fn, budget_ms=500.0),) * 2
    for h, d in HEADS:
        hd = h * d
        x = torch.randn(n, hd, generator=gen, device=DEVICE).bfloat16()
        gg = torch.randn(n, hd, generator=gen, device=DEVICE).bfloat16()
        w = torch.rand(e_pad, h, generator=gen, device=DEVICE)
        xs = [x.view(n, h, d)[:, j].contiguous() for j in range(h)]
        for direction, src, ro, perm, sp in directions:
            wd = w if perm is None else w[perm].contiguous()
            tag = f"{direction} H={h} D={d}"
            common = dict(times=times, source="segment_heads.cu", dtype="bfloat16",
                          shape={"N": n, "E": e, "H": h, "D": d}, n_ops=2 * e * hd)

            def k2_library():  # one CSR matmul a head, where cuSPARSE takes bfloat16
                mats = [torch.sparse_csr_tensor(ro, src[:e], wd[:e, j].bfloat16(), (n, n))
                        for j in range(h)]
                return lambda: [a @ xj for a, xj in zip(mats, xs)]

            rec, fails = _kernel_case(
                f"K2 bf16 csr_segment_sum_heads {tag}",
                lambda: K.csr_segment_sum_heads(x, wd, src, ro, sp),
                lambda: K.csr_segment_sum_heads_plain(x, wd, src, ro),
                tol_terms=lambda: K.csr_segment_sum_heads_plain(x.abs(), wd.abs(), src, ro),
                same={"two launches": lambda: K.csr_segment_sum_heads(x, wd, src, ro, sp),
                      "without split": lambda: K.csr_segment_sum_heads(x, wd, src, ro)},
                library=(f"K2 bf16 ({h} CSR matmuls)", k2_library),
                replaces=PALLAS + "segment_matmul.py:92", launch_key="K2 bf16",
                n_bytes=n * hd * 2 + n * hd * 4 + e * 4 + e * h * 4 + (n + 1) * 4, **common)
            records.append(rec)
            failures += fails

            def k4_library():  # one sampled_addmm a head
                pattern = torch.sparse_csr_tensor(
                    ro, src[:e], torch.zeros(e, dtype=torch.bfloat16, device=DEVICE), (n, n))
                gs = [gg.view(n, h, d)[:, j].contiguous() for j in range(h)]
                xts = [xj.t().contiguous() for xj in xs]
                return lambda: [torch.sparse.sampled_addmm(pattern, gj, xtj, beta=0.0)
                                for gj, xtj in zip(gs, xts)]

            def k4_rule(got, want):  # within float32's tolerance, 0 on the padding
                diff = (got - want).abs()
                terms = K.csr_sddmm_heads_plain(gg.abs(), x.abs(), src, ro, h)
                return float(diff.max()), (bool((diff <= TOL + TOL * terms).all())
                                           and not bool(got[e:].any()))

            rec, fails = _kernel_case(
                f"K4 bf16 csr_sddmm_heads {tag}",
                lambda: K.csr_sddmm_heads(gg, x, src, ro, h, sp),
                lambda: K.csr_sddmm_heads_plain(gg, x, src, ro, h), rule=k4_rule,
                same={"two launches": lambda: K.csr_sddmm_heads(gg, x, src, ro, h, sp),
                      "without split": lambda: K.csr_sddmm_heads(gg, x, src, ro, h)},
                library=(f"K4 bf16 ({h} sampled_addmm calls)", k4_library),
                replaces=PALLAS + "segment_matmul.py:250", launch_key="K4 bf16",
                n_bytes=2 * n * hd * 2 + e * 4 + (n + 1) * 4 + e_pad * h * 4, **common)
            records.append(rec)
            failures += fails
    torch.cuda.synchronize()
    return records, failures


# first-step losses of the gat-step in bfloat16 against float32, relative:
# bfloat16 rounds the messages by at most 2**-8, which three layers of
# attention and BatchNorm carry into the logits at about that size
MICROBENCH_LOSS_RTOL = 1e-2
GAT_STEP_ITERS, GAT_STEP_REPEATS = 3, 2
# K2 and K4 launches of one gat-step (3 layers, one label iteration, no
# attn-dst): a train step runs 2 forwards and 1 backward of each layer (K2
# once a forward, K2 and K4 once a backward), an eval step 2 forwards
GAT_STEP_LAUNCHES = {"train": {"K2": 9, "K4": 3}, "eval": {"K2": 6, "K4": 0}}


def phase_microbench(graph):
    """``analysis/microbench.py`` on the card. ``gat-step --hub 0``: the
    arxiv-shaped teacher graph without the hub partition, so every layer of
    the 3 x 3 x 250 teacher runs ``gat_attention`` (K2, K4-K7); the train
    and the eval step in float32 and then in bfloat16 messages (K2 and K4
    read bfloat16), the bfloat16 run with every counter set to 0 before it
    and read after it; the two dtypes' first-step losses within
    ``MICROBENCH_LOSS_RTOL``; a trace of the bfloat16 train step whose
    summary must name K2's and K4's bfloat16 kernels. Then ``microbench
    spmm`` at F = 128 on ``graph`` with its bound, and ``sddmm_dot`` forward
    (K3) and backward (K1 twice) against the plain versions. Returns
    (launches by record key, failures)."""
    import torch

    from efficient_gnns_tpu_torch.analysis import microbench
    from efficient_gnns_tpu_torch.ops import dispatch, sddmm_dot
    from efficient_gnns_tpu_torch.ops import cuda as K

    failures, launches, first = [], {}, {}
    t0 = time.time()
    ds = microbench.gat_dataset(169343, 1166243, hub=0)
    print(f"microbench: gat-step graph (hub 0) built in {time.time() - t0:.1f} s, "
          f"{ds.graph.n_edge} edges, hub {'on' if ds.graph.hub is not None else 'off'}",
          flush=True)
    if ds.graph.hub is not None:
        failures.append("microbench: --hub 0 built a hub partition")
    counters = _counters("K")
    saved = dispatch.message_dtype(), dispatch.hub_message_dtype()
    trace_dir = os.path.join(OUT_DIR, "microbench_trace")
    try:
        for dtype in ("float32", "bfloat16"):
            microbench.set_message_dtype(dtype)
            for c in counters.values():
                c.launches = 0
            steps = {}
            for which in ("train", "eval"):
                trainer = microbench.teacher_trainer(ds, DEVICE)
                traced = which == "train" and dtype == "bfloat16"
                r = microbench.gat_step(trainer, which, GAT_STEP_ITERS, GAT_STEP_REPEATS,
                                        trace_dir=trace_dir if traced else None)
                steps[which] = 1 + GAT_STEP_ITERS * GAT_STEP_REPEATS + (3 if traced else 0)
                first[(dtype, which)] = r["first_loss"]
                print(f"microbench gat-step {which} {dtype}: first loss "
                      f"{r['first_loss']:.6f} step ms {r['step_ms']} peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
                if traced:
                    names = [k for k in r["trace"] if "bfloat16" in k]
                    for kernel, fn in (("K2", "split_segment_sum_kernel"),
                                       ("K4", "split_sddmm_kernel")):
                        hit = [k for k in names if fn in k]
                        print(f"  trace: {kernel} bf16 {sum(r['trace'][k] for k in hit):.3f} ms "
                              f"of {r['trace']['__total__']:.3f} ms device time in "
                              f"{len(hit)} kernel names", flush=True)
                        if not hit:
                            failures.append(f"microbench: the trace names no {kernel} "
                                            "bfloat16 kernel")
                del trainer
            counts = {k: c.launches for k, c in counters.items()}
            want = {k: sum(GAT_STEP_LAUNCHES[w][k] * steps[w] for w in steps)
                    for k in ("K2", "K4")}
            print(f"microbench gat-step {dtype}: launches {counts} (K2/K4 expected {want})",
                  flush=True)
            if any(counts[k] != want[k] for k in want) or counts["K1"] or counts["K3"]:
                failures.append(f"microbench gat-step {dtype}: launches {counts}, "
                                f"expected {want} and no K1/K3")
            if dtype == "bfloat16":
                launches = {"K2 bf16": counts["K2"], "K4 bf16": counts["K4"]}
    finally:
        dispatch.set_message_dtype(saved[0])
        dispatch.set_hub_message_dtype(saved[1])
        shutil.rmtree(trace_dir, ignore_errors=True)
    for which in ("train", "eval"):
        f32, bf16 = first[("float32", which)], first[("bfloat16", which)]
        rel = abs(bf16 - f32) / abs(f32)
        print(f"microbench gat-step {which}: first loss float32 {f32:.6f} bfloat16 "
              f"{bf16:.6f} relative gap {rel:.3e} (tolerance {MICROBENCH_LOSS_RTOL})",
              flush=True)
        if not rel <= MICROBENCH_LOSS_RTOL:
            failures.append(f"microbench gat-step {which}: bf16 loss {bf16} against {f32}")
    del ds

    g = graph.to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    x = torch.randn(g.num_nodes, 128, generator=gen, device=DEVICE)
    r = microbench.spmm_bench(g, x)
    print(f"microbench spmm F=128: {r['ms']:.4f} ms a forward+backward on "
          f"{torch.cuda.get_device_name(0)}, bound {r['bound_ms']:.4f} ms at "
          f"{microbench.HBM_BYTES_PER_S / 1e12:.2f} TB/s ({r['bound_ms'] / r['ms']:.3f} of "
          f"it)", flush=True)
    if not r["ms"] > 0:
        failures.append("microbench spmm: no time")

    a = torch.randn(g.num_nodes, 64, generator=gen, device=DEVICE)
    b = torch.randn(g.num_nodes, 64, generator=gen, device=DEVICE)
    cot = torch.randn(g.num_edges_padded, generator=gen, device=DEVICE)
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    K.csr_segment_sum.launches = K.csr_sddmm.launches = 0
    out = sddmm_dot(g, ta, tb)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    sd_launches = (K.csr_sddmm.launches, K.csr_segment_sum.launches)
    perm = g.csc_perm.long()
    want = (K.csr_sddmm_plain(a, b, g.senders, g.row_offsets),
            K.csr_segment_sum_plain(b, g.senders, g.row_offsets, cot),
            K.csr_segment_sum_plain(a, g.t_senders, g.t_row_offsets, cot[perm].contiguous()))
    scale = (K.csr_sddmm_plain(a.abs(), b.abs(), g.senders, g.row_offsets),
             K.csr_segment_sum_plain(b.abs(), g.senders, g.row_offsets, cot.abs()),
             K.csr_segment_sum_plain(a.abs(), g.t_senders, g.t_row_offsets,
                                     cot[perm].abs().contiguous()))
    errs = {}
    for name, got, w_, sc in zip(("out", "da", "db"), (out.detach(), ta.grad, tb.grad),
                                 want, scale):
        diff = (got - w_).abs()
        errs[name] = float(diff.max())
        if not bool((diff <= TOL + TOL * sc).all()):
            failures.append(f"sddmm_dot {name} disagrees with the plain version")
    print(f"sddmm_dot F=64: launches K3 {sd_launches[0]} K1 {sd_launches[1]} "
          f"(expected 1 and 2), max_abs_err vs plain {errs}", flush=True)
    if sd_launches != (1, 2) or bool(out[g.n_edge:].any()):
        failures.append(f"sddmm_dot: launches {sd_launches} or a value on padding edges")
    return launches, failures


PARALLEL_WORLD = 4
PARALLEL_F = 256
# K1 launches a rank makes in one run of each dryrun section, from the code:
# a halo step's forward sums the local and the halo edges, its backward the
# halo transpose, the local transpose and the send_idx scatter; spmm_sharded
# one forward and one backward; the ring none; the MAG epoch a forward and a
# backward a layer a step (3 layers, 2 steps); the GCN-KD train step two
# halo SpMMs forward (2 each) and backward (3 each), its evaluation two
# forward; the SIGN step none (dense layers and column gathers only)
PARALLEL_LAUNCHES = {"gcn_kd_step": 2 * (2 + 3), "gcn_kd_eval": 2 * 2, "sign_step": 0,
                     "halo_step": 5, "halo_exchange": 0, "spmm_sharded": 2, "spmm_halo": 5,
                     "ring_nce": 0, "halo2_step": 5, "mag_epoch": 2 * 3 * 2}
# K1 launches a rank makes in each case of parallel/modes.py (every
# distillation mode on row shards), from the code: (a train step, the
# evaluation). A step's two GCN layers one halo SpMM each, forward (2) and
# backward (3); gcd's two ProjectionGCD heads one each more; lpw's term
# (lsp_term) the student's and the teacher's softmax sums forward,
# and backward the student's sums' gather and its two edge gathers; the
# evaluation the two layers forward. The other terms launch nothing
PARALLEL_MODE_LAUNCHES = {"step": (2 * (2 + 3), 2 * 2), "gcd": (2 * (2 + 3) + 2 * (2 + 3), 2 * 2),
                          "lpw": (2 * (2 + 3) + 2 + 3, 2 * 2)}


def _parallel_one_rank(device, graph):
    """A world of one NCCL rank: ``spmm_sharded`` and ``spmm_halo`` forward
    and backward of ``sum(sin(A @ x))`` at F = ``PARALLEL_F`` on the padded
    arxiv graph, against the single-device ``ops.spmm`` on the same card
    (every entry within 1e-5 + 1e-5 * its sum of |terms|), with their K1
    launches and warm times."""
    import torch

    from efficient_gnns_tpu_torch.ops import cuda as K
    from efficient_gnns_tpu_torch.ops import spmm
    from efficient_gnns_tpu_torch.parallel import make_mesh
    from efficient_gnns_tpu_torch.parallel.partition import (
        local_partition, partition_graph, partition_graph_halo, spmm_halo, spmm_sharded)

    mesh = make_mesh(1, device=device)
    g = graph.to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(g.num_nodes, PARALLEL_F, generator=gen, device=device)

    def fwd_bwd(fn):
        v = x.clone().requires_grad_()
        y = fn(v)
        torch.sin(y).sum().backward()
        return y.detach(), v.grad

    ref_y, ref_dx = fwd_bwd(lambda v: spmm(g, v))
    y_scale = K.csr_segment_sum(x.abs(), g.senders, g.row_offsets, g.edge_weight.abs(),
                                g.row_split)
    dx_scale = K.csr_segment_sum(torch.cos(ref_y).abs(), g.t_senders, g.t_row_offsets,
                                 g.t_edge_weight.abs(), g.t_row_split)
    out = {}
    for name, build, fn in (("spmm_sharded", partition_graph, spmm_sharded),
                            ("spmm_halo", partition_graph_halo, spmm_halo)):
        local = local_partition(mesh, build(graph, 1))
        before = K.csr_segment_sum.launches
        y, dx = fwd_bwd(lambda v: fn(mesh, local, v))
        torch.cuda.synchronize()
        launches = K.csr_segment_sum.launches - before
        ok = bool(((y - ref_y).abs() <= TOL + TOL * y_scale).all()
                  and ((dx - ref_dx).abs() <= TOL + TOL * dx_scale).all())
        out[name] = dict(launches=launches, ok=ok, err_y=float((y - ref_y).abs().max()),
                         err_dx=float((dx - ref_dx).abs().max()),
                         ms=_time_ms(lambda: fwd_bwd(lambda v: fn(mesh, local, v)), 5))
    out["single_ms"] = _time_ms(lambda: fwd_bwd(lambda v: spmm(g, v)), 5)
    return out


def _parallel_modes(inputs, smi, failures):
    """Every distillation mode of the row-sharded trainer
    (``parallel.modes.run_modes``) on the gloo world of 4 on cuda:0 at arxiv
    shape and full width: ``parallel.modes.STEPS`` steps of each case, its
    losses against the card's single device (rtol 1e-5), the replicated
    parameters the same bits on every rank, every rank's K1 launches against
    ``PARALLEL_MODE_LAUNCHES``; prints ms and bytes a step; then K1 at
    ``lpw``'s shapes on the train subgraph (``K1 parallel lpw ...``
    records). Returns (the K1 launches of the path, records)."""
    import torch

    from efficient_gnns_tpu_torch.parallel.modes import STEPS, run_modes

    t0 = time.time()
    out = run_modes(inputs, PARALLEL_WORLD, backend="gloo", device="cuda")
    failures += [f"parallel modes: {f}" for f in out["failures"]]
    k1 = 0
    lsp = out["lsp_graph"]
    print(f"parallel modes: gloo x{PARALLEL_WORLD} on cuda:0, (2, 2) mesh, GCN 2 x 256, "
          f"teacher features 750 wide, proj_dim 256, max_samples 8192, train subgraph "
          f"{out['n_train']} nodes {lsp.n_edge} edges [{smi}]", flush=True)
    for name, want in out["single"].items():
        step, evaluation = PARALLEL_MODE_LAUNCHES.get(name, PARALLEL_MODE_LAUNCHES["step"])
        for r in out["ranks"]:
            c = r[name]
            if (c["k1_step"], c["k1_eval"]) != (step, evaluation):
                failures.append(f"parallel mode {name} rank K1 launches "
                                f"{c['k1_step']} a step, {c['k1_eval']} an evaluation")
            k1 += c["k1_step"] * STEPS + c["k1_eval"]
        c = out["ranks"][0][name]
        ms = " / ".join(f"{r[name]['ms'][-1]:.1f}" for r in out["ranks"])
        print(f"parallel mode {name}: losses {c['losses']} single device {want} (rtol 1e-5); "
              f"ms a step rank 0 {' / '.join(f'{v:.1f}' for v in c['ms'])}, last step ranks "
              f"{ms}; bytes sent a step a rank "
              f"{' / '.join(str(r[name]['bytes_step']) for r in out['ranks'])}; K1 a step "
              f"{c['k1_step']}, an evaluation {c['k1_eval']} [{smi}]", flush=True)
    print(f"parallel modes: {len(out['single'])} cases, world and single device "
          f"{time.time() - t0:.1f} s", flush=True)

    # lpw's K1 shapes: the softmax sums (and their gather's backward) at F = 1
    # over the train subgraph's CSR, the edge gathers' backward at the GCN's
    # width over its transpose (senders) and its CSR (receivers)
    g = lsp.to(DEVICE)
    e, e_pad = g.n_edge, g.num_edges_padded
    ident = torch.arange(e_pad, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    z = torch.rand(e_pad, 1, generator=gen, device=DEVICE)
    msg = torch.randn(e_pad, PARALLEL_F, generator=gen, device=DEVICE)
    ro64 = g.row_offsets.long()

    def index_add(ids, m):
        return torch.zeros(g.num_nodes, m.shape[1], device=DEVICE).index_add_(
            0, ids[:e].long(), m[:e])

    records = []
    for name, inp, src, ro, split, library in (
            ("sums F=1", z, ident, g.row_offsets, g.row_split,
             lambda: torch.segment_reduce(z[:e], "sum", offsets=ro64, axis=0)),
            (f"senders gather bwd F={PARALLEL_F}", msg, g.csc_perm, g.t_row_offsets,
             g.t_row_split, lambda: index_add(g.senders, msg)),
            (f"receivers gather bwd F={PARALLEL_F}", msg, ident, g.row_offsets, g.row_split,
             lambda: index_add(g.receivers, msg))):
        rec, fails = _mol_k1_case(f"K1 parallel lpw {name}", inp, src, ro, split, library,
                                  extra={"graph": "train subgraph"})
        rec["launch_key"] = "K1 parallel"
        records.append(rec)
        failures += fails
    return k1, records


def phase_parallel(smi):
    """The multi-device layer (``efficient_gnns_tpu_torch/parallel``) on the
    one card: the padded arxiv graph's partitions at D = 4 (``halo_stats``);
    a world of one NCCL rank holding ``spmm_sharded`` / ``spmm_halo`` forward
    and backward at F = 256 to the single-device ``ops.spmm``; then
    ``parallel.dryrun`` at arxiv shape on a gloo world of 4 ranks, every one
    on cuda:0 (the GCN-KD dp steps, the SIGN dp x tp step and the halo GCN
    step against the single-device losses on the card, rtol 1e-5; the
    two-level step the flat step's bits; ring NCE at 8,192 x 256; the MAG
    step with sharded tables), every rank's K1 launches checked against
    ``PARALLEL_LAUNCHES``, its exchange bytes a step printed; every
    distillation mode of the row-sharded trainer on a gloo world of 4 too
    (:func:`_parallel_modes`); and K1 timed on
    rank 0's local and halo CSRs of D = 4 at F = 256 and of the GCN-KD
    section's D = 2 at F = 256 and 40 (``K1 parallel ...`` records). Returns
    (records, K1 launches of the path, failures)."""
    import torch

    from efficient_gnns_tpu_torch.parallel import run_world
    from efficient_gnns_tpu_torch.parallel.dryrun import build_inputs, run_dryrun
    from efficient_gnns_tpu_torch.parallel.partition import partition_block

    t_phase = time.time()
    failures = []
    inputs = build_inputs(PARALLEL_WORLD, "arxiv")
    halo = inputs["halo"]
    print(f"parallel: padded arxiv graph {halo.num_nodes} nodes, {inputs['graph'].n_edge} "
          f"edges, D={PARALLEL_WORLD}: rows {halo.rows_per_dev}, halo width "
          f"{halo.halo_width}, local edges {int((halo.r_local < halo.rows_per_dev).sum())}, "
          f"halo edges {int((halo.r_halo < halo.rows_per_dev).sum())} "
          f"(built in {time.time() - t_phase:.1f} s)", flush=True)

    t0 = time.time()
    one = run_world(_parallel_one_rank, 1, backend="nccl", device="cuda",
                    args=(inputs["graph"],))[0]
    k1 = 0
    for name in ("spmm_sharded", "spmm_halo"):
        r = one[name]
        k1 += r["launches"]
        print(f"parallel nccl x1 {name} F={PARALLEL_F} fwd+bwd: max_abs_err out "
              f"{r['err_y']:.3e} grad {r['err_dx']:.3e} {'ok' if r['ok'] else 'MISMATCH'}, "
              f"K1 launches {r['launches']}, ms={r['ms']:.3f} (single-device spmm "
              f"{one['single_ms']:.3f}) [{smi}]", flush=True)
        if not r["ok"] or r["launches"] != (2 if name == "spmm_sharded" else 5):
            failures.append(f"parallel nccl x1 {name}")
    print(f"parallel nccl x1 world: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    r0 = run_dryrun(inputs, PARALLEL_WORLD, backend="gloo", device="cuda")
    for r in r0["ranks"]:
        if r["k1_launches"] != PARALLEL_LAUNCHES:
            failures.append(f"parallel rank {r['rank']} K1 launches {r['k1_launches']}")
        k1 += sum(n * len(r["ms"][name]) for name, n in r["k1_launches"].items())
        print(f"parallel gloo x{PARALLEL_WORLD} rank {r['rank']} on cuda:0 [{smi}]: ms "
              + ", ".join(f"{k} {' / '.join(f'{v:.1f}' for v in ms)}"
                          for k, ms in r["ms"].items())
              + f"; K1 launches a run {r['k1_launches']}", flush=True)
    rows = halo.halo_width * (PARALLEL_WORLD - 1)
    print(f"parallel halo exchange a rank: {rows} rows, {r0['exchange_bytes']} bytes at F=40 "
          f"(the step), {rows * PARALLEL_F * 4} bytes at F={PARALLEL_F}; staged through the "
          f"host by the port: 0 bytes (gloo takes the CUDA tensors); world "
          f"{time.time() - t0:.1f} s", flush=True)
    if not r0["halo2_same_bits"]:
        failures.append("parallel: the two-level step is not the flat step's bits")
    for r in r0["ranks"]:
        print(f"parallel gloo x{PARALLEL_WORLD} rank {r['rank']} exchange a step "
              f"[{smi}]: GCN-KD halo rows {r['gcn_kd_exchange_bytes']} bytes each way "
              f"(forward and backward at F=256 and 40), SIGN column gathers "
              f"{r['sign_gather_bytes']} bytes received (as many reduce-scattered back); "
              f"the SIGN step's collectives inside its last run "
              f"{r['exchange_ms']['sign_step']:.1f} ms of {r['ms']['sign_step'][-1]:.1f} ms "
              f"({100 * r['exchange_ms']['sign_step'] / r['ms']['sign_step'][-1]:.1f}%)",
              flush=True)
    print(f"parallel GCN-KD dp step (2, 2) losses {r0['gcn_kd_losses']} single device "
          f"{r0['single_gcn_kd_losses']} (rtol 1e-5), accuracies {r0['gcn_kd_accs']}; "
          f"SIGN dp x tp step (2, 2) losses {r0['sign_losses']} single device "
          f"{r0['single_sign_losses']} (rtol 1e-5); replicated parameters the same bits on "
          f"every rank", flush=True)
    more, lpw_records = _parallel_modes(inputs, smi, failures)
    k1 += more

    records = []
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    for part, widths in ((halo, (PARALLEL_F,)), (inputs["halo_dp"], (PARALLEL_F, 40))):
        blk = partition_block(part, 0)
        d = part.num_devices
        for f in widths:
            for what, csr, n_in in (("local", blk.local_fwd, part.rows_per_dev),
                                    ("halo", blk.halo_fwd, d * part.halo_width)):
                csr = csr.to(DEVICE)
                inp = torch.randn(n_in, f, generator=gen, device=DEVICE)
                rec, fails = _k1_case(f"K1 parallel D={d} {what} F={f}", inp, csr.src,
                                      csr.row_offsets, csr.w, csr.split,
                                      (part.rows_per_dev, n_in),
                                      extra={"world": d, "rank": 0, "csr": what})
                rec["launch_key"] = "K1 parallel"
                records.append(rec)
                failures += fails
    print(f"parallel phase: {time.time() - t_phase:.1f} s", flush=True)
    return records + lpw_records, k1, failures


PHASES = ("k1", "attention_kernels", "k3", "split_edges", "reference", "teacher_reference",
          "hub_attention", "hub_fused", "masked_bn", "sign_reference", "slice", "teacher_slice",
          "sign_slice", "checkpoint", "ogbn_cache", "runtime_spmm", "sign_profile", "ppi_kernels",
          "ppi_reference", "ppi_slice", "ppi_profile", "mag_kernels", "mag_reference", "mag_slice",
          "mag_profile", "mol_reference", "mol_kernels", "mol_slice", "mol_cache", "mol_profile",
          "heads_bf16_kernels", "microbench", "parallel", "categorical")


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
                        ("k3", phase_k3), ("heads_bf16_kernels", phase_heads_bf16_kernels),
                        ("hub_fused", phase_hub_fused)):
        recs, fails = run(name, phase, ds.graph) or ([], [])
        records, failures = records + recs, failures + fails
    for name, phase in (("masked_bn", phase_masked_bn), ("categorical", phase_categorical)):
        recs, fails = run(name, phase) or ([], [])
        records, failures = records + recs, failures + fails
    failures += run("split_edges", phase_split_edges) or []
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
    mb_launches, mb_failures = run("microbench", phase_microbench, ds.graph) or ({}, [])
    failures += (slice_failures + teacher_failures + sign_failures + ck_failures
                 + ogbn_failures + rt_failures + mb_failures)
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
    failures += run("mag_reference", phase_mag_reference) or []
    mag_k1, fails = run("mag_slice", phase_mag_slice) or (0, [])
    failures += fails
    if chosen & {"mag_kernels", "mag_profile"}:
        t0 = time.time()
        mag = _mag_dataset()
        print(f"MAG-shaped dataset built in {time.time() - t0:.1f} s: {mag.num_nodes_dict}, "
              f"{mag.grouped.edge_index.shape[1]} edges after augmentation", flush=True)
        recs, fails = run("mag_kernels", phase_mag_kernels, mag) or ([], [])
        records, failures = records + recs, failures + fails
        more, fails = run("mag_profile", phase_mag_profile, mag) or (0, [])
        mag_k1, failures = mag_k1 + more, failures + fails
        del mag
    failures += run("mol_reference", phase_mol_reference) or []
    mol_launches, fails = run("mol_slice", phase_mol_slice) or ({}, [])
    failures += fails
    if chosen & {"mol_kernels", "mol_cache", "mol_profile"}:
        molds = _mol_dataset()
        recs, fails = run("mol_kernels", phase_mol_kernels, molds) or ([], [])
        records, failures = records + recs, failures + fails
        for name, phase in (("mol_cache", phase_mol_cache), ("mol_profile", phase_mol_profile)):
            more, fails = run(name, phase, molds) or ({}, [])
            mol_launches, failures = _add(mol_launches, more), failures + fails
        del molds
    par_records, par_k1, fails = run("parallel", phase_parallel, smi) or ([], 0, [])
    records, failures = records + par_records, failures + fails
    run("sign_profile", phase_sign_profile, ds)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches["K1"] = (k1_launches + launches.get("K1", 0) + rt_launches.get("K1", 0)
                      + sign_launches + ck_launches + ogbn_launches + mag_k1
                      + mol_launches.get("K1", 0) + par_k1)
    launches["K1 parallel"] = par_k1
    launches["K3"] = launches.get("K3", 0) + rt_launches.get("K3", 0)
    for k, n in ppi_launches.items():
        launches[k] = launches.get(k, 0) + n
    launches.update(mb_launches)
    launches.update({k: n for k, n in mol_launches.items() if k.startswith("categorical_")})
    for r in records:  # a shape that the paths never launch counts 0
        on_path = r.get("on_main_path", True)
        key = r.pop("launch_key", r["name"].split()[0])
        r["launches"] = launches.get(key, 0) if on_path else 0
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
