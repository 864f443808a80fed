"""SIGN training CLI (counterpart of ``efficient_gnns_tpu/cli/sign.py``),
with the same flags plus ``--device`` and ``--data_root``:

    python -m efficient_gnns_tpu_torch.cli.sign --R 5 --training kd \\
        --teacher_dir teacher_dumps/gat-3L250x3h --device cuda

The hop features are ``R`` neighbour-mean passes (``spmm_mean``) over the
dataset's graph, computed once on the device before the runs. On
``--dataset synthetic`` that graph carries the GCN-normalised edge weights,
as the JAX CLI builds it, so a hop is ``D^-1 (A_hat x)``, not the plain
neighbour mean (ROADMAP.md Queue 3). The modes with a teacher read the
per-seed ``.npz`` dumps in ``--teacher_dir`` or, without one, use the oracle
teacher of the JAX CLI: class prototypes as features, 4 / -2 logits. The
command writes ``<out_dir>/sign-<expt_name>-<training>.json`` (args, per-run
seconds and statistics, across-run statistics) and returns it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SIGN on ogbn-arxiv (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--data_root", type=str, default="dataset",
                   help="OGB cache root for --dataset ogbn-arxiv")
    p.add_argument("--expt_name", type=str, default="debug")
    p.add_argument("--training", type=str, default="supervised",
                   choices=["supervised", "kd", "fitnet", "at", "gpw", "nce"])
    p.add_argument("--kd_and_aux", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_runs", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--R", type=int, default=5, help="number of hops")
    p.add_argument("--num_hidden", type=int, default=512)
    p.add_argument("--ff_layer", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--input_dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=50000)
    p.add_argument("--eval_batch_size", type=int, default=100000)
    p.add_argument("--alpha", type=float, default=0.9)
    p.add_argument("--kd_T", type=float, default=4.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--kernel", type=str, default="cosine")
    p.add_argument("--max_samples", type=int, default=8192)
    p.add_argument("--proj_dim", type=int, default=256)
    p.add_argument("--nce_T", type=float, default=0.075)
    p.add_argument("--teacher_dir", type=str, default=None)
    p.add_argument("--num_nodes", type=int, default=20000)
    p.add_argument("--num_edges", type=int, default=120000)
    p.add_argument("--signal", type=float, default=0.8,
                   help="synthetic class-signal strength (lower = harder)")
    p.add_argument("--label_noise", type=float, default=0.0)
    p.add_argument("--out_dir", type=str, default="logs")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform override of the JAX CLI; the port takes "
                        "--device instead")
    return p


def oracle_teacher_prototypes(y: np.ndarray, num_classes: int) -> np.ndarray:
    """The SIGN CLI's stand-in teacher features: the 64-d prototype of each
    node's class, from the JAX CLI's NumPy stream (seed 7), without noise."""
    rng = np.random.default_rng(7)
    return rng.normal(size=(num_classes, 64)).astype(np.float32)[y]


def main(argv=None) -> dict:
    """Run the CLI; returns what it writes to the JSON file."""
    args = build_parser().parse_args(argv)
    if args.platform is not None:
        raise ValueError("--platform selects a JAX platform; use --device")
    if args.dataset not in ("synthetic", "ogbn-arxiv"):
        raise ValueError(f"--dataset must be synthetic or ogbn-arxiv, got {args.dataset!r}")
    import torch

    from efficient_gnns_tpu_torch.cli.arxiv import oracle_teacher_logits
    from efficient_gnns_tpu_torch.data import load_ogbn_arxiv, synthetic_node_dataset
    from efficient_gnns_tpu_torch.distill import load_teacher_dump
    from efficient_gnns_tpu_torch.sampling import neighbor_average_features
    from efficient_gnns_tpu_torch.train import DistillConfig, Logger, SIGNTrainer

    if args.dataset == "synthetic":
        ds = synthetic_node_dataset(
            num_nodes=args.num_nodes, num_edges=args.num_edges, seed=42,
            signal=args.signal, label_noise=args.label_noise,
        )
    else:
        ds = load_ogbn_arxiv(root=args.data_root)
    device = torch.device(args.device)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device))

    graph = ds.graph.to(device)
    x = torch.as_tensor(ds.x, dtype=torch.float32).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    feats = neighbor_average_features(graph, x, args.R)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    precompute_s = time.perf_counter() - t0
    print(f"hop precompute (R={args.R}) in {precompute_s * 1e3:.2f} ms on {device_name} "
          f"(nodes={ds.num_nodes} edges={ds.graph.n_edge})", flush=True)
    del graph, x

    cfg = DistillConfig(
        training=args.training, kd_and_aux=args.kd_and_aux,
        hidden=args.num_hidden, dropout=args.dropout, lr=args.lr,
        weight_decay=args.weight_decay, alpha=args.alpha, kd_T=args.kd_T,
        beta=args.beta, kernel=args.kernel, max_samples=args.max_samples,
        proj_dim=args.proj_dim, nce_T=args.nce_T,
    )
    logger = Logger(args.num_runs)
    results = []
    for run in range(args.num_runs):
        seed = args.seed + run
        t_feat = t_logits = None
        if cfg.needs_teacher() and args.teacher_dir:
            t_feat, t_logits = load_teacher_dump(args.teacher_dir, seed)
        elif cfg.needs_teacher():
            t_feat = oracle_teacher_prototypes(ds.y, ds.num_classes)
            t_logits = oracle_teacher_logits(ds.y, ds.num_classes)
        trainer = SIGNTrainer(
            cfg, feats, ds.y, ds.split_idx, ds.num_classes,
            batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
            teacher_feat=t_feat, teacher_logits=t_logits, ff_layers=args.ff_layer,
            input_drop=args.input_dropout, seed=seed, device=device,
        )
        if run == 0:
            print("# Params:", trainer.num_params())
        losses = []
        t0 = time.time()
        for epoch in range(1, args.num_epochs + 1):
            m = trainer.train_epoch(epoch)
            losses.append(m["loss"])
            if epoch % args.eval_every == 0 or epoch == args.num_epochs:
                accs = trainer.evaluate()
                logger.add_result(run, accs)
                print(f"Run {run} Epoch {epoch} loss {m['loss']:.4f} "
                      f"train/val/test {accs[0]:.4f}/{accs[1]:.4f}/{accs[2]:.4f}", flush=True)
        logger.print_statistics(run)
        results.append({"run": run, "seed": seed, "seconds": time.time() - t0,
                        "losses": losses, **logger.run_statistics(run)})
    logger.print_statistics()

    os.makedirs(args.out_dir, exist_ok=True)
    summary = {"args": vars(args), "precompute_seconds": precompute_s, "runs": results,
               "statistics": logger.statistics()}
    with open(os.path.join(args.out_dir, f"sign-{args.expt_name}-{args.training}.json"),
              "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
