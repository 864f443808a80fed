"""ogbn-arxiv student training CLI (counterpart of
``efficient_gnns_tpu/cli/arxiv.py``), with the same flags and outputs:

    python -m efficient_gnns_tpu_torch.cli.arxiv --gnn gcn --training kd \\
        --alpha 0.9 --kd_T 4 --runs 10 --epochs 500 --device cuda

Each run appends per-epoch JSONL records to
``<out_dir>/<expt_name>/<gnn>-<mode>/seed<seed>/metrics.jsonl`` and the
command writes ``<out_dir>/<expt_name>-<gnn>-<mode>.json`` (args, per-run
statistics, across-run statistics).

``--gnn gcn|sage`` with every ``--training`` mode and ``--kd_and_aux``, on
``--dataset synthetic`` or ``ogbn-arxiv`` (the OGB raw cache under
``--data_root``, ``data/ogb.py``). The modes with a teacher read its
features and logits from the per-seed ``.npz`` dumps in ``--teacher_dir``
(``distill/artifacts.py``, written by either package's teacher CLI), or use
the oracle teacher without one. ``--checkpoint_every N`` saves the training
state to ``<run dir>/checkpoint.pt`` at the end of every epoch chunk that
crosses a multiple of N, and at the end of the run; ``--resume`` starts each
run after its saved epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ogbn-arxiv distillation (PyTorch)")
    # experiment
    p.add_argument("--expt_name", type=str, default="debug")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--gnn", type=str, default="gcn", choices=["gcn", "sage"])
    p.add_argument(
        "--training",
        type=str,
        default="supervised",
        choices=["supervised", "kd", "fitnet", "at", "gpw", "lpw", "nce", "gcd",
                 "nce-labels", "nce-edges", "nce-labels-edges"],
    )
    p.add_argument("--kd_and_aux", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--log_steps", type=int, default=50)
    # GNN
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--hidden_channels", type=int, default=256)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=0.01)
    # KD
    p.add_argument("--alpha", type=float, default=0.9)
    p.add_argument("--kd_T", type=float, default=4.0)
    p.add_argument("--kd_reduction", type=str, default="numel",
                   choices=["numel", "batchmean"],
                   help="'numel' = reference F.kl_div('mean') parity "
                        "(KL/(N*C)); 'batchmean' = standard Hinton scaling")
    p.add_argument("--beta", type=float, default=1000.0)
    p.add_argument("--kernel", type=str, default="cosine",
                   choices=["cosine", "poly", "l2", "rbf"])
    p.add_argument("--max_samples", type=int, default=8192)
    p.add_argument("--proj_dim", type=int, default=256)
    p.add_argument("--nce_T", type=float, default=0.075)
    # teacher artifacts
    p.add_argument("--teacher_dir", type=str, default=None,
                   help="directory of per-seed teacher .npz dumps")
    p.add_argument("--data_root", type=str, default="dataset",
                   help="OGB cache root for --dataset ogbn-arxiv")
    # synthetic dataset sizing
    p.add_argument("--num_nodes", type=int, default=20000)
    p.add_argument("--num_edges", type=int, default=120000)
    p.add_argument("--signal", type=float, default=0.8)
    p.add_argument("--label_noise", type=float, default=0.0)
    p.add_argument("--feat_sparse", type=float, default=0.0)
    p.add_argument("--n_super", type=int, default=0)
    p.add_argument("--sub_scale", type=float, default=0.4)
    p.add_argument("--train_frac", type=float, default=0.54)
    p.add_argument("--epoch_chunk", type=int, default=50,
                   help="epochs per chunk (one host synchronisation per chunk)")
    p.add_argument("--out_dir", type=str, default="logs")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save the training state every N epochs (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume each run from its checkpoint if present")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform override of the JAX CLI; the port takes "
                        "--device instead")
    return p


def _check_args(args) -> None:
    if args.platform is not None:
        raise ValueError("--platform selects a JAX platform; use --device")
    if args.dataset not in ("synthetic", "ogbn-arxiv"):
        raise ValueError(f"--dataset must be synthetic or ogbn-arxiv, got {args.dataset!r}")


def load_dataset(args):
    if args.dataset == "ogbn-arxiv":
        from efficient_gnns_tpu_torch.data.ogb import load_ogbn_arxiv

        return load_ogbn_arxiv(root=args.data_root)
    from efficient_gnns_tpu_torch.data import synthetic_node_dataset

    return synthetic_node_dataset(
        num_nodes=args.num_nodes, num_edges=args.num_edges, seed=42,
        signal=args.signal, label_noise=args.label_noise,
        feat_sparse=args.feat_sparse, train_frac=args.train_frac,
        n_super=args.n_super, sub_scale=args.sub_scale,
    )


def oracle_teacher_logits(y: np.ndarray, num_classes: int) -> np.ndarray:
    """Stand-in teacher for synthetic runs without dumps: 4 on the true
    class, -2 elsewhere (the JAX CLI's oracle-teacher logits)."""
    tl = np.full((len(y), num_classes), -2.0, np.float32)
    tl[np.arange(len(y)), y] = 4.0
    return tl


def oracle_teacher_features(y: np.ndarray, num_classes: int) -> np.ndarray:
    """The oracle teacher's 64-d features: a class prototype plus noise, from
    the JAX CLI's NumPy stream (seed 7)."""
    rng = np.random.default_rng(7)
    protos = rng.normal(size=(num_classes, 64)).astype(np.float32)
    return protos[y] + 0.2 * rng.normal(size=(len(y), 64)).astype(np.float32)


def main(argv=None) -> dict:
    """Run the CLI; returns what it writes to the JSON file."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    import torch

    from efficient_gnns_tpu_torch.distill import load_teacher_dump
    from efficient_gnns_tpu_torch.graphs import induced_subgraph
    from efficient_gnns_tpu_torch.models import GCN, SAGE
    from efficient_gnns_tpu_torch.train import (
        DistillConfig,
        Logger,
        MetricsWriter,
        NodeDistillTrainer,
    )

    cfg = DistillConfig(
        training=args.training,
        kd_and_aux=args.kd_and_aux,
        runs=args.runs,
        epochs=args.epochs,
        num_layers=args.num_layers,
        hidden=args.hidden_channels,
        dropout=args.dropout,
        lr=args.lr,
        alpha=args.alpha,
        kd_T=args.kd_T,
        kd_reduction=args.kd_reduction,
        beta=args.beta,
        kernel=args.kernel,
        max_samples=args.max_samples,
        proj_dim=args.proj_dim,
        nce_T=args.nce_T,
    )
    device = torch.device(args.device)
    ds = load_dataset(args)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device))
    print(
        f"dataset={args.dataset} nodes={ds.num_nodes} "
        f"edges={ds.graph.n_edge} classes={ds.num_classes} "
        f"device={device_name}"
    )
    graph = ds.graph.to(device)  # once, shared by every run
    lsp_graph = None
    if cfg.needs_train_subgraph():
        lsp_graph = induced_subgraph(
            ds.senders, ds.receivers, ds.split_idx["train"]).to(device)

    logger = Logger(args.runs)
    results = []
    # kd_and_aux is part of the experiment's identity, so composed runs do
    # not collide with the plain mode
    mode = ("kd+" if args.kd_and_aux else "") + args.training
    for run in range(args.runs):
        seed = args.seed + run
        teacher_feat = teacher_logits = None
        if cfg.needs_teacher() and args.teacher_dir:
            teacher_feat, teacher_logits = load_teacher_dump(args.teacher_dir, seed)
        elif cfg.needs_teacher():
            teacher_feat = oracle_teacher_features(ds.y, ds.num_classes)
            teacher_logits = oracle_teacher_logits(ds.y, ds.num_classes)
        model_cls = GCN if args.gnn == "gcn" else SAGE
        model = model_cls(
            ds.x.shape[1], cfg.hidden, ds.num_classes, cfg.num_layers,
            dropout=cfg.dropout, seed=seed, device=device,
        )
        trainer = NodeDistillTrainer(
            model, cfg, graph, ds.x, ds.y, ds.split_idx,
            teacher_feat=teacher_feat, teacher_logits=teacher_logits,
            lsp_graph=lsp_graph, seed=seed, device=device,
        )
        run_dir = os.path.join(
            args.out_dir, args.expt_name, f"{args.gnn}-{mode}", f"seed{seed}",
        )
        writer = MetricsWriter(run_dir, tensorboard=args.tensorboard)
        ckpt_path = os.path.join(run_dir, "checkpoint.pt")
        start_epoch = 1
        if args.resume and os.path.exists(ckpt_path):
            start_epoch = trainer.restore_checkpoint(ckpt_path) + 1
            print(f"Run {run + 1:02d}: resumed from {ckpt_path} at epoch {start_epoch}")
        t0 = time.time()
        epoch = start_epoch
        while epoch <= args.epochs:
            k = min(args.epoch_chunk, args.epochs - epoch + 1)
            hist = trainer.run_epochs(epoch, k)
            for i in range(k):
                ep = epoch + i
                loss, loss_cls, loss_aux, a_tr, a_va, a_te = hist[i]
                accs = (float(a_tr), float(a_va), float(a_te))
                logger.add_result(run, accs)
                writer.write(ep, {
                    "loss/train": float(loss),
                    "loss/cls": float(loss_cls),
                    "loss/aux": float(loss_aux),
                    "acc/train": accs[0],
                    "acc/valid": accs[1],
                    "acc/test": accs[2],
                })
                if ep % args.log_steps == 0 or ep == args.epochs:
                    print(
                        f"Run {run + 1:02d} Epoch {ep:04d} "
                        f"avg-epoch {(time.time() - t0) / (ep - start_epoch + 1):.3f}s "
                        f"loss {float(loss):.4f} (cls {float(loss_cls):.4f}, "
                        f"aux {float(loss_aux):.4f}) "
                        f"train/val/test {accs[0]:.4f}/{accs[1]:.4f}/{accs[2]:.4f}",
                        flush=True,
                    )
            prev_done = epoch - 1
            epoch += k
            # save whenever this chunk crossed a multiple of checkpoint_every:
            # the chunk size and the cadence need not be aligned
            if args.checkpoint_every and (
                    (epoch - 1) // args.checkpoint_every > prev_done // args.checkpoint_every):
                trainer.save_checkpoint(ckpt_path)
        if args.checkpoint_every:
            trainer.save_checkpoint(ckpt_path)
        writer.close()
        logger.print_statistics(run)
        results.append(
            {"run": run, "seconds": time.time() - t0, **logger.run_statistics(run)}
        )

    logger.print_statistics()
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"{args.expt_name}-{args.gnn}-{mode}.json")
    summary = {"args": vars(args), "runs": results,
               "statistics": logger.statistics()}
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {out}")
    return summary


if __name__ == "__main__":
    main()
