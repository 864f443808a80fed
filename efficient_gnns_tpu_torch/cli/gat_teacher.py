"""GAT teacher training CLI (counterpart of ``efficient_gnns_tpu/cli/gat_teacher.py``),
with the same flags plus ``--device``:

    python -m efficient_gnns_tpu_torch.cli.gat_teacher --use-labels \\
        --n-label-iters 1 --use-norm --edge-drop 0.3 --input-drop 0.25 \\
        --save-pred --expt-name gat-3L250x3h --device cuda

``--save-pred`` writes each seed's dump (softmax output, logits, penultimate
features) in the ``.npz`` format of ``distill/artifacts.py`` under
``<out-dir>/teacher_dumps/<expt-name>/``, which the student CLI reads with
``--teacher_dir``, and the best-validation weights (the model's
``state_dict``, ``train/checkpoint.py``) as
``<out-dir>/checkpoints/<expt-name>/<seed>.pt``. The command writes
``<out-dir>/gat_teacher_<expt-name>.json``.

The graph is built unweighted with the hub partition (``hub_dense="auto"``),
as the JAX CLI builds it: with ``--no-attn-dst`` the teacher then takes the
hub attention path (``ops/hub_attention.py``) on graphs of 200k edges or
more, and the exact edge softmax below that. ``--dataset ogbn-arxiv`` reads
the OGB raw cache under ``--data-root`` (``data/ogb.py``) into the same kind
of graph.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("GAT teacher on ogbn-arxiv (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-runs", type=int, default=10)
    p.add_argument("--n-epochs", type=int, default=2000)
    p.add_argument("--use-labels", action="store_true")
    p.add_argument("--n-label-iters", type=int, default=0)
    p.add_argument("--mask-rate", type=float, default=0.5)
    p.add_argument("--no-attn-dst", action="store_true")
    p.add_argument("--use-norm", action="store_true")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--n-layers", type=int, default=3)
    p.add_argument("--n-heads", type=int, default=3)
    p.add_argument("--n-hidden", type=int, default=250)
    p.add_argument("--dropout", type=float, default=0.75)
    p.add_argument("--input-drop", type=float, default=0.1)
    p.add_argument("--attn-drop", type=float, default=0.0)
    p.add_argument("--edge-drop", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--epoch-chunk", type=int, default=50,
                   help="epochs per chunk (one host synchronisation per chunk; "
                        "evaluation and best-val selection still run every epoch)")
    p.add_argument("--save-pred", action="store_true")
    p.add_argument("--dump-labels", type=str, default="train",
                   choices=["train", "self"],
                   help="label-reuse channel for the dump forward: 'train' = "
                        "reference semantics (true train labels fed), 'self' = "
                        "zeroed channel + self-predicted label iterations")
    p.add_argument("--expt-name", type=str, default="debug")
    p.add_argument("--out-dir", type=str, default=".")
    # synthetic sizing
    p.add_argument("--num-nodes", type=int, default=20000)
    p.add_argument("--num-edges", type=int, default=120000)
    p.add_argument("--signal", type=float, default=0.8)
    p.add_argument("--label-noise", type=float, default=0.0)
    p.add_argument("--feat-sparse", type=float, default=0.0)
    p.add_argument("--train-frac", type=float, default=0.54)
    p.add_argument("--n-super", type=int, default=0)
    p.add_argument("--sub-scale", type=float, default=0.4)
    p.add_argument("--data-root", type=str, default="dataset")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform override of the JAX CLI; the port takes "
                        "--device instead")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns what it writes to the JSON file."""
    args = build_parser().parse_args(argv)
    if args.platform is not None:
        raise ValueError("--platform selects a JAX platform; use --device")
    if args.dataset not in ("synthetic", "ogbn-arxiv"):
        raise ValueError(f"--dataset must be synthetic or ogbn-arxiv, got {args.dataset!r}")
    if not args.use_labels and args.n_label_iters > 0:
        raise ValueError("'--use-labels' must be enabled when n_label_iters > 0")

    import torch

    from efficient_gnns_tpu_torch.data import load_ogbn_arxiv, synthetic_node_dataset
    from efficient_gnns_tpu_torch.distill import save_teacher_dump
    from efficient_gnns_tpu_torch.train import GATTeacherTrainer, TeacherConfig
    from efficient_gnns_tpu_torch.train.checkpoint import save_checkpoint

    # unweighted with the hub partition, as the JAX CLI builds it
    if args.dataset == "ogbn-arxiv":
        ds = load_ogbn_arxiv(root=args.data_root, hub_dense="auto", gcn_norm=False)
    else:
        ds = synthetic_node_dataset(
            num_nodes=args.num_nodes, num_edges=args.num_edges, seed=42,
            hub_dense="auto", gcn_norm=False, signal=args.signal,
            label_noise=args.label_noise, feat_sparse=args.feat_sparse,
            train_frac=args.train_frac, n_super=args.n_super, sub_scale=args.sub_scale,
        )
    cfg = TeacherConfig(
        n_hidden=args.n_hidden, n_layers=args.n_layers, n_heads=args.n_heads,
        dropout=args.dropout, input_drop=args.input_drop,
        attn_drop=args.attn_drop, edge_drop=args.edge_drop,
        use_labels=args.use_labels, n_label_iters=args.n_label_iters,
        mask_rate=args.mask_rate, no_attn_dst=args.no_attn_dst,
        use_norm=args.use_norm, lr=args.lr, wd=args.wd, n_epochs=args.n_epochs,
    )
    device = torch.device(args.device)
    graph = ds.graph.to(device)  # once, shared by every run

    val_accs, test_accs, runs = [], [], []
    for run in range(args.n_runs):
        seed = args.seed + run
        trainer = GATTeacherTrainer(cfg, graph, ds.x, ds.y, ds.split_idx,
                                    ds.num_classes, seed=seed, device=device)
        if run == 0:
            name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else str(device))
            print(f"params: {trainer.num_params()}  device: {name}  "
                  f"nodes={ds.num_nodes} edges={ds.graph.n_edge}", flush=True)
        best = trainer.init_best()
        losses = []
        t0 = time.time()
        epoch = 1
        while epoch <= args.n_epochs:
            k = min(args.epoch_chunk, args.n_epochs - epoch + 1)
            best, hist = trainer.run_epochs(epoch, k, best)
            losses += hist[:, 0].tolist()
            done = epoch + k - 1
            for i in range(k):
                ep = epoch + i
                if ep % args.log_every != 0 and ep != args.n_epochs:
                    continue
                h = hist[i]
                print(
                    f"Run {run}/{args.n_runs} Epoch {ep}/{args.n_epochs} "
                    f"avg-epoch {(time.time() - t0) / done:.2f}s "
                    f"loss {h[0]:.4f} "
                    f"train/val/test {h[2]:.4f}/{h[3]:.4f}/{h[4]:.4f} "
                    f"best-val {float(best['val_acc']):.4f} "
                    f"final-test {float(best['test_acc']):.4f}",
                    flush=True,
                )
            epoch += k
        seconds = time.time() - t0
        val_accs.append(float(best["val_acc"]))
        test_accs.append(float(best["test_acc"]))
        runs.append({"run": run, "seed": seed, "seconds": seconds,
                     "losses": losses})

        if args.save_pred:
            if args.dump_labels == "train":
                logits, feats = best["logits"], best["feats"]
            else:
                logits, feats = trainer.dump_outputs(best, args.dump_labels)
            dump_dir = os.path.join(args.out_dir, "teacher_dumps", args.expt_name)
            save_teacher_dump(dump_dir, seed, feats.cpu().numpy(), logits.cpu().numpy(),
                              torch.softmax(logits, -1).cpu().numpy())
            ckpt_dir = os.path.join(args.out_dir, "checkpoints", args.expt_name)
            save_checkpoint(os.path.join(ckpt_dir, f"{seed}.pt"), best["state"])
            print(f"saved teacher dump ({args.dump_labels} labels) + "
                  f"best-val checkpoint for seed {seed}", flush=True)

    print(f"Average val accuracy: {np.mean(val_accs)} ± {np.std(val_accs)}")
    print(f"Average test accuracy: {np.mean(test_accs)} ± {np.std(test_accs)}")
    os.makedirs(args.out_dir, exist_ok=True)
    summary = {"args": vars(args), "val_accs": val_accs, "test_accs": test_accs,
               "runs": runs}
    with open(os.path.join(args.out_dir, f"gat_teacher_{args.expt_name}.json"), "w") as f:
        json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
