"""PPI distillation CLI (counterpart of ``efficient_gnns_tpu/cli/ppi.py``):
the student flags of the reference's ``ppi_pyg/gnn.py`` and teacher training
(``ppi_pyg/train_teacher.py``) with ``--train_teacher``, plus ``--device``:

    python -m efficient_gnns_tpu_torch.cli.ppi --train_teacher --dataset ppi \\
        --data_root dataset/ppi --expt_name t --device cuda
    python -m efficient_gnns_tpu_torch.cli.ppi --training kd --dataset ppi \\
        --data_root dataset/ppi --teacher_path logs/ppi_teacher/t --device cuda

``--dataset synthetic`` is ``synthetic_ppi_dataset(seed=42)`` at its
defaults; any other value reads the torch-geometric raw files under
``--data_root`` (``data/ppi.py``; nothing is downloaded). ``--gnn teacher``
and ``student`` are TeacherNet and StudentNet; ``gat``, ``gcn`` and
``sage`` all build ``PPIGAT(hidden_channels, num_layers, heads)``, as the
JAX CLI does. ``--train_teacher`` saves the best-validation teacher's
``state_dict`` as ``<out_dir>/ppi_teacher/<expt_name>/seed<seed>/
checkpoint.pt``; a student's ``--teacher_path <dir>`` reads
``<dir>/seed<seed>/checkpoint.pt`` (without it the teacher keeps random
weights, as in the JAX CLI). The command writes
``<out_dir>/ppi-<expt_name>-<tag>.json`` (args, per-run seconds, losses and
statistics, across-run statistics) and returns it.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("PPI distillation (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--expt_name", type=str, default="debug")
    p.add_argument("--train_teacher", action="store_true")
    p.add_argument("--gnn", type=str, default="student",
                   choices=["teacher", "student", "gat", "gcn", "sage"])
    p.add_argument("--training", type=str, default="supervised",
                   choices=["supervised", "kd", "fitnet", "at", "gpw", "lpw", "nce"])
    p.add_argument("--kd_and_aux", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--hidden_channels", type=int, default=68)
    p.add_argument("--num_layers", type=int, default=5)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--kd_T", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=100.0)
    p.add_argument("--kernel", type=str, default="cosine")
    p.add_argument("--max_samples", type=int, default=8192)
    p.add_argument("--proj_dim", type=int, default=128)
    p.add_argument("--nce_T", type=float, default=0.075)
    p.add_argument("--teacher_path", type=str, default=None)
    p.add_argument("--data_root", type=str, default="dataset/ppi",
                   help="torch-geometric PPI raw files for any --dataset but synthetic "
                        "({train,valid,test}_{graph.json,feats.npy,...})")
    p.add_argument("--out_dir", type=str, default="logs")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform override of the JAX CLI; the port takes "
                        "--device instead")
    return p


def teacher_checkpoint_path(root: str, expt_name: str, seed: int) -> str:
    """Where ``--train_teacher`` saves the teacher of ``seed``."""
    return os.path.join(root, "ppi_teacher", expt_name, f"seed{seed}", "checkpoint.pt")


def main(argv=None) -> dict:
    """Run the CLI; returns what it writes to the JSON file."""
    args = build_parser().parse_args(argv)
    if args.platform is not None:
        raise ValueError("--platform selects a JAX platform; use --device")
    import torch

    from efficient_gnns_tpu_torch.data import load_ppi, synthetic_ppi_dataset
    from efficient_gnns_tpu_torch.models import PPIGAT, ppi_student, ppi_teacher
    from efficient_gnns_tpu_torch.train import DistillConfig, Logger, PPITrainer
    from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    ds = (synthetic_ppi_dataset(seed=42) if args.dataset == "synthetic"
          else load_ppi(args.data_root))
    device = torch.device(args.device)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device))
    g0 = ds.train[0].graph
    print(f"dataset={args.dataset} graphs={len(ds.train)}/{len(ds.valid)}/{len(ds.test)} "
          f"padded nodes={g0.num_nodes} edges={g0.num_edges_padded} "
          f"features={ds.feat_dim} labels={ds.num_labels} device={device_name}", flush=True)

    def make_model(kind, seed):
        if kind == "teacher":
            return ppi_teacher(ds.feat_dim, ds.num_labels, seed=seed, device=device)
        if kind == "student":
            return ppi_student(ds.feat_dim, ds.num_labels, seed=seed, device=device)
        return PPIGAT(ds.feat_dim, args.hidden_channels, ds.num_labels, args.num_layers,
                      heads=args.heads, seed=seed, device=device)

    cfg = DistillConfig(
        training="supervised" if args.train_teacher else args.training,
        kd_and_aux=args.kd_and_aux, lr=args.lr, alpha=args.alpha, kd_T=args.kd_T,
        beta=args.beta, kernel=args.kernel, max_samples=args.max_samples,
        proj_dim=args.proj_dim, nce_T=args.nce_T,
    )
    logger = Logger(args.runs)
    results = []
    for run in range(args.runs):
        seed = args.seed + run
        teacher = None
        if args.train_teacher:
            model = make_model("teacher", seed)
        else:
            model = make_model(args.gnn, seed)
            if cfg.needs_teacher():
                teacher = make_model("teacher", seed + 4242)
                if args.teacher_path:
                    teacher.load_state_dict(load_checkpoint(
                        os.path.join(args.teacher_path, f"seed{seed}", "checkpoint.pt"),
                        map_location=device))
        trainer = PPITrainer(cfg, ds, model, teacher=teacher, teacher_feat_dim=1024,
                             seed=seed, device=device)
        best_val, losses, f1s_by_epoch = 0.0, [], []
        t0 = time.time()
        for epoch in range(1, args.epochs + 1):
            m = trainer.train_epoch(epoch)
            f1s = trainer.evaluate_all()
            logger.add_result(run, f1s)
            losses.append(m["loss"])
            f1s_by_epoch.append(f1s)
            if f1s[1] > best_val:
                best_val = f1s[1]
                if args.train_teacher:
                    save_checkpoint(
                        teacher_checkpoint_path(args.out_dir, args.expt_name, seed),
                        trainer.model.state_dict())
            print(f"Run {run} Epoch {epoch} loss {m['loss']:.4f} "
                  f"F1 train/val/test {f1s[0]:.4f}/{f1s[1]:.4f}/{f1s[2]:.4f}", flush=True)
        logger.print_statistics(run)
        results.append({"run": run, "seed": seed, "seconds": time.time() - t0,
                        "losses": losses, "f1": f1s_by_epoch,
                        **logger.run_statistics(run)})
    logger.print_statistics()

    os.makedirs(args.out_dir, exist_ok=True)
    tag = "teacher" if args.train_teacher else f"{args.gnn}-{args.training}"
    summary = {"args": vars(args), "runs": results, "statistics": logger.statistics()}
    with open(os.path.join(args.out_dir, f"ppi-{args.expt_name}-{tag}.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
