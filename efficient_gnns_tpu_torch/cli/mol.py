"""ogbg-molhiv graph-classification CLI (counterpart of
``efficient_gnns_tpu/cli/mol.py``: the same flags and defaults), plus
``--device``:

    python -m efficient_gnns_tpu_torch.cli.mol --dataset ogbg-molhiv \\
        --data_root dataset --gnn gine --hidden_channels 300 --num_layers 5 \\
        --expt_name t --device cuda
    python -m efficient_gnns_tpu_torch.cli.mol --dataset ogbg-molhiv \\
        --data_root dataset --training kd --teacher_gnn gine \\
        --teacher_path logs/mol_ckpt/t/gine --device cuda

``--dataset synthetic`` is ``synthetic_molhiv_dataset(n_train, n_valid,
n_test, seed=42)``; any other value reads OGB's raw cache under
``--data_root`` (``data/molhiv.py``; nothing is downloaded). ``gine`` models
carry the virtual node (so a ``gine`` run's checkpoint loads as the
teacher), with OGB ``gin-virtual``'s BatchNorms in its MLP under
``--virtual_node_norm`` (the teacher takes the same flag), PNA has 4 towers
and the dataset's mean log degree as ``delta``. ``--max_atoms`` sets the
batch budget (``MolBatcher``).
Each run saves its model's ``state_dict`` whenever the validation ROC-AUC
improves, as ``<out_dir>/mol_ckpt/<expt_name>/<gnn>/seed<seed>.pt``
(``torch.save``); ``--teacher_path <dir>`` reads ``<dir>/seed<seed>.pt``
(without it the teacher keeps random weights, as in the JAX CLI). The
command writes ``<out_dir>/mol-<expt_name>-<tag>.json`` (the JAX CLI's tag;
args, statistics, and each run's seconds an epoch: the train steps and the
evaluation of ``MolTrainer.run_epochs``, one host copy an epoch) and returns
it with the per-run losses and AUCs of every epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("molhiv distillation (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--expt_name", type=str, default="debug")
    p.add_argument("--gnn", type=str, default="gcn", choices=["gcn", "gin", "gine", "pna"])
    p.add_argument("--teacher_gnn", type=str, default="gine", choices=["gine", "pna"])
    p.add_argument("--training", type=str, default="supervised",
                   choices=["supervised", "kd", "fitnet", "at", "gpw", "nce"])
    p.add_argument("--kd_and_aux", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden_channels", type=int, default=64)
    p.add_argument("--teacher_hidden", type=int, default=300)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--teacher_layers", type=int, default=5)
    p.add_argument("--virtual_node_norm", action="store_true",
                   help="OGB gin-virtual's two BatchNorms in the virtual node's MLP of a gine "
                        "model and teacher (off: the JAX module's MLP)")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_atoms", type=int, default=32,
                   help="atoms a molecule in the batch budget (batch_size * max_atoms node "
                        "rows, three edges an atom); a batch past it is padded to its own size")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--kd_T", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.5)
    p.add_argument("--kernel", type=str, default="cosine")
    p.add_argument("--max_samples", type=int, default=8192)
    p.add_argument("--proj_dim", type=int, default=64)
    p.add_argument("--nce_T", type=float, default=0.075)
    p.add_argument("--teacher_path", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="logs")
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--n_valid", type=int, default=250)
    p.add_argument("--n_test", type=int, default=250)
    p.add_argument("--data_root", type=str, default="dataset",
                   help="OGB raw cache of ogbg-molhiv for any --dataset but synthetic "
                        "(ogbg_molhiv/raw + split/scaffold)")
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform override of the JAX CLI; the port takes --device")
    return p


def checkpoint_path(root: str, expt_name: str, gnn: str, seed: int) -> str:
    """Where a run of ``gnn`` saves its best-validation model of ``seed``."""
    return os.path.join(root, "mol_ckpt", expt_name, gnn, f"seed{seed}.pt")


def result_tag(args) -> str:
    """The JSON file's tag, as the JAX CLI forms it."""
    tag = f"{args.gnn}-{args.training}"
    if args.training != "supervised" or args.kd_and_aux:  # the run has a teacher
        tag += f"-from-{args.teacher_gnn}"  # two teachers share student modes
    if args.kd_and_aux:
        tag = tag.replace(f"-{args.training}-", f"-kd+{args.training}-")
    return tag


def main(argv=None) -> dict:
    """Run the CLI; returns what it writes to the JSON file with ``losses``
    and ``aucs`` (per run, per epoch)."""
    args = build_parser().parse_args(argv)
    if args.platform is not None:
        raise ValueError("--platform selects a JAX platform; use --device")
    import torch

    from efficient_gnns_tpu_torch.data.molhiv import load_molhiv, synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models.mol import MolGNN
    from efficient_gnns_tpu_torch.train import DistillConfig, Logger, MolTrainer
    from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    device = torch.device(args.device)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device))
    if args.dataset == "synthetic":
        ds = synthetic_molhiv_dataset(n_train=args.n_train, n_valid=args.n_valid,
                                      n_test=args.n_test, seed=42)
    else:
        ds = load_molhiv(args.data_root)
    print(f"dataset={args.dataset} molecules={len(ds.train)}/{len(ds.valid)}/{len(ds.test)} "
          f"mean_log_degree={ds.mean_log_degree:.4f} device={device_name}", flush=True)

    cfg = DistillConfig(
        training=args.training, kd_and_aux=args.kd_and_aux, hidden=args.hidden_channels,
        num_layers=args.num_layers, dropout=args.dropout, lr=args.lr, alpha=args.alpha,
        kd_T=args.kd_T, beta=args.beta, kernel=args.kernel, max_samples=args.max_samples,
        proj_dim=args.proj_dim, nce_T=args.nce_T,
    )
    logger = Logger(args.runs)
    seconds, losses, aucs = {}, {}, {}
    for run in range(args.runs):
        seed = args.seed + run
        student = MolGNN(args.gnn, args.hidden_channels, ds.num_tasks, args.num_layers,
                         dropout=args.dropout, virtual_node=(args.gnn == "gine"),
                         virtual_node_norm=args.virtual_node_norm,
                         pna_delta=ds.mean_log_degree, pna_towers=4, seed=seed, device=device)
        teacher = None
        if cfg.needs_teacher():
            teacher = MolGNN(args.teacher_gnn, args.teacher_hidden, ds.num_tasks,
                             args.teacher_layers, virtual_node=(args.teacher_gnn == "gine"),
                             virtual_node_norm=args.virtual_node_norm,
                             pna_delta=ds.mean_log_degree, pna_towers=4, seed=seed + 4242,
                             device=device)
            if args.teacher_path:
                teacher.load_state_dict(load_checkpoint(
                    os.path.join(args.teacher_path, f"seed{seed}.pt"), map_location=device))
        tr = MolTrainer(cfg, ds, student, teacher=teacher, batch_size=args.batch_size,
                        max_atoms=args.max_atoms, seed=seed, device=device)
        if run == 0:
            print(f"batches of {args.batch_size}: {tr.batcher.node_budget} nodes, "
                  f"{tr.batcher.edge_budget} edges; {len(tr.batcher)} train batches",
                  flush=True)
        best_val, run_secs, run_losses, run_aucs = -1.0, [], [], []
        for epoch in range(1, args.epochs + 1):
            t0 = time.time()
            row = tr.run_epochs(epoch, 1)[0]  # one host copy an epoch: the best is saved
            secs = time.time() - t0
            loss, epoch_aucs = float(row[0]), tuple(float(a) for a in row[1:4])
            run_secs.append({"epoch": secs})
            logger.add_result(run, epoch_aucs)
            run_losses.append(loss)
            run_aucs.append(epoch_aucs)
            if epoch_aucs[1] > best_val:
                best_val = epoch_aucs[1]
                save_checkpoint(checkpoint_path(args.out_dir, args.expt_name, args.gnn, seed),
                                tr.model.state_dict())
            print(f"Run {run} Epoch {epoch} loss {loss:.4f} {secs:.2f}s AUC train/val/test "
                  f"{epoch_aucs[0]:.4f}/{epoch_aucs[1]:.4f}/{epoch_aucs[2]:.4f}", flush=True)
        logger.print_statistics(run)
        seconds[f"run{run}"] = run_secs
        losses[f"run{run}"] = run_losses
        aucs[f"run{run}"] = run_aucs
    logger.print_statistics()

    os.makedirs(args.out_dir, exist_ok=True)
    summary = {"args": vars(args), "statistics": logger.statistics(), "seconds": seconds}
    with open(os.path.join(args.out_dir, f"mol-{args.expt_name}-{result_tag(args)}.json"),
              "w") as f:
        json.dump(summary, f)
    return {**summary, "losses": losses, "aucs": aucs}


if __name__ == "__main__":
    main()
