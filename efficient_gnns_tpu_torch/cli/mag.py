"""ogbn-mag R-GCN CLI (counterpart of ``efficient_gnns_tpu/cli/mag.py``, the
flags of the reference's ``mag_pyg/gnn.py:485-526``), plus ``--device`` and
``--data_root``:

    python -m efficient_gnns_tpu_torch.cli.mag --dataset ogbn-mag \\
        --data_root dataset --num_layers 3 --hidden_channels 512 \\
        --expt_name t --save_ckpt ckpt/t --device cuda
    python -m efficient_gnns_tpu_torch.cli.mag --dataset ogbn-mag \\
        --data_root dataset --training kd --teacher_path ckpt/t --device cuda

``--dataset synthetic`` is ``synthetic_mag_dataset(n_paper, seed=42)`` with
the difficulty flags; ``ogbn-mag`` reads OGB's raw cache under
``--data_root`` (``data/mag.py``; nothing is downloaded). ``--save_ckpt
<dir>`` writes each run's model ``state_dict`` as ``<dir>/seed<seed>.pt``
(``torch.save``), which ``--teacher_path <dir>`` reads (without it a
teacher keeps random weights, as in the JAX CLI). ``--time_steps N`` times
N chained train steps on one resident subgraph after training, ending in
one host read: the device's step time without the sampler. The first line
printed names the GraphSAINT walker (``native`` or ``numpy``). The command
writes ``<out_dir>/mag-<expt_name>-<training>.json`` (args, statistics,
per-run epoch seconds) and returns it with the per-run losses and
accuracies of every epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("R-GCN on ogbn-mag (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--expt_name", type=str, default="debug")
    p.add_argument("--training", type=str, default="supervised",
                   choices=["supervised", "kd", "fitnet", "at", "gpw", "lpw", "nce"])
    p.add_argument("--kd_and_aux", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--hidden_channels", type=int, default=32)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=20000)
    p.add_argument("--num_steps", type=int, default=30)
    p.add_argument("--alpha", type=float, default=0.9)
    p.add_argument("--kd_T", type=float, default=4.0)
    p.add_argument("--beta", type=float, default=100.0)
    p.add_argument("--kernel", type=str, default="cosine")
    p.add_argument("--max_samples", type=int, default=8192)
    p.add_argument("--proj_dim", type=int, default=128)
    p.add_argument("--nce_T", type=float, default=0.075)
    p.add_argument("--teacher_path", type=str, default=None)
    p.add_argument("--teacher_hidden", type=int, default=512)
    p.add_argument("--teacher_layers", type=int, default=3)
    p.add_argument("--out_dir", type=str, default="logs")
    p.add_argument("--time_steps", type=int, default=0,
                   help="after training, time N train steps on ONE resident sampled "
                        "subgraph: the device's step time, sampling and upload excluded")
    p.add_argument("--no_typed_square", action="store_true",
                   help="aggregate with R relation-masked passes instead of the typed "
                        "square layout (for step-time comparisons)")
    p.add_argument("--save_ckpt", type=str, default=None,
                   help="directory for per-seed model checkpoints (seed<k>.pt), "
                        "readable by --teacher_path")
    p.add_argument("--data_root", type=str, default="dataset",
                   help="OGB raw cache of ogbn-mag for --dataset ogbn-mag")
    # synthetic sizing and difficulty (data/mag.py)
    p.add_argument("--n_paper", type=int, default=4000)
    p.add_argument("--signal", type=float, default=0.8)
    p.add_argument("--label_noise", type=float, default=0.0)
    p.add_argument("--homophily", type=float, default=0.5)
    p.add_argument("--platform", type=str, default=None,
                   help="JAX platform override of the JAX CLI; the port takes --device")
    return p


def checkpoint_path(root: str, seed: int) -> str:
    """Where ``--save_ckpt root`` writes the model of ``seed``."""
    return os.path.join(root, f"seed{seed}.pt")


def main(argv=None) -> dict:
    """Run the CLI; returns what it writes to the JSON file with ``losses``
    and ``accuracies`` (per run, per epoch)."""
    args = build_parser().parse_args(argv)
    if args.platform is not None:
        raise ValueError("--platform selects a JAX platform; use --device")
    import torch

    from efficient_gnns_tpu_torch.data.mag import load_ogbn_mag, synthetic_mag_dataset
    from efficient_gnns_tpu_torch.native import host
    from efficient_gnns_tpu_torch.train import DistillConfig, Logger, MagTrainer
    from efficient_gnns_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    device = torch.device(args.device)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device))
    print(f"dataset={args.dataset} walker={host.walker()} device={device_name} "
          f"typed_square={not args.no_typed_square}", flush=True)
    if args.dataset == "synthetic":
        ds = synthetic_mag_dataset(n_paper=args.n_paper, seed=42, signal=args.signal,
                                   label_noise=args.label_noise, homophily=args.homophily)
    elif args.dataset == "ogbn-mag":
        ds = load_ogbn_mag(args.data_root)
    else:
        raise ValueError(f"--dataset must be synthetic or ogbn-mag, got {args.dataset!r}")

    cfg = DistillConfig(
        training=args.training, kd_and_aux=args.kd_and_aux, num_layers=args.num_layers,
        hidden=args.hidden_channels, dropout=args.dropout, lr=args.lr, alpha=args.alpha,
        kd_T=args.kd_T, beta=args.beta, kernel=args.kernel, max_samples=args.max_samples,
        proj_dim=args.proj_dim, nce_T=args.nce_T,
    )
    logger = Logger(args.runs)
    epoch_seconds, losses, accuracies = {}, {}, {}
    for run in range(args.runs):
        seed = args.seed + run
        teacher_state = None
        if cfg.needs_teacher() and args.teacher_path:
            teacher_state = load_checkpoint(checkpoint_path(args.teacher_path, seed),
                                            map_location=device)
        tr = MagTrainer(cfg, ds, batch_size=args.batch_size, num_steps=args.num_steps,
                        teacher_state=teacher_state, teacher_hidden=args.teacher_hidden,
                        teacher_layers=args.teacher_layers, seed=seed,
                        typed_square=not args.no_typed_square, device=device)
        if run == 0:
            print(f"params: {tr.num_params()}  nodes: {ds.grouped.node_type.shape[0]}  "
                  f"edges: {ds.grouped.edge_index.shape[1]}  node budget: "
                  f"{tr.sampler.node_budget}  edge budget: {tr.sampler.edge_budget}",
                  flush=True)
        epoch_secs, run_losses, run_accs = [], [], []
        try:
            for epoch in range(1, args.epochs + 1):
                t0 = time.time()
                m = tr.train_epoch(epoch)
                dt = time.time() - t0
                epoch_secs.append(dt)
                run_losses.append(m["loss"])
                accs = tr.evaluate()
                logger.add_result(run, accs)
                run_accs.append(accs)
                print(f"Run {run} Epoch {epoch} loss {m['loss']:.4f} epoch {dt:.2f}s "
                      f"({dt / args.num_steps * 1e3:.0f} ms/step) train/val/test "
                      f"{accs[0]:.4f}/{accs[1]:.4f}/{accs[2]:.4f}", flush=True)
            logger.print_statistics(run)
            if args.save_ckpt:  # before --time_steps, whose steps change the model
                save_checkpoint(checkpoint_path(args.save_ckpt, seed), tr.model.state_dict())
                print(f"saved checkpoint seed{seed}.pt -> {args.save_ckpt}", flush=True)
            if args.time_steps:
                ms = tr.device_step_ms(args.time_steps)
                print(f"device-only train step: {ms:.1f} ms "
                      f"(typed_square={not args.no_typed_square})", flush=True)
                epoch_secs.append({"device_step_ms": ms})
        finally:
            tr.close()
        epoch_seconds[f"run{run}"] = epoch_secs
        losses[f"run{run}"] = run_losses
        accuracies[f"run{run}"] = run_accs
    logger.print_statistics()

    os.makedirs(args.out_dir, exist_ok=True)
    summary = {"args": vars(args), "statistics": logger.statistics(),
               "epoch_seconds": epoch_seconds}
    with open(os.path.join(args.out_dir, f"mag-{args.expt_name}-{args.training}.json"),
              "w") as f:
        json.dump(summary, f)
    return {**summary, "losses": losses, "accuracies": accuracies}


if __name__ == "__main__":
    main()
