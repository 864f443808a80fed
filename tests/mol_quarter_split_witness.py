"""The GIN-E teacher of ``chip_smoke.py``'s molhiv slice on the CPU, in the
port and in the JAX package: ``cli.mol``'s defaults at 300 x 5 with the
virtual node (dropout 0.5, Adam 1e-3, batch 32) on the synthetic set at the
slice's counts (8,225 / 4,113 / 4,113 molecules, seed 42). After each epoch
it prints the ROC-AUC of the three splits and the spread of the valid and
test scores, so that the card's accuracy after a quarter-split epoch can be
read against both packages. The two draw their dropout masks from other
generators, so their numbers agree in kind, not in bits.

Not collected by pytest (a few minutes on the CPU). Run from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/mol_quarter_split_witness.py \
        [--epochs 2] [--which port,jax]
"""

import argparse
import time

import numpy as np

COUNTS = dict(n_train=8225, n_valid=4113, n_test=4113, seed=42)
SPLITS = ("train", "valid", "test")


def _spread(tag, split, s):
    print(f"{tag} {split} scores: mean {s.mean():.6g} std {s.std():.6g} "
          f"min {s.min():.6g} max {s.max():.6g}", flush=True)


def run_port(epochs):
    import torch

    from efficient_gnns_tpu_torch.data.molhiv import synthetic_molhiv_dataset
    from efficient_gnns_tpu_torch.models.mol import MolGNN
    from efficient_gnns_tpu_torch.train import DistillConfig, MolTrainer

    ds = synthetic_molhiv_dataset(**COUNTS)
    model = MolGNN("gine", 300, 1, 5, dropout=0.5, virtual_node=True,
                   pna_delta=ds.mean_log_degree, pna_towers=4, seed=0, device="cpu")
    tr = MolTrainer(DistillConfig(training="supervised", hidden=300, num_layers=5,
                                  dropout=0.5, lr=0.001), ds, model, seed=0, device="cpu")
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        loss = tr.train_epoch(epoch)["loss"]
        print(f"port epoch {epoch}: loss {loss:.6f} train {time.time() - t0:.1f} s "
              f"({torch.get_num_threads()} threads); ROC-AUC train/valid/test "
              f"{tr.evaluate_all()}", flush=True)
        for split in SPLITS[1:]:
            _spread("port", split, tr.scores(split)[0])


def run_jax(epochs):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from efficient_gnns_tpu.data.molhiv import synthetic_molhiv_dataset
    from efficient_gnns_tpu.models.mol import MolGNN
    from efficient_gnns_tpu.train import DistillConfig
    from efficient_gnns_tpu.train.mol_trainer import MolTrainer

    ds = synthetic_molhiv_dataset(**COUNTS)
    model = MolGNN(conv="gine", hidden=300, num_tasks=1, num_layers=5, dropout=0.5,
                   virtual_node=True, pna_delta=ds.mean_log_degree, pna_towers=4)
    tr = MolTrainer(DistillConfig(training="supervised", hidden=300, num_layers=5,
                                  dropout=0.5, lr=0.001), ds, model, batch_size=32, seed=0)
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        loss = tr.train_epoch(epoch)["loss"]
        print(f"jax epoch {epoch}: loss {loss:.6f} train {time.time() - t0:.1f} s; ROC-AUC "
              f"train/valid/test {tr.evaluate_all()}", flush=True)
        for split in SPLITS[1:]:
            scores = []
            for batch, atoms, bonds, _ in tr.eval_batchers[split].epoch(0):
                s = np.asarray(tr._eval_step(tr.state.params, tr.state.batch_stats, batch,
                                             jnp.asarray(atoms), jnp.asarray(bonds)))
                scores.append(s[np.asarray(batch.graph_mask)])
            _spread("jax", split, np.concatenate(scores))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--which", type=str, default="port,jax")
    args = p.parse_args()
    for which in args.which.split(","):
        {"port": run_port, "jax": run_jax}[which](args.epochs)


if __name__ == "__main__":
    main()
