"""OGB ``gin-virtual`` on ogbg-molhiv, written out in plain PyTorch.

The model is ``GNN_node_Virtualnode`` with ``GINConv`` (OGB's
``examples/graphproppred/mol/conv.py``) under ``main_pyg.py --gnn
gin-virtual``: the atom encoder, then for each layer ``l``

1. ``h <- h + v[graph(i)]`` (``v``: one state a graph, zeros at the start);
2. ``z = MLP((1 + eps) h + sum_j ReLU(h_j + BondEnc_l(e_ij)))``, ``MLP =
   Linear(F, 2F) -> BN -> ReLU -> Linear(2F, F)``; ``h' = BN(z)``;
3. ReLU but on the last layer, dropout;
4. but on the last layer, ``v <- dropout(MLP_v(sum_{i in g} h_i + v))``,
   ``MLP_v = Linear(F, 2F) -> BN -> ReLU -> Linear(2F, F) -> BN -> ReLU``
   (the BatchNorms over the graphs of the batch);

then the mean pool, ``Linear(F, tasks)``, BCE with logits over the batch's
molecules and Adam. Every sum, gather and pool is a product with a dense 0/1
matrix of the batch (senders, receivers, graph membership), and each atom
and bond embedding a one-hot product, so nothing adds with atomics and a
reading repeats at one seed; with TF32 on (the control) they round as every
other product does.

Departures from OGB, each in the configuration file too:

* BatchNorm keeps the running variance of the batch without Bessel's
  correction, ``ra = 0.9 ra + 0.1 batch`` (flax's layer, which the program
  ports); ``torch.nn.BatchNorm1d`` keeps the unbiased one. Training-mode
  outputs are the same; evaluation differs by ``n / (n - 1)`` in the
  variance.
* The batch order is the trainer's (``default_rng(seed * 613 + epoch)``'s
  permutation of the train molecules in batches of ``batch_size``), and
  every dropout mask is drawn from the trainer's generator, seeded from
  ``(seed, epoch, step)``, in the model's order (each layer's node mask, then
  its virtual node's), over the program's padded shapes: ``batch_size``
  graph rows, and the batch's atoms padded to the node budget
  (``round_up(batch_size * max_atoms, 128)``) or, past it, to their count
  rounded up to 128. Only the rows of real atoms and molecules are used.
* The initial weights are the benchmark's, not OGB's defaults; linear
  weights are stored ``[in, out]``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench.reference import nn as R
from gnnbench.reference.train import _outputs, _split_state, matmul_precision

# ogb.utils.features.get_atom_feature_dims() / get_bond_feature_dims()
ATOM_DIMS = (119, 5, 12, 12, 10, 6, 6, 2, 2)
BOND_DIMS = (5, 6, 2)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The trainer's generator seed of one step: ``SeedSequence((seed,
    epoch, step))``'s first 32-bit word."""
    return int(np.random.SeedSequence([int(seed), int(epoch), int(step)]).generate_state(1)[0])


def padded_atoms(atoms: int, batch_size: int, max_atoms: int) -> int:
    """The rows the program pads a batch of ``atoms`` atoms to."""
    budget = -(-batch_size * max_atoms // 128) * 128
    return budget if atoms <= budget else -(-atoms // 128) * 128


class Batch:
    """The molecules of one batch as dense matrices on ``device``: ``send``
    ``[E, N]`` (row ``e`` picks its sender), ``recv`` ``[N, E]`` (row ``i``
    sums the edges into atom ``i``), ``member`` ``[G, N]`` (row ``g`` sums
    its molecule's atoms), the atom and bond features, labels and atom
    counts, and ``n_pad``, the program's rows for the dropout draws."""

    def __init__(self, mols: Sequence[tuple], n_pad: int, device):
        sizes = [m[2] for m in mols]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        n, g = int(offsets[-1]), len(mols)
        senders = np.concatenate([np.asarray(m[0]) + o for m, o in zip(mols, offsets)])
        receivers = np.concatenate([np.asarray(m[1]) + o for m, o in zip(mols, offsets)])
        e = len(senders)
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
        rows = torch.arange(e, device=device)
        self.send = torch.zeros(e, n, device=device)
        self.send[rows, t(senders)] = 1.0
        self.recv = torch.zeros(n, e, device=device)
        self.recv[t(receivers), rows] = 1.0
        self.member = torch.zeros(g, n, device=device)
        self.member[t(np.repeat(np.arange(g), sizes)), torch.arange(n, device=device)] = 1.0
        self.atoms = t(np.concatenate([m[3] for m in mols]))
        self.bonds = t(np.concatenate([m[4] for m in mols]))
        self.labels = torch.tensor([float(m[5]) for m in mols], device=device)
        self.counts = torch.tensor(sizes, dtype=torch.float32, device=device)
        self.n_pad = n_pad


def embed(idx: torch.Tensor, P: Dict[str, torch.Tensor], name: str, dims) -> torch.Tensor:
    """OGB's ``AtomEncoder`` / ``BondEncoder``: the sum over feature columns
    of each column's table row, as one-hot products."""
    out = 0.0
    for k, v in enumerate(dims):
        table = P[f"{name}.embs.{k}"]
        out = out + F.one_hot(idx[:, k], v).to(table.dtype) @ table
    return out


def batch_norm(x, P, S, name: str, training: bool):
    """BatchNorm over the rows of ``x`` (the real atoms or molecules)."""
    if training:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        with torch.no_grad():
            S[f"{name}.running_mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            S[f"{name}.running_var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    else:
        mean, var = S[f"{name}.running_mean"], S[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * P[f"{name}.scale"] + P[f"{name}.bias"]


def linear(x, P, name: str):
    return x @ P[f"{name}.weight"] + P[f"{name}.bias"]


def dropout(x, rate: float, gen, rows: int):
    """The program's mask over ``rows`` padded rows, of which ``x`` is the
    first ``x.shape[0]``."""
    u = torch.rand((rows, x.shape[1]), generator=gen, device=x.device)[: x.shape[0]]
    return torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x))


def forward(P, S, b: Batch, cfg: dict, gen, training: bool, keep: List = None):
    """Logits ``[G]`` of one batch; ``keep`` receives the first conv's output
    (before its BatchNorm) over the real atoms."""
    layers, rate, g_pad = cfg["num_layers"], cfg["dropout"], cfg["batch_size"]
    h = embed(b.atoms, P, "0.atom_encoder", ATOM_DIMS)
    v = P["0.virtualnode_emb"].expand(b.member.shape[0], -1)
    for i in range(layers):
        c = f"0.convs.{i}"
        h = h + b.member.t() @ v
        msg = torch.relu(b.send @ h + embed(b.bonds, P, f"0.bond_encoders.{i}", BOND_DIMS))
        z = (1.0 + P[f"{c}.eps"]) * h + b.recv @ msg
        z = torch.relu(batch_norm(linear(z, P, f"{c}.dense.0"), P, S, f"{c}.bn", training))
        z = linear(z, P, f"{c}.dense.1")
        if keep is not None and i == 0:
            keep.append(z.detach().float().cpu())
        out = batch_norm(z, P, S, f"0.bns.{i}", training)
        if i < layers - 1:
            out = torch.relu(out)
        if training:
            out = dropout(out, rate, gen, b.n_pad)
        if i < layers - 1:
            u = b.member @ h + v
            for j in (2 * i, 2 * i + 1):
                u = linear(u, P, f"0.vn_lins.{j}")
                u = torch.relu(batch_norm(u, P, S, f"0.vn_bns.{j}", training))
            v = dropout(u, rate, gen, g_pad) if training else u
        h = out
    pooled = (b.member @ h) / b.counts[:, None]
    return linear(pooled, P, "0.graph_pred")[:, 0]


def follow_mol(sets: Dict[str, list], init: Dict[str, torch.Tensor], cfg: dict, seed: int,
               steps: int, device, tf32: bool = False, half_batch: bool = False,
               frozen: bool = False) -> dict:
    """``steps`` epochs of the trainer's protocol from ``init``: an Adam step
    a train batch, then an evaluation of every molecule of train, valid and
    test (in that order, unshuffled batches). Returns what the comparison
    reads: each epoch's mean loss, the first step's gradient norms, each
    parameter's change, each evaluation's logits and the first conv's output
    in the first forward; and under ``state`` every parameter and running
    statistic after the last step."""
    P, S = _split_state(init)
    P0 = {k: v.detach().clone() for k, v in P.items()}
    opt = R.Adam(cfg["lr"])
    gen = torch.Generator(device=device)
    bs, max_atoms = cfg["batch_size"], cfg["max_atoms"]
    train = sets["train"]
    out = _outputs()

    def batch(mols):
        return Batch(mols, padded_atoms(sum(m[2] for m in mols), bs, max_atoms), device)

    with matmul_precision(tf32):
        for epoch in range(steps):
            order = np.random.default_rng(seed * 613 + epoch).permutation(len(train))
            losses = []
            for step, lo in enumerate(range(0, len(order), bs)):
                b = batch([train[j] for j in order[lo:lo + bs]])
                gen.manual_seed(step_seed(seed, epoch, step))
                first = epoch == 0 and step == 0
                logits = forward(P, S, b, cfg, gen, True, out["first_layer"] if first else None)
                rows = slice(0, len(b.labels) // 2) if half_batch else slice(None)
                loss = F.binary_cross_entropy_with_logits(logits[rows], b.labels[rows])
                grads = R.grads_of(loss, P, list(P))
                if not frozen:
                    opt.step(P, grads)
                if first:
                    out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
                losses.append(float(loss.detach()))
            out["loss"].append(sum(losses) / len(losses))
            out["change"] = {k: float((P[k].detach() - P0[k]).norm()) for k in P}
            with torch.no_grad():
                out["eval"].append(torch.cat([
                    forward(P, S, batch(mols[lo:lo + bs]), cfg, None, False)
                    for split in ("train", "valid", "test")
                    for mols in (sets[split],) for lo in range(0, len(mols), bs)]))
    out["state"] = {**{k: v.detach() for k, v in P.items()}, **S}
    return out
