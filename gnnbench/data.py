"""Inputs of a run, made from ``--seed``.

The graph, features, labels and splits are the ogbn-arxiv-shaped synthetic
node task (a power-law citation graph with class prototypes, two hops of
label smoothing and label noise), drawn in bulk with NumPy on the host. The teacher's
stand-in outputs and every initial parameter are drawn on the device with
one ``torch.Generator`` in a few large calls. Both sides of the comparison
get the same inputs; neither makes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    senders: np.ndarray  # int64[E0] raw edge list
    receivers: np.ndarray
    num_nodes: int
    num_classes: int
    x: np.ndarray  # float32[N, F]
    y: np.ndarray  # int64[N]
    split_idx: Dict[str, np.ndarray]  # int64 node ids, sorted
    teacher_feat: Optional[torch.Tensor] = None  # float32[N, teacher_dim]
    teacher_logits: Optional[torch.Tensor] = None  # float32[N, C]


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a run."""
    key = np.random.SeedSequence([int(seed), 0x6E6E, int(stream)]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(key[0]) << 32 | int(key[1]))


def arxiv_task(graph: dict, seed: int) -> Inputs:
    """The synthetic node task: ``num_edges`` senders drawn zipf(1.4) modulo
    N with uniform receivers (self pairs dropped), labels uniform then
    smoothed over ``label_smoothing_hops`` hops (each receiver adopts a
    sender's class), features ``signal * prototype[label] + N(0, 1)``, a
    ``label_noise`` share relabelled uniformly, and a random split."""
    rng = np.random.default_rng(int(seed))
    n, e = graph["num_nodes"], graph["num_edges"]
    f, c = graph["feat_dim"], graph["num_classes"]
    s = rng.zipf(1.4, size=e * 2) % n
    r = rng.integers(0, n, size=e * 2)
    keep = s != r
    s, r = s[keep][:e].astype(np.int64), r[keep][:e].astype(np.int64)
    protos = rng.normal(size=(c, f)).astype(np.float32)
    y = rng.integers(0, c, size=n).astype(np.int64)
    for _ in range(graph["label_smoothing_hops"]):
        y_new = y.copy()
        y_new[r] = y[s]
        y = y_new
    x = protos[y] * graph["signal"] + rng.normal(size=(n, f)).astype(np.float32)
    flip = rng.random(n) < graph["label_noise"]
    y = np.where(flip, rng.integers(0, c, size=n), y)
    perm = rng.permutation(n)
    n_tr, n_va = int(graph["train_frac"] * n), int(graph["valid_frac"] * n)
    parts = {"train": perm[:n_tr], "valid": perm[n_tr:n_tr + n_va], "test": perm[n_tr + n_va:]}
    return Inputs(
        senders=s, receivers=r, num_nodes=n, num_classes=c,
        x=x.astype(np.float32), y=y.astype(np.int64),
        split_idx={k: np.sort(v).astype(np.int64) for k, v in parts.items()},
    )


def teacher_outputs(inputs: Inputs, dim: int, seed: int, device) -> None:
    """Stand-ins for a trained teacher's dump: features ``relu(prototype[y]
    + N(0, 1))`` of width ``dim`` and logits ``3 * onehot(y) + N(0, 1)``."""
    gen = device_generator(seed, 1, device)
    n, c = inputs.num_nodes, inputs.num_classes
    y = torch.from_numpy(inputs.y).to(device)
    protos = torch.randn(c, dim, generator=gen, device=device)
    noise = torch.randn(n, dim + c, generator=gen, device=device)
    inputs.teacher_feat = torch.relu(protos[y] + noise[:, :dim])
    inputs.teacher_logits = 3.0 * torch.nn.functional.one_hot(y, c).float() + noise[:, dim:]


def initial_state(shapes: Dict[str, tuple], seed: int, device, gain: float = 1.0
                  ) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of a model from one uniform draw: each
    matrix ``U(-a, a)`` with ``a = gain * sqrt(6 / (fan_in + fan_out))``,
    biases, shifts and running means 0, scales and running variances 1."""
    gen = device_generator(seed, 2, device)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    draw = torch.rand(sum(a * b for a, b in mats.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in mats:
            a, b = s
            bound = gain * (6.0 / (a + b)) ** 0.5
            out[k] = (draw[at:at + a * b].view(a, b) * 2.0 - 1.0) * bound
            at += a * b
        elif k.endswith(("scale", "running_var")):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out
