"""Tensor-parallel SIGN and its data x tensor parallel step (counterpart of
the SIGN dp x tp section of ``dryrun_multichip``: the batch rows sharded
over ``data``, every 2-D kernel of width ``hidden`` over ``model``).

XLA partitions the JAX step from ``P(None, "model")`` annotations by
itself; here the split is explicit:

* :func:`shard_sign` keeps, in place, this rank's column block of every
  split kernel (``shard_cols``); every other parameter stays whole and
  replicated, the split layers' biases (1-D in JAX) included.
* The forward is :class:`~efficient_gnns_tpu_torch.models.gnns.SIGN`'s,
  unchanged: each split layer's ``FeedForwardNet.linear`` computes ``x @
  w[:, c] + b[c]`` and gathers it with ``all_gather_cols``, so every layer
  after it sees the whole width, as on one device.
* The loss is this rank's NLL sum over ``M * B`` (``M`` the ``model`` axis'
  size, ``B`` the global batch), summed over the whole world with
  ``all_reduce_replicated``: the ``M`` ranks that share rows each hold a
  ``1/M`` share of its cotangent. ``all_gather_cols``' backward sums the
  shares over ``model`` (and so the input gradients of a split layer's
  column blocks), each rank keeping its columns' whole cotangent.
* So a split kernel's gradient is whole for its rows and is summed over
  ``data``; a replicated parameter's is a share on every rank (the biases
  and PReLU slopes see a share of every column, the last kernel a ``1/M``
  share) and is summed over the world. Each wrong choice of a backward or
  a group fails the gradient checks of ``tests/test_torch_parallel_dp.py``.
  The world is the ``("data", "model")`` mesh's ranks.
* Dropout draws each whole-batch mask on every rank from one seed and keeps
  the rank's rows (``RowBlockGenerator``): the single device's masks.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from efficient_gnns_tpu_torch.models.gnns import SIGN
from efficient_gnns_tpu_torch.models.layers import FeedForwardNet, RowBlockGenerator
from efficient_gnns_tpu_torch.parallel.collectives import (
    all_gather_cols,
    all_reduce_grads,
    all_reduce_replicated,
)
from efficient_gnns_tpu_torch.parallel.mesh import Mesh, shard_cols


class _ColumnSplitFFN(FeedForwardNet):
    """A ``FeedForwardNet`` whose split kernels hold this rank's column
    block over ``model`` of ``self.mesh`` (narrower than their biases)."""

    def linear(self, x: torch.Tensor, i: int) -> torch.Tensor:
        w, b = self.weights[i], self.biases[i]
        cols = w.shape[1]
        if cols == b.shape[0]:
            return x @ w + b
        lo = self.mesh.index("model") * cols
        return all_gather_cols(x @ w + b[lo:lo + cols], self.mesh.group("model"))


def shard_sign(model: SIGN, mesh: Mesh) -> SIGN:
    """Split ``model`` in place over ``model``: every 2-D kernel whose second
    dimension is ``hidden`` becomes this rank's column block (the JAX rule
    ``p.ndim == 2 and p.shape[1] == hid``), on the mesh's device with the
    rest. The split names are kept in ``model.tp_split``."""
    hidden = model.inceptions[0].biases[-1].shape[0]
    model.to(mesh.device)
    model.tp_split = set()
    for name, p in model.named_parameters():
        if p.dim() == 2 and p.shape[1] == hidden:
            p.data = shard_cols(mesh, p.data)
            model.tp_split.add(name)
    for ff in (*model.inceptions, model.project):
        ff.__class__, ff.mesh = _ColumnSplitFFN, mesh
    return model


def sign_dp_tp_step(model: SIGN, opt: torch.optim.Optimizer, feats: Sequence[torch.Tensor],
                    labels: torch.Tensor, mesh: Mesh, generator: torch.Generator) -> torch.Tensor:
    """One ``opt`` step of a :func:`shard_sign` model on the NLL averaged
    over the global batch (``__graft_entry__.py``'s ``sign_step``).
    ``feats`` and ``labels`` are this rank's row blocks along ``data``
    (``shard_rows``); dropout draws from ``generator`` as the single device
    does. Returns the global loss (the same on every rank)."""
    rows = labels.shape[0]
    batch = rows * mesh.size("data")
    gen = RowBlockGenerator(generator, batch, mesh.index("data") * rows)
    model.train()
    logits, _ = model(feats, gen)
    nll = -F.log_softmax(logits, -1).gather(1, labels[:, None].long()).sum()
    loss = all_reduce_replicated(nll / (mesh.size("model") * batch), dist.group.WORLD)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    split = [p for n, p in model.named_parameters() if n in model.tp_split]
    replicated = [p for n, p in model.named_parameters() if n not in model.tp_split]
    all_reduce_grads(split, mesh.group("data"))
    all_reduce_grads(replicated, dist.group.WORLD)
    opt.step()
    return loss.detach()


@torch.no_grad()
def gather_sign(model: SIGN, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every parameter of a :func:`shard_sign` model as a whole tensor, the
    split kernels gathered over ``model`` (``state_dict`` names)."""
    group = mesh.group("model")
    return {n: (all_gather_cols(p, group) if n in model.tp_split else p).detach().clone()
            for n, p in model.named_parameters()}
