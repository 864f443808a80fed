"""Ring (blockwise) computation of the global N x N similarity structures
(counterpart of ``efficient_gnns_tpu/parallel/ring.py``).

The GSP loss and the G-CRD InfoNCE logits are dense Gram matrices over a
node subset; on one device ``distill/criteria.py`` caps their size with
``max_samples``. Here rows are sharded over a mesh axis and the Gram is
computed block by block while chunks rotate around the ring
(:func:`~efficient_gnns_tpu_torch.parallel.collectives.ring_shift`), so no
rank holds more than an ``(N/D) x (N/D)`` block. The InfoNCE term carries an
online logsumexp per local row (running max and running sum of
exponentials), so the softmax over all N columns needs one sweep.

Both terms take this rank's row shards and return the replicated scalar:
the ranks' partial sums meet in
:func:`~efficient_gnns_tpu_torch.parallel.collectives.all_reduce_replicated`,
whose backward is the identity, since every rank backpropagates the same
loss; the ring steps' backward shifts the cotangents back to the rows'
owners. Both reduce to the single-device ``gsp_term`` / ``nce_term``.
"""

from __future__ import annotations

import torch

from efficient_gnns_tpu_torch.parallel.collectives import all_reduce_replicated, ring_shift
from efficient_gnns_tpu_torch.parallel.mesh import Mesh


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps * eps)


def _block_gram(za: torch.Tensor, zb: torch.Tensor, kernel: str) -> torch.Tensor:
    """Similarity block between row chunks ``za`` [m, d] and ``zb`` [k, d];
    for cosine and poly the chunks come normalized (a row-local step, done
    before the ring)."""
    if kernel in ("cosine", "poly"):
        g = za @ zb.T
        return g * g if kernel == "poly" else g
    sqa, sqb = (za * za).sum(-1), (zb * zb).sum(-1)
    d2 = (sqa[:, None] + sqb[None, :] - 2.0 * (za @ zb.T)).clamp_min(0.0)
    if kernel == "l2":
        return torch.sqrt(d2 + 1e-12)
    if kernel == "rbf":
        return torch.exp(-0.5 * d2)
    raise NotImplementedError(kernel)


def _global_rows(mesh: Mesh, axis: str, *shards: torch.Tensor) -> int:
    d = mesh.size(axis)
    m = shards[0].shape[0]
    if any(s.shape[0] != m for s in shards):
        raise ValueError("the student and teacher shards need the same rows")
    n = m * d
    assert n % d == 0, f"rows ({n}) must divide the '{axis}' axis ({d})"
    return n


def ring_gsp_term(mesh: Mesh, feat: torch.Tensor, teacher_feat: torch.Tensor,
                  kernel: str = "cosine", axis: str = "data") -> torch.Tensor:
    """Distributed ``gsp_term``: the mean of ``(G_s - G_t)^2`` over the full
    N x N Gram. ``feat`` / ``teacher_feat`` are this rank's ``[N/D, d_s]`` /
    ``[N/D, d_t]`` row blocks (every rank the same height)."""
    n = _global_rows(mesh, axis, feat, teacher_feat)
    group, d = mesh.group(axis), mesh.size(axis)
    f_local, t_local = feat.float(), teacher_feat.float()
    if kernel in ("cosine", "poly"):
        f_local, t_local = _l2_normalize(f_local), _l2_normalize(t_local)
    ds = f_local.shape[1]
    rot = torch.cat([f_local, t_local], 1)  # one shift a step carries both
    acc = f_local.new_zeros(())
    for k in range(d):
        if k:
            rot = ring_shift(rot, group, 1)
        gs = _block_gram(f_local, rot[:, :ds], kernel)
        gt = _block_gram(t_local, rot[:, ds:], kernel)
        acc = acc + (gs - gt).square().sum()
    return all_reduce_replicated(acc, group) / (n * n)


def ring_nce_term(mesh: Mesh, feat: torch.Tensor, teacher_feat: torch.Tensor,
                  nce_T: float = 0.075, axis: str = "data") -> torch.Tensor:
    """Distributed ``nce_term``: InfoNCE with all N rows as candidates.
    Student row i's positive is teacher row i; the ring rotates teacher
    chunks and keeps an online logsumexp per local student row."""
    n = _global_rows(mesh, axis, feat, teacher_feat)
    group, d = mesh.group(axis), mesh.size(axis)
    f_local = _l2_normalize(feat.float())
    t_local = _l2_normalize(teacher_feat.float())
    m = f_local.shape[0]
    run_max = f_local.new_full((m,), float("-inf"))
    run_sum = f_local.new_zeros((m,))
    t_rot = t_local
    for k in range(d):
        if k:
            t_rot = ring_shift(t_rot, group, 1)
        logits = (f_local @ t_rot.T) / nce_T
        new_max = torch.maximum(run_max, logits.max(-1).values)
        run_sum = (run_sum * torch.exp(run_max - new_max)
                   + torch.exp(logits - new_max[:, None]).sum(-1))
        run_max = new_max
    pos = (f_local * t_local).sum(-1) / nce_T  # the diagonal logits
    nll = (run_max + torch.log(run_sum)) - pos
    return all_reduce_replicated(nll.sum(), group) / n
