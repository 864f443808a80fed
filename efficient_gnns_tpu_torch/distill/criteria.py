"""Distillation criteria (counterpart of ``efficient_gnns_tpu/distill/criteria.py``).

Reductions match the reference exactly: ``F.kl_div(reduction='mean')``
divides by numel (N*C), ``F.mse_loss`` is an all-element mean,
``F.cross_entropy`` is a batch mean. Every term takes already gathered rows
and an optional row ``mask`` that removes padding rows from the reductions.
Each ``*_term`` returns the raw auxiliary scalar; each ``*_criterion``
returns ``(loss, loss_cls, loss_aux)``.

Row subsampling (``gsp_term``, ``nce_term``, ``nce_term_structured``) draws
from an explicit ``torch.Generator`` on the features' device: the
distribution of the JAX package's ``subsample_rows``, other bits. The chosen
rows can be handed in directly (``idx``, ``sel_mask``) instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from efficient_gnns_tpu_torch.graphs.container import Graph
from efficient_gnns_tpu_torch.ops.sorted_segment import csr_segment_softmax, gather_rows_csr

_F32_MIN = torch.finfo(torch.float32).min


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements, with rows (leading axis) masked out."""
    if mask is None:
        return x.mean()
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    per_row = 1 if x.dim() == mask.dim() else x.shape[-1]
    denom = (mask.to(x.dtype).sum() * per_row).clamp_min(1.0)
    return (x * m).sum() / denom


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)`` over the last axis with the eps inside the rsqrt,
    so the gradient at all-zero rows (ReLU features) is finite."""
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps * eps)


def cls_ce(logits, labels, mask=None):
    """Mean cross-entropy over (valid) rows."""
    nll = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def cls_bce(logits, targets, mask=None):
    """BCE-with-logits, mean over all elements (multi-label)."""
    loss = F.binary_cross_entropy_with_logits(
        logits.float(), targets.float(), reduction="none")
    return _masked_mean(loss, mask)


def kd_term(logits, teacher_logits, T: float = 4.0, mask=None):
    """KL(softmax(teacher/T) || softmax(student/T)), mean over numel."""
    ls = F.log_softmax(logits.float() / T, dim=-1)
    pt = F.softmax(teacher_logits.float() / T, dim=-1)
    elt = pt * (torch.log(pt.clamp_min(1e-20)) - ls)
    elt = torch.where(pt > 0, elt, torch.zeros_like(elt))  # 0 * log 0 = 0
    return _masked_mean(elt, mask)


def kd_criterion(logits, labels, teacher_logits, alpha=0.9, T=4.0, mask=None,
                 reduction: str = "numel"):
    """``alpha * T^2 * KL + (1 - alpha) * CE`` -> ``(loss, loss_cls, loss_kd)``.

    ``reduction="numel"`` reproduces the reference (KL / (N*C));
    ``"batchmean"`` sums over classes and means over nodes (standard Hinton).
    """
    loss_cls = cls_ce(logits, labels, mask)
    loss_kd = kd_term(logits, teacher_logits, T, mask)
    if reduction == "batchmean":
        loss_kd = loss_kd * logits.shape[-1]
    elif reduction != "numel":
        raise ValueError(f"unknown kd reduction {reduction!r}")
    return loss_kd * (alpha * T * T) + loss_cls * (1 - alpha), loss_cls, loss_kd


def kd_term_bce(logits, teacher_logits, mask=None):
    """BCE against ``sigmoid(teacher)`` soft targets."""
    return cls_bce(logits, torch.sigmoid(teacher_logits.float()), mask)


def kd_criterion_bce(logits, targets, teacher_logits, alpha=0.5, T=1.0, mask=None):
    loss_cls = cls_bce(logits, targets, mask)
    loss_kd = kd_term_bce(logits, teacher_logits, mask)
    return loss_kd * (alpha * T * T) + loss_cls * (1 - alpha), loss_cls, loss_kd


# FitNet


def fitnet_term(feat, teacher_feat, mask=None):
    f = _normalize(feat.float())
    t = _normalize(teacher_feat.float())
    return _masked_mean((f - t).square(), mask)


def fitnet_criterion(logits, labels, feat, teacher_feat, beta=1000.0, mask=None):
    loss_cls = cls_ce(logits, labels, mask)
    loss_aux = fitnet_term(feat, teacher_feat, mask)
    return loss_cls + beta * loss_aux, loss_cls, loss_aux


# Attention Transfer


def at_term(feat, teacher_feat, mask=None):
    # per-node squared-activation norms, L2-normalized over the whole node vector
    f = feat.float().square().sum(-1)
    t = teacher_feat.float().square().sum(-1)
    if mask is not None:
        f = torch.where(mask, f, 0.0)
        t = torch.where(mask, t, 0.0)
    f = f / torch.linalg.norm(f).clamp_min(1e-12)
    t = t / torch.linalg.norm(t).clamp_min(1e-12)
    return _masked_mean((f - t).square(), mask)


def at_criterion(logits, labels, feat, teacher_feat, beta=1000.0, mask=None):
    loss_cls = cls_ce(logits, labels, mask)
    loss_aux = at_term(feat, teacher_feat, mask)
    return loss_cls + beta * loss_aux, loss_cls, loss_aux


# GSP ("gpw"): Global Structure Preserving


def subsample_rows(
    generator: torch.Generator, n_rows: int, max_samples: int,
    mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Static-shape analog of ``np.random.choice(n, m, replace=False)``:
    ``(idx[m], sel_mask[m] or None)``. With a row-validity mask, valid rows
    sort first, so padding is only selected when fewer than ``max_samples``
    valid rows exist (then flagged in ``sel_mask``). The scores are drawn
    from ``generator`` on its own device, which must be the rows' device."""
    device = generator.device
    if max_samples >= n_rows and mask is None:
        return torch.arange(n_rows, device=device), None
    scores = torch.rand(n_rows, generator=generator, device=device)
    if mask is not None:
        scores = scores + torch.where(mask, 0.0, 2.0)  # invalid rows last
    idx = torch.argsort(scores)[: min(max_samples, n_rows)]
    return idx, None if mask is None else mask[idx]


def _require_sampler(n, max_samples, generator, idx):
    """More rows than ``max_samples`` need a draw: without one the term would
    build an n x n matrix over all of them."""
    if idx is None and generator is None and n > max_samples:
        raise ValueError(
            f"{n} rows exceed max_samples={max_samples}: pass a generator to "
            "subsample them, or the chosen rows as idx")


def _select_rows(feat, teacher_feat, generator, max_samples, mask, idx, sel_mask):
    """The rows a sampled term works on: the given ``idx`` / ``sel_mask``, a
    draw from ``generator`` when the rows exceed ``max_samples`` or carry a
    mask, else all rows."""
    n = feat.shape[0]
    _require_sampler(n, max_samples, generator, idx)
    if idx is None and generator is not None and (max_samples < n or mask is not None):
        idx, sel_mask = subsample_rows(generator, n, max_samples, mask)
    elif idx is None:
        return feat, teacher_feat, mask
    return feat[idx], teacher_feat[idx], sel_mask


def _gram(z: torch.Tensor, kernel: str) -> torch.Tensor:
    if kernel in ("cosine", "poly"):
        z = _normalize(z)
        g = z @ z.T
        return g * g if kernel == "poly" else g
    if kernel in ("l2", "rbf"):
        sq = (z * z).sum(-1)
        d2 = (sq[:, None] + sq[None, :] - 2.0 * (z @ z.T)).clamp_min(0.0)
        return torch.sqrt(d2 + 1e-12) if kernel == "l2" else torch.exp(-0.5 * d2)
    raise NotImplementedError(kernel)


def gsp_term(feat, teacher_feat, kernel: str = "cosine", *,
             generator: Optional[torch.Generator] = None, max_samples: int = 8192,
             mask=None, idx=None, sel_mask=None):
    """MSE between the teacher's and the student's pairwise-similarity (Gram)
    matrices over (a subsample of) the rows."""
    feat, teacher_feat, sel_mask = _select_rows(
        feat, teacher_feat, generator, max_samples, mask, idx, sel_mask)
    diff2 = (_gram(feat.float(), kernel) - _gram(teacher_feat.float(), kernel)).square()
    if sel_mask is not None:
        pair = sel_mask[:, None] & sel_mask[None, :]
        return torch.where(pair, diff2, 0.0).sum() / pair.float().sum().clamp_min(1.0)
    return diff2.mean()


def gsp_criterion(logits, labels, feat, teacher_feat, kernel="cosine", beta=1.0,
                  max_samples=8192, generator=None, mask=None):
    loss_cls = cls_ce(logits, labels, mask)
    loss_aux = gsp_term(feat, teacher_feat, kernel, generator=generator,
                        max_samples=max_samples, mask=mask)
    return loss_cls + beta * loss_aux, loss_cls, loss_aux


# LSP ("lpw"): Local Structure Preserving


def _edge_similarity(graph: Graph, feat: torch.Tensor, kernel: str,
                     ident: torch.Tensor) -> torch.Tensor:
    # padding edges point one past the last node: clamped here, masked later;
    # each gather's gradient is K1 over the CSR of its index
    s = gather_rows_csr(feat, graph.senders, graph.t_row_offsets, graph.csc_perm,
                        graph.t_row_split).float()
    d = gather_rows_csr(feat, graph.receivers, graph.row_offsets, ident,
                        graph.row_split).float()
    if kernel in ("cosine", "poly"):
        sim = (_normalize(s) * _normalize(d)).sum(-1)
        return sim * sim if kernel == "poly" else sim
    if kernel == "l2":
        return torch.sqrt((s - d).square().sum(-1) + 1e-12)
    if kernel == "rbf":
        return torch.exp(-0.5 * (s - d).square().sum(-1))
    raise NotImplementedError(kernel)


def lsp_term(graph: Graph, feat, teacher_feat, kernel: str = "cosine",
             mode: str = "kld", keep_mask=None):
    """Per-edge similarity distributions (segment softmax over the in-edges
    of each receiver), KL(teacher || student) or MSE, mean over the real
    (and kept) edges. ``keep_mask`` restricts the edges without relabeling.
    Every sum of the term and of its gradient runs on K1 in the graph's CSR
    order (``ops/sorted_segment.py``), with no float atomics: every call
    gives the same bits (the row-sharded trainer computes the term on every
    rank)."""
    mask = graph.edge_mask
    if keep_mask is not None:
        mask = mask & keep_mask
    ident = torch.arange(graph.num_edges_padded, dtype=torch.int32, device=graph.device)
    p_s, p_t = (
        csr_segment_softmax(_edge_similarity(graph, f, kernel, ident), graph.receivers,
                            graph.row_offsets, graph.row_split, ident, mask)
        for f in (feat, teacher_feat)
    )
    if mode == "mse":
        return _masked_mean((p_s - p_t).square(), mask)
    if mode == "kld":
        elt = p_t * (torch.log(p_t.clamp_min(1e-20)) - torch.log(p_s.clamp_min(1e-20)))
        return _masked_mean(torch.where(p_t > 0, elt, 0.0), mask)
    raise NotImplementedError(mode)


def lsp_criterion(logits, labels, feat, teacher_feat, graph: Graph, kernel="cosine",
                  beta=100.0, mode="kld", mask=None):
    loss_cls = cls_ce(logits, labels, mask)
    loss_aux = lsp_term(graph, feat, teacher_feat, kernel, mode)
    return loss_cls + beta * loss_aux, loss_cls, loss_aux


# G-CRD ("nce"): contrastive representation distillation


def _nce_log_probs(feat, teacher_feat, nce_T, sel_mask):
    f = _normalize(feat.float())
    t = _normalize(teacher_feat.float())
    logits = (f @ t.T) / nce_T
    if sel_mask is not None:
        # invalid columns are no candidates; a finite fill (a where, not a
        # multiply) keeps a fully masked row finite
        logits = torch.where(sel_mask[None, :], logits, _F32_MIN)
    return F.log_softmax(logits, dim=-1)


def nce_term(feat, teacher_feat, nce_T: float = 0.075, *,
             generator: Optional[torch.Generator] = None, max_samples: int = 8192,
             mask=None, idx=None, sel_mask=None):
    """InfoNCE: student row i should match teacher row i among M candidates."""
    feat, teacher_feat, sel_mask = _select_rows(
        feat, teacher_feat, generator, max_samples, mask, idx, sel_mask)
    diag = torch.diagonal(_nce_log_probs(feat, teacher_feat, nce_T, sel_mask))
    if sel_mask is not None:
        m = sel_mask.float()
        return -(torch.where(sel_mask, diag, 0.0) * m).sum() / m.sum().clamp_min(1.0)
    return -diag.mean()


def nce_criterion(logits, labels, feat, teacher_feat, beta=0.5, nce_T=0.075,
                  max_samples=8192, generator=None, mask=None):
    loss_cls = cls_ce(logits, labels, mask)
    loss_aux = nce_term(feat, teacher_feat, nce_T, generator=generator,
                        max_samples=max_samples, mask=mask)
    return loss_cls + beta * loss_aux, loss_cls, loss_aux


def nce_term_structured(feat, teacher_feat, nce_T: float = 0.075, *,
                        generator: Optional[torch.Generator] = None,
                        max_samples: int = 8192, mask=None,
                        labels: Optional[torch.Tensor] = None,
                        graph: Optional[Graph] = None, idx=None, sel_mask=None,
                        gathered: bool = False):
    """Label- and/or edge-conditioned InfoNCE (multi-positive G-CRD): beside
    the diagonal student-i / teacher-i pair, columns sharing node i's label
    (``labels``) and/or i's graph neighbors (``graph``) count as positives;
    the loss is the mean over positives of ``-log p``. With ``gathered``
    ``feat`` and ``teacher_feat`` are already the rows ``idx`` (``[m, d]``),
    while ``labels`` and ``graph`` still span all the rows that ``idx``
    indexes (the row-sharded trainer assembles only the chosen rows)."""
    n = feat.shape[0]
    _require_sampler(n, max_samples, generator, idx)
    if idx is None and generator is not None:
        idx, sel_mask = subsample_rows(generator, n, max_samples, mask)
    elif idx is None:
        idx, sel_mask = torch.arange(n, device=feat.device), mask
    m = idx.shape[0]
    if sel_mask is None:
        sel_mask = torch.ones(m, dtype=torch.bool, device=feat.device)
    if not gathered:
        feat, teacher_feat = feat[idx], teacher_feat[idx]
    logp = _nce_log_probs(feat, teacher_feat, nce_T, sel_mask)

    pos = torch.eye(m, dtype=torch.bool, device=feat.device)
    if labels is not None:
        lab = labels.reshape(-1)[idx]
        pos = pos | (lab[:, None] == lab[None, :])
    if graph is not None:
        # edge positives among the subsample: map node -> sampled slot (+1)
        # and mark each intra-sample edge in the MxM indicator (a boolean
        # scatter: only "at least one edge" is read, so no float atomics)
        slot = torch.zeros(graph.num_nodes + 1, dtype=torch.long, device=feat.device)
        slot[idx] = torch.arange(1, m + 1, device=feat.device)
        si = slot[graph.senders.long().clamp_max(graph.num_nodes)]
        ri = slot[graph.receivers.long().clamp_max(graph.num_nodes)]
        both = (si > 0) & (ri > 0) & graph.edge_mask
        adj = torch.zeros(m * m, dtype=torch.bool, device=feat.device)
        adj[((ri - 1) * m + (si - 1))[both]] = True
        pos = pos | adj.view(m, m)
    pos_f = (pos & sel_mask[None, :] & sel_mask[:, None]).float()
    per_row = -(logp * pos_f).sum(-1) / pos_f.sum(-1).clamp_min(1.0)
    row_m = sel_mask.float()
    return (per_row * row_m).sum() / row_m.sum().clamp_min(1.0)
