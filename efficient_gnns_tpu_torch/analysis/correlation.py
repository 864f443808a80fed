"""Embedding-structure analysis: how much of the teacher's representational
geometry a student inherits (counterpart of
``efficient_gnns_tpu/analysis/correlation.py``, the reference's
``arxiv_pyg/correlation.py``):

* global metric: Pearson correlation between the teacher's and the
  student's condensed pairwise cosine-distance vectors over a node subset;
* local metric: Pearson correlation over per-edge cosine distances;
* linear CKA in its feature-space form.

The distances are computed in float32 on the features' device, a block of
rows of the Gram matrix at a time; the correlations and CKA in float64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _float32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _float64_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def pairwise_cosine_distance_condensed(feat, block: int = 2048) -> np.ndarray:
    """Condensed (upper-triangle) cosine-distance vector in scipy
    ``squareform`` order: row-major pairs (i, j), i < j."""
    f = _l2_normalize(_float32(feat))
    n = f.shape[0]
    cols = torch.arange(n, device=f.device)
    out = [np.zeros(0, np.float32)]
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        d = 1.0 - f[lo:hi] @ f.T  # [B, N]
        upper = cols[None, :] > torch.arange(lo, hi, device=f.device)[:, None]
        out.append(d[upper].cpu().numpy())
    return np.concatenate(out)


def edge_cosine_distance(feat, senders, receivers) -> np.ndarray:
    """Per-edge cosine distance ``1 - cos(f[src], f[dst])``."""
    f = _l2_normalize(_float32(feat))
    s = torch.as_tensor(np.asarray(senders), dtype=torch.long, device=f.device)
    r = torch.as_tensor(np.asarray(receivers), dtype=torch.long, device=f.device)
    return (1.0 - (f[s] * f[r]).sum(-1)).cpu().numpy()


def mantel_correlation(a, b) -> float:
    """Pearson correlation between two distance vectors."""
    a, b = _float64_np(a), _float64_np(b)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom else 0.0


def linear_cka(x, y) -> float:
    """Linear CKA via the feature-space (d x d) form: with column-centred
    ``X`` and ``Y``, ``||Xc^T Yc||_F^2 / (||Xc^T Xc||_F ||Yc^T Yc||_F)``, in
    float64 on the inputs' device."""
    x = torch.as_tensor(x).double()
    y = torch.as_tensor(y).double().to(x.device)
    xc = x - x.mean(0, keepdim=True)
    yc = y - y.mean(0, keepdim=True)
    hsic = torch.linalg.norm(xc.T @ yc, "fro") ** 2
    denom = torch.linalg.norm(xc.T @ xc, "fro") * torch.linalg.norm(yc.T @ yc, "fro")
    return float(hsic / denom) if float(denom) else 0.0


def structure_report(
    teacher_feat,
    student_feat,
    senders: Optional[np.ndarray] = None,
    receivers: Optional[np.ndarray] = None,
    max_nodes: int = 4096,
    seed: int = 0,
) -> Dict[str, float]:
    """Global and local Mantel correlations and linear CKA for one run. Both
    feature sets are L2-normalized; the global metric subsamples
    ``max_nodes`` rows with ``np.random.default_rng(seed).choice``, the draw
    of the JAX package."""
    t = _float32(teacher_feat)
    s = _float32(student_feat).to(t.device)
    if t.shape[0] != s.shape[0]:
        raise ValueError(f"structure_report: {t.shape[0]} teacher rows against "
                         f"{s.shape[0]} student rows")
    n = t.shape[0]
    tg, sg = t, s
    if n > max_nodes:
        idx = np.random.default_rng(seed).choice(n, max_nodes, replace=False)
        idx = torch.as_tensor(idx, device=t.device)
        tg, sg = t[idx], s[idx]
    report = {
        "global_corr": mantel_correlation(
            pairwise_cosine_distance_condensed(tg),
            pairwise_cosine_distance_condensed(sg),
        ),
        "cka": linear_cka(_l2_normalize(sg), _l2_normalize(tg)),
    }
    if senders is not None and receivers is not None:
        report["local_corr"] = mantel_correlation(
            edge_cosine_distance(t, senders, receivers),
            edge_cosine_distance(s, senders, receivers),
        )
    return report
