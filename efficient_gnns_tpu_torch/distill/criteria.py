"""Distillation criteria (counterpart of ``efficient_gnns_tpu/distill/criteria.py``;
the classification and logit-KD terms so far).

Reductions match the reference exactly: ``F.kl_div(reduction='mean')``
divides by numel (N*C), ``F.cross_entropy`` is a batch mean. Every term takes
already gathered rows and an optional row ``mask`` that removes padding rows
from the reductions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements, with rows (leading axis) masked out."""
    if mask is None:
        return x.mean()
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    per_row = 1 if x.dim() == mask.dim() else x.shape[-1]
    denom = (mask.to(x.dtype).sum() * per_row).clamp_min(1.0)
    return (x * m).sum() / denom


def cls_ce(logits, labels, mask=None):
    """Mean cross-entropy over (valid) rows."""
    nll = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


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
