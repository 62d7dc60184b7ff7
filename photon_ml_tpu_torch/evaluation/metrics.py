"""Evaluation metrics as torch reductions.

Port of ``auc_roc`` and ``logistic_loss_metric`` from
photon_ml_tpu/evaluation/metrics.py: weighted reductions over (score, label,
weight); AUC is the exact sort-based area with tied scores integrated as one
trapezoid per tie group.  Degenerate inputs (no positives or no negatives)
give 0.5.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _wsum(x: Tensor, w: Tensor) -> Tensor:
    return torch.sum(x * w)


def logistic_loss_metric(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    from photon_ml_tpu_torch.core.losses import logistic_loss

    return _wsum(logistic_loss.loss(scores, labels), weights)


def _rank_stats(scores: Tensor, labels: Tensor, weights: Tensor):
    """Sort by score descending; cumulative weighted TP/FP at the end of each
    tied-score group and at the end of the group before it."""
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    pos_w = (weights * (labels > 0.5))[order]
    neg_w = (weights * (labels <= 0.5))[order]
    ctp = torch.cumsum(pos_w, 0)
    cfp = torch.cumsum(neg_w, 0)
    n = s.shape[0]
    one = torch.ones(1, dtype=torch.bool, device=s.device)
    is_end = torch.cat([s[:-1] != s[1:], one])
    is_start = torch.cat([one, s[1:] != s[:-1]])
    seg = torch.cumsum(is_start.long(), 0) - 1  # tie-group id per element
    zero = torch.zeros(n, dtype=ctp.dtype, device=s.device)
    seg_end_tp = zero.scatter_reduce(0, seg, torch.where(is_end, ctp, 0.0), "amax")
    seg_end_fp = zero.scatter_reduce(0, seg, torch.where(is_end, cfp, 0.0), "amax")
    prev = torch.clamp(seg - 1, min=0)
    prev_ctp = torch.where(seg > 0, seg_end_tp[prev], 0.0)
    prev_cfp = torch.where(seg > 0, seg_end_fp[prev], 0.0)
    return is_end, seg_end_tp[seg], seg_end_fp[seg], prev_ctp, prev_cfp, ctp[-1], cfp[-1]


def auc_roc(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Exact weighted ROC AUC with tie handling (trapezoidal)."""
    is_end, end_tp, end_fp, prev_tp, prev_fp, tot_p, tot_n = _rank_stats(
        scores, labels, weights)
    area = torch.where(is_end, (end_fp - prev_fp) * 0.5 * (end_tp + prev_tp), 0.0)
    degenerate = (tot_p == 0) | (tot_n == 0)
    auc = torch.sum(area) / torch.where(degenerate, 1.0, tot_p * tot_n)
    return torch.where(degenerate, 0.5, auc)
