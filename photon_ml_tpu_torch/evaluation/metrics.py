"""Evaluation metrics as torch reductions.

Port of photon_ml_tpu/evaluation/metrics.py: weighted reductions over
(score, label, weight); rows of weight 0 (padding) are inert.  AUC is the
exact sort-based area with tied scores integrated as one trapezoid per tie
group; degenerate inputs (no positives or no negatives) give 0.5.

Every metric reduces over the last dimension and keeps any leading ones, so
a [groups, size] layout evaluates every group in one batched call (the
reference ``vmap``s its metrics over groups instead).
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.core.losses import (logistic_loss, poisson_loss,
                                             smoothed_hinge_loss, squared_loss)

Tensor = torch.Tensor


def _wsum(x: Tensor, w: Tensor) -> Tensor:
    return torch.sum(x * w, dim=-1)


def rmse(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted RMSE; a total weight of 0 divides by 1."""
    tot = torch.sum(weights, dim=-1)
    se = _wsum((scores - labels) ** 2, weights)
    return torch.sqrt(se / torch.where(tot == 0, 1.0, tot))


def squared_loss_metric(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    return _wsum(squared_loss.loss(scores, labels), weights)


def logistic_loss_metric(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    return _wsum(logistic_loss.loss(scores, labels), weights)


def poisson_loss_metric(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    return _wsum(poisson_loss.loss(scores, labels), weights)


def smoothed_hinge_loss_metric(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    return _wsum(smoothed_hinge_loss.loss(scores, labels), weights)


def _rank_stats(scores: Tensor, labels: Tensor, weights: Tensor):
    """Sort by score descending along the last dimension; cumulative weighted
    TP/FP at the end of each tied-score group and at the end of the group
    before it, and the totals."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    s = torch.gather(scores, -1, order)
    pos_w = torch.gather(weights * (labels > 0.5), -1, order)
    neg_w = torch.gather(weights * (labels <= 0.5), -1, order)
    ctp = torch.cumsum(pos_w, -1)
    cfp = torch.cumsum(neg_w, -1)
    one = torch.ones(s.shape[:-1] + (1,), dtype=torch.bool, device=s.device)
    is_end = torch.cat([s[..., :-1] != s[..., 1:], one], -1)
    is_start = torch.cat([one, s[..., 1:] != s[..., :-1]], -1)
    seg = torch.cumsum(is_start.long(), -1) - 1  # tie-group id per element
    zero = torch.zeros_like(ctp)
    seg_end_tp = zero.scatter_reduce(-1, seg, torch.where(is_end, ctp, 0.0), "amax")
    seg_end_fp = zero.scatter_reduce(-1, seg, torch.where(is_end, cfp, 0.0), "amax")
    prev = torch.clamp(seg - 1, min=0)
    prev_ctp = torch.where(seg > 0, torch.gather(seg_end_tp, -1, prev), 0.0)
    prev_cfp = torch.where(seg > 0, torch.gather(seg_end_fp, -1, prev), 0.0)
    return (is_end, torch.gather(seg_end_tp, -1, seg), torch.gather(seg_end_fp, -1, seg),
            prev_ctp, prev_cfp, ctp[..., -1], cfp[..., -1])


def auc_roc(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Exact weighted ROC AUC with tie handling (trapezoidal)."""
    is_end, end_tp, end_fp, prev_tp, prev_fp, tot_p, tot_n = _rank_stats(
        scores, labels, weights)
    area = torch.where(is_end, (end_fp - prev_fp) * 0.5 * (end_tp + prev_tp), 0.0)
    degenerate = (tot_p == 0) | (tot_n == 0)
    auc = torch.sum(area, dim=-1) / torch.where(degenerate, 1.0, tot_p * tot_n)
    return torch.where(degenerate, 0.5, auc)


def auc_pr(scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Weighted area under the precision-recall curve, linear in recall;
    the precision before the first group is 1, and no positives give 0."""
    is_end, end_tp, end_fp, prev_tp, prev_fp, tot_p, _ = _rank_stats(
        scores, labels, weights)
    prec_end = end_tp / torch.clamp(end_tp + end_fp, min=1e-30)
    prec_prev = torch.where(prev_tp + prev_fp > 0,
                            prev_tp / torch.clamp(prev_tp + prev_fp, min=1e-30), 1.0)
    tp_den = torch.where(tot_p == 0, 1.0, tot_p).unsqueeze(-1)
    area = torch.where(is_end, (end_tp / tp_den - prev_tp / tp_den) * 0.5
                       * (prec_end + prec_prev), 0.0)
    return torch.where(tot_p == 0, 0.0, torch.sum(area, dim=-1))


def precision_at_k(k: int, scores: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    """Unweighted precision among the top-k scores (ties in the original
    order); rows of weight 0 are pushed out of the ranking and do not
    count.  Computed in the scores' dtype."""
    masked = torch.where(weights > 0, scores, -torch.inf)
    topk = torch.argsort(-masked, dim=-1, stable=True)[..., :k]
    valid = torch.gather(weights, -1, topk) > 0
    hits = torch.sum((torch.gather(labels, -1, topk) > 0.5) & valid, dim=-1)
    denom = torch.clamp(torch.sum(valid, dim=-1), min=1)
    return hits.to(scores.dtype) / denom.to(scores.dtype)
