"""Evaluator objects, suites, and grouped (per-id-tag) evaluation.

Port of photon_ml_tpu/evaluation/evaluator.py: the eight evaluator types, an
evaluator per spec ('auc', 'precision@5', 'auc:userId'), a suite with a
primary, and ``grouped_evaluate``, the per-group metric averaged over the
groups with weight (reference MultiEvaluator).

Grouped evaluation builds a padded [groups, max group size] layout on the
scores' device (groups in sorted id order, samples in their original order
inside a group, padding 0.0 in scores, labels and weights, as the reference
pads) and evaluates every group in one batched call of the metric.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import metrics as M

Tensor = torch.Tensor
MetricFn = Callable[[Tensor, Tensor, Tensor], Tensor]


class EvaluatorType(enum.Enum):
    AUC = "auc"
    AUPR = "aupr"
    RMSE = "rmse"
    LOGISTIC_LOSS = "logistic_loss"
    POISSON_LOSS = "poisson_loss"
    SQUARED_LOSS = "squared_loss"
    SMOOTHED_HINGE_LOSS = "smoothed_hinge_loss"
    PRECISION_AT_K = "precision_at_k"


_LARGER_IS_BETTER = {
    EvaluatorType.AUC, EvaluatorType.AUPR, EvaluatorType.PRECISION_AT_K,
}

_METRIC_FNS: Dict[EvaluatorType, MetricFn] = {
    EvaluatorType.AUC: M.auc_roc,
    EvaluatorType.AUPR: M.auc_pr,
    EvaluatorType.RMSE: M.rmse,
    EvaluatorType.LOGISTIC_LOSS: M.logistic_loss_metric,
    EvaluatorType.POISSON_LOSS: M.poisson_loss_metric,
    EvaluatorType.SQUARED_LOSS: M.squared_loss_metric,
    EvaluatorType.SMOOTHED_HINGE_LOSS: M.smoothed_hinge_loss_metric,
}


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric with an ordering; with ``group_name``, the metric is
    computed per group of that id tag and averaged."""

    kind: EvaluatorType
    k: int = 0  # PRECISION_AT_K only
    group_name: Optional[str] = None  # None: one metric over all samples

    @property
    def name(self) -> str:
        base = (f"{self.kind.value}@{self.k}" if self.kind == EvaluatorType.PRECISION_AT_K
                else self.kind.value)
        return f"{base}:{self.group_name}" if self.group_name else base

    @property
    def larger_is_better(self) -> bool:
        return self.kind in _LARGER_IS_BETTER

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.larger_is_better else a < b

    def metric_fn(self) -> MetricFn:
        if self.kind == EvaluatorType.PRECISION_AT_K:
            k = self.k
            return lambda s, l, w: M.precision_at_k(k, s, l, w)
        return _METRIC_FNS[self.kind]

    def evaluate(self, scores: Tensor, labels: Tensor, weights: Tensor,
                 group_ids: Optional[np.ndarray] = None) -> float:
        fn = self.metric_fn()
        if self.group_name is None:
            return float(fn(scores, labels, weights))
        if group_ids is None:
            raise ValueError(f"evaluator {self.name} needs group ids '{self.group_name}'")
        return grouped_evaluate(fn, group_ids, scores, labels, weights)


def make_evaluator(spec: str) -> Evaluator:
    """Parse an evaluator spec: 'auc', 'rmse', 'precision@5', 'auc:userId'
    (grouped), 'precision@3:songId'.  An unknown name is a ValueError."""
    group = None
    if ":" in spec:
        spec, group = spec.split(":", 1)
    if spec.startswith("precision@"):
        return Evaluator(EvaluatorType.PRECISION_AT_K, k=int(spec.split("@")[1]),
                         group_name=group)
    return Evaluator(EvaluatorType(spec), group_name=group)


def pad_groups(group_ids, *arrays: Tensor) -> Tuple[Tensor, ...]:
    """Each of ``arrays`` [n] as a [groups, max group size] tensor on its
    device: groups in sorted id order, samples in their original order
    inside a group, padded with 0.  The layout is built on the device of
    ``arrays[0]``; the only host read is the largest group's size."""
    dev = arrays[0].device
    ids = torch.as_tensor(group_ids, device=dev)
    _, inverse, counts = torch.unique(ids, return_inverse=True, return_counts=True)
    g, smax = counts.numel(), int(counts.max())
    order = torch.argsort(inverse, stable=True)
    group = inverse[order]
    pos = torch.arange(ids.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[group]
    out = []
    for a in arrays:
        p = torch.zeros((g, smax), dtype=a.dtype, device=dev)
        p[group, pos] = a[order]
        out.append(p)
    return tuple(out)


def grouped_mean(values: Tensor, padded_weights: Tensor) -> float:
    """The unweighted mean of per-group ``values`` over the groups whose
    total weight is > 0."""
    has_w = torch.sum(padded_weights, dim=-1) > 0
    denom = torch.clamp(torch.sum(has_w), min=1).to(values.dtype)
    return float(torch.sum(torch.where(has_w, values, 0.0)) / denom)


def grouped_evaluate(metric_fn: MetricFn, group_ids, scores: Tensor, labels: Tensor,
                     weights: Tensor) -> float:
    """Per-group metric, unweighted-averaged over the groups with > 0 total
    weight; a degenerate group (say, no positives for AUC) still counts
    with its metric's degenerate value.  No groups give NaN."""
    if len(group_ids) == 0:
        return float("nan")
    ps, pl, pw = pad_groups(group_ids, scores, labels, weights)
    return grouped_mean(metric_fn(ps, pl, pw), pw)


@dataclasses.dataclass
class EvaluationResults:
    """Metric name -> value, with the primary distinguished."""

    values: Dict[str, float]
    primary_name: str

    @property
    def primary(self) -> float:
        return self.values[self.primary_name]


@dataclasses.dataclass
class EvaluationSuite:
    """Evaluator set + primary."""

    evaluators: List[Evaluator]
    primary: Evaluator

    def __post_init__(self):
        if self.primary not in self.evaluators:
            self.evaluators = [self.primary] + list(self.evaluators)

    @classmethod
    def from_specs(cls, specs: Sequence[str], primary: Optional[str] = None
                   ) -> "EvaluationSuite":
        evs = [make_evaluator(s) for s in specs]
        prim = make_evaluator(primary) if primary else evs[0]
        return cls(evaluators=evs, primary=prim)

    def evaluate(self, scores, labels, weights,
                 group_ids: Optional[Dict[str, np.ndarray]] = None) -> EvaluationResults:
        """``scores`` is a tensor; labels and weights may be numpy, and are
        moved to the scores' device and dtype.  ``group_ids``: id tag ->
        per-sample ids, for the grouped evaluators."""
        scores = torch.as_tensor(scores)
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=scores.device,
                                         dtype=scores.dtype)
        labels, weights = as_t(labels), as_t(weights)
        out = {}
        for ev in self.evaluators:
            gids = (group_ids or {}).get(ev.group_name) if ev.group_name else None
            out[ev.name] = ev.evaluate(scores, labels, weights, gids)
        return EvaluationResults(values=out, primary_name=self.primary.name)

    def better_than(self, a: EvaluationResults, b: Optional[EvaluationResults]) -> bool:
        if b is None:
            return True
        return self.primary.better_than(a.primary, b.primary)
