"""Evaluators and a minimal evaluation suite.

Port of the ungrouped part of photon_ml_tpu/evaluation/evaluator.py with the
two metrics this slice carries (AUC and logistic loss).  Grouped
(per-id-tag) evaluators and the other metrics come with later slices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import metrics as M

Tensor = torch.Tensor
MetricFn = Callable[[Tensor, Tensor, Tensor], Tensor]


class EvaluatorType(enum.Enum):
    AUC = "auc"
    LOGISTIC_LOSS = "logistic_loss"


_LARGER_IS_BETTER = {EvaluatorType.AUC}

_METRIC_FNS: Dict[EvaluatorType, MetricFn] = {
    EvaluatorType.AUC: M.auc_roc,
    EvaluatorType.LOGISTIC_LOSS: M.logistic_loss_metric,
}


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric with an ordering."""

    kind: EvaluatorType

    @property
    def name(self) -> str:
        return self.kind.value

    @property
    def larger_is_better(self) -> bool:
        return self.kind in _LARGER_IS_BETTER

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.larger_is_better else a < b

    def evaluate(self, scores: Tensor, labels: Tensor, weights: Tensor) -> float:
        return float(_METRIC_FNS[self.kind](scores, labels, weights))


def make_evaluator(spec: str) -> Evaluator:
    if ":" in spec:
        raise NotImplementedError(
            f"grouped evaluator {spec!r} is not ported yet (ROADMAP.md "
            "'Modules still to port', item 5, evaluation/)")
    try:
        return Evaluator(EvaluatorType(spec))
    except ValueError:
        raise NotImplementedError(
            f"evaluator {spec!r} is not ported yet (ROADMAP.md 'Modules still "
            "to port', item 5, evaluation/); this slice has 'auc' and 'logistic_loss'")


@dataclasses.dataclass
class EvaluationResults:
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

    def evaluate(self, scores, labels, weights) -> EvaluationResults:
        """``scores`` is a tensor; labels and weights may be numpy, and are
        moved to the scores' device and dtype."""
        scores = torch.as_tensor(scores)
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=scores.device,
                                         dtype=scores.dtype)
        labels, weights = as_t(labels), as_t(weights)
        out = {ev.name: ev.evaluate(scores, labels, weights) for ev in self.evaluators}
        return EvaluationResults(values=out, primary_name=self.primary.name)

    def better_than(self, a: EvaluationResults, b: Optional[EvaluationResults]) -> bool:
        if b is None:
            return True
        return self.primary.better_than(a.primary, b.primary)
