"""Regularization weights.

Port of photon_ml_tpu/core/regularization.py.  ``l2`` adds (l2/2)·‖w‖² to
the objective; ``l1`` adds l1·‖w‖₁, which the solver factories hand to
OWLQN (``opt.lbfgs.minimize_owlqn_lanes``) rather than to the smooth
objective.  ``Regularization.from_context`` splits one weight by type, as
the regularization path (``models/training.py``) takes it.
"""

from __future__ import annotations

import dataclasses
import enum


class RegularizationType(enum.Enum):
    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    ELASTIC_NET = "elastic_net"


@dataclasses.dataclass(frozen=True)
class Regularization:
    l1: float = 0.0
    l2: float = 0.0

    @classmethod
    def from_context(cls, kind: RegularizationType, weight: float,
                     alpha: float = 1.0) -> "Regularization":
        """One weight by type (reference RegularizationContext.scala:134):
        elastic net puts alpha·weight on L1 and (1 - alpha)·weight on L2."""
        if kind == RegularizationType.NONE:
            return cls()
        if kind == RegularizationType.L1:
            return cls(l1=weight)
        if kind == RegularizationType.L2:
            return cls(l2=weight)
        if kind == RegularizationType.ELASTIC_NET:
            return cls(l1=alpha * weight, l2=(1.0 - alpha) * weight)
        raise ValueError(f"unknown regularization type {kind!r}")
