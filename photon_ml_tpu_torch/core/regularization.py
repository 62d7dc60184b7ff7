"""Regularization weights.

Port of photon_ml_tpu/core/regularization.py.  ``l2`` adds (l2/2)·‖w‖² to
the objective; ``l1`` adds l1·‖w‖₁, which the solver factories hand to
OWLQN (``opt.lbfgs.minimize_owlqn_lanes``) rather than to the smooth
objective.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Regularization:
    l1: float = 0.0
    l2: float = 0.0
