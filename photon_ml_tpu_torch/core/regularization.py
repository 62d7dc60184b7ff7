"""Regularization weights.

Port of photon_ml_tpu/core/regularization.py.  ``l2`` adds (l2/2)·‖w‖² to
the objective; ``l1`` belongs to OWLQN, which this slice does not carry
(coordinates refuse l1 > 0).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Regularization:
    l1: float = 0.0
    l2: float = 0.0
