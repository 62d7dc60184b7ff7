"""Shared score composition: the one definition of GAME additive scoring.

Port of ``additive_total`` in photon_ml_tpu/game/scoring.py: the total score
is the sum of the coordinates' raw margins, accumulated from zero in
coordinate order.  The total is float64, as in the reference's
double-precision mode.
"""

from __future__ import annotations

from typing import Iterable

import torch

Tensor = torch.Tensor


def additive_total(num_samples: int, margins: Iterable[Tensor],
                   device: "torch.device | str" = "cpu") -> Tensor:
    """Sum per-coordinate raw margins [n] into the total score vector."""
    total = torch.zeros(num_samples, dtype=torch.float64, device=device)
    for m in margins:
        total = total + m
    return total
