"""Feature-normalization algebra (effective coefficients + margin shift).

Port of the ``NormalizationContext`` margin algebra of
photon_ml_tpu/core/normalization.py.
With x' = (x - shift) .* factor, margins against the raw x are
eff(w)·x + margin_shift(w), eff(w) = w .* factor and
margin_shift(w) = -eff(w)·shift, so the design matrix is never transformed.

This slice trains with the identity context only (``no_normalization``);
the coefficient-space maps and feature statistics come with the slice that
normalizes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Affine feature normalization; ``factors``/``shifts`` None = identity."""

    factors: Optional[Tensor]  # [d] or None
    shifts: Optional[Tensor]  # [d] or None

    def effective_coefficients(self, w: Tensor) -> Tensor:
        return w if self.factors is None else w * self.factors

    def margin_shift(self, w: Tensor) -> Tensor:
        """-dot(eff(w), shift); added to every margin."""
        if self.shifts is None:
            return torch.zeros((), dtype=w.dtype, device=w.device)
        return -torch.dot(self.effective_coefficients(w), self.shifts)


def no_normalization() -> NormalizationContext:
    return NormalizationContext(factors=None, shifts=None)
