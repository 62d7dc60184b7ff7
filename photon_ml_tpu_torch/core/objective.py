"""GLM objective: weighted-sum pointwise loss over a batch plus L2.

Port of photon_ml_tpu/core/objective.py, keeping the raw/finish split:
``raw_value_and_grad`` returns plain data sums (Σ wt·l, Xᵀr, Σ r) that a
multi-GPU caller would all-reduce, and ``finish_value_and_grad`` applies the
normalization chain rule and L2.  The raw sums come from
``ops.fused_glm.fused_value_and_grad``: the CUDA kernel for a batch on the
card, its plain version for a batch on the CPU.

Objectives are weighted SUMS, not means, as in the reference.
Hessian-vector products belong to TRON, a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from photon_ml_tpu_torch.core.batch import DenseBatch
from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.core.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.ops.fused_glm import fused_value_and_grad

Tensor = torch.Tensor

_TRON_SLICE = ("Hessian-vector products are not ported yet: ROADMAP.md "
               "'Next slices', TRON + _hvp_kernel")


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    loss: PointwiseLoss
    reg: Regularization = Regularization()
    norm: NormalizationContext = dataclasses.field(default_factory=no_normalization)

    def with_reg(self, reg: Regularization) -> "GLMObjective":
        return dataclasses.replace(self, reg=reg)

    # -- margins -----------------------------------------------------------

    def margins(self, w: Tensor, batch: DenseBatch) -> Tensor:
        eff = self.norm.effective_coefficients(w)
        return batch.margins(eff) + batch.offset + self.norm.margin_shift(w)

    def _safe_margins(self, w: Tensor, batch: DenseBatch) -> Tensor:
        """Margins with weight-0 rows zeroed, so unbounded losses stay finite
        on padded rows."""
        return torch.where(batch.weight > 0, self.margins(w, batch), 0.0)

    def l2_term(self, w: Tensor) -> Tensor:
        return 0.5 * self.reg.l2 * torch.dot(w, w)

    # -- gradient ------------------------------------------------------------

    def _chain(self, g_raw: Tensor, r_sum: Tensor) -> Tensor:
        """Normalization chain rule: g = factor * (Xᵀr - (Σr)·shift)."""
        g = g_raw
        if self.norm.shifts is not None:
            g = g - r_sum * self.norm.shifts
        if self.norm.factors is not None:
            g = g * self.norm.factors
        return g

    def raw_value_and_grad(self, w: Tensor, batch: DenseBatch
                           ) -> Tuple[Tensor, Tensor, Tensor]:
        """(Σ wt·l, Xᵀr, Σ r) with no regularization or chain rule applied."""
        eff = self.norm.effective_coefficients(w)
        return fused_value_and_grad(self.loss, eff, batch,
                                    margin_shift=self.norm.margin_shift(w))

    def finish_value_and_grad(self, w: Tensor, raw_val: Tensor, g_raw: Tensor,
                              r_sum: Tensor) -> Tuple[Tensor, Tensor]:
        val = raw_val + self.l2_term(w)
        g = self._chain(g_raw, r_sum) + self.reg.l2 * w
        return val, g

    def value_and_grad(self, w: Tensor, batch: DenseBatch) -> Tuple[Tensor, Tensor]:
        return self.finish_value_and_grad(w, *self.raw_value_and_grad(w, batch))

    # -- curvature (TRON slice) ------------------------------------------------

    def raw_hvp(self, w: Tensor, batch: DenseBatch, v: Tensor):
        raise NotImplementedError(_TRON_SLICE)

    def hvp(self, w: Tensor, batch: DenseBatch, v: Tensor):
        raise NotImplementedError(_TRON_SLICE)
