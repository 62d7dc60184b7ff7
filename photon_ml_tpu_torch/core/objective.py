"""GLM objective: weighted-sum pointwise loss over a batch plus L2.

Port of photon_ml_tpu/core/objective.py, keeping the raw/finish split:
``raw_value_and_grad`` returns plain data sums (Σ wt·l, Xᵀr, Σ r) that a
multi-GPU caller would all-reduce, and ``finish_value_and_grad`` applies the
normalization chain rule and L2.  The raw sums come from
``ops.fused_glm.fused_value_and_grad``, and ``raw_hvp`` likewise splits from
``finish_hvp`` over ``ops.fused_glm.fused_hvp``: the CUDA kernel for a batch
on the card, its plain version for a batch on the CPU.

``LaneObjective`` is the same objective over a random-effect bucket held
lanes-first (x [L, cap, d], one GLM per lane, a per-lane L2 [L]): what the
JAX package computes as a ``jax.vmap`` of the plain XLA path, written out as
batched products.

Objectives are weighted SUMS, not means, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from photon_ml_tpu_torch.core.batch import DenseBatch, full_f32_matmul
from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.core.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.ops.fused_glm import fused_hvp, fused_value_and_grad

Tensor = torch.Tensor


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

    # -- Hessian-vector product ------------------------------------------------

    def raw_hvp(self, w: Tensor, batch: DenseBatch, v: Tensor) -> Tuple[Tensor, Tensor]:
        """(Xᵀq, Σ q) raw sums, q = wt·l''(z)·(margin derivative along v)."""
        return fused_hvp(self.loss, self.norm.effective_coefficients(w),
                         self.norm.effective_coefficients(v), batch,
                         margin_shift=self.norm.margin_shift(w),
                         v_shift=self.norm.margin_shift(v))

    def finish_hvp(self, v: Tensor, hv_raw: Tensor, q_sum: Tensor) -> Tensor:
        return self._chain(hv_raw, q_sum) + self.reg.l2 * v

    def hvp(self, w: Tensor, batch: DenseBatch, v: Tensor) -> Tensor:
        """H·v = Xnᵀ diag(wt·l'') Xn v + l2·v."""
        return self.finish_hvp(v, *self.raw_hvp(w, batch, v))


def lane_margins(x: Tensor, w: Tensor) -> Tensor:
    """[L, cap] raw margins of lanes-first x [L, cap, d] against w [L, d]."""
    full_f32_matmul()
    return torch.bmm(x, w.unsqueeze(-1)).squeeze(-1)


def _lane_xt(x: Tensor, r: Tensor) -> Tensor:
    """[L, d] = per-lane r [L, cap] @ x [L, cap, d]."""
    full_f32_matmul()
    return torch.bmm(r.unsqueeze(1), x).squeeze(1)


def lane_dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane dot product of [L, d] tensors."""
    return (a * b).sum(-1)


def lane_norm(a: Tensor) -> Tensor:
    """Per-lane Euclidean norm of an [L, d] tensor."""
    return torch.sqrt(lane_dot(a, a))


@dataclasses.dataclass(frozen=True)
class LaneObjective:
    """One GLM per lane over a bucket held lanes-first: ``batch.x`` is
    [L, cap, d] and ``batch.y``/``offset``/``weight`` are [L, cap]; ``l2`` is
    the per-lane L2 weight [L].  No normalization (the coordinates refuse
    it).  Values are [L], gradients and Hessian-vector products [L, d]."""

    loss: PointwiseLoss
    l2: Tensor

    def _safe_margins(self, w: Tensor, batch: DenseBatch) -> Tensor:
        z = lane_margins(batch.x, w) + batch.offset
        return torch.where(batch.weight > 0, z, 0.0)

    def value_and_grad(self, w: Tensor, batch: DenseBatch) -> Tuple[Tensor, Tensor]:
        z = self._safe_margins(w, batch)
        l, d1 = self.loss.loss_and_d1(z, batch.y)
        r = batch.weight * d1
        val = (batch.weight * l).sum(-1) + 0.5 * self.l2 * lane_dot(w, w)
        return val, _lane_xt(batch.x, r) + self.l2[:, None] * w

    def hvp(self, w: Tensor, batch: DenseBatch, v: Tensor) -> Tensor:
        z = self._safe_margins(w, batch)
        q = batch.weight * self.loss.d2(z, batch.y) * lane_margins(batch.x, v)
        return _lane_xt(batch.x, q) + self.l2[:, None] * v
