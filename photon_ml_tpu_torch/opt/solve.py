"""Solver factories: a GLMObjective and an optimizer bound into
``solve(w0, batch) -> SolverResult``.

Port of ``make_solver`` in photon_ml_tpu/opt/solve.py for L-BFGS and TRON,
with the default configuration chosen by optimizer.  TRON refuses L1 (a
ValueError, as in the reference); the L1 regime (OWLQN) is a later slice and
raises NotImplementedError naming its ROADMAP item.

``make_lane_solver`` is the random-effect form: the JAX package ``vmap``s the
same solve over a bucket's lanes; here the lane-batched solvers take the
bucket lanes-first with a per-lane L2 and a shared normalization context.

``compute_variances`` is the reference's coefficient variances: SIMPLE is
1 / diag(H) (a zero diagonal gives 0), not the inverse-Hessian diagonal;
FULL is diag(H⁻¹) by Cholesky.  It takes a ``LaneObjective`` for a
lanes-first bucket as well; ``compute_soa_variances`` is its form for the
lanes-last buckets of the SoA Newton path.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.core.batch import Batch, DenseBatch
from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.core.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.core.objective import (GLMObjective, LaneObjective,
                                                soa_hessian, soa_hessian_diag)
from photon_ml_tpu_torch.opt.lbfgs import minimize_lbfgs, minimize_lbfgs_lanes
from photon_ml_tpu_torch.opt.tron import minimize_tron
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult
from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType
from photon_ml_tpu_torch.utils.linalg import cholesky_inverse

Tensor = torch.Tensor


def check_supported(optimizer: OptimizerType, l1: float) -> None:
    """Refuse what the port does not carry: TRON with L1 is not an optimizer
    (ValueError); OWLQN is not ported yet (NotImplementedError)."""
    if optimizer == OptimizerType.TRON and l1 > 0.0:
        raise ValueError("TRON does not support L1 regularization (reference parity)")
    if optimizer == OptimizerType.OWLQN or l1 > 0.0:
        raise NotImplementedError(
            "L1 regularization / OWLQN is not ported yet: ROADMAP.md "
            "'Modules still to port', item 3, opt/lbfgs.py OWLQN")
    if optimizer not in (OptimizerType.LBFGS, OptimizerType.TRON):
        raise ValueError(f"unknown optimizer {optimizer!r}")


def default_config(optimizer: OptimizerType) -> SolverConfig:
    return (SolverConfig.tron_default() if optimizer == OptimizerType.TRON
            else SolverConfig.lbfgs_default())


def make_solver(objective: GLMObjective, optimizer: OptimizerType = OptimizerType.LBFGS,
                config: Optional[SolverConfig] = None
                ) -> Callable[[Tensor, DenseBatch], SolverResult]:
    """Build solve(w0, batch) for one GLM coordinate."""
    check_supported(optimizer, objective.reg.l1)
    config = config or default_config(optimizer)

    if optimizer == OptimizerType.LBFGS:

        def solve_lbfgs(w0: Tensor, batch: DenseBatch) -> SolverResult:
            return minimize_lbfgs(lambda w: objective.value_and_grad(w, batch), w0,
                                  config)

        return solve_lbfgs

    def solve_tron(w0: Tensor, batch: DenseBatch) -> SolverResult:
        # TRON over one lane; the Hessian-vector products are the fused kernel's
        def value_and_grad(w):
            f, g = objective.value_and_grad(w[0], batch)
            return f.reshape(1), g[None]

        res = minimize_tron(value_and_grad,
                            lambda w, v: objective.hvp(w[0], batch, v[0])[None],
                            w0[None], config)
        return SolverResult(w=res.w[0], value=res.value[0].item(),
                            grad_norm=res.grad_norm[0].item(),
                            iterations=int(res.iterations[0]), reason=int(res.reason[0]))

    return solve_tron


def make_lane_solver(loss: PointwiseLoss, optimizer: OptimizerType,
                     config: Optional[SolverConfig] = None,
                     norm: Optional[NormalizationContext] = None
                     ) -> Callable[[Tensor, DenseBatch, Tensor], SolverResult]:
    """Build solve(w0 [L, d], lanes-first batch, l2 [L]) for a bucket of
    random-effect lanes, one GLM per lane, in the transformed space of
    ``norm`` (shared by every lane)."""
    check_supported(optimizer, 0.0)
    config = config or default_config(optimizer)
    norm = norm or no_normalization()

    def solve_lanes(w0: Tensor, batch: DenseBatch, l2: Tensor) -> SolverResult:
        obj = LaneObjective(loss, l2, norm)
        vg = lambda w: obj.value_and_grad(w, batch)
        if optimizer == OptimizerType.TRON:
            return minimize_tron(vg, lambda w, v: obj.hvp(w, batch, v), w0, config)
        return minimize_lbfgs_lanes(vg, w0, config)

    return solve_lanes


def _variances(kind: VarianceComputationType, diag: Callable[[], Tensor],
               hessian: Callable[[], Tensor]) -> Optional[Tensor]:
    """SIMPLE from the Hessian diagonal, FULL from the Hessian (either [d]
    and [d, d], or stacked over lanes); None for NONE."""
    if kind == VarianceComputationType.NONE:
        return None
    if kind == VarianceComputationType.SIMPLE:
        d = diag()
        return 1.0 / torch.where(d == 0, torch.full_like(d, float("inf")), d)
    if kind == VarianceComputationType.FULL:
        return torch.diagonal(cholesky_inverse(hessian()), dim1=-2, dim2=-1)
    raise ValueError(f"unknown variance computation type {kind!r}")


def compute_variances(objective: "GLMObjective | LaneObjective", w: Tensor, batch: Batch,
                      kind: VarianceComputationType) -> Optional[Tensor]:
    """Coefficient variances at ``w``: [d] for a ``GLMObjective``, [L, d]
    for a ``LaneObjective`` over a lanes-first bucket (w [L, d])."""
    return _variances(kind, lambda: objective.hessian_diag(w, batch),
                      lambda: objective.hessian(w, batch))


def compute_soa_variances(loss: PointwiseLoss, w_t: Tensor, x_t: Tensor, y_t: Tensor,
                          off_t: Tensor, wt_t: Tensor, l2: Tensor,
                          kind: VarianceComputationType) -> Optional[Tensor]:
    """[L, d] per-lane variances of a lanes-last bucket (w_t [d, L], x_t
    [cap, d, L], the rest [cap, L]), computed in that layout."""
    args = (loss, w_t, x_t, y_t, off_t, wt_t, l2)
    return _variances(kind, lambda: soa_hessian_diag(*args).T, lambda: soa_hessian(*args))
