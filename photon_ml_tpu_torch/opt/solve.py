"""Solver factories: a GLMObjective and an optimizer bound into
``solve(w0, batch) -> SolverResult``.

Port of ``make_solver`` in photon_ml_tpu/opt/solve.py, with the default
configuration chosen by optimizer.  As in the reference, OWLQN runs for
``OptimizerType.OWLQN`` and for L-BFGS with an L1 weight; TRON refuses L1,
and TRON and the L1 regime refuse box constraints (ValueErrors).  L-BFGS,
OWLQN and TRON are each written once, in the lane form: a single solve runs
L-BFGS as ``minimize_lbfgs`` (the lane solver over one lane held without
the lane axis), OWLQN and TRON as one lane.  A solve's result holds 0-d
tensors, as the reference's does; nothing here reads them on the host.

``make_lane_solver`` is the random-effect form: the JAX package ``vmap``s the
same solve over a bucket's lanes; here the lane-batched solvers take the
bucket lanes-first with a per-lane L2 and, per call, a normalization context
(shared, or per-lane factor and shift rows) and optionally a box.

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
from photon_ml_tpu_torch.opt.lbfgs import (Box, minimize_lbfgs, minimize_lbfgs_lanes,
                                           minimize_owlqn_lanes)
from photon_ml_tpu_torch.opt.tron import minimize_tron
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult
from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType
from photon_ml_tpu_torch.utils.linalg import cholesky_inverse

Tensor = torch.Tensor


def check_supported(optimizer: OptimizerType, l1: float) -> None:
    """The reference's refusals: TRON with L1, and an unknown optimizer."""
    if optimizer == OptimizerType.TRON and l1 > 0.0:
        raise ValueError("TRON does not support L1 regularization (reference parity)")
    if optimizer not in (OptimizerType.LBFGS, OptimizerType.TRON, OptimizerType.OWLQN):
        raise ValueError(f"unknown optimizer {optimizer!r}")


def check_box_support(optimizer: OptimizerType, has_l1: bool) -> None:
    """Box constraints are a projected-gradient L-BFGS feature; TRON and the
    L1 / OWLQN regime refuse them."""
    if optimizer == OptimizerType.TRON:
        raise ValueError("TRON does not support box constraints")
    if optimizer == OptimizerType.OWLQN or has_l1:
        raise ValueError("OWLQN does not support box constraints")


def _uses_owlqn(optimizer: OptimizerType, l1: float) -> bool:
    """OWLQN is the solver for OWLQN, and for L-BFGS with an L1 weight."""
    return optimizer == OptimizerType.OWLQN or (optimizer == OptimizerType.LBFGS
                                                and l1 > 0.0)


def default_config(optimizer: OptimizerType) -> SolverConfig:
    return (SolverConfig.tron_default() if optimizer == OptimizerType.TRON
            else SolverConfig.lbfgs_default())


def _one_lane(res: SolverResult) -> SolverResult:
    """A one-lane solve's result, its tracker included, as a single solve's:
    0-d tensors, read nowhere here."""
    return SolverResult(w=res.w[0], value=res.value[0], grad_norm=res.grad_norm[0],
                        iterations=res.iterations[0], reason=res.reason[0],
                        tracker=None if res.tracker is None else res.tracker.lane(0))


def make_solver(objective: GLMObjective, optimizer: OptimizerType = OptimizerType.LBFGS,
                config: Optional[SolverConfig] = None, box: Box = None
                ) -> Callable[[Tensor, Batch], SolverResult]:
    """Build solve(w0, batch) for one GLM coordinate; ``box`` = (lower[d],
    upper[d]) constrains an L-BFGS solve."""
    l1 = objective.reg.l1
    check_supported(optimizer, l1)
    if box is not None:
        check_box_support(optimizer, l1 > 0.0)
    config = config or default_config(optimizer)

    # one lane over the objective as it is (a dense batch keeps its kernel)
    def one_lane(batch: Batch):
        def value_and_grad(w):
            f, g = objective.value_and_grad(w[0], batch)
            return f.reshape(1), g[None]

        return value_and_grad

    if _uses_owlqn(optimizer, l1):

        def solve_owlqn(w0: Tensor, batch: Batch) -> SolverResult:
            return _one_lane(minimize_owlqn_lanes(one_lane(batch), w0[None], l1, config))

        return solve_owlqn

    if optimizer == OptimizerType.LBFGS:

        def solve_lbfgs(w0: Tensor, batch: Batch) -> SolverResult:
            return minimize_lbfgs(lambda w: objective.value_and_grad(w, batch), w0,
                                  config, box=box)

        return solve_lbfgs

    def solve_tron(w0: Tensor, batch: Batch) -> SolverResult:
        # TRON over one lane; the Hessian-vector products are the fused kernel's
        res = minimize_tron(one_lane(batch),
                            lambda w, v: objective.hvp(w[0], batch, v[0])[None],
                            w0[None], config)
        return _one_lane(res)

    return solve_tron


def make_lane_solver(loss: PointwiseLoss, optimizer: OptimizerType,
                     config: Optional[SolverConfig] = None, l1: float = 0.0
                     ) -> Callable[..., SolverResult]:
    """Build solve(w0 [L, d], lanes-first batch, l2 [L], norm=, box=) for a
    bucket of random-effect lanes, one GLM per lane with L1 weight ``l1``, in
    the transformed space of ``norm``: one context shared by every lane, or
    per-lane factor and shift rows [L, d] (None: the identity).  ``box``
    bounds every lane ([d]) or each lane ([L, d])."""
    check_supported(optimizer, l1)
    config = config or default_config(optimizer)
    owlqn = _uses_owlqn(optimizer, l1)

    def solve_lanes(w0: Tensor, batch: DenseBatch, l2: Tensor,
                    norm: Optional[NormalizationContext] = None,
                    box: Box = None) -> SolverResult:
        if box is not None:
            check_box_support(optimizer, l1 > 0.0)
        obj = LaneObjective(loss, l2, norm or no_normalization())
        vg = lambda w: obj.value_and_grad(w, batch)
        if owlqn:
            return minimize_owlqn_lanes(vg, w0, l1, config)
        if optimizer == OptimizerType.TRON:
            return minimize_tron(vg, lambda w, v: obj.hvp(w, batch, v), w0, config)
        return minimize_lbfgs_lanes(vg, w0, config, box=box)

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
