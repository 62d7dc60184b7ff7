"""Solver factory binding a GLMObjective and an optimizer into
``solve(w0, batch) -> SolverResult``.

Port of ``make_solver`` in photon_ml_tpu/opt/solve.py for L-BFGS.  TRON and
the L1 regime (OWLQN) are later slices and raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.core.batch import DenseBatch
from photon_ml_tpu_torch.core.objective import GLMObjective
from photon_ml_tpu_torch.opt.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult
from photon_ml_tpu_torch.types import OptimizerType

Tensor = torch.Tensor


def check_supported(optimizer: OptimizerType, l1: float) -> None:
    """Refuse what this slice does not carry, naming the ROADMAP item."""
    if optimizer == OptimizerType.TRON:
        raise NotImplementedError(
            "TRON (and its fused Hessian-vector kernel) is not ported yet: "
            "ROADMAP.md 'Next slices', TRON + _hvp_kernel")
    if optimizer == OptimizerType.OWLQN or l1 > 0.0:
        raise NotImplementedError(
            "L1 regularization / OWLQN is not ported yet: ROADMAP.md "
            "'Modules still to port', opt/lbfgs.py OWLQN")
    if optimizer != OptimizerType.LBFGS:
        raise ValueError(f"unknown optimizer {optimizer!r}")


def make_solver(objective: GLMObjective, optimizer: OptimizerType = OptimizerType.LBFGS,
                config: Optional[SolverConfig] = None
                ) -> Callable[[Tensor, DenseBatch], SolverResult]:
    """Build solve(w0, batch) for one GLM coordinate."""
    check_supported(optimizer, objective.reg.l1)
    config = config or SolverConfig.lbfgs_default()

    def solve_lbfgs(w0: Tensor, batch: DenseBatch) -> SolverResult:
        return minimize_lbfgs(lambda w: objective.value_and_grad(w, batch), w0, config)

    return solve_lbfgs
