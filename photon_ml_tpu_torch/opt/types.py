"""Solver configuration, result and the convergence contract.

Port of photon_ml_tpu/opt/types.py.  The JAX solvers run inside
``lax.while_loop``; the port's solvers are host loops, so the result is a
plain dataclass of tensors and Python numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.types import ConvergenceReason

# Working-precision plateau width, in ulps of the objective value.  Shared
# invariant with opt/linesearch.py's approximate-Wolfe slack: the line search
# may accept a step up to PLATEAU_ULPS ulps worse than phi0, and the function
# tolerance is floored at the same width, so a slack-accepted step is
# recognised as converged and the solver never creeps uphill.
PLATEAU_ULPS = 4.0

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver hyperparameters.  Defaults follow the reference: L-BFGS m=10,
    tol=1e-7, maxIter=100; TRON tol=1e-5, maxIter=15, CG <= 20."""

    max_iters: int = 100
    tolerance: float = 1e-7
    history: int = 10  # L-BFGS m
    max_linesearch: int = 25
    c1: float = 1e-4  # Armijo
    c2: float = 0.9  # Wolfe curvature
    max_cg: int = 20  # TRON's truncated-CG steps per outer iteration

    @classmethod
    def lbfgs_default(cls) -> "SolverConfig":
        return cls(max_iters=100, tolerance=1e-7)

    @classmethod
    def tron_default(cls) -> "SolverConfig":
        return cls(max_iters=15, tolerance=1e-5, max_cg=20)


@dataclasses.dataclass
class SolverResult:
    """Final solver output.  ``reason`` is the ConvergenceReason code: an int
    for a single solve, an int32 tensor over lanes for batched solves."""

    w: Tensor
    value: "Tensor | float"
    grad_norm: "Tensor | float"
    iterations: "Tensor | int"
    reason: "Tensor | int"


def convergence_check(value: Tensor, prev_value: Tensor, init_value: Tensor,
                      grad_norm: Tensor, init_grad_norm: Tensor, iteration,
                      max_iters: int, tolerance: float) -> Tensor:
    """The reference's convergence logic, elementwise over tensors of the
    working dtype (0-dim for one solve, [L] for lanes).

    Tolerances are relative to the initial state:
      - FunctionValuesConverged: |f_k - f_{k-1}| <= max(tol * max(|f_0|, tiny),
        PLATEAU_ULPS ulps of f)
      - GradientConverged:       ||g_k|| <= tol * max(||g_0||, tiny)
      - MaxIterations:           k >= max_iters
    Returns int32 reasons (0 = not converged), checked in that order.
    """
    fi = torch.finfo(value.dtype)
    ulp = fi.eps * torch.maximum(value.abs(), prev_value.abs())
    f_tol = torch.maximum(tolerance * torch.clamp(init_value.abs(), min=fi.tiny),
                          PLATEAU_ULPS * ulp)
    g_tol = tolerance * torch.clamp(init_grad_norm, min=fi.tiny)
    func_conv = (value - prev_value).abs() <= f_tol
    grad_conv = grad_norm <= g_tol
    max_iter = torch.as_tensor(iteration, device=value.device) >= max_iters

    def code(r):
        return torch.tensor(int(r), dtype=torch.int32, device=value.device)

    return torch.where(
        func_conv, code(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
        torch.where(grad_conv, code(ConvergenceReason.GRADIENT_CONVERGED),
                    torch.where(max_iter, code(ConvergenceReason.MAX_ITERATIONS),
                                code(ConvergenceReason.NOT_CONVERGED))))
