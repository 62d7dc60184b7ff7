"""Solver configuration, result, state tracking and the convergence contract.

Port of photon_ml_tpu/opt/types.py.  The solvers run as ``cond`` / ``body``
loops over tensors (``opt/loop.while_loop``), as the reference's run inside
``lax.while_loop``; the result is a plain dataclass of tensors.

``StateTracker`` is the per-iteration history (the reference's
OptimizationStatesTracker): values and gradient norms in device tensors of
[max_iters + 1] slots, or [L, max_iters + 1] over lanes, padded with nan,
slot 0 the initial state.  ``record`` writes a slot by ``scatter_`` at each
lane's ``num_states`` and never reads a device value on the host, so a
solver loop that records pays no synchronisation for it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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
    track_states: bool = True  # the result carries its StateTracker

    @classmethod
    def lbfgs_default(cls) -> "SolverConfig":
        return cls(max_iters=100, tolerance=1e-7)

    @classmethod
    def tron_default(cls) -> "SolverConfig":
        return cls(max_iters=15, tolerance=1e-5, max_cg=20)


@dataclasses.dataclass
class StateTracker:
    """Per-iteration history: ``values[..., i]`` and ``grad_norms[..., i]``
    hold state i for i < ``num_states`` (an int32 tensor, one per lane);
    later slots stay nan."""

    values: Tensor
    grad_norms: Tensor
    num_states: Tensor

    @classmethod
    def init(cls, max_iters: int, dtype, device=None,
             lanes: Optional[int] = None) -> "StateTracker":
        """An empty tracker of ``max_iters + 1`` slots, over ``lanes`` lanes
        when given."""
        lead = () if lanes is None else (lanes,)
        values = torch.full(lead + (max_iters + 1,), float("nan"), dtype=dtype,
                            device=device)
        return cls(values=values, grad_norms=values.clone(),
                   num_states=torch.zeros(lead, dtype=torch.int32, device=device))

    def _like(self, v) -> Tensor:
        """``v`` as a tensor of the lanes' shape on the tracker's device; a
        host number is filled in on the device, never copied there."""
        lead = self.num_states.shape
        if isinstance(v, Tensor):
            return v.to(self.values.dtype).expand(lead)
        return torch.full(lead, float(v), dtype=self.values.dtype,
                          device=self.values.device)

    def record(self, value, grad_norm, active: Optional[Tensor] = None) -> "StateTracker":
        """Write (value, grad_norm) into slot ``num_states`` of every lane
        (of the lanes where ``active`` holds) and count it; in place,
        returning the tracker."""
        slot = self.num_states.clamp(max=self.values.shape[-1] - 1).long().unsqueeze(-1)
        for hist, v in ((self.values, value), (self.grad_norms, grad_norm)):
            v = self._like(v).unsqueeze(-1)
            if active is not None:
                v = torch.where(active.unsqueeze(-1), v, hist.gather(-1, slot))
            hist.scatter_(-1, slot, v)
        self.num_states += 1 if active is None else active.to(torch.int32)
        return self

    def lane(self, i: int) -> "StateTracker":
        """Lane ``i`` of a lane tracker, as a single solve's."""
        return StateTracker(values=self.values[i], grad_norms=self.grad_norms[i],
                            num_states=self.num_states[i])


def new_tracker(config: "SolverConfig", like: Tensor,
                lanes: Optional[int] = None) -> Optional[StateTracker]:
    """A solve's empty tracker at ``like``'s dtype and device; None when
    ``config.track_states`` is off."""
    if not config.track_states:
        return None
    return StateTracker.init(config.max_iters, like.dtype, like.device, lanes)


@dataclasses.dataclass
class SolverResult:
    """Final solver output.  ``reason`` is the ConvergenceReason code, an
    int32 tensor: 0-d for a single solve, over lanes for batched solves.
    ``tracker`` is the solve's StateTracker (None when states are not
    tracked, and for the SoA Newton solver)."""

    w: Tensor
    value: "Tensor | float"
    grad_norm: "Tensor | float"
    iterations: "Tensor | int"
    reason: "Tensor | int"
    tracker: Optional[StateTracker] = None

    def convergence_reason(self) -> ConvergenceReason:
        return ConvergenceReason(int(self.reason))


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
    ``iteration`` is an integer tensor (the solvers' counters) or an int.
    """
    tols = convergence_tolerances(init_value, init_grad_norm, tolerance)
    if not isinstance(iteration, Tensor):
        iteration = torch.full(value.shape, iteration, dtype=torch.int32, device=value.device)
    return converged(value, prev_value, grad_norm, iteration, max_iters, *tols)


def convergence_tolerances(init_value: Tensor, init_grad_norm: Tensor,
                           tolerance: float) -> Tuple[Tensor, Tensor]:
    """The solve's fixed tolerances: (tol * max(|f_0|, tiny), the floor of
    the function tolerance; tol * max(||g_0||, tiny), the gradient's)."""
    tiny = torch.finfo(init_value.dtype).tiny
    return (tolerance * torch.clamp(init_value.abs(), min=tiny),
            tolerance * torch.clamp(init_grad_norm, min=tiny))


def converged(value: Tensor, prev_value: Tensor, grad_norm: Tensor, iteration: Tensor,
              max_iters: int, f_floor: Tensor, g_tol: Tensor) -> Tensor:
    """``convergence_check`` with the solve's ``convergence_tolerances``: the
    reason codes go in as numbers, so no call makes a tensor from a host
    number."""
    ulp = torch.finfo(value.dtype).eps * torch.maximum(value.abs(), prev_value.abs())
    f_tol = torch.maximum(f_floor, PLATEAU_ULPS * ulp)
    last = (iteration >= max_iters).to(torch.int32) * int(ConvergenceReason.MAX_ITERATIONS)
    return torch.where((value - prev_value).abs() <= f_tol,
                       int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
                       torch.where(grad_norm <= g_tol,
                                   int(ConvergenceReason.GRADIENT_CONVERGED), last))


def _host(a) -> np.ndarray:
    """A number, array or tensor as a numpy array of at least one dimension."""
    if isinstance(a, Tensor):
        a = a.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(a))


def summarize_solver_results(results, valid_masks=None) -> dict:
    """Statistics over many solver results, scalar or over lanes: counts of
    convergence reasons and summaries of iterations and final values (the
    reference's RandomEffectOptimizationTracker summary).  ``valid_masks``:
    one boolean lane mask (or None) per result; masked-out lanes, such as a
    bucket's padding, are left out."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    its, reasons, values = [], [], []
    for k, res in enumerate(results):
        it, rs, va = _host(res.iterations), _host(res.reason), _host(res.value)
        mask = np.ones(it.shape, bool)
        if valid_masks is not None and valid_masks[k] is not None:
            mask = _host(valid_masks[k]).astype(bool)
        its.append(it[mask])
        reasons.append(rs[mask])
        values.append(va[mask])
    its = np.concatenate(its) if its else np.zeros(0, np.int32)
    reasons = np.concatenate(reasons) if reasons else np.zeros(0, np.int32)
    values = np.concatenate(values) if values else np.zeros(0)
    if len(its) == 0:
        return {"count": 0}
    return {
        "count": int(len(its)),
        "convergence_reasons": {ConvergenceReason(int(r)).name: int((reasons == r).sum())
                                for r in np.unique(reasons)},
        "iterations": {"mean": float(its.mean()), "max": int(its.max()),
                       "p50": float(np.percentile(its, 50)),
                       "p90": float(np.percentile(its, 90))},
        "final_value": {"mean": float(values.mean()), "max": float(values.max()),
                        "min": float(values.min())},
    }
