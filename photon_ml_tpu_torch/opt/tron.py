"""TRON: trust-region Newton with a truncated conjugate-gradient inner solver,
over a leading lane axis.

Port of photon_ml_tpu/opt/tron.py (itself LIBLINEAR's TRON as photon-lib
carries it): truncated CG (at most ``max_cg`` steps, forcing tolerance
xi = 0.1), the trust-region update with (eta0, eta1, eta2) =
(1e-4, 0.25, 0.75) and (sigma1, sigma2, sigma3) = (0.25, 0.5, 4), and up to
5 consecutive rejected steps.

The JAX solver is two nested ``lax.while_loop``s, which the random effects
run under ``jax.vmap``.  Here one solver serves both: every state tensor
carries a leading lane axis [L, ...], and per-lane masks reproduce the
vmapped loops exactly.  A lane's carry freezes once its own loop condition is
false; each loop runs while any lane's condition holds.  The host reads one
flag per CG step and one per outer iteration.  The fixed effect runs it with
one lane, its Hessian-vector products from the fused CUDA kernel.  Each
lane's states go to a ``StateTracker``, the reference's record: the initial
state, then the value and gradient norm after every outer iteration it runs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from photon_ml_tpu_torch.core.objective import lane_dot, lane_norm
from photon_ml_tpu_torch.opt.types import (SolverConfig, SolverResult, convergence_check,
                                          new_tracker)
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0
XI = 0.1  # CG forcing tolerance
MAX_IMPROVEMENT_FAILURES = 5


def _col(t: Tensor) -> Tensor:
    return t[:, None]


def _code(reason: ConvergenceReason, like: Tensor) -> Tensor:
    return torch.tensor(int(reason), dtype=torch.int32, device=like.device)


def _truncated_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                  max_cg: int, active: Tensor) -> Tuple[Tensor, Tensor]:
    """Approximately solve H p = -g inside ||p|| <= delta, per lane; lanes
    with ``active`` False are left at p = 0.  Returns (p, Hp)."""
    gnorm = lane_norm(g)
    tol = XI * gnorm
    p = torch.zeros_like(g)
    r = -g
    d = r
    rr = lane_dot(r, r)
    it = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    done = gnorm <= tol
    inf = torch.tensor(float("inf"), dtype=g.dtype, device=g.device)
    while True:
        run = active & ~done & (it < max_cg)
        if not bool(run.any()):
            break
        hd = hvp(d)
        dhd = lane_dot(d, hd)
        # non-positive curvature along d: march to the boundary
        alpha = torch.where(dhd > 0, rr / torch.where(dhd == 0, 1.0, dhd), inf)
        p_try = p + _col(torch.where(torch.isfinite(alpha), alpha, 0.0)) * d
        crosses = (lane_norm(p_try) >= delta) | ~torch.isfinite(alpha) | (dhd <= 0)

        # tau >= 0 solving ||p + tau d|| = delta (boundary intersection)
        pd, dd, pp = lane_dot(p, d), lane_dot(d, d), lane_dot(p, p)
        disc = pd * pd + dd * (delta * delta - pp)
        tau = (-pd + torch.sqrt(torch.clamp(disc, min=0.0))) / torch.where(dd == 0, 1.0, dd)
        p_bound = p + _col(tau) * d

        p_new = torch.where(_col(crosses), p_bound, p_try)
        r_new = r - _col(torch.where(crosses, tau, alpha)) * hd
        rr_new = lane_dot(r_new, r_new)
        beta = rr_new / torch.where(rr == 0, 1.0, rr)
        d_new = r_new + _col(beta) * d
        done_new = crosses | (torch.sqrt(rr_new) <= tol)

        p = torch.where(_col(run), p_new, p)
        r = torch.where(_col(run), r_new, r)
        d = torch.where(_col(run), d_new, d)
        rr = torch.where(run, rr_new, rr)
        done = torch.where(run, done_new, done)
        it = torch.where(run, it + 1, it)
    # Hp = -g - r (CG invariant r = -g - Hp)
    return p, -g - r


def minimize_tron(value_and_grad: Callable[[Tensor], Tuple[Tensor, Tensor]],
                  hvp_at: Callable[[Tensor, Tensor], Tensor], w0: Tensor,
                  config: SolverConfig = SolverConfig.tron_default()) -> SolverResult:
    """Minimize twice-differentiable objectives, one per lane, by trust-region
    Newton.

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives ([L], [L, d]) and
    ``hvp_at(w, v)`` the [L, d] Hessian-vector products at w.  The result
    holds w [L, d] and [L] values, gradient norms, iterations and reasons."""
    f0, g0 = value_and_grad(w0)
    g0norm = lane_norm(g0)
    w, f, g = w0, f0, g0
    delta = g0norm
    num_l = w0.shape[0]
    tracker = new_tracker(config, w0, num_l)
    if tracker is not None:
        tracker.record(f0, g0norm)
    it = torch.zeros(num_l, dtype=torch.int32, device=w0.device)
    failures = torch.zeros_like(it)
    reason = torch.where(g0norm == 0.0,
                         _code(ConvergenceReason.GRADIENT_CONVERGED, w0),
                         _code(ConvergenceReason.NOT_CONVERGED, w0))
    not_improving = _code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING, w0)
    max_iterations = _code(ConvergenceReason.MAX_ITERATIONS, w0)
    not_converged = _code(ConvergenceReason.NOT_CONVERGED, w0)

    while True:
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        p, hp = _truncated_cg(lambda v: hvp_at(w, v), g, delta, config.max_cg, active)

        w_try = w + p
        f_try, g_try = value_and_grad(w_try)
        actual = f - f_try
        gs = lane_dot(g, p)
        predicted = -(gs + 0.5 * lane_dot(p, hp))
        ratio = actual / torch.where(predicted == 0, 1.0, predicted)

        snorm = lane_norm(p)
        # LIBLINEAR's radius update
        denom = f_try - f - gs
        alpha = torch.where(
            denom <= 0, SIGMA3,
            torch.clamp(-0.5 * (gs / torch.where(denom == 0, 1.0, denom)), min=SIGMA1))
        radius = alpha * snorm
        delta_new = torch.where(
            ratio < ETA0,
            torch.minimum(torch.clamp(alpha, min=SIGMA1) * snorm, SIGMA2 * delta),
            torch.where(
                ratio < ETA1,
                torch.maximum(SIGMA1 * delta, torch.minimum(radius, SIGMA2 * delta)),
                torch.where(
                    ratio < ETA2,
                    torch.maximum(SIGMA1 * delta, torch.minimum(radius, SIGMA3 * delta)),
                    torch.maximum(delta, torch.minimum(radius, SIGMA3 * delta)))))

        accept = (ratio > ETA0) & (actual > 0)
        w_new = torch.where(_col(accept), w_try, w)
        f_new = torch.where(accept, f_try, f)
        g_new = torch.where(_col(accept), g_try, g)
        failures_new = torch.where(accept, 0, failures + 1).to(torch.int32)

        it_new = it + 1
        g_new_norm = lane_norm(g_new)
        r_new = convergence_check(f_new, f, f0, g_new_norm, g0norm, it_new,
                                  config.max_iters, config.tolerance)
        # only accepted steps can claim convergence (a rejected step has
        # f_new == f trivially); rejected steps retry, or give up after
        # MAX_IMPROVEMENT_FAILURES in a row
        r_new = torch.where(
            accept, r_new,
            torch.where(failures_new >= MAX_IMPROVEMENT_FAILURES, not_improving,
                        torch.where(it_new >= config.max_iters, max_iterations,
                                    not_converged)))

        w = torch.where(_col(active), w_new, w)
        f = torch.where(active, f_new, f)
        g = torch.where(_col(active), g_new, g)
        delta = torch.where(active, delta_new, delta)
        it = torch.where(active, it_new, it)
        failures = torch.where(active, failures_new, failures)
        reason = torch.where(active, r_new, reason)
        if tracker is not None:
            tracker.record(f_new, g_new_norm, active)

    return SolverResult(w=w, value=f, grad_norm=lane_norm(g), iterations=it, reason=reason,
                        tracker=tracker)
