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
false; each loop is a ``cond`` / ``body`` pair over ``opt/loop.while_loop``
and runs while any lane's condition holds, read once a CG step and once an
outer iteration.  The fixed effect runs it with one lane, its
Hessian-vector products from the fused CUDA kernel.  Each lane's states go
to a ``StateTracker``, the reference's record: the initial state, then the
value and gradient norm after every outer iteration it runs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from photon_ml_tpu_torch.core.objective import lane_dot, lane_norm
from photon_ml_tpu_torch.opt.loop import replay, while_loop
from photon_ml_tpu_torch.opt.types import (SolverConfig, SolverResult, converged,
                                          convergence_tolerances, new_tracker)
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0
XI = 0.1  # CG forcing tolerance
MAX_IMPROVEMENT_FAILURES = 5

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)


def _col(t: Tensor) -> Tensor:
    return t[:, None]


class _Cg(NamedTuple):
    p: Tensor
    r: Tensor  # residual -g - Hp
    d: Tensor
    rr: Tensor
    it: Tensor  # int32
    done: Tensor
    run: Tensor  # the lane's CG goes on
    tol: Tensor  # the forcing tolerance XI·||g||


def _cg_start(g: Tensor, active: Tensor, max_cg: int) -> _Cg:
    """Truncated CG's first state at p = 0; lanes with ``active`` False do
    not run."""
    gnorm = lane_norm(g)
    r0 = -g
    it0 = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    done0 = gnorm <= XI * gnorm
    return _Cg(torch.zeros_like(g), r0, r0, lane_dot(r0, r0), it0, done0,
               active & ~done0 & (it0 < max_cg), XI * gnorm)


def _cg_step(c: _Cg, hd: Tensor, delta: Tensor, active: Tensor, max_cg: int) -> _Cg:
    """One CG step given H·d (``hd``): toward H p = -g inside ||p|| <= delta,
    stopping at the boundary or along non-positive curvature."""
    run = c.run
    dhd = lane_dot(c.d, hd)
    # non-positive curvature along d: march to the boundary
    alpha = torch.where(dhd > 0, c.rr / torch.where(dhd == 0, 1.0, dhd), float("inf"))
    p_try = c.p + _col(torch.where(torch.isfinite(alpha), alpha, 0.0)) * c.d
    crosses = (lane_norm(p_try) >= delta) | ~torch.isfinite(alpha) | (dhd <= 0)

    # tau >= 0 solving ||p + tau d|| = delta (boundary intersection)
    pd, dd, pp = lane_dot(c.p, c.d), lane_dot(c.d, c.d), lane_dot(c.p, c.p)
    disc = pd * pd + dd * (delta * delta - pp)
    tau = (-pd + torch.sqrt(torch.clamp(disc, min=0.0))) / torch.where(dd == 0, 1.0, dd)
    p_bound = c.p + _col(tau) * c.d

    p_new = torch.where(_col(crosses), p_bound, p_try)
    r_new = c.r - _col(torch.where(crosses, tau, alpha)) * hd
    rr_new = lane_dot(r_new, r_new)
    beta = rr_new / torch.where(c.rr == 0, 1.0, c.rr)
    d_new = r_new + _col(beta) * c.d
    done_new = crosses | (torch.sqrt(rr_new) <= c.tol)

    done = torch.where(run, done_new, c.done)
    it = torch.where(run, c.it + 1, c.it)
    return _Cg(torch.where(_col(run), p_new, c.p), torch.where(_col(run), r_new, c.r),
               torch.where(_col(run), d_new, c.d), torch.where(run, rr_new, c.rr),
               it, done, active & ~done & (it < max_cg), c.tol)


def _truncated_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                  max_cg: int, active: Tensor) -> _Cg:
    """Approximately solve H p = -g inside ||p|| <= delta, per lane; lanes
    with ``active`` False are left at p = 0.  The final state: p, and the
    residual r = -g - Hp (the CG invariant)."""
    def body(c: _Cg) -> _Cg:
        return replay(_cg_step, c, hvp(c.d), delta, active, max_cg)

    return while_loop(lambda c: c.run.any(), body, replay(_cg_start, g, active, max_cg))


class _Tron(NamedTuple):
    w: Tensor
    f: Tensor
    g: Tensor
    delta: Tensor  # trust-region radius
    it: Tensor  # int32
    failures: Tensor  # consecutive rejected steps
    reason: Tensor  # int32
    active: Tensor  # reason == NOT_CONVERGED


def _tron_finish(c: _Tron, cg: _Cg, f_try: Tensor, g_try: Tensor,
                 tols: Tuple[Tensor, Tensor], max_iters: int):
    """The next state from the CG step p and the objective at w + p: the
    trust-region update; also the value and gradient norm an active lane
    records."""
    active = c.active
    w, f, g, delta = c.w, c.f, c.g, c.delta
    p, hp = cg.p, -g - cg.r
    w_try = w + p
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
    failures_new = torch.where(accept, 0, c.failures + 1).to(torch.int32)

    it_new = c.it + 1
    g_new_norm = lane_norm(g_new)
    r_new = converged(f_new, f, g_new_norm, it_new, max_iters, *tols)
    # only accepted steps can claim convergence (a rejected step has
    # f_new == f trivially); rejected steps retry, or give up after
    # MAX_IMPROVEMENT_FAILURES in a row
    r_new = torch.where(
        accept, r_new,
        torch.where(failures_new >= MAX_IMPROVEMENT_FAILURES,
                    int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
                    (it_new >= max_iters).to(torch.int32)
                    * int(ConvergenceReason.MAX_ITERATIONS)))

    reason = torch.where(active, r_new, c.reason)
    nxt = _Tron(torch.where(_col(active), w_new, w), torch.where(active, f_new, f),
                torch.where(_col(active), g_new, g), torch.where(active, delta_new, delta),
                torch.where(active, it_new, c.it),
                torch.where(active, failures_new, c.failures), reason,
                reason == _NOT_CONVERGED)
    return nxt, f_new, g_new_norm


def minimize_tron(value_and_grad: Callable[[Tensor], Tuple[Tensor, Tensor]],
                  hvp_at: Callable[[Tensor, Tensor], Tensor], w0: Tensor,
                  config: SolverConfig = SolverConfig.tron_default()) -> SolverResult:
    """Minimize twice-differentiable objectives, one per lane, by trust-region
    Newton.

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives ([L], [L, d]) and
    ``hvp_at(w, v)`` the [L, d] Hessian-vector products at w.  The result
    holds w [L, d] and [L] values, gradient norms, iterations and reasons.
    On the card the bookkeeping is replayed (``loop.replay``): CG's start
    and each CG step, and the trust-region update, are a graph each; the
    objective and its Hessian-vector products run eagerly between them."""
    f0, g0 = value_and_grad(w0)
    g0norm = lane_norm(g0)
    num_l = w0.shape[0]
    tracker = new_tracker(config, w0, num_l)
    if tracker is not None:
        tracker.record(f0, g0norm)
    it0 = torch.zeros(num_l, dtype=torch.int32, device=w0.device)
    reason0 = (g0norm == 0.0).to(torch.int32) * int(ConvergenceReason.GRADIENT_CONVERGED)
    tols = convergence_tolerances(f0, g0norm, config.tolerance)

    def body(c: _Tron) -> _Tron:
        cg = _truncated_cg(lambda v: hvp_at(c.w, v), c.g, c.delta, config.max_cg, c.active)
        f_try, g_try = value_and_grad(c.w + cg.p)
        ran = c.active.clone() if tracker is not None else None
        nxt, f_new, g_new_norm = replay(_tron_finish, c, cg, f_try, g_try, tols,
                                        config.max_iters)
        if tracker is not None:
            tracker.record(f_new, g_new_norm, ran)
        return nxt

    final = while_loop(lambda c: c.active.any(), body,
                       _Tron(w0, f0, g0, g0norm, it0, torch.zeros_like(it0), reason0,
                             reason0 == _NOT_CONVERGED))
    final = _Tron(*(t.clone() for t in final))  # the replayed graphs' buffers are theirs
    return SolverResult(w=final.w, value=final.f, grad_norm=lane_norm(final.g),
                        iterations=final.it, reason=final.reason, tracker=tracker)
