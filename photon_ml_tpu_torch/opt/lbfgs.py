"""L-BFGS with a strong-Wolfe line search, as a host loop.

Port of ``minimize_lbfgs`` and ``two_loop_direction`` in
photon_ml_tpu/opt/lbfgs.py (the unconstrained path; box constraints and
OWLQN are later slices).  The JAX solver is a ``lax.while_loop`` over a
circular [m, d] history; here the loop runs on the host and the history is a
ring of device vectors, so every vector operation stays on the card and the
host sees only scalars: each line-search evaluation and each iteration's
convergence test synchronise once.

Each iteration costs (1 + line-search evaluations) fused value+gradient
passes, as in the reference.

``minimize_lbfgs_lanes`` is the JAX solver as ``jax.vmap`` runs it over the
random-effect lanes: one L-BFGS per lane, every state tensor with a leading
lane axis ([L, m, d] histories, [L] counters), the masked two-loop recursion
of the reference and the lane-batched strong-Wolfe search.  A lane's carry
freezes once its reason is set; the host reads one flag per iteration and
one per line-search evaluation.  The history slots are written in place.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.objective import lane_dot, lane_norm
from photon_ml_tpu_torch.opt.linesearch import (numpy_scalar_type, strong_wolfe,
                                                strong_wolfe_lanes)
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult, convergence_check
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


class _History:
    """Circular buffer of the last m curvature pairs (s, y) and rho = 1/s·y."""

    def __init__(self, m: int):
        self.m = m
        self.s: List[Optional[Tensor]] = [None] * m
        self.y: List[Optional[Tensor]] = [None] * m
        self.rho: List[float] = [0.0] * m
        self.count = 0
        self.pos = 0

    def newest_first(self, j: int) -> int:
        return (self.pos - 1 - j) % self.m

    def admit(self, s: Tensor, y: Tensor, rho: float) -> None:
        self.s[self.pos], self.y[self.pos], self.rho[self.pos] = s, y, rho
        self.pos = (self.pos + 1) % self.m
        self.count = min(self.count + 1, self.m)


def two_loop_direction(g: Tensor, hist: _History) -> Tensor:
    """The L-BFGS two-loop recursion over the valid history, newest first."""
    q = g
    alphas = {}
    for j in range(hist.count):
        i = hist.newest_first(j)
        a = hist.rho[i] * torch.dot(hist.s[i], q)
        q = q - a * hist.y[i]
        alphas[i] = a
    if hist.count > 0:
        # initial Hessian scaling gamma = s·y / y·y of the newest pair
        newest = hist.newest_first(0)
        sy = torch.dot(hist.s[newest], hist.y[newest])
        yy = torch.dot(hist.y[newest], hist.y[newest])
        gamma = torch.where(yy > 0, sy / torch.where(yy == 0, 1.0, yy), 1.0)
        r = gamma * q
    else:
        r = q
    for jj in reversed(range(hist.count)):  # oldest first
        i = hist.newest_first(jj)
        b = hist.rho[i] * torch.dot(hist.y[i], r)
        r = r + (alphas[i] - b) * hist.s[i]
    return -r


def minimize_lbfgs(value_and_grad: ValueAndGrad, w0: Tensor,
                   config: SolverConfig = SolverConfig()) -> SolverResult:
    """Minimize a smooth objective with L-BFGS + strong-Wolfe line search."""
    T = numpy_scalar_type(w0.dtype)

    def host(t: Tensor):
        return T(t.item())

    def conv(f_new, f_prev, f0, gn, gn0, it):
        as_t = lambda v: torch.tensor(v)  # numpy scalar -> 0-dim tensor, same dtype
        return int(convergence_check(as_t(f_new), as_t(f_prev), as_t(f0), as_t(gn),
                                     as_t(gn0), it, config.max_iters,
                                     config.tolerance))

    f0_t, g0 = value_and_grad(w0)
    f0 = host(f0_t)
    g0norm = host(torch.linalg.vector_norm(g0))
    w, f, g = w0, f0, g0
    hist = _History(config.history)
    it = 0
    reason = (ConvergenceReason.GRADIENT_CONVERGED if g0norm == 0.0
              else ConvergenceReason.NOT_CONVERGED)

    while reason == ConvergenceReason.NOT_CONVERGED:
        dvec = two_loop_direction(g, hist)
        if host(torch.dot(g, dvec)) >= 0:
            # the direction lost descent: fall back to steepest descent
            dvec = -g
        gnorm = host(torch.linalg.vector_norm(g))
        with np.errstate(divide="ignore"):
            alpha0 = (min(T(1.0), T(1.0) / max(gnorm, T(1e-12))) if hist.count == 0
                      else T(1.0))

        def phi_fn(alpha: float, w=w, dvec=dvec):
            return value_and_grad(w + alpha * dvec)

        ls = strong_wolfe(phi_fn, f, g, dvec, alpha0, c1=config.c1, c2=config.c2,
                          max_evals=config.max_linesearch)

        w_new = w + float(ls.alpha) * dvec
        f_new, g_new = ls.phi, ls.g
        s = w_new - w
        y = g_new - g
        sy = host(torch.dot(s, y))
        yy = host(torch.dot(y, y))
        if ls.success and sy > 1e-12 * max(yy, T(1e-30)):
            hist.admit(s, y, float(T(1.0) / sy))

        it += 1
        g_new_norm = host(torch.linalg.vector_norm(g_new))
        reason = ConvergenceReason(conv(f_new, f, f0, g_new_norm, g0norm, it))
        if not ls.success:
            # no Armijo point along any direction we can build
            reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
        else:
            w, f, g = w_new, f_new, g_new

    return SolverResult(w=w, value=f, grad_norm=host(torch.linalg.vector_norm(g)),
                        iterations=it, reason=int(reason))


def two_loop_direction_lanes(g: Tensor, s_hist: Tensor, y_hist: Tensor, rho: Tensor,
                             count: Tensor, pos: Tensor) -> Tensor:
    """The masked two-loop recursion per lane: g [L, d], histories [L, m, d],
    rho [L, m], count/pos [L].  Slots at or past a lane's count are no-ops."""
    num_l, m, _ = s_hist.shape
    lanes = torch.arange(num_l, device=g.device)
    q = g
    alphas = torch.zeros_like(rho)
    for j in range(m):
        i = (pos - 1 - j) % m  # newest first
        a = rho[lanes, i] * lane_dot(s_hist[lanes, i], q)
        a = torch.where(j < count, a, 0.0)
        q = q - a[:, None] * y_hist[lanes, i]
        alphas[lanes, i] = a
    # initial Hessian scaling gamma = s·y / y·y of the newest pair
    newest = (pos - 1) % m
    s_new, y_new = s_hist[lanes, newest], y_hist[lanes, newest]
    sy, yy = lane_dot(s_new, y_new), lane_dot(y_new, y_new)
    gamma = torch.where((count > 0) & (yy > 0), sy / torch.where(yy == 0, 1.0, yy), 1.0)
    r = gamma[:, None] * q
    for j in range(m):
        jj = m - 1 - j  # oldest first
        i = (pos - 1 - jj) % m
        b = rho[lanes, i] * lane_dot(y_hist[lanes, i], r)
        upd = (alphas[lanes, i] - b)[:, None] * s_hist[lanes, i]
        r = r + (jj < count).to(r.dtype)[:, None] * upd
    return -r


def minimize_lbfgs_lanes(value_and_grad: ValueAndGrad, w0: Tensor,
                         config: SolverConfig = SolverConfig()) -> SolverResult:
    """One L-BFGS + strong-Wolfe solve per lane.

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives ([L], [L, d]).  The result
    holds w [L, d] and [L] values, gradient norms, iterations and reasons."""
    num_l, d = w0.shape
    m = config.history
    dev, dt = w0.device, w0.dtype
    lanes = torch.arange(num_l, device=dev)

    def code(r):
        return torch.tensor(int(r), dtype=torch.int32, device=dev)

    f0, g0 = value_and_grad(w0)
    g0norm = lane_norm(g0)
    w, f, g = w0, f0, g0
    s_hist = torch.zeros((num_l, m, d), dtype=dt, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((num_l, m), dtype=dt, device=dev)
    count = torch.zeros(num_l, dtype=torch.int64, device=dev)
    pos = torch.zeros_like(count)
    it = torch.zeros(num_l, dtype=torch.int32, device=dev)
    reason = torch.where(g0norm == 0.0, code(ConvergenceReason.GRADIENT_CONVERGED),
                         code(ConvergenceReason.NOT_CONVERGED))
    not_improving = code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)

    while True:
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        dvec = two_loop_direction_lanes(g, s_hist, y_hist, rho, count, pos)
        # the direction lost descent: fall back to steepest descent
        dvec = torch.where((lane_dot(g, dvec) >= 0)[:, None], -g, dvec)
        gnorm = lane_norm(g)
        alpha0 = torch.where(count == 0,
                             torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0),
                             1.0)

        def phi_fn(alpha, w=w, dvec=dvec):
            return value_and_grad(w + alpha[:, None] * dvec)

        ls = strong_wolfe_lanes(phi_fn, f, g, dvec, alpha0, active, c1=config.c1,
                                c2=config.c2, max_evals=config.max_linesearch)

        w_new = w + ls.alpha[:, None] * dvec
        f_new, g_new = ls.phi, ls.g
        s = w_new - w
        y = g_new - g
        sy = lane_dot(s, y)
        admit = active & ls.success & (sy > 1e-12 * torch.clamp(lane_dot(y, y), min=1e-30))
        s_hist[lanes, pos] = torch.where(admit[:, None], s, s_hist[lanes, pos])
        y_hist[lanes, pos] = torch.where(admit[:, None], y, y_hist[lanes, pos])
        rho[lanes, pos] = torch.where(admit, 1.0 / torch.where(sy == 0, 1.0, sy),
                                      rho[lanes, pos])
        pos = torch.where(admit, (pos + 1) % m, pos)
        count = torch.where(admit, torch.clamp(count + 1, max=m), count)

        it_new = it + 1
        r_new = convergence_check(f_new, f, f0, lane_norm(g_new), g0norm, it_new,
                                  config.max_iters, config.tolerance)
        # no Armijo point along any direction we can build
        r_new = torch.where(ls.success, r_new, not_improving)
        keep = active & ls.success
        w = torch.where(keep[:, None], w_new, w)
        f = torch.where(keep, f_new, f)
        g = torch.where(keep[:, None], g_new, g)
        it = torch.where(active, it_new, it)
        reason = torch.where(active, r_new, reason)

    return SolverResult(w=w, value=f, grad_norm=lane_norm(g), iterations=it,
                        reason=reason)
