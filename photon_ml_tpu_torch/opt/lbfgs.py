"""L-BFGS (optionally box-constrained) with a strong-Wolfe line search, and
OWLQN for L1, as host loops.

Port of ``minimize_lbfgs``, ``minimize_owlqn`` and ``two_loop_direction`` in
photon_ml_tpu/opt/lbfgs.py.  The JAX solvers are ``lax.while_loop``s over
circular [m, d] histories; here the loop runs on the host and the history is
a ring of device vectors, so every vector operation stays on the card and the
host sees only scalars: each line-search evaluation and each iteration's
convergence test synchronise once.

Each iteration costs (1 + line-search evaluations) value+gradient passes, as
in the reference.

``box=(lower, upper)`` is the reference's gradient-projection variant: the
start and every trial point are clipped into the box, coordinates at a bound
with the gradient pushing outward are frozen out of the quasi-Newton
direction, and convergence is measured on the projected-gradient residual
``w - clip(w - g, lower, upper)``.

``minimize_lbfgs_lanes`` is the JAX solver as ``jax.vmap`` runs it over the
random-effect lanes: one L-BFGS per lane, every state tensor with a leading
lane axis ([L, m, d] histories, [L] counters), the masked two-loop recursion
of the reference and the lane-batched strong-Wolfe search; its box bounds
are [d] (shared) or [L, d] (per lane).  ``minimize_owlqn_lanes`` is OWLQN in
the same lane form, with a per-lane L1 weight; a single solve (the fixed
effect) runs it as one lane.  A lane's carry freezes once its reason is set;
the host reads one flag per iteration and one per line-search evaluation.
The history slots are written in place.

Every solver records its states in a ``StateTracker`` (``SolverConfig.
track_states``) as the reference does: the initial state, then per
iteration the accepted point's value and (projected or pseudo-) gradient
norm, or the current point's where the line search failed.  A finished
lane records no more, as under ``jax.vmap`` of the reference's loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.objective import lane_dot, lane_norm
from photon_ml_tpu_torch.opt.constraints import project_to_box
from photon_ml_tpu_torch.opt.linesearch import (numpy_scalar_type, strong_wolfe,
                                                strong_wolfe_lanes)
from photon_ml_tpu_torch.opt.types import (SolverConfig, SolverResult, convergence_check,
                                          new_tracker)
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
Box = Optional[Tuple[Tensor, Tensor]]


def _box_maps(box: Box):
    """(project, opt_gradient, free_mask) of a box: the projection onto it
    (None without one), the projected-gradient residual w - clip(w - g),
    zero iff w is KKT-stationary (g itself without a box), and the mask of
    coordinates not held at a bound by an outward gradient (None)."""
    if box is None:
        return None, lambda w, g: g, None
    lower, upper = box

    def opt_gradient(w, g):
        return w - torch.clamp(w - g, lower, upper)

    def free_mask(w, g):
        return ~(((w <= lower) & (g > 0)) | ((w >= upper) & (g < 0)))

    return project_to_box(lower, upper), opt_gradient, free_mask


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
                   config: SolverConfig = SolverConfig(), box: Box = None) -> SolverResult:
    """Minimize a smooth objective with L-BFGS + strong-Wolfe line search,
    inside ``box`` = (lower[d], upper[d]) when one is given."""
    T = numpy_scalar_type(w0.dtype)
    project, opt_gradient, free_mask = _box_maps(box)

    def host(t: Tensor):
        return T(t.item())

    def conv(f_new, f_prev, f0, gn, gn0, it):
        as_t = lambda v: torch.tensor(v)  # numpy scalar -> 0-dim tensor, same dtype
        return int(convergence_check(as_t(f_new), as_t(f_prev), as_t(f0), as_t(gn),
                                     as_t(gn0), it, config.max_iters,
                                     config.tolerance))

    if project is not None:
        w0 = project(w0)
    f0_t, g0 = value_and_grad(w0)
    f0 = host(f0_t)
    g0norm = host(torch.linalg.vector_norm(opt_gradient(w0, g0)))
    w, f, g = w0, f0, g0
    hist = _History(config.history)
    tracker = new_tracker(config, w0)
    if tracker is not None:
        tracker.record(f0, g0norm)
    it = 0
    reason = (ConvergenceReason.GRADIENT_CONVERGED if g0norm == 0.0
              else ConvergenceReason.NOT_CONVERGED)

    while reason == ConvergenceReason.NOT_CONVERGED:
        # bound-active coordinates are frozen out of the direction
        free = None if free_mask is None else free_mask(w, g)
        g_dir = g if free is None else torch.where(free, g, 0.0)
        dvec = two_loop_direction(g_dir, hist)
        if free is not None:
            dvec = torch.where(free, dvec, 0.0)
        if host(torch.dot(g, dvec)) >= 0:
            # the direction lost descent: fall back to steepest descent
            dvec = -g_dir
        gnorm = host(torch.linalg.vector_norm(opt_gradient(w, g)))
        with np.errstate(divide="ignore"):
            alpha0 = (min(T(1.0), T(1.0) / max(gnorm, T(1e-12))) if hist.count == 0
                      else T(1.0))

        def phi_fn(alpha: float, w=w, dvec=dvec):
            wt = w + alpha * dvec
            return value_and_grad(wt if project is None else project(wt))

        ls = strong_wolfe(phi_fn, f, g, dvec, alpha0, c1=config.c1, c2=config.c2,
                          max_evals=config.max_linesearch)

        w_new = w + float(ls.alpha) * dvec
        if project is not None:
            w_new = project(w_new)
        f_new, g_new = ls.phi, ls.g
        s = w_new - w
        y = g_new - g
        sy = host(torch.dot(s, y))
        yy = host(torch.dot(y, y))
        if ls.success and sy > 1e-12 * max(yy, T(1e-30)):
            hist.admit(s, y, float(T(1.0) / sy))

        it += 1
        g_new_norm = host(torch.linalg.vector_norm(opt_gradient(w_new, g_new)))
        reason = ConvergenceReason(conv(f_new, f, f0, g_new_norm, g0norm, it))
        if not ls.success:
            # no Armijo point along any direction we can build
            reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
        else:
            w, f, g = w_new, f_new, g_new
        if tracker is not None:
            tracker.record(f, g_new_norm if ls.success else gnorm)

    return SolverResult(w=w, value=f,
                        grad_norm=host(torch.linalg.vector_norm(opt_gradient(w, g))),
                        iterations=it, reason=int(reason), tracker=tracker)


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


class _LaneHistory:
    """The lanes' circular curvature histories: s, y [L, m, d], rho [L, m],
    count / pos [L]; slots are written in place."""

    def __init__(self, num_l: int, m: int, d: int, dtype, device):
        self.m = m
        self.lanes = torch.arange(num_l, device=device)
        self.s = torch.zeros((num_l, m, d), dtype=dtype, device=device)
        self.y = torch.zeros_like(self.s)
        self.rho = torch.zeros((num_l, m), dtype=dtype, device=device)
        self.count = torch.zeros(num_l, dtype=torch.int64, device=device)
        self.pos = torch.zeros_like(self.count)

    def direction(self, g: Tensor) -> Tensor:
        return two_loop_direction_lanes(g, self.s, self.y, self.rho, self.count, self.pos)

    def admit(self, s: Tensor, y: Tensor, ok: Tensor) -> None:
        """Store the pair (s, y) in the lanes where ``ok`` holds and the pair
        has positive curvature s·y > 1e-12·y·y."""
        lanes, pos = self.lanes, self.pos
        sy = lane_dot(s, y)
        admit = ok & (sy > 1e-12 * torch.clamp(lane_dot(y, y), min=1e-30))
        self.s[lanes, pos] = torch.where(admit[:, None], s, self.s[lanes, pos])
        self.y[lanes, pos] = torch.where(admit[:, None], y, self.y[lanes, pos])
        self.rho[lanes, pos] = torch.where(admit, 1.0 / torch.where(sy == 0, 1.0, sy),
                                           self.rho[lanes, pos])
        self.pos = torch.where(admit, (pos + 1) % self.m, pos)
        self.count = torch.where(admit, torch.clamp(self.count + 1, max=self.m),
                                 self.count)


def _first_step(gnorm: Tensor, count: Tensor) -> Tensor:
    """The first trial step: 1 / ||g|| (at most 1) before any curvature pair
    is stored, then 1."""
    return torch.where(count == 0, torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0),
                       1.0)


def _code(reason, device) -> Tensor:
    return torch.tensor(int(reason), dtype=torch.int32, device=device)


def minimize_lbfgs_lanes(value_and_grad: ValueAndGrad, w0: Tensor,
                         config: SolverConfig = SolverConfig(),
                         box: Box = None) -> SolverResult:
    """One L-BFGS + strong-Wolfe solve per lane, inside ``box`` = (lower,
    upper) when one is given ([d] for every lane, or [L, d]).

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives ([L], [L, d]).  The result
    holds w [L, d] and [L] values, gradient norms, iterations and reasons."""
    num_l, d = w0.shape
    dev = w0.device
    project, opt_gradient, free_mask = _box_maps(box)
    if project is not None:
        w0 = project(w0)
    f0, g0 = value_and_grad(w0)
    g0norm = lane_norm(opt_gradient(w0, g0))
    w, f, g = w0, f0, g0
    hist = _LaneHistory(num_l, config.history, d, w0.dtype, dev)
    tracker = new_tracker(config, w0, num_l)
    if tracker is not None:
        tracker.record(f0, g0norm)
    it = torch.zeros(num_l, dtype=torch.int32, device=dev)
    reason = torch.where(g0norm == 0.0, _code(ConvergenceReason.GRADIENT_CONVERGED, dev),
                         _code(ConvergenceReason.NOT_CONVERGED, dev))
    not_improving = _code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING, dev)

    while True:
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        # bound-active coordinates are frozen out of the direction
        free = None if free_mask is None else free_mask(w, g)
        g_dir = g if free is None else torch.where(free, g, 0.0)
        dvec = hist.direction(g_dir)
        if free is not None:
            dvec = torch.where(free, dvec, 0.0)
        # the direction lost descent: fall back to steepest descent
        dvec = torch.where((lane_dot(g, dvec) >= 0)[:, None], -g_dir, dvec)
        gnorm = lane_norm(opt_gradient(w, g))
        alpha0 = _first_step(gnorm, hist.count)

        def phi_fn(alpha, w=w, dvec=dvec):
            wt = w + alpha[:, None] * dvec
            return value_and_grad(wt if project is None else project(wt))

        ls = strong_wolfe_lanes(phi_fn, f, g, dvec, alpha0, active, c1=config.c1,
                                c2=config.c2, max_evals=config.max_linesearch)

        w_new = w + ls.alpha[:, None] * dvec
        if project is not None:
            w_new = project(w_new)
        f_new, g_new = ls.phi, ls.g
        hist.admit(w_new - w, g_new - g, active & ls.success)

        it_new = it + 1
        g_new_norm = lane_norm(opt_gradient(w_new, g_new))
        r_new = convergence_check(f_new, f, f0, g_new_norm, g0norm, it_new,
                                  config.max_iters, config.tolerance)
        # no Armijo point along any direction we can build
        r_new = torch.where(ls.success, r_new, not_improving)
        keep = active & ls.success
        w = torch.where(keep[:, None], w_new, w)
        f = torch.where(keep, f_new, f)
        g = torch.where(keep[:, None], g_new, g)
        if tracker is not None:
            tracker.record(f, torch.where(keep, g_new_norm, gnorm), active)
        it = torch.where(active, it_new, it)
        reason = torch.where(active, r_new, reason)

    return SolverResult(w=w, value=f, grad_norm=lane_norm(opt_gradient(w, g)),
                        iterations=it, reason=reason, tracker=tracker)


def pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Sub-gradient of f(w) + l1·|w|₁ choosing the steepest orthant at 0."""
    right = g + l1
    left = g - l1
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, 0.0))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


def minimize_owlqn_lanes(value_and_grad: ValueAndGrad, w0: Tensor, l1,
                         config: SolverConfig = SolverConfig()) -> SolverResult:
    """One OWLQN solve of smooth(w) + l1·||w||₁ per lane.

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives the smooth part ([L],
    [L, d]); ``l1`` is a number or an [L] tensor of per-lane weights.  The
    line search backtracks by halving from the orthant-projected trial point
    until the composite objective meets Armijo's condition; the curvature
    history takes smooth gradients.  A lane whose search finds no such point
    keeps its point and stops with OBJECTIVE_NOT_IMPROVING.  The result's
    values are composite and its gradient norms the pseudo-gradients'."""
    num_l, d = w0.shape
    dev, dt = w0.device, w0.dtype
    l1 = torch.as_tensor(l1, dtype=dt, device=dev)
    if l1.dim() == 1:
        l1 = l1[:, None]

    def composite(w, f_smooth):
        return f_smooth + (l1 * w.abs()).sum(-1)

    f0, g0 = value_and_grad(w0)
    pg0norm = lane_norm(pseudo_gradient(w0, g0, l1))
    ff0 = composite(w0, f0)
    w, f, g, full_f = w0, f0, g0, ff0
    hist = _LaneHistory(num_l, config.history, d, dt, dev)
    tracker = new_tracker(config, w0, num_l)
    if tracker is not None:
        tracker.record(ff0, pg0norm)
    it = torch.zeros(num_l, dtype=torch.int32, device=dev)
    reason = torch.where(pg0norm == 0.0, _code(ConvergenceReason.GRADIENT_CONVERGED, dev),
                         _code(ConvergenceReason.NOT_CONVERGED, dev))
    not_improving = _code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING, dev)

    while True:
        active = reason == ConvergenceReason.NOT_CONVERGED
        if not bool(active.any()):
            break
        pg = pseudo_gradient(w, g, l1)
        dvec = hist.direction(pg)
        # align: drop the components that leave the pseudo-gradient's orthant
        dvec = torch.where(dvec * -pg > 0, dvec, 0.0)
        dphi0 = lane_dot(pg, dvec)
        bad = dphi0 >= 0
        dvec = torch.where(bad[:, None], -pg, dvec)
        dphi0 = torch.where(bad, -lane_dot(pg, pg), dphi0)
        # the orthant of the trial region: sign(w), or the steepest one at 0
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
        pgnorm = lane_norm(pg)
        alpha = _first_step(pgnorm, hist.count)

        # backtracking Armijo search on the composite objective; a lane's
        # last trial is kept whether or not it succeeded, and ``ok`` selects
        w_new, f_new, g_new = torch.zeros_like(w), f, g
        ok = torch.zeros(num_l, dtype=torch.bool, device=dev)
        k = 0
        searching = active
        while k < config.max_linesearch and bool(searching.any()):
            wt = w + alpha[:, None] * dvec
            wt = torch.where(wt * xi >= 0, wt, 0.0)  # orthant projection
            ft, gt = value_and_grad(wt)
            ok_t = composite(wt, ft) <= full_f + config.c1 * alpha * dphi0
            w_new = torch.where(searching[:, None], wt, w_new)
            f_new = torch.where(searching, ft, f_new)
            g_new = torch.where(searching[:, None], gt, g_new)
            ok = torch.where(searching, ok_t, ok)
            alpha = torch.where(searching, alpha * 0.5, alpha)
            searching = searching & ~ok
            k += 1

        hist.admit(w_new - w, g_new - g, active & ok)
        ff_new = composite(w_new, f_new)
        it_new = it + 1
        pg_new_norm = lane_norm(pseudo_gradient(w_new, g_new, l1))
        r_new = convergence_check(ff_new, full_f, ff0, pg_new_norm, pg0norm, it_new,
                                  config.max_iters, config.tolerance)
        r_new = torch.where(ok, r_new, not_improving)
        keep = active & ok
        w = torch.where(keep[:, None], w_new, w)
        f = torch.where(keep, f_new, f)
        g = torch.where(keep[:, None], g_new, g)
        full_f = torch.where(keep, ff_new, full_f)
        if tracker is not None:
            tracker.record(full_f, torch.where(keep, pg_new_norm, pgnorm), active)
        it = torch.where(active, it_new, it)
        reason = torch.where(active, r_new, reason)

    return SolverResult(w=w, value=full_f, grad_norm=lane_norm(pseudo_gradient(w, g, l1)),
                        iterations=it, reason=reason, tracker=tracker)
