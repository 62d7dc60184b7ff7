"""L-BFGS (optionally box-constrained) with a strong-Wolfe line search, and
OWLQN for L1, as ``while_loop`` solvers.

Port of ``minimize_lbfgs``, ``minimize_owlqn`` and ``two_loop_direction`` in
photon_ml_tpu/opt/lbfgs.py.  As in the reference, each solver is a ``cond``
/ ``body`` pair (``opt/loop.while_loop``) whose stops are tensors: the body
takes no decision on the host, and the loop reads one flag a trip.

There is one L-BFGS.  ``minimize_lbfgs_lanes`` runs one solve per lane, as
``jax.vmap`` runs the reference's over the random-effect lanes: every state
tensor has a leading lane axis ([L, m, d] histories, [L] counters) and a
lane's carry freezes once its reason is set.  ``minimize_lbfgs`` is the same
solver over a single lane held without that axis (0-d scalars, [d]
vectors), the reference's signature: the fixed effect's solve.  A single
solve takes its dot products and norms as one vector's, as the reference's
unbatched solve does; the lanes take them per lane.

Each iteration costs (1 + line-search evaluations) value+gradient passes, as
in the reference.  The curvature history is held newest first (slot 0 the
newest pair), so the two-loop recursion reads its slots as views; a slot
not yet filled is zero and its terms vanish, as the reference's masks make
them.

``box=(lower, upper)`` is the reference's gradient-projection variant: the
start and every trial point are clipped into the box, coordinates at a bound
with the gradient pushing outward are frozen out of the quasi-Newton
direction, and convergence is measured on the projected-gradient residual
``w - clip(w - g, lower, upper)``; the lanes' bounds are [d] (shared) or
[L, d] (per lane).  ``minimize_owlqn_lanes`` is OWLQN in the lane form, with
a per-lane L1 weight; a single solve (the fixed effect) runs it as one lane.

Every solver records its states in a ``StateTracker`` (``SolverConfig.
track_states``) as the reference does: the initial state, then per
iteration the accepted point's value and (projected or pseudo-) gradient
norm, or the current point's where the line search failed.  A finished
lane records no more, as under ``jax.vmap`` of the reference's loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from photon_ml_tpu_torch.core.objective import lane_dot, lane_norm
from photon_ml_tpu_torch.opt import linesearch
from photon_ml_tpu_torch.opt.linesearch import Search
from photon_ml_tpu_torch.opt.loop import replay, while_loop
from photon_ml_tpu_torch.opt.types import (SolverConfig, SolverResult, converged,
                                          convergence_tolerances, new_tracker)
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]
Box = Optional[Tuple[Tensor, Tensor]]

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)
_NOT_IMPROVING = int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)
_MAX_ALPHA = 1e10


def _direction(g: Tensor, s_hist: Tensor, y_hist: Tensor, rho: Tensor, gamma: Tensor,
               dot) -> Tensor:
    """The two-loop recursion over histories held newest first: g [..., d],
    s / y [..., m, d], rho [..., m], and gamma [...], the initial Hessian
    scaling s·y / y·y of the newest pair (1 before any).  A slot not yet
    filled is zero and its terms vanish."""
    col = (lambda t: t) if g.dim() == 1 else (lambda t: t[..., None])
    s_rows, y_rows, rhos = s_hist.unbind(-2), y_hist.unbind(-2), rho.unbind(-1)
    q = g
    alphas = []
    for s_j, y_j, rho_j in zip(s_rows, y_rows, rhos):
        a = rho_j * dot(s_j, q)
        q = q - col(a) * y_j
        alphas.append(a)
    r = col(gamma) * q
    for s_j, y_j, rho_j, a in reversed(list(zip(s_rows, y_rows, rhos, alphas))):
        b = rho_j * dot(y_j, r)  # oldest first
        r = r + col(a - b) * s_j
    return -r


def _gamma(sy: Tensor, yy: Tensor) -> Tensor:
    """The initial Hessian scaling s·y / y·y of a pair (1 where y·y is 0)."""
    return torch.where(yy > 0, sy / torch.where(yy == 0, 1.0, yy), 1.0)


def two_loop_direction(g: Tensor, s_hist: Tensor, y_hist: Tensor, rho: Tensor,
                       count, pos) -> Tensor:
    """The masked L-BFGS two-loop recursion over the reference's circular
    buffers: g [d], s / y [m, d], rho [m], ``count`` valid pairs ending
    before slot ``pos``; slots at or past the count are no-ops."""
    m = rho.shape[-1]
    slots = torch.arange(m, device=g.device)
    order = (pos - 1 - slots) % m  # newest first
    valid = slots < count
    s = torch.where(valid[:, None], s_hist[order], 0.0)
    y = torch.where(valid[:, None], y_hist[order], 0.0)
    gamma = torch.where(torch.as_tensor(count) > 0, _gamma(torch.dot(s[0], y[0]),
                                                           torch.dot(y[0], y[0])), 1.0)
    return _direction(g, s, y, torch.where(valid, rho[order], 0.0), gamma, torch.dot)


def _admit(s_hist, y_hist, rho, gamma, s, y, ok, dot):
    """The histories and scaling with the pair (s, y) pushed in front where
    ``ok`` holds and the pair has positive curvature s·y > 1e-12·y·y."""
    sy, yy = dot(s, y), dot(y, y)
    admit = ok & (sy > 1e-12 * torch.clamp(yy, min=1e-30))
    lanes = admit.dim() > 0
    push = admit[..., None, None] if lanes else admit
    s_hist = torch.where(push, torch.cat([s[..., None, :], s_hist[..., :-1, :]], -2), s_hist)
    y_hist = torch.where(push, torch.cat([y[..., None, :], y_hist[..., :-1, :]], -2), y_hist)
    # (an admitted pair's s·y is positive: its rho is too, so a history whose
    # newest rho is 0 holds no pair)
    rho = torch.where(admit[..., None] if lanes else admit,
                      torch.cat([torch.reciprocal(sy)[..., None], rho[..., :-1]], -1), rho)
    return s_hist, y_hist, rho, torch.where(admit, _gamma(sy, yy), gamma)


def _empty_history(w0: Tensor, m: int):
    """Zero histories and a scaling of 1."""
    lead, d = w0.shape[:-1], w0.shape[-1]
    s = torch.zeros(lead + (m, d), dtype=w0.dtype, device=w0.device)
    rho = torch.zeros(lead + (m,), dtype=w0.dtype, device=w0.device)
    return s, torch.zeros_like(s), rho, torch.ones_like(rho[..., 0])


def _first_step(gnorm: Tensor, rho: Tensor) -> Tensor:
    """The first trial step: 1 / ||g|| (at most 1) before any curvature pair
    is stored, then 1."""
    return torch.where(rho[..., 0] == 0,
                       torch.clamp(torch.reciprocal(torch.clamp(gnorm, min=1e-12)), max=1.0),
                       1.0)


def _start_reason(gnorm0: Tensor) -> Tensor:
    """GRADIENT_CONVERGED at a stationary start, else NOT_CONVERGED (int32)."""
    return (gnorm0 == 0.0).to(torch.int32) * int(ConvergenceReason.GRADIENT_CONVERGED)


class _Lbfgs(NamedTuple):
    w: Tensor
    f: Tensor
    g: Tensor
    gnorm: Tensor  # (projected) gradient norm at w
    s_hist: Tensor  # [..., m, d], newest first
    y_hist: Tensor
    rho: Tensor  # [..., m]
    gamma: Tensor  # s·y / y·y of the newest pair
    it: Tensor  # int32
    reason: Tensor  # int32
    active: Tensor  # reason == NOT_CONVERGED


def _opt_gradient(w: Tensor, g: Tensor, box: Box) -> Tensor:
    """The projected-gradient residual w - clip(w - g), zero iff w is
    KKT-stationary; g itself without a box."""
    return g if box is None else w - torch.clamp(w - g, *box)


def _prepare(c: _Lbfgs, box: Box, lanes: bool, c2: float, max_evals: int, dot
             ) -> Tuple[Tensor, Search, Tensor]:
    """An iteration's direction, and its line search's first state and
    constants."""
    col = (lambda t: t[..., None]) if lanes else (lambda t: t)
    g_dir = c.g
    if box is not None:
        # coordinates at a bound with the gradient pushing outward are frozen
        # out of the direction
        lower, upper = box
        free = ~(((c.w <= lower) & (c.g > 0)) | ((c.w >= upper) & (c.g < 0)))
        g_dir = torch.where(free, c.g, 0.0)
    dvec = _direction(g_dir, c.s_hist, c.y_hist, c.rho, c.gamma, dot)
    if box is not None:
        dvec = torch.where(free, dvec, 0.0)
    # the direction lost descent: fall back to steepest descent
    dvec = torch.where(col(dot(c.g, dvec) >= 0), -g_dir, dvec)
    st, k = linesearch.start(c.f, c.g, dvec, _first_step(c.gnorm, c.rho),
                             c.active if lanes else None, c2, max_evals, dot)
    return dvec, st, k


def _finish(c: _Lbfgs, st: Search, dvec: Tensor, tols: Tuple[Tensor, Tensor], box: Box,
            lanes: bool, max_iters: int, dot, norm) -> _Lbfgs:
    """The next state from an iteration's finished line search."""
    col = (lambda t: t[..., None]) if lanes else (lambda t: t)
    ls = linesearch.result(st)
    w_new = c.w + col(ls.alpha) * dvec
    if box is not None:
        w_new = torch.clamp(w_new, *box)
    keep = c.active & ls.success if lanes else ls.success
    hist = _admit(c.s_hist, c.y_hist, c.rho, c.gamma, w_new - c.w, ls.g - c.g, keep, dot)
    it = c.it + 1
    g_new_norm = norm(_opt_gradient(w_new, ls.g, box))
    reason = converged(ls.phi, c.f, g_new_norm, it, max_iters, *tols)
    # no Armijo point along any direction we can build
    reason = torch.where(ls.success, reason, _NOT_IMPROVING)
    if lanes:  # a finished lane keeps its counters
        it = torch.where(c.active, it, c.it)
        reason = torch.where(c.active, reason, c.reason)
    return _Lbfgs(torch.where(col(keep), w_new, c.w), torch.where(keep, ls.phi, c.f),
                  torch.where(col(keep), ls.g, c.g), torch.where(keep, g_new_norm, c.gnorm),
                  *hist, it, reason, reason == _NOT_CONVERGED)


def _lbfgs(value_and_grad: ValueAndGrad, w0: Tensor, config: SolverConfig, box: Box,
           single: bool) -> SolverResult:
    """L-BFGS over one solve (w0 [d], ``single``) or lanes (w0 [L, d]).  On
    the card its bookkeeping is replayed (``loop.replay``): an iteration's
    direction and search start, each search step and the iteration's end
    are a graph each, per shape; the objective runs eagerly between them."""
    lanes = not single
    dot, norm = (lane_dot, lane_norm) if lanes else (torch.dot, torch.linalg.vector_norm)
    col = (lambda t: t[..., None]) if lanes else (lambda t: t)
    if box is not None:
        w0 = torch.clamp(w0, *box)
    f0, g0 = value_and_grad(w0)
    g0norm = norm(_opt_gradient(w0, g0, box))
    tols = convergence_tolerances(f0, g0norm, config.tolerance)
    linesearch.tables(f0)
    tracker = new_tracker(config, w0, w0.shape[0] if lanes else None)
    if tracker is not None:
        tracker.record(f0, g0norm)
    reason0 = _start_reason(g0norm)
    init = _Lbfgs(w0, f0, g0, g0norm, *_empty_history(w0, config.history),
                  torch.zeros_like(reason0), reason0, reason0 == _NOT_CONVERGED)

    def body(c: _Lbfgs) -> _Lbfgs:
        dvec, st, k = replay(_prepare, c, box, lanes, config.c2, config.max_linesearch, dot)

        def search(st: Search) -> Search:
            wt = c.w + col(linesearch.trial(st)) * dvec
            phi, g = value_and_grad(wt if box is None else torch.clamp(wt, *box))
            return replay(linesearch.step, st, phi, g, dvec, k, lanes, config.c1,
                          config.max_linesearch, _MAX_ALPHA, dot)

        st = while_loop(lambda st: st.run.any() if lanes else st.run, search, st)
        # (c is the last iteration's graph output, which the replay below
        # overwrites: the lanes that ran are kept apart first)
        ran = c.active.clone() if lanes and tracker is not None else None
        nxt = replay(_finish, c, st, dvec, tols, box, lanes, config.max_iters, dot, norm)
        if tracker is not None:
            tracker.record(nxt.f, nxt.gnorm, ran)
        return nxt

    final = while_loop(lambda c: c.active.any() if lanes else c.active, body, init)
    final = _Lbfgs(*(t.clone() for t in final))  # the replayed graphs' buffers are theirs
    return SolverResult(w=final.w, value=final.f, grad_norm=final.gnorm,
                        iterations=final.it, reason=final.reason, tracker=tracker)


def minimize_lbfgs(value_and_grad: ValueAndGrad, w0: Tensor,
                   config: SolverConfig = SolverConfig(), box: Box = None) -> SolverResult:
    """Minimize a smooth objective with L-BFGS + strong-Wolfe line search,
    inside ``box`` = (lower[d], upper[d]) when one is given.

    ``w0`` is [d]; ``value_and_grad(w)`` gives (0-d, [d]).  The result's
    value, gradient norm, iterations and reason are 0-d tensors."""
    return _lbfgs(value_and_grad, w0, config, box, single=True)


def minimize_lbfgs_lanes(value_and_grad: ValueAndGrad, w0: Tensor,
                         config: SolverConfig = SolverConfig(),
                         box: Box = None) -> SolverResult:
    """One L-BFGS + strong-Wolfe solve per lane, inside ``box`` = (lower,
    upper) when one is given ([d] for every lane, or [L, d]).

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives ([L], [L, d]).  The result
    holds w [L, d] and [L] values, gradient norms, iterations and reasons."""
    return _lbfgs(value_and_grad, w0, config, box, single=False)


def pseudo_gradient(w: Tensor, g: Tensor, l1) -> Tensor:
    """Sub-gradient of f(w) + l1·|w|₁ choosing the steepest orthant at 0."""
    right = g + l1
    left = g - l1
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, 0.0))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


class _Owlqn(NamedTuple):
    w: Tensor
    f: Tensor  # smooth part
    g: Tensor  # smooth gradient
    full_f: Tensor  # f + l1 term
    pgnorm: Tensor  # pseudo-gradient norm at w
    s_hist: Tensor
    y_hist: Tensor
    rho: Tensor
    gamma: Tensor
    it: Tensor
    reason: Tensor
    active: Tensor


class _Backtrack(NamedTuple):
    alpha: Tensor
    w: Tensor  # the last trial point
    f: Tensor
    g: Tensor
    ok: Tensor  # Armijo met
    searching: Tensor  # the search goes on
    k: Tensor  # trials, int32


def _composite(w: Tensor, f_smooth: Tensor, l1: Tensor) -> Tensor:
    """The OWLQN objective: the smooth part plus l1·||w||₁, per lane."""
    return f_smooth + (l1 * w.abs()).sum(-1)


def _orthant_trial(w: Tensor, alpha: Tensor, dvec: Tensor, xi: Tensor) -> Tensor:
    """The trial point w + alpha·d projected onto the orthant ``xi``."""
    wt = w + alpha[:, None] * dvec
    return torch.where(wt * xi >= 0, wt, 0.0)


def _owlqn_prepare(c: _Owlqn, l1: Tensor, max_linesearch: int):
    """An iteration's direction, its slope, the orthant of its trial region,
    its backtracking search's first state and first trial point."""
    pg = pseudo_gradient(c.w, c.g, l1)
    dvec = _direction(pg, c.s_hist, c.y_hist, c.rho, c.gamma, lane_dot)
    # align: drop the components that leave the pseudo-gradient's orthant
    dvec = torch.where(dvec * -pg > 0, dvec, 0.0)
    dphi0 = lane_dot(pg, dvec)
    bad = dphi0 >= 0
    dvec = torch.where(bad[:, None], -pg, dvec)
    dphi0 = torch.where(bad, -lane_dot(pg, pg), dphi0)
    # the orthant of the trial region: sign(w), or the steepest one at 0
    xi = torch.where(c.w != 0, torch.sign(c.w), torch.sign(-pg))
    k0 = torch.zeros((), dtype=torch.int32, device=c.w.device)
    b = _Backtrack(_first_step(c.pgnorm, c.rho), torch.zeros_like(c.w), c.f, c.g,
                   torch.zeros_like(c.active), c.active & (k0 < max_linesearch), k0)
    return dvec, dphi0, xi, b, _orthant_trial(c.w, b.alpha, dvec, xi)


def _owlqn_trial(b: _Backtrack, wt: Tensor, ft: Tensor, gt: Tensor, w: Tensor,
                 full_f: Tensor, dvec: Tensor, dphi0: Tensor, xi: Tensor, l1: Tensor,
                 c1: float, max_linesearch: int):
    """The backtracking search's next state after evaluating the trial
    point ``wt``, and its next trial point.  A lane's last trial is kept
    whether or not it succeeded, and ``ok`` selects."""
    ok = _composite(wt, ft, l1) <= full_f + c1 * b.alpha * dphi0
    k = b.k + 1
    nxt = _Backtrack(torch.where(b.searching, b.alpha * 0.5, b.alpha),
                     torch.where(b.searching[:, None], wt, b.w),
                     torch.where(b.searching, ft, b.f),
                     torch.where(b.searching[:, None], gt, b.g),
                     torch.where(b.searching, ok, b.ok),
                     b.searching & ~ok & (k < max_linesearch), k)
    return nxt, _orthant_trial(w, nxt.alpha, dvec, xi)


def _owlqn_finish(c: _Owlqn, ls: _Backtrack, l1: Tensor, tols: Tuple[Tensor, Tensor],
                  max_iters: int) -> _Owlqn:
    """The next state from an iteration's finished search."""
    active = c.active
    hist = _admit(c.s_hist, c.y_hist, c.rho, c.gamma, ls.w - c.w, ls.g - c.g,
                  active & ls.ok, lane_dot)
    ff_new = _composite(ls.w, ls.f, l1)
    it_new = c.it + 1
    pg_new_norm = lane_norm(pseudo_gradient(ls.w, ls.g, l1))
    r_new = converged(ff_new, c.full_f, pg_new_norm, it_new, max_iters, *tols)
    r_new = torch.where(ls.ok, r_new, _NOT_IMPROVING)
    keep = active & ls.ok
    reason = torch.where(active, r_new, c.reason)
    return _Owlqn(torch.where(keep[:, None], ls.w, c.w), torch.where(keep, ls.f, c.f),
                  torch.where(keep[:, None], ls.g, c.g),
                  torch.where(keep, ff_new, c.full_f), torch.where(keep, pg_new_norm, c.pgnorm),
                  *hist, torch.where(active, it_new, c.it), reason, reason == _NOT_CONVERGED)


def minimize_owlqn_lanes(value_and_grad: ValueAndGrad, w0: Tensor, l1,
                         config: SolverConfig = SolverConfig()) -> SolverResult:
    """One OWLQN solve of smooth(w) + l1·||w||₁ per lane.

    ``w0`` is [L, d]; ``value_and_grad(w)`` gives the smooth part ([L],
    [L, d]); ``l1`` is a number or an [L] tensor of per-lane weights.  The
    line search backtracks by halving from the orthant-projected trial point
    until the composite objective meets Armijo's condition; the curvature
    history takes smooth gradients.  A lane whose search finds no such point
    keeps its point and stops with OBJECTIVE_NOT_IMPROVING.  The result's
    values are composite and its gradient norms the pseudo-gradients'.  On
    the card the bookkeeping is replayed as ``_lbfgs``'s is; a number ``l1``
    enters it as a 0-d tensor, so a λ grid replays the same graphs."""
    if isinstance(l1, Tensor):
        l1 = l1.to(dtype=w0.dtype, device=w0.device)
        if l1.dim() == 1:
            l1 = l1[:, None]
    else:
        l1 = torch.full((), l1, dtype=w0.dtype, device=w0.device)

    f0, g0 = value_and_grad(w0)
    pg0norm = lane_norm(pseudo_gradient(w0, g0, l1))
    ff0 = _composite(w0, f0, l1)
    tracker = new_tracker(config, w0, w0.shape[0])
    if tracker is not None:
        tracker.record(ff0, pg0norm)
    reason0 = _start_reason(pg0norm)
    tols = convergence_tolerances(ff0, pg0norm, config.tolerance)
    init = _Owlqn(w0, f0, g0, ff0, pg0norm, *_empty_history(w0, config.history),
                  torch.zeros_like(reason0), reason0, reason0 == _NOT_CONVERGED)

    def body(c: _Owlqn) -> _Owlqn:
        dvec, dphi0, xi, b, wt = replay(_owlqn_prepare, c, l1, config.max_linesearch)

        def trial(state):
            b, wt = state
            ft, gt = value_and_grad(wt)
            return replay(_owlqn_trial, b, wt, ft, gt, c.w, c.full_f, dvec, dphi0, xi, l1,
                          config.c1, config.max_linesearch)

        ls, _ = while_loop(lambda state: state[0].searching.any(), trial, (b, wt))
        ran = c.active.clone() if tracker is not None else None
        nxt = replay(_owlqn_finish, c, ls, l1, tols, config.max_iters)
        if tracker is not None:
            tracker.record(nxt.full_f, nxt.pgnorm, ran)
        return nxt

    final = while_loop(lambda c: c.active.any(), body, init)
    final = _Owlqn(*(t.clone() for t in final))
    return SolverResult(w=final.w, value=final.full_f, grad_norm=final.pgnorm,
                        iterations=final.it, reason=final.reason, tracker=tracker)
