"""Batched exact-Newton solver for narrow random-effect lanes, in
structure-of-arrays ([d, L]) layout.

Port of ``solve_newton_soa`` in photon_ml_tpu/opt/newton_soa.py: per-lane
Newton steps with Armijo backtracking (halving, at most ``max_linesearch``
trials), per-lane active masks and the reference convergence contract
(function values, then gradient, then max iterations; a line search that
finds no Armijo point stops the lane as OBJECTIVE_NOT_IMPROVING and keeps its
iterate).  As in the reference, the backtracking loop nests in the Newton
loop, each a ``cond`` / ``body`` pair over ``opt/loop.while_loop``, read
once a Newton iteration and once a backtracking trial; on the card the
bodies' bookkeeping replays as CUDA graphs (``opt/loop.replay``).

The step itself is ``ops.soa_newton.newton_step``: the CUDA kernel on the
card, its plain version on the CPU.  A narrow-stored ``x_t`` (bf16 / f16) is
widened element by element in margins and gradients; w is not rounded.

Gate (game/coordinate.py): solve dim <= 16, cap*d^2 <= 2560, a smooth loss,
no normalization, box or L1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.soa_newton import MAX_DIM, newton_step, soa_margins
from photon_ml_tpu_torch.opt.loop import replay, while_loop
from photon_ml_tpu_torch.opt.types import (SolverConfig, SolverResult, converged,
                                          convergence_tolerances)
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor


def soa_eligible(dim: int, loss_name: str) -> bool:
    """Static part of the gate (the caller adds its layout conditions)."""
    return dim <= MAX_DIM and loss_name != "smoothed_hinge"


def _value(loss: PointwiseLoss, w, x_t, y_t, off_t, wt_t, l2) -> Tensor:
    z = soa_margins(w, x_t, off_t)
    return (wt_t * loss.loss(z, y_t)).sum(0) + 0.5 * l2 * (w * w).sum(0)


def _value_grad(loss: PointwiseLoss, w, x_t, y_t, off_t, wt_t, l2):
    z = soa_margins(w, x_t, off_t)
    l, d1 = loss.loss_and_d1(z, y_t)
    f = (wt_t * l).sum(0) + 0.5 * l2 * (w * w).sum(0)
    r = wt_t * d1                                        # [cap, L]
    g = (x_t.to(r.dtype) * r[:, None, :]).sum(0) + l2 * w  # [d, L]; x widened
    return f, g


def _gnorm(g: Tensor) -> Tensor:
    return torch.sqrt((g * g).sum(dim=0))


class _Newton(NamedTuple):
    w: Tensor
    f: Tensor
    g: Tensor
    reason: Tensor  # int32 per lane, 0 while it runs
    iters: Tensor  # int32 per lane
    k: Tensor  # Newton iterations of the solve, int32
    run: Tensor  # k < max_iters and some lane runs


class _Armijo(NamedTuple):
    alpha: Tensor
    accepted: Tensor
    t: Tensor  # trials, int32
    run: Tensor  # t < max_linesearch and some active lane unaccepted


def _armijo_start(c: _Newton, step: Tensor, max_linesearch: int):
    """An iteration's lanes that run, descent rates, backtracking's first
    state and first trial point."""
    active = c.reason == 0
    gd = (c.g * step).sum(0)                            # descent rate, [L] >= 0
    t0 = torch.zeros((), dtype=torch.int32, device=c.w.device)
    a = _Armijo(torch.ones_like(c.f), torch.zeros_like(active), t0,
                (t0 < max_linesearch) & active.any())
    return active, gd, a, c.w - a.alpha[None] * step


def _armijo_step(a: _Armijo, f_try: Tensor, w: Tensor, f: Tensor, step: Tensor, gd: Tensor,
                 active: Tensor, c1: float, max_linesearch: int):
    """Backtracking's next state after evaluating the trial point, and its
    next trial point."""
    ok = f_try <= f - c1 * a.alpha * gd         # False for NaN f_try
    accepted = a.accepted | (~a.accepted & ok)
    t = a.t + 1
    nxt = _Armijo(torch.where(accepted, a.alpha, a.alpha * 0.5), accepted, t,
                  (t < max_linesearch) & (active & ~accepted).any())
    return nxt, w - nxt.alpha[None] * step


def _newton_point(w: Tensor, ls: _Armijo, step: Tensor, active: Tensor) -> Tensor:
    """The iteration's point: the accepted step, or the iterate kept where
    the search found none (never w - 0*step, which is NaN for a non-finite
    step)."""
    return torch.where((active & ls.accepted)[None], w - ls.alpha[None] * step, w)


def _newton_finish(c: _Newton, ls: _Armijo, active: Tensor, w_new: Tensor, f_new: Tensor,
                   g_new: Tensor, tols, max_iters: int) -> _Newton:
    """The next state from the iteration's point and its value and gradient."""
    k = c.k + 1
    r_new = converged(f_new, c.f, _gnorm(g_new), k, max_iters, *tols)
    # line-search exhaustion is a stall, not convergence
    r_new = torch.where(active & ~ls.accepted,
                        int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING), r_new)
    reason = torch.where(active, r_new, c.reason)
    return _Newton(torch.where(active[None], w_new, c.w), torch.where(active, f_new, c.f),
                   torch.where(active[None], g_new, c.g), reason,
                   torch.where(active, c.iters + 1, c.iters), k,
                   (k < max_iters) & (reason == 0).any())


def solve_newton_soa(loss: PointwiseLoss, w0_t: Tensor, x_t: Tensor, y_t: Tensor,
                     off_t: Tensor, wt_t: Tensor, l2: Tensor,
                     config: SolverConfig) -> SolverResult:
    """Per-lane Newton descent, all tensors lanes-last.

    w0_t: [d, L] start; x_t: [cap, d, L]; y/off/wt_t: [cap, L]; l2: [L].
    Returns a SolverResult whose ``w`` is [d, L] and whose value, grad_norm,
    iterations and reason are [L] tensors.  On the card the bookkeeping is
    replayed (``loop.replay``): the search's start, each trial's test and
    the iteration's point and end are a graph each; the Newton step (kernel
    3) and the objective run eagerly between them, the design never passing
    through a graph's inputs."""
    num_l = w0_t.shape[1]
    dev = w0_t.device
    c1 = config.c1
    f0, g0 = _value_grad(loss, w0_t, x_t, y_t, off_t, wt_t, l2)
    gn0 = _gnorm(g0)
    tols = convergence_tolerances(f0, gn0, config.tolerance)

    def body(c: _Newton) -> _Newton:
        step = newton_step(loss, c.w, c.g, x_t, y_t, off_t, wt_t, l2)
        active, gd, a, w_try = replay(_armijo_start, c, step, config.max_linesearch)

        def trial(state):
            a, w_try = state
            f_try = _value(loss, w_try, x_t, y_t, off_t, wt_t, l2)
            return replay(_armijo_step, a, f_try, c.w, c.f, step, gd, active, c1,
                          config.max_linesearch)

        ls, _ = while_loop(lambda state: state[0].run, trial, (a, w_try))
        w_new = replay(_newton_point, c.w, ls, step, active)
        f_new, g_new = _value_grad(loss, w_new, x_t, y_t, off_t, wt_t, l2)
        return replay(_newton_finish, c, ls, active, w_new, f_new, g_new, tols,
                      config.max_iters)

    zeros = torch.zeros(num_l, dtype=torch.int32, device=dev)
    k0 = torch.zeros((), dtype=torch.int32, device=dev)
    final = while_loop(lambda c: c.run, body,
                       _Newton(w0_t, f0, g0, zeros, zeros, k0,
                               (k0 < config.max_iters) & (zeros == 0).any()))
    final = _Newton(*(t.clone() for t in final))  # the replayed graphs' buffers are theirs
    # no state tracking here, as in the reference
    return SolverResult(w=final.w, value=final.f, grad_norm=_gnorm(final.g),
                        iterations=final.iters, reason=final.reason, tracker=None)
