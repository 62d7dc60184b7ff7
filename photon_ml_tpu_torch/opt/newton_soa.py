"""Batched exact-Newton solver for narrow random-effect lanes, in
structure-of-arrays ([d, L]) layout.

Port of ``solve_newton_soa`` in photon_ml_tpu/opt/newton_soa.py: per-lane
Newton steps with Armijo backtracking (halving, at most ``max_linesearch``
trials), per-lane active masks and the reference convergence contract
(function values, then gradient, then max iterations; a line search that
finds no Armijo point stops the lane as OBJECTIVE_NOT_IMPROVING and keeps its
iterate).  As in the reference, the backtracking loop nests in the Newton
loop, each a ``cond`` / ``body`` pair over ``opt/loop.while_loop``, read
once a Newton iteration and once a backtracking trial.

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
from photon_ml_tpu_torch.opt.loop import while_loop
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


def solve_newton_soa(loss: PointwiseLoss, w0_t: Tensor, x_t: Tensor, y_t: Tensor,
                     off_t: Tensor, wt_t: Tensor, l2: Tensor,
                     config: SolverConfig) -> SolverResult:
    """Per-lane Newton descent, all tensors lanes-last.

    w0_t: [d, L] start; x_t: [cap, d, L]; y/off/wt_t: [cap, L]; l2: [L].
    Returns a SolverResult whose ``w`` is [d, L] and whose value, grad_norm,
    iterations and reason are [L] tensors."""
    num_l = w0_t.shape[1]
    dev = w0_t.device
    c1 = config.c1
    f0, g0 = _value_grad(loss, w0_t, x_t, y_t, off_t, wt_t, l2)
    gn0 = _gnorm(g0)
    tols = convergence_tolerances(f0, gn0, config.tolerance)

    def body(c: _Newton) -> _Newton:
        w, f, g = c.w, c.f, c.g
        active = c.reason == 0
        step = newton_step(loss, w, g, x_t, y_t, off_t, wt_t, l2)
        gd = (g * step).sum(0)                          # descent rate, [L] >= 0

        def trial(a: _Armijo) -> _Armijo:
            f_try = _value(loss, w - a.alpha[None] * step, x_t, y_t, off_t, wt_t, l2)
            ok = f_try <= f - c1 * a.alpha * gd         # False for NaN f_try
            accepted = a.accepted | (~a.accepted & ok)
            t = a.t + 1
            return _Armijo(torch.where(accepted, a.alpha, a.alpha * 0.5), accepted, t,
                           (t < config.max_linesearch) & (active & ~accepted).any())

        t0 = torch.zeros((), dtype=torch.int32, device=dev)
        ls = while_loop(lambda a: a.run, trial,
                        _Armijo(torch.ones(num_l, dtype=w.dtype, device=dev),
                                torch.zeros(num_l, dtype=torch.bool, device=dev), t0,
                                (t0 < config.max_linesearch) & active.any()))
        # a rejected line search keeps the iterate (never w - 0*step, which is
        # NaN for a non-finite step)
        stepped = active & ls.accepted
        w_new = torch.where(stepped[None], w - ls.alpha[None] * step, w)
        f_new, g_new = _value_grad(loss, w_new, x_t, y_t, off_t, wt_t, l2)
        k = c.k + 1
        r_new = converged(f_new, f, _gnorm(g_new), k, config.max_iters, *tols)
        # line-search exhaustion is a stall, not convergence
        r_new = torch.where(active & ~ls.accepted,
                            int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING), r_new)
        reason = torch.where(active, r_new, c.reason)
        return _Newton(torch.where(active[None], w_new, w), torch.where(active, f_new, f),
                       torch.where(active[None], g_new, g), reason,
                       torch.where(active, c.iters + 1, c.iters), k,
                       (k < config.max_iters) & (reason == 0).any())

    zeros = torch.zeros(num_l, dtype=torch.int32, device=dev)
    k0 = torch.zeros((), dtype=torch.int32, device=dev)
    final = while_loop(lambda c: c.run, body,
                       _Newton(w0_t, f0, g0, zeros, zeros, k0,
                               (k0 < config.max_iters) & (zeros == 0).any()))
    # no state tracking here, as in the reference
    return SolverResult(w=final.w, value=final.f, grad_norm=_gnorm(final.g),
                        iterations=final.iters, reason=final.reason, tracker=None)
