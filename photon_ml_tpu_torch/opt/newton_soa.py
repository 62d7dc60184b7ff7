"""Batched exact-Newton solver for narrow random-effect lanes, in
structure-of-arrays ([d, L]) layout.

Port of ``solve_newton_soa`` in photon_ml_tpu/opt/newton_soa.py: per-lane
Newton steps with Armijo backtracking (halving, at most ``max_linesearch``
trials), per-lane active masks and the reference convergence contract
(function values, then gradient, then max iterations; a line search that
finds no Armijo point stops the lane as OBJECTIVE_NOT_IMPROVING and keeps its
iterate).  The JAX version nests two ``lax.while_loop``s; here both are host
loops over device tensors, synchronising once per Newton iteration and once
per backtracking trial to test whether any lane is still active.

The step itself is ``ops.soa_newton.newton_step``: the CUDA kernel on the
card, its plain version on the CPU.  A narrow-stored ``x_t`` (bf16 / f16) is
widened element by element in margins and gradients; w is not rounded.

Gate (game/coordinate.py): solve dim <= 16, cap*d^2 <= 2560, a smooth loss,
no normalization, box or L1.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.soa_newton import MAX_DIM, newton_step, soa_margins
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult, convergence_check
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
    not_improving = torch.tensor(int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING),
                                 dtype=torch.int32, device=dev)

    w, f, g = w0_t, f0, g0
    reason = torch.zeros(num_l, dtype=torch.int32, device=dev)
    iters = torch.zeros(num_l, dtype=torch.int32, device=dev)
    k = 0
    while k < config.max_iters and bool((reason == 0).any()):
        active = reason == 0
        step = newton_step(loss, w, g, x_t, y_t, off_t, wt_t, l2)
        gd = (g * step).sum(0)                          # descent rate, [L] >= 0

        alpha = torch.ones(num_l, dtype=w.dtype, device=dev)
        accepted = torch.zeros(num_l, dtype=torch.bool, device=dev)
        t = 0
        while t < config.max_linesearch and bool((active & ~accepted).any()):
            f_try = _value(loss, w - alpha[None] * step, x_t, y_t, off_t, wt_t, l2)
            ok = f_try <= f - c1 * alpha * gd           # False for NaN f_try
            accepted = accepted | (~accepted & ok)
            alpha = torch.where(accepted, alpha, alpha * 0.5)
            t += 1
        # a rejected line search keeps the iterate (never w - 0*step, which is
        # NaN for a non-finite step)
        stepped = active & accepted
        w_new = torch.where(stepped[None], w - alpha[None] * step, w)
        f_new, g_new = _value_grad(loss, w_new, x_t, y_t, off_t, wt_t, l2)
        r_new = convergence_check(f_new, f, f0, _gnorm(g_new), gn0, k + 1,
                                  config.max_iters, config.tolerance)
        # line-search exhaustion is a stall, not convergence
        r_new = torch.where(active & ~accepted, not_improving, r_new)
        reason = torch.where(active, r_new, reason)
        w = torch.where(active[None], w_new, w)
        f = torch.where(active, f_new, f)
        g = torch.where(active[None], g_new, g)
        iters = torch.where(active, iters + 1, iters)
        k += 1

    # no state tracking here, as in the reference
    return SolverResult(w=w, value=f, grad_norm=_gnorm(g), iterations=iters,
                        reason=reason, tracker=None)
