"""Strong-Wolfe line search (bracket + zoom) as a host loop.

Port of photon_ml_tpu/opt/linesearch.py: the same state machine (Nocedal &
Wright Algorithms 3.5 / 3.6 with a safeguarded quadratic zoom step), the same
approximate-Wolfe slack and the same bound on evaluations.  The JAX version is
one ``lax.while_loop``; here each trial point's value and directional
derivative come to the host (one sync per evaluation) and the scalar logic
runs in numpy scalars of the working dtype, so its rounding matches the
device-side scalars of the reference.  The accepted point's gradient stays
on the device and rides along, so the optimizer never re-evaluates it.

``strong_wolfe_lanes`` is the same state machine over a leading lane axis,
as the JAX search runs under ``jax.vmap`` for the random-effect lanes: the
state lives in [L] tensors, both stage transitions are computed for every
lane and selected by its stage (vmap's form of ``lax.cond``), and a lane's
state freezes once its own search has ended.  The host reads one flag per
evaluation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.objective import lane_dot
from photon_ml_tpu_torch.opt.types import PLATEAU_ULPS

Tensor = torch.Tensor

_BRACKET, _ZOOM, _DONE, _FAILED = 0, 1, 2, 3


class LineSearchResult(NamedTuple):
    alpha: np.floating  # accepted step (0 on failure)
    phi: np.floating  # f(w + alpha d)
    g: Tensor  # grad f(w + alpha d)
    success: bool  # some Armijo-satisfying step found
    wolfe: bool  # strong Wolfe conditions met
    num_evals: int


def numpy_scalar_type(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _next_zoom_alpha(lo, hi, phi_lo, dphi_lo, phi_hi):
    """Safeguarded quadratic interpolation using (phi_lo, dphi_lo, phi_hi)."""
    with np.errstate(all="ignore"):
        dx = hi - lo
        denom = 2.0 * (phi_hi - phi_lo - dphi_lo * dx)
        quad = lo - dphi_lo * dx * dx / (denom if denom != 0 else 1.0)
        bad = denom == 0 or not np.isfinite(quad)
        mid = lo + 0.5 * dx
        a_min = lo + 0.1 * dx
        a_max = lo + 0.9 * dx
        safe = np.clip(quad, min(a_min, a_max), max(a_min, a_max))
    return mid if bad else safe


def strong_wolfe(phi_fn: Callable[[float], Tuple[Tensor, Tensor]], phi0, g0: Tensor,
                 d: Tensor, alpha0, c1: float = 1e-4, c2: float = 0.9,
                 max_evals: int = 25, max_alpha: float = 1e10) -> LineSearchResult:
    """Find alpha satisfying the strong Wolfe conditions along d.

    ``phi_fn(alpha) -> (f(w + alpha d), grad f(w + alpha d))`` as tensors;
    ``phi0`` is f at alpha = 0 as a numpy scalar of the working dtype,
    ``g0`` its gradient."""
    T = numpy_scalar_type(g0.dtype)
    phi0 = T(phi0)
    dphi0 = T(torch.dot(g0, d).item())
    # approximate-Wolfe slack: accept decrease up to PLATEAU_ULPS ulps of phi0
    # (the convergence check floors its function tolerance at the same width)
    slack = T(PLATEAU_ULPS) * T(np.finfo(T).eps) * abs(phi0)

    def armijo_ok(alpha, phi):
        return phi <= phi0 + c1 * alpha * dphi0 + slack

    def curvature_ok(dphi):
        return abs(dphi) <= -c2 * dphi0

    zero = T(0)
    stage, i = _BRACKET, 0
    alpha, alpha_prev, phi_prev = T(alpha0), zero, phi0
    lo = hi = zero
    phi_lo, dphi_lo, phi_hi = phi0, dphi0, phi0
    best_alpha, best_phi, best_g, wolfe = zero, phi0, g0, False
    if dphi0 >= 0:  # not a descent direction: the caller restarts with -g
        stage = _FAILED

    with np.errstate(all="ignore"):
        while stage < _DONE and i < max_evals:
            phi_t, g = phi_fn(float(alpha))
            phi = T(phi_t.item())
            dphi = T(torch.dot(g, d).item())
            if stage == _BRACKET:
                if not armijo_ok(alpha, phi) or (i > 0 and phi >= phi_prev):
                    # zoom(alpha_prev, alpha)
                    stage = _ZOOM
                    lo, hi = alpha_prev, alpha
                    phi_lo, phi_hi = phi_prev, phi
                    dphi_lo = dphi_lo if i > 0 else dphi0
                elif curvature_ok(dphi):
                    stage = _DONE
                    best_alpha, best_phi, best_g, wolfe = alpha, phi, g, True
                elif dphi >= 0:
                    # zoom(alpha, alpha_prev); alpha is the best point so far
                    stage = _ZOOM
                    lo, hi = alpha, alpha_prev
                    phi_lo, dphi_lo, phi_hi = phi, dphi, phi_prev
                    best_alpha, best_phi, best_g = alpha, phi, g
                else:
                    # keep expanding; alpha satisfies Armijo and decreases
                    best_alpha, best_phi, best_g = alpha, phi, g
                    alpha_prev, phi_prev, dphi_lo = alpha, phi, dphi
                    alpha = T(min(T(2.0) * alpha, T(max_alpha)))
            else:
                if not armijo_ok(alpha, phi) or phi >= phi_lo:
                    hi, phi_hi = alpha, phi
                elif curvature_ok(dphi):
                    stage = _DONE
                    best_alpha, best_phi, best_g, wolfe = alpha, phi, g, True
                else:
                    if dphi * (hi - lo) >= 0:
                        hi, phi_hi = lo, phi_lo
                    lo, phi_lo, dphi_lo = alpha, phi, dphi
                    best_alpha, best_phi, best_g = alpha, phi, g
                if stage == _ZOOM and abs(hi - lo) <= 1e-12 * max(T(1.0), abs(hi)):
                    stage = _DONE  # interval collapsed: stop at the best point
            i += 1
            if stage == _ZOOM:
                alpha = T(_next_zoom_alpha(lo, hi, phi_lo, dphi_lo, phi_hi))

    return LineSearchResult(alpha=best_alpha, phi=best_phi, g=best_g,
                            success=bool(best_alpha > 0), wolfe=wolfe, num_evals=i)


class LaneLineSearchResult(NamedTuple):
    alpha: Tensor  # [L] accepted steps (0 where the search failed)
    phi: Tensor  # [L]
    g: Tensor  # [L, d]
    success: Tensor  # [L] bool
    wolfe: Tensor  # [L] bool
    num_evals: Tensor  # [L] int32


def _next_zoom_alpha_lanes(lo, hi, phi_lo, dphi_lo, phi_hi):
    dx = hi - lo
    denom = 2.0 * (phi_hi - phi_lo - dphi_lo * dx)
    quad = lo - dphi_lo * dx * dx / torch.where(denom == 0, 1.0, denom)
    bad = (denom == 0) | ~torch.isfinite(quad)
    mid = lo + 0.5 * dx
    a_min = lo + 0.1 * dx
    a_max = lo + 0.9 * dx
    safe = torch.clamp(quad, torch.minimum(a_min, a_max), torch.maximum(a_min, a_max))
    return torch.where(bad, mid, safe)


def strong_wolfe_lanes(phi_fn: Callable[[Tensor], Tuple[Tensor, Tensor]], phi0: Tensor,
                       g0: Tensor, d: Tensor, alpha0: Tensor, active: Tensor,
                       c1: float = 1e-4, c2: float = 0.9, max_evals: int = 25,
                       max_alpha: float = 1e10) -> LaneLineSearchResult:
    """Per-lane strong-Wolfe search along d [L, d].

    ``phi_fn(alpha)`` takes the [L] trial steps and gives ([L] values,
    [L, d] gradients) at w + alpha d; ``phi0``/``g0`` are the values and
    gradients at alpha = 0.  Lanes with ``active`` False do not search."""
    dphi0 = lane_dot(g0, d)
    slack = PLATEAU_ULPS * torch.finfo(phi0.dtype).eps * phi0.abs()
    zero = torch.zeros_like(phi0)

    def col(t):
        return t[:, None]

    stage = torch.where(dphi0 >= 0, _FAILED, _BRACKET).to(torch.int32)
    i = torch.zeros_like(stage)
    alpha = alpha0
    alpha_prev, phi_prev = zero, phi0
    lo, hi = zero, zero
    phi_lo, dphi_lo, phi_hi = phi0, dphi0, phi0
    best_alpha, best_phi, best_g = zero, phi0, g0
    wolfe = torch.zeros_like(active)

    while True:
        run = active & (stage < _DONE) & (i < max_evals)
        if not bool(run.any()):
            break
        phi, g = phi_fn(alpha)
        dphi = lane_dot(g, d)
        armijo = phi <= phi0 + c1 * alpha * dphi0 + slack
        curv = dphi.abs() <= -c2 * dphi0
        in_bracket = stage == _BRACKET

        # bracketing: (1) Armijo fails or no decrease -> zoom(alpha_prev,
        # alpha); (2) strong Wolfe -> done; (3) dphi >= 0 -> zoom(alpha,
        # alpha_prev); (4) expand
        b1 = ~armijo | ((i > 0) & (phi >= phi_prev))
        b2 = ~b1 & curv
        b3 = ~b1 & ~curv & (dphi >= 0)
        b4 = ~b1 & ~curv & ~b3
        b_stage = torch.where(b1 | b3, _ZOOM, torch.where(b2, _DONE, stage)).to(torch.int32)
        b_alpha = torch.where(b4, torch.clamp(2.0 * alpha, max=max_alpha), alpha)
        b_alpha_prev = torch.where(b4, alpha, alpha_prev)
        b_phi_prev = torch.where(b4, phi, phi_prev)
        b_lo = torch.where(b1, alpha_prev, torch.where(b3, alpha, lo))
        b_hi = torch.where(b1, alpha, torch.where(b3, alpha_prev, hi))
        b_phi_lo = torch.where(b1, phi_prev, torch.where(b3, phi, phi_lo))
        b_dphi_lo = torch.where(b1, torch.where(i > 0, dphi_lo, dphi0),
                                torch.where(b3 | b4, dphi, dphi_lo))
        b_phi_hi = torch.where(b1, phi, torch.where(b3, phi_prev, phi_hi))
        b_best = ~b1

        # zoom: (1) Armijo fails or no decrease on lo -> shrink from hi;
        # (2) strong Wolfe -> done; (3) new lo, hi flips to the old lo when
        # the slope says so
        z1 = ~armijo | (phi >= phi_lo)
        z2 = ~z1 & curv
        z3 = ~z1 & ~curv
        flip = dphi * (hi - lo) >= 0
        z_hi = torch.where(z1, alpha, torch.where(z3 & flip, lo, hi))
        z_phi_hi = torch.where(z1, phi, torch.where(z3 & flip, phi_lo, phi_hi))
        z_lo = torch.where(z3, alpha, lo)
        z_phi_lo = torch.where(z3, phi, phi_lo)
        z_dphi_lo = torch.where(z3, dphi, dphi_lo)
        z_stage = torch.where(z2, _DONE, stage).to(torch.int32)
        # interval collapse: stop at the best point
        tiny = (z_hi - z_lo).abs() <= 1e-12 * torch.clamp(z_hi.abs(), min=1.0)
        z_stage = torch.where((z_stage == _ZOOM) & tiny, _DONE, z_stage).to(torch.int32)
        z_best = ~z1

        n_stage = torch.where(in_bracket, b_stage, z_stage)
        n_alpha = torch.where(in_bracket, b_alpha, alpha)
        n_alpha_prev = torch.where(in_bracket, b_alpha_prev, alpha_prev)
        n_phi_prev = torch.where(in_bracket, b_phi_prev, phi_prev)
        n_lo = torch.where(in_bracket, b_lo, z_lo)
        n_hi = torch.where(in_bracket, b_hi, z_hi)
        n_phi_lo = torch.where(in_bracket, b_phi_lo, z_phi_lo)
        n_dphi_lo = torch.where(in_bracket, b_dphi_lo, z_dphi_lo)
        n_phi_hi = torch.where(in_bracket, b_phi_hi, z_phi_hi)
        take = torch.where(in_bracket, b_best, z_best)
        n_wolfe = wolfe | torch.where(in_bracket, b2, z2)
        # the next zoom trial point
        n_alpha = torch.where(n_stage == _ZOOM,
                              _next_zoom_alpha_lanes(n_lo, n_hi, n_phi_lo, n_dphi_lo,
                                                     n_phi_hi), n_alpha)

        take = run & take
        best_alpha = torch.where(take, alpha, best_alpha)
        best_phi = torch.where(take, phi, best_phi)
        best_g = torch.where(col(take), g, best_g)
        stage = torch.where(run, n_stage, stage)
        i = torch.where(run, i + 1, i)
        alpha = torch.where(run, n_alpha, alpha)
        alpha_prev = torch.where(run, n_alpha_prev, alpha_prev)
        phi_prev = torch.where(run, n_phi_prev, phi_prev)
        lo = torch.where(run, n_lo, lo)
        hi = torch.where(run, n_hi, hi)
        phi_lo = torch.where(run, n_phi_lo, phi_lo)
        dphi_lo = torch.where(run, n_dphi_lo, dphi_lo)
        phi_hi = torch.where(run, n_phi_hi, phi_hi)
        wolfe = torch.where(run, n_wolfe, wolfe)

    return LaneLineSearchResult(alpha=best_alpha, phi=best_phi, g=best_g,
                                success=best_alpha > 0, wolfe=wolfe, num_evals=i)
