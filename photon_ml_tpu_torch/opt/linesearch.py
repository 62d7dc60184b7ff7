"""Strong-Wolfe line search (bracket + zoom) as a host loop.

Port of photon_ml_tpu/opt/linesearch.py: the same state machine (Nocedal &
Wright Algorithms 3.5 / 3.6 with a safeguarded quadratic zoom step), the same
approximate-Wolfe slack and the same bound on evaluations.  The JAX version is
one ``lax.while_loop``; here each trial point's value and directional
derivative come to the host (one sync per evaluation) and the scalar logic
runs in numpy scalars of the working dtype, so its rounding matches the
device-side scalars of the reference.  The accepted point's gradient stays
on the device and rides along, so the optimizer never re-evaluates it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

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
