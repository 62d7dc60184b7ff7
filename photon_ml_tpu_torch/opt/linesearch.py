"""Strong-Wolfe line search (bracket + zoom) as one ``while_loop`` state
machine.

Port of photon_ml_tpu/opt/linesearch.py: the same state machine (Nocedal &
Wright Algorithms 3.5 / 3.6 with a safeguarded quadratic zoom step), the same
approximate-Wolfe slack and the same bound on evaluations.  As in the
reference, it is one ``cond`` / ``body`` pair (``opt/loop.while_loop``):
the body evaluates the trial point and takes the next state in tensors,
and the accepted point's gradient rides along, so the optimizer never
re-evaluates it.

``strong_wolfe`` is a single search, with the reference's signature: 0-d
scalars and [d] vectors.  The solvers run the same search (``start``,
``step``) over a leading lane axis, as the JAX search runs under
``jax.vmap`` for the random-effect lanes; a lane's state freezes once its
own search has ended.

Layout: a search's scalars lie in one tensor [..., _FIELDS] of the working
dtype (the fields below; the stage, the Wolfe flag and the evaluations as
whole numbers), its constants in another ([..., 10]).  Each evaluation
makes the reference's eight tests at once and falls into one of the nine
cases of its two steps; each case is a whole next state, as the
reference's ``_replace``s are: a row naming, for every field, the field or
evaluated quantity it takes (``_CASES``).  The body looks the row up by the
tests' bits and gathers it, so a trip costs the same few launches whatever
the case.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from photon_ml_tpu_torch.opt.loop import while_loop
from photon_ml_tpu_torch.opt.types import PLATEAU_ULPS

Tensor = torch.Tensor

_ZOOM, _DONE = 1, 2  # the stages after bracketing (0)

# the fields of the packed state
(_ALPHA, _STAGE, _ALPHA_PREV, _PHI_PREV, _LO, _HI, _PHI_LO, _DPHI_LO, _PHI_HI,
 _BEST_ALPHA, _BEST_PHI, _WOLFE, _EVALS) = range(13)
_FIELDS = 13
# the columns a next state draws on after the fields: the evaluation's value
# and slope, the doubled step and the evaluations with this one; then the
# search's constants: the slope at 0, the stage codes, 1, 0 and the collapse
# tolerances (1e-12 where a case shrinks the zoom interval, -1 where not)
(_PHI, _DPHI, _DOUBLED, _COUNTED) = range(_FIELDS, _FIELDS + 4)
(_DPHI0, _ZOOM_C, _DONE_C, _ONE, _ZERO, _SHRINKS, _KEEPS) = range(_FIELDS + 4, _FIELDS + 11)
_COLUMN_CONSTS = (_ZOOM, _DONE, 1.0, 0.0, 1e-12, -1.0)
# the constants' tensor: the columns' seven, then phi0, the slack and the
# curvature bound
_K_PHI0, _K_SLACK, _K_CURV = range(7, 10)
# a next state is its fields, its collapse tolerance and whether the point
# is the best so far
_TOL, _TAKE = _FIELDS, _FIELDS + 1

# the cases
(_B1_LATER, _B1_FIRST, _B2, _B3, _B4, _Z1, _Z2, _Z3_FLIP, _Z3) = range(9)
_BEST = {_BEST_ALPHA: _ALPHA, _BEST_PHI: _PHI, _TAKE: _ONE}
_CASES = {
    # bracketing (1): Armijo fails, or no decrease after a first
    # evaluation -> zoom between alpha_prev and alpha
    _B1_LATER: {_STAGE: _ZOOM_C, _LO: _ALPHA_PREV, _HI: _ALPHA, _PHI_LO: _PHI_PREV,
                _PHI_HI: _PHI},
    _B1_FIRST: {_STAGE: _ZOOM_C, _LO: _ALPHA_PREV, _HI: _ALPHA, _PHI_LO: _PHI_PREV,
                _PHI_HI: _PHI, _DPHI_LO: _DPHI0},
    # (2) strong Wolfe -> done
    _B2: {_STAGE: _DONE_C, _WOLFE: _ONE, **_BEST},
    # (3) dphi >= 0 -> zoom between alpha and alpha_prev
    _B3: {_STAGE: _ZOOM_C, _LO: _ALPHA, _HI: _ALPHA_PREV, _PHI_LO: _PHI, _DPHI_LO: _DPHI,
          _PHI_HI: _PHI_PREV, **_BEST},
    # (4) expand
    _B4: {_ALPHA: _DOUBLED, _ALPHA_PREV: _ALPHA, _PHI_PREV: _PHI, _DPHI_LO: _DPHI, **_BEST},
    # zoom (1): Armijo fails or no decrease on lo -> shrink from hi
    _Z1: {_HI: _ALPHA, _PHI_HI: _PHI, _TOL: _SHRINKS},
    # (2) strong Wolfe -> done
    _Z2: {_STAGE: _DONE_C, _WOLFE: _ONE, **_BEST},
    # (3) a new lo; hi flips to the old lo where the slope points back
    _Z3_FLIP: {_LO: _ALPHA, _PHI_LO: _PHI, _DPHI_LO: _DPHI, _HI: _LO, _PHI_HI: _PHI_LO,
               _TOL: _SHRINKS, **_BEST},
    _Z3: {_LO: _ALPHA, _PHI_LO: _PHI, _DPHI_LO: _DPHI, _TOL: _SHRINKS, **_BEST},
}


def _case(armijo, above_prev, curved, rising, above_lo, flips, later, bracketing) -> int:
    """The reference's two steps as a decision over the eight tests."""
    if bracketing:
        if not armijo or (later and above_prev):
            return _B1_LATER if later else _B1_FIRST
        return _B2 if curved else (_B3 if rising else _B4)
    if not armijo or above_lo:
        return _Z1
    return _Z2 if curved else (_Z3_FLIP if flips else _Z3)


def _row(case: int) -> list:
    """A case's next state as columns: every field keeps its own unless the
    case names another; the collapse tolerance never holds; not the best."""
    row = list(range(_FIELDS)) + [_KEEPS, _ZERO]
    row[_EVALS] = _COUNTED
    for target, column in _CASES[case].items():
        row[target] = column
    return row


_TESTS = 8
# the rows by the tests' bits (test k adds 2**k)
_TABLE = [_row(_case(*((i >> k) & 1 for k in range(_TESTS)))) for i in range(2 ** _TESTS)]


class LineSearchResult(NamedTuple):
    alpha: Tensor  # accepted step (0 on failure)
    phi: Tensor  # f(w + alpha d)
    g: Tensor  # grad f(w + alpha d)
    success: Tensor  # bool: some Armijo-satisfying step found
    wolfe: Tensor  # bool: strong Wolfe conditions met
    num_evals: Tensor  # int32


class Search(NamedTuple):
    s: Tensor  # [..., _FIELDS]
    best_g: Tensor  # [..., d]
    run: Tensor  # bool: the search goes on


class Tables(NamedTuple):
    """The search's tables on a device (``tables``)."""

    rows: Tensor  # [2**_TESTS, _FIELDS + 2] int64
    bits: Tensor  # [_TESTS] int64: 2**k
    consts: Tensor  # [6]: the column constants after the slope at 0
    fracs: Tensor  # [3]: the zoom's midpoint and safeguards, as fractions


_TABLES: dict = {}


def tables(like: Tensor) -> Tables:
    """The search's tables on ``like``'s device, the constants at its dtype:
    copied there (without a wait) on a first call, kept for later ones."""
    key = (like.device, like.dtype)
    tabs = _TABLES.get(key)
    if tabs is None:
        def put(values, dtype):
            return torch.tensor(values, dtype=dtype).to(like.device, non_blocking=True)

        tabs = _TABLES[key] = Tables(
            put(_TABLE, torch.int64), put([1 << k for k in range(_TESTS)], torch.int64),
            put(_COLUMN_CONSTS, like.dtype), put((0.5, 0.1, 0.9), like.dtype))
    return tabs


def _next_zoom_alpha(lo, dx, phi_lo, dphi_lo, phi_hi, fracs):
    """Safeguarded quadratic interpolation on [lo, lo + dx] using (phi_lo,
    dphi_lo, phi_hi): the minimiser of the quadratic, clipped to the
    interval's 10%-90%, or its midpoint where the quadratic is flat or not
    finite."""
    slope = dphi_lo * dx
    quad = lo - slope * dx / (2.0 * (phi_hi - phi_lo - slope))
    # lo + [0.5, 0.1, 0.9] dx: the midpoint, then the safeguards
    points = lo[..., None] + fracs * dx[..., None]
    low, high = points[..., 1:].aminmax(dim=-1)
    return torch.where(torch.isfinite(quad), torch.clamp(quad, low, high), points[..., 0])


def start(phi0: Tensor, g0: Tensor, d: Tensor, alpha0: Tensor, active: Optional[Tensor],
          c2: float, max_evals: int, dot) -> Tuple[Search, Tensor]:
    """A search's first state and its constants, from f and its gradient at
    alpha = 0 and the first trial step; ``active`` None for 0-d scalars,
    else the [L] lanes that search."""
    tabs = tables(phi0)
    dphi0 = dot(g0, d)
    # approximate-Wolfe slack: accept decrease up to PLATEAU_ULPS ulps of phi0
    # (the convergence check floors its function tolerance at the same width)
    slack = PLATEAU_ULPS * torch.finfo(phi0.dtype).eps * phi0.abs()
    k = torch.cat([dphi0[..., None], tabs.consts.expand(phi0.shape + (6,)),
                   torch.stack([phi0, slack, -c2 * dphi0], -1)], -1)
    zero = k[..., _ZERO - _DPHI0]
    s0 = torch.stack([alpha0, zero, zero, phi0, zero, zero, phi0, dphi0, phi0, zero, phi0,
                      zero, zero], -1)
    run0 = (dphi0 < 0) & (max_evals > 0)  # a descent direction
    if active is not None:
        run0 = run0 & active
    return Search(s0, g0, run0), k


def trial(st: Search) -> Tensor:
    """The step a search evaluates next."""
    return st.s[..., _ALPHA]


def step(st: Search, phi: Tensor, g: Tensor, d: Tensor, k: Tensor, lanes: bool, c1: float,
         max_evals: int, max_alpha: float, dot) -> Search:
    """The next state after evaluating f (``phi``) and its gradient (``g``)
    at the trial step; ``k`` the search's constants."""
    tabs = tables(phi)
    s, best_g, run = st
    f = s.unbind(-1)
    c = k.unbind(-1)
    dphi0, zero, one = c[0], c[_ZERO - _DPHI0], c[_ONE - _DPHI0]
    phi0, slack, curv_bound = c[_K_PHI0], c[_K_SLACK], c[_K_CURV]
    alpha = f[_ALPHA]
    dphi = dot(g, d)
    # the eight tests, each a >= b: Armijo (NaN failing), phi >= phi_prev,
    # the curvature condition, dphi >= 0, phi >= phi_lo, the slope pointing
    # back across the zoom interval, a later evaluation, the bracketing stage
    a = torch.stack([phi0 + c1 * alpha * dphi0 + slack, phi, curv_bound, dphi, phi,
                     dphi * (f[_HI] - f[_LO]), f[_EVALS], zero], -1)
    b = torch.stack([phi, f[_PHI_PREV], dphi.abs(), zero, f[_PHI_LO], zero, one, f[_STAGE]],
                    -1)
    index = ((a >= b) * tabs.bits).sum(-1)
    # (the row by index_select: a 0-d index would be read on the host)
    rows = tabs.rows.index_select(0, index.reshape(-1)).view(index.shape + (_FIELDS + 2,))
    counted = f[_EVALS] + 1
    columns = torch.cat([s, torch.stack([phi, dphi, torch.clamp(2.0 * alpha, max=max_alpha),
                                         counted], -1), k[..., :_KEEPS - _DPHI0 + 1]], -1)
    nxt = columns.gather(-1, rows).unbind(-1)
    lo, hi = nxt[_LO], nxt[_HI]
    dx = hi - lo
    # zoom: an interval collapsed stops the search at the best point
    stage = torch.where(dx.abs() <= nxt[_TOL] * torch.clamp(hi.abs(), min=1.0), float(_DONE),
                        nxt[_STAGE])
    alpha_next = torch.where(stage == _ZOOM, _next_zoom_alpha(
        lo, dx, nxt[_PHI_LO], nxt[_DPHI_LO], nxt[_PHI_HI], tabs.fracs), nxt[_ALPHA])
    s_next = torch.stack((alpha_next, stage) + nxt[_ALPHA_PREV:_FIELDS], -1)
    take = nxt[_TAKE] > 0
    run_next = (stage < _DONE) & (counted < max_evals)
    if lanes:  # finished lanes keep their state
        s_next = torch.where(run[..., None], s_next, s)
        take = run & take
        run_next = run & run_next
        take = take[..., None]
    return Search(s_next, torch.where(take, g, best_g), run_next)


def result(final: Search) -> LineSearchResult:
    """The search's outcome: the best point found, or a step of 0."""
    s = final.s
    best_alpha = s[..., _BEST_ALPHA]
    return LineSearchResult(alpha=best_alpha, phi=s[..., _BEST_PHI], g=final.best_g,
                            success=best_alpha > 0, wolfe=s[..., _WOLFE] > 0,
                            num_evals=s[..., _EVALS].to(torch.int32))


def strong_wolfe(phi_fn: Callable[[Tensor], Tuple[Tensor, Tensor]], phi0: Tensor,
                 g0: Tensor, d: Tensor, alpha0, c1: float = 1e-4, c2: float = 0.9,
                 max_evals: int = 25, max_alpha: float = 1e10) -> LineSearchResult:
    """Find alpha satisfying the strong Wolfe conditions along d.

    ``phi_fn(alpha) -> (f(w + alpha d), grad f(w + alpha d))`` for a 0-d
    ``alpha``; ``phi0`` / ``g0`` are f and its gradient at alpha = 0."""
    alpha0 = alpha0 if isinstance(alpha0, Tensor) else torch.full_like(phi0, alpha0)
    st, k = start(phi0, g0, d, alpha0, None, c2, max_evals, torch.dot)

    def body(st: Search) -> Search:
        phi, g = phi_fn(trial(st))
        return step(st, phi, g, d, k, False, c1, max_evals, max_alpha, torch.dot)

    return result(while_loop(lambda st: st.run, body, st))
