"""The port's TRON and lane-batched solvers against the JAX package's, in
float64 on the CPU.

The JAX package solves a random-effect bucket as ``jax.vmap`` of its
``lax.while_loop`` solvers; the port runs one solver over a leading lane axis
with per-lane masks.  Both get the same numpy inputs: a ragged bucket whose
lanes hold 0..cap real rows (all-padding and all-zero-weight lanes converge
at once) under an iteration budget that some lanes exhaust.

Tolerances: coefficients rtol 1e-8 (relative to the largest magnitude).  The
two sides take the same steps and differ only in the summation order of
their float64 dot products, so iterates agree to ~1e-13; the margin covers
the amplification of those ulps over ~10 iterations.  Per-lane iteration
counts and convergence reasons must be identical.

One lane of the smoothed-hinge bucket is sensitive to rounding: the
reference's vmapped and scalar solves of that same lane end ~3e-4 apart
after 10 iterations (the vmapped reductions round differently, and the
hinge's piecewise curvature amplifies it).
Where the vmapped reference disagrees with its own scalar solve beyond the
tolerance, the port is held to the scalar solve of that lane instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core.batch import DenseBatch as JBatch
from photon_ml_tpu.core.batch import dense_batch as j_dense_batch
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.opt import lbfgs as jlbfgs
from photon_ml_tpu.opt import tron as jtron
from photon_ml_tpu.opt import types as jtypes
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.core.batch import dense_batch as t_dense_batch
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.objective import LaneObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.opt import types as ttypes
from photon_ml_tpu_torch.opt.solve import make_lane_solver, make_solver
from photon_ml_tpu_torch.types import ConvergenceReason, OptimizerType

RTOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _bucket(num_l, cap, d, seed, loss="logistic"):
    """A ragged lanes-first bucket: lane k holds counts[k] real rows, the
    rest padding (x = 0, weight 0).  Lanes 0-2 are all padding and lane 3
    has rows of weight 0 only."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, size=num_l)
    counts[:3] = 0
    counts[3] = cap
    valid = np.arange(cap)[None, :] < counts[:, None]
    x = rng.normal(size=(num_l, cap, d)) * valid[..., None]
    w_true = rng.normal(size=(num_l, d))
    z = np.einsum("lcd,ld->lc", x, w_true)
    if loss == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -4, 2))).astype(np.float64)
    elif loss == "squared":
        y = z + rng.normal(size=z.shape) * 0.3
    else:
        y = (rng.random(z.shape) < 1 / (1 + np.exp(-z))).astype(np.float64)
    y = y * valid
    off = rng.normal(size=(num_l, cap)) * 0.2 * valid
    wt = (rng.random((num_l, cap)) + 0.5) * valid
    wt[3] = 0.0
    l2 = 0.5 + rng.random(num_l)
    return x, y, off, wt, l2


def _jax_solve_one(loss, optimizer, cfg):
    jloss = jl.loss_by_name(loss)

    def one(w0, xx, yy, oo, ww, ll):
        obj = JObjective(loss=jloss, reg=JReg(l2=ll))
        b = JBatch(x=xx, y=yy, offset=oo, weight=ww)
        vg = lambda w: obj.value_and_grad(w, b)
        if optimizer == "tron":
            return jtron.minimize_tron(vg, lambda w, v: obj.hvp(w, b, v), w0, cfg)
        return jlbfgs.minimize_lbfgs(vg, w0, cfg)

    return one


def _jax_vmapped(loss, optimizer, cfg, x, y, off, wt, l2):
    w0 = jnp.zeros(x.shape[::2])
    return jax.jit(jax.vmap(_jax_solve_one(loss, optimizer, cfg)))(
        w0, *[jnp.asarray(a) for a in (x, y, off, wt, l2)])


@pytest.mark.parametrize("optimizer,loss", [
    ("tron", "logistic"), ("tron", "poisson"), ("tron", "squared"),
    ("lbfgs", "logistic"), ("lbfgs", "poisson"), ("lbfgs", "smoothed_hinge"),
])
def test_lane_solvers_match_jax_vmap(optimizer, loss):
    x, y, off, wt, l2 = _bucket(num_l=40, cap=32, d=6, seed=len(loss) + 3)
    max_iters = 5 if optimizer == "tron" else 10
    jcfg = jtypes.SolverConfig(max_iters=max_iters, tolerance=1e-10, max_cg=20)
    jres = _jax_vmapped(loss, optimizer, jcfg, x, y, off, wt, l2)

    opt = OptimizerType.TRON if optimizer == "tron" else OptimizerType.LBFGS
    solve = make_lane_solver(tl.loss_by_name(loss), opt,
                             ttypes.SolverConfig(max_iters=max_iters, tolerance=1e-10,
                                                 max_cg=20))
    t = [torch.from_numpy(a) for a in (x, y, off, wt, l2)]
    tres = solve(torch.zeros(x.shape[::2], dtype=torch.float64),
                 TBatch(x=t[0], y=t[1], offset=t[2], weight=t[3]), t[4])

    reasons = tres.reason.numpy()
    np.testing.assert_array_equal(reasons, np.asarray(jres.reason))
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    # the bucket exercises both ends: lanes done at once, lanes out of budget
    assert (reasons[:4] == int(ConvergenceReason.GRADIENT_CONVERGED)).all()
    assert (tres.iterations.numpy()[:4] == 0).all()
    assert (reasons == int(ConvergenceReason.MAX_ITERATIONS)).sum() >= 3

    tw, jw = tres.w.numpy(), np.array(jres.w)
    scale = np.abs(jw).max()
    for lane in np.nonzero(np.abs(tw - jw).max(axis=1) > RTOL * scale)[0]:
        js = jax.jit(_jax_solve_one(loss, optimizer, jcfg))(
            jnp.zeros(x.shape[2]), *[jnp.asarray(a[lane]) for a in (x, y, off, wt, l2)])
        assert np.abs(np.asarray(js.w) - jw[lane]).max() > RTOL * scale  # knife edge
        assert np.abs(tw[lane] - np.asarray(js.w)).max() <= RTOL * scale
        assert int(js.iterations) == tres.iterations[lane] and int(js.reason) == reasons[lane]
        jw[lane] = np.asarray(js.w)
    assert _rel(tw, jw) <= RTOL


def test_lane_objective_matches_jax_vmap():
    """Lane-batched value, gradient and Hessian-vector product against the
    JAX objective vmapped over lanes (rtol 1e-12: the same sums in another
    order)."""
    x, y, off, wt, l2 = _bucket(num_l=9, cap=16, d=5, seed=4)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(9, 5))
    v = rng.normal(size=(9, 5))
    jloss = jl.logistic_loss

    def one(ww, vv, xx, yy, oo, wtt, ll):
        obj = JObjective(loss=jloss, reg=JReg(l2=ll))
        b = JBatch(x=xx, y=yy, offset=oo, weight=wtt)
        f, g = obj.value_and_grad(ww, b)
        return f, g, obj.hvp(ww, b, vv)

    jf, jg, jh = jax.vmap(one)(*[jnp.asarray(a) for a in (w, v, x, y, off, wt, l2)])
    t = [torch.from_numpy(a) for a in (w, v, x, y, off, wt, l2)]
    obj = LaneObjective(tl.logistic_loss, t[6])
    b = TBatch(x=t[2], y=t[3], offset=t[4], weight=t[5])
    tf, tg = obj.value_and_grad(t[0], b)
    th = obj.hvp(t[0], b, t[1])
    assert _rel(tf, jf) <= 1e-12 and _rel(tg, jg) <= 1e-12 and _rel(th, jh) <= 1e-12


@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared"])
def test_fixed_effect_tron_matches_jax(loss):
    """TRON on one GLM (the fixed effect: one lane, Hessian-vector products
    through fused_hvp) against JAX minimize_tron."""
    rng = np.random.default_rng(21)
    n, d = 500, 30
    x = rng.normal(size=(n, d)) * 0.3
    z = x @ rng.normal(size=d)
    y = {"logistic": (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64),
         "poisson": rng.poisson(np.exp(np.clip(0.3 * z, -4, 2))).astype(np.float64),
         "squared": z + rng.normal(size=n) * 0.1}[loss]
    off = rng.normal(size=n) * 0.1
    wt = rng.random(n) + 0.5
    wt[::7] = 0.0
    w0 = np.zeros(d)
    jcfg = jtypes.SolverConfig(max_iters=30, tolerance=1e-10)
    jobj = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.7))
    jb = j_dense_batch(x, y, off, wt)
    jres = jax.jit(lambda w: jtron.minimize_tron(
        lambda u: jobj.value_and_grad(u, jb), lambda u, v: jobj.hvp(u, jb, v), w,
        jcfg))(jnp.asarray(w0))

    tobj = TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.7))
    tres = make_solver(tobj, OptimizerType.TRON,
                       ttypes.SolverConfig(max_iters=30, tolerance=1e-10))(
        torch.from_numpy(w0), t_dense_batch(x, y, off, wt))
    assert _rel(tres.w, jres.w) <= RTOL
    assert abs(tres.value - float(jres.value)) <= 1e-12 * abs(float(jres.value))
    assert tres.iterations == int(jres.iterations)
    assert tres.reason == int(jres.reason)


def test_tron_default_config_matches_jax():
    t, j = ttypes.SolverConfig.tron_default(), jtypes.SolverConfig.tron_default()
    assert (t.max_iters, t.tolerance, t.max_cg) == (j.max_iters, j.tolerance, j.max_cg)
    assert ttypes.SolverConfig().max_cg == jtypes.SolverConfig().max_cg == 20
