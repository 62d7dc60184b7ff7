"""The PyTorch port's solvers against the JAX package's, in float64 on the CPU.

Both sides get the same numpy inputs.  The port's solvers are host loops and
the reference's are ``lax.while_loop``s, so the iterates agree to rounding;
tolerances are stated per test.  An iteration count may differ by one where
a convergence test lands within rounding of its threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core.batch import dense_batch as j_dense_batch
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.opt import lbfgs as jlbfgs
from photon_ml_tpu.opt import newton_soa as jnewton
from photon_ml_tpu.opt import types as jtypes
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core.batch import dense_batch as t_dense_batch
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.opt import newton_soa as tnewton
from photon_ml_tpu_torch.opt import types as ttypes
from photon_ml_tpu_torch.opt.solve import make_solver
from photon_ml_tpu_torch.types import OptimizerType


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _glm(n, d, seed, loss):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * 0.3
    w_true = rng.normal(size=d)
    z = x @ w_true
    if loss == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    elif loss == "poisson":
        y = rng.poisson(np.exp(np.clip(z * 0.3, -5, 3))).astype(np.float64)
    else:
        y = z + rng.normal(size=n) * 0.1
    off = rng.normal(size=n) * 0.1
    wt = rng.random(n) + 0.5
    return x, y, off, wt


@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_minimize_lbfgs_matches_jax(loss):
    """rtol 1e-8 on the coefficients: the two L-BFGS runs take the same
    steps, and their f64 dot products differ only in summation order."""
    x, y, off, wt = _glm(400, 24, seed=7, loss=loss)
    w0 = np.zeros(24)
    jcfg = jtypes.SolverConfig(max_iters=50, tolerance=1e-9)
    jobj = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.5))
    jb = j_dense_batch(x, y, off, wt)
    jres = jax.jit(lambda w: jlbfgs.minimize_lbfgs(
        lambda v: jobj.value_and_grad(v, jb), w, jcfg))(jnp.asarray(w0))

    tcfg = ttypes.SolverConfig(max_iters=50, tolerance=1e-9)
    tobj = TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.5))
    tres = make_solver(tobj, OptimizerType.LBFGS, tcfg)(
        torch.from_numpy(w0), t_dense_batch(x, y, off, wt))

    assert _rel(tres.w, jres.w) <= 1e-8
    assert abs(float(tres.value) - float(jres.value)) <= 1e-10 * abs(float(jres.value))
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    assert tres.reason == int(jres.reason)


def test_lbfgs_stationary_start_and_max_iters():
    x, y, off, wt = _glm(100, 5, seed=3, loss="squared")
    tobj = TObjective(loss=tl.squared_loss, reg=TReg(l2=1.0))
    b = t_dense_batch(x, y, off, wt)
    res = make_solver(tobj, config=ttypes.SolverConfig(max_iters=2, tolerance=1e-30))(
        torch.zeros(5, dtype=torch.float64), b)
    assert res.iterations == 2 and res.reason == int(jtypes.ConvergenceReason.MAX_ITERATIONS)
    # zero data and zero start: the gradient is exactly 0 at w0
    zb = t_dense_batch(np.zeros((4, 5)), np.zeros(4), None, None)
    res0 = make_solver(tobj)(torch.zeros(5, dtype=torch.float64), zb)
    assert res0.iterations == 0
    assert res0.reason == int(jtypes.ConvergenceReason.GRADIENT_CONVERGED)


def test_make_solver_refuses_out_of_slice():
    """The reference's dispatch and its errors: L1 under L-BFGS, and OWLQN,
    solve with OWLQN (held against the JAX ``make_solver``, coefficients rtol
    1e-8 and the same iterations and reason); TRON with L1, and TRON or the
    L1 regime with a box, are ValueErrors."""
    from photon_ml_tpu.opt.solve import make_solver as j_make_solver
    from photon_ml_tpu.types import OptimizerType as JOptimizerType

    x, y, off, wt = _glm(300, 12, seed=5, loss="logistic")
    jb, tb = j_dense_batch(x, y, off, wt), t_dense_batch(x, y, off, wt)
    cfg = dict(max_iters=40, tolerance=1e-9)
    for opt, reg in ((OptimizerType.LBFGS, dict(l1=3.0, l2=0.1)),
                     (OptimizerType.OWLQN, dict(l1=3.0)),
                     (OptimizerType.OWLQN, dict(l2=0.5))):
        jres = jax.jit(lambda w: j_make_solver(
            JObjective(loss=jl.logistic_loss, reg=JReg(**reg)), JOptimizerType(opt.value),
            jtypes.SolverConfig(**cfg))(w, jb))(jnp.zeros(12))
        tres = make_solver(TObjective(loss=tl.logistic_loss, reg=TReg(**reg)), opt,
                           ttypes.SolverConfig(**cfg))(torch.zeros(12, dtype=torch.float64),
                                                       tb)
        assert _rel(tres.w, jres.w) <= 1e-8, (opt, reg)
        assert (tres.iterations, tres.reason) == (int(jres.iterations), int(jres.reason))
        np.testing.assert_array_equal(tres.w.numpy() == 0, np.asarray(jres.w) == 0)
    l1 = TObjective(loss=tl.logistic_loss, reg=TReg(l1=0.1))
    box = (torch.zeros(12, dtype=torch.float64), torch.ones(12, dtype=torch.float64))
    with pytest.raises(ValueError, match="TRON does not support L1"):
        make_solver(l1, OptimizerType.TRON)
    with pytest.raises(ValueError, match="TRON does not support box"):
        make_solver(TObjective(loss=tl.logistic_loss), OptimizerType.TRON, box=box)
    for opt, obj in ((OptimizerType.LBFGS, l1),
                     (OptimizerType.OWLQN, TObjective(loss=tl.logistic_loss))):
        with pytest.raises(ValueError, match="OWLQN does not support box"):
            make_solver(obj, opt, box=box)
@pytest.mark.parametrize("d,loss", [(1, "logistic"), (4, "logistic"), (4, "poisson"),
                                    (7, "squared")])
def test_solve_newton_soa_matches_jax(d, loss):
    """rtol 1e-9 on the coefficients; iteration counts and reasons per lane
    agree exactly (Newton converges quadratically, so the last step is far
    from any threshold)."""
    rng = np.random.default_rng(d)
    cap, num_l = 16, 300
    x = rng.normal(size=(cap, d, num_l))
    y = (rng.random((cap, num_l)) < 0.5).astype(np.float64)
    if loss == "poisson":
        y = rng.poisson(1.0, size=(cap, num_l)).astype(np.float64)
    off = rng.normal(size=(cap, num_l)) * 0.2
    wt = (rng.random((cap, num_l)) < 0.7).astype(np.float64)
    wt[:, :5] = 0.0  # weightless (padding) lanes
    l2 = np.full(num_l, 1.0)
    w0 = np.zeros((d, num_l))
    args = (w0, x, y, off, wt, l2)
    jcfg = jtypes.SolverConfig(max_iters=30, tolerance=1e-7)
    jres = jax.jit(lambda *a: jnewton.solve_newton_soa(jl.loss_by_name(loss), *a, jcfg))(
        *[jnp.asarray(a) for a in args])
    tres = tnewton.solve_newton_soa(tl.loss_by_name(loss),
                                    *[torch.from_numpy(a) for a in args],
                                    ttypes.SolverConfig(max_iters=30, tolerance=1e-7))
    assert _rel(tres.w, jres.w) <= 1e-9
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(tres.reason.numpy(), np.asarray(jres.reason))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_convergence_check_matches_jax(dtype):
    rng = np.random.default_rng(11)
    n = 64
    f0 = rng.normal(size=n).astype(dtype) * 100
    prev = f0 - np.abs(rng.normal(size=n)).astype(dtype)
    val = prev - (np.abs(rng.normal(size=n)) * 10.0 ** rng.integers(-12, 0, n)).astype(dtype)
    gn0 = np.abs(rng.normal(size=n)).astype(dtype)
    gn = (gn0 * 10.0 ** rng.integers(-9, 0, n)).astype(dtype)
    for it in (3, 10):
        j = jtypes.convergence_check(*[jnp.asarray(a) for a in (val, prev, f0, gn, gn0)],
                                     jnp.int32(it), 10, 1e-7)
        t = ttypes.convergence_check(*[torch.from_numpy(a) for a in (val, prev, f0, gn, gn0)],
                                     it, 10, 1e-7)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
