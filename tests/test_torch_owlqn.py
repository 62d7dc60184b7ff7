"""The port's OWLQN (L1 and elastic net) against the JAX package, in float64
on the CPU.

The port writes OWLQN once, in the lane form (``minimize_owlqn_lanes``): a
random-effect bucket runs it over its lanes, as the JAX package runs
``jax.vmap(minimize_owlqn)``, and the fixed effect runs it as one lane, as
the JAX package runs its scalar ``minimize_owlqn``.  Both get the same numpy
inputs.

Tolerances: coefficients rtol 1e-8 (relative to the largest magnitude; the
two sides take the same steps and differ only in the summation order of
their float64 dot products), identical per-lane iteration counts and
reasons, and identical zero sets.  Fits through ``GameEstimator`` within
rtol 1e-6, as tests/test_torch_game.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core import normalization as jn
from photon_ml_tpu.core.batch import DenseBatch as JBatch
from photon_ml_tpu.core.batch import dense_batch as j_dense_batch
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt import lbfgs as jlbfgs
from photon_ml_tpu.opt import types as jtypes
from photon_ml_tpu.types import NormalizationType as JKind
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.core.batch import dense_batch as t_dense_batch
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.objective import LaneObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.opt import lbfgs as tlbfgs
from photon_ml_tpu_torch.opt import types as ttypes
from photon_ml_tpu_torch.opt.solve import make_lane_solver, make_solver
from photon_ml_tpu_torch.types import (ConvergenceReason, NormalizationType,
                                       OptimizerType, TaskType)

RTOL = 1e-8
FIT_RTOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _bucket(num_l, cap, d, seed, loss="logistic"):
    """A ragged lanes-first bucket (lane k holds counts[k] real rows, lanes
    0-1 are all padding) with per-lane L1 and L2 weights."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, cap + 1, size=num_l)
    counts[:2] = 0
    valid = np.arange(cap)[None, :] < counts[:, None]
    x = rng.normal(size=(num_l, cap, d)) * valid[..., None]
    z = np.einsum("lcd,ld->lc", x, rng.normal(size=(num_l, d)) * (rng.random(d) < 0.5))
    if loss == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -4, 2))).astype(np.float64)
    elif loss == "squared":
        y = z + rng.normal(size=z.shape) * 0.3
    else:
        y = (rng.random(z.shape) < 1 / (1 + np.exp(-z))).astype(np.float64)
    off = rng.normal(size=(num_l, cap)) * 0.2 * valid
    wt = (rng.random((num_l, cap)) + 0.5) * valid
    l1 = rng.uniform(0.5, 4.0, num_l)
    l2 = rng.uniform(0.0, 0.5, num_l)
    return x, y * valid, off, wt, l1, l2


def _jax_owlqn_vmapped(loss, cfg, x, y, off, wt, l1, l2):
    jloss = jl.loss_by_name(loss)

    def one(w0, xx, yy, oo, ww, l1_, l2_):
        obj = JObjective(loss=jloss, reg=JReg(l2=l2_))
        b = JBatch(x=xx, y=yy, offset=oo, weight=ww)
        return jlbfgs.minimize_owlqn(lambda w: obj.value_and_grad(w, b), w0, l1_, cfg)

    return jax.jit(jax.vmap(one))(jnp.zeros(x.shape[::2]),
                                  *[jnp.asarray(a) for a in (x, y, off, wt, l1, l2)])


def _port_owlqn_lanes(loss, cfg, x, y, off, wt, l1, l2):
    t = [torch.from_numpy(a) for a in (x, y, off, wt, l1, l2)]
    obj = LaneObjective(tl.loss_by_name(loss), t[5])
    b = TBatch(x=t[0], y=t[1], offset=t[2], weight=t[3])
    return tlbfgs.minimize_owlqn_lanes(lambda w: obj.value_and_grad(w, b),
                                       torch.zeros(x.shape[::2], dtype=torch.float64),
                                       t[4], cfg)


def _assert_same_solve(t, j):
    np.testing.assert_array_equal(np.asarray(t.iterations), np.asarray(j.iterations))
    np.testing.assert_array_equal(np.asarray(t.reason), np.asarray(j.reason))
    tw, jw = np.asarray(t.w), np.asarray(j.w)
    np.testing.assert_array_equal(tw == 0, jw == 0)
    assert _rel(tw, jw) <= RTOL
    assert _rel(t.value, j.value) <= RTOL


@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared"])
def test_owlqn_lanes_match_jax_vmap(loss):
    """Per-lane L1 weights over a ragged bucket, an iteration budget that
    some lanes exhaust: ``minimize_owlqn_lanes`` against
    ``jax.vmap(minimize_owlqn)``."""
    x, y, off, wt, l1, l2 = _bucket(num_l=24, cap=24, d=8, seed=len(loss))
    kw = dict(max_iters=12, tolerance=1e-10)
    j = _jax_owlqn_vmapped(loss, jtypes.SolverConfig(**kw), x, y, off, wt, l1, l2)
    t = _port_owlqn_lanes(loss, ttypes.SolverConfig(**kw), x, y, off, wt, l1, l2)
    _assert_same_solve(t, j)
    w = t.w.numpy()
    assert 0 < (w == 0).mean() < 1  # the L1 zeroes some coefficients, not all


def test_owlqn_failed_line_search_keeps_the_point():
    """A one-trial search that fails keeps the lane's old point (the JAX
    search ends on its last trial; ``ok`` selects the old point), and the
    lane stops with OBJECTIVE_NOT_IMPROVING, as in the reference."""
    x, y, off, wt, l1, l2 = _bucket(num_l=16, cap=16, d=6, seed=11)
    x = x * 4.0  # steep lanes whose first unit trial overshoots
    kw = dict(max_iters=20, tolerance=1e-12, max_linesearch=1)
    j = _jax_owlqn_vmapped("logistic", jtypes.SolverConfig(**kw), x, y, off, wt, l1, l2)
    t = _port_owlqn_lanes("logistic", ttypes.SolverConfig(**kw), x, y, off, wt, l1, l2)
    _assert_same_solve(t, j)
    assert (t.reason.numpy() == int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)).any()


def _glm(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * np.exp(rng.uniform(-1, 1, d)) + rng.uniform(-1, 1, d)
    x[:, 0] = 1.0
    z = x @ (rng.normal(size=d) * (rng.random(d) < 0.4))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return x, y, rng.normal(size=n) * 0.1, rng.random(n) + 0.5


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("reg", [dict(l1=6.0), dict(l1=6.0, l2=0.5)])
def test_owlqn_one_lane_matches_jax_scalar(reg, normalized):
    """The fixed effect's solve, OWLQN as one lane over ``GLMObjective``,
    against the JAX scalar ``minimize_owlqn``, with and without a
    STANDARDIZATION context (the L1 weight applies to the transformed
    coefficients, the intercept's too)."""
    x, y, off, wt = _glm(500, 12, seed=3)
    jn_ctx = tn_ctx = None
    if normalized:
        jn_ctx = jn.build_normalization(JKind.STANDARDIZATION, jn.compute_feature_stats(
            jnp.asarray(x), intercept_index=0))
        tn_ctx = tn.build_normalization(NormalizationType.STANDARDIZATION,
                                        tn.compute_feature_stats(torch.from_numpy(x),
                                                                 intercept_index=0))
    kw = dict(max_iters=80, tolerance=1e-10)
    jobj = JObjective(loss=jl.logistic_loss, reg=JReg(**reg),
                      **({} if jn_ctx is None else {"norm": jn_ctx}))
    jb = j_dense_batch(x, y, off, wt)
    j = jax.jit(lambda w: jlbfgs.minimize_owlqn(lambda v: jobj.value_and_grad(v, jb), w,
                                                reg["l1"], jtypes.SolverConfig(**kw)))(
        jnp.zeros(12))
    tobj = TObjective(loss=tl.logistic_loss, reg=TReg(**reg),
                      **({} if tn_ctx is None else {"norm": tn_ctx}))
    t = make_solver(tobj, OptimizerType.LBFGS, ttypes.SolverConfig(**kw))(
        torch.zeros(12, dtype=torch.float64), t_dense_batch(x, y, off, wt))
    assert (t.iterations, t.reason) == (int(j.iterations), int(j.reason))
    np.testing.assert_array_equal(t.w.numpy() == 0, np.asarray(j.w) == 0)
    assert _rel(t.w, j.w) <= RTOL
    assert abs(t.value - float(j.value)) <= RTOL * abs(float(j.value))
    assert 0 < (t.w.numpy() == 0).sum() < 12


def test_lane_solver_dispatches_owlqn():
    """``make_lane_solver`` runs OWLQN for L-BFGS with an L1 weight and for
    OWLQN, with the coordinate's L1 on every lane."""
    x, y, off, wt, _, l2 = _bucket(num_l=10, cap=12, d=5, seed=4)
    cfg = ttypes.SolverConfig(max_iters=30, tolerance=1e-10)
    t = [torch.from_numpy(a) for a in (x, y, off, wt, l2)]
    batch = TBatch(x=t[0], y=t[1], offset=t[2], weight=t[3])
    w0 = torch.zeros(x.shape[::2], dtype=torch.float64)
    ref = _port_owlqn_lanes("logistic", cfg, x, y, off, wt, np.full(10, 1.5), l2)
    for opt in (OptimizerType.LBFGS, OptimizerType.OWLQN):
        res = make_lane_solver(tl.logistic_loss, opt, cfg, l1=1.5)(w0, batch, t[4])
        torch.testing.assert_close(res.w, ref.w, rtol=0, atol=0)


def _en_data(seed, n_users=10, per_user=40, d_g=6, d_u=5):
    rng = np.random.default_rng(seed)
    n = n_users * per_user
    xg = rng.normal(size=(n, d_g))
    xu = rng.normal(size=(n, d_u))
    uids = rng.permutation(np.repeat(np.arange(n_users), per_user))
    z = xg @ rng.normal(size=d_g) + np.einsum("nd,nd->n", xu,
                                              rng.normal(size=(n_users, d_u))[uids])
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    idx = rng.integers(0, 60, size=(n, 4)).astype(np.int32)
    vals = rng.normal(size=(n, 4))
    vals[rng.random((n, 4)) < 0.2] = 0.0
    return xg, xu, uids, y, idx, vals


def _fit_both(parts_j, parts_t, coords, norms=None):
    """Fit the same coordinates, given as (name, JAX config, port config),
    with both estimators over two sweeps; returns the two models.  The
    solves run to the float64 plateau: the second sweep's warm starts round
    ~1e-16 apart on the two sides, and OWLQN's orthant steps can carry that
    to ~1e-5 along a flat direction before a looser function tolerance
    stops it."""
    solver = dict(max_iters=300, tolerance=1e-14)
    jcfg = JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        name: j(jtypes.SolverConfig(**solver)) for name, j, _ in coords})
    tcfg = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                      coordinates={name: t(ttypes.SolverConfig(**solver))
                                   for name, _, t in coords})
    jn_, tn_ = norms or ({}, {})
    jm = JEstimator(fused=False, dtype=np.float64, normalization=jn_).fit(
        JData(**parts_j), [jcfg])[0].model
    tm = GameEstimator(device="cpu", dtype=torch.float64, normalization=tn_).fit(
        GameData(**parts_t), [tcfg])[0].model
    return jm, tm


@pytest.mark.parametrize("fixed_shard", ["dense", "sparse"])
def test_fixed_elastic_net_fit_matches_jax(fixed_shard):
    """A fixed effect under elastic net (OWLQN through the one-lane adapter;
    a dense shard keeps the fused value-and-gradient) beside a per-user
    coordinate, through ``GameEstimator.fit``."""
    xg, xu, uids, y, idx, vals = _en_data(21)
    reg = dict(l1=40.0, l2=0.5)
    jg = xg if fixed_shard == "dense" else JShard(indices=idx, values=vals, dim=60)
    tg = xg if fixed_shard == "dense" else SparseShard(indices=idx, values=vals, dim=60)
    coords = [("fixed", lambda s: JFixed(feature_shard="g", solver=s, reg=JReg(**reg)),
               lambda s: FixedEffectConfig(feature_shard="g", solver=s, reg=TReg(**reg))),
              ("per-user",
               lambda s: JRandom(random_effect_type="userId", feature_shard="u", solver=s,
                                 reg=JReg(l2=1.0)),
               lambda s: RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                                            solver=s, reg=TReg(l2=1.0)))]
    tags = {"userId": uids}
    jm, tm = _fit_both(dict(y=y, features={"g": jg, "u": xu}, id_tags=tags),
                       dict(y=y, features={"g": tg, "u": xu}, id_tags=tags), coords)
    tw, jw = tm["fixed"].coefficients.means, jm["fixed"].coefficients.means
    assert _rel(tw, jw) <= FIT_RTOL
    np.testing.assert_array_equal(tw == 0, np.asarray(jw) == 0)
    assert (tw == 0).any()
    assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= FIT_RTOL


@pytest.mark.parametrize("layout", ["lanes", "compact", "compact_standardized"])
def test_random_effect_elastic_net_fit_matches_jax(layout):
    """Per-user elastic net through ``GameEstimator.fit``: a dense IDENTITY
    coordinate (the lane OWLQN over full-width lanes, which the SoA gate
    turns away), a sparse shard on compact lanes, and the same under a
    STANDARDIZATION context (per-lane factor and shift rows)."""
    xg, xu, uids, y, idx, vals = _en_data(23)
    norms = None
    if layout == "lanes":
        ju = tu = xu
    else:
        idx = np.concatenate([np.zeros((len(y), 1), np.int32), idx + 1], axis=1)
        vals = np.concatenate([np.ones((len(y), 1)), vals + 2.0 * (vals != 0)], axis=1)
        ju = JShard(indices=idx, values=vals, dim=61)
        tu = SparseShard(indices=idx, values=vals, dim=61)
        if layout == "compact_standardized":
            norms = ({"u": jn.build_normalization(
                         JKind.STANDARDIZATION,
                         jn.compute_feature_stats_sparse(idx, vals, 61, intercept_index=0))},
                     {"u": tn.build_normalization(
                         NormalizationType.STANDARDIZATION,
                         tn.compute_feature_stats_sparse(idx, vals, 61, intercept_index=0))})
    reg = dict(l1=2.0, l2=2.0)
    coords = [("fixed", lambda s: JFixed(feature_shard="g", solver=s, reg=JReg(l2=1.0)),
               lambda s: FixedEffectConfig(feature_shard="g", solver=s, reg=TReg(l2=1.0))),
              ("per-user",
               lambda s: JRandom(random_effect_type="userId", feature_shard="u", solver=s,
                                 reg=JReg(**reg), intercept_index=0),
               lambda s: RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                                            solver=s, reg=TReg(**reg), intercept_index=0))]
    tags = {"userId": uids}
    jm, tm = _fit_both(dict(y=y, features={"g": xg, "u": ju}, id_tags=tags),
                       dict(y=y, features={"g": xg, "u": tu}, id_tags=tags), coords, norms)
    tw, jw = tm["per-user"].w_stack, np.asarray(jm["per-user"].w_stack)
    assert tm["per-user"].slot_of == jm["per-user"].slot_of
    assert _rel(tw, jw) <= FIT_RTOL
    np.testing.assert_array_equal(tw == 0, jw == 0)
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= FIT_RTOL
