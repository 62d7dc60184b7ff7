"""Solver state tracking and the other public names of ROADMAP item 16,
against the JAX package on the CPU.

Both packages get the same numpy inputs, drawn from a seed, in float64
unless a test says otherwise.  The JAX lane solvers run under ``jax.vmap``;
the port's run over a leading lane axis with per-lane masks.

Tolerances for a tracker, lane by lane:

- the same ``num_states``, and nan in the same slots;
- values within rtol 1e-8, element by element (the two sides take the
  same steps; their float64 sums differ in order only);
- gradient norms within rtol 1e-6 of the lane's largest norm (its initial
  one).  Near a tight tolerance the last norms sit at the float64 noise
  floor of the gradient (~1e-12 of the initial norm), where the summation
  order alone moves them by ~1e-5 of themselves; relative to the lane's
  scale they agree to ~1e-12.

The other names are held to 1e-12 relative in float64 (the same sums in
another order), the generators bitwise, and ``score_sparse_compact`` within
1e-6 in float32 through ``match_dot_plain``.

``python -m pytest tests/test_torch_tracking.py -k iterations_float32 -s``
prints the fixed effect's L-BFGS iterations and objective evaluations at
three reduced glmix_chip scales, float32 compute, under float32 and bf16
storage in both packages (``bf16_iteration_table``).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core.batch import DenseBatch as JBatch
from photon_ml_tpu.core.batch import SparseBatch as JSparseBatch
from photon_ml_tpu.core.batch import dense_batch as j_dense_batch
from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.data import synthetic as jsynth
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game import coordinate as jcoord
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models import glm as jglm
from photon_ml_tpu.models.training import train_glm_reg_path as j_train_glm_reg_path
from photon_ml_tpu.ops import compact_score as jcs
from photon_ml_tpu.opt import lbfgs as jlbfgs
from photon_ml_tpu.opt import tron as jtron
from photon_ml_tpu.opt import types as jtypes
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.utils import linalg as jlinalg
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.core.batch import SparseBatch as TSparseBatch
from photon_ml_tpu_torch.core.batch import dense_batch as t_dense_batch
from photon_ml_tpu_torch.core.batch import narrow
from photon_ml_tpu_torch.core.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.data import synthetic as tsynth
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game import coordinate as tcoord
from photon_ml_tpu_torch.game import descent as tdescent
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.models import game as tgame
from photon_ml_tpu_torch.models import glm as tglm
from photon_ml_tpu_torch.models.training import train_glm_reg_path
from photon_ml_tpu_torch.ops import compact_score as tcs
from photon_ml_tpu_torch.opt import lbfgs as tlbfgs
from photon_ml_tpu_torch.opt import types as ttypes
from photon_ml_tpu_torch.opt.newton_soa import solve_newton_soa
from photon_ml_tpu_torch.opt.solve import make_lane_solver, make_solver
from photon_ml_tpu_torch.types import ConvergenceReason, OptimizerType, TaskType
from photon_ml_tpu_torch.utils import linalg as tlinalg

VALUE_RTOL = 1e-8
GRAD_NORM_RTOL = 1e-6
F64_RTOL = 1e-12
COMPACT_F32_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_same_tracker(t, j):
    """The port's tracker ``t`` against the JAX tracker ``j`` (either shape)."""
    tv, tg = np.atleast_2d(t.values.numpy()), np.atleast_2d(t.grad_norms.numpy())
    jv, jg = np.atleast_2d(np.asarray(j.values)), np.atleast_2d(np.asarray(j.grad_norms))
    assert t.num_states.dtype == torch.int32
    np.testing.assert_array_equal(np.atleast_1d(t.num_states.numpy()),
                                  np.atleast_1d(np.asarray(j.num_states)))
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
    seen = ~np.isnan(jv)
    assert (np.abs(tv - jv)[seen] <= VALUE_RTOL * np.abs(jv)[seen]).all()
    scale = np.nanmax(np.abs(jg), axis=1, keepdims=True)
    assert (np.nan_to_num(np.abs(tg - jg)) <= GRAD_NORM_RTOL * scale).all()


def _assert_tracks_iterations(res):
    """num_states = iterations + 1 on every lane (slot 0: the start)."""
    np.testing.assert_array_equal(np.atleast_1d(res.tracker.num_states.numpy()),
                                  np.atleast_1d(np.asarray(res.iterations)) + 1)


# -- inputs ------------------------------------------------------------------


def _glm(n, d, seed, loss):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * 0.3
    z = x @ rng.normal(size=d)
    y = {"logistic": (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64),
         "poisson": rng.poisson(np.exp(np.clip(0.3 * z, -4, 2))).astype(np.float64),
         "squared": z + rng.normal(size=n) * 0.1}[loss]
    off = rng.normal(size=n) * 0.1
    wt = rng.random(n) + 0.5
    return x, y, off, wt


def _bucket(num_l, cap, d, seed, loss="logistic"):
    """A ragged lanes-first bucket; lanes 0-2 are all padding (they converge
    at once) and lane 3 has rows of weight 0 only."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, size=num_l)
    counts[:3] = 0
    counts[3] = cap
    valid = np.arange(cap)[None, :] < counts[:, None]
    x = rng.normal(size=(num_l, cap, d)) * valid[..., None]
    z = np.einsum("lcd,ld->lc", x, rng.normal(size=(num_l, d)))
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
    return x, y, off, wt, 0.5 + rng.random(num_l)


def _jax_lane_solve(loss, optimizer, cfg, l1=0.0):
    jloss = jl.loss_by_name(loss)

    def one(w0, xx, yy, oo, ww, ll):
        obj = JObjective(loss=jloss, reg=JReg(l2=ll))
        b = JBatch(x=xx, y=yy, offset=oo, weight=ww)
        vg = lambda w: obj.value_and_grad(w, b)
        if optimizer == "tron":
            return jtron.minimize_tron(vg, lambda w, v: obj.hvp(w, b, v), w0, cfg)
        if optimizer == "owlqn":
            return jlbfgs.minimize_owlqn(vg, w0, l1, cfg)
        return jlbfgs.minimize_lbfgs(vg, w0, cfg)

    return one


def _both_lane_solves(loss, optimizer, max_iters, track=True, l1=0.0, seed=11):
    x, y, off, wt, l2 = _bucket(num_l=24, cap=24, d=6, seed=seed, loss=loss)
    kw = dict(max_iters=max_iters, tolerance=1e-10)
    jcfg = jtypes.SolverConfig(track_states=track, **kw)
    jres = jax.jit(jax.vmap(_jax_lane_solve(loss, optimizer, jcfg, l1)))(
        jnp.zeros(x.shape[::2]), *[jnp.asarray(a) for a in (x, y, off, wt, l2)])
    opt = {"tron": OptimizerType.TRON, "owlqn": OptimizerType.OWLQN,
           "lbfgs": OptimizerType.LBFGS}[optimizer]
    solve = make_lane_solver(tl.loss_by_name(loss), opt,
                             ttypes.SolverConfig(track_states=track, **kw), l1=l1)
    t = [torch.from_numpy(a) for a in (x, y, off, wt, l2)]
    tres = solve(torch.zeros(x.shape[::2], dtype=torch.float64),
                 TBatch(x=t[0], y=t[1], offset=t[2], weight=t[3]), t[4])
    return tres, jres


# -- the solvers' trackers ------------------------------------------------------


@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_scalar_lbfgs_tracker_matches_jax(loss):
    x, y, off, wt = _glm(400, 24, seed=7, loss=loss)
    kw = dict(max_iters=40, tolerance=1e-9)
    jobj = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.5))
    jb = j_dense_batch(x, y, off, wt)
    jres = jax.jit(lambda w: jlbfgs.minimize_lbfgs(
        lambda v: jobj.value_and_grad(v, jb), w, jtypes.SolverConfig(**kw)))(
        jnp.zeros(24))
    tres = make_solver(TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.5)),
                       OptimizerType.LBFGS, ttypes.SolverConfig(**kw))(
        torch.zeros(24, dtype=torch.float64), t_dense_batch(x, y, off, wt))
    assert tres.tracker.values.shape == (41,)
    assert tres.iterations == int(jres.iterations) and tres.reason == int(jres.reason)
    _assert_same_tracker(tres.tracker, jres.tracker)
    _assert_tracks_iterations(tres)
    assert tres.convergence_reason() == jres.convergence_reason()


@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_boxed_lbfgs_tracker_matches_jax(loss):
    """The projected-gradient L-BFGS records the projected-gradient norm."""
    x, y, off, wt = _glm(300, 10, seed=3, loss=loss)
    rng = np.random.default_rng(5)
    lo = -np.abs(rng.normal(size=10)) * 0.05
    hi = np.abs(rng.normal(size=10)) * 0.05
    kw = dict(max_iters=30, tolerance=1e-9)
    jobj = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.1))
    jb = j_dense_batch(x, y, off, wt)
    jres = jax.jit(lambda w: jlbfgs.minimize_lbfgs(
        lambda v: jobj.value_and_grad(v, jb), w, jtypes.SolverConfig(**kw),
        box=(jnp.asarray(lo), jnp.asarray(hi))))(jnp.zeros(10))
    tobj = TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.1))
    tb = t_dense_batch(x, y, off, wt)
    tres = tlbfgs.minimize_lbfgs(lambda v: tobj.value_and_grad(v, tb),
                                 torch.zeros(10, dtype=torch.float64),
                                 ttypes.SolverConfig(**kw),
                                 box=(torch.from_numpy(lo), torch.from_numpy(hi)))
    assert (np.asarray(tres.w) <= hi + 1e-15).all() and (np.asarray(tres.w) >= lo - 1e-15).all()
    assert tres.iterations == int(jres.iterations) and tres.reason == int(jres.reason)
    _assert_same_tracker(tres.tracker, jres.tracker)
    _assert_tracks_iterations(tres)


@pytest.mark.parametrize("optimizer,loss", [
    ("lbfgs", "logistic"), ("lbfgs", "poisson"), ("lbfgs", "squared"),
    ("tron", "logistic"), ("tron", "poisson"), ("tron", "squared"),
])
def test_lane_tracker_matches_jax_vmap(optimizer, loss):
    """Lane L-BFGS and lane TRON against ``jax.vmap`` of the scalar solvers:
    lanes that stop at once keep one state, lanes out of budget the most,
    and no finished lane records again."""
    tres, jres = _both_lane_solves(loss, optimizer, 5 if optimizer == "tron" else 10)
    assert tres.tracker.values.shape == (24, 11 if optimizer == "lbfgs" else 6)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    _assert_same_tracker(tres.tracker, jres.tracker)
    _assert_tracks_iterations(tres)
    states = tres.tracker.num_states.numpy()
    assert (states[:4] == 1).all() and states.max() == tres.tracker.values.shape[1]


@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared"])
def test_owlqn_lane_tracker_matches_jax_vmap(loss):
    """The lane OWLQN records the composite value and the pseudo-gradient
    norm."""
    tres, jres = _both_lane_solves(loss, "owlqn", 12, l1=0.3, seed=4)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    _assert_same_tracker(tres.tracker, jres.tracker)
    _assert_tracks_iterations(tres)


@pytest.mark.parametrize("optimizer", ["tron", "owlqn"])
def test_one_lane_tracker_is_the_scalar_solve(optimizer):
    """The fixed effect runs TRON and OWLQN as one lane; its tracker comes
    back in the scalar shape, as the reference's scalar solve's."""
    x, y, off, wt = _glm(500, 20, seed=21, loss="logistic")
    kw = dict(max_iters=25, tolerance=1e-10)
    reg = dict(l2=0.7, l1=2.0 if optimizer == "owlqn" else 0.0)
    jobj = JObjective(loss=jl.logistic_loss, reg=JReg(l2=reg["l2"]))
    jb = j_dense_batch(x, y, off, wt)
    jcfg = jtypes.SolverConfig(**kw)
    if optimizer == "tron":
        jfn = lambda w: jtron.minimize_tron(lambda u: jobj.value_and_grad(u, jb),
                                           lambda u, v: jobj.hvp(u, jb, v), w, jcfg)
    else:
        jfn = lambda w: jlbfgs.minimize_owlqn(lambda u: jobj.value_and_grad(u, jb), w,
                                             reg["l1"], jcfg)
    jres = jax.jit(jfn)(jnp.zeros(20))
    tres = make_solver(TObjective(loss=tl.logistic_loss, reg=TReg(**reg)),
                       OptimizerType(optimizer), ttypes.SolverConfig(**kw))(
        torch.zeros(20, dtype=torch.float64), t_dense_batch(x, y, off, wt))
    assert tres.tracker.values.shape == (26,) and tres.tracker.num_states.dim() == 0
    assert tres.iterations == int(jres.iterations) and tres.reason == int(jres.reason)
    _assert_same_tracker(tres.tracker, jres.tracker)
    _assert_tracks_iterations(tres)


@pytest.mark.parametrize("solver", ["lbfgs", "lbfgs_lanes", "tron_lanes", "owlqn_lanes",
                                    "newton_soa"])
def test_untracked_solves_carry_no_tracker(solver):
    """``track_states=False`` gives a result without a tracker in both
    packages, and the same solve; the SoA Newton solver never tracks, as in
    the reference."""
    if solver == "newton_soa":
        rng = np.random.default_rng(0)
        x_t = torch.from_numpy(rng.normal(size=(8, 3, 5)))
        y_t = torch.from_numpy((rng.random((8, 5)) < 0.5).astype(np.float64))
        zeros, ones = torch.zeros(8, 5, dtype=torch.float64), torch.ones(8, 5, dtype=torch.float64)
        res = solve_newton_soa(tl.logistic_loss, torch.zeros(3, 5, dtype=torch.float64),
                               x_t, y_t, zeros, ones, torch.ones(5, dtype=torch.float64),
                               ttypes.SolverConfig(max_iters=5))
        assert res.tracker is None
        return
    if solver == "lbfgs":
        x, y, off, wt = _glm(200, 8, seed=1, loss="logistic")
        results = []
        for track in (True, False):
            jobj = JObjective(loss=jl.logistic_loss, reg=JReg(l2=0.5))
            jb = j_dense_batch(x, y, off, wt)
            jres = jax.jit(lambda w: jlbfgs.minimize_lbfgs(
                lambda v: jobj.value_and_grad(v, jb), w,
                jtypes.SolverConfig(max_iters=20, track_states=track)))(jnp.zeros(8))
            tres = make_solver(TObjective(loss=tl.logistic_loss, reg=TReg(l2=0.5)),
                               OptimizerType.LBFGS,
                               ttypes.SolverConfig(max_iters=20, track_states=track))(
                torch.zeros(8, dtype=torch.float64), t_dense_batch(x, y, off, wt))
            results.append((tres, jres))
    else:
        optimizer = solver.split("_")[0]
        results = [_both_lane_solves("logistic", optimizer, 6, track=track,
                                     l1=0.3 if optimizer == "owlqn" else 0.0)
                   for track in (True, False)]
    (t_on, j_on), (t_off, j_off) = results
    assert t_on.tracker is not None and j_on.tracker is not None
    assert t_off.tracker is None and j_off.tracker is None
    np.testing.assert_array_equal(np.asarray(t_off.w), np.asarray(t_on.w))


def test_state_tracker_records_masked_lanes_in_place():
    """init pads with nan and counts in int32; record writes slot
    num_states of the active lanes only, host numbers included, and
    returns the tracker itself."""
    tr = ttypes.StateTracker.init(3, torch.float64, lanes=2)
    assert tr.values.shape == (2, 4) and torch.isnan(tr.values).all()
    assert tr.num_states.dtype == torch.int32 and tr.num_states.tolist() == [0, 0]
    assert tr.record(torch.tensor([1.0, 2.0], dtype=torch.float64), 5.0) is tr
    tr.record(torch.tensor([3.0, 4.0], dtype=torch.float64),
              torch.tensor([6.0, 7.0], dtype=torch.float64), torch.tensor([False, True]))
    assert tr.num_states.tolist() == [1, 2]
    np.testing.assert_array_equal(tr.values.numpy(),
                                  [[1.0, np.nan, np.nan, np.nan], [2.0, 4.0, np.nan, np.nan]])
    np.testing.assert_array_equal(tr.grad_norms.numpy(),
                                  [[5.0, np.nan, np.nan, np.nan], [5.0, 7.0, np.nan, np.nan]])
    one = ttypes.StateTracker.init(2, torch.float32).record(np.float32(1.5), 0.25)
    assert one.num_states.dim() == 0 and int(one.num_states) == 1
    assert one.values.dtype == torch.float32 and float(one.values[0]) == 1.5
    lane = tr.lane(1)
    assert lane.values.shape == (4,) and int(lane.num_states) == 2


def test_solver_config_and_result_surface():
    """``track_states`` defaults to True as in the reference;
    ``convergence_reason`` names the reason."""
    assert ttypes.SolverConfig().track_states is jtypes.SolverConfig().track_states is True
    assert ttypes.SolverConfig(track_states=False).track_states is False
    res = ttypes.SolverResult(w=torch.zeros(2), value=0.0, grad_norm=0.0, iterations=3,
                              reason=int(ConvergenceReason.MAX_ITERATIONS))
    assert res.tracker is None
    assert res.convergence_reason() is ConvergenceReason.MAX_ITERATIONS


@pytest.mark.parametrize("masked", [False, True])
def test_summarize_solver_results_matches_jax(masked):
    """The same dict, key for key, over a list of scalar and lane results;
    final values within 1e-8."""
    results = [_both_lane_solves(loss, "lbfgs", 8, seed=s)
               for loss, s in (("logistic", 2), ("poisson", 3))]
    results.append(_both_lane_solves("logistic", "tron", 4, seed=5))
    x, y, off, wt = _glm(300, 12, seed=9, loss="squared")
    kw = dict(max_iters=20)
    jobj = JObjective(loss=jl.squared_loss, reg=JReg(l2=0.5))
    jb = j_dense_batch(x, y, off, wt)
    jscalar = jax.jit(lambda w: jlbfgs.minimize_lbfgs(
        lambda v: jobj.value_and_grad(v, jb), w, jtypes.SolverConfig(**kw)))(jnp.zeros(12))
    tscalar = make_solver(TObjective(loss=tl.squared_loss, reg=TReg(l2=0.5)),
                          OptimizerType.LBFGS, ttypes.SolverConfig(**kw))(
        torch.zeros(12, dtype=torch.float64), t_dense_batch(x, y, off, wt))
    results.append((tscalar, jscalar))
    masks = None
    if masked:
        rng = np.random.default_rng(1)
        masks = [rng.random(24) < 0.7 for _ in range(3)] + [None]
    t = ttypes.summarize_solver_results([r[0] for r in results], valid_masks=masks)
    j = jtypes.summarize_solver_results([r[1] for r in results], valid_masks=masks)
    tv, jv = t.pop("final_value"), j.pop("final_value")
    assert t == j and t["count"] == (3 * 24 + 1 if not masked else sum(m.sum() for m in masks[:3]) + 1)
    assert set(tv) == set(jv) and all(abs(tv[k] - jv[k]) <= VALUE_RTOL * abs(jv[k]) for k in jv)
    assert ttypes.summarize_solver_results([]) == jtypes.summarize_solver_results([]) == {"count": 0}
    one_t, one_j = (ttypes.summarize_solver_results(tscalar),
                    jtypes.summarize_solver_results(jscalar))
    assert one_t.pop("final_value")["mean"] == pytest.approx(one_j.pop("final_value")["mean"],
                                                            rel=VALUE_RTOL)
    assert one_t == one_j


# -- the coordinates' summaries and the descent's log ---------------------------------


def _game_parts(path, seed=2024):
    """(JAX data, port data, JAX fixed / random configs, port fixed /
    random configs) of a small GLMix: ``path`` "soa" (4 per-user features:
    SoA Newton), "lanes" (20 per-user features: lane L-BFGS) or "sparse"
    (sparse shards: compact lanes)."""
    rng = np.random.default_rng(seed)
    users = 30
    counts = rng.integers(2, 50, size=users)
    uids = rng.permutation(np.repeat(np.arange(users) * 5 + 2, counts))
    n = len(uids)
    y = (rng.random(n) < 0.5).astype(np.float64)
    off, wt = rng.normal(size=n) * 0.05, rng.random(n) + 0.5
    if path == "sparse":
        k = 6
        gi, ui = (rng.integers(0, dim, size=(n, k)).astype(np.int32) for dim in (200, 60))
        gv, uv = rng.normal(size=(n, k)) * 0.3, rng.normal(size=(n, k))
        jf = {"g": JShard(indices=gi, values=gv, dim=200),
              "u": JShard(indices=ui, values=uv, dim=60)}
        tf = {"g": SparseShard(indices=gi, values=gv, dim=200),
              "u": SparseShard(indices=ui, values=uv, dim=60)}
    else:
        xg = rng.normal(size=(n, 16)) * 0.3
        xu = rng.normal(size=(n, 4 if path == "soa" else 20))
        jf = tf = {"g": xg, "u": xu}
    common = dict(y=y, offset=off, weight=wt, id_tags={"userId": uids})
    s = dict(max_iters=20, tolerance=1e-9)
    jfix = JFixed(feature_shard="g", solver=jtypes.SolverConfig(**s), reg=JReg(l2=1.0))
    jran = JRandom(random_effect_type="userId", feature_shard="u",
                   solver=jtypes.SolverConfig(**s), reg=JReg(l2=1.0), active_cap=32)
    tfix = FixedEffectConfig(feature_shard="g", solver=ttypes.SolverConfig(**s),
                             reg=TReg(l2=1.0))
    tran = RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                              solver=ttypes.SolverConfig(**s), reg=TReg(l2=1.0),
                              active_cap=32)
    return (JData(features=jf, **common), GameData(features=tf, **common),
            (jfix, jran), (tfix, tran))


def _assert_same_summary(t, j):
    t, j = dict(t), dict(j)
    tv, jv = t.pop("final_value"), j.pop("final_value")
    assert t == j
    assert all(abs(tv[k] - jv[k]) <= VALUE_RTOL * abs(jv[k]) for k in jv)


@pytest.mark.parametrize("path", ["soa", "lanes", "sparse"])
def test_coordinate_tracker_summaries_match_jax(path):
    """Both coordinates' ``tracker_summary`` of one update each, on the same
    offsets: the random effect's counts its valid lanes only."""
    jdata, tdata, jcfgs, tcfgs = _game_parts(path)
    task = TaskType.LOGISTIC_REGRESSION
    off = np.asarray(jdata.offset)
    for cid, jc_cfg, tc_cfg in zip(("fixed", "per-user"), jcfgs, tcfgs):
        jc = jcoord.build_coordinate(cid, jdata, jc_cfg, JTask.LOGISTIC_REGRESSION,
                                     dtype=np.float64)
        tc = build_coordinate(cid, tdata, tc_cfg, task, dtype=torch.float64, device="cpu")
        _, jres = jc.update(off)
        _, tres = tc.update(torch.from_numpy(off))
        ts, js = tc.tracker_summary(tres), jc.tracker_summary(jres)
        _assert_same_summary(ts, js)
        if cid == "per-user":
            assert ts["count"] == len(tc.buckets.lane_of)
            assert tc.use_soa == (path == "soa")
        else:
            assert ts["count"] == 1


def _small_fit_config(num_iters=1):
    s = ttypes.SolverConfig(max_iters=10, tolerance=1e-7)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(feature_shard="g", solver=s,
                                                     reg=TReg(l2=1.0)),
                          "per-user": RandomEffectConfig(random_effect_type="userId",
                                                         feature_shard="u", solver=s,
                                                         reg=TReg(l2=1.0))})


def test_descent_logs_the_tracker_summary_at_debug(caplog):
    """At DEBUG every update logs its coordinate's ``tracker_summary``."""
    _, tdata, _, _ = _game_parts("lanes")
    caplog.set_level(logging.DEBUG, logger=tdescent.logger.name)
    GameEstimator(device="cpu", dtype=torch.float64, fused=False).fit(
        tdata, [_small_fit_config(2)])
    logged = [r.args for r in caplog.records if r.msg == "coord %s solvers: %s"]
    assert [cid for cid, _ in logged] == ["fixed", "per-user"] * 2
    fixed, user = logged[0][1], logged[1][1]
    assert fixed["count"] == 1 and user["count"] == 30
    assert set(user) == {"count", "convergence_reasons", "iterations", "final_value"}


def test_descent_builds_no_summary_above_debug_and_survives_a_failing_one(caplog,
                                                                           monkeypatch):
    """Above DEBUG no summary is built (no extra host read); at DEBUG a
    summary that raises is logged as unavailable and the fit goes on."""
    _, tdata, _, _ = _game_parts("soa")
    calls = []

    def boom(self, results):
        calls.append(self.coordinate_id)
        raise RuntimeError("telemetry fault")

    monkeypatch.setattr(tcoord.FixedEffectCoordinate, "tracker_summary", boom)
    monkeypatch.setattr(tcoord.RandomEffectCoordinate, "tracker_summary", boom)
    caplog.set_level(logging.INFO, logger=tdescent.logger.name)
    quiet = GameEstimator(device="cpu", dtype=torch.float64, fused=False).fit(
        tdata, [_small_fit_config()])[0].model
    assert calls == []
    caplog.set_level(logging.DEBUG, logger=tdescent.logger.name)
    loud = GameEstimator(device="cpu", dtype=torch.float64, fused=False).fit(
        tdata, [_small_fit_config()])[0].model
    assert calls == ["fixed", "per-user"]
    assert sum("tracker summary unavailable" in r.getMessage() for r in caplog.records) == 2
    np.testing.assert_array_equal(loud["per-user"].w_stack, quiet["per-user"].w_stack)


def test_reg_path_returns_trackers_as_the_reference():
    """``train_glm_reg_path``'s per-weight results carry their trackers."""
    x, y, off, wt = _glm(300, 10, seed=12, loss="logistic")
    weights = [10.0, 1.0, 0.1]
    solver = dict(max_iters=25, tolerance=1e-9)
    _, jtr = j_train_glm_reg_path(x, y, JTask.LOGISTIC_REGRESSION, weights, offset=off,
                                  weight=wt, solver=jtypes.SolverConfig(**solver),
                                  dtype=np.float64)
    _, ttr = train_glm_reg_path(x, y, TaskType.LOGISTIC_REGRESSION, weights, offset=off,
                                weight=wt, solver=ttypes.SolverConfig(**solver),
                                dtype=torch.float64, device="cpu")
    assert sorted(ttr) == sorted(jtr)
    for lam in weights:
        assert ttr[lam].iterations == int(jtr[lam].iterations)
        _assert_same_tracker(ttr[lam].tracker, jtr[lam].tracker)


# -- the other public names ---------------------------------------------------------


def _objective_inputs(kind, seed=6):
    rng = np.random.default_rng(seed)
    n, d = 80, 7
    y = (rng.random(n) < 0.5).astype(np.float64)
    off, wt = rng.normal(size=n) * 0.1, rng.random(n) + 0.5
    wt[::9] = 0.0
    w = rng.normal(size=d) * 0.4
    norm = dict(factors=rng.random(d) + 0.5, shifts=rng.normal(size=d) * 0.1)
    if kind == "sparse":
        idx = rng.integers(0, d, size=(n, 3)).astype(np.int32)
        vals = rng.normal(size=(n, 3))
        jb = JSparseBatch(indices=jnp.asarray(idx), values=jnp.asarray(vals),
                          y=jnp.asarray(y), offset=jnp.asarray(off), weight=jnp.asarray(wt),
                          dim=d)
        tb = TSparseBatch(indices=torch.from_numpy(idx).long(), values=torch.from_numpy(vals),
                          y=torch.from_numpy(y), offset=torch.from_numpy(off),
                          weight=torch.from_numpy(wt), dim=d)
    else:
        x = rng.normal(size=(n, d))
        jb, tb = j_dense_batch(x, y, off, wt), t_dense_batch(x, y, off, wt)
    return w, norm, jb, tb


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_objective_methods_match_jax(kind, loss):
    """value, gradient, raw_value, l1_term, scores and means under a
    normalization context with shifts."""
    w, norm, jb, tb = _objective_inputs(kind)
    reg = dict(l2=0.3, l1=0.2)
    jobj = JObjective(loss=jl.loss_by_name(loss), reg=JReg(**reg),
                      norm=JNorm(**{k: jnp.asarray(v) for k, v in norm.items()}))
    tobj = TObjective(loss=tl.loss_by_name(loss), reg=TReg(**reg),
                      norm=TNorm(**{k: torch.from_numpy(v) for k, v in norm.items()}))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for name in ("value", "gradient", "raw_value", "scores", "means"):
        t, j = getattr(tobj, name)(tw, tb), getattr(jobj, name)(jw, jb)
        assert _rel(t, j) <= F64_RTOL, name
    assert _rel(tobj.l1_term(tw), jobj.l1_term(jw)) <= F64_RTOL
    assert _rel(tobj.value(tw, tb), tobj.value_and_grad(tw, tb)[0]) <= F64_RTOL


@pytest.mark.parametrize("kind", ["dense", "sparse", "dense_bf16"])
def test_rescale_weights_matches_jax(kind):
    """Weights times a per-row scale; the design keeps its (storage) width."""
    w, _, jb, tb = _objective_inputs("sparse" if kind == "sparse" else "dense")
    if kind == "dense_bf16":
        x16 = narrow(torch.from_numpy(np.array(jb.x)), torch.bfloat16)
        tb = tb.replace(x=x16)
        jb = jb.replace(x=jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16))
    scale = np.random.default_rng(2).random(tb.weight.shape[0]) + 0.25
    tr, jr = tb.rescale_weights(torch.from_numpy(scale)), jb.rescale_weights(jnp.asarray(scale))
    assert _rel(tr.weight, jr.weight) <= F64_RTOL
    assert isinstance(tr, type(tb)) and tr.weight.dtype == torch.float64
    if kind == "sparse":
        assert tr.values is tb.values
    else:
        assert tr.x is tb.x and tr.x.dtype == (torch.bfloat16 if kind == "dense_bf16"
                                             else torch.float64)
    obj = TObjective(loss=tl.logistic_loss)
    jobj = JObjective(loss=jl.logistic_loss)
    assert _rel(obj.value(torch.from_numpy(w), tr), jobj.value(jnp.asarray(w), jr)) <= F64_RTOL


def test_glm_model_names_match_jax():
    """``Coefficients.zeros`` and ``GLMModel.predict`` for every task."""
    tz, jz = tglm.Coefficients.zeros(5), jglm.Coefficients.zeros(5)
    assert tz.means.dtype == jz.means.dtype and (tz.means == jz.means).all()
    assert tz.variances is None and tglm.Coefficients.zeros(3, np.float64).means.dtype == np.float64
    rng = np.random.default_rng(8)
    x, means, off = rng.normal(size=(20, 5)), rng.normal(size=5) * 0.5, rng.normal(size=20)
    for task in TaskType:
        if task == TaskType.NONE:
            continue
        tm = tglm.GLMModel(coefficients=tglm.Coefficients(means=means), task=task)
        jm = jglm.GLMModel(coefficients=jglm.Coefficients(means=means), task=JTask(task.value))
        assert _rel(tm.predict(torch.from_numpy(x)), jm.predict(jnp.asarray(x))) <= F64_RTOL
        assert _rel(tm.predict(torch.from_numpy(x), torch.from_numpy(off)),
                    jm.predict(jnp.asarray(x), jnp.asarray(off))) <= F64_RTOL


def test_game_model_names_match_jax():
    """``FixedEffectModel.glm``, ``RandomEffectModel.coefficients_for``
    (dense and compact) and ``GameModel.updated``."""
    rng = np.random.default_rng(3)
    means = rng.normal(size=6)
    tfe = tgame.FixedEffectModel(coefficients=tglm.Coefficients(means=means),
                                 feature_shard="g", task=TaskType.POISSON_REGRESSION)
    jfe = jgame.FixedEffectModel(coefficients=jglm.Coefficients(means=means),
                                 feature_shard="g", task=JTask.POISSON_REGRESSION)
    tg, jg = tfe.glm(), jfe.glm()
    assert isinstance(tg, tglm.GLMModel) and tg.task.value == jg.task.value
    assert tg.coefficients is tfe.coefficients
    w = rng.normal(size=(5, 9)) * (rng.random((5, 9)) < 0.4)
    var = rng.random((5, 9))
    slot_of = {11: 3, 4: 0, 7: 1, 20: 2, 9: 4}
    kw = dict(slot_of=slot_of, random_effect_type="userId", feature_shard="u")
    tre = tgame.RandomEffectModel(w_stack=w, variances=var, **kw)
    jre = jgame.RandomEffectModel(w_stack=w, variances=var, **kw)
    tcompact = tgame.RandomEffectModel(w_stack=w, **kw).to_compact()
    for eid in (11, 4, 7, 20, 9, 99):
        t, j, c = (tre.coefficients_for(eid), jre.coefficients_for(eid),
                   tcompact.coefficients_for(eid))
        if j is None:
            assert t is None and c is None
            continue
        np.testing.assert_array_equal(t.means, j.means)
        np.testing.assert_array_equal(t.variances, j.variances)
        np.testing.assert_array_equal(c.means, j.means)
        assert c.variances is None and c.means.dtype == w.dtype
    tmodel = tgame.GameModel(models={"fixed": tfe})
    updated = tmodel.updated("per-user", tre)
    jupdated = jgame.GameModel(models={"fixed": jfe}).updated("per-user", jre)
    assert list(updated.models) == list(jupdated.models) == ["fixed", "per-user"]
    assert list(tmodel.models) == ["fixed"] and updated["per-user"] is tre
    replaced = updated.updated("fixed", tfe)
    assert replaced["fixed"] is tfe and replaced is not updated


def test_score_sparse_compact_matches_jax_float32():
    """Through ``match_dot_plain`` on the CPU, against the reference's
    wrapper running its Pallas kernel in interpret mode, float32, within
    1e-6 relative to the largest score; slot -1 scores 0 and no kernel is
    launched."""
    rng = np.random.default_rng(14)
    num_e, dim, k_model, n, k_feat = 17, 60, 12, 250, 9
    w_idx = np.full((num_e, k_model), dim, np.int32)
    w_val = np.zeros((num_e, k_model), np.float32)
    for e in range(num_e):
        m = int(rng.integers(0, k_model + 1))
        w_idx[e, :m] = np.sort(rng.choice(dim, size=m, replace=False))
        w_val[e, :m] = rng.normal(size=m)
    slots = rng.integers(-1, num_e, size=n).astype(np.int32)
    f_idx = np.where(rng.random((n, k_feat)) < 0.6,
                     w_idx[np.maximum(slots, 0)][np.arange(n)[:, None],
                                                 rng.integers(0, k_model, size=(n, k_feat))],
                     rng.integers(0, dim, size=(n, k_feat))).clip(0, dim - 1).astype(np.int32)
    f_val = rng.normal(size=(n, k_feat)).astype(np.float32)
    args = (w_idx, w_val, slots, f_idx, f_val)
    j = np.asarray(jcs.score_sparse_compact(*[jnp.asarray(a) for a in args], interpret=True))
    before = tcs.match_dot.launches
    t = tcs.score_sparse_compact(*[torch.from_numpy(a) for a in args])
    assert tcs.match_dot.launches == before
    assert t.dtype == torch.float32 and t.shape == (n,)
    assert np.abs(t.numpy() - j).max() <= COMPACT_F32_TOL * np.abs(j).max()
    assert (t.numpy()[slots < 0] == 0).all() and (slots < 0).any()


@pytest.mark.parametrize("jitter", [0.0, 0.5])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_psd_matches_jax(jitter, rhs):
    rng = np.random.default_rng(10)
    m = rng.normal(size=(6, 6))
    a = m @ m.T + 0.1 * np.eye(6)
    b = rng.normal(size=6 if rhs == "vector" else (6, 3))
    t = tlinalg.solve_psd(torch.from_numpy(a), torch.from_numpy(b), jitter=jitter)
    j = jlinalg.solve_psd(jnp.asarray(a), jnp.asarray(b), jitter=jitter)
    assert t.shape == b.shape and _rel(t, j) <= 1e-10
    assert _rel((torch.from_numpy(a) + jitter * torch.eye(6, dtype=torch.float64)) @ t, b) <= 1e-10


@pytest.mark.parametrize("name,kw", [
    ("generate_binary_classification", dict(n=50, d=6, seed=3)),
    ("generate_binary_classification", dict(n=20, d=4, seed=1, intercept=False,
                                            dtype=np.float64)),
    ("generate_poisson", dict(n=40, d=5, seed=2)),
    ("generate_linear", dict(n=30, d=3, noise=0.5, seed=4, dtype=np.float64)),
])
def test_array_generators_match_jax_bitwise(name, kw):
    for t, j in zip(getattr(tsynth, name)(**kw), getattr(jsynth, name)(**kw)):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kw", [dict(n_users=6, per_user=10, d_global=5, d_user=3, seed=9),
                                dict(n_users=5, per_user=8, n_items=4, d_item=2, seed=2,
                                     dtype=np.float64)])
def test_generate_glmix_matches_jax_bitwise(kw):
    (td, tt), (jd, jt) = tsynth.generate_glmix(**kw), jsynth.generate_glmix(**kw)
    assert isinstance(td, GameData)
    for a, b in ((td.y, jd.y), (td.offset, jd.offset), (td.weight, jd.weight)):
        np.testing.assert_array_equal(a, b)
    assert sorted(td.features) == sorted(jd.features) and sorted(td.id_tags) == sorted(jd.id_tags)
    for k in td.features:
        np.testing.assert_array_equal(td.features[k], jd.features[k])
    for k in td.id_tags:
        np.testing.assert_array_equal(td.id_tags[k], jd.id_tags[k])
    assert sorted(tt) == sorted(jt) and all((tt[k] == jt[k]).all() for k in tt)


# -- bf16 storage: the fixed effect's iterations in both packages -------------------

# synth_glmix_chip scales: 256, 1,024 and 2,048 users x 16 rows, 512 fixed features
BF16_SCALES = (4096, 1024, 512)


def _bf16_chip_inputs(storage, scale=BF16_SCALES[0]):
    """Both packages' data and configs for glmix_chip at ``scale`` with
    ``storage`` on both coordinates; the design is drawn at bf16, so both
    storage widths hold the same values."""
    host = tsynth.synth_glmix_chip(scale)
    xg = tsynth.chip_design(host["n"], "cpu", dtype=torch.bfloat16).float().numpy()
    common = dict(y=host["y"], id_tags={"userId": host["uids"]})
    feats = {"g": xg, "u": host["xu"]}
    s = dict(max_iters=30, tolerance=1e-7)
    jcfg = JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": JFixed(feature_shard="g", solver=jtypes.SolverConfig(**s),
                        reg=JReg(l2=1.0), storage_dtype=storage),
        "per-user": JRandom(random_effect_type="userId", feature_shard="u",
                            solver=jtypes.SolverConfig(**s), reg=JReg(l2=1.0),
                            active_cap=32, storage_dtype=storage)})
    tcfg = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                      coordinates={
        "fixed": FixedEffectConfig(feature_shard="g", solver=ttypes.SolverConfig(**s),
                                   reg=TReg(l2=1.0), storage_dtype=storage),
        "per-user": RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                                       solver=ttypes.SolverConfig(**s), reg=TReg(l2=1.0),
                                       active_cap=32, storage_dtype=storage)})
    return JData(features=feats, **common), GameData(features=feats, **common), jcfg, tcfg


def _fixed_results(storage, compute, scale=BF16_SCALES[0]):
    """Each package's fixed-effect SolverResults of a two-sweep fit, and
    each package's objective evaluations per update (the JAX side's
    counted at run time by a debug callback inside its jitted solver)."""
    jdata, tdata, jcfg, tcfg = _bf16_chip_inputs(storage, scale)
    kept = {"jax": [], "port": []}
    evals, jevals = [], []

    def keep(update, side):
        def wrapped(self, *args, **kwargs):
            model, res = update(self, *args, **kwargs)
            kept[side].append(res)
            return model, res
        return wrapped

    real_vg = TObjective.value_and_grad

    def counted_vg(self, w, batch):
        evals[-1] += 1
        return real_vg(self, w, batch)

    def port_update(self, *args, **kwargs):
        evals.append(0)
        return real_port(self, *args, **kwargs)

    real_jvg = JObjective.value_and_grad

    def counted_jvg(self, w, batch):
        jax.debug.callback(lambda: jevals.__setitem__(-1, jevals[-1] + 1))
        return real_jvg(self, w, batch)

    def jax_update(self, *args, **kwargs):
        jevals.append(0)
        return real_jax(self, *args, **kwargs)

    real_port = tcoord.FixedEffectCoordinate.update
    real_jax = jcoord.FixedEffectCoordinate.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcoord.FixedEffectCoordinate, "update", keep(jax_update, "jax"))
        mp.setattr(tcoord.FixedEffectCoordinate, "update", keep(port_update, "port"))
        mp.setattr(TObjective, "value_and_grad", counted_vg)
        mp.setattr(JObjective, "value_and_grad", counted_jvg)
        JEstimator(fused=False, dtype=compute).fit(jdata, [jcfg])
        GameEstimator(device="cpu", dtype=torch.float32 if compute == np.float32
                      else torch.float64, fused=False).fit(tdata, [tcfg])
    return kept["jax"], kept["port"], evals, jevals


def test_bf16_fixed_effect_tracker_matches_jax_float64():
    """Under bf16 storage and float64 compute the fixed effect's L-BFGS
    takes the reference's iterations, stops for its reason and records its
    values within 1e-8, update by update."""
    jres, tres, evals, jevals = _fixed_results("bfloat16", np.float64)
    assert evals == jevals
    assert len(jres) == len(tres) == 2
    for t, j in zip(tres, jres):
        assert t.iterations == int(j.iterations) and t.reason == int(j.reason)
        _assert_same_tracker(t.tracker, j.tracker)


def bf16_iteration_table(scale) -> dict:
    """{storage: {"jax": [iterations per update], "port": [...], "jax
    evaluations": [...], "port evaluations": [...]}} for float32 compute at
    ``scale``."""
    table = {}
    for storage in (None, "bfloat16"):
        jres, tres, evals, jevals = _fixed_results(storage, np.float32, scale)
        table[storage or "float32"] = {"jax": [int(r.iterations) for r in jres],
                                       "port": [int(r.iterations) for r in tres],
                                       "jax evaluations": jevals,
                                       "port evaluations": evals}
    return table


@pytest.mark.parametrize("scale", BF16_SCALES)
def test_bf16_fixed_effect_iterations_float32(scale):
    """The float32-compute counts that PERF.md records: each package's
    fixed effect runs both updates within the budget and evaluates the
    objective at least once per iteration and once at the start; at
    float32 storage the two packages take the same iterations and
    evaluations."""
    table = bf16_iteration_table(scale)
    for storage, row in table.items():
        print(f"glmix_chip at scale {scale}, float32 compute, {storage} storage: {row}")
    for row in table.values():
        assert len(row["jax"]) == len(row["port"]) == 2
        assert all(1 <= it <= 30 for it in row["jax"] + row["port"])
        for side in ("jax", "port"):
            assert all(e >= it + 1 for e, it in zip(row[f"{side} evaluations"], row[side]))
    f32 = table["float32"]
    assert f32["jax"] == f32["port"] and f32["jax evaluations"] == f32["port evaluations"]

