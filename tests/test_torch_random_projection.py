"""The port's RANDOM projector against the JAX package, on the CPU.

Covers ``build_random_projection`` (bitwise, with and without the intercept
pass-through, float32 and float64), ``RandomProjection.project_normalization``
and the RANDOM branch of ``project_buckets`` on dense buckets (rtol 1e-12 in
float64: the same products, summed in another order), the reference's
ValueErrors, the RANDOM random-effect coordinate (dense and sparse shards;
no context, a factors context, and a factors-and-shifts context with the
intercept pass-through; inside and outside the SoA gate, under L-BFGS and
TRON; a warm start; ``rebind``) against ``RandomEffectCoordinate.update``
within FIT_RTOL, a sparse RANDOM fit against its densified twin, and
``GameEstimator()`` bitwise equal to ``fused=False``, without and with a
validation suite.

Fits run in float64 on numpy inputs drawn from a seed.  FIT_RTOL is
tests/test_torch_game.py's: both sides take the same solver steps and land
~1e-13 apart, the margin covers a solver that stops one iteration apart at
its tolerance.  The port restarts every RANDOM update cold, in its host loop
and its fused sweep alike; the reference's fused sweep starts from the
previous update's projected lanes and agrees with its own host loop only to
JAX_FUSED_TOL (tests/test_game.py::test_fused_sweep_projected_space_matches_host),
the bound the port's fused fit is held to against it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.coordinate import build_coordinate as j_build_coordinate
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.parallel import bucketing as jbucketing
from photon_ml_tpu.parallel import projection as jprojection
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.core.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.parallel import bucketing as tbucketing
from photon_ml_tpu_torch.parallel import projection as tprojection
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

FIT_RTOL = 1e-6
JAX_FUSED_TOL = 2e-3
SOLVER = dict(max_iters=100, tolerance=1e-12)
DIM, II = 10, 0  # the dense per-user shard's width and intercept column
SPARSE_DIM, SPARSE_II = 40, 39  # the sparse shard's vocabulary and intercept id
SEED = 3  # the coordinates' seed: the Gaussian matrix's stream


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def data():
    """14 users with 5..16 rows (two buckets, of capacities 8 and 16: few
    shapes for the reference to compile); a fixed design "g" (column 0 an
    intercept), a dense per-user design "u" (DIM columns, column II the
    intercept) and a sparse one "s" (SPARSE_DIM columns, 4 a row, the first
    the intercept id SPARSE_II at value 1); its densified twin "sd"."""
    rng = np.random.default_rng(21)
    users = 14
    uids = rng.permutation(np.repeat(np.arange(users) * 5 + 2, rng.integers(5, 17, users)))
    n = len(uids)
    xg = rng.normal(size=(n, 4))
    xg[:, 0] = 1.0
    xu = rng.normal(size=(n, DIM)) * rng.uniform(0.5, 3.0, DIM) + rng.normal(size=DIM)
    xu[:, II] = 1.0
    idx = rng.integers(0, SPARSE_DIM - 1, size=(n, 4))
    idx[:, 0] = SPARSE_II
    vals = rng.normal(size=(n, 4)) * 2.0 + 0.5
    vals[:, 0] = 1.0
    dense = np.zeros((n, SPARSE_DIM))
    np.add.at(dense, (np.repeat(np.arange(n), 4), idx.reshape(-1)), vals.reshape(-1))
    z = xg[:, 1:] @ rng.normal(size=3) + 0.3 * np.einsum(
        "nd,nd->n", xu, rng.normal(size=(users * 5 + 2, DIM))[uids])
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(y=y, offset=rng.normal(size=n) * 0.05, weight=rng.random(n) + 0.5,
                uids=uids, xg=xg, xu=xu, idx=idx, vals=vals, dense=dense)


def _game_data(d, jax: bool):
    shard = (JShard if jax else SparseShard)(indices=d["idx"], values=d["vals"],
                                             dim=SPARSE_DIM)
    return (JData if jax else GameData)(
        y=d["y"], offset=d["offset"], weight=d["weight"],
        features={"g": d["xg"], "u": d["xu"], "s": shard, "sd": d["dense"]},
        id_tags={"userId": d["uids"]})


def _contexts(d, shard: str, kind: str):
    """(JAX, port) contexts of a per-user shard: None, factors only, or
    factors and shifts (the intercept keeps factor 1 and shift 0)."""
    if kind == "none":
        return None, None
    x = d["xu"] if shard == "u" else d["dense"]
    ii = II if shard == "u" else SPARSE_II
    f = 1.0 / np.maximum(x.std(axis=0), 1e-3)
    f[ii] = 1.0
    s = None
    if kind == "shifts":
        s = x.mean(axis=0)
        s[ii] = 0.0
    return (JNorm(factors=f, shifts=s),
            TNorm(factors=torch.from_numpy(f), shifts=None if s is None
                  else torch.from_numpy(s)))


# case -> (per-user shard, projected_dim, optimizer, context, intercept_index, SoA)
CASES = {
    "dense_soa_lbfgs": ("u", 4, "LBFGS", "none", None, True),
    "dense_soa_tron": ("u", 4, "TRON", "none", None, True),
    "dense_lanes_lbfgs": ("u", 14, "LBFGS", "none", None, False),
    "dense_lanes_tron": ("u", 14, "TRON", "none", None, False),
    "dense_factors": ("u", 5, "LBFGS", "factors", None, False),
    "dense_shifts": ("u", 5, "TRON", "shifts", II, False),
    "sparse_soa": ("s", 4, "LBFGS", "none", SPARSE_II, True),
    "sparse_lanes": ("s", 14, "LBFGS", "none", None, False),
    "sparse_factors": ("s", 6, "TRON", "factors", None, False),
    "sparse_shifts": ("s", 6, "LBFGS", "shifts", SPARSE_II, False),
}


def _re_config(jax: bool, shard: str, k: int, opt: str, ii, l2: float = 1.0):
    return (JRandom if jax else RandomEffectConfig)(
        random_effect_type="userId", feature_shard=shard,
        optimizer=(JOpt if jax else OptimizerType)[opt],
        solver=(JSolver if jax else SolverConfig)(**SOLVER),
        reg=(JReg if jax else TReg)(l2=l2), projector=(JProj if jax else ProjectorType).RANDOM,
        projected_dim=k, intercept_index=ii)


def _re_pair(d, case: str, l2: float = 1.0, jax: bool = True):
    """(JAX, port) coordinates of a case; the port's alone without ``jax``."""
    shard, k, opt, ctx, ii, _ = CASES[case]
    jnorm, tnorm = _contexts(d, shard, ctx)
    tc = build_coordinate("u", _game_data(d, False), _re_config(False, shard, k, opt, ii, l2),
                          TaskType.LOGISTIC_REGRESSION, seed=SEED, dtype=torch.float64,
                          device="cpu", norm=tnorm)
    if not jax:
        return tc
    jc = j_build_coordinate("u", _game_data(d, True), _re_config(True, shard, k, opt, ii, l2),
                            JTask.LOGISTIC_REGRESSION, seed=SEED, dtype=np.float64,
                            norm=jnorm)
    return jc, tc


# -- the projection ---------------------------------------------------------------

@pytest.mark.parametrize("intercept", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_build_random_projection_is_the_references(dtype, intercept):
    """The same seed draws bitwise the reference's matrix, pass-through
    column and zeroed intercept row included."""
    j = jprojection.build_random_projection(17, 5, seed=11, dtype=np.dtype(dtype),
                                            intercept_index=intercept)
    t = tprojection.build_random_projection(17, 5, seed=11, dtype=getattr(torch, dtype),
                                            intercept_index=intercept)
    assert t.matrix.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(t.matrix.numpy(), j.matrix)
    assert (t.d_full, t.d_proj, t.projected_intercept) == (j.d_full, j.d_proj,
                                                           j.projected_intercept)


@pytest.mark.parametrize("shifts", [False, True])
def test_projected_normalization_and_dense_buckets(data, shifts):
    """``project_normalization`` and RANDOM ``project_buckets`` on dense
    buckets (designs, the shared matrix, the back-projection) within 1e-12
    of the reference in float64."""
    x, uids, y = data["xu"], data["uids"], data["y"]
    jb = jbucketing.bucket_by_entity(uids, x, y, active_cap=16, dtype=np.float64)
    tb = tbucketing.bucket_by_entity(uids, x, y, active_cap=16, dtype=np.float64)
    jp = jprojection.project_buckets(jb, JProj.RANDOM, projected_dim=6, intercept_index=II,
                                     seed=SEED)
    tp = tprojection.project_buckets(tb, ProjectorType.RANDOM, projected_dim=6,
                                     intercept_index=II, seed=SEED)
    assert len({id(p) for p in tp.projections}) == 1  # one shared matrix
    for j, t, jpp, tpp in zip(jp.buckets, tp.buckets, jp.projections, tp.projections):
        assert t.x.shape == j.x.shape and t.x.shape[2] == 7
        assert _rel(t.x.numpy(), j.x) <= 1e-12
        np.testing.assert_array_equal(tpp.matrix.numpy(), jpp.matrix)
        w = np.random.default_rng(4).normal(size=(t.num_lanes, 7))
        assert _rel(tpp.back_project(torch.from_numpy(w)).numpy(), jpp.back_project(w)) <= 1e-12
    jnorm, tnorm = _contexts(data, "u", "shifts" if shifts else "factors")
    jctx, jii = jp.projections[0].project_normalization(jnorm)
    tctx, tii = tp.projections[0].project_normalization(tnorm)
    assert tii == jii == 6
    assert _rel(tctx.factors.numpy(), jctx.factors) <= 1e-12
    assert (tctx.shifts is None) == (not shifts)
    if shifts:
        assert _rel(tctx.shifts.numpy(), jctx.shifts) <= 1e-12
        assert float(tctx.shifts[tii]) == 0.0 and float(tctx.factors[tii]) == 1.0


def test_random_projection_value_errors(data):
    """The reference's ValueErrors: projected_dim under another projector
    (at config time), the |Pearson| ratio under RANDOM, RANDOM without
    projected_dim, variances or a box under RANDOM, and a shift context under
    RANDOM without intercept_index."""
    with pytest.raises(ValueError, match="projected_dim applies only"):
        RandomEffectConfig("userId", "u", projector=ProjectorType.INDEX_MAP, projected_dim=3)
    with pytest.raises(ValueError, match="projected_dim applies only"):
        RandomEffectConfig("userId", "u", projected_dim=3)
    tb = tbucketing.bucket_by_entity(data["uids"], data["xu"], data["y"], dtype=np.float64)
    for kw, match in ((dict(projected_dim=3, features_to_samples_ratio=0.5), "ratio"),
                      (dict(), "requires projected_dim")):
        with pytest.raises(ValueError, match=match):
            tprojection.project_buckets(tb, ProjectorType.RANDOM, **kw)
    with pytest.raises(ValueError, match="projected_dim applies only"):
        tprojection.project_buckets(tb, ProjectorType.INDEX_MAP, projected_dim=3)
    gd, task = _game_data(data, False), TaskType.LOGISTIC_REGRESSION

    def build(shard="u", norm=None, **kw):
        return build_coordinate("c", gd, RandomEffectConfig(
            "userId", shard, projector=ProjectorType.RANDOM, **kw), task, device="cpu",
            norm=norm)

    for shard in ("u", "s"):
        with pytest.raises(ValueError, match="requires projected_dim"):
            build(shard)
        with pytest.raises(ValueError, match="ratio"):
            build(shard, projected_dim=3, features_to_samples_ratio=0.5)
        with pytest.raises(ValueError, match="variances"):
            build(shard, projected_dim=3, variance=VarianceComputationType.SIMPLE)
        with pytest.raises(ValueError, match="box constraints"):
            build(shard, projected_dim=3, constraints=((1, -1.0, 1.0),))
        with pytest.raises(ValueError, match="needs intercept_index"):
            build(shard, norm=_contexts(data, shard, "shifts")[1], projected_dim=3)


# -- the coordinate -----------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_random_update_matches_jax(data, case):
    """A RANDOM update from zeros and one warm-started from its own model (a
    cold restart on both sides) within FIT_RTOL of the reference's
    ``RandomEffectCoordinate.update``, the scores too; the SoA gate decided
    alike on the projected shapes."""
    jc, tc = _re_pair(data, case)
    assert tc.use_soa == jc._use_soa == CASES[case][5]
    off = np.random.default_rng(5).normal(size=len(data["y"])) * 0.2
    jm, _ = jc.update(off)
    tm, _ = tc.update(torch.from_numpy(off))
    assert tm.slot_of == jm.slot_of
    dim = DIM if CASES[case][0] == "u" else SPARSE_DIM
    assert tm.w_stack.shape == (14, dim)
    assert _rel(tm.w_stack, jm.w_stack) <= FIT_RTOL
    assert _rel(tc.score(tm).numpy(), jc.score(jm)) <= FIT_RTOL
    jm2, _ = jc.update(off * 2, init=jm)
    tm2, _ = tc.update(torch.from_numpy(off * 2), init=tm)
    assert _rel(tm2.w_stack, jm2.w_stack) <= FIT_RTOL
    cold, _ = tc.update(torch.from_numpy(off * 2))
    np.testing.assert_array_equal(tm2.w_stack, cold.w_stack)


def test_warm_start_with_carried_entity_and_rebind(data):
    """A prior with an entity this data does not train passes it through
    and starts the rest cold; ``rebind`` over L2 equals a fresh build and
    the reference's fresh build, and refuses a change of projected_dim."""
    tc = _re_pair(data, "dense_lanes_lbfgs", jax=False)
    off = torch.zeros(len(data["y"]), dtype=torch.float64)
    cold, _ = tc.update(off)
    prior = dataclasses.replace(cold, w_stack=np.concatenate([cold.w_stack,
                                                              np.ones((1, DIM))]),
                                slot_of={**cold.slot_of, 10**6: len(cold.slot_of)})
    warm, _ = tc.update(off, init=prior)
    np.testing.assert_array_equal(warm.w_stack[:-1], cold.w_stack)
    np.testing.assert_array_equal(warm.w_stack[warm.slot_of[10**6]], np.ones(DIM))
    cfg = tc.config
    rebound = tc.rebind(dataclasses.replace(cfg, reg=TReg(l2=0.3)))
    jfresh, fresh = _re_pair(data, "dense_lanes_lbfgs", l2=0.3)
    a, b = rebound.update(off)[0], fresh.update(off)[0]
    np.testing.assert_array_equal(a.w_stack, b.w_stack)
    assert _rel(a.w_stack, jfresh.update(np.zeros(len(data["y"])))[0].w_stack) <= FIT_RTOL
    with pytest.raises(ValueError, match="data configuration"):
        tc.rebind(dataclasses.replace(cfg, projected_dim=5))


def test_sparse_random_matches_densified(data):
    """A sparse RANDOM coordinate (the matrix's rows gathered through each
    lane's compact columns) and its densified twin (x·A) share one projected
    problem: the same fit and scores within 1e-9 in float64 (the projected
    designs are the same products summed in another order), at the
    projected width on the sparse side."""
    cfg = dict(projector=ProjectorType.RANDOM, projected_dim=6, intercept_index=SPARSE_II,
               solver=SolverConfig(**SOLVER))
    gd = _game_data(data, False)
    cs, cd = (build_coordinate("c", gd, RandomEffectConfig("userId", shard, **cfg),
                               TaskType.LOGISTIC_REGRESSION, seed=SEED, dtype=torch.float64,
                               device="cpu") for shard in ("s", "sd"))
    off = torch.zeros(len(data["y"]), dtype=torch.float64)
    ms, md = cs.update(off)[0], cd.update(off)[0]
    assert ms.w_stack.shape == md.w_stack.shape == (14, SPARSE_DIM)
    assert _rel(ms.w_stack, md.w_stack) <= 1e-9
    assert _rel(cs.score(ms).numpy(), cd.score(md).numpy()) <= 1e-9
    assert all(dev["x"].shape[1 if cs.use_soa else 2] == 7 for dev in cs._dev)


# -- the estimator ------------------------------------------------------------------

def _game_config(jax: bool, case: str, iters: int = 2):
    shard, k, opt, _, ii, _ = CASES[case]
    fixed = JFixed if jax else FixedEffectConfig
    return (JConfig if jax else GameConfig)(
        task=JTask.LOGISTIC_REGRESSION if jax else TaskType.LOGISTIC_REGRESSION,
        num_outer_iterations=iters,
        coordinates={"fixed": fixed(feature_shard="g",
                                    solver=(JSolver if jax else SolverConfig)(**SOLVER),
                                    reg=(JReg if jax else TReg)(l2=1.0)),
                     "per-user": _re_config(jax, shard, k, opt, ii)})


def _norms(data, case):
    shard, ctx = CASES[case][0], CASES[case][3]
    jnorm, tnorm = _contexts(data, shard, ctx)
    return ({shard: jnorm} if jnorm is not None else None,
            {shard: tnorm} if tnorm is not None else None)


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a["fixed"].coefficients.means, b["fixed"].coefficients.means)
    assert a["per-user"].slot_of == b["per-user"].slot_of
    np.testing.assert_array_equal(a["per-user"].w_stack, b["per-user"].w_stack)


@pytest.mark.parametrize("case", ["dense_soa_lbfgs", "sparse_shifts"])
def test_estimator_fused_is_the_host_loop_and_the_references(data, case):
    """``GameEstimator()`` runs the fused sweep (an empty history), bitwise
    ``fused=False``'s fit; that fit within FIT_RTOL of the reference's
    ``fused=False``, and the fused one within the reference's own fused /
    host bound of its ``fused=True``."""
    jnorms, tnorms = _norms(data, case)
    kw = dict(device="cpu", dtype=torch.float64, normalization=tnorms)
    fused = GameEstimator(**kw).fit(_game_data(data, False), [_game_config(False, case)],
                                    seed=SEED)[0]
    host = GameEstimator(fused=False, **kw).fit(_game_data(data, False),
                                                [_game_config(False, case)], seed=SEED)[0]
    assert fused.history.steps == [] and len(host.history.steps) == 4
    _assert_bitwise(fused.model, host.model)
    jd, jcfg = _game_data(data, True), [_game_config(True, case)]
    jhost = JEstimator(fused=False, normalization=jnorms, dtype=np.float64).fit(
        jd, jcfg, seed=SEED)[0].model
    assert _rel(host.model["fixed"].coefficients.means,
                jhost["fixed"].coefficients.means) <= FIT_RTOL
    assert host.model["per-user"].slot_of == jhost["per-user"].slot_of
    assert _rel(host.model["per-user"].w_stack, jhost["per-user"].w_stack) <= FIT_RTOL
    jfused = JEstimator(fused=True, normalization=jnorms, dtype=np.float64).fit(
        jd, jcfg, seed=SEED)[0].model
    np.testing.assert_allclose(fused.model["fixed"].coefficients.means,
                               jfused["fixed"].coefficients.means, rtol=JAX_FUSED_TOL,
                               atol=JAX_FUSED_TOL)
    np.testing.assert_allclose(fused.model["per-user"].w_stack, jfused["per-user"].w_stack,
                               rtol=JAX_FUSED_TOL, atol=JAX_FUSED_TOL)


@pytest.mark.parametrize("case", ["dense_lanes_tron", "sparse_soa"])
def test_validated_estimator_fused_is_the_host_loop(data, case):
    """With a validation suite, ``GameEstimator()`` runs the validated sweep
    (an empty history), bitwise ``fused=False``'s models and evaluations
    over two λ points, and picks the same best."""
    specs = ["auc", "logistic_loss", "auc:userId"]
    train = _game_data(data, False)
    grid = [_game_config(False, case), dataclasses.replace(
        _game_config(False, case), coordinates={
            "fixed": _game_config(False, case).coordinates["fixed"],
            "per-user": dataclasses.replace(_game_config(False, case).coordinates["per-user"],
                                            reg=TReg(l2=0.2))})]
    ests = [GameEstimator(device="cpu", dtype=torch.float64, fused=f,
                          validation_suite=TSuite.from_specs(specs)) for f in ("auto", False)]
    fused, host = (e.fit(train, grid, validation_data=train, seed=SEED) for e in ests)
    for f, h in zip(fused, host):
        assert f.history.steps == [] and len(h.history.steps) == 4
        _assert_bitwise(f.model, h.model)
        assert f.evaluation.values == h.evaluation.values
    assert fused.index(ests[0].best(fused)) == host.index(ests[1].best(host))
