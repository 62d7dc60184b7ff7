"""The PyTorch port's feature normalization against the JAX package, on the CPU.

Covers feature statistics (dense, weighted and unweighted, and sparse),
``build_normalization`` for the four kinds and the coefficient-space maps,
fixed-effect fits under every kind through ``GameEstimator(normalization=
...)``, the reference's four-kind golden on its trivial dataset, and the
shared context of a random effect (IDENTITY projector, dense shard).  Inputs
are drawn with numpy from a seed and handed to both packages; everything
runs in float64.

Tolerances: statistics, contexts and maps within 1e-12 relative (the same
sums in another order); fits within rtol 1e-6, as tests/test_torch_game.py
(both sides take the same solver steps in float64); the golden at atol 1e-8,
the reference's own tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import normalization as jn
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import NormalizationType as JKind
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core.batch import dense_batch
from photon_ml_tpu_torch.core.objective import GLMObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.solve import make_solver
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import NormalizationType, OptimizerType, TaskType

KINDS = ["none", "scale_with_max_magnitude", "scale_with_standard_deviation",
         "standardization"]
STATS_RTOL = 1e-12
FIT_RTOL = 1e-6
STAT_FIELDS = ("mean", "variance", "min", "max", "abs_max", "num_nonzeros", "count")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _badly_scaled(seed, n=400, d=7, intercept=0):
    """Features of very different scales and means, with zero entries, an
    intercept column of ones and a column with no spread."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * np.resize([1.0, 0.03, 12.0, 2.0], d) \
        + np.resize([0.0, 1.0, -3.0, 0.5], d)
    x[rng.random((n, d)) < 0.1] = 0.0
    x[:, d - 2] = 4.0  # no spread
    x[:, intercept] = 1.0
    return x


def _contexts(kind, x, intercept, weight=None):
    """(JAX, port) contexts of ``kind`` from the same float64 design."""
    js = jn.compute_feature_stats(jnp.asarray(x), None if weight is None
                                  else jnp.asarray(weight), intercept_index=intercept)
    ts = tn.compute_feature_stats(torch.from_numpy(x), None if weight is None
                                  else torch.from_numpy(weight), intercept_index=intercept)
    return (jn.build_normalization(JKind(kind), js),
            tn.build_normalization(NormalizationType(kind), ts))


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_feature_stats_match_jax(weighted):
    x = _badly_scaled(1)
    wt = np.random.default_rng(2).random(len(x)) + 0.5 if weighted else None
    j = jn.compute_feature_stats(jnp.asarray(x), None if wt is None else jnp.asarray(wt),
                                 intercept_index=0)
    t = tn.compute_feature_stats(torch.from_numpy(x), None if wt is None
                                 else torch.from_numpy(wt), intercept_index=0)
    assert t.intercept_index == j.intercept_index == 0
    for f in STAT_FIELDS:
        assert _rel(getattr(t, f), getattr(j, f)) <= STATS_RTOL, f


@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_feature_stats_match_jax(weighted):
    """Implicit zeros, duplicate ids, zero-valued pads, and a column present
    in every row (its min and max are not blended with 0)."""
    rng = np.random.default_rng(5)
    n, dim, k = 300, 30, 5
    idx = rng.integers(1, dim, size=(n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k)) * 3.0
    vals[rng.random((n, k)) < 0.2] = 0.0
    idx[::4, 2] = idx[::4, 1]
    idx[:, 0], vals[:, 0] = 0, rng.random(n) + 2.0  # column 0 in every row, all > 0
    wt = rng.random(n) + 0.5 if weighted else None
    j = jn.compute_feature_stats_sparse(idx, vals, dim, weight=wt, intercept_index=3)
    t = tn.compute_feature_stats_sparse(idx, vals, dim, weight=wt, intercept_index=3)
    assert t.intercept_index == 3
    assert float(t.min[0]) > 2.0  # observed in every row: no implicit zero
    for f in STAT_FIELDS:
        assert _rel(getattr(t, f), getattr(j, f)) <= STATS_RTOL, f


@pytest.mark.parametrize("kind", KINDS)
def test_build_normalization_and_maps_match_jax(kind):
    """Factors and shifts against JAX (the intercept keeps factor 1 and shift
    0; a feature with no spread keeps factor 1 under the kinds that divide
    by the standard deviation); both coefficient maps
    against JAX, their round trip, and margin invariance: the original-space
    model on raw x scores as the transformed one on normalized x."""
    x = _badly_scaled(3, intercept=2)
    jctx, tctx = _contexts(kind, x, 2)
    assert tctx.is_identity == jctx.is_identity == (kind == "none")
    for f in ("factors", "shifts"):
        jv, tv = getattr(jctx, f), getattr(tctx, f)
        assert (jv is None) == (tv is None), f
        if tv is not None:
            assert _rel(tv, jv) <= STATS_RTOL, f
    if tctx.factors is not None:
        assert float(tctx.factors[2]) == 1.0
        if kind != "scale_with_max_magnitude":  # no spread: std 0 keeps factor 1
            assert float(tctx.factors[5]) == 1.0
    if tctx.shifts is not None:
        assert float(tctx.shifts[2]) == 0.0
    w = np.random.default_rng(4).normal(size=(3, x.shape[1]))
    t_orig = tctx.model_to_original_space(torch.from_numpy(w), 2)
    for row in range(3):
        j_orig = jctx.model_to_original_space(jnp.asarray(w[row]), 2)
        assert _rel(t_orig[row], j_orig) <= STATS_RTOL
        j_back = jctx.model_to_transformed_space(j_orig, 2)
        assert _rel(tctx.model_to_transformed_space(t_orig[row], 2), j_back) <= STATS_RTOL
    assert _rel(tctx.model_to_transformed_space(t_orig, 2), w) <= STATS_RTOL
    xn = torch.from_numpy(x)
    if tctx.shifts is not None:
        xn = xn - tctx.shifts
    if tctx.factors is not None:
        xn = xn * tctx.factors
    assert _rel(torch.from_numpy(x) @ t_orig.T, xn @ torch.from_numpy(w).T) <= 1e-12


def _fixed_pair(kind, optimizer, sparse=False):
    """The same one-coordinate logistic fit in both packages, under the
    shard's context of ``kind`` (intercept column 0), two configurations
    (the second warm-starts from the first's original-space model)."""
    x = _badly_scaled(6, n=500, d=9)
    rng = np.random.default_rng(7)
    logits = (x - x.mean(0)) / (x.std(0) + 1e-9) @ rng.normal(size=x.shape[1]) * 0.5
    y = (rng.random(len(x)) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    off, wt = rng.normal(size=len(x)) * 0.1, rng.random(len(x)) + 0.5
    if sparse:
        idx = np.tile(np.arange(x.shape[1], dtype=np.int32), (len(x), 1))
        jshard, tshard = (JShard(indices=idx, values=x, dim=x.shape[1]),
                          SparseShard(indices=idx, values=x, dim=x.shape[1]))
        js = jn.compute_feature_stats_sparse(idx, x, x.shape[1], intercept_index=0)
        ts = tn.compute_feature_stats_sparse(idx, x, x.shape[1], intercept_index=0)
        jctx = jn.build_normalization(JKind(kind), js)
        tctx = tn.build_normalization(NormalizationType(kind), ts)
    else:
        jshard, tshard = x, x
        jctx, tctx = _contexts(kind, x, 0)
    jcfgs, tcfgs = [], []
    for l2 in (1.0, 0.1):
        jcfgs.append(JConfig(task=JTask.LOGISTIC_REGRESSION, coordinates={
            "fixed": JFixed(feature_shard="g", optimizer=JOpt(optimizer.value),
                            solver=JSolver(max_iters=60, tolerance=1e-10),
                            reg=JReg(l2=l2), intercept_index=0)}))
        tcfgs.append(GameConfig(task=TaskType.LOGISTIC_REGRESSION, coordinates={
            "fixed": FixedEffectConfig(feature_shard="g", optimizer=optimizer,
                                       solver=SolverConfig(max_iters=60, tolerance=1e-10),
                                       reg=TReg(l2=l2), intercept_index=0)}))
    jr = JEstimator(fused=False, dtype=np.float64, normalization={"g": jctx}).fit(
        JData(y=y, features={"g": jshard}, offset=off, weight=wt), jcfgs)
    tr = GameEstimator(device="cpu", dtype=torch.float64, normalization={"g": tctx}).fit(
        GameData(y=y, features={"g": tshard}, offset=off, weight=wt), tcfgs)
    return jr, tr


@pytest.mark.parametrize("optimizer", [OptimizerType.LBFGS, OptimizerType.TRON])
@pytest.mark.parametrize("kind", KINDS)
def test_normalized_fixed_effect_fit_matches_jax(kind, optimizer):
    jr, tr = _fixed_pair(kind, optimizer)
    for j, t in zip(jr, tr):
        assert _rel(t.model["fixed"].coefficients.means,
                    j.model["fixed"].coefficients.means) <= FIT_RTOL


@pytest.mark.parametrize("kind", ["scale_with_max_magnitude", "standardization"])
def test_normalized_sparse_fixed_effect_fit_matches_jax(kind):
    """A sparse shard under a context from ``compute_feature_stats_sparse``."""
    jr, tr = _fixed_pair(kind, OptimizerType.TRON, sparse=True)
    for j, t in zip(jr, tr):
        assert _rel(t.model["fixed"].coefficients.means,
                    j.model["fixed"].coefficients.means) <= FIT_RTOL


_TRIVIAL_X = np.asarray([
    [-0.7306653538519616, 0.0],
    [0.6750417712898752, -0.4232874171873786],
    [0.1863463229359709, -0.8163423997075965],
    [-0.6719842051493347, 0.0],
    [0.9699938346531928, 0.0],
    [0.22759406190283604, 0.0],
    [0.9688721028330911, 0.0],
    [0.5993795346650845, 0.0],
    [0.9219423508390701, -0.8972778242305388],
    [0.7006904841584055, -0.5607635619919824],
])
_TRIVIAL_Y = np.asarray([0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


@pytest.mark.parametrize("kind", KINDS)
def test_reference_golden_trivial_normalization(kind):
    """tests/test_game.py's four-kind golden through the port: the
    unregularized linear solve is invariant under every normalization, so
    each kind reproduces the reference's pinned OLS coefficients."""
    x = np.concatenate([_TRIVIAL_X, np.ones((len(_TRIVIAL_Y), 1))], axis=1)
    stats = tn.compute_feature_stats(torch.from_numpy(x), intercept_index=2)
    ctx = tn.build_normalization(NormalizationType(kind), stats)
    cfg = GameConfig(task=TaskType.LINEAR_REGRESSION, coordinates={
        "global": FixedEffectConfig(feature_shard="features",
                                    solver=SolverConfig(max_iters=100, tolerance=1e-11),
                                    reg=TReg(), intercept_index=2)})
    res = GameEstimator(device="cpu", dtype=torch.float64,
                        normalization={"features": ctx}).fit(
        GameData(y=_TRIVIAL_Y, features={"features": x}), [cfg])[0]
    np.testing.assert_allclose(res.model["global"].coefficients.means,
                               [0.34945501725815586, 0.26339479490270173,
                                0.4366125400310442], rtol=0, atol=1e-8)


def _re_norm_data(seed, n_users=6, per_user=60, d=4):
    """Per-user logistic data with an intercept column and badly scaled
    features (tests/test_game.py's ``_re_norm_data``)."""
    rng = np.random.default_rng(seed)
    n = n_users * per_user
    x = rng.normal(size=(n, d)) * np.resize([1.0, 0.03, 12.0, 1.0], d)
    x[:, 0] = 1.0
    uids = np.repeat(np.arange(n_users), per_user)
    wu = rng.normal(size=(n_users, d))
    y = (rng.random(n) < 1 / (1 + np.exp(-np.einsum("nd,nd->n", x, wu[uids])))
         ).astype(float)
    return x, uids, y


def test_random_effect_shared_normalization_parity():
    """IDENTITY projector: one standardization context for every entity
    (tests/test_game.py::test_random_effect_shared_normalization_parity).
    Each entity's published coefficients match a direct normalized solve of
    its rows, mapped to original space, and the SoA gate is off."""
    x, uids, y = _re_norm_data(11)
    factors = 1.0 / (np.std(x, axis=0) + 1e-12)
    shifts = np.mean(x, axis=0).copy()
    factors[0], shifts[0] = 1.0, 0.0
    norm = tn.NormalizationContext(factors=torch.from_numpy(factors),
                                   shifts=torch.from_numpy(shifts))
    solver = SolverConfig(max_iters=100, tolerance=1e-12)
    cfg = RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                             reg=TReg(l2=0.3), intercept_index=0, solver=solver)
    coord = build_coordinate("u", GameData(y=y, features={"u": x}, id_tags={"userId": uids}),
                             cfg, TaskType.LOGISTIC_REGRESSION, dtype=torch.float64,
                             device="cpu", norm=norm)
    assert not coord.use_soa  # 4 features inside the width gate, but normalized
    model, _ = coord.update(torch.zeros(len(y), dtype=torch.float64))
    solve = make_solver(GLMObjective(loss=tl.logistic_loss, reg=TReg(l2=0.3), norm=norm),
                        config=solver)
    for u in range(6):
        rows = uids == u
        res = solve(torch.zeros(x.shape[1], dtype=torch.float64),
                    dense_batch(x[rows], y[rows], dtype=torch.float64))
        w_ref = norm.model_to_original_space(res.w, 0)
        assert _rel(model.w_stack[model.slot_of[u]], w_ref) <= FIT_RTOL


@pytest.mark.parametrize("kind", KINDS)
def test_random_effect_shared_context_fit_matches_jax(kind):
    """A fixed effect and a dense per-user coordinate, both under their
    shard's context, through two configurations (warm starts mapped into
    transformed space), against the JAX package."""
    x, uids, y = _re_norm_data(12, n_users=10, per_user=50)
    xg = _badly_scaled(13, n=len(y), d=6)
    jg, tg = _contexts(kind, xg, 0)
    ju, tu = _contexts(kind, x, 0)
    solver = dict(max_iters=60, tolerance=1e-10)
    jcfgs, tcfgs = [], []
    for l2 in (1.0, 0.2):
        jcfgs.append(JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2,
                             coordinates={
            "fixed": JFixed(feature_shard="g", solver=JSolver(**solver), reg=JReg(l2=l2),
                            intercept_index=0),
            "per-user": JRandom(random_effect_type="userId", feature_shard="u",
                                solver=JSolver(**solver), reg=JReg(l2=l2),
                                intercept_index=0)}))
        tcfgs.append(GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                                coordinates={
            "fixed": FixedEffectConfig(feature_shard="g", solver=SolverConfig(**solver),
                                       reg=TReg(l2=l2), intercept_index=0),
            "per-user": RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                                           solver=SolverConfig(**solver), reg=TReg(l2=l2),
                                           intercept_index=0)}))
    parts = dict(y=y, features={"g": xg, "u": x}, id_tags={"userId": uids})
    jr = JEstimator(fused=False, dtype=np.float64,
                    normalization={"g": jg, "u": ju}).fit(JData(**parts), jcfgs)
    tr = GameEstimator(device="cpu", dtype=torch.float64,
                       normalization={"g": tg, "u": tu}).fit(GameData(**parts), tcfgs)
    for j, t in zip(jr, tr):
        assert _rel(t.model["fixed"].coefficients.means,
                    j.model["fixed"].coefficients.means) <= FIT_RTOL
        assert t.model["per-user"].slot_of == j.model["per-user"].slot_of
        assert _rel(t.model["per-user"].w_stack, j.model["per-user"].w_stack) <= FIT_RTOL


def test_estimator_reuses_a_normalized_coordinate_across_configs(monkeypatch):
    """A coordinate is built once, with its shard's context, and reused by a
    later configuration with the same config; a changed regularization
    rebinds it over the same data, with the same context, and builds
    nothing."""
    import photon_ml_tpu_torch.game.estimator as est_mod

    built = []

    def counting(*args, **kw):
        built.append(kw.get("norm"))
        return build_coordinate(*args, **kw)

    monkeypatch.setattr(est_mod, "build_coordinate", counting)
    x = _badly_scaled(14, n=200, d=5)
    y = (np.random.default_rng(15).random(len(x)) < 0.5).astype(np.float64)
    _, ctx = _contexts("standardization", x, 0)
    cfgs = [GameConfig(task=TaskType.LOGISTIC_REGRESSION, coordinates={
        "fixed": FixedEffectConfig(feature_shard="g", reg=TReg(l2=l2), intercept_index=0,
                                   solver=SolverConfig(max_iters=100, tolerance=1e-12))})
        for l2 in (1.0, 1.0, 0.5)]
    est = GameEstimator(device="cpu", dtype=torch.float64, normalization={"g": ctx})
    a, b, _ = est.fit(GameData(y=y, features={"g": x}), cfgs)
    assert len(built) == 1 and all(n is ctx for n in built)
    assert _rel(b.model["fixed"].coefficients.means,
                a.model["fixed"].coefficients.means) <= FIT_RTOL
