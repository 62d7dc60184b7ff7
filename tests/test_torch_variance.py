"""The PyTorch port's coefficient variances against the JAX package, on the CPU.

Covers ``GLMObjective.hessian_diag`` / ``hessian`` (dense and sparse, every
loss and normalization kind), ``cholesky_inverse``, ``compute_variances``
(SIMPLE, FULL) and its lane-batched (lanes-first) and SoA (lanes-last)
forms, variances through ``GameEstimator.fit`` on the fixed dense, fixed
sparse, SoA, lane and compact (sparse and INDEX_MAP) paths, the exactness of
the compact expansion, conversion of models with variances, and the
refusals this slice keeps or adds.  Inputs are drawn with numpy from a seed
and handed to both packages.

Tolerances: Hessians and variances in float64 within 1e-10 relative (the
same sums in another order); in float32 within 1e-4 relative to the
largest entry (a few hundred float32 products summed in another order,
against the float64 reference); fits within rtol 1e-6 for means and
variances, as tests/test_torch_game.py; the block-diagonal expansion within
1e-8 relative, as tests/test_compact_property.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core import normalization as jn
from photon_ml_tpu.core.batch import DenseBatch as JBatch
from photon_ml_tpu.core.batch import dense_batch as j_dense_batch
from photon_ml_tpu.core.batch import sparse_batch as j_sparse_batch
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt.solve import compute_variances as j_compute_variances
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import NormalizationType as JKind
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu.utils.linalg import cholesky_inverse as j_cholesky_inverse
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core import objective as tobjective
from photon_ml_tpu_torch.core.batch import DenseBatch, dense_batch, sparse_batch
from photon_ml_tpu_torch.core.objective import GLMObjective, LaneObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.solve import compute_soa_variances, compute_variances
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (NormalizationType, OptimizerType, ProjectorType,
                                       TaskType, VarianceComputationType)
from photon_ml_tpu_torch.utils.linalg import cholesky_inverse

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]
KINDS = ["none", "scale_with_max_magnitude", "scale_with_standard_deviation",
         "standardization"]
F64_RTOL = 1e-10
F32_RTOL = 1e-4
FIT_RTOL = 1e-6
ROADMAP = Path(__file__).resolve().parent.parent / "ROADMAP.md"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _labels(loss, rng, n):
    return {"poisson": rng.poisson(1.0, size=n).astype(np.float64),
            "squared": rng.normal(size=n)}.get(loss, (rng.random(n) < 0.4) * 1.0)


def _problem(loss, kind, sparse, seed):
    """(JAX objective, JAX batch, port objective pieces, w) over one design:
    column 0 is the intercept (ones in every row), the rest badly scaled;
    the normalization context of ``kind`` comes from the design's stats."""
    rng = np.random.default_rng(seed)
    n, dim = 160, 12
    y = _labels(loss, rng, n)
    off, wt = rng.normal(size=n) * 0.2, rng.random(n) + 0.5
    wt[::9] = 0.0
    w = rng.normal(size=dim) * 0.2
    if sparse:
        k = 5
        idx = rng.integers(1, dim, size=(n, k)).astype(np.int32)
        vals = rng.normal(size=(n, k)) * np.array([1.0, 3.0, 0.1, 1.0, 2.0])
        vals[rng.random((n, k)) < 0.2] = 0.0
        idx[::3, 2] = idx[::3, 1]  # duplicate ids
        idx[:, 0], vals[:, 0] = 0, 1.0
        js = jn.compute_feature_stats_sparse(idx, vals, dim, intercept_index=0)
        ts = tn.compute_feature_stats_sparse(idx, vals, dim, intercept_index=0)
        jb = j_sparse_batch(idx, vals, y, dim, off, wt, dtype=jnp.float64)
        data = dict(indices=idx, values=vals, dim=dim)
    else:
        x = rng.normal(size=(n, dim)) * np.resize([1.0, 0.05, 7.0, 2.0], dim) + 0.3
        x[:, 0] = 1.0
        js = jn.compute_feature_stats(jnp.asarray(x), intercept_index=0)
        ts = tn.compute_feature_stats(torch.from_numpy(x), intercept_index=0)
        jb = j_dense_batch(x, y, off, wt, dtype=jnp.float64)
        data = dict(x=x)
    jctx = jn.build_normalization(JKind(kind), js)
    tctx = tn.build_normalization(NormalizationType(kind), ts)
    jo = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.7), norm=jctx)
    return jo, jb, dict(data, y=y, off=off, wt=wt, ctx=tctx), w


def _port(loss, p, dtype):
    """The port's objective and batch in ``dtype`` for a ``_problem``."""
    ctx = p["ctx"].to(dtype, torch.device("cpu"))
    obj = GLMObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.7), norm=ctx)
    if "x" in p:
        b = dense_batch(p["x"], p["y"], p["off"], p["wt"], dtype=dtype)
    else:
        b = sparse_batch(p["indices"], p["values"], p["y"], p["dim"], p["off"], p["wt"],
                         dtype=dtype)
    return obj, b


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("loss", LOSSES)
def test_hessian_diag_and_hessian_match_jax(loss, kind, sparse, dtype):
    jo, jb, p, w = _problem(loss, kind, sparse, seed=LOSSES.index(loss) + 7 * KINDS.index(kind))
    obj, b = _port(loss, p, dtype)
    tw = torch.as_tensor(w, dtype=dtype)
    tol = F64_RTOL if dtype == torch.float64 else F32_RTOL
    jd = jo.hessian_diag(jnp.asarray(w), jb)
    jh = jo.hessian(jnp.asarray(w), jb)
    assert _rel(obj.hessian_diag(tw, b), jd) <= tol
    assert _rel(obj.hessian(tw, b), jh) <= tol
    if not sparse:  # a sparse diagonal squares duplicate slots one by one
        assert _rel(torch.diagonal(obj.hessian(tw, b)), jd) <= tol


def test_dense_hessian_diag_is_the_same_over_row_chunks(monkeypatch):
    """The row-chunked diagonal (chunks of 3 rows, ragged last chunk) equals
    the one-chunk diagonal."""
    _, _, p, w = _problem("logistic", "standardization", False, seed=3)
    obj, b = _port("logistic", p, torch.float64)
    whole = obj.hessian_diag(torch.from_numpy(w), b)
    monkeypatch.setattr(tobjective, "HESSIAN_DIAG_CHUNK_ELEMS", 3 * b.x.shape[1])
    assert _rel(obj.hessian_diag(torch.from_numpy(w), b), whole) <= 1e-13


@pytest.mark.parametrize("kind", ["simple", "full"])
@pytest.mark.parametrize("norm", ["none", "standardization"])
def test_compute_variances_matches_jax(kind, norm):
    jo, jb, p, w = _problem("logistic", norm, False, seed=11)
    obj, b = _port("logistic", p, torch.float64)
    jv = j_compute_variances(jo, jnp.asarray(w), jb, JVar(kind))
    tv = compute_variances(obj, torch.from_numpy(w), b, VarianceComputationType(kind))
    assert _rel(tv, jv) <= F64_RTOL
    assert compute_variances(obj, torch.from_numpy(w), b,
                             VarianceComputationType.NONE) is None


def test_simple_variance_of_a_zero_diagonal_is_zero():
    """SIMPLE is 1 / diag(H) with a zero diagonal giving 0 (no L2 and a
    column of zeros), as the reference."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 4))
    x[:, 2] = 0.0
    y = (rng.random(50) < 0.5) * 1.0
    jo = JObjective(loss=jl.logistic_loss)
    obj = GLMObjective(loss=tl.logistic_loss)
    tv = compute_variances(obj, torch.zeros(4, dtype=torch.float64),
                           dense_batch(x, y, dtype=torch.float64),
                           VarianceComputationType.SIMPLE)
    jv = j_compute_variances(jo, jnp.zeros(4), j_dense_batch(x, y, dtype=jnp.float64),
                             JVar.SIMPLE)
    assert float(tv[2]) == 0.0
    assert _rel(tv, jv) <= F64_RTOL


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_cholesky_inverse_matches_jax(batch):
    rng = np.random.default_rng(8)
    a = rng.normal(size=batch + (7, 7))
    spd = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(7)
    t = cholesky_inverse(torch.from_numpy(spd))
    assert t.shape == spd.shape
    flat_t, flat_spd = t.reshape(-1, 7, 7), spd.reshape(-1, 7, 7)
    for i in range(flat_spd.shape[0]):
        assert _rel(flat_t[i], j_cholesky_inverse(jnp.asarray(flat_spd[i]))) <= F64_RTOL
    assert _rel(t @ torch.from_numpy(spd), np.broadcast_to(np.eye(7), spd.shape)) <= 1e-9


def _lanes(loss, seed, num_l=24, cap=20, d=5):
    """A lanes-first bucket with empty, full and weight-0 lanes; column 0 is
    an intercept."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, cap + 1, size=num_l)
    counts[:2], counts[2] = 0, cap
    valid = np.arange(cap)[None, :] < counts[:, None]
    x = rng.normal(size=(num_l, cap, d)) * np.resize([1.0, 0.2, 4.0], d)
    x[..., 0] = 1.0
    x = x * valid[..., None]
    y = _labels(loss, rng, num_l * cap).reshape(num_l, cap) * valid
    off = rng.normal(size=(num_l, cap)) * 0.2 * valid
    wt = (rng.random((num_l, cap)) + 0.5) * valid
    w = rng.normal(size=(num_l, d)) * 0.3
    l2 = 0.5 + rng.random(num_l)
    return x, y, off, wt, w, l2


@pytest.mark.parametrize("kind", ["simple", "full"])
@pytest.mark.parametrize("norm", ["none", "standardization"])
@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared"])
def test_lane_and_soa_variances_match_jax_vmap(loss, norm, kind):
    """Lanes-first variances under a shared context, and (without a context,
    as the SoA gate requires) lanes-last ones, against ``jax.vmap`` of the
    JAX package's ``compute_variances``."""
    x, y, off, wt, w, l2 = _lanes(loss, seed=len(loss) + len(norm))
    d = x.shape[2]
    fac, sh = np.resize([1.0, 2.0, 0.25], d), np.resize([0.0, 0.3, -1.0], d)
    if norm == "none":
        jctx, tctx = jn.no_normalization(), tn.no_normalization()
    else:
        jctx = jn.NormalizationContext(factors=jnp.asarray(fac), shifts=jnp.asarray(sh))
        tctx = tn.NormalizationContext(factors=torch.from_numpy(fac),
                                       shifts=torch.from_numpy(sh))
    jloss = jl.loss_by_name(loss)

    def one(ww, xx, yy, oo, wtt, ll):
        obj = JObjective(loss=jloss, reg=JReg(l2=ll), norm=jctx)
        return j_compute_variances(obj, ww, JBatch(x=xx, y=yy, offset=oo, weight=wtt),
                                   JVar(kind))

    jv = jax.vmap(one)(*[jnp.asarray(a) for a in (w, x, y, off, wt, l2)])
    t = [torch.from_numpy(a) for a in (x, y, off, wt, w, l2)]
    batch = DenseBatch(x=t[0], y=t[1], offset=t[2], weight=t[3])
    tv = compute_variances(LaneObjective(tl.loss_by_name(loss), t[5], tctx), t[4], batch,
                           VarianceComputationType(kind))
    assert tv.shape == (x.shape[0], d)
    assert _rel(tv, jv) <= F64_RTOL
    if norm == "none":
        sv = compute_soa_variances(tl.loss_by_name(loss), t[4].T, t[0].permute(1, 2, 0),
                                   t[1].T, t[2].T, t[3].T, t[5],
                                   VarianceComputationType(kind))
        assert sv.shape == (x.shape[0], d)
        assert _rel(sv, jv) <= F64_RTOL


# -- fits through GameEstimator -------------------------------------------------

def _glmix_data(seed, n_users=12, d_u=4, sparse_u=False, dim_u=40):
    """A fixed shard with an intercept, and a per-user shard (dense with d_u
    columns, or sparse over dim_u columns with 4 nonzeros a row)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(5, 60, size=n_users)
    uids = rng.permutation(np.repeat(np.arange(n_users) * 3 + 1, counts))
    n = len(uids)
    xg = rng.normal(size=(n, 8)) * np.resize([1.0, 0.1, 5.0, 1.0], 8) + 0.2
    xg[:, 0] = 1.0
    y = (rng.random(n) < 0.45).astype(np.float64)
    off, wt = rng.normal(size=n) * 0.1, rng.random(n) + 0.5
    if sparse_u:
        idx = rng.integers(1, dim_u, size=(n, 4)).astype(np.int32)
        idx[:, 0] = 0
        vals = rng.normal(size=(n, 4))
        vals[:, 0] = 1.0
        return dict(y=y, off=off, wt=wt, uids=uids, xg=xg,
                    u=dict(indices=idx, values=vals, dim=dim_u))
    xu = rng.normal(size=(n, d_u)) * np.resize([1.0, 3.0, 0.2], d_u)
    xu[:, 0] = 1.0
    return dict(y=y, off=off, wt=wt, uids=uids, xg=xg, u=xu)


def _fit_pair(g, fixed_kw, user_kw=None, norm_kinds=None, optimizer="lbfgs"):
    """The same GAME fit in both packages (float64, two sweeps); ``*_kw``
    hold config fields with port-side enums; ``norm_kinds`` maps shards to a
    normalization kind built from the dense design's stats."""
    solver = dict(max_iters=60, tolerance=1e-10)
    enum_to_j = {VarianceComputationType: JVar, ProjectorType: JProj}

    def jkw(kw):
        return {k: enum_to_j[type(v)](v.value) if type(v) in enum_to_j else
                JReg(l2=v.l2) if isinstance(v, TReg) else v for k, v in kw.items()}

    jco = {"fixed": JFixed(feature_shard="g", optimizer=JOpt(optimizer),
                           solver=JSolver(**solver), **jkw(fixed_kw))}
    tco = {"fixed": FixedEffectConfig(feature_shard="g", optimizer=OptimizerType(optimizer),
                                      solver=SolverConfig(**solver), **fixed_kw)}
    if user_kw is not None:
        jco["per-user"] = JRandom(random_effect_type="userId", feature_shard="u",
                                  optimizer=JOpt(optimizer), solver=JSolver(**solver),
                                  **jkw(user_kw))
        tco["per-user"] = RandomEffectConfig(random_effect_type="userId",
                                             feature_shard="u",
                                             optimizer=OptimizerType(optimizer),
                                             solver=SolverConfig(**solver), **user_kw)
    jnorm, tnorm = {}, {}
    for shard, kind in (norm_kinds or {}).items():
        x, ii = {"g": (g["xg"], 0), "u": (g["u"], 0)}[shard]
        jnorm[shard] = jn.build_normalization(
            JKind(kind), jn.compute_feature_stats(jnp.asarray(x), intercept_index=ii))
        tnorm[shard] = tn.build_normalization(
            NormalizationType(kind),
            tn.compute_feature_stats(torch.from_numpy(x), intercept_index=ii))
    sparse_u = isinstance(g["u"], dict)
    parts = dict(y=g["y"], offset=g["off"], weight=g["wt"], id_tags={"userId": g["uids"]})
    jd = JData(features={"g": g["xg"], "u": JShard(**g["u"]) if sparse_u else g["u"]},
               **parts)
    td = GameData(features={"g": g["xg"], "u": SparseShard(**g["u"]) if sparse_u
                            else g["u"]}, **parts)
    jr = JEstimator(fused=False, dtype=np.float64, normalization=jnorm).fit(
        jd, [JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2,
                     coordinates=jco)])[0]
    tr = GameEstimator(device="cpu", dtype=torch.float64, normalization=tnorm).fit(
        td, [GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                        coordinates=tco)])[0]
    return jr, tr


def _check_fixed(jr, tr):
    jc, tc = jr.model["fixed"].coefficients, tr.model["fixed"].coefficients
    assert _rel(tc.means, jc.means) <= FIT_RTOL
    assert tc.variances is not None and tc.variances.shape == tc.means.shape
    assert _rel(tc.variances, jc.variances) <= FIT_RTOL


def _check_random(jr, tr):
    jm, tm = jr.model["per-user"], tr.model["per-user"]
    assert tm.slot_of == jm.slot_of
    assert _rel(tm.w_stack, jm.w_stack) <= FIT_RTOL
    assert tm.variances is not None and tm.variances.shape == tm.w_stack.shape
    assert _rel(tm.variances, jm.variances) <= FIT_RTOL


@pytest.mark.parametrize("norm,kind,optimizer", [
    ("none", "simple", "lbfgs"), ("none", "full", "tron"),
    ("standardization", "simple", "tron"), ("standardization", "full", "lbfgs"),
    ("scale_with_standard_deviation", "simple", "lbfgs"),
    ("scale_with_max_magnitude", "full", "tron")])
def test_fixed_effect_variances_fit_matches_jax(norm, kind, optimizer):
    """Dense fixed effect, variances mapped through the same coefficient map
    as the means (under STANDARDIZATION the intercept's entry takes the
    shift fold, which may be negative: reference parity)."""
    g = _glmix_data(21)
    jr, tr = _fit_pair(g, dict(reg=TReg(l2=0.5), intercept_index=0,
                               variance=VarianceComputationType(kind)),
                       norm_kinds={"g": norm}, optimizer=optimizer)
    _check_fixed(jr, tr)


@pytest.mark.parametrize("kind", ["simple", "full"])
def test_sparse_fixed_effect_variances_fit_matches_jax(kind):
    u = _glmix_data(22, sparse_u=True)["u"]
    g = _glmix_data(22)
    solver = dict(max_iters=60, tolerance=1e-10)
    parts = dict(y=g["y"], offset=g["off"], weight=g["wt"])
    jr = JEstimator(fused=False, dtype=np.float64).fit(
        JData(features={"g": JShard(**u)}, **parts),
        [JConfig(task=JTask.LOGISTIC_REGRESSION, coordinates={"fixed": JFixed(
            feature_shard="g", optimizer=JOpt.TRON, solver=JSolver(**solver),
            reg=JReg(l2=0.5), variance=JVar(kind))})])[0]
    tr = GameEstimator(device="cpu", dtype=torch.float64).fit(
        GameData(features={"g": SparseShard(**u)}, **parts),
        [GameConfig(task=TaskType.LOGISTIC_REGRESSION, coordinates={
            "fixed": FixedEffectConfig(feature_shard="g", optimizer=OptimizerType.TRON,
                                       solver=SolverConfig(**solver), reg=TReg(l2=0.5),
                                       variance=VarianceComputationType(kind))})])[0]
    _check_fixed(jr, tr)


MULT = {1: 3.0, 4: 0.25, 13: 7.5}


@pytest.mark.parametrize("kind", ["simple", "full"])
def test_soa_random_effect_variances_fit_matches_jax(kind):
    """4 per-user features: the SoA Newton path (variances computed on its
    lanes-last buckets), with per-entity L2 multipliers."""
    g = _glmix_data(23)
    var = VarianceComputationType(kind)
    user_kw = dict(reg=TReg(l2=1.0), variance=var, per_entity_l2_multipliers=MULT)
    coord = build_coordinate("u", GameData(y=g["y"], features={"u": g["u"]},
                                           id_tags={"userId": g["uids"]}),
                             RandomEffectConfig("userId", "u", **user_kw),
                             TaskType.LOGISTIC_REGRESSION, device="cpu")
    assert coord.use_soa
    jr, tr = _fit_pair(g, dict(reg=TReg(l2=0.5), variance=var), user_kw)
    _check_fixed(jr, tr)
    _check_random(jr, tr)


@pytest.mark.parametrize("norm,kind", [("none", "simple"), ("standardization", "full"),
                                       ("scale_with_standard_deviation", "simple")])
def test_lane_random_effect_variances_fit_matches_jax(norm, kind):
    """20 per-user features (outside the SoA width gate), or a shared
    context (which turns the gate off): the lane-batched path."""
    g = _glmix_data(24, d_u=20 if norm == "none" else 4)
    var = VarianceComputationType(kind)
    jr, tr = _fit_pair(g, dict(reg=TReg(l2=0.5), variance=var, intercept_index=0),
                       dict(reg=TReg(l2=1.0), variance=var, intercept_index=0,
                            per_entity_l2_multipliers=MULT),
                       norm_kinds={"g": norm, "u": norm}, optimizer="tron")
    _check_fixed(jr, tr)
    _check_random(jr, tr)


@pytest.mark.parametrize("layout", ["sparse", "index_map"])
@pytest.mark.parametrize("kind", ["simple", "full"])
def test_compact_random_effect_variances_fit_matches_jax(layout, kind):
    """Compact lanes (a sparse shard; a dense shard under INDEX_MAP): the
    unobserved features of each entity take the prior-only 1/λ2 of its own
    L2, multiplier included."""
    if layout == "sparse":
        g = _glmix_data(25, sparse_u=True)
        extra = {}
    else:
        g = _glmix_data(25, d_u=10)
        g["u"][np.random.default_rng(0).random(g["u"].shape) < 0.5] = 0.0
        g["u"][:, 0] = 1.0
        g["u"][g["uids"] == 13, 5:] = 0.0  # features entity 13 never observes
        extra = dict(projector=ProjectorType.INDEX_MAP)
    var = VarianceComputationType(kind)
    jr, tr = _fit_pair(g, dict(reg=TReg(l2=0.5)),
                       dict(reg=TReg(l2=2.0), variance=var, per_entity_l2_multipliers=MULT,
                            **extra))
    _check_random(jr, tr)
    tm = tr.model["per-user"]
    assert np.any(tm.variances == 1.0 / (2.0 * 7.5))  # entity 13's unobserved features


@pytest.mark.parametrize("seed", range(5))
def test_compact_full_variances_are_block_diagonal_exact(seed):
    """diag(H_full⁻¹) equals diag(H_compact⁻¹) on the observed columns and
    1/λ2 elsewhere (tests/test_compact_property.py's property, on the
    port's objective)."""
    rng = np.random.default_rng(seed)
    n, d, k = 24, 8, 4
    obs = np.sort(rng.choice(d, size=k, replace=False))
    x_c = rng.normal(size=(n, k))
    y = (rng.random(n) < 0.5) * 1.0
    w_c = rng.normal(size=k) * 0.5
    l2 = 0.1 + 4.9 * rng.random()
    x_full = np.zeros((n, d))
    x_full[:, obs] = x_c
    w_full = np.zeros(d)
    w_full[obs] = w_c
    obj = GLMObjective(loss=tl.logistic_loss, reg=TReg(l2=l2))
    v_full = compute_variances(obj, torch.from_numpy(w_full),
                               dense_batch(x_full, y, dtype=torch.float64),
                               VarianceComputationType.FULL)
    v_c = compute_variances(obj, torch.from_numpy(w_c),
                            dense_batch(x_c, y, dtype=torch.float64),
                            VarianceComputationType.FULL)
    expand = np.full(d, 1.0 / l2)
    expand[obs] = v_c.numpy()
    assert _rel(v_full, expand) <= 1e-8


def test_sparse_random_effect_variances_equal_full_space_inverse_hessian():
    """Through a fit: each entity's published FULL variances are the diagonal
    of the inverse of its full-width Hessian at its published means."""
    g = _glmix_data(26, sparse_u=True, dim_u=12)
    var = VarianceComputationType.FULL
    _, tr = _fit_pair(g, dict(reg=TReg(l2=0.5)),
                      dict(reg=TReg(l2=2.0), variance=var, per_entity_l2_multipliers=MULT))
    tm = tr.model["per-user"]
    u = g["u"]
    dense = sparse_batch(u["indices"], u["values"], g["y"], u["dim"],
                         dtype=torch.float64).to_dense().x
    total = tr.model.score(GameData(y=g["y"], features={
        "g": g["xg"], "u": SparseShard(**u)}, id_tags={"userId": g["uids"]}), device="cpu")
    for eid in (1, 4, 13, 19):
        rows = torch.from_numpy(g["uids"] == eid)
        w = torch.from_numpy(tm.w_stack[tm.slot_of[eid]])
        # the entity's residual offsets: everything but its own score
        off = torch.from_numpy(g["off"])[rows] + total[rows] - dense[rows] @ w
        obj = GLMObjective(loss=tl.logistic_loss, reg=TReg(l2=2.0 * MULT.get(eid, 1.0)))
        h = obj.hessian(w, dense_batch(dense[rows], g["y"][rows.numpy()], off,
                                       g["wt"][rows.numpy()], dtype=torch.float64))
        expected = torch.diagonal(torch.linalg.inv(h))
        assert _rel(tm.variances[tm.slot_of[eid]], expected) <= 1e-8


def test_convert_carries_variances_both_ways():
    """Fixed and random-effect variances from a JAX fit, through the
    exchange dict into the port's models and back, unchanged."""
    g = _glmix_data(27)
    var = VarianceComputationType.SIMPLE
    jr, _ = _fit_pair(g, dict(reg=TReg(l2=0.5), variance=var),
                      dict(reg=TReg(l2=1.0), variance=var))
    jf, ju = jr.model["fixed"], jr.model["per-user"]
    arrays = {"fixed": {"kind": "fixed", "means": np.asarray(jf.coefficients.means),
                        "variances": np.asarray(jf.coefficients.variances),
                        "feature_shard": "g", "task": jf.task.value},
              "per-user": {"kind": "random", "w_stack": np.asarray(ju.w_stack),
                           "variances": np.asarray(ju.variances), "slot_of": ju.slot_of,
                           "random_effect_type": "userId", "feature_shard": "u",
                           "task": ju.task.value}}
    model = convert.game_model_from_arrays(arrays)
    np.testing.assert_array_equal(model["fixed"].coefficients.variances,
                                  jf.coefficients.variances)
    np.testing.assert_array_equal(model["per-user"].variances, ju.variances)
    back = convert.game_model_to_arrays(model)
    for cid in arrays:
        np.testing.assert_array_equal(back[cid]["variances"], arrays[cid]["variances"])
    arrays["fixed"].pop("variances")
    assert convert.game_model_from_arrays(arrays)["fixed"].coefficients.variances is None


def test_carried_entities_keep_their_variances():
    """A warm-start entity that this data does not train keeps its prior
    variances; a prior without variances carries zeros ("not estimated")."""
    g = _glmix_data(28)
    data = GameData(y=g["y"], features={"u": g["u"]}, id_tags={"userId": g["uids"]})
    coord = build_coordinate("u", data, RandomEffectConfig(
        "userId", "u", variance=VarianceComputationType.SIMPLE),
        TaskType.LOGISTIC_REGRESSION, dtype=torch.float64, device="cpu")
    model, _ = coord.update(torch.zeros(len(g["y"]), dtype=torch.float64))
    d = model.w_stack.shape[1]
    prior = type(model)(w_stack=np.ones((1, d)), slot_of={999: 0},
                        random_effect_type="userId", feature_shard="u",
                        variances=np.full((1, d), 0.125))
    out, _ = coord.update(torch.zeros(len(g["y"]), dtype=torch.float64), init=prior)
    np.testing.assert_array_equal(out.variances[out.slot_of[999]], np.full(d, 0.125))
    bare = type(model)(w_stack=np.ones((1, d)), slot_of={999: 0},
                       random_effect_type="userId", feature_shard="u")
    out, _ = coord.update(torch.zeros(len(g["y"]), dtype=torch.float64), init=bare)
    np.testing.assert_array_equal(out.variances[out.slot_of[999]], np.zeros(d))


# -- refusals --------------------------------------------------------------------

def _roadmap_items():
    """{item number: title} of ROADMAP.md's 'Modules still to port' list."""
    text = ROADMAP.read_text()
    section = text[text.index("### 1. Modules still to port"):text.index("### 2.")]
    return {int(m.group(1)): m.group(2)
            for m in re.finditer(r"^(\d+)\. \*\*(.+?)\*\*", section, re.M)}


def _assert_names_roadmap_item(err: BaseException) -> None:
    msg = str(err)
    assert "ROADMAP.md 'Modules still to port'" in msg, msg
    item = int(re.search(r"item (\d+)", msg).group(1))
    assert item in _roadmap_items(), (item, msg)


def test_remaining_refusals_name_an_existing_roadmap_item():
    """The port's own refusals, ``GameEstimator(mesh=...)`` and the grid
    forms of ``FusedSweep``, raise NotImplementedError naming an item of
    ROADMAP.md's 'Modules still to port' that exists.  L1 / OWLQN, box
    constraints, normalization under compaction and the RANDOM projector now
    build, as in the reference, and so do their variances except the
    reference's own NotImplementedError: variances under compaction with a
    per-entity context."""
    g = _glmix_data(29, d_u=6)
    data = GameData(y=g["y"], features={"g": g["xg"], "u": g["u"]},
                    id_tags={"userId": g["uids"]})
    task = TaskType.LOGISTIC_REGRESSION
    ctx = tn.NormalizationContext(factors=torch.full((6,), 0.5), shifts=None)
    from photon_ml_tpu_torch.game import FusedSweep

    with pytest.raises(NotImplementedError, match="mesh") as err:
        GameEstimator(device="cpu", mesh=object())
    _assert_names_roadmap_item(err.value)
    sweep = FusedSweep({"u": build_coordinate("u", data, RandomEffectConfig("userId", "u"),
                                              task, device="cpu")})
    for run in (sweep.run_grid, sweep.run_grid_snapshots):
        with pytest.raises(NotImplementedError, match="grid forms") as err:
            run()
        _assert_names_roadmap_item(err.value)
    simple = VarianceComputationType.SIMPLE
    builds = [
        ("f", FixedEffectConfig("g", optimizer=OptimizerType.OWLQN, variance=simple), None),
        ("f", FixedEffectConfig("g", reg=TReg(l1=0.1), variance=simple), None),
        ("u", RandomEffectConfig("userId", "u", reg=TReg(l1=0.1), variance=simple), None),
        ("f", FixedEffectConfig("g", constraints=((1, -1.0, 1.0),), variance=simple), None),
        ("u", RandomEffectConfig("userId", "u", constraints=((1, -1.0, 1.0),),
                                 variance=simple), None),
        ("u", RandomEffectConfig("userId", "u", projector=ProjectorType.INDEX_MAP), ctx),
        ("u", RandomEffectConfig("userId", "u", projector=ProjectorType.RANDOM,
                                 projected_dim=3), ctx),
    ]
    for cid, cfg, norm in builds:
        coord = build_coordinate(cid, data, cfg, task, device="cpu", norm=norm)
        model, _ = coord.update(torch.zeros(len(g["y"])))
        var = (model.coefficients.variances if cid == "f" else model.variances)
        assert (var is None) == (cfg.variance == VarianceComputationType.NONE)
    sparse = GameData(y=g["y"], features={"s": SparseShard(
        indices=np.zeros((len(g["y"]), 1), np.int32), values=np.ones((len(g["y"]), 1)),
        dim=6)}, id_tags={"userId": g["uids"]})
    build_coordinate("s", sparse, RandomEffectConfig("userId", "s"), task, device="cpu",
                     norm=ctx)
    for d, cfg in ((data, RandomEffectConfig("userId", "u", projector=ProjectorType.INDEX_MAP,
                                             variance=simple)),
                   (sparse, RandomEffectConfig("userId", "s", variance=simple))):
        with pytest.raises(NotImplementedError, match="variances under compaction"):
            build_coordinate("c", d, cfg, task, device="cpu", norm=ctx)


def test_variance_and_normalization_value_errors():
    """Variances under the RANDOM projector, STANDARDIZATION without an
    intercept, a shift context on a coordinate without intercept_index, and
    ``to_compact`` of a model with variances are ValueErrors, as in the
    reference."""
    g = _glmix_data(30)
    data = GameData(y=g["y"], features={"g": g["xg"], "u": g["u"]},
                    id_tags={"userId": g["uids"]})
    task = TaskType.LOGISTIC_REGRESSION
    with pytest.raises(ValueError, match="variances"):
        build_coordinate("u", data, RandomEffectConfig(
            "userId", "u", projector=ProjectorType.RANDOM,
            variance=VarianceComputationType.SIMPLE), task, device="cpu")
    stats = tn.compute_feature_stats(torch.from_numpy(g["xg"]))
    with pytest.raises(ValueError, match="intercept_index"):
        tn.build_normalization(NormalizationType.STANDARDIZATION, stats)
    ctx = tn.build_normalization(NormalizationType.STANDARDIZATION,
                                 tn.compute_feature_stats(torch.from_numpy(g["xg"]),
                                                          intercept_index=0))
    with pytest.raises(ValueError, match="intercept"):
        build_coordinate("f", data, FixedEffectConfig("g"), task, device="cpu", norm=ctx)
    coord = build_coordinate("u", data, RandomEffectConfig(
        "userId", "u", variance=VarianceComputationType.SIMPLE), task, device="cpu")
    model, _ = coord.update(torch.zeros(len(g["y"])))
    assert model.variances is not None
    with pytest.raises(ValueError, match="variances"):
        model.to_compact()
