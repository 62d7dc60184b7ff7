"""Per-entity normalization contexts under compaction, against the JAX
package, in float64 on the CPU.

A random effect over a sparse shard, or over a dense shard under INDEX_MAP,
solves each entity in the compact space of its observed columns; the
shard's context is projected into that space per lane (factor and shift
rows, each lane's own intercept position).  Both packages fit the same
numpy data under SCALE_WITH_STANDARD_DEVIATION and STANDARDIZATION, from
cold and warm starts, through ``build_coordinate`` and ``GameEstimator``.
The columns have means far from 0, so the shifts, and the intercept fold
that absorbs them, move every published coefficient vector.

Tolerances: fits within rtol 1e-6, as tests/test_torch_game.py (both sides
take the same solver steps in float64 and land ~1e-13 apart; the margin
covers a solver that stops one iteration apart at its tolerance).
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
from photon_ml_tpu.game.coordinate import build_coordinate as j_build_coordinate
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import NormalizationType as JKind
from photon_ml_tpu.types import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (NormalizationType, ProjectorType, TaskType,
                                       VarianceComputationType)

FIT_RTOL = 1e-6
KINDS = ["scale_with_standard_deviation", "standardization"]
SOLVER = dict(max_iters=60, tolerance=1e-10)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _sparse_data(seed, n_users=12, per_user=30, dim=40, k=5):
    """Per-user sparse rows with an intercept (column 0, value 1) in every
    row; each column's nonzero values have their own scale and a mean far
    from 0, and about 20% of the slots are zero-valued padding."""
    rng = np.random.default_rng(seed)
    n = n_users * per_user
    idx = rng.integers(1, dim, size=(n, k + 1)).astype(np.int32)
    scale = np.exp(rng.uniform(-1.0, 1.0, dim))
    mean = rng.uniform(-2.0, 3.0, dim)
    vals = rng.normal(size=(n, k + 1)) * scale[idx] + mean[idx]
    vals[rng.random((n, k + 1)) < 0.2] = 0.0
    idx[:, 0], vals[:, 0] = 0, 1.0
    uids = rng.permutation(np.repeat(np.arange(n_users), per_user))
    w_true = rng.normal(size=(n_users, dim)) * 0.3
    z = (vals * w_true[uids[:, None], idx]).sum(axis=1) - (mean * 0.3).sum() / 4
    y = (rng.random(n) < 1 / (1 + np.exp(-np.clip(z, -8, 8)))).astype(np.float64)
    return idx, vals, uids, y


def _dense_data(seed, n_users=10, per_user=24, d=9):
    """A dense per-user shard with an intercept column 0 and shifted,
    scaled columns, in which each entity leaves a few columns unobserved
    (zero in all its rows), so INDEX_MAP lanes differ in width and columns."""
    rng = np.random.default_rng(seed)
    n = n_users * per_user
    x = rng.normal(size=(n, d)) * np.exp(rng.uniform(-1, 1, d)) + rng.uniform(-2, 3, d)
    x[:, 0] = 1.0
    uids = np.repeat(np.arange(n_users), per_user)
    for u in range(n_users):
        drop = rng.choice(np.arange(1, d), size=rng.integers(0, d // 2), replace=False)
        x[np.ix_(uids == u, drop)] = 0.0
    wu = rng.normal(size=(n_users, d)) * 0.3
    z = np.einsum("nd,nd->n", x, wu[uids])
    y = (rng.random(n) < 1 / (1 + np.exp(-(z - z.mean())))).astype(np.float64)
    return x, uids, y


def _contexts(kind, shard, intercept=0):
    """(JAX, port) contexts of ``kind`` from the same float64 shard: a
    (indices, values, dim) triple or a dense design."""
    if isinstance(shard, tuple):
        idx, vals, dim = shard
        js = jn.compute_feature_stats_sparse(idx, vals, dim, intercept_index=intercept)
        ts = tn.compute_feature_stats_sparse(idx, vals, dim, intercept_index=intercept)
    else:
        js = jn.compute_feature_stats(jnp.asarray(shard), intercept_index=intercept)
        ts = tn.compute_feature_stats(torch.from_numpy(shard), intercept_index=intercept)
    return (jn.build_normalization(JKind(kind), js),
            tn.build_normalization(NormalizationType(kind), ts))


def _shards(layout, seed):
    """(JAX shard, port shard, uids, y, stats source, projector) of ``layout``."""
    if layout == "sparse":
        idx, vals, uids, y = _sparse_data(seed)
        return (JShard(indices=idx, values=vals, dim=40),
                SparseShard(indices=idx, values=vals, dim=40), uids, y, (idx, vals, 40),
                ProjectorType.IDENTITY)
    x, uids, y = _dense_data(seed)
    return x, x, uids, y, x, ProjectorType.INDEX_MAP


def _re_configs(projector, ii=0, l2=1.0, variance="none"):
    """The per-user coordinate's (JAX, port) configs."""
    cfg = dict(random_effect_type="userId", feature_shard="u", intercept_index=ii)
    return (JRandom(solver=JSolver(**SOLVER), reg=JReg(l2=l2),
                    projector=JProj(projector.value), variance=JVar(variance), **cfg),
            RandomEffectConfig(solver=SolverConfig(**SOLVER), reg=TReg(l2=l2),
                               projector=projector,
                               variance=VarianceComputationType(variance), **cfg))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["sparse", "index_map"])
def test_compact_context_coordinate_matches_jax(layout, kind):
    """``build_coordinate`` + ``update`` from a cold start and warm-started
    from the first model, and scoring: the per-lane contexts through the
    lane L-BFGS, the warm start's compact shift dot and the publish fold."""
    js, ts, uids, y, src, proj = _shards(layout, seed=3)
    jctx, tctx = _contexts(kind, src)
    jcfg, tcfg = _re_configs(proj)
    task = TaskType.LOGISTIC_REGRESSION
    jc = j_build_coordinate("u", JData(y=y, features={"u": js}, id_tags={"userId": uids}),
                            jcfg, JTask.LOGISTIC_REGRESSION, dtype=np.float64, norm=jctx)
    tc = build_coordinate("u", GameData(y=y, features={"u": ts}, id_tags={"userId": uids}),
                          tcfg, task, dtype=torch.float64, device="cpu", norm=tctx)
    assert not tc.use_soa and tc._lane_norms is not None
    off = np.random.default_rng(0).normal(size=len(y)) * 0.2
    jm, _ = jc.update(off)
    tm, _ = tc.update(torch.from_numpy(off))
    assert tm.slot_of == jm.slot_of
    assert _rel(tm.w_stack, jm.w_stack) <= FIT_RTOL
    assert _rel(tc.score(tm), jc.score(jm)) <= FIT_RTOL
    jm2, _ = jc.update(-off, init=jm)
    tm2, _ = tc.update(torch.from_numpy(-off), init=tm)
    assert _rel(tm2.w_stack, jm2.w_stack) <= FIT_RTOL
    if kind == "standardization":
        # the fold moves the published intercepts by far more than the
        # tolerance: each lane's own Σ w_j·s_j over its observed columns
        shifts = tctx.shifts.numpy()
        unfolded = tm.w_stack.copy()
        unfolded[:, 0] += (tm.w_stack * shifts).sum(axis=1)
        assert _rel(unfolded, jm.w_stack) > 1e3 * FIT_RTOL


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["sparse", "index_map"])
def test_compact_context_fit_matches_jax(layout, kind):
    """``GameEstimator.fit`` over a fixed effect and the per-user
    coordinate under its shard's context, two sweeps, then a second
    configuration warm-started from the first, against the JAX package's
    host-paced estimator."""
    js, ts, uids, y, src, proj = _shards(layout, seed=5)
    jctx, tctx = _contexts(kind, src)
    xg = np.random.default_rng(6).normal(size=(len(y), 4))
    jcfgs, tcfgs = [], []
    for l2 in (1.0, 0.3):
        jre, tre = _re_configs(proj, l2=l2)
        jcfgs.append(JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2,
                             coordinates={
            "fixed": JFixed(feature_shard="g", solver=JSolver(**SOLVER), reg=JReg(l2=l2)),
            "per-user": jre}))
        tcfgs.append(GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                                coordinates={
            "fixed": FixedEffectConfig(feature_shard="g", solver=SolverConfig(**SOLVER),
                                       reg=TReg(l2=l2)),
            "per-user": tre}))
    jr = JEstimator(fused=False, dtype=np.float64, normalization={"u": jctx}).fit(
        JData(y=y, features={"g": xg, "u": js}, id_tags={"userId": uids}), jcfgs)
    tr = GameEstimator(device="cpu", dtype=torch.float64, normalization={"u": tctx}).fit(
        GameData(y=y, features={"g": xg, "u": ts}, id_tags={"userId": uids}), tcfgs)
    for j, t in zip(jr, tr):
        assert _rel(t.model["fixed"].coefficients.means,
                    j.model["fixed"].coefficients.means) <= FIT_RTOL
        assert t.model["per-user"].slot_of == j.model["per-user"].slot_of
        assert _rel(t.model["per-user"].w_stack, j.model["per-user"].w_stack) <= FIT_RTOL


@pytest.mark.parametrize("layout", ["sparse", "index_map"])
def test_compact_context_reference_errors(layout):
    """The reference's errors, raised by both packages: shift normalization
    without ``intercept_index``, an entity that never observes the intercept
    column, and variances under compaction with a context."""
    js, ts, uids, y, src, proj = _shards(layout, seed=7)
    jctx, tctx = _contexts("standardization", src)
    task = TaskType.LOGISTIC_REGRESSION

    def both(raises, match, js=js, ts=ts, ii=0, **kw):
        jcfg, tcfg = _re_configs(proj, ii=ii, **kw)
        with pytest.raises(raises, match=match):
            j_build_coordinate("u", JData(y=y, features={"u": js}, id_tags={"userId": uids}),
                               jcfg, JTask.LOGISTIC_REGRESSION, dtype=np.float64, norm=jctx)
        with pytest.raises(raises, match=match):
            build_coordinate("u", GameData(y=y, features={"u": ts}, id_tags={"userId": uids}),
                             tcfg, task, dtype=torch.float64, device="cpu", norm=tctx)

    both(ValueError, "intercept_index", ii=None)
    both(NotImplementedError, "variances under compaction", variance="simple")
    # user 0 never observes the intercept column
    if layout == "sparse":
        vals = np.array(ts.values)
        vals[uids == 0, 0] = 0.0
        js2 = JShard(indices=ts.indices, values=vals, dim=40)
        ts2 = SparseShard(indices=ts.indices, values=vals, dim=40)
    else:
        js2 = ts2 = np.array(ts)
        js2[uids == 0, 0] = 0.0
    both(ValueError, "observed in every entity", js=js2, ts=ts2)
    # a scaling-only context keeps variances refused, but needs no intercept
    jctx, tctx = _contexts("scale_with_standard_deviation", src)
    both(NotImplementedError, "variances under compaction", ii=None, variance="full")
