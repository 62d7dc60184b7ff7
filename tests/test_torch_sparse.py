"""The PyTorch port's sparse shards against the JAX package, on the CPU.

Covers ``SparseBatch`` and the sparse branch of ``GLMObjective``, the
compact bucketing (``bucket_by_entity_sparse``, ``build_observed_indices`` /
INDEX_MAP), back-projection and publishing, sparse scoring, fixed- and
random-effect fits over sparse shards, and the refusals.  Inputs are drawn
with numpy from a seed and handed to both packages; everything runs in
float64.

Tolerances: the objective within 1e-12 relative (the same sums: the JAX
scatter-add and ``index_add_`` on the CPU both add in row order, the row
sums may pair differently); bucketing, projections and lane directories
bitwise; fits within rtol 1e-6, as tests/test_torch_game.py (both sides take
the same solver steps in float64 and land ~1e-13 apart; the margin covers a
solver that stops one iteration apart at its tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core.batch import sparse_batch as j_sparse_batch
from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
from photon_ml_tpu.core.objective import GLMObjective as JObjective
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
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core.batch import sparse_batch as t_sparse_batch
from photon_ml_tpu_torch.core.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.data import synthetic as tsynth
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.ops import fused_glm as tfused
from photon_ml_tpu_torch.parallel import bucketing as tbucketing
from photon_ml_tpu_torch.parallel import projection as tprojection
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]
FIT_RTOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _coo(n, dim, k, seed, zero_frac=0.2, dup=True):
    """Row-padded COO with zero-valued padded slots and, with ``dup``,
    repeated ids within rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    if dup:
        idx[::3, 1] = idx[::3, 0]  # a duplicate id in every third row
    vals = rng.normal(size=(n, k))
    vals[rng.random((n, k)) < zero_frac] = 0.0
    return idx, vals


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_sparse_objective_matches_jax(loss, normalized):
    """value, gradient and Hessian-vector product of a SparseBatch (duplicate
    ids, zero pads, weight-0 rows), with and without a factor + shift
    normalization context."""
    n, dim, k = 180, 40, 6
    idx, vals = _coo(n, dim, k, seed=len(loss) + 10 * normalized)
    rng = np.random.default_rng(3)
    y = {"poisson": rng.poisson(1.0, size=n).astype(np.float64),
         "squared": rng.normal(size=n)}.get(loss, (rng.random(n) < 0.4) * 1.0)
    off, wt = rng.normal(size=n) * 0.2, rng.random(n) + 0.5
    wt[::7] = 0.0
    w, v = rng.normal(size=dim) * 0.3, rng.normal(size=dim)
    fac, sh = rng.random(dim) + 0.5, rng.normal(size=dim) * 0.1
    jnorm = (JNorm(factors=jnp.asarray(fac), shifts=jnp.asarray(sh)) if normalized
             else JNorm(factors=None, shifts=None))
    tnorm = (TNorm(factors=torch.from_numpy(fac), shifts=torch.from_numpy(sh))
             if normalized else TNorm(factors=None, shifts=None))
    jo = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.3), norm=jnorm)
    to = TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.3), norm=tnorm)
    jb = j_sparse_batch(idx, vals, y, dim, off, wt, dtype=jnp.float64)
    tb = t_sparse_batch(idx, vals, y, dim, off, wt, dtype=torch.float64)
    jf, jg = jo.value_and_grad(jnp.asarray(w), jb)
    before = tfused.fused_value_and_grad.launches, tfused.fused_hvp.launches
    tf, tg = to.value_and_grad(torch.from_numpy(w), tb)
    th = to.hvp(torch.from_numpy(w), tb, torch.from_numpy(v))
    assert (tfused.fused_value_and_grad.launches, tfused.fused_hvp.launches) == before
    assert _rel(tf, jf) <= 1e-12
    assert _rel(tg, jg) <= 1e-12
    assert _rel(th, jo.hvp(jnp.asarray(w), jb, jnp.asarray(v))) <= 1e-12


def test_sparse_batch_margins_and_to_dense():
    idx, vals = _coo(50, 20, 5, seed=1)
    y = np.zeros(50)
    jb = j_sparse_batch(idx, vals, y, 20, dtype=jnp.float64)
    tb = t_sparse_batch(idx, vals, y, 20, dtype=torch.float64)
    np.testing.assert_array_equal(tb.to_dense().x.numpy(), np.asarray(jb.to_dense().x))
    w = np.random.default_rng(0).normal(size=20)
    assert _rel(tb.margins(torch.from_numpy(w)), jb.margins(jnp.asarray(w))) <= 1e-14
    assert tb.num_examples == 50 and tb.indices.dtype == torch.int64


def _re_data(seed, n, dim, k, n_users):
    """A per-user sparse bag (the reference tests' shape): ids, values with
    zero pads, shuffled users, logistic labels from per-user weights."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k))
    vals[rng.random((n, k)) < 0.2] = 0.0
    uids = np.repeat(np.arange(n_users), n // n_users)
    rng.shuffle(uids)
    w_true = rng.normal(size=(n_users, dim)) * 0.3
    z = (vals * w_true[uids[:, None], idx]).sum(axis=1)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return idx, vals, uids, y


@pytest.mark.parametrize("ratio", [None, 0.5])
def test_bucket_by_entity_sparse_bitwise(ratio):
    """Compact buckets, projections and the lane directory, bitwise, with and
    without the |Pearson| filter (intercept column 0 pinned)."""
    idx, vals, uids, y = _re_data(4, n=600, dim=300, k=6, n_users=40)
    idx[:, 0], vals[:, 0] = 0, 1.0  # an intercept column in every row
    uids = uids * 5 + 2
    uids[:37] = 999  # one heavy user, capped below
    kw = dict(active_cap=24, min_active_samples=2, lane_multiple=2, seed=7,
              dtype=np.float64, features_to_samples_ratio=ratio, intercept_index=0)
    off, wt = np.linspace(-0.1, 0.1, 600), np.linspace(0.5, 1.5, 600)
    jb, jp = jbucketing.bucket_by_entity_sparse(uids, idx, vals, 300, y, off, wt, **kw)
    tb, tp = tbucketing.bucket_by_entity_sparse(uids, idx, vals, 300, y, off, wt, **kw)
    assert tb.lane_of == jb.lane_of
    assert (tb.dim, tb.num_entities, tb.num_samples) == (jb.dim, jb.num_entities,
                                                          jb.num_samples)
    assert len(tb.buckets) == len(jb.buckets) >= 2
    for t, j, tpp, jpp in zip(tb.buckets, jb.buckets, tp, jp):
        np.testing.assert_array_equal(t.x.numpy(), j.x)
        for name in ("y", "offset", "weight", "rows", "counts", "entity_lanes"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name), name)
        np.testing.assert_array_equal(tpp.indices, jpp.indices)
        assert tpp.d_full == jpp.d_full == 300


@pytest.mark.parametrize("ratio", [None, 0.25])
def test_index_map_projection_bitwise(ratio):
    """build_observed_indices / project_buckets(INDEX_MAP) on dense buckets,
    and the publish scatter of their compact lanes, against the JAX package."""
    rng = np.random.default_rng(8)
    n, d = 400, 24
    x = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.3)
    x[:, 3] = 1.0  # intercept
    uids = rng.integers(0, 30, size=n)
    y = (rng.random(n) < 0.5) * 1.0
    jb = jbucketing.bucket_by_entity(uids, x, y, dtype=np.float64)
    tb = tbucketing.bucket_by_entity(uids, x, y, dtype=np.float64)
    jproj = jprojection.project_buckets(jb, JProj.INDEX_MAP,
                                        features_to_samples_ratio=ratio, intercept_index=3)
    tproj = tprojection.project_buckets(tb, ProjectorType.INDEX_MAP,
                                        features_to_samples_ratio=ratio, intercept_index=3)
    for j, t, jpp, tpp in zip(jproj.buckets, tproj.buckets, jproj.projections,
                              tproj.projections):
        np.testing.assert_array_equal(tpp.indices, jpp.indices)
        np.testing.assert_array_equal(t.x.numpy(), j.x)
        w = rng.normal(size=(t.num_lanes, tpp.d_proj))
        slots = torch.arange(t.num_lanes)
        np.testing.assert_array_equal(
            tbucketing.publish_stack([torch.from_numpy(w)], [slots], t.num_lanes, d,
                                     [tpp]).numpy(), jpp.back_project(w))
    with pytest.raises(NotImplementedError, match="RANDOM"):
        tprojection.project_buckets(tb, ProjectorType.RANDOM)


def test_publish_stack_matches_jax_back_project_and_stack():
    """The device scatter of compact lanes into the [E, d_full] stack equals
    the JAX package's per-bucket back-projection + stacked_coefficients."""
    idx, vals, uids, y = _re_data(6, n=300, dim=90, k=4, n_users=20)
    uids[:40] = 77  # a second capacity class
    jb, jp = jbucketing.bucket_by_entity_sparse(uids, idx, vals, 90, y, lane_multiple=3,
                                                dtype=np.float64)
    tb, tp = tbucketing.bucket_by_entity_sparse(uids, idx, vals, 90, y, lane_multiple=3,
                                                dtype=np.float64)
    rng = np.random.default_rng(1)
    lanes = [rng.normal(size=(b.num_lanes, p.d_proj)) for b, p in zip(jb.buckets, jp)]
    full = jprojection.ProjectedBuckets(base=jb, buckets=jb.buckets,
                                        projections=jp).back_project(lanes)
    jw, jslot = jbucketing.stacked_coefficients(full, jb)
    slot_of = {e: i for i, e in enumerate(sorted(tb.lane_of))}
    lane_slots = [torch.as_tensor(tbucketing.slots_from(slot_of, b.entity_lanes))
                  for b in tb.buckets]
    tw = tbucketing.publish_stack([torch.from_numpy(a) for a in lanes], lane_slots,
                                  len(slot_of), 90, tp)
    assert slot_of == jslot
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_score_samples_sparse_matches_jax():
    idx, vals = _coo(120, 30, 5, seed=2)
    rng = np.random.default_rng(2)
    w = rng.normal(size=(9, 30))
    slots = rng.integers(-1, 9, size=120).astype(np.int32)
    j = jbucketing.score_samples_sparse(jnp.asarray(w), jnp.asarray(slots),
                                        jnp.asarray(idx), jnp.asarray(vals))
    t = tbucketing.score_samples_sparse(*[torch.from_numpy(a) for a in (w, slots, idx, vals)])
    assert _rel(t, j) <= 1e-14
    assert float(t[slots < 0].abs().max()) == 0.0


def test_sparse1m_generator_matches_bench():
    d = tsynth.synth_sparse1m(64)
    idx, vals, y, dim = bench.synth_sparse1m(64)
    np.testing.assert_array_equal(d["indices"], idx)
    np.testing.assert_array_equal(d["values"], vals)
    np.testing.assert_array_equal(d["y"], y)
    assert d["dim"] == dim == 1_000_000


@pytest.mark.parametrize("optimizer", ["lbfgs", "tron"])
def test_sparse_fixed_effect_fit_matches_jax(optimizer):
    """GameEstimator over one fixed effect on a SparseShard (Poisson, the
    sparse1m task cut to 512 rows of a 4,000-column vocabulary) against JAX
    GameEstimator(fused=False)."""
    rng = np.random.default_rng(12)
    n, dim, k = 512, 4000, 12
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    vals = rng.exponential(0.5, size=(n, k))
    vals[:, -2:] = 0.0  # padded slots
    z = np.clip((vals * (rng.normal(size=dim) * 0.3)[idx]).sum(axis=1), -4, 4)
    y = rng.poisson(np.exp(z)).astype(np.float64)
    s = dict(max_iters=20, tolerance=1e-8)
    jopt, topt = JOpt(optimizer), OptimizerType(optimizer)
    jcfg = JConfig(task=JTask.POISSON_REGRESSION, num_outer_iterations=1, coordinates={
        "fixed": JFixed(feature_shard="g", optimizer=jopt, solver=JSolver(**s),
                        reg=JReg(l2=1.0))})
    tcfg = GameConfig(task=TaskType.POISSON_REGRESSION, num_outer_iterations=1,
                      coordinates={"fixed": FixedEffectConfig(
                          feature_shard="g", optimizer=topt, solver=SolverConfig(**s),
                          reg=TReg(l2=1.0))})
    jdata = JData(y=y, features={"g": JShard(indices=idx, values=vals, dim=dim)})
    tdata = GameData(y=y, features={"g": SparseShard(indices=idx, values=vals, dim=dim)})
    jm = JEstimator(fused=False, dtype=np.float64).fit(jdata, [jcfg])[0].model
    tres = GameEstimator(device="cpu", dtype=torch.float64).fit(tdata, [tcfg])[0]
    tm = tres.model
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= FIT_RTOL
    assert _rel(tm.score(tdata, device="cpu"), jm.score(jdata)) <= FIT_RTOL
    assert tres.history.steps[0]["solver_iterations"] > 1


def _re_pair(shard_j, shard_t, uids, y, **cfg):
    s = dict(max_iters=25)
    jc = j_build_coordinate(
        "u", JData(y=y, features={"u": shard_j}, id_tags={"userId": uids}),
        JRandom(random_effect_type="userId", feature_shard="u", solver=JSolver(**s),
                reg=JReg(l2=1.0), **{k: (JProj(v.value) if k == "projector" else v)
                                     for k, v in cfg.items()}),
        JTask.LOGISTIC_REGRESSION, dtype=np.float64)
    tc = build_coordinate(
        "u", GameData(y=y, features={"u": shard_t}, id_tags={"userId": uids}),
        RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                           solver=SolverConfig(**s), reg=TReg(l2=1.0), **cfg),
        TaskType.LOGISTIC_REGRESSION, dtype=torch.float64, device="cpu")
    return jc, tc


@pytest.mark.parametrize("path", ["lanes", "soa"])
def test_sparse_random_effect_fit_matches_jax(path):
    """A per-user random effect on a sparse shard: compact buckets on the
    lane-batched L-BFGS (d_proj 256, cap 32), or on SoA Newton for the
    narrow compact shape of tests/test_sparse_shards.py:725 (the gate keys
    on the solve-space width, not the 512-column vocabulary).  Update from
    zero, then warm-started from the first model, and scoring."""
    if path == "lanes":
        idx, vals, uids, y = _re_data(5, n=1024, dim=2048, k=8, n_users=32)
        dim = 2048
    else:
        idx, vals, uids, y = _re_data(9, n=128, dim=512, k=2, n_users=16)
        dim = 512
    jc, tc = _re_pair(JShard(indices=idx, values=vals, dim=dim),
                      SparseShard(indices=idx, values=vals, dim=dim), uids, y)
    assert tc.use_soa == jc._use_soa == (path == "soa")
    off = np.random.default_rng(0).normal(size=len(y)) * 0.1
    jm, _ = jc.update(off)
    tm, _ = tc.update(torch.from_numpy(off))
    assert tm.slot_of == jm.slot_of and tm.w_stack.shape == (16 if path == "soa" else 32,
                                                             dim)
    assert _rel(tm.w_stack, jm.w_stack) <= FIT_RTOL
    assert _rel(tc.score(tm), jc.score(jm)) <= FIT_RTOL
    jm2, _ = jc.update(off * 2, init=jm)
    tm2, _ = tc.update(torch.from_numpy(off * 2), init=tm)
    assert _rel(tm2.w_stack, jm2.w_stack) <= FIT_RTOL
    # a compact warm start is its dense twin, exactly
    tc2, _ = tc.update(torch.from_numpy(off * 2), init=tm.to_compact())
    np.testing.assert_array_equal(tc2.w_stack, tm2.w_stack)
    assert _rel(tc.score(tm.to_compact()), tc.score(tm)) == 0.0


def test_index_map_dense_random_effect_fit_matches_jax():
    """INDEX_MAP on a dense shard with the |Pearson| filter: compact solves
    back-projected to full width."""
    rng = np.random.default_rng(31)
    n, d = 640, 40
    x = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.25)
    x[:, 0] = 1.0
    uids = rng.integers(0, 20, size=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-x[:, :8].sum(axis=1)))).astype(np.float64)
    cfg = dict(projector=ProjectorType.INDEX_MAP, features_to_samples_ratio=0.3,
               intercept_index=0)
    jc, tc = _re_pair(x, x, uids, y, **cfg)
    assert tc.use_soa == jc._use_soa
    jm, _ = jc.update(np.zeros(n))
    tm, _ = tc.update(torch.zeros(n, dtype=torch.float64))
    assert _rel(tm.w_stack, jm.w_stack) <= FIT_RTOL
    assert _rel(tc.score(tm), jc.score(jm)) <= FIT_RTOL


def test_sparse_random_effect_refusals():
    """RANDOM, variances and box constraints on a sparse shard raise
    NotImplementedError naming their ROADMAP items."""
    idx, vals, uids, y = _re_data(2, n=256, dim=64, k=4, n_users=8)
    data = GameData(y=y, features={"u": SparseShard(indices=idx, values=vals, dim=64)},
                    id_tags={"userId": uids})

    def build(**kw):
        return build_coordinate("c", data, RandomEffectConfig("userId", "u", **kw),
                                TaskType.LOGISTIC_REGRESSION, device="cpu")

    with pytest.raises(NotImplementedError, match=r"random-effect projectors \(RANDOM\)"):
        build(projector=ProjectorType.RANDOM)
    with pytest.raises(NotImplementedError, match="variances"):
        build(variance=VarianceComputationType.SIMPLE)
    with pytest.raises(NotImplementedError, match="box constraints"):
        build(constraints=((1, -1.0, 1.0),))
    assert build().buckets.num_entities == 8  # the plain sparse coordinate builds


def test_sparse_shard_validation():
    """Malformed sparse shards are refused on the host, before any gather or
    scatter-add could fault on the card."""
    idx, vals = _coo(10, 20, 3, seed=0)
    y = np.zeros(10)
    GameData(y=y, features={"s": SparseShard(indices=idx, values=vals, dim=20)})
    for bad in (np.where(idx == idx.max(), 20, idx), np.where(idx == idx.min(), -1, idx)):
        with pytest.raises(ValueError, match=r"\[0, 20\)"):
            GameData(y=y, features={"s": SparseShard(indices=bad, values=vals, dim=20)})
    with pytest.raises(ValueError, match="one \\[n, k\\] shape"):
        GameData(y=y, features={"s": SparseShard(indices=idx, values=vals[:, :2], dim=20)})
    with pytest.raises(ValueError, match="rows"):
        GameData(y=y[:9], features={"s": SparseShard(indices=idx, values=vals, dim=20)})
