"""Box constraints in the port against the JAX package, in float64 on the CPU.

Covers the constraint helpers (``box_arrays``, the configs' constraint
canonicalization, the coordinates' solve-space box), the projected-gradient
L-BFGS (scalar, and lanes with shared and per-lane bounds), box-constrained
fits through ``GameEstimator`` (fixed effect, dense and compact random
effects, scaled and ``constraint_space="transformed"``), and the
reference's errors.  Both packages get the same numpy inputs.

Tolerances: solver coefficients rtol 1e-8 with identical iteration counts
and reasons (the same steps, float64 dot products summed in another order);
fits within rtol 1e-6, as tests/test_torch_game.py.
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
from photon_ml_tpu.game.coordinate import _box_from_constraints as j_box_from_constraints
from photon_ml_tpu.game.coordinate import build_coordinate as j_build_coordinate
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt import constraints as jconstraints
from photon_ml_tpu.opt import lbfgs as jlbfgs
from photon_ml_tpu.opt import types as jtypes
from photon_ml_tpu.types import NormalizationType as JKind
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import ProjectorType as JProj
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
from photon_ml_tpu_torch.game.coordinate import _box_from_constraints, build_coordinate
from photon_ml_tpu_torch.opt import constraints as tconstraints
from photon_ml_tpu_torch.opt import lbfgs as tlbfgs
from photon_ml_tpu_torch.opt import types as ttypes
from photon_ml_tpu_torch.opt.solve import make_solver
from photon_ml_tpu_torch.types import (NormalizationType, OptimizerType, ProjectorType,
                                       TaskType)

RTOL = 1e-8
FIT_RTOL = 1e-6
INF = float("inf")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _raise_alike(jfn, tfn, exc, match):
    """Both packages raise ``exc`` matching ``match``."""
    with pytest.raises(exc, match=match):
        jfn()
    with pytest.raises(exc, match=match):
        tfn()


def test_box_arrays_match_jax():
    """Densified bounds bitwise, None for no constraints, and the two
    errors: an index out of range and lo > hi."""
    cmap = {4: (-1.0, 2.0), 0: (0.0, INF), 2: (-INF, 0.5)}
    for dtype in (np.float32, np.float64):
        j, t = jconstraints.box_arrays(cmap, 6, dtype), tconstraints.box_arrays(cmap, 6, dtype)
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tconstraints.box_arrays(None, 3) is None and tconstraints.box_arrays({}, 3) is None
    _raise_alike(lambda: jconstraints.box_arrays({6: (0.0, 1.0)}, 6),
                 lambda: tconstraints.box_arrays({6: (0.0, 1.0)}, 6), ValueError, "range")
    _raise_alike(lambda: jconstraints.box_arrays({1: (2.0, 1.0)}, 6),
                 lambda: tconstraints.box_arrays({1: (2.0, 1.0)}, 6), ValueError, "lo > hi")
    w = torch.tensor([[-3.0, 0.2, 9.0], [0.5, -0.1, 1.5]])
    lo, hi = torch.tensor([-1.0, 0.0, -INF]), torch.tensor([1.0, INF, 1.0])
    torch.testing.assert_close(tconstraints.project_to_box(lo, hi)(w),
                               torch.tensor([[-1.0, 0.2, 1.0], [0.5, 0.0, 1.0]]))


@pytest.mark.parametrize("kind", ["fixed", "random"])
def test_canonicalize_constraints_matches_jax(kind):
    """A dict or triples become the same sorted tuple; a duplicate index,
    lo >= hi, two infinite bounds and an unknown ``constraint_space`` are
    ValueErrors in both packages."""

    def both(**kw):
        if kind == "fixed":
            return (lambda: JFixed(feature_shard="g", **kw),
                    lambda: FixedEffectConfig(feature_shard="g", **kw))
        return (lambda: JRandom(random_effect_type="u", feature_shard="g", **kw),
                lambda: RandomEffectConfig(random_effect_type="u", feature_shard="g", **kw))

    for given in ({3: (0, 1), 1: (-2.5, INF)}, [(3, 0, 1), (1, -2.5, INF)]):
        j, t = both(constraints=given)
        assert t().constraints == j().constraints == ((1, -2.5, INF), (3, 0.0, 1.0))
    assert both()[1]().constraints is None
    for bad, match in ((((1, 0, 1), (1, 0, 2)), "duplicate"), (((2, 1.0, 1.0),), "must be <"),
                       (((2, 2.0, 1.0),), "must be <"), (((0, -INF, INF),), "infinite")):
        _raise_alike(*both(constraints=bad), ValueError, match)
    _raise_alike(*both(constraint_space="solver"), ValueError, "constraint_space")
    j, t = both(constraints={0: (0, 1)}, constraint_space="transformed")
    assert t().constraint_space == j().constraint_space == "transformed"


def test_box_from_constraints_matches_jax():
    """The solve-space box: raw bounds without a context, [lo/f, hi/f] under
    scaling, raw bounds under ``constraint_space="transformed"`` whatever the
    context, and the errors (a shift under "original" bounds, an index out of
    range)."""
    cons = ((0, -1.0, 2.0), (3, 0.0, INF), (4, -INF, 0.5))
    f = np.array([2.0, 0.5, 1.0, 4.0, 0.25, 3.0])
    s = np.linspace(-1, 1, 6)
    jscale, tscale = (jn.NormalizationContext(factors=jnp.asarray(f), shifts=None),
                      tn.NormalizationContext(factors=torch.from_numpy(f), shifts=None))
    jshift, tshift = (jn.NormalizationContext(factors=jnp.asarray(f), shifts=jnp.asarray(s)),
                      tn.NormalizationContext(factors=torch.from_numpy(f),
                                              shifts=torch.from_numpy(s)))
    assert _box_from_constraints(None, 6, torch.float64, "cpu") is None
    for (jnorm, tnorm, space) in ((None, None, "original"), (jscale, tscale, "original"),
                                  (jscale, tscale, "transformed"),
                                  (jshift, tshift, "transformed")):
        j = j_box_from_constraints(cons, 6, np.float64, jnorm, space=space)
        t = _box_from_constraints(cons, 6, torch.float64, torch.device("cpu"), tnorm, space)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _raise_alike(lambda: j_box_from_constraints(cons, 6, np.float64, jshift),
                 lambda: _box_from_constraints(cons, 6, torch.float64, "cpu", tshift),
                 ValueError, "shift normalization")
    _raise_alike(lambda: j_box_from_constraints(((6, 0.0, 1.0),), 6, np.float64),
                 lambda: _box_from_constraints(((6, 0.0, 1.0),), 6, torch.float64, "cpu"),
                 ValueError, "out of range")


def _glm(n, d, seed, loss="logistic"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    z = x @ rng.normal(size=d)
    if loss == "poisson":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -4, 2))).astype(np.float64)
    elif loss == "squared":
        y = z + rng.normal(size=n) * 0.3
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return x, y, rng.normal(size=n) * 0.1, rng.random(n) + 0.5


def _box(d, seed):
    """Bounds that bind: [0, inf) on the first half, [-0.2, 0.2] on two
    features, the rest free."""
    lo, hi = np.full(d, -INF), np.full(d, INF)
    lo[: d // 2] = 0.0
    lo[d - 2:], hi[d - 2:] = -0.2, 0.2
    return lo, hi


@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared"])
def test_box_lbfgs_matches_jax(loss):
    """The scalar projected-gradient L-BFGS, ``make_solver(box=)``, against
    the JAX ``minimize_lbfgs(box=)``."""
    x, y, off, wt = _glm(400, 10, seed=len(loss), loss=loss)
    lo, hi = _box(10, 0)
    kw = dict(max_iters=60, tolerance=1e-10)
    jobj = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.3))
    jb = j_dense_batch(x, y, off, wt)
    j = jax.jit(lambda w: jlbfgs.minimize_lbfgs(
        lambda v: jobj.value_and_grad(v, jb), w, jtypes.SolverConfig(**kw),
        box=(jnp.asarray(lo), jnp.asarray(hi))))(jnp.full(10, 0.5))
    t = make_solver(TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.3)),
                    OptimizerType.LBFGS, ttypes.SolverConfig(**kw),
                    box=(torch.from_numpy(lo), torch.from_numpy(hi)))(
        torch.full((10,), 0.5, dtype=torch.float64), t_dense_batch(x, y, off, wt))
    assert (t.iterations, t.reason) == (int(j.iterations), int(j.reason))
    assert _rel(t.w, j.w) <= RTOL
    assert abs(t.grad_norm - float(j.grad_norm)) <= 1e-6 * max(float(j.grad_norm), 1e-12)
    w = t.w.numpy()
    assert ((w == lo) | (w == hi)).any() and (w >= lo).all() and (w <= hi).all()


@pytest.mark.parametrize("bounds", ["shared", "per_lane"])
def test_box_lbfgs_lanes_match_jax_vmap(bounds):
    """The lane L-BFGS with [d] bounds for every lane, or [L, d] bounds, as
    ``jax.vmap(minimize_lbfgs(box=))`` runs it over a ragged bucket."""
    rng = np.random.default_rng(3)
    num_l, cap, d = 20, 16, 6
    counts = rng.integers(0, cap + 1, size=num_l)
    valid = np.arange(cap)[None, :] < counts[:, None]
    x = rng.normal(size=(num_l, cap, d)) * valid[..., None]
    y = (rng.random((num_l, cap)) < 0.5) * valid * 1.0
    off = rng.normal(size=(num_l, cap)) * 0.2 * valid
    wt = valid * 1.0
    l2 = rng.uniform(0.1, 1.0, num_l)
    lo, hi = _box(d, 1)
    if bounds == "per_lane":
        lo = np.broadcast_to(lo, (num_l, d)) * rng.uniform(0.5, 2.0, (num_l, 1))
        hi = np.broadcast_to(hi, (num_l, d)) * rng.uniform(0.5, 2.0, (num_l, 1))
        lo[:, 0] = rng.uniform(-1, 0.5, num_l)
    cfg = dict(max_iters=25, tolerance=1e-10)

    def one(w0, xx, yy, oo, ww, ll, lo_, hi_):
        obj = JObjective(loss=jl.logistic_loss, reg=JReg(l2=ll))
        b = JBatch(x=xx, y=yy, offset=oo, weight=ww)
        return jlbfgs.minimize_lbfgs(lambda w: obj.value_and_grad(w, b), w0,
                                     jtypes.SolverConfig(**cfg), box=(lo_, hi_))

    axes = (0,) * 6 + ((0, 0) if bounds == "per_lane" else (None, None))
    j = jax.jit(jax.vmap(one, in_axes=axes))(
        jnp.zeros((num_l, d)), *[jnp.asarray(a) for a in (x, y, off, wt, l2, lo, hi)])
    t_ = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, off, wt, l2, lo, hi)]
    obj = LaneObjective(tl.logistic_loss, t_[4])
    b = TBatch(x=t_[0], y=t_[1], offset=t_[2], weight=t_[3])
    t = tlbfgs.minimize_lbfgs_lanes(lambda w: obj.value_and_grad(w, b),
                                    torch.zeros((num_l, d), dtype=torch.float64),
                                    ttypes.SolverConfig(**cfg), box=(t_[5], t_[6]))
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_array_equal(t.reason.numpy(), np.asarray(j.reason))
    assert _rel(t.w, j.w) <= RTOL
    assert (t.w.numpy() == np.broadcast_to(lo, (num_l, d))).any()


def _re_data(seed, n_users=10, per_user=40, d=6):
    rng = np.random.default_rng(seed)
    n = n_users * per_user
    xg = rng.normal(size=(n, 4))
    xg[:, 0] = 1.0
    xu = rng.normal(size=(n, d)) * np.exp(rng.uniform(-1, 1, d))
    uids = rng.permutation(np.repeat(np.arange(n_users), per_user))
    z = xg @ rng.normal(size=4) + np.einsum("nd,nd->n", xu,
                                            rng.normal(size=(n_users, d))[uids])
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    idx = rng.integers(0, 30, size=(n, 4)).astype(np.int32)
    vals = rng.normal(size=(n, 4)) * 2.0
    vals[rng.random((n, 4)) < 0.2] = 0.0
    return xg, xu, uids, y, idx, vals


def _scale_contexts(kind, stats_j, stats_t):
    return (jn.build_normalization(JKind(kind), stats_j),
            tn.build_normalization(NormalizationType(kind), stats_t))


CASES = ["fixed", "fixed_scaled", "fixed_transformed", "dense_re_scaled",
         "dense_re_transformed", "compact_scaled"]


@pytest.mark.parametrize("case", CASES)
def test_box_fit_matches_jax(case):
    """Box-constrained fits through ``GameEstimator.fit`` (two sweeps, so
    warm starts too): the fixed effect with raw bounds, scaled bounds and
    ``constraint_space="transformed"`` under STANDARDIZATION; a dense
    IDENTITY per-user coordinate under a shared scaling context, and under
    STANDARDIZATION with transformed bounds; and a sparse per-user coordinate
    on compact lanes under a scaling context, where one bound excludes 0 so
    that every unobserved feature publishes the box fill."""
    xg, xu, uids, y, idx, vals = _re_data(31)
    fixed_box = ((0, -0.3, 0.3), (1, -INF, 0.0), (2, 0.0, INF))
    user_box = ((0, 0.0, INF), (1, -0.1, 0.1), (3, 0.25, 3.0))
    jnorm, tnorm = {}, {}
    fixed_kw, user_kw = dict(intercept_index=0), {}
    fcons = ucons = None
    ju = tu = xu
    if case.startswith("fixed"):
        fcons = fixed_box
        if case != "fixed":
            kind = "standardization" if case == "fixed_transformed" else "scale_with_max_magnitude"
            jg, tg = _scale_contexts(
                kind, jn.compute_feature_stats(jnp.asarray(xg), intercept_index=0),
                tn.compute_feature_stats(torch.from_numpy(xg), intercept_index=0))
            jnorm["g"], tnorm["g"] = jg, tg
        if case == "fixed_transformed":
            fixed_kw["constraint_space"] = "transformed"
    else:
        ucons = user_box
        if case == "compact_scaled":
            ju = JShard(indices=idx, values=vals, dim=30)
            tu = SparseShard(indices=idx, values=vals, dim=30)
            stats = (jn.compute_feature_stats_sparse(idx, vals, 30),
                     tn.compute_feature_stats_sparse(idx, vals, 30))
            kind = "scale_with_standard_deviation"
        else:
            xu = np.concatenate([np.ones((len(y), 1)), xu + 1.5], axis=1)
            ju = tu = xu
            stats = (jn.compute_feature_stats(jnp.asarray(xu), intercept_index=0),
                     tn.compute_feature_stats(torch.from_numpy(xu), intercept_index=0))
            user_box = ((1, 0.0, INF), (2, -0.1, 0.1), (4, 0.25, 3.0))
            ucons = user_box
            user_kw["intercept_index"] = 0
            kind = "scale_with_max_magnitude"
            if case == "dense_re_transformed":
                kind = "standardization"
                user_kw["constraint_space"] = "transformed"
        jnorm["u"], tnorm["u"] = _scale_contexts(kind, *stats)
    solver = dict(max_iters=200, tolerance=1e-13)
    jcfg = JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": JFixed(feature_shard="g", solver=jtypes.SolverConfig(**solver),
                        reg=JReg(l2=0.5), constraints=fcons, **fixed_kw),
        "per-user": JRandom(random_effect_type="userId", feature_shard="u",
                            solver=jtypes.SolverConfig(**solver), reg=JReg(l2=1.0),
                            constraints=ucons, **user_kw)})
    tcfg = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": FixedEffectConfig(feature_shard="g", solver=ttypes.SolverConfig(**solver),
                                   reg=TReg(l2=0.5), constraints=fcons, **fixed_kw),
        "per-user": RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                                       solver=ttypes.SolverConfig(**solver),
                                       reg=TReg(l2=1.0), constraints=ucons, **user_kw)})
    tags = {"userId": uids}
    jm = JEstimator(fused=False, dtype=np.float64, normalization=jnorm).fit(
        JData(y=y, features={"g": xg, "u": ju}, id_tags=tags), [jcfg])[0].model
    tm = GameEstimator(device="cpu", dtype=torch.float64, normalization=tnorm).fit(
        GameData(y=y, features={"g": xg, "u": tu}, id_tags=tags), [tcfg])[0].model
    tw, jw = tm["fixed"].coefficients.means, np.asarray(jm["fixed"].coefficients.means)
    assert _rel(tw, jw) <= FIT_RTOL
    assert tm["per-user"].slot_of == jm["per-user"].slot_of
    tu_w, ju_w = tm["per-user"].w_stack, np.asarray(jm["per-user"].w_stack)
    assert _rel(tu_w, ju_w) <= FIT_RTOL
    if case in ("fixed", "fixed_scaled"):  # bounds on the published coefficients
        assert -0.3 <= tw[0] <= 0.3 and tw[1] <= 0.0 and tw[2] >= 0.0
        assert tw[1] == 0.0 or tw[2] == 0.0  # a bound binds
    if case in ("dense_re_scaled", "compact_scaled"):
        col = {c[0]: c for c in user_box}
        for j, (_, lo, hi) in col.items():  # bounds mapped by f, then f^-1: 1e-12
            assert (tu_w[:, j] >= lo - 1e-12 * abs(lo)).all()
            assert (tu_w[:, j] <= hi + 1e-12 * abs(hi)).all()
        assert (tu_w[:, user_box[0][0]] == 0.0).any()  # a bound binds
    if case == "compact_scaled":
        observed = np.zeros(tu_w.shape, bool)
        slots = np.array([tm["per-user"].slot_of[u] for u in uids])
        observed[slots[:, None].repeat(idx.shape[1], 1)[vals != 0], idx[vals != 0]] = True
        np.testing.assert_array_equal(tu_w[~observed[:, 3], 3], 0.25)  # the fill


def _coordinate_both(config_pair, shard_pair, uids, y, norms=(None, None)):
    """Build the same coordinate in both packages (thunks, for the errors)."""
    (jcfg, tcfg), (js, ts) = config_pair, shard_pair
    return (lambda: j_build_coordinate(
                "c", JData(y=y, features={"s": js}, id_tags={"userId": uids}), jcfg,
                JTask.LOGISTIC_REGRESSION, dtype=np.float64, norm=norms[0]),
            lambda: build_coordinate(
                "c", GameData(y=y, features={"s": ts}, id_tags={"userId": uids}), tcfg,
                TaskType.LOGISTIC_REGRESSION, dtype=torch.float64, device="cpu",
                norm=norms[1]))


def test_box_reference_errors():
    """The reference's ValueErrors, raised by both packages: a box under a
    shift context (fixed effect, dense and compact random effects; under
    compaction even with transformed bounds), transformed bounds on a
    compact solve under a scaling context, a box under the RANDOM projector,
    and TRON or the L1 regime (L-BFGS with L1, or OWLQN) with a box."""
    xg, xu, uids, y, idx, vals = _re_data(37)
    xg_stats = (jn.compute_feature_stats(jnp.asarray(xg), intercept_index=0),
                tn.compute_feature_stats(torch.from_numpy(xg), intercept_index=0))
    std = _scale_contexts("standardization", *xg_stats)
    scale = _scale_contexts("scale_with_max_magnitude", *xg_stats)
    box = ((1, 0.0, 1.0),)
    dense, sparse = (xg, xg), (JShard(indices=idx, values=vals, dim=30),
                               SparseShard(indices=idx, values=vals, dim=30))

    def fixed(**kw):
        return JFixed("s", intercept_index=0, **{
            k: (JOpt(v.value) if k == "optimizer" else
                JReg(**v.__dict__) if k == "reg" else v) for k, v in kw.items()}), \
            FixedEffectConfig("s", intercept_index=0, **kw)

    def random(**kw):
        conv = {"optimizer": lambda v: JOpt(v.value), "projector": lambda v: JProj(v.value),
                "reg": lambda v: JReg(**v.__dict__)}
        jkw = {k: conv.get(k, lambda v: v)(v) for k, v in kw.items()}
        if kw.get("projector") == ProjectorType.RANDOM:
            jkw["projected_dim"] = 2
        return (JRandom("userId", "s", intercept_index=0, **jkw),
                RandomEffectConfig("userId", "s", intercept_index=0, **kw))

    cases = [
        (fixed(constraints=box), dense, std, "shift normalization"),
        (random(constraints=box), dense, std, "shift normalization"),
        (random(constraints=box), sparse, _scale_contexts(
            "standardization", jn.compute_feature_stats_sparse(idx, vals, 30, intercept_index=0),
            tn.compute_feature_stats_sparse(idx, vals, 30, intercept_index=0)),
         "shift normalization"),
        (random(constraints=box, constraint_space="transformed",
                projector=ProjectorType.INDEX_MAP), dense, std, "shift normalization"),
        (random(constraints=box, constraint_space="transformed",
                projector=ProjectorType.INDEX_MAP), dense, scale, "transformed"),
        (random(constraints=box, projector=ProjectorType.RANDOM), dense, (None, None),
         "RANDOM"),
    ]
    for opt, reg in ((OptimizerType.TRON, TReg()), (OptimizerType.LBFGS, TReg(l1=0.5)),
                     (OptimizerType.OWLQN, TReg())):
        what = "TRON" if opt == OptimizerType.TRON else "OWLQN"
        cases += [(fixed(constraints=box, optimizer=opt, reg=reg), dense, (None, None), what),
                  (random(constraints=box, optimizer=opt, reg=reg), dense, (None, None), what),
                  (random(constraints=box, optimizer=opt, reg=reg), sparse, (None, None), what)]
    for cfgs, shards, norms, match in cases:
        _raise_alike(*_coordinate_both(cfgs, shards, uids, y, norms), ValueError, match)
    # the same boxes build without the context or with the L-BFGS
    for cfgs, shards in ((fixed(constraints=box), dense), (random(constraints=box), sparse),
                         (random(constraints=box, constraint_space="transformed",
                                 projector=ProjectorType.INDEX_MAP), dense)):
        _coordinate_both(cfgs, shards, uids, y)[1]()
