"""The λ grid of the PyTorch port against the JAX package, on the CPU:
``rebind`` on both coordinate kinds, fixed-effect down-sampling, the grid
loop of ``GameEstimator.fit`` and ``GameEstimator.best``.

- A rebound coordinate shares the old one's device tensors (same
  ``data_ptr``) and its update equals a freshly built coordinate's bitwise,
  on the SoA, lane, sparse and INDEX_MAP random-effect paths and on the
  fixed effect, for every kind of optimization change; a change of the data
  configuration raises ValueError and ``fit`` builds afresh.
- A grid with an elastic-net point (across the SoA gate) and a down-sampled
  point matches the JAX ``GameEstimator(fused=False)`` grid within rtol
  1e-6, and the same grid with every coordinate rebuilt bitwise; ``best``
  picks the JAX package's index.
- Down-sampling draws, multipliers and down-sampled fits (variances
  included) match the reference for all four tasks.

Everything runs in float64 on numpy inputs drawn from a seed.  Grid fits run
the solvers to the float64 plateau (tolerance 1e-14), as
tests/test_torch_owlqn.py does for OWLQN: the warm starts of later points
round ~1e-16 apart on the two sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.evaluation.evaluator import EvaluationSuite as JSuite
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.coordinate import build_coordinate as j_build_coordinate
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game import coordinate as tcoord
from photon_ml_tpu_torch.game import estimator as est_mod
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (NormalizationType, OptimizerType, ProjectorType,
                                       TaskType, VarianceComputationType)

FIT_RTOL = 1e-6
TASK = TaskType.LOGISTIC_REGRESSION


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def data():
    """40 users with 5..60 rows (active cap 32 drops rows); shards: a fixed
    design "g" (column 0 an intercept), a second one "g2", per-user designs
    "u" (d 4: the SoA gate) and "u2", "w" (d 12: lanes), "m" (d 12, each user
    observing 9 columns: INDEX_MAP lanes) and "s" (sparse, 40 columns, 5 a
    row: compact lanes); a second id tag "itemId"."""
    rng = np.random.default_rng(31)
    users = 40
    uids = rng.permutation(np.repeat(np.arange(users) * 3 + 1, rng.integers(5, 61, users)))
    n = len(uids)
    xg = rng.normal(size=(n, 6))
    xg[:, 0] = 1.0
    xu, xw = rng.normal(size=(n, 4)), rng.normal(size=(n, 12))
    observed = rng.random((users * 3 + 1, 12)) < 0.75
    xm = rng.normal(size=(n, 12)) * observed[uids]
    idx = rng.integers(0, 40, size=(n, 5))
    vals = rng.normal(size=(n, 5))
    z = (xg[:, 1:] @ rng.normal(size=5) + np.einsum(
        "nd,nd->n", xu, rng.normal(size=(users * 3 + 1, 4))[uids]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(y=y, offset=rng.normal(size=n) * 0.05, weight=rng.random(n) + 0.5,
                features={"g": xg, "g2": xg[:, ::-1].copy(), "u": xu, "u2": xu[:, ::-1].copy(),
                          "w": xw, "m": xm,
                          "s": SparseShard(indices=idx, values=vals, dim=40)},
                id_tags={"userId": uids, "itemId": rng.integers(0, 7, n)})


SOLVER = SolverConfig(max_iters=40, tolerance=1e-9)
PATHS = {  # random-effect path -> its base config
    "soa": dict(feature_shard="u"),
    "lanes": dict(feature_shard="w"),
    "sparse": dict(feature_shard="s"),
    "index_map": dict(feature_shard="m", projector=ProjectorType.INDEX_MAP),
}
RE_CHANGES = {
    "reg": dict(reg=TReg(l2=0.25)),
    "multipliers": dict(per_entity_l2_multipliers={1: 4.0, 4: 0.5, 10: 9.0}),
    "elastic_net": dict(reg=TReg(l1=0.3, l2=1.0)),
    "box": dict(constraints=((0, -0.1, 0.1), (2, 0.0, float("inf")))),
    "tron": dict(optimizer=OptimizerType.TRON),
    "variance": dict(variance=VarianceComputationType.FULL),
}


def _re_config(path, **change):
    return RandomEffectConfig(**{**dict(random_effect_type="userId", solver=SOLVER,
                                        reg=TReg(l2=1.0), active_cap=32),
                                 **PATHS[path], **change})


def _models_equal(a, b) -> bool:
    """Bitwise equality of two updates' published models."""
    if hasattr(a, "w_stack"):
        pairs = [(a.w_stack, b.w_stack), (a.variances, b.variances)]
        if a.slot_of != b.slot_of:
            return False
    else:
        pairs = [(a.coefficients.means, b.coefficients.means),
                 (a.coefficients.variances, b.coefficients.variances)]
    return all((x is None and y is None) or (x is not None and y is not None
                                             and np.array_equal(x, y)) for x, y in pairs)


def _assert_rebind_is_fresh(old, new_cfg, data_, norm=None, seed=3, moves=True):
    """``old.rebind(new_cfg)`` updates bitwise as a fresh build of new_cfg,
    and, where the change ``moves`` the solution, differs from ``old``'s
    own update (the settings took effect)."""
    rebound = old.rebind(new_cfg)
    assert rebound.config == new_cfg and old.config != new_cfg
    fresh = build_coordinate("c", GameData(**data_), new_cfg, TASK, dtype=torch.float64,
                             device="cpu", norm=norm)
    offsets = torch.from_numpy(data_["offset"]) * 3.0
    got, _ = rebound.update(offsets, seed=seed)
    want, _ = fresh.update(offsets, seed=seed)
    assert _models_equal(got, want)
    before, _ = old.update(offsets, seed=seed)
    assert _models_equal(got, before) != moves
    np.testing.assert_array_equal(rebound.score(got).numpy(), fresh.score(want).numpy())
    return rebound, fresh


@pytest.mark.parametrize("change", list(RE_CHANGES))
@pytest.mark.parametrize("path", list(PATHS))
def test_random_effect_rebind_equals_a_fresh_build(data, path, change):
    """Each optimization change on each random-effect path: the rebound
    coordinate keeps the old one's device buckets and designs (the same
    tensors) and updates bitwise as a fresh build; elastic net and a box
    take the SoA path out of its gate, and the rebound coordinate's buckets
    are then a copy permuted on the device (the old one keeps its own).
    TRON inside the SoA gate runs SoA Newton, as L-BFGS does there: the
    same solution."""
    old = build_coordinate("c", GameData(**data), _re_config(path), TASK,
                           dtype=torch.float64, device="cpu")
    assert old.use_soa == (path == "soa")
    new, fresh = _assert_rebind_is_fresh(old, _re_config(path, **RE_CHANGES[change]), data,
                                         moves=(path, change) != ("soa", "tron"))
    assert new.use_soa == fresh.use_soa == (path == "soa" and change not in
                                            ("elastic_net", "box"))
    crossed = new.use_soa != old.use_soa
    for a, b in zip(old._dev, new._dev):
        assert all((a[k].data_ptr() == b[k].data_ptr()) != crossed for k in a)
        if crossed:
            order = (1, 2, 0) if old.use_soa else (2, 0, 1)
            assert torch.equal(b["x"].permute(*order), a["x"])
    design = "_x_idx" if path == "sparse" else "_x_full"
    assert getattr(new, design).data_ptr() == getattr(old, design).data_ptr()


def _fixed_context(data_):
    """STANDARDIZATION of "g" with column 0 as the intercept."""
    stats = tn.compute_feature_stats(torch.from_numpy(data_["features"]["g"]),
                                     intercept_index=0)
    return tn.build_normalization(NormalizationType.STANDARDIZATION, stats)


FIXED_CHANGES = {
    "reg": dict(reg=TReg(l2=0.25)),
    "elastic_net": dict(reg=TReg(l1=2.0, l2=1.0)),
    "box": dict(constraints=((1, -0.05, 0.05), (3, 0.0, float("inf")))),
    "tron": dict(optimizer=OptimizerType.TRON),
    "variance": dict(variance=VarianceComputationType.SIMPLE),
    "down_sampling": dict(down_sampling_rate=0.5),
    "intercept_index": dict(intercept_index=2),
}


@pytest.mark.parametrize("change", list(FIXED_CHANGES))
def test_fixed_effect_rebind_equals_a_fresh_build(data, change):
    """Each optimization change on the fixed effect, on the same batch; the
    intercept change runs under a STANDARDIZATION context, whose coefficient
    maps the rebind binds anew."""
    norm = _fixed_context(data) if change == "intercept_index" else None
    base = dict(feature_shard="g", solver=SOLVER, reg=TReg(l2=1.0),
                intercept_index=0 if norm is not None else None)
    old = build_coordinate("c", GameData(**data), FixedEffectConfig(**base), TASK,
                           dtype=torch.float64, device="cpu", norm=norm)
    new, _ = _assert_rebind_is_fresh(
        old, FixedEffectConfig(**{**base, **FIXED_CHANGES[change]}), data, norm=norm)
    for k in ("x", "y", "offset", "weight"):
        assert getattr(new._batch, k).data_ptr() == getattr(old._batch, k).data_ptr()
    assert new.norm_source is old.norm_source


DATA_CHANGES = {
    "random_effect_type": dict(random_effect_type="itemId"),
    "feature_shard": dict(feature_shard="u2"),
    "active_cap": dict(active_cap=16),
    "min_active_samples": dict(min_active_samples=20),
    "projector": dict(projector=ProjectorType.INDEX_MAP),
    "features_to_samples_ratio": dict(features_to_samples_ratio=0.5),
    "intercept_index": dict(intercept_index=0),
    "fixed_feature_shard": None,
    "kind": None,
}


def _data_change_configs(change):
    """(old, new) coordinate configs of a data-configuration change."""
    fixed = FixedEffectConfig(feature_shard="g", solver=SOLVER, reg=TReg(l2=1.0))
    if change == "fixed_feature_shard":
        return fixed, dataclasses.replace(fixed, feature_shard="g2")
    if change == "kind":
        return fixed, _re_config("soa")
    return _re_config("soa"), _re_config("soa", **DATA_CHANGES[change])


@pytest.mark.parametrize("change", list(DATA_CHANGES))
def test_data_configuration_change_raises_and_fit_rebuilds(data, change, monkeypatch):
    """A change of a field that shapes the device data cannot rebind
    (ValueError, as the reference's ``rebind``), and ``fit`` then builds the
    coordinate afresh: two builds for two configurations.  (A coordinate id
    that changes kind cannot warm-start in ``fit``: rebind alone.)"""
    old_cfg, new_cfg = _data_change_configs(change)
    old = build_coordinate("c", GameData(**data), old_cfg, TASK, dtype=torch.float64,
                           device="cpu")
    with pytest.raises(ValueError, match="rebind cannot change"):
        old.rebind(new_cfg)
    if change == "kind":
        return
    built = []

    def counting(cid, *args, **kw):
        built.append(cid)
        return build_coordinate(cid, *args, **kw)

    monkeypatch.setattr(est_mod, "build_coordinate", counting)
    configs = [GameConfig(task=TASK, coordinates={"c": c}) for c in (old_cfg, new_cfg)]
    GameEstimator(device="cpu", dtype=torch.float64).fit(GameData(**data), configs)
    assert built == ["c", "c"]


# -- the grid ------------------------------------------------------------------

GRID_SOLVER = dict(max_iters=300, tolerance=1e-14)
# (fixed L2, per-user L1, per-user L2, fixed down-sampling rate) per point
GRID = [(8.0, 0.0, 8.0, 1.0), (1.0, 0.0, 1.0, 1.0), (1.0, 0.5, 1.0, 1.0),
        (1.0, 0.0, 0.25, 0.5)]


def _grid_configs(jax: bool):
    fixed, random = (JFixed, JRandom) if jax else (FixedEffectConfig, RandomEffectConfig)
    reg, solver = (JReg, JSolver) if jax else (TReg, SolverConfig)
    config = JConfig if jax else GameConfig
    task = JTask.LOGISTIC_REGRESSION if jax else TASK
    s = solver(**GRID_SOLVER)
    return [config(task=task, num_outer_iterations=2, coordinates={
        "fixed": fixed(feature_shard="g", solver=s, reg=reg(l2=fl2), down_sampling_rate=rate),
        "per-user": random(random_effect_type="userId", feature_shard="u", solver=s,
                           reg=reg(l1=ul1, l2=ul2), active_cap=32)})
        for fl2, ul1, ul2, rate in GRID]


def _halves(data_):
    """(training, validation) parts: every third row is held out."""
    held = np.arange(len(data_["y"])) % 3 == 0

    def part(mask):
        return dict(y=data_["y"][mask], offset=data_["offset"][mask],
                    weight=data_["weight"][mask],
                    features={k: data_["features"][k][mask] for k in ("g", "u")},
                    id_tags={"userId": data_["id_tags"]["userId"][mask]})

    return part(~held), part(held)


def _fit_grid(data_, side: str, specs):
    """(estimator, results, the port's builds) of the grid on one side:
    "jax", "port" or "port_rebuilt" (every rebind refused, so every point
    builds its coordinates), validated by the suite of ``specs``."""
    train, val = _halves(data_)
    if side == "jax":
        suite = JSuite.from_specs(list(specs)) if specs else None
        est = JEstimator(fused=False, dtype=np.float64, validation_suite=suite)
        return est, est.fit(JData(**train), _grid_configs(True),
                            validation_data=JData(**val)), None
    built = []
    suite = TSuite.from_specs(list(specs)) if specs else None
    est = GameEstimator(device="cpu", dtype=torch.float64, validation_suite=suite)
    with pytest.MonkeyPatch.context() as mp:
        def counting(cid, *args, **kw):
            built.append(cid)
            return build_coordinate(cid, *args, **kw)

        def refuse(self, config):
            raise ValueError("rebinding turned off")

        mp.setattr(est_mod, "build_coordinate", counting)
        if side == "port_rebuilt":
            mp.setattr(tcoord.FixedEffectCoordinate, "rebind", refuse)
            mp.setattr(tcoord.RandomEffectCoordinate, "rebind", refuse)
        res = est.fit(GameData(**train), _grid_configs(False),
                      validation_data=GameData(**val))
    return est, res, built


@pytest.fixture(scope="module")
def grids(data):
    """``grids(side, specs)``: ``_fit_grid``, each fit once per module."""
    fits = {}

    def get(side, specs):
        key = (side, specs)
        if key not in fits:
            fits[key] = _fit_grid(data, side, specs)
        return fits[key]

    return get


SPECS = ("auc", "logistic_loss")


def test_grid_matches_jax_and_the_rebuilt_grid(grids):
    """The 4-point grid (a strong point, a weak one, per-user elastic net
    across the SoA gate, a down-sampled fixed effect) builds each coordinate
    once; every point's models match the JAX grid within rtol 1e-6 and the
    grid rebuilt at every point bitwise, with the same validation."""
    _, jres, _ = grids("jax", SPECS)
    _, tres, built = grids("port", SPECS)
    _, rres, rebuilt = grids("port_rebuilt", SPECS)
    assert built == ["fixed", "per-user"]
    # a coordinate whose config did not change is reused, as with rebinding
    configs = _grid_configs(False)
    assert rebuilt == [cid for i, c in enumerate(configs) for cid in c.coordinates
                       if i == 0 or c.coordinates[cid] != configs[i - 1].coordinates[cid]]
    assert len(rebuilt) == 7
    for j, t, r in zip(jres, tres, rres):
        jm, tm, rm = j.model, t.model, r.model
        assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= FIT_RTOL
        assert tm["per-user"].slot_of == jm["per-user"].slot_of
        assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= FIT_RTOL
        for name in SPECS:
            jv = j.evaluation.values[name]
            assert abs(t.evaluation.values[name] - jv) <= FIT_RTOL * abs(jv)
        np.testing.assert_array_equal(tm["fixed"].coefficients.means,
                                      rm["fixed"].coefficients.means)
        np.testing.assert_array_equal(tm["per-user"].w_stack, rm["per-user"].w_stack)
        assert t.evaluation.values == r.evaluation.values
    # the elastic-net point zeroes some per-user coefficients, the others none
    assert (tres[2].model["per-user"].w_stack == 0).any()
    assert not (tres[1].model["per-user"].w_stack == 0).any()


@pytest.mark.parametrize("specs", [SPECS, SPECS[::-1], None],
                         ids=["auc", "logistic_loss", "no_suite"])
def test_best_picks_the_jax_grid_point(grids, specs):
    """``best`` by the primary metric (the first spec) picks the JAX
    package's index; with no suite, the last result.  Results without an
    evaluation are skipped."""
    jest, jres, _ = grids("jax", specs)
    test_est, tres, _ = grids("port", specs)
    pick = tres.index(test_est.best(tres))
    assert pick == jres.index(jest.best(jres))
    if specs is None:
        assert pick == len(GRID) - 1
        return
    values = [r.evaluation.primary for r in tres]
    better = max if specs[0] == "auc" else min
    assert values[pick] == better(values)
    # without its evaluation, the chosen point is skipped
    tres2 = [dataclasses.replace(r, evaluation=None) if i == pick else r
             for i, r in enumerate(tres)]
    jres2 = [dataclasses.replace(r, evaluation=None) if i == pick else r
             for i, r in enumerate(jres)]
    assert tres2.index(test_est.best(tres2)) == jres2.index(jest.best(jres2)) != pick


# -- down-sampling -------------------------------------------------------------

TASKS = {
    "logistic": (TaskType.LOGISTIC_REGRESSION, JTask.LOGISTIC_REGRESSION),
    "smoothed_hinge": (TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
                       JTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM),
    "linear": (TaskType.LINEAR_REGRESSION, JTask.LINEAR_REGRESSION),
    "poisson": (TaskType.POISSON_REGRESSION, JTask.POISSON_REGRESSION),
}


def _task_data(data_, task):
    """``data``'s fixed design with labels of ``task``'s kind."""
    rng = np.random.default_rng(5)
    xg = data_["features"]["g"]
    z = xg[:, 1:] @ rng.normal(size=5) * 0.5
    y = {"linear": z + rng.normal(size=len(z)),
         "poisson": rng.poisson(np.exp(z)).astype(np.float64)}.get(task, data_["y"])
    return dict(y=y, offset=data_["offset"], weight=data_["weight"], features={"g": xg})


@pytest.mark.parametrize("task", list(TASKS))
def test_down_sampling_matches_the_reference(data, task):
    """The port draws the first n of the reference's ``_padded_n`` draws
    (numpy's stream is a prefix), gives the same multipliers and weights
    (binary tasks: positives kept, kept negatives at 1 / rate; linear and
    Poisson: kept rows unweighted), and a rate >= 1 keeps the weights."""
    ttask, jtask = TASKS[task]
    d = _task_data(data, task)
    n, rate, seed = len(d["y"]), 0.3, 11
    jc = j_build_coordinate("f", JData(**d), JFixed(feature_shard="g",
                                                    down_sampling_rate=rate),
                            jtask, dtype=np.float64)
    tc = build_coordinate("f", GameData(**d), FixedEffectConfig(
        feature_shard="g", down_sampling_rate=rate), ttask, dtype=torch.float64,
        device="cpu")
    draws = np.random.default_rng(seed).random(jc._padded_n)
    np.testing.assert_array_equal(draws[:n],
                                  np.random.default_rng(seed).random(n + 257)[:n])
    keep = tc._down_sample_keep(seed)
    np.testing.assert_array_equal(keep, draws[:n] < rate)
    w = tc._down_sample_weights(seed).numpy()
    np.testing.assert_array_equal(w, np.asarray(jc._down_sample_weights(seed))[:n])
    base = d["weight"]
    if task in ("logistic", "smoothed_hinge"):
        pos = d["y"] > 0.5
        np.testing.assert_array_equal(w[pos], base[pos])
        np.testing.assert_array_equal(w[~pos], np.where(keep, base / rate, 0.0)[~pos])
    else:
        np.testing.assert_array_equal(w, np.where(keep, base, 0.0))
    assert 0 < keep.sum() < n
    assert not np.array_equal(w, tc._down_sample_weights(seed + 1).numpy())
    full = tc.rebind(FixedEffectConfig(feature_shard="g"))
    assert full._down_sample_weights(seed) is full._batch.weight


@pytest.mark.parametrize("task", list(TASKS))
def test_down_sampled_fit_matches_the_reference(data, task):
    """A down-sampled fixed-effect update with SIMPLE variances matches the
    JAX host-paced update (means and variances, rtol 1e-6), for two seeds."""
    ttask, jtask = TASKS[task]
    d = _task_data(data, task)
    s = dict(max_iters=200, tolerance=1e-12)
    jc = j_build_coordinate("f", JData(**d), JFixed(
        feature_shard="g", solver=JSolver(**s), reg=JReg(l2=1.0), down_sampling_rate=0.4,
        variance=JVar.SIMPLE), jtask, dtype=np.float64)
    tc = build_coordinate("f", GameData(**d), FixedEffectConfig(
        feature_shard="g", solver=SolverConfig(**s), reg=TReg(l2=1.0),
        down_sampling_rate=0.4, variance=VarianceComputationType.SIMPLE), ttask,
        dtype=torch.float64, device="cpu")
    for seed in (0, 1):
        jm, jr = jc.update(d["offset"], seed=seed)
        tm, tr = tc.update(torch.from_numpy(d["offset"]), seed=seed)
        assert tr.iterations == int(jr.iterations)
        assert _rel(tm.coefficients.means, jm.coefficients.means) <= FIT_RTOL
        assert _rel(tm.coefficients.variances, jm.coefficients.variances) <= FIT_RTOL
