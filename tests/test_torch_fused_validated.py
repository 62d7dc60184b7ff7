"""The port's validated ``FusedSweep`` (``run_validated`` with a
``ValidationPlan``), its ``run_snapshots`` and the estimator's validated
fused dispatch, against the JAX package and the port's own host loop, on
the CPU.

- ``run_validated`` against the JAX package's over three sweeps on the SoA,
  lane L-BFGS, TRON, OWLQN and INDEX_MAP paths: models, evaluations and
  the per-update held-out losses within FUSED_RTOL, the same best
  iteration.
- ``run_validated`` against ``CoordinateDescent(validation=...)`` on the
  same coordinates, two sweeps: the model, every iteration's evaluation and the best
  one bitwise, cold and from a warm start whose carried entities also
  have held-out rows, with the fixed effect down-sampled; the losses times
  the held-out weight sum against the host loop's per-update
  ``logistic_loss`` within 1e-12.
- ``run_snapshots``: snapshot t bitwise the host loop's fit of t + 1
  sweeps, and within FUSED_RTOL of the JAX package's snapshots.
- The variance refusals, and the estimator's fall-backs to the host loop
  (variances, a coordinate without external scoring, and without a suite
  one without the sweep interface); a validated λ grid through
  ``GameEstimator()`` bitwise ``fused=False``'s, one plan a sweep.

Everything runs in float64 on numpy inputs drawn from one seed, the solvers
run to the float64 plateau (tolerance 1e-14), as tests/test_torch_fused.py
does.  The mirrored reference tests are tests/test_solve_path.py's
``TestFusedValidated``.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.evaluation.evaluator import EvaluationSuite as JSuite
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.coordinate import build_coordinate as j_build_coordinate
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.game.fused import FusedSweep as JSweep
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import ProjectorType as JProjector
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, FusedSweep, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game import estimator as est_mod
from photon_ml_tpu_torch.game import fused as fused_mod
from photon_ml_tpu_torch.game.coordinate import (Coordinate, FixedEffectCoordinate,
                                                 build_coordinate)
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.models import game as tgame
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

FUSED_RTOL = 1e-6
LOSS_RTOL = 1e-12
TASK = TaskType.LOGISTIC_REGRESSION
CPU = torch.device("cpu")
USERS = 24
MIN_ACTIVE = 9
STRANGER = 3 * USERS - 1  # a prior's entity with held-out rows but no training rows
UNKNOWN = 3 * USERS  # held-out rows of an entity no model knows
SOLVER = dict(max_iters=300, tolerance=1e-14)
SPECS = ["auc", "logistic_loss", "auc:userId"]
ITERS = 3  # sweeps against the JAX package and in the snapshots
HOST_ITERS = 2  # sweeps against the port's host loop


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def data():
    """(training rows, held-out rows) of 24 users, ids 3u + 1 in shuffled
    order: 2..24 training rows a user (four under MIN_ACTIVE) and 1..5
    held-out rows, plus held-out rows of STRANGER and UNKNOWN.  A fixed
    design "g" (column 0 an intercept) and per-user designs "u" (d 4: the
    SoA gate), "w" (d 10: lanes), "m" (d 10, each user observing about 7
    columns: INDEX_MAP) and "s" (sparse, 30 columns, 4 a row)."""
    rng = np.random.default_rng(83)
    ids = np.arange(USERS) * 3 + 1
    wg, wu = rng.normal(size=4), rng.normal(size=(UNKNOWN + 1, 4))
    observed = rng.random((UNKNOWN + 1, 10)) < 0.7

    def rows(uids):
        n = len(uids)
        xg = rng.normal(size=(n, 5))
        xg[:, 0] = 1.0
        xu, xw = rng.normal(size=(n, 4)), rng.normal(size=(n, 10))
        xm = rng.normal(size=(n, 10)) * observed[uids]
        z = xg[:, 1:] @ wg + np.einsum("nd,nd->n", xu, wu[uids])
        return dict(y=(rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64),
                    offset=rng.normal(size=n) * 0.05, weight=rng.random(n) + 0.5,
                    features={"g": xg, "u": xu, "w": xw, "m": xm},
                    sparse=dict(indices=rng.integers(0, 30, size=(n, 4)),
                                values=rng.normal(size=(n, 4)), dim=30),
                    id_tags={"userId": uids})

    train = rows(rng.permutation(np.repeat(ids, rng.integers(2, 25, USERS))))
    held = np.concatenate([np.repeat(ids, rng.integers(1, 6, USERS)), [STRANGER] * 3,
                           [UNKNOWN] * 2])
    return rows(rng.permutation(held)), train


def _game_data(d, jax: bool = False):
    sp = d["sparse"]
    shard = (JShard if jax else SparseShard)(indices=sp["indices"], values=sp["values"],
                                             dim=sp["dim"])
    return (JData if jax else GameData)(
        y=d["y"], offset=d["offset"], weight=d["weight"],
        features={**d["features"], "s": shard}, id_tags=d["id_tags"])


# path -> (per-user shard, optimizer, fixed L1, per-user L1, INDEX_MAP)
PATHS = {
    "soa": ("u", "LBFGS", 0.0, 0.0, False),
    "lanes": ("w", "LBFGS", 0.0, 0.0, False),
    "tron": ("w", "TRON", 0.0, 0.0, False),
    "owlqn": ("w", "LBFGS", 0.3, 0.2, False),
    "sparse": ("s", "LBFGS", 0.0, 0.0, False),
    "index_map": ("m", "LBFGS", 0.0, 0.0, True),
}


def _config(jax: bool, path: str = "soa", l2=(1.0, 1.0), iters: int = ITERS,
            fixed_kw=None, user_kw=None):
    fixed, random = (JFixed, JRandom) if jax else (FixedEffectConfig, RandomEffectConfig)
    reg = JReg if jax else TReg
    shard, opt, fl1, ul1, index_map = PATHS[path]
    optimizer = (JOpt if jax else OptimizerType)[opt]
    s = (JSolver if jax else SolverConfig)(**SOLVER)
    extra = dict(user_kw or {})
    if index_map:
        extra["projector"] = (JProjector if jax else ProjectorType).INDEX_MAP
    return (JConfig if jax else GameConfig)(
        task=JTask.LOGISTIC_REGRESSION if jax else TASK, num_outer_iterations=iters,
        coordinates={
            "fixed": fixed(feature_shard="g", solver=s, optimizer=optimizer,
                           reg=reg(l2=l2[0], l1=fl1), **(fixed_kw or {})),
            "per-user": random(random_effect_type="userId", feature_shard=shard, solver=s,
                               optimizer=optimizer, reg=reg(l2=l2[1], l1=ul1),
                               min_active_samples=MIN_ACTIVE, **extra)})


def _coords(train, config, keys=None):
    return {cid: build_coordinate(cid, _game_data(train), c, TASK, dtype=torch.float64,
                                  device="cpu",
                                  existing_model_keys=keys if cid == "per-user" else None)
            for cid, c in config.coordinates.items()}


def _prior(train, shard: str, compact: bool = False) -> tgame.GameModel:
    """A warm start: random fixed means and per-user rows for STRANGER and
    every training user but every other under-bound one, so the others
    under the bound and STRANGER are carried (half the sparse shard's
    entries zero)."""
    rng = np.random.default_rng(5)
    dim = {"u": 4, "w": 10, "m": 10, "s": 30}[shard]
    ids, counts = np.unique(train["id_tags"]["userId"], return_counts=True)
    new = set(ids[counts < MIN_ACTIVE].tolist()[::2])
    covered = [u for u in ids.tolist() if u not in new] + [STRANGER]
    w = rng.normal(size=(len(covered), dim)) * 0.3
    if shard == "s":
        w *= rng.random(w.shape) < 0.5
    re = tgame.RandomEffectModel(w_stack=w, slot_of={u: i for i, u in enumerate(covered)},
                                 random_effect_type="userId", feature_shard=shard, task=TASK)
    fixed = tgame.FixedEffectModel(coefficients=Coefficients(means=rng.normal(size=5) * 0.3),
                                   feature_shard="g", task=TASK)
    return tgame.GameModel(models={"fixed": fixed,
                                   "per-user": re.to_compact() if compact else re})


def _assert_bitwise(a, b):
    """Two port models: the same coordinates in the same order, entities,
    coefficients and variances, bit for bit."""
    assert list(a.models) == list(b.models)
    for cid in a.models:
        ma, mb = a[cid], b[cid]
        if isinstance(ma, tgame.FixedEffectModel):
            np.testing.assert_array_equal(ma.coefficients.means, mb.coefficients.means)
            va, vb = ma.coefficients.variances, mb.coefficients.variances
        else:
            assert ma.slot_of == mb.slot_of
            np.testing.assert_array_equal(ma.w_stack, mb.w_stack)
            va, vb = ma.variances, mb.variances
        assert (va is None) == (vb is None)
        if va is not None:
            np.testing.assert_array_equal(va, vb)


def _host_validated(coords, val, iters=HOST_ITERS, **run_kw):
    """The host loop with validation: (model, history, best evaluation,
    each sweep's evaluation)."""
    suite = TSuite.from_specs(SPECS)
    model, history, ev = CoordinateDescent(coords, num_iterations=iters,
                                           validation=(val, suite)).run(CPU, **run_kw)
    ends = [s["validation"] for s in history.steps if s["coordinate"] == "per-user"]
    return model, history, ev, ends


def _best_index(evals, best):
    return next(t for t, e in enumerate(evals) if e is best)


@pytest.mark.parametrize("path", ["soa", "lanes", "tron", "owlqn", "index_map"])
def test_run_validated_matches_jax(data, path):
    """Three validated sweeps on both sides from one numpy seed: the best
    models, every sweep's evaluation and the [T, C] held-out losses within
    FUSED_RTOL of the JAX package's, the same best iteration."""
    val, train = data
    coords = _coords(train, _config(False, path))
    sweep = FusedSweep(coords, num_iterations=ITERS)
    model, evals, best, losses = sweep.run_validated(
        sweep.validation_plan(_game_data(val), TSuite.from_specs(SPECS)))
    jtrain = _game_data(train, jax=True)
    jcoords = {cid: j_build_coordinate(cid, jtrain, c, JTask.LOGISTIC_REGRESSION,
                                       dtype=np.float64)
               for cid, c in _config(True, path).coordinates.items()}
    jsweep = JSweep(jcoords, num_iterations=ITERS)
    jmodel, jevals, jbest, jlosses = jsweep.run_validated(
        jsweep.validation_plan(_game_data(val, jax=True), JSuite.from_specs(SPECS)))
    assert losses.dtype == torch.float64 and losses.shape == (ITERS, 2)
    assert _rel(losses, jlosses) <= FUSED_RTOL
    assert len(evals) == len(jevals) == ITERS
    for e, j in zip(evals, jevals):
        assert list(e.values) == list(j.values)
        for k, v in j.values.items():
            assert abs(e.values[k] - v) <= FUSED_RTOL * abs(v), (k, e.values[k], v)
    assert _best_index(evals, best) == _best_index(jevals, jbest)
    assert _rel(model["fixed"].coefficients.means, jmodel["fixed"].coefficients.means) \
        <= FUSED_RTOL
    assert model["per-user"].slot_of == jmodel["per-user"].slot_of
    assert _rel(model["per-user"].w_stack, jmodel["per-user"].w_stack) <= FUSED_RTOL


@pytest.mark.parametrize("path", list(PATHS))
def test_run_validated_is_the_host_loop(data, path):
    """``run_validated`` and ``CoordinateDescent(validation=...)`` over the
    same coordinates: the best model, every sweep's evaluation and the best
    one bitwise, the best the host loop's sweep."""
    val, train = data
    coords = _coords(train, _config(False, path, iters=HOST_ITERS))
    host, _, host_best, ends = _host_validated(coords, _game_data(val))
    sweep = FusedSweep(coords, num_iterations=HOST_ITERS)
    model, evals, best, _ = sweep.run_validated(
        sweep.validation_plan(_game_data(val), TSuite.from_specs(SPECS)))
    _assert_bitwise(model, host)
    assert [e.values for e in evals] == [e.values for e in ends]
    assert best.values == host_best.values
    assert _best_index(evals, best) == _best_index(ends, host_best)


@pytest.mark.parametrize("path", ["soa", "lanes"])
def test_losses_match_the_host_loss_metric(data, path):
    """The held-out mean losses times the weight sum: the host loop's
    per-update ``logistic_loss`` within LOSS_RTOL (the host metric is the
    weighted sum), also before the first update of the per-user
    coordinate, whose warm start the first loss scores."""
    val, train = data
    prior = _prior(train, PATHS[path][0])
    coords = _coords(train, _config(False, path), keys=frozenset(prior["per-user"].slot_of))
    _, history, _, _ = _host_validated(coords, _game_data(val), initial=prior)
    sweep = FusedSweep(coords, num_iterations=HOST_ITERS)
    _, _, _, losses = sweep.run_validated(
        sweep.validation_plan(_game_data(val), TSuite.from_specs(SPECS)), initial=prior)
    host = np.asarray([s["validation"].values["logistic_loss"] for s in history.steps])
    np.testing.assert_allclose(losses.numpy().reshape(-1) * val["weight"].sum(), host,
                               rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("path, compact", [("soa", False), ("sparse", True),
                                           ("index_map", False)])
def test_run_validated_warm_start_down_sampled(data, path, compact):
    """A warm start whose carried entities (the under-bound users it
    covers, and STRANGER, which has no training rows) have held-out rows,
    the fixed effect down-sampled at 0.8: bitwise the host loop, the
    carried rows the prior's; a compact prior on the sparse path."""
    val, train = data
    prior = _prior(train, PATHS[path][0], compact=compact)
    keys = frozenset(prior["per-user"].slot_of)
    config = _config(False, path, fixed_kw=dict(down_sampling_rate=0.8))
    coords = _coords(train, config, keys=keys)
    host, _, host_best, ends = _host_validated(coords, _game_data(val), initial=prior,
                                               seed=3)
    sweep = FusedSweep(coords, num_iterations=HOST_ITERS)
    model, evals, best, _ = sweep.run_validated(
        sweep.validation_plan(_game_data(val), TSuite.from_specs(SPECS)), initial=prior,
        seed=3)
    _assert_bitwise(model, host)
    assert [e.values for e in evals] == [e.values for e in ends]
    assert best.values == host_best.values
    re, dense_prior = model["per-user"], tgame.dense_random_effect(prior["per-user"])
    assert STRANGER in re.slot_of and STRANGER not in coords["per-user"]._slot_of
    np.testing.assert_array_equal(re.w_stack[re.slot_of[STRANGER]],
                                  dense_prior.w_stack[dense_prior.slot_of[STRANGER]])


@pytest.mark.parametrize("path", ["soa", "sparse"])
def test_run_snapshots_are_host_fits(data, path):
    """Snapshot t bitwise the host loop's fit of t + 1 sweeps over the same
    coordinates, from a warm start with carried entities."""
    _, train = data
    prior = _prior(train, PATHS[path][0])
    coords = _coords(train, _config(False, path), keys=frozenset(prior["per-user"].slot_of))
    snaps = FusedSweep(coords, num_iterations=ITERS).run_snapshots(initial=prior)
    assert len(snaps) == ITERS
    for t, snap in enumerate(snaps):
        host, _, _ = CoordinateDescent(coords, num_iterations=t + 1).run(CPU, initial=prior)
        _assert_bitwise(snap, host)
    assert not np.array_equal(snaps[0]["fixed"].coefficients.means,
                              snaps[-1]["fixed"].coefficients.means)


def test_run_snapshots_match_jax(data):
    """Every snapshot within FUSED_RTOL of the JAX package's."""
    _, train = data
    snaps = FusedSweep(_coords(train, _config(False, "soa")),
                       num_iterations=ITERS).run_snapshots()
    jtrain = _game_data(train, jax=True)
    jcoords = {cid: j_build_coordinate(cid, jtrain, c, JTask.LOGISTIC_REGRESSION,
                                       dtype=np.float64)
               for cid, c in _config(True, "soa").coordinates.items()}
    jsnaps = JSweep(jcoords, num_iterations=ITERS).run_snapshots()
    assert len(snaps) == len(jsnaps) == ITERS
    for s, j in zip(snaps, jsnaps):
        assert _rel(s["fixed"].coefficients.means, j["fixed"].coefficients.means) <= FUSED_RTOL
        assert s["per-user"].slot_of == j["per-user"].slot_of
        assert _rel(s["per-user"].w_stack, j["per-user"].w_stack) <= FUSED_RTOL


def test_variance_refusals(data):
    """A variance-computing sweep refuses both forms with the reference's
    NotImplementedError, and ``run`` still runs it."""
    val, train = data
    config = _config(False, "soa", iters=1,
                     fixed_kw=dict(variance=VarianceComputationType.SIMPLE))
    sweep = FusedSweep(_coords(train, config))
    with pytest.raises(NotImplementedError, match="run_snapshots does not compute"):
        sweep.run_snapshots()
    plan = sweep.validation_plan(_game_data(val), TSuite.from_specs(SPECS))
    with pytest.raises(NotImplementedError, match="run_validated does not compute"):
        sweep.run_validated(plan)
    assert sweep.run()[0]["fixed"].coefficients.variances is not None


def _without(monkeypatch, method: str):
    """Estimator builds whose fixed effect lacks ``method`` (the base
    Coordinate's refusal)."""
    bare = type("Bare", (FixedEffectCoordinate,), {method: getattr(Coordinate, method)})

    def build(cid, *args, **kwargs):
        coord = build_coordinate(cid, *args, **kwargs)
        if cid == "fixed":
            coord.__class__ = bare
        return coord

    monkeypatch.setattr(est_mod, "build_coordinate", build)


@pytest.mark.parametrize("why", ["variances", "no_external"])
@pytest.mark.parametrize("fused", ["auto", True])
def test_validated_fit_falls_back_to_the_host_loop(data, why, fused, monkeypatch):
    """With a suite, a fit the validated sweep refuses (variances, a
    coordinate without external scoring) runs the host loop, also under
    ``fused=True``: a full history, the variances attached, bitwise the
    ``fused=False`` fit."""
    val, train = data
    over = dict(fixed_kw=dict(variance=VarianceComputationType.SIMPLE)) \
        if why == "variances" else {}
    if why == "no_external":
        _without(monkeypatch, "external_data")
    config = _config(False, "soa", iters=2, **over)
    fits = [GameEstimator(device="cpu", dtype=torch.float64, fused=f,
                          validation_suite=TSuite.from_specs(SPECS)).fit(
        _game_data(train), [config], validation_data=_game_data(val))[0]
        for f in (fused, False)]
    assert len(fits[0].history.steps) == 4
    _assert_bitwise(fits[0].model, fits[1].model)
    assert fits[0].evaluation.values == fits[1].evaluation.values
    assert (fits[0].model["fixed"].coefficients.variances is not None) == (why == "variances")


def test_fit_without_suite_falls_back_or_raises(data, monkeypatch):
    """Without a suite, a coordinate without the sweep interface runs the
    host loop under ``"auto"`` and raises under ``fused=True``, as in the
    reference."""
    _, train = data
    _without(monkeypatch, "init_sweep_state")
    config = _config(False, "soa", iters=1)
    (r,) = GameEstimator(device="cpu", dtype=torch.float64).fit(_game_data(train), [config])
    assert len(r.history.steps) == 2
    with pytest.raises(NotImplementedError):
        GameEstimator(device="cpu", dtype=torch.float64, fused=True).fit(
            _game_data(train), [config])


def test_validated_grid_through_the_estimator(data, monkeypatch):
    """``GameEstimator()`` with a suite over three points (the last with
    the fixed effect down-sampled, a sweep key of its own) runs the
    validated sweep at each (an empty history), bitwise ``fused=False``'s
    models and evaluations, the same ``best``; one plan a sweep."""
    val, train = data
    grid = [_config(False, "soa", l2=(l2, l2), iters=2) for l2 in (10.0, 0.1)]
    grid.append(_config(False, "soa", l2=(0.1, 0.1), iters=2,
                        fixed_kw=dict(down_sampling_rate=0.7)))
    sweeps, plans = [], []
    real_sweep, real_plan = est_mod.FusedSweep, fused_mod.FusedSweep.validation_plan

    def counted_sweep(*args, **kwargs):
        sweeps.append(real_sweep(*args, **kwargs))
        return sweeps[-1]

    def counted_plan(self, *args, **kwargs):
        plans.append(self)
        return real_plan(self, *args, **kwargs)

    monkeypatch.setattr(est_mod, "FusedSweep", counted_sweep)
    monkeypatch.setattr(fused_mod.FusedSweep, "validation_plan", counted_plan)
    ests = [GameEstimator(device="cpu", dtype=torch.float64, fused=f,
                          validation_suite=TSuite.from_specs(SPECS)) for f in ("auto", False)]
    fused, host = (e.fit(_game_data(train), grid, validation_data=_game_data(val), seed=2)
                   for e in ests)
    assert len(sweeps) == 2 and plans == sweeps
    for f, h in zip(fused, host):
        assert f.history.steps == [] and len(h.history.steps) == 4
        _assert_bitwise(f.model, h.model)
        assert f.evaluation.values == h.evaluation.values
    assert fused.index(ests[0].best(fused)) == host.index(ests[1].best(host))
    assert len({r.evaluation.primary for r in fused}) == 3
