"""The estimator surface of the PyTorch port against the JAX package, on the
CPU: warm starts with the existing-model lower bound, locked coordinates,
and checkpoint / resume through ``GameEstimator.fit``.

- ``_group_rows`` with a warm start's entity ids, bitwise against the
  reference's over the lower bound, the active cap and key sets; the
  ``lane_of`` of dense (IDENTITY), sparse and INDEX_MAP builds with keys;
  the keys survive ``rebind``.
- The reference's three-entity case: an under-bound entity the prior covers
  passes through bitwise, an under-bound new one trains.
- Warm-started and locked fits, the checkpoint hook's whole sequence of
  cursors and keyword values, resumes (mid-configuration, with the
  checkpointed best, at a configuration boundary) against
  ``GameEstimator(fused=False)`` within rtol 1e-6, and resumes against the
  uninterrupted run within RESUME_RTOL; only a warm start, never a resume,
  feeds the lower bound.

Everything runs in float64 on numpy inputs drawn from a seed.  Priors are
made on the port's side and carried to the JAX package through
``convert.game_model_to_arrays``; fits run the solvers to the float64
plateau (tolerance 1e-14), as tests/test_torch_grid.py does.
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
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models.glm import Coefficients as JCoefficients
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.parallel.bucketing import _group_rows as j_group_rows
from photon_ml_tpu.types import ProjectorType as JProjector
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game import estimator as est_mod
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.models.game import (FixedEffectModel, GameModel,
                                             RandomEffectModel)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.parallel.bucketing import _group_rows
from photon_ml_tpu_torch.types import ProjectorType, TaskType

FIT_RTOL = 1e-6
# a resume against the uninterrupted run, both in float64 on the port: the
# resume sums the total score afresh where the run accumulated it, ~1e-16
# apart (measured: bitwise equal, or 6.3e-13 at one crash point)
RESUME_RTOL = 1e-10
TASK = TaskType.LOGISTIC_REGRESSION
MIN_ACTIVE = 8
SPECS = ["auc", "logistic_loss"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def data():
    """36 users with 2..30 rows (about a fifth under MIN_ACTIVE), ids 3u + 1
    in shuffled order; a fixed design "g" (column 0 an intercept) and
    per-user designs "u" (d 4: the SoA gate), "w" (d 12: lanes), "m" (d 12,
    each user observing 9 columns: INDEX_MAP lanes) and "s" (sparse, 40
    columns, 5 a row: compact lanes)."""
    rng = np.random.default_rng(47)
    users = 36
    uids = rng.permutation(np.repeat(np.arange(users) * 3 + 1, rng.integers(2, 31, users)))
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
                features={"g": xg, "u": xu, "w": xw, "m": xm},
                sparse=dict(indices=idx, values=vals, dim=40),
                id_tags={"userId": uids})


def _game_data(data_, jax: bool, rows=None):
    """GameData of ``data_`` (its ``rows`` where given) on one side."""
    sel = (lambda a: a) if rows is None else (lambda a: a[rows])
    sp = data_["sparse"]
    shard = (JShard if jax else SparseShard)(indices=sel(sp["indices"]),
                                             values=sel(sp["values"]), dim=sp["dim"])
    return (JData if jax else GameData)(
        y=sel(data_["y"]), offset=sel(data_["offset"]), weight=sel(data_["weight"]),
        features={**{k: sel(v) for k, v in data_["features"].items()}, "s": shard},
        id_tags={k: sel(v) for k, v in data_["id_tags"].items()})


def _halves(data_):
    """(training rows, validation rows): every fourth row validates."""
    held = np.arange(len(data_["y"])) % 4 == 0
    return ~held, held


PATHS = {  # random-effect path -> (feature shard, INDEX_MAP)
    "soa": ("u", False), "lanes": ("w", False), "sparse": ("s", False),
    "index_map": ("m", True),
}
SHARD_DIM = {"u": 4, "w": 12, "m": 12, "s": 40}
SOLVER = dict(max_iters=300, tolerance=1e-14)


def _configs(jax: bool, path: str = "soa", l2s=((1.0, 1.0),), iters: int = 2,
             min_active: int = MIN_ACTIVE):
    """One configuration per (fixed L2, per-user L2) of ``l2s``."""
    fixed, random = (JFixed, JRandom) if jax else (FixedEffectConfig, RandomEffectConfig)
    reg, solver = (JReg, JSolver) if jax else (TReg, SolverConfig)
    config = JConfig if jax else GameConfig
    task = JTask.LOGISTIC_REGRESSION if jax else TASK
    shard, index_map = PATHS[path]
    extra = {}
    if index_map:
        extra["projector"] = (JProjector if jax else ProjectorType).INDEX_MAP
    s = solver(**SOLVER)
    return [config(task=task, num_outer_iterations=iters, coordinates={
        "fixed": fixed(feature_shard="g", solver=s, reg=reg(l2=fl2)),
        "per-user": random(random_effect_type="userId", feature_shard=shard, solver=s,
                           reg=reg(l2=ul2), min_active_samples=min_active, **extra)})
        for fl2, ul2 in l2s]


def _counts(data_, rows=None):
    uids = data_["id_tags"]["userId"] if rows is None else data_["id_tags"]["userId"][rows]
    ids, counts = np.unique(uids, return_counts=True)
    return dict(zip(ids.tolist(), counts.tolist()))


def _prior(data_, path: str, rows=None, compact: bool = False) -> GameModel:
    """A warm-start model on the port's side: random fixed means, and random
    per-user rows for every user whose id is not 1 mod 6 (so about half of
    the under-bound users are new), zero at half the columns on the
    sparse shard (as ``to_compact`` needs them sparse)."""
    rng = np.random.default_rng(9)
    shard = PATHS[path][0]
    covered = [u for u in sorted(_counts(data_, rows)) if u % 6 != 1]
    w = rng.normal(size=(len(covered), SHARD_DIM[shard])) * 0.3
    if shard == "s":
        w *= rng.random(w.shape) < 0.5
    re = RandomEffectModel(w_stack=w, slot_of={u: i for i, u in enumerate(covered)},
                           random_effect_type="userId", feature_shard=shard, task=TASK)
    fixed = FixedEffectModel(coefficients=Coefficients(means=rng.normal(size=6) * 0.3),
                             feature_shard="g", task=TASK)
    return GameModel(models={"fixed": fixed, "per-user": re.to_compact() if compact else re})


def _to_jax(model: GameModel):
    """The JAX package's GameModel of a port model, through the exchange
    dict.  Compact random effects go across densified: the reference's
    host-paced descent scores a prior through its ``w_stack``."""
    model = GameModel(models={cid: (m.to_dense() if hasattr(m, "to_dense") else m)
                              for cid, m in model.models.items()})
    out = {}
    for cid, c in convert.game_model_to_arrays(model).items():
        task = JTask(c["task"])
        if c["kind"] == "fixed":
            out[cid] = jgame.FixedEffectModel(
                coefficients=JCoefficients(means=c["means"], variances=c["variances"]),
                feature_shard=c["feature_shard"], task=task)
        else:
            out[cid] = jgame.RandomEffectModel(
                w_stack=c["w_stack"], slot_of=c["slot_of"], task=task,
                random_effect_type=c["random_effect_type"],
                feature_shard=c["feature_shard"], variances=c["variances"])
    return jgame.GameModel(models=out)


def _to_port(jmodel) -> GameModel:
    """The port's GameModel of a JAX model (dense random effects)."""
    arrays = {}
    for cid, m in jmodel.models.items():
        base = dict(feature_shard=m.feature_shard, task=m.task.value)
        if isinstance(m, jgame.FixedEffectModel):
            arrays[cid] = dict(base, kind="fixed", means=np.asarray(m.coefficients.means))
        else:
            arrays[cid] = dict(base, kind="random", w_stack=np.asarray(m.w_stack),
                               slot_of=m.slot_of, random_effect_type=m.random_effect_type)
    return convert.game_model_from_arrays(arrays)


def _fit(side: str, data_, configs, rows=None, val_rows=None, **kw):
    """``GameEstimator.fit`` on one side ("jax" or "port") in float64, with
    validation by SPECS on ``val_rows`` where given; port models in ``kw``
    are carried to the JAX side."""
    jax = side == "jax"
    val = None if val_rows is None else _game_data(data_, jax, val_rows)
    if jax:
        kw = {k: (_to_jax(v) if isinstance(v, GameModel) else v) for k, v in kw.items()}
        if kw.get("resume_best") is not None:
            m, ev = kw["resume_best"]
            kw["resume_best"] = (_to_jax(m), ev)
        suite = None if val is None else JSuite.from_specs(SPECS)
        est = JEstimator(fused=False, dtype=np.float64, validation_suite=suite)
    else:
        suite = None if val is None else TSuite.from_specs(SPECS)
        est = GameEstimator(device="cpu", dtype=torch.float64, validation_suite=suite)
    return est.fit(_game_data(data_, jax, rows), configs, validation_data=val, **kw)


def _assert_models_close(t, j, rtol=FIT_RTOL):
    """A port model against a JAX one: the same coordinates (a save before
    a cold coordinate's first update lacks it), fixed means and the
    per-user stack (same entities) within ``rtol``."""
    assert set(t.models) == set(j.models)
    assert _rel(t["fixed"].coefficients.means, j["fixed"].coefficients.means) <= rtol
    if "per-user" not in j:
        return
    jre = j["per-user"]
    assert t["per-user"].slot_of == jre.slot_of
    assert _rel(t["per-user"].w_stack, jre.w_stack) <= rtol


def _carried_users(data_, prior: GameModel, rows=None):
    """The under-bound users that ``prior`` covers, and the new ones."""
    slot_of = prior["per-user"].slot_of
    under = [u for u, c in _counts(data_, rows).items() if c < MIN_ACTIVE]
    return [u for u in under if u in slot_of], [u for u in under if u not in slot_of]


def _dense_row(model, uid):
    m = model.to_dense() if hasattr(model, "to_dense") else model
    return m.w_stack[m.slot_of[uid]]


# -- the lower bound's keys ----------------------------------------------------


@pytest.mark.parametrize("keys", ["none", "empty", "some", "all"])
@pytest.mark.parametrize("cap", [None, 6])
@pytest.mark.parametrize("min_active", [1, 4, 9])
def test_group_rows_with_keys_matches_reference(min_active, cap, keys):
    """Kept rows, entities and weight rescales bitwise equal to the
    reference's, with and without a warm start's ids."""
    rng = np.random.default_rng(min_active * 10 + (cap or 0))
    ids = rng.permutation(np.repeat(np.arange(30) * 7, rng.integers(1, 14, 30)))
    key_set = {"none": None, "empty": frozenset(),
               "some": frozenset(int(u) for u in np.arange(0, 30 * 7, 14)),
               "all": frozenset(int(u) for u in np.arange(30) * 7)}[keys]
    got = _group_rows(ids, cap, min_active, 5, key_set)
    want = j_group_rows(ids, cap, min_active, 5, existing_model_keys=key_set)
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[0]) == len(want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    counts = dict(zip(*np.unique(ids, return_counts=True)))
    expect = [int(u) for u, c in sorted(counts.items())
              if c >= min_active or (key_set is not None and int(u) not in key_set)]
    assert got[1] == expect


@pytest.mark.parametrize("path", ["soa", "sparse", "index_map"])
def test_lane_of_with_keys_matches_reference(data, path):
    """The dense (IDENTITY), sparse and INDEX_MAP builds keep every user at
    or over the bound and every under-bound user the keys do not cover; the
    directory is the reference's, and a rebind keeps keys and directory."""
    prior = _prior(data, path)
    keys = frozenset(prior["per-user"].slot_of)
    tcfg, jcfg = _configs(False, path)[0], _configs(True, path)[0]
    coord = build_coordinate("per-user", _game_data(data, False), tcfg.coordinates["per-user"],
                             TASK, dtype=torch.float64, device="cpu",
                             existing_model_keys=keys)
    jcoord = j_build_coordinate("per-user", _game_data(data, True),
                                jcfg.coordinates["per-user"], JTask.LOGISTIC_REGRESSION,
                                dtype=np.float64, existing_model_keys=keys)
    assert coord.buckets.lane_of == jcoord.buckets.lane_of
    carried, new = _carried_users(data, prior)
    assert carried and new
    lanes = set(coord.buckets.lane_of)
    assert lanes == set(_counts(data)) - set(carried) and set(new) <= lanes
    cold = build_coordinate("per-user", _game_data(data, False), tcfg.coordinates["per-user"],
                            TASK, dtype=torch.float64, device="cpu")
    assert set(cold.buckets.lane_of) == lanes - set(new)
    rebound = coord.rebind(dataclasses.replace(tcfg.coordinates["per-user"],
                                               reg=TReg(l2=0.5)))
    assert rebound.existing_model_keys == keys
    assert rebound.buckets.lane_of == coord.buckets.lane_of


def test_rebound_keys_equal_a_fresh_build_with_them(data):
    """A coordinate built with keys and rebound updates bitwise as a fresh
    build of the new configuration with the same keys."""
    prior = _prior(data, "lanes")
    keys = frozenset(prior["per-user"].slot_of)
    cfg = _configs(False, "lanes")[0].coordinates["per-user"]
    new_cfg = dataclasses.replace(cfg, reg=TReg(l2=0.25))
    build = lambda c: build_coordinate("per-user", _game_data(data, False), c, TASK,
                                       dtype=torch.float64, device="cpu",
                                       existing_model_keys=keys)
    rebound, fresh = build(cfg).rebind(new_cfg), build(new_cfg)
    offsets = torch.from_numpy(data["offset"]) * 2.0
    got, _ = rebound.update(offsets, seed=1, init=prior["per-user"])
    want, _ = fresh.update(offsets, seed=1, init=prior["per-user"])
    assert got.slot_of == want.slot_of
    np.testing.assert_array_equal(got.w_stack, want.w_stack)


@pytest.mark.parametrize("prior_kind", ["dense", "compact"])
def test_three_entity_lower_bound_case(prior_kind):
    """The reference's case (tests/test_game.py::
    test_lower_bound_existing_model_semantics): entity 0 has 16 rows, 1 and 2
    two each under a bound of 4; the prior covers 0 and 1.  Cold, the
    under-bound entities are dropped; warm, entity 1 passes through bitwise
    and scores with its prior row, entity 2 trains; the estimator's fit
    matches the JAX package's, the carried row bitwise."""
    rng = np.random.default_rng(0)
    d = 4
    uids = np.concatenate([np.zeros(16), np.ones(2), np.full(2, 2)]).astype(np.int64)
    n = len(uids)
    x, y = rng.normal(size=(n, d)), (rng.random(n) > 0.5).astype(np.float64)
    cfg = dict(random_effect_type="userId", feature_shard="u", min_active_samples=4)
    tcfg = RandomEffectConfig(solver=SolverConfig(max_iters=20), reg=TReg(l2=1.0), **cfg)
    jcfg = JRandom(solver=JSolver(max_iters=20), reg=JReg(l2=1.0), **cfg)
    prior_w = np.asarray([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    re = RandomEffectModel(w_stack=prior_w, slot_of={0: 0, 1: 1}, random_effect_type="userId",
                           feature_shard="u", task=TASK)
    prior = GameModel(models={"user": re.to_compact() if prior_kind == "compact" else re})
    tdata = GameData(y=y, features={"u": x}, id_tags={"userId": uids})
    jdata = JData(y=y, features={"u": x}, id_tags={"userId": uids})

    est = GameEstimator(device="cpu", dtype=torch.float64)
    cold = est.build_one_coordinate("user", tdata, tcfg, TASK)
    m_cold, _ = cold.update(torch.zeros(n, dtype=torch.float64))
    assert set(m_cold.slot_of) == {0}
    warm = est.build_one_coordinate("user", tdata, tcfg, TASK, initial_model=prior)
    assert set(warm.buckets.lane_of) == {0, 2}
    m_warm, _ = warm.update(torch.zeros(n, dtype=torch.float64), init=prior["user"])
    assert set(m_warm.slot_of) == {0, 1, 2}
    np.testing.assert_array_equal(m_warm.w_stack[m_warm.slot_of[1]], prior_w[1])
    assert np.abs(m_warm.w_stack[m_warm.slot_of[0]] - prior_w[0]).max() > 1e-3
    np.testing.assert_allclose(warm.score(m_warm).numpy()[16:18], x[16:18] @ prior_w[1],
                               rtol=1e-12)

    config = dict(task=TASK, coordinates={"user": tcfg})
    res = est.fit(tdata, [GameConfig(**config)], initial_model=prior)[0].model["user"]
    jres = JEstimator(fused=False, dtype=np.float64).fit(
        jdata, [JConfig(task=JTask.LOGISTIC_REGRESSION, coordinates={"user": jcfg})],
        initial_model=_to_jax(prior))[0].model["user"]
    assert res.slot_of == jres.slot_of and set(res.slot_of) == {0, 1, 2}
    assert _rel(res.w_stack, jres.w_stack) <= FIT_RTOL
    np.testing.assert_array_equal(res.w_stack[res.slot_of[1]], prior_w[1])


# -- warm starts and locked coordinates -----------------------------------------


@pytest.mark.parametrize("path", list(PATHS))
def test_warm_start_fit_matches_jax(data, path):
    """A two-sweep fit warm-started from a prior that covers about half of
    the under-bound users: the models match the JAX package's, the covered
    under-bound users' rows are the prior's bitwise, the new ones trained."""
    prior = _prior(data, path, compact=path == "sparse")
    t = _fit("port", data, _configs(False, path), initial_model=prior)[0].model
    j = _fit("jax", data, _configs(True, path), initial_model=prior)[0].model
    _assert_models_close(t, j)
    carried, new = _carried_users(data, prior)
    for u in carried:
        np.testing.assert_array_equal(t["per-user"].w_stack[t["per-user"].slot_of[u]],
                                      _dense_row(prior["per-user"], u))
    for u in new:
        assert np.abs(t["per-user"].w_stack[t["per-user"].slot_of[u]]).max() > 1e-6


@pytest.mark.parametrize("locked", ["fixed", "per-user"])
def test_locked_fit_matches_jax(data, locked):
    """A coordinate locked to the prior is only scored: its model is the
    prior's object; the other trains as in the JAX package, and with
    validation the best full model is retained after the last unlocked
    update (the fixed effect's when the per-user one is locked)."""
    train, val = _halves(data)
    prior = _prior(data, "soa", rows=train)
    saves = {"port": [], "jax": []}
    kw = dict(rows=train, val_rows=val, initial_model=prior, locked_coordinates={locked})
    (t,) = _fit("port", data, _configs(False), checkpoint_hook=lambda m, c, **h:
                saves["port"].append((c, h["updated"], h["best"] is None, h["best_changed"])),
                **kw)
    (j,) = _fit("jax", data, _configs(True), checkpoint_hook=lambda m, c, **h:
                saves["jax"].append((c, h["updated"], h["best"] is None, h["best_changed"])),
                **kw)
    # a sweep is complete after its one unlocked update: best from the first
    assert saves["port"] == saves["jax"]
    assert [b for _, _, b, _ in saves["port"]] == [False, False]
    assert saves["port"][0][3]
    assert t.model[locked] is prior[locked]
    _assert_models_close(t.model, _to_port(j.model))
    assert [s["coordinate"] for s in t.history.steps] == \
        [s["coordinate"] for s in j.history.steps] == [c for c in ("fixed", "per-user")
                                                       if c != locked] * 2
    for k, v in j.evaluation.values.items():
        assert abs(t.evaluation.values[k] - v) <= FIT_RTOL * abs(v)


def test_locked_coordinate_errors(data):
    """The reference's two ValueErrors: a locked id that is not a
    coordinate, and a locked coordinate without an initial model."""
    coords = {"fixed": build_coordinate("fixed", _game_data(data, False),
                                        _configs(False)[0].coordinates["fixed"], TASK,
                                        dtype=torch.float64, device="cpu")}
    with pytest.raises(ValueError, match="locked coordinates not present"):
        CoordinateDescent(coords, locked={"per-user"})
    with pytest.raises(ValueError, match="locked coordinate 'fixed' needs an initial model"):
        CoordinateDescent(coords, locked={"fixed"}).run(torch.device("cpu"))
    with pytest.raises(ValueError, match="needs an initial model"):
        GameEstimator(device="cpu", dtype=torch.float64).fit(
            _game_data(data, False), _configs(False), locked_coordinates={"fixed"})


# -- checkpoints and resume -------------------------------------------------------

GRID_L2 = ((4.0, 4.0), (1.0, 1.0), (0.25, 0.25))


def _hooked(side: str, data_, **kw):
    """(results, saves) of the three-point grid on one side with validation
    and a hook that keeps every (model, cursor, keywords)."""
    train, val = _halves(data_)
    saves = []
    hook = lambda m, cur, **h: saves.append((m, dict(cur), h))
    res = _fit(side, data_, _configs(side == "jax", l2s=GRID_L2), rows=train, val_rows=val,
               checkpoint_hook=hook, **kw)
    return res, saves


@pytest.fixture(scope="module")
def runs(data):
    """``runs(side)``: the uninterrupted hooked grid on that side, once."""
    cache = {}

    def get(side):
        if side not in cache:
            cache[side] = _hooked(side, data)
        return cache[side]

    return get


def _cursor_rule(num_configs: int, num_iters: int, order):
    """The reference's cursors: after update (ci, it, k) the next one's."""
    out = []
    for ci in range(num_configs):
        for it in range(num_iters):
            for k in range(len(order)):
                nxt = (it, k + 1) if k + 1 < len(order) else (it + 1, 0)
                out.append({"config": ci, "iteration": nxt[0], "coordinate": nxt[1]})
    return out


def test_checkpoint_hook_sequence_matches_jax(runs):
    """3 configurations x 2 sweeps x 2 coordinates = 12 saves with the
    reference's cursors, ``updated`` None on each configuration's first save
    and the coordinate otherwise, ``best`` None until a configuration's first
    complete sweep, and ``best_changed`` as in the JAX package; the saved
    models match the JAX package's."""
    tres, tsaves = runs("port")
    jres, jsaves = runs("jax")
    assert len(tsaves) == len(jsaves) == 12
    assert [c for _, c, _ in tsaves] == [c for _, c, _ in jsaves] == \
        _cursor_rule(3, 2, ["fixed", "per-user"])
    keys = lambda saves: [(h["updated"], h["best"] is None, h["best_changed"])
                          for _, _, h in saves]
    assert keys(tsaves) == keys(jsaves)
    assert [h["updated"] for _, _, h in tsaves] == \
        [None, "per-user", "fixed", "per-user"] * 3
    assert [h["best"] is None for _, _, h in tsaves] == [True, False, False, False] * 3
    for (tm, _, th), (jm, _, jh) in zip(tsaves, jsaves):
        _assert_models_close(tm, _to_port(jm))
        if th["best"] is not None:
            assert abs(th["best"][1].primary - jh["best"][1].primary) <= \
                FIT_RTOL * abs(jh["best"][1].primary)
    for t, j in zip(tres, jres):
        _assert_models_close(t.model, _to_port(j.model))


@pytest.mark.parametrize("crash", [2, 6, 7, 9])
def test_resume_matches_the_uninterrupted_run_and_jax(data, runs, crash):
    """Resume from save ``crash`` (its model, cursor and best): the
    configurations before the cursor's are left out, and every later result
    matches the uninterrupted run's within RESUME_RTOL and the JAX
    package's resume within rtol 1e-6; the resumed configuration's primary
    metric is at least the checkpointed best's."""
    tres, tsaves = runs("port")
    model, cursor, h = tsaves[crash]
    kw = dict(initial_model=model, resume_cursor=cursor, resume_best=h["best"])
    t, tsaves2 = _hooked("port", data, **kw)
    j, _ = _hooked("jax", data, **kw)
    assert len(t) == len(j) == 3 - cursor["config"]
    assert [c for _, c, _ in tsaves2] == [c for _, c, _ in tsaves[crash + 1:]]
    for a, b, c in zip(t, tres[cursor["config"]:], j):
        assert _rel(a.model["fixed"].coefficients.means,
                    b.model["fixed"].coefficients.means) <= RESUME_RTOL
        assert a.model["per-user"].slot_of == b.model["per-user"].slot_of
        assert _rel(a.model["per-user"].w_stack, b.model["per-user"].w_stack) <= RESUME_RTOL
        _assert_models_close(a.model, _to_port(c.model))
    if h["best"] is not None:
        assert t[0].evaluation.primary >= h["best"][1].primary - 1e-12


def test_resume_at_a_configuration_boundary(data, runs):
    """A cursor past a configuration's last update ({"iteration":
    num_iters, "coordinate": 0}) skips all of its updates: without a best it
    returns the model built from ``initial``, with one the best; the next
    configuration runs from there, as in the JAX package."""
    tres, tsaves = runs("port")
    model, _, h = tsaves[3]  # configuration 0's last save
    cursor = {"config": 0, "iteration": 2, "coordinate": 0}
    for best in (None, h["best"]):
        kw = dict(initial_model=model, resume_cursor=cursor, resume_best=best)
        t, saves = _hooked("port", data, **kw)
        j, _ = _hooked("jax", data, **kw)
        assert len(t) == len(j) == 3
        assert [c["config"] for _, c, _ in saves] == [1] * 4 + [2] * 4
        expect = model if best is None else best[0]
        assert t[0].model.models == expect.models
        assert (t[0].evaluation is None) == (best is None)
        for a, b in zip(t, j):
            _assert_models_close(a.model, _to_port(b.model))
    for a, b in zip(t[1:], tres[1:]):
        np.testing.assert_allclose(a.model["per-user"].w_stack, b.model["per-user"].w_stack,
                                   rtol=RESUME_RTOL, atol=0)


def test_resume_does_not_feed_the_lower_bound(data, monkeypatch):
    """Only a warm start feeds the lower bound: a resume of a cold fit
    builds without keys, so an under-bound user, absent from the
    checkpoint, stays out of the lanes as in the uninterrupted run (were the
    checkpoint's ids the keys, the user would be new and would train), and
    the results match the uninterrupted run and the JAX package's resume."""
    keys_seen = []
    real = est_mod.build_coordinate

    def spy(cid, *args, **kw):
        keys_seen.append((cid, kw.get("existing_model_keys")))
        return real(cid, *args, **kw)

    monkeypatch.setattr(est_mod, "build_coordinate", spy)
    saves = []
    hook = lambda m, cur, **h: saves.append((m, dict(cur), h))
    full = _fit("port", data, _configs(False), checkpoint_hook=hook)
    model, cursor, h = saves[1]
    under = [u for u, c in _counts(data).items() if c < MIN_ACTIVE]
    assert under and not set(under) & set(model["per-user"].slot_of)
    keys_seen.clear()
    kw = dict(initial_model=model, resume_cursor=cursor, resume_best=h["best"])
    t = _fit("port", data, _configs(False), **kw)
    assert keys_seen == [("fixed", None), ("per-user", None)]
    assert not set(under) & set(t[0].model["per-user"].slot_of)
    assert _rel(t[0].model["per-user"].w_stack, full[0].model["per-user"].w_stack) \
        <= RESUME_RTOL
    j = _fit("jax", data, _configs(True), **kw)
    _assert_models_close(t[0].model, _to_port(j[0].model))
    # a warm start with the same model does feed it: its ids are the keys
    keys_seen.clear()
    _fit("port", data, _configs(False), initial_model=model)
    assert keys_seen[1] == ("per-user", frozenset(model["per-user"].slot_of))


def test_resume_of_a_warm_start_matches_jax(data):
    """A resume of a warm-started fit builds without keys too, as the
    reference does: an under-bound user new to the prior, which the
    uninterrupted run trains, is carried from the checkpoint bitwise (the
    reference's resume is not the uninterrupted run here; ROADMAP.md §1
    records it), and the resume matches the JAX package's."""
    prior = _prior(data, "soa")
    saves = []
    hook = lambda m, cur, **h: saves.append((m, dict(cur), h))
    full = _fit("port", data, _configs(False), initial_model=prior, checkpoint_hook=hook)
    model, cursor, h = saves[1]
    kw = dict(initial_model=model, resume_cursor=cursor, resume_best=h["best"])
    t = _fit("port", data, _configs(False), **kw)[0].model
    j = _fit("jax", data, _configs(True), **kw)[0].model
    _assert_models_close(t, _to_port(j))
    _, new = _carried_users(data, prior)
    ckpt, res, uninterrupted = model["per-user"], t["per-user"], full[0].model["per-user"]
    for u in new:
        np.testing.assert_array_equal(res.w_stack[res.slot_of[u]],
                                      ckpt.w_stack[ckpt.slot_of[u]])
        assert not np.array_equal(uninterrupted.w_stack[uninterrupted.slot_of[u]],
                                  ckpt.w_stack[ckpt.slot_of[u]])
