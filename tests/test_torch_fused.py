"""The port's ``FusedSweep`` and the estimator's fused dispatch against the
JAX package, on the CPU.

- Fits through ``GameEstimator()`` (``fused="auto"``) on every coordinate
  path (SoA Newton, lane L-BFGS, TRON, OWLQN, sparse shards on compact
  lanes, a compact warm start with carried entities, INDEX_MAP) against
  the JAX package's ``GameEstimator(fused=True)`` within FUSED_RTOL, and
  bitwise equal to the port's own ``fused=False`` fit.
- ``FusedSweep.run`` against ``CoordinateDescent.run`` on the same
  coordinates, cold and warm started; variances; λ grids (one sweep reused
  per regime, another at the L1 switch, each point's λ in its variances);
  down-sampling (bitwise the host loop's draws; against the reference's
  fused fit by the reference's own statistic); the dispatch's refusals
  (the validated form is tests/test_torch_fused_validated.py's); and no
  design among the solvers' replayed arguments.

Everything runs in float64 on numpy inputs drawn from a seed, with the
solvers run to the float64 plateau (tolerance 1e-14), as
tests/test_torch_estimator_surface.py does.  The mirrored reference tests
are in tests/test_game.py (``test_fused_*``, ``test_estimator_fused_auto_*``,
``test_reg_grid_reuses_compiled_programs``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import ProjectorType as JProjector
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, FusedSweep, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game import estimator as est_mod
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.models import game as tgame
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.opt import lbfgs, newton_soa, tron
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

FUSED_RTOL = 1e-6
TASK = TaskType.LOGISTIC_REGRESSION
MIN_ACTIVE = 9
SOLVER = dict(max_iters=300, tolerance=1e-14)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def data():
    """24 users with 2..24 rows (four under MIN_ACTIVE), ids 3u + 1 in
    shuffled order; a fixed design "g" (column 0 an intercept) and per-user
    designs "u" (d 4: the SoA gate), "w" (d 10: lanes), "m" (d 10, each
    user observing about 7 columns: INDEX_MAP) and "s" (sparse, 30 columns,
    4 a row: compact lanes)."""
    rng = np.random.default_rng(61)
    users = 24
    uids = rng.permutation(np.repeat(np.arange(users) * 3 + 1, rng.integers(2, 25, users)))
    n = len(uids)
    xg = rng.normal(size=(n, 5))
    xg[:, 0] = 1.0
    xu, xw = rng.normal(size=(n, 4)), rng.normal(size=(n, 10))
    xm = rng.normal(size=(n, 10)) * (rng.random((users * 3 + 1, 10)) < 0.7)[uids]
    z = (xg[:, 1:] @ rng.normal(size=4) + np.einsum(
        "nd,nd->n", xu, rng.normal(size=(users * 3 + 1, 4))[uids]))
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return dict(y=y, offset=rng.normal(size=n) * 0.05, weight=rng.random(n) + 0.5,
                features={"g": xg, "u": xu, "w": xw, "m": xm},
                sparse=dict(indices=rng.integers(0, 30, size=(n, 4)),
                            values=rng.normal(size=(n, 4)), dim=30),
                id_tags={"userId": uids})


def _game_data(d, jax: bool):
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
    "compact": ("s", "LBFGS", 0.0, 0.0, False),  # + a compact warm start
    "index_map": ("m", "LBFGS", 0.0, 0.0, True),
}


def _config(jax: bool, path: str = "soa", l2=(1.0, 1.0), iters: int = 2,
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


def _under_bound(d):
    """The users under MIN_ACTIVE: (those a prior covers, the new ones)."""
    ids, counts = np.unique(d["id_tags"]["userId"], return_counts=True)
    under = ids[counts < MIN_ACTIVE].tolist()
    return under[1::2], under[::2]


def _prior(d, shard: str, compact: bool = False) -> tgame.GameModel:
    """A warm start on the port's side: random fixed means and per-user
    rows for every user but every other under-bound one (so under-bound
    users are carried and others new), half zero on the sparse shard."""
    rng = np.random.default_rng(5)
    dim = {"u": 4, "w": 10, "m": 10, "s": 30}[shard]
    new = set(_under_bound(d)[1])
    covered = [u for u in sorted(set(d["id_tags"]["userId"].tolist())) if u not in new]
    w = rng.normal(size=(len(covered), dim)) * 0.3
    if shard == "s":
        w *= rng.random(w.shape) < 0.5
    re = tgame.RandomEffectModel(w_stack=w, slot_of={u: i for i, u in enumerate(covered)},
                                 random_effect_type="userId", feature_shard=shard, task=TASK)
    fixed = tgame.FixedEffectModel(coefficients=Coefficients(means=rng.normal(size=5) * 0.3),
                                   feature_shard="g", task=TASK)
    return tgame.GameModel(models={"fixed": fixed,
                                   "per-user": re.to_compact() if compact else re})


def _to_jax(model):
    """The JAX package's GameModel of a port model (random effects dense)."""
    from photon_ml_tpu.models import game as jgame
    from photon_ml_tpu.models.glm import Coefficients as JCoefficients

    model = tgame.GameModel(models={cid: (m.to_dense() if hasattr(m, "to_dense") else m)
                                    for cid, m in model.models.items()})
    out = {}
    for cid, c in convert.game_model_to_arrays(model).items():
        task = JTask(c["task"])
        if c["kind"] == "fixed":
            out[cid] = jgame.FixedEffectModel(coefficients=JCoefficients(means=c["means"]),
                                              feature_shard=c["feature_shard"], task=task)
        else:
            out[cid] = jgame.RandomEffectModel(
                w_stack=c["w_stack"], slot_of=c["slot_of"], task=task,
                random_effect_type=c["random_effect_type"], feature_shard=c["feature_shard"])
    return jgame.GameModel(models=out)


def _port(d, configs, **kw):
    return GameEstimator(device="cpu", dtype=torch.float64, **kw.pop("est", {})).fit(
        _game_data(d, False), configs, **kw)


def _assert_bitwise(a, b):
    """Two port models: the same coordinates, entities, coefficients and
    variances, bit for bit."""
    assert set(a.models) == set(b.models)
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


def _assert_close_to_jax(t, j, rtol=FUSED_RTOL):
    assert _rel(t["fixed"].coefficients.means, j["fixed"].coefficients.means) <= rtol
    assert t["per-user"].slot_of == j["per-user"].slot_of
    assert _rel(t["per-user"].w_stack, j["per-user"].w_stack) <= rtol


@pytest.mark.parametrize("path", list(PATHS))
def test_fused_fit_matches_jax_fused_and_the_host_loop(data, path):
    """``GameEstimator()`` runs the sweep (an empty history), within
    FUSED_RTOL of the JAX package's ``fused=True`` fit and bitwise equal to
    the port's ``fused=False`` fit.  "compact" warm-starts the sparse path
    from a compact prior that leaves under-bound users to carry through."""
    kw = {}
    if path == "compact":
        kw["initial_model"] = _prior(data, "s", compact=True)
    (fused,) = _port(data, [_config(False, path)], **kw)
    (host,) = _port(data, [_config(False, path)], est=dict(fused=False), **kw)
    assert fused.history.steps == [] and len(host.history.steps) == 4
    _assert_bitwise(fused.model, host.model)
    jkw = {k: _to_jax(v) for k, v in kw.items()}
    j = JEstimator(fused=True, dtype=np.float64).fit(_game_data(data, True),
                                                     [_config(True, path)], **jkw)[0]
    _assert_close_to_jax(fused.model, j.model)


def _coords(d, config):
    return {cid: build_coordinate(cid, _game_data(d, False), c, TASK, dtype=torch.float64,
                                  device="cpu")
            for cid, c in config.coordinates.items()}


def test_fused_sweep_matches_host_descent(data):
    """``FusedSweep.run`` and ``CoordinateDescent.run`` over the same
    coordinates, three sweeps: bitwise the same model, and final scores
    (float64 tensors) equal to the model's own re-scoring."""
    config = _config(False, "lanes", iters=3)
    coords = _coords(data, config)
    host, _, _ = CoordinateDescent(coords, num_iterations=3).run(torch.device("cpu"))
    fused, scores = FusedSweep(coords, num_iterations=3).run()
    _assert_bitwise(fused, host)
    for cid, coord in coords.items():
        assert scores[cid].dtype == torch.float64
        torch.testing.assert_close(scores[cid], coord.score(fused[cid]).double(), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("path", ["soa", "sparse", "index_map"])
def test_fused_warm_start_with_carried_entities(data, path):
    """A warm start whose under-bound covered users carry through: the
    sweep's fit bitwise the host loop's (the carried rows the prior's), and
    a second run of the same sweep from a fitted model bitwise the host
    loop's from it."""
    shard = PATHS[path][0]
    prior = _prior(data, shard)
    config = _config(False, path)
    (fused,) = _port(data, [config], initial_model=prior)
    (host,) = _port(data, [config], initial_model=prior, est=dict(fused=False))
    _assert_bitwise(fused.model, host.model)
    keys = frozenset(prior["per-user"].slot_of)
    carried, new = _under_bound(data)
    assert len(carried) == len(new) == 2
    assert set(new) <= set(fused.model["per-user"].slot_of)
    re = fused.model["per-user"]
    for u in carried:
        np.testing.assert_array_equal(re.w_stack[re.slot_of[u]],
                                      prior["per-user"].w_stack[prior["per-user"].slot_of[u]])
    coords = {cid: build_coordinate(cid, _game_data(data, False), c, TASK,
                                    dtype=torch.float64, device="cpu",
                                    existing_model_keys=keys if cid == "per-user" else None)
              for cid, c in config.coordinates.items()}
    sweep = FusedSweep(coords, num_iterations=2)
    again, _ = sweep.run(initial=fused.model)
    h2, _, _ = CoordinateDescent(coords, num_iterations=2).run(torch.device("cpu"),
                                                               initial=fused.model)
    _assert_bitwise(again, h2)


def test_fused_variances_match_host_and_jax(data):
    """SIMPLE fixed and FULL per-user variances, computed by the sweep at
    the last iteration only: bitwise the host loop's, within FUSED_RTOL of
    the JAX package's fused fit."""
    over = dict(fixed_kw=dict(variance=VarianceComputationType.SIMPLE),
                user_kw=dict(variance=VarianceComputationType.FULL))
    (fused,) = _port(data, [_config(False, "lanes", **over)])
    (host,) = _port(data, [_config(False, "lanes", **over)], est=dict(fused=False))
    _assert_bitwise(fused.model, host.model)
    jover = dict(fixed_kw=dict(variance=JVar.SIMPLE), user_kw=dict(variance=JVar.FULL))
    j = JEstimator(fused=True, dtype=np.float64).fit(
        _game_data(data, True), [_config(True, "lanes", **jover)])[0].model
    assert _rel(fused.model["fixed"].coefficients.variances,
                j["fixed"].coefficients.variances) <= FUSED_RTOL
    assert _rel(fused.model["per-user"].variances, j["per-user"].variances) <= FUSED_RTOL


def _count_sweeps(monkeypatch):
    built = []
    real = est_mod.FusedSweep

    def counted(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(est_mod, "FusedSweep", counted)
    return built


@pytest.mark.parametrize("variance", ["none", "simple"])
def test_reg_grid_reuses_one_sweep(data, variance, monkeypatch):
    """A λ grid over the same data and solvers runs one sweep (the
    reference compiles one program); each point bitwise the host loop's,
    its variances at its own λ, and the points differ."""
    kind = VarianceComputationType(variance)
    grid = [_config(False, "soa", l2=(l2, l2), iters=1,
                    fixed_kw=dict(variance=kind), user_kw=dict(variance=kind))
            for l2 in (0.1, 1.0, 10.0)]
    built = _count_sweeps(monkeypatch)
    fused = _port(data, grid)
    assert len(built) == 1
    host = _port(data, grid, est=dict(fused=False))
    for f, h in zip(fused, host):
        _assert_bitwise(f.model, h.model)
    w = [r.model["fixed"].coefficients.means for r in fused]
    assert not np.allclose(w[0], w[2], atol=1e-3)
    if kind != VarianceComputationType.NONE:
        v = [r.model["fixed"].coefficients.variances for r in fused]
        assert not np.allclose(v[0], v[2], rtol=1e-2)


def test_fused_grid_l1_regime_switch(data, monkeypatch):
    """A point that crosses into L1 builds a second sweep; both points equal
    the host loop's bitwise and the JAX package's fused fits within
    FUSED_RTOL, and the L1 point has zeros."""
    def grid(jax):
        base = _config(jax, "lanes", iters=1)
        reg = JReg if jax else TReg
        fixed = base.coordinates["fixed"]
        cfg = JConfig if jax else GameConfig
        return [cfg(task=base.task, num_outer_iterations=1, coordinates={
            "fixed": dataclasses.replace(fixed, reg=r)})
            for r in (reg(l2=1.0), reg(l1=2.0), reg(l1=1.5))]

    built = _count_sweeps(monkeypatch)
    fused = _port(data, grid(False))
    assert len(built) == 2
    host = _port(data, grid(False), est=dict(fused=False))
    jres = JEstimator(fused=True, dtype=np.float64).fit(_game_data(data, True), grid(True))
    for f, h, j in zip(fused, host, jres):
        _assert_bitwise(f.model, h.model)
        assert _rel(f.model["fixed"].coefficients.means,
                    j.model["fixed"].coefficients.means) <= FUSED_RTOL
    assert (fused[1].model["fixed"].coefficients.means == 0).any()


def test_fused_down_sampling(data):
    """The sweep draws the host loop's masks: a down-sampled fused fit is
    bitwise the host loop's.  Against the reference's fused fit, whose
    draws come from another stream, the reference's own statistic
    (tests/test_game.py:822-860): not equal, but within rtol 0.35, atol
    0.15; the same seed reproduces and another varies."""
    over = dict(fixed_kw=dict(down_sampling_rate=0.8))
    config = _config(False, "soa", **over)
    (fused,) = _port(data, [config], seed=3)
    (host,) = _port(data, [config], seed=3, est=dict(fused=False))
    _assert_bitwise(fused.model, host.model)
    w_fused = fused.model["fixed"].coefficients.means
    j = JEstimator(fused=True, dtype=np.float64).fit(
        _game_data(data, True), [_config(True, "soa", **over)], seed=3)[0].model
    w_ref = np.asarray(j["fixed"].coefficients.means)
    assert not np.allclose(w_fused, w_ref, atol=1e-12)
    np.testing.assert_allclose(w_fused, w_ref, rtol=0.35, atol=0.15)
    sweep = FusedSweep(_coords(data, config), num_iterations=2)
    m1, m2, m3 = (sweep.run(seed=s)[0] for s in (3, 3, 4))
    _assert_bitwise(m1, m2)
    _assert_bitwise(m1, fused.model)
    assert not np.array_equal(m1["fixed"].coefficients.means, m3["fixed"].coefficients.means)


def test_dispatch_refusals(data):
    """``fused=True`` with per-update host work raises the reference's
    ValueError; with a validation suite, ``fused=True`` and ``"auto"`` run
    the validated sweep (an empty history, the evaluation the host loop's);
    the default is ``"auto"``."""
    config = _config(False, "soa", iters=1)
    gd = _game_data(data, False)
    est = GameEstimator(device="cpu", dtype=torch.float64, fused=True)
    with pytest.raises(ValueError, match="per-update host work"):
        est.fit(gd, [config], checkpoint_hook=lambda m, cur, **kw: None)
    with pytest.raises(ValueError, match="per-update host work"):
        est.fit(gd, [config], initial_model=_prior(data, "u"),
                locked_coordinates={"fixed"})
    suite = TSuite.from_specs(["auc"])
    assert GameEstimator(device="cpu").fused == "auto"
    (host,) = GameEstimator(device="cpu", dtype=torch.float64, fused=False,
                            validation_suite=suite).fit(gd, [config], validation_data=gd)
    assert len(host.history.steps) == 2
    for fused in (True, "auto"):
        (r,) = GameEstimator(device="cpu", dtype=torch.float64, fused=fused,
                             validation_suite=suite).fit(gd, [config], validation_data=gd)
        assert r.history.steps == [] and r.evaluation.values == host.evaluation.values
        _assert_bitwise(r.model, host.model)
    assert est.fit(gd, [config])[0].history.steps == []


def test_sweep_refusals(data):
    """An order that is not the ids, and the grid forms, item 8(f)."""
    coords = _coords(data, _config(False, "soa", iters=1))
    with pytest.raises(ValueError):
        FusedSweep(coords, order=["fixed", "fixed"])
    with pytest.raises(ValueError):
        FusedSweep({})
    sweep = FusedSweep(coords)
    for name in ("run_grid", "run_grid_snapshots"):
        with pytest.raises(NotImplementedError) as err:
            getattr(sweep, name)()
        assert "item 8, part (f)" in str(err.value), name


@pytest.mark.parametrize("path", ["soa", "lanes", "tron", "owlqn"])
def test_no_design_among_replayed_arguments(data, path, monkeypatch):
    """The solvers' replayed functions see solver state only (the
    reference's guard against baked design constants, tests/test_game.py:959):
    no tensor argument of a replay shares storage with a design."""
    coords = _coords(data, _config(False, path, iters=1))
    designs = {coords["fixed"]._batch.x.untyped_storage().data_ptr()}
    designs |= {dev["x"].untyped_storage().data_ptr() for dev in coords["per-user"]._dev}
    seen = []

    def spy(fn, *args):
        stack = list(args)
        while stack:
            a = stack.pop()
            if isinstance(a, tuple):
                stack.extend(a)
            elif isinstance(a, torch.Tensor):
                seen.append((fn.__name__, a.untyped_storage().data_ptr()))
        return fn(*args)

    for mod in (lbfgs, tron, newton_soa):
        monkeypatch.setattr(mod, "replay", spy)
    FusedSweep(coords).run()
    assert seen
    assert not [name for name, ptr in seen if ptr in designs]


# -- the lane solvers' replayed bookkeeping -------------------------------------


def _stand_in_capture(fn, leaves, structure, device):
    """``opt/loop._capture`` on the CPU: a "graph" whose replay runs ``fn``
    on the copied inputs and writes its results into the first call's
    output buffers without a version bump, as a CUDA graph's replay
    overwrites its own."""
    from photon_ml_tpu_torch.opt import loop

    leaves = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
    args = loop._unflatten(structure, iter(leaves))
    outputs = fn(*args)

    class Graph:
        def replay(self):
            new, old = [], []
            loop._flatten(fn(*args), new)
            loop._flatten(outputs, old)
            for o, n in zip(old, new):
                o.data.copy_(n)

    return [x for x in leaves if isinstance(x, torch.Tensor)], outputs, Graph()


def _lane_problem(solver: str):
    """A solve over 9 lanes of a random bucket: (solve(w0), w0)."""
    from photon_ml_tpu_torch.core.batch import DenseBatch
    from photon_ml_tpu_torch.core.losses import loss_by_name
    from photon_ml_tpu_torch.core.objective import LaneObjective

    rng = np.random.default_rng(23)
    num_l, cap, d = 9, 12, 5
    x = torch.from_numpy(rng.normal(size=(num_l, cap, d)))
    y = torch.from_numpy((rng.random((num_l, cap)) < 0.4).astype(np.float64))
    off = torch.from_numpy(rng.normal(size=(num_l, cap)) * 0.1)
    wt = torch.from_numpy(rng.random((num_l, cap)) + 0.5)
    l2 = torch.from_numpy(rng.random(num_l) + 0.5)
    loss = loss_by_name("logistic")
    config = SolverConfig(max_iters=30, tolerance=1e-12)
    obj, batch = LaneObjective(loss, l2), DenseBatch(x=x, y=y, offset=off, weight=wt)
    vg = lambda w: obj.value_and_grad(w, batch)
    if solver == "soa":
        xt, yt, ot, wtt = (x.permute(1, 2, 0).contiguous(), y.T.contiguous(),
                           off.T.contiguous(), wt.T.contiguous())
        return (lambda w0: newton_soa.solve_newton_soa(loss, w0.T.contiguous(), xt, yt, ot,
                                                       wtt, l2, config)), num_l, d
    if solver == "tron":
        return (lambda w0: tron.minimize_tron(vg, lambda w, v: obj.hvp(w, batch, v), w0,
                                              config)), num_l, d
    if solver == "owlqn":
        return (lambda w0: lbfgs.minimize_owlqn_lanes(vg, w0, 0.3, config)), num_l, d
    box = None
    if solver == "lbfgs_box":
        box = (torch.full((d,), -0.2, dtype=torch.float64), torch.full((d,), 0.25,
                                                                          dtype=torch.float64))
    return (lambda w0: lbfgs.minimize_lbfgs_lanes(vg, w0, config, box=box)), num_l, d


@pytest.mark.parametrize("solver", ["lbfgs", "lbfgs_box", "owlqn", "tron", "soa"])
def test_replayed_lane_solvers_are_the_plain_ones(solver, monkeypatch):
    """Each lane solver with its bookkeeping replayed from fixed buffers
    (each replay overwrites the last one's outputs) ends bitwise where the
    plain calls do, trackers included, and keeps no graph buffer in its
    result: a second solve leaves the first one's intact."""
    from photon_ml_tpu_torch.opt import loop

    solve, num_l, d = _lane_problem(solver)
    w0 = torch.zeros(num_l, d, dtype=torch.float64)
    plain = solve(w0)
    monkeypatch.setattr(loop, "_replays", lambda t: True)
    monkeypatch.setattr(loop, "_capture", _stand_in_capture)
    monkeypatch.setattr(loop, "_GRAPHS", {})
    replayed = solve(w0)
    fields = ("w", "value", "grad_norm", "iterations", "reason")
    kept = [getattr(replayed, f).clone() for f in fields]
    solve(torch.full((num_l, d), 0.1, dtype=torch.float64))
    assert loop.captured() > 0
    assert int(plain.iterations.max()) > 2
    for f, k in zip(fields, kept):
        assert torch.equal(getattr(replayed, f), getattr(plain, f)), f
        assert torch.equal(getattr(replayed, f), k), f
    if plain.tracker is not None:
        for name in ("values", "grad_norms", "num_states"):
            torch.testing.assert_close(getattr(replayed.tracker, name),
                                       getattr(plain.tracker, name), rtol=0, atol=0,
                                       equal_nan=True)
