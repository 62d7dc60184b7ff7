"""``GameTransformer``, grouped validation and the estimator's refusals of
the PyTorch port against the JAX package, on the CPU in float64.

- ``GameTransformer`` ``score`` / ``predict`` / ``evaluate`` against the
  reference's for the logistic, linear and Poisson tasks, on a model with a
  dense fixed effect and a dense or compact per-user effect on a sparse
  shard, carried across by ``convert.py``; rtol 1e-12 (the two sides sum
  the same products in other orders).
- A two-point grid validated with ``auc:userId`` as the primary, against
  ``GameEstimator(fused=False)``: the same ``best`` index, evaluations
  within 1e-10.
- glmix_sparse (``synth_glmix_sparse(4)``) split inside each user (the last
  8 of its 32 rows validate): the port's held-out AUC within 1e-6 of the
  JAX package's, and the compact model's through the transformer equal to
  the dense model's.
- ``GameEstimator(mesh=...)`` and ``fused=True`` raise NotImplementedError
  naming their ROADMAP items; ``fit`` takes the reference's arguments in
  the reference's positions.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.evaluation.evaluator import EvaluationSuite as JSuite
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import GameTransformer as JTransformer
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models.glm import Coefficients as JCoefficients
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.data import synthetic as tsynth
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, GameTransformer, RandomEffectConfig,
                                      SparseShard)
from photon_ml_tpu_torch.game.scoring import output_scores, raw_scores
from photon_ml_tpu_torch.models.game import CompactRandomEffectModel, GameModel
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import OptimizerType, TaskType

RTOL = 1e-12
TASKS = {
    "logistic": (TaskType.LOGISTIC_REGRESSION, JTask.LOGISTIC_REGRESSION),
    "linear": (TaskType.LINEAR_REGRESSION, JTask.LINEAR_REGRESSION),
    "poisson": (TaskType.POISSON_REGRESSION, JTask.POISSON_REGRESSION),
}
SPECS = ["auc", "aupr", "rmse", "logistic_loss", "poisson_loss", "squared_loss",
         "smoothed_hinge_loss", "precision@5", "auc:userId", "rmse:userId",
         "precision@2:userId", "aupr:itemId"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _scoring_data(task: str, seed: int = 3):
    """150 rows: a dense fixed shard "g" (d 5), a sparse per-user shard "s"
    (dim 20, 4 slots a row), unsorted user ids of which 3 have no model, an
    item id, offsets and weights (some 0), labels of the task."""
    rng = np.random.default_rng(seed)
    n = 150
    uids = rng.integers(0, 15, size=n) * 5 + 2
    z = rng.normal(size=n)
    y = {"logistic": (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64),
         "linear": z + rng.normal(size=n),
         "poisson": rng.poisson(np.exp(np.clip(z, -2, 2))).astype(np.float64)}[task]
    w = rng.random(n) + 0.5
    w[::11] = 0.0
    return dict(y=y, offset=rng.normal(size=n) * 0.1, weight=w,
                xg=rng.normal(size=(n, 5)),
                s=dict(indices=rng.integers(0, 20, size=(n, 4)).astype(np.int32),
                       values=rng.normal(size=(n, 4)), dim=20),
                id_tags={"userId": uids, "itemId": rng.integers(0, 4, size=n)})


def _data(cls, shard_cls, g):
    return cls(y=g["y"], features={"g": g["xg"], "s": shard_cls(**g["s"])},
               offset=g["offset"], weight=g["weight"], id_tags=g["id_tags"])


def _jax_model(jtask, compact: bool, seed: int = 4):
    """A fixed effect over "g" and a per-user effect over "s" for 12 of the
    15 users, each user with 5 of the 20 columns nonzero."""
    rng = np.random.default_rng(seed)
    w = np.zeros((12, 20))
    for e in range(12):
        w[e, rng.choice(20, 5, replace=False)] = rng.normal(size=5) * 0.5
    re = jgame.RandomEffectModel(w_stack=w, slot_of={u * 5 + 2: e for e, u in
                                                     enumerate(rng.permutation(15)[:12])},
                                 random_effect_type="userId", feature_shard="s", task=jtask)
    fixed = jgame.FixedEffectModel(coefficients=JCoefficients(means=rng.normal(size=5) * 0.3),
                                   feature_shard="g", task=jtask)
    return jgame.GameModel(models={"fixed": fixed,
                                   "per-user": re.to_compact() if compact else re})


def _exchange(jmodel):
    """The exchange dict of a JAX GameModel (convert.py's format)."""
    out = {}
    for cid, m in jmodel.models.items():
        base = dict(feature_shard=m.feature_shard, task=m.task.value)
        if isinstance(m, jgame.FixedEffectModel):
            out[cid] = dict(base, kind="fixed", means=np.asarray(m.coefficients.means))
        elif isinstance(m, jgame.CompactRandomEffectModel):
            out[cid] = dict(base, kind="compact", indices=np.asarray(m.indices),
                            values=np.asarray(m.values), dim=m.dim, slot_of=m.slot_of,
                            random_effect_type=m.random_effect_type)
        else:
            out[cid] = dict(base, kind="random", w_stack=np.asarray(m.w_stack),
                            slot_of=m.slot_of, random_effect_type=m.random_effect_type)
    return out


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("task", list(TASKS))
def test_transformer_matches_jax(task, compact):
    ttask, jtask = TASKS[task]
    g = _scoring_data(task)
    jdata, tdata = _data(JData, JShard, g), _data(GameData, SparseShard, g)
    jmodel = _jax_model(jtask, compact)
    tmodel = convert.game_model_from_arrays(_exchange(jmodel))
    assert isinstance(tmodel["per-user"], CompactRandomEffectModel) == compact
    jt = JTransformer(jmodel, jtask)
    tt = GameTransformer(tmodel, ttask, device="cpu")

    score, predict = tt.score(tdata), tt.predict(tdata)
    for out in (score, predict):
        assert out.dtype == torch.float64 and out.device.type == "cpu"
    assert _rel(score, jt.score(jdata)) <= RTOL
    assert _rel(predict, jt.predict(jdata)) <= RTOL
    # the port's own contract: score is GameModel.score, predict the task's
    # mean of score + offset, bitwise
    assert torch.equal(score, tmodel.score(tdata, device="cpu"))
    raw = raw_scores(tmodel, tdata, device="cpu")
    assert torch.equal(raw, score + torch.from_numpy(g["offset"]))
    assert torch.equal(predict, loss_for_task(ttask).mean(raw))
    assert torch.equal(output_scores(raw, ttask, predict_mean=True), predict)
    assert output_scores(raw, ttask) is raw

    jr = jt.evaluate(jdata, JSuite.from_specs(SPECS))
    tr = tt.evaluate(tdata, TSuite.from_specs(SPECS))
    assert list(tr.values) == list(jr.values)
    for k, v in jr.values.items():
        assert abs(tr.values[k] - v) <= RTOL * abs(v) + 1e-15, (k, tr.values[k], v)


def _grid_data(seed: int = 12):
    """40 users x 10..30 rows (contiguous, unsorted ids); dense fixed (d 6)
    and per-user (d 12: the lane L-BFGS, whose per-lane steps match the
    JAX package's to ~1e-15) shards; the last 5 rows of every user
    validate."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(10, 31, size=40)
    uids = np.repeat(rng.permutation(40) * 3 + 1, counts)
    n = len(uids)
    xg, xu = rng.normal(size=(n, 6)), rng.normal(size=(n, 12))
    z = xg @ rng.normal(size=6) * 0.5 + np.einsum("nd,nd->n", xu,
                                                  rng.normal(size=(121, 12))[uids] * 0.4)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    held = tsynth.last_rows_per_entity(uids, 5)
    rows = dict(y=y, offset=rng.normal(size=n) * 0.05, weight=rng.random(n) + 0.5)

    def part(cls, m):
        return cls(**{k: v[m] for k, v in rows.items()},
                   features={"g": xg[m], "u": xu[m]}, id_tags={"userId": uids[m]})

    return part, held


def _grid(Config, Fixed, Random, Solver, Reg, Task):
    s = Solver(max_iters=40, tolerance=1e-9)
    return [Config(task=Task.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": Fixed(feature_shard="g", solver=s, reg=Reg(l2=1.0)),
        "per-user": Random(random_effect_type="userId", feature_shard="u", solver=s,
                           reg=Reg(l2=l2))}) for l2 in (20.0, 0.05)]


def test_grid_selects_on_grouped_auc_as_jax():
    part, held = _grid_data()
    specs = ["auc:userId", "auc", "logistic_loss", "aupr:userId"]
    jest = JEstimator(fused=False, dtype=np.float64, validation_suite=JSuite.from_specs(specs))
    jres = jest.fit(part(JData, ~held), _grid(JConfig, JFixed, JRandom, JSolver, JReg, JTask),
                    validation_data=part(JData, held))
    test = GameEstimator(device="cpu", dtype=torch.float64,
                         validation_suite=TSuite.from_specs(specs))
    tres = test.fit(part(GameData, ~held),
                    _grid(GameConfig, FixedEffectConfig, RandomEffectConfig, SolverConfig,
                          TReg, TaskType), validation_data=part(GameData, held))
    pick = tres.index(test.best(tres))
    assert pick == jres.index(jest.best(jres))
    primaries = [r.evaluation.primary for r in tres]
    assert primaries[0] != primaries[1]  # the grouped AUC tells the points apart
    for t, j in zip(tres, jres):
        assert t.evaluation.primary_name == "auc:userId"
        for k, v in j.evaluation.values.items():
            assert abs(t.evaluation.values[k] - v) <= 1e-10 * max(abs(v), 1.0), k
        # every update's validation carries the grouped metric
        assert all("auc:userId" in st["validation"].values for st in t.history.steps)


def _glmix_sparse_config(Config, Fixed, Random, Solver, Reg, Opt, Task):
    """chip_smoke.py's glmix_sparse configuration."""
    return Config(task=Task.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": Fixed(feature_shard="g", optimizer=Opt.TRON, solver=Solver.tron_default(),
                       reg=Reg(l2=1.0)),
        "per-user": Random(random_effect_type="userId", feature_shard="u",
                           solver=Solver(max_iters=30, tolerance=1e-7), reg=Reg(l2=1.0))})


def test_glmix_sparse_held_out_split_matches_jax():
    g = tsynth.synth_glmix_sparse(4)
    held = tsynth.last_rows_per_entity(g["uids"], 8)
    assert held.sum() == 8 * 1024 and (~held).sum() == 24 * 1024
    y = g["y"].astype(np.float64)

    def part(cls, shard_cls, m):
        return cls(y=y[m], features={
            k: shard_cls(indices=g[s]["indices"][m], values=g[s]["values"][m], dim=g[s]["dim"])
            for k, s in (("g", "fixed"), ("u", "user"))}, id_tags={"userId": g["uids"][m]})

    specs = ["auc", "auc:userId", "logistic_loss"]
    jres = JEstimator(fused=False, dtype=np.float64,
                      validation_suite=JSuite.from_specs(specs)).fit(
        part(JData, JShard, ~held),
        [_glmix_sparse_config(JConfig, JFixed, JRandom, JSolver, JReg, JOpt, JTask)],
        validation_data=part(JData, JShard, held))[0]
    tval = part(GameData, SparseShard, held)
    tres = GameEstimator(device="cpu", dtype=torch.float64,
                         validation_suite=TSuite.from_specs(specs)).fit(
        part(GameData, SparseShard, ~held),
        [_glmix_sparse_config(GameConfig, FixedEffectConfig, RandomEffectConfig,
                              SolverConfig, TReg, OptimizerType, TaskType)],
        validation_data=tval)[0]
    for k in ("auc", "auc:userId"):
        assert abs(tres.evaluation.values[k] - jres.evaluation.values[k]) <= 1e-6, k
    compact = GameModel(models={"fixed": tres.model["fixed"],
                                "per-user": tres.model["per-user"].to_compact()})
    held_out = GameTransformer(compact, TaskType.LOGISTIC_REGRESSION, device="cpu").evaluate(
        tval, TSuite.from_specs(specs))
    for k, v in tres.evaluation.values.items():
        assert abs(held_out.values[k] - v) <= 1e-12 * abs(v), k


def _refusal(call, item: int, *names):
    with pytest.raises(NotImplementedError) as err:
        call()
    msg = str(err.value)
    assert f"ROADMAP.md 'Modules still to port', item {item}," in msg, msg
    assert all(n in msg for n in names), msg


def test_estimator_refuses_what_is_not_ported():
    _refusal(lambda: GameEstimator(device="cpu", mesh=object()), 11, "mesh")
    part, held = _grid_data()
    configs = _grid(GameConfig, FixedEffectConfig, RandomEffectConfig, SolverConfig, TReg,
                    TaskType)[:1]
    # the fused sweep's validated form runs under fused=True
    suite = TSuite.from_specs(["auc"])
    (validated,) = GameEstimator(device="cpu", fused=True, validation_suite=suite).fit(
        part(GameData, ~held), configs, part(GameData, held))
    assert validated.history.steps == [] and validated.evaluation is not None
    for fused in (False, "auto", True):
        GameEstimator(device="cpu", fused=fused)
    est = GameEstimator(device="cpu", dtype=torch.float64)
    res = est.fit(part(GameData, ~held), configs, None, None, set(), 3)
    assert len(res) == 1
    # the reference's positional order: data, configs, validation_data,
    # initial_model, locked_coordinates, seed, checkpoint_hook, resume_cursor,
    # resume_best; the five reference arguments run since they were ported
    model = res[0].model
    saves = []
    hook = lambda m, cur, **kw: saves.append((cur, kw["updated"]))
    by_position = est.fit(part(GameData, ~held), configs, None, model, {"fixed"}, 3, hook,
                          {"config": 0, "iteration": 1, "coordinate": 1}, None)
    by_name = est.fit(part(GameData, ~held), configs, initial_model=model,
                      locked_coordinates={"fixed"}, seed=3,
                      resume_cursor={"config": 0, "iteration": 1, "coordinate": 1})
    assert by_position[0].model["fixed"] is model["fixed"]  # locked
    np.testing.assert_array_equal(by_position[0].model["per-user"].w_stack,
                                  by_name[0].model["per-user"].w_stack)
    assert saves == [({"config": 0, "iteration": 2, "coordinate": 0}, None)]
