"""The PyTorch port's GLMix slice against the JAX package, on the CPU.

The slice: bucketing, GameEstimator.fit over a glmix_chip-shaped
configuration (a logistic fixed effect under L-BFGS and a 4-feature per-user
random effect with active cap 32 on the SoA Newton path), GameModel.score
and AUC, plus weight conversion and the glmix_chip generator.  The JAX side
is ``GameEstimator(fused=False)``, the host-paced loop the port follows.
Everything runs in float64 with inputs drawn by numpy from a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.evaluation import metrics as jmetrics
from photon_ml_tpu.evaluation.evaluator import EvaluationSuite as JSuite
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.parallel import bucketing as jbucketing
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.core.normalization import NormalizationContext
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.data import synthetic as tsynth
from photon_ml_tpu_torch.evaluation import metrics as tmetrics
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig)
from photon_ml_tpu_torch.game.coordinate import build_coordinate
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.parallel import bucketing as tbucketing
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

D_G, D_U, CAP = 128, 4, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def glmix():
    """glmix_chip-shaped data: 300 users with 1..80 rows each (so the cap
    drops rows and buckets of every capacity class exist)."""
    rng = np.random.default_rng(2024)
    users = 300
    counts = rng.integers(1, 81, size=users)
    uids = rng.permutation(np.repeat(np.arange(users) * 7 + 3, counts))
    n = len(uids)
    xg = rng.normal(size=(n, D_G)) * 0.2
    xu = rng.normal(size=(n, D_U))
    wg = rng.normal(size=D_G) * 0.3
    wu = rng.normal(size=(users * 7 + 3, D_U)) * 0.5
    logits = xg @ wg + np.einsum("nd,nd->n", xu, wu[uids])
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    off = rng.normal(size=n) * 0.05
    wt = rng.random(n) + 0.5
    return dict(y=y, xg=xg, xu=xu, uids=uids, off=off, wt=wt, n=n)


def _jax_config(num_iters=2):
    s = JSolver(max_iters=30, tolerance=1e-7)
    return JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                   coordinates={
                       "fixed": JFixed(feature_shard="g", solver=s, reg=JReg(l2=1.0)),
                       "per-user": JRandom(random_effect_type="userId",
                                           feature_shard="u", solver=s,
                                           reg=JReg(l2=1.0), active_cap=CAP)})


def _torch_config(num_iters=2):
    s = SolverConfig(max_iters=30, tolerance=1e-7)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(feature_shard="g", solver=s,
                                                     reg=TReg(l2=1.0)),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              solver=s, reg=TReg(l2=1.0), active_cap=CAP)})


def _data(cls, g):
    return cls(y=g["y"], features={"g": g["xg"], "u": g["xu"]}, offset=g["off"],
               weight=g["wt"], id_tags={"userId": g["uids"]})


@pytest.fixture(scope="module")
def jax_fit(glmix):
    data = _data(JData, glmix)
    suite = JSuite.from_specs(["auc", "logistic_loss"])
    res = JEstimator(fused=False, dtype=np.float64, validation_suite=suite).fit(
        data, [_jax_config()], validation_data=data)[0]
    return res, data


def test_bucket_by_entity_bitwise(glmix):
    """Bitwise-equal buckets, reservoir choice and weight rescale included."""
    kw = dict(active_cap=CAP, min_active_samples=3, lane_multiple=4, seed=17,
              dtype=np.float64)
    args = (glmix["uids"], glmix["xu"], glmix["y"], glmix["off"], glmix["wt"])
    j = jbucketing.bucket_by_entity(*args, **kw)
    t = tbucketing.bucket_by_entity(*args, **kw)
    assert t.lane_of == j.lane_of
    assert (t.dim, t.num_entities, t.num_samples) == (j.dim, j.num_entities, j.num_samples)
    assert len(t.buckets) == len(j.buckets) > 3
    for tb, jb in zip(t.buckets, j.buckets):
        for name in ("x", "y", "offset", "weight", "rows", "counts", "entity_lanes"):
            np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), name)
    # a device-style (tensor) design gathers to the same bucket blocks
    tt = tbucketing.bucket_by_entity(glmix["uids"], torch.from_numpy(glmix["xu"]),
                                     *args[2:], **kw)
    for tb, jb in zip(tt.buckets, j.buckets):
        np.testing.assert_array_equal(tb.x.numpy(), jb.x)


def test_glmix_fit_matches_jax_host_paced(glmix, jax_fit):
    """GameEstimator(device="cpu").fit against JAX GameEstimator(fused=False).

    Tolerance rtol 1e-6 on fixed and per-user coefficients and scores, 1e-9
    absolute on AUC.  Both fits take the same steps in float64 and land
    ~1e-14 apart; the margin is for a solver that ends one iteration apart
    near its tolerance (1e-7 relative function change)."""
    jres, jdata = jax_fit
    suite = TSuite.from_specs(["auc", "logistic_loss"])
    data = _data(GameData, glmix)
    tres = GameEstimator(device="cpu", dtype=torch.float64, validation_suite=suite,
                         fused=False).fit(data, [_torch_config()], validation_data=data)[0]
    jm, tm = jres.model, tres.model

    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= 1e-6
    assert tm["per-user"].slot_of == jm["per-user"].slot_of
    assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= 1e-6

    js = np.asarray(jm.score(jdata))
    ts = tm.score(data, device="cpu").numpy()
    assert _rel(ts, js) <= 1e-6
    raw = js + glmix["off"]
    j_auc = float(jmetrics.auc_roc(raw, glmix["y"], glmix["wt"]))
    t_auc = float(tmetrics.auc_roc(torch.from_numpy(ts + glmix["off"]),
                                   torch.from_numpy(glmix["y"]),
                                   torch.from_numpy(glmix["wt"])))
    assert abs(t_auc - j_auc) <= 1e-9
    assert t_auc > 0.7  # the data carries real signal

    assert len(tres.history.steps) == len(jres.history.steps) == 4
    for k in ("auc", "logistic_loss"):
        assert abs(tres.evaluation.values[k] - jres.evaluation.values[k]) <= \
            1e-6 * abs(jres.evaluation.values[k])


def test_convert_carries_jax_weights(glmix, jax_fit):
    """A JAX-fitted model, carried across as numpy, scores the same data to
    rounding (rtol 1e-12: identical weights, different summation order)."""
    jres, jdata = jax_fit
    jm = jres.model
    fixed, re = jm["fixed"], jm["per-user"]
    arrays = {
        "fixed": {"kind": "fixed", "means": np.asarray(fixed.coefficients.means),
                  "feature_shard": fixed.feature_shard, "task": fixed.task.value},
        "per-user": {"kind": "random", "w_stack": np.asarray(re.w_stack),
                     "slot_of": dict(re.slot_of),
                     "random_effect_type": re.random_effect_type,
                     "feature_shard": re.feature_shard, "task": re.task.value},
    }
    tm = convert.game_model_from_arrays(arrays)
    ts = tm.score(_data(GameData, glmix), device="cpu").numpy()
    assert _rel(ts, np.asarray(jm.score(jdata))) <= 1e-12
    back = convert.game_model_to_arrays(tm)
    np.testing.assert_array_equal(back["per-user"]["w_stack"], arrays["per-user"]["w_stack"])
    assert back["per-user"]["slot_of"] == arrays["per-user"]["slot_of"]
    np.testing.assert_array_equal(back["fixed"]["means"], arrays["fixed"]["means"])


def test_auc_matches_jax_with_ties():
    rng = np.random.default_rng(5)
    s = np.round(rng.normal(size=500), 1)  # many tied scores
    y = (rng.random(500) < 0.4).astype(np.float64)
    w = rng.random(500)
    w[::9] = 0.0
    t = tmetrics.auc_roc(*[torch.from_numpy(a) for a in (s, y, w)])
    assert abs(float(t) - float(jmetrics.auc_roc(s, y, w))) <= 1e-12
    lt = tmetrics.logistic_loss_metric(*[torch.from_numpy(a) for a in (s, y, w)])
    assert abs(float(lt) - float(jmetrics.logistic_loss_metric(s, y, w))) <= 1e-9
    ones = torch.ones(4, dtype=torch.float64)
    assert float(tmetrics.auc_roc(torch.arange(4.0, dtype=torch.float64), ones, ones)) == 0.5


def test_glmix_chip_generator_matches_bench():
    """The host half is bench.synth_glmix_chip bit for bit; the device half's
    signal columns equal the host's (float32 sin, 1e-6)."""
    j = bench.synth_glmix_chip(64)
    t = tsynth.synth_glmix_chip(64)
    for k in ("y", "uids", "xu"):
        np.testing.assert_array_equal(t[k], j[k])
    assert (t["n"], t["users"], t["per_user"]) == (j["n"], j["users"], j["per_user"])
    assert tsynth.chip_sizes(1) == bench._chip_sizes(1) == (131072, 64)
    i = np.arange(0, 40000, 7, dtype=np.int64)
    np.testing.assert_array_equal(tsynth.chip_signal_cols_np(i),
                                  bench._chip_signal_cols(i, np))
    x = tsynth.chip_design(3000, "cpu", seed=1)
    assert x.shape == (3000, tsynth.D_CHIP_G) and x.dtype == torch.float32
    np.testing.assert_allclose(x[:, :16].numpy(),
                               tsynth.chip_signal_cols_np(np.arange(3000)), atol=1e-6)
    noise = x[:, 16:]
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1.0) < 0.01
    torch.testing.assert_close(tsynth.chip_design(3000, "cpu", seed=1), x)


def test_out_of_slice_configurations_raise(glmix):
    """What earlier slices refused now follows the reference: L1 (OWLQN),
    OWLQN itself, box constraints, normalization under compaction and the
    RANDOM projector (with a context pushed through its matrix) fit, each
    update held against the JAX coordinate's within rtol 1e-6 in float64.
    The reference's errors stay ValueErrors (TRON with L1, variances under
    the RANDOM projector, RANDOM without projected_dim), and a shard that is
    neither an array, a tensor nor a SparseShard is a TypeError."""
    from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
    from photon_ml_tpu.game.coordinate import build_coordinate as j_build_coordinate
    from photon_ml_tpu.types import ProjectorType as JProj

    jdata, data = _data(JData, glmix), _data(GameData, glmix)
    task = TaskType.LOGISTIC_REGRESSION
    s = dict(max_iters=10, tolerance=1e-7)
    half = np.full(D_U, 0.5)
    fits = [
        (JRandom(random_effect_type="userId", feature_shard="u", solver=JSolver(**s),
                 reg=JReg(l1=0.5)),
         RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                            solver=SolverConfig(**s), reg=TReg(l1=0.5)), False),
        (JFixed(feature_shard="g", optimizer=JOpt.OWLQN, solver=JSolver(**s)),
         FixedEffectConfig(feature_shard="g", optimizer=OptimizerType.OWLQN,
                           solver=SolverConfig(**s)), False),
        (JRandom(random_effect_type="userId", feature_shard="u", solver=JSolver(**s),
                 reg=JReg(l2=1.0), projector=JProj.INDEX_MAP),
         RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                            solver=SolverConfig(**s), reg=TReg(l2=1.0),
                            projector=ProjectorType.INDEX_MAP), True),
        (JRandom(random_effect_type="userId", feature_shard="u", solver=JSolver(**s),
                 reg=JReg(l2=1.0), constraints=((0, -0.2, 0.2),)),
         RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                            solver=SolverConfig(**s), reg=TReg(l2=1.0),
                            constraints=((0, -0.2, 0.2),)), False),
        (JRandom(random_effect_type="userId", feature_shard="u", solver=JSolver(**s),
                 reg=JReg(l2=1.0), projector=JProj.RANDOM, projected_dim=3),
         RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                            solver=SolverConfig(**s), reg=TReg(l2=1.0),
                            projector=ProjectorType.RANDOM, projected_dim=3), True),
    ]
    for jcfg, tcfg, normalized in fits:
        jnorm = JNorm(factors=half, shifts=None) if normalized else None
        tnorm = (NormalizationContext(factors=torch.from_numpy(half), shifts=None)
                 if normalized else None)
        jc = j_build_coordinate("c", jdata, jcfg, JTask.LOGISTIC_REGRESSION,
                                dtype=np.float64, norm=jnorm)
        tc = build_coordinate("c", data, tcfg, task, dtype=torch.float64, device="cpu",
                              norm=tnorm)
        jm, _ = jc.update(glmix["off"])
        tm, _ = tc.update(torch.from_numpy(glmix["off"]))
        if isinstance(tcfg, FixedEffectConfig):
            assert _rel(tm.coefficients.means, jm.coefficients.means) <= 1e-6
        else:
            assert tm.slot_of == jm.slot_of
            assert _rel(tm.w_stack, jm.w_stack) <= 1e-6
    with pytest.raises(ValueError, match="TRON does not support L1"):
        build_coordinate("f", data, FixedEffectConfig(
            feature_shard="g", optimizer=OptimizerType.TRON, reg=TReg(l1=0.1)),
            task, device="cpu")
    with pytest.raises(ValueError, match="variances"):
        build_coordinate("u", data, RandomEffectConfig(
            random_effect_type="userId", feature_shard="u",
            projector=ProjectorType.RANDOM,
            variance=VarianceComputationType.FULL), task, device="cpu")
    with pytest.raises(ValueError, match="RANDOM projection requires projected_dim"):
        build_coordinate("u", data, RandomEffectConfig(
            random_effect_type="userId", feature_shard="g",
            projector=ProjectorType.RANDOM), task, device="cpu")
    with pytest.raises(TypeError, match="SparseShard"):
        GameData(y=glmix["y"], features={"s": object()})


def test_random_effect_warm_start_carries_untrained_entities(glmix):
    """A warm-start model's entity that this data does not train keeps its
    coefficients in the published model (the reference's leftOuterJoin
    passthrough); trained entities start from their prior rows."""
    data = _data(GameData, glmix)
    coord = build_coordinate("per-user", data, _torch_config().coordinates["per-user"],
                             TaskType.LOGISTIC_REGRESSION, dtype=torch.float64,
                             device="cpu")
    offsets = torch.from_numpy(glmix["off"])
    cold, _ = coord.update(offsets)
    extra = np.array([[0.5, -1.0, 2.0, 0.25]])
    prior = dataclasses.replace(cold, w_stack=np.concatenate([cold.w_stack, extra]),
                                slot_of={**cold.slot_of, 10**9: len(cold.slot_of)})
    warm, _ = coord.update(offsets, init=prior)
    np.testing.assert_array_equal(warm.w_stack[warm.slot_of[10**9]], extra[0])
    trained = [e for e in warm.slot_of if e != 10**9]
    rows = [warm.slot_of[e] for e in trained]
    # the prior rows are the optimum already: Newton may take one more step
    # inside its 1e-7 tolerance, which moves nothing by more than 1e-6 of
    # the largest coefficient / score
    assert _rel(warm.w_stack[rows], cold.w_stack[[cold.slot_of[e] for e in trained]]) <= 1e-6
    assert _rel(coord.score(warm), coord.score(cold)) <= 1e-6


# -- lanes outside the SoA gate, TRON, per-entity L2 ---------------------------

D_U2, D_I2, LANE_CAP = 8, 6, 64


@pytest.fixture(scope="module")
def glmix3():
    """glmix3-shaped data: a fixed effect, 60 users with 20..80 rows (active
    cap 64: buckets of capacity 32 and 64, cap*d^2 = 4096 is outside the
    SoA gate) and 25 items."""
    rng = np.random.default_rng(77)
    users, items = 60, 25
    counts = rng.integers(20, 81, size=users)
    uids = rng.permutation(np.repeat(np.arange(users) * 3 + 1, counts))
    n = len(uids)
    iids = rng.integers(0, items, size=n) * 5
    xg = rng.normal(size=(n, 24)) * 0.3
    xu = rng.normal(size=(n, D_U2)) * 0.7
    xi = rng.normal(size=(n, D_I2)) * 0.7
    logits = (xg @ rng.normal(size=24) * 0.5
              + np.einsum("nd,nd->n", xu, rng.normal(size=(users * 3 + 1, D_U2))[uids])
              + np.einsum("nd,nd->n", xi, rng.normal(size=(items * 5, D_I2))[iids]))
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    off = rng.normal(size=n) * 0.05
    wt = rng.random(n) + 0.5
    mult = {int(u): float(m) for u, m in zip(np.arange(users) * 3 + 1,
                                             rng.uniform(0.25, 4.0, size=users))}
    return dict(y=y, xg=xg, xu=xu, xi=xi, uids=uids, iids=iids, off=off, wt=wt,
                mult=mult)


def _lane_configs(case, g):
    """(JAX config, port config) of one case; the two are built from the same
    description so they cannot drift apart."""
    jopt = {"tron": JOpt.TRON, "lbfgs": JOpt.LBFGS}
    topt = {"tron": OptimizerType.TRON, "lbfgs": OptimizerType.LBFGS}
    fe_opt, re_opt, shard, coords, mult, task = {
        "tron_both": ("tron", "tron", "u", ("fixed", "per-user"), None, "logistic"),
        "lbfgs_three": ("lbfgs", "lbfgs", "u", ("fixed", "per-user", "per-item"), None,
                        "logistic"),
        "per_entity_l2": ("lbfgs", "tron", "u", ("fixed", "per-user"), g["mult"],
                          "logistic"),
        "tron_soa_eligible": ("tron", "tron", "u4", ("fixed", "per-user"), g["mult"],
                              "logistic"),
        "hinge_lanes": ("lbfgs", "lbfgs", "u4", ("fixed", "per-user"), None, "hinge"),
    }[case]
    cap = CAP if shard == "u4" else LANE_CAP
    jtask = JTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM if task == "hinge" else \
        JTask.LOGISTIC_REGRESSION
    ttask = TaskType(jtask.value)
    out = []
    for lib in ("jax", "torch"):
        S, R, F, Rd, C, O = ((JSolver, JReg, JFixed, JRandom, JConfig, jopt) if lib == "jax"
                             else (SolverConfig, TReg, FixedEffectConfig,
                                   RandomEffectConfig, GameConfig, topt))
        s = S(max_iters=15, tolerance=1e-8)
        cs = {"fixed": F(feature_shard="g", solver=s, reg=R(l2=1.0), optimizer=O[fe_opt])}
        if "per-user" in coords:
            cs["per-user"] = Rd(random_effect_type="userId", feature_shard=shard, solver=s,
                                reg=R(l2=2.0), active_cap=cap, optimizer=O[re_opt],
                                per_entity_l2_multipliers=mult)
        if "per-item" in coords:
            cs["per-item"] = Rd(random_effect_type="itemId", feature_shard="i", solver=s,
                                reg=R(l2=0.5), optimizer=O[re_opt])
        out.append(C(task=jtask if lib == "jax" else ttask, num_outer_iterations=2,
                     coordinates=cs))
    return out


def _data3(cls, g):
    return cls(y=g["y"], features={"g": g["xg"], "u": g["xu"], "u4": g["xu"][:, :4],
                                   "i": g["xi"]},
               offset=g["off"], weight=g["wt"],
               id_tags={"userId": g["uids"], "itemId": g["iids"]})


_JAX_FITS = {}


def _jax_lane_fit(case, g):
    if case not in _JAX_FITS:
        jcfg, _ = _lane_configs(case, g)
        data = _data3(JData, g)
        res = JEstimator(fused=False, dtype=np.float64).fit(data, [jcfg])[0]
        _JAX_FITS[case] = (res, data)
    return _JAX_FITS[case]


@pytest.mark.parametrize("case", ["tron_both", "lbfgs_three", "per_entity_l2",
                                  "tron_soa_eligible", "hinge_lanes"])
def test_lane_coordinates_fit_matches_jax_host_paced(glmix3, case):
    """GameEstimator(device="cpu").fit against JAX GameEstimator(fused=False)
    for random effects outside the SoA gate (lane-batched L-BFGS / TRON),
    TRON on both coordinates, three coordinates, per-entity L2 multipliers,
    the smoothed hinge on the lanes path, and a TRON coordinate inside the
    SoA gate, which must run SoA Newton as the reference does.  rtol 1e-6 on
    coefficients and scores, as in the glmix_chip parity test."""
    jres, jdata = _jax_lane_fit(case, glmix3)
    _, tcfg = _lane_configs(case, glmix3)
    data = _data3(GameData, glmix3)
    tres = GameEstimator(device="cpu", dtype=torch.float64).fit(data, [tcfg])[0]
    jm, tm = jres.model, tres.model
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= 1e-6
    for cid in tcfg.coordinates:
        if cid == "fixed":
            continue
        assert tm[cid].slot_of == jm[cid].slot_of
        assert _rel(tm[cid].w_stack, jm[cid].w_stack) <= 1e-6
    assert _rel(tm.score(data, device="cpu").numpy(), np.asarray(jm.score(jdata))) <= 1e-6

    coord = build_coordinate("per-user", data, tcfg.coordinates["per-user"], tcfg.task,
                             dtype=torch.float64, device="cpu")
    assert coord.use_soa == (case == "tron_soa_eligible")


def test_convert_carries_per_item_models(glmix3):
    """A three-coordinate JAX model (fixed, per-user, per-item) carried
    across as numpy scores the same data to rounding (rtol 1e-12)."""
    jres, jdata = _jax_lane_fit("lbfgs_three", glmix3)
    jm = jres.model
    arrays = {"fixed": {"kind": "fixed", "means": np.asarray(jm["fixed"].coefficients.means),
                        "feature_shard": "g", "task": jm["fixed"].task.value}}
    for cid in ("per-user", "per-item"):
        re = jm[cid]
        arrays[cid] = {"kind": "random", "w_stack": np.asarray(re.w_stack),
                       "slot_of": dict(re.slot_of),
                       "random_effect_type": re.random_effect_type,
                       "feature_shard": re.feature_shard, "task": re.task.value}
    tm = convert.game_model_from_arrays(arrays)
    assert set(tm.models) == {"fixed", "per-user", "per-item"}
    ts = tm.score(_data3(GameData, glmix3), device="cpu").numpy()
    assert _rel(ts, np.asarray(jm.score(jdata))) <= 1e-12
    back = convert.game_model_to_arrays(tm)
    np.testing.assert_array_equal(back["per-item"]["w_stack"], arrays["per-item"]["w_stack"])
    assert back["per-item"]["slot_of"] == arrays["per-item"]["slot_of"]


@pytest.mark.parametrize("three", [False, True])
def test_glmix_generator_matches_bench(three):
    """synth_glmix is bench.synth_glmix bit for bit at a small scale, and its
    logits are the generative margins the labels were drawn from."""
    j = bench.synth_glmix(64, three)
    t = tsynth.synth_glmix(64, three)
    assert set(t) == set(j) | {"logits"}
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], k)
    assert t["logits"].shape == t["y"].shape
    assert ((t["logits"] > 0) == (t["y"] > 0.5)).mean() > 0.6
