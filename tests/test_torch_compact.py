"""The PyTorch port's compact random-effect models and the match-dot
against the JAX package, on the CPU.

On the CPU ``match_dot`` runs its plain version (the CUDA kernel is held
against that same plain version on the card by chip_smoke.py); the JAX side
runs its Pallas ``_match_dot_kernel`` in interpret mode, as
tests/test_solve_path.py does, and its searchsorted chain, which is what the
JAX package's ``score_compact_sparse`` takes without a TPU.

Tolerances, float64: the match-dot within 1e-10 relative of the interpret
kernel and of the chain (the sums run in other orders: over f of f_val times
the matched model value, against the kernel's sublane sums); containers
(``to_compact``, ``to_dense``, the exchange dict) bitwise; the whole slice
(fit -> compact -> score) within rtol 1e-6, as tests/test_torch_game.py.
"""

import jax.numpy as jnp
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
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.ops import compact_score as jcs
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.data import synthetic as tsynth
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite as TSuite
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.models import game as tgame
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.ops import compact_score as tcs
from photon_ml_tpu_torch.types import OptimizerType, TaskType

RTOL = 1e-10
FIT_RTOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _compact_inputs(num_e, dim, k_model, n, k_feat, seed):
    """Sorted unique model rows padded with ``dim`` (value 0), features with
    duplicate ids and zero-valued pads, slots in [-1, E)."""
    rng = np.random.default_rng(seed)
    w_idx = np.full((num_e, k_model), dim, np.int32)
    w_val = np.zeros((num_e, k_model))
    for e in range(num_e):
        m = int(rng.integers(0, k_model + 1)) if e % 4 else k_model  # ragged rows
        w_idx[e, :m] = np.sort(rng.choice(dim, size=m, replace=False))
        w_val[e, :m] = rng.normal(size=m)
    slots = rng.integers(-1, num_e, size=n).astype(np.int32)
    # features drawn mostly from their entity's columns, so matches are common
    f_idx = rng.integers(0, dim, size=(n, k_feat)).astype(np.int32)
    own = w_idx[np.maximum(slots, 0)]
    pick = rng.integers(0, k_model, size=(n, k_feat))
    take = rng.random((n, k_feat)) < 0.6
    f_idx = np.where(take, own[np.arange(n)[:, None], pick], f_idx).astype(np.int32)
    f_idx = np.minimum(f_idx, dim - 1)
    if k_feat > 1:
        f_idx[::3, 1] = f_idx[::3, 0]  # duplicate feature ids accumulate
    f_val = rng.normal(size=(n, k_feat))
    f_val[rng.random((n, k_feat)) < 0.2] = 0.0  # padded COO slots
    return w_idx, w_val, slots, f_idx, f_val


@pytest.mark.parametrize("k_model,k_feat,n", [(1, 1, 37), (16, 24, 300), (64, 64, 129),
                                              (5, 3, 1), (4096, 1, 40)])
def test_match_dot_plain_matches_pallas_interpret_and_chain(k_model, k_feat, n):
    dim = max(50, 2 * k_model)
    args = _compact_inputs(23, dim, k_model, n, k_feat, seed=k_model + k_feat)
    j_kernel = jcs.score_sparse_compact(*[jnp.asarray(a) for a in args], interpret=True)
    j_chain = jgame.score_compact_sparse(*[jnp.asarray(a) for a in args])
    before = tcs.match_dot.launches
    t = tcs.match_dot(*[torch.from_numpy(a) for a in args])
    assert tcs.match_dot.launches == before  # CPU: the plain version
    assert t.dtype == torch.float64 and t.shape == (n,)
    assert _rel(t, j_kernel) <= RTOL
    assert _rel(t, j_chain) <= RTOL
    assert float(t[torch.from_numpy(args[2]) < 0].abs().sum()) == 0.0


def test_eligible_boundary_and_ineligible_route():
    """The gate is the reference's (k_model * k_feat <= 4096) without its TPU
    test; an ineligible shape takes the searchsorted chain, which matches the
    JAX package's, and match_dot itself refuses it."""
    for km, kf in [(64, 64), (65, 64), (4096, 1), (4097, 1), (1, 1), (0, 3), (3, 0)]:
        assert tcs.eligible(km, kf) == jcs.eligible(km, kf, interpret=True), (km, kf)
    assert tcs.eligible(64, 64) and not tcs.eligible(65, 64)
    args = _compact_inputs(11, 400, 65, 90, 64, seed=3)
    targs = [torch.from_numpy(a) for a in args]
    before = tcs.match_dot.launches
    t = tgame.score_compact_sparse(*targs)
    assert _rel(t, jgame.score_compact_sparse(*[jnp.asarray(a) for a in args])) <= RTOL
    assert _rel(t, tgame.score_compact_sparse_search(*targs)) == 0.0
    assert tcs.match_dot.launches == before
    with pytest.raises(ValueError, match="ineligible"):
        tcs.match_dot(*targs)
    # an eligible shape routes to the match-dot, which equals the chain there
    small = [torch.from_numpy(a) for a in _compact_inputs(11, 60, 8, 50, 6, seed=4)]
    assert _rel(tgame.score_compact_sparse(*small), tcs.match_dot_plain(*small)) == 0.0
    assert _rel(tgame.score_compact_sparse_search(*small), tcs.match_dot_plain(*small)) \
        <= RTOL


def _dense_re(seed=0, e=12, d=30):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(e, d)) * (rng.random((e, d)) < 0.3)
    w[3] = 0.0  # an entity with no nonzero coefficient
    slot_of = {int(i): s for s, i in enumerate(rng.permutation(100)[:e])}
    kw = dict(slot_of=slot_of, random_effect_type="userId", feature_shard="u")
    return (jgame.RandomEffectModel(w_stack=w, **kw),
            tgame.RandomEffectModel(w_stack=w, **kw))


def test_to_compact_and_to_dense_match_jax():
    jm, tm = _dense_re()
    jc, tc = jm.to_compact(), tm.to_compact()
    np.testing.assert_array_equal(tc.indices, jc.indices)
    np.testing.assert_array_equal(tc.values, jc.values)
    assert tc.indices.dtype == np.int32 and tc.dim == jc.dim == 30
    assert tc.slot_of == jc.slot_of
    np.testing.assert_array_equal(tc.to_dense().w_stack, jm.w_stack)
    roomy_t, roomy_j = tm.to_compact(k=20), jm.to_compact(k=20)
    np.testing.assert_array_equal(roomy_t.indices, roomy_j.indices)
    np.testing.assert_array_equal(roomy_t.values, roomy_j.values)
    k_need = int((jm.w_stack != 0).sum(axis=1).max())
    for m in (jm, tm):
        with pytest.raises(ValueError, match="truncation"):
            m.to_compact(k=k_need - 1)


def test_compact_scoring_matches_jax_dense_and_sparse_shards():
    """CompactRandomEffectModel.score on a dense and on a sparse shard, and
    score_compact_dense, against the JAX package; the dim-mismatch error."""
    jm, tm = _dense_re(seed=5)
    jc, tc = jm.to_compact(), tm.to_compact()
    rng = np.random.default_rng(9)
    n = 200
    ids = np.asarray(list(jm.slot_of) + [1000])[rng.integers(0, 13, size=n)]  # + unknown
    x = rng.normal(size=(n, 30))
    idx = rng.integers(0, 30, size=(n, 7)).astype(np.int32)
    vals = rng.normal(size=(n, 7))
    vals[:, -1] = 0.0
    for jshard, tshard in [(x, x), (JShard(indices=idx, values=vals, dim=30),
                                    SparseShard(indices=idx, values=vals, dim=30))]:
        jd = JData(y=np.zeros(n), features={"u": jshard}, id_tags={"userId": ids})
        td = GameData(y=np.zeros(n), features={"u": tshard}, id_tags={"userId": ids})
        t = tc.score(td, device="cpu")
        assert _rel(t, jc.score(jd)) <= RTOL
        assert _rel(t, tm.score(td, device="cpu")) <= RTOL  # the dense twin
    slots = jc.slots_for(jd)
    np.testing.assert_array_equal(tc.slots_for(td), slots)
    args = (jc.indices, jc.values, slots, x)
    assert _rel(tgame.score_compact_dense(*[torch.from_numpy(a) for a in args]),
                jgame.score_compact_dense(*[jnp.asarray(a) for a in args])) <= RTOL
    narrow = GameData(y=np.zeros(n), features={"u": x[:, :29]}, id_tags={"userId": ids})
    with pytest.raises(ValueError, match="trained on 30"):
        tc.score(narrow, device="cpu")


def test_device_copies_are_made_once_per_instance():
    _, tm = _dense_re(seed=2)
    tc = tm.to_compact()
    a = tgame.cached_device_copies(tc, "cpu", tc.indices, tc.values)
    assert tgame.cached_device_copies(tc, "cpu", tc.indices, tc.values) is a
    import dataclasses

    fresh = dataclasses.replace(tc, values=tc.values.copy())
    b = tgame.cached_device_copies(fresh, "cpu", fresh.indices, fresh.values)
    assert b is not a and b[1].data_ptr() != a[1].data_ptr()


def test_convert_compact_round_trip():
    jm, _ = _dense_re(seed=7)
    jc = jm.to_compact()
    arrays = {"per-user": {"kind": "compact", "indices": np.asarray(jc.indices),
                           "values": np.asarray(jc.values), "dim": jc.dim,
                           "slot_of": dict(jc.slot_of),
                           "random_effect_type": jc.random_effect_type,
                           "feature_shard": jc.feature_shard, "task": jc.task.value}}
    tmodel = convert.game_model_from_arrays(arrays)
    assert isinstance(tmodel["per-user"], tgame.CompactRandomEffectModel)
    back = convert.game_model_to_arrays(tmodel)["per-user"]
    for key in ("indices", "values"):
        np.testing.assert_array_equal(back[key], arrays["per-user"][key])
    assert {k: back[k] for k in ("dim", "slot_of", "random_effect_type", "feature_shard",
                                 "task")} == \
        {k: arrays["per-user"][k] for k in ("dim", "slot_of", "random_effect_type",
                                            "feature_shard", "task")}


def test_glmix_sparse_slice_matches_jax():
    """The whole slice at a small size: glmix_sparse (32 users x 32 rows,
    sparse1m's 1M-column fixed shard under TRON, a 50,000-column per-user
    shard on compact lanes under L-BFGS), fitted with validation on sparse
    shards, compacted and scored, against JAX GameEstimator(fused=False)."""
    g = tsynth.synth_glmix_sparse(128)
    s = dict(max_iters=15, tolerance=1e-7)

    def cfgs(Config, Fixed, Random, Solver, Reg, Opt, Task):
        return Config(task=Task.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
            "fixed": Fixed(feature_shard="g", optimizer=Opt.TRON, solver=Solver(**s),
                           reg=Reg(l2=1.0)),
            "per-user": Random(random_effect_type="userId", feature_shard="u",
                               solver=Solver(**s), reg=Reg(l2=1.0))})

    def data(Data, Shard):
        return Data(y=g["y"], features={"g": Shard(**g["fixed"]), "u": Shard(**g["user"])},
                    id_tags={"userId": g["uids"]})

    jdata, tdata = data(JData, JShard), data(GameData, SparseShard)
    jres = JEstimator(fused=False, dtype=np.float64,
                      validation_suite=JSuite.from_specs(["auc"])).fit(
        jdata, [cfgs(JConfig, JFixed, JRandom, JSolver, JReg, JOpt, JTask)],
        validation_data=jdata)[0]
    tres = GameEstimator(device="cpu", dtype=torch.float64,
                         validation_suite=TSuite.from_specs(["auc"])).fit(
        tdata, [cfgs(GameConfig, FixedEffectConfig, RandomEffectConfig, SolverConfig,
                     TReg, OptimizerType, TaskType)], validation_data=tdata)[0]
    jm, tm = jres.model, tres.model
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= FIT_RTOL
    assert tm["per-user"].slot_of == jm["per-user"].slot_of
    assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= FIT_RTOL
    assert abs(tres.evaluation.values["auc"] - jres.evaluation.values["auc"]) <= 1e-9

    jc, tc = jm["per-user"].to_compact(), tm["per-user"].to_compact()
    np.testing.assert_array_equal(tc.indices, jc.indices)
    assert tc.indices.shape[1] <= tsynth.GS_BAG  # k_model <= 32: the match-dot's shape
    assert tcs.eligible(tc.indices.shape[1], tsynth.GS_K)
    tcomp = tgame.GameModel(models={"fixed": tm["fixed"], "per-user": tc})
    jcomp = jgame.GameModel(models={"fixed": jm["fixed"], "per-user": jc})
    ts = tcomp.score(tdata, device="cpu")
    assert _rel(ts, jcomp.score(jdata)) <= FIT_RTOL
    assert _rel(ts, tm.score(tdata, device="cpu")) <= RTOL  # compact == dense


def test_models_score_a_tensor_shard_as_dense():
    """A design already held as a tensor (a shard generated on the card) is
    a dense shard to every model, not a sparse one: torch tensors carry an
    ``indices`` method of their own."""
    from photon_ml_tpu_torch.models.glm import Coefficients

    _, tm = _dense_re(seed=4)
    rng = np.random.default_rng(4)
    n = 64
    ids = np.asarray(list(tm.slot_of))[rng.integers(0, 12, size=n)]
    x = rng.normal(size=(n, 30))
    fixed = tgame.FixedEffectModel(coefficients=Coefficients(means=rng.normal(size=30)),
                                   feature_shard="u")
    for m in (fixed, tm, tm.to_compact()):
        as_np = m.score(GameData(y=np.zeros(n), features={"u": x},
                                 id_tags={"userId": ids}), device="cpu")
        as_tensor = m.score(GameData(y=np.zeros(n), features={"u": torch.from_numpy(x)},
                                     id_tags={"userId": ids}), device="cpu")
        assert _rel(as_tensor, as_np) == 0.0


def _lower_bound_walk(w_idx, w_val, slots, f_idx, f_val):
    """The CUDA kernel's search, step for step, in PyTorch: per (sample,
    feature) lane the lower bound of the feature id in its entity's row by
    halving windows (lo += half while row[lo + half - 1] < id; len -= half),
    then one compare; products summed over features in order."""
    k_model = w_idx.shape[1]
    valid = (slots >= 0) & (slots < w_idx.shape[0])
    rows = w_idx[torch.where(valid, slots, 0).long()]
    vals = w_val[torch.where(valid, slots, 0).long()]
    fid = f_idx.long()
    lo = torch.zeros_like(fid)
    length = k_model
    while length > 1:
        half = length >> 1
        probe = torch.gather(rows, 1, lo + half - 1).long()
        lo = torch.where(probe < fid, lo + half, lo)
        length -= half
    hit = torch.gather(rows, 1, lo).long() == fid
    prod = torch.where(hit, f_val * torch.gather(vals, 1, lo), 0.0)
    return torch.where(valid, prod.sum(dim=1), 0.0)


@pytest.mark.parametrize("k_model,k_feat", [(1, 1), (3, 5), (8, 24), (16, 24), (32, 24),
                                            (33, 24), (24, 32), (64, 64)])
def test_kernel_search_walk_matches_plain_on_sorted_rows(k_model, k_feat):
    """On rows sorted ascending with unique ids and trailing padding, the
    kernel's lower-bound walk computes match_dot_plain's function."""
    args = [torch.from_numpy(a) for a in
            _compact_inputs(29, 700, k_model, 257, k_feat, seed=k_model * k_feat)]
    assert _rel(_lower_bound_walk(*args), tcs.match_dot_plain(*args)) <= RTOL


@pytest.mark.parametrize("k_model,k_feat,group", [
    (32, 24, 8), (16, 24, 8), (8, 24, 8), (33, 24, 8), (24, 32, 32), (64, 64, 32),
    (16, 2, 2), (16, 12, 4), (16, 16, 16), (1, 1, 1), (4096, 1, 1), (3, 1365, 1)])
def test_match_plan_groups(k_model, k_feat, group):
    plan = tcs.match_plan(k_model, k_feat)
    assert plan.group == group
    # the lanes of a group take every feature exactly once
    assert plan.feats_per_lane * plan.group >= k_feat > \
        (plan.feats_per_lane - 1) * plan.group
    assert plan.steps == int(np.ceil(np.log2(k_model))) + 1


def test_match_plan_never_exceeds_the_flattened_walk():
    """Over the whole eligible range, a sample's lane-steps (its group's
    lanes, idle ones included, times the features a lane takes, times the
    dependent loads of each search) fit in the warp-per-sample walk's
    ceil(k_model * k_feat / 32) trips of 32 lanes; at glmix_sparse's (32, 24)
    and the bench's (16, 24) they are a third of it or less."""
    checked = 0
    for k_model in range(1, tcs.MAX_MATCH_WORK + 1):
        for k_feat in range(1, tcs.MAX_MATCH_WORK // k_model + 1):
            assert tcs.eligible(k_model, k_feat)
            plan = tcs.match_plan(k_model, k_feat)
            assert 0 <= plan.log_group <= 5
            assert plan.lane_steps <= 32 * tcs.flat_trips(k_model, k_feat), \
                (k_model, k_feat, plan)
            checked += 1
    assert checked > 30_000
    for k_model, k_feat in ((32, 24), (16, 24)):
        plan = tcs.match_plan(k_model, k_feat)
        assert plan.lane_steps * 3 <= 32 * tcs.flat_trips(k_model, k_feat)


def _rows_sorted_unique_padded(indices, values, dim):
    idx, val = np.asarray(indices), np.asarray(values)
    for r, v in zip(idx, val):
        real = r[r < dim]
        assert (r[len(real):] == dim).all() and (v[len(real):] == 0).all()
        assert (np.diff(real) > 0).all() and (real >= 0).all()


def test_every_producer_gives_sorted_unique_rows():
    """match_dot's kernel relies on sorted rows with unique ids and trailing
    padding: to_compact (port and JAX, tight and roomy), convert's compact
    kind and chip_smoke's generated cases all give them."""
    jm, tm = _dense_re(seed=11)
    for m in (tm.to_compact(), tm.to_compact(k=25), jm.to_compact()):
        _rows_sorted_unique_padded(m.indices, m.values, m.dim)
    jc = jm.to_compact()
    arrays = {"u": {"kind": "compact", "indices": np.asarray(jc.indices),
                    "values": np.asarray(jc.values), "dim": jc.dim,
                    "slot_of": dict(jc.slot_of), "random_effect_type": "userId",
                    "feature_shard": "u", "task": jc.task.value}}
    cm = convert.game_model_from_arrays(arrays)["u"]
    _rows_sorted_unique_padded(cm.indices, cm.values, cm.dim)

    import chip_smoke

    gen = torch.Generator().manual_seed(5)
    for k_model in (1, 16, 33, 4096):
        w_idx, w_val, *_ = chip_smoke._compact_case(50, 50_000, k_model, 10, 3,
                                                    torch.float64, gen, dev="cpu")
        _rows_sorted_unique_padded(w_idx.numpy(), w_val.numpy(), 50_000)


@pytest.mark.parametrize("row,vals", [([5, 3, 9], [1.0, 2.0, 3.0]),  # unsorted
                                      ([3, 3, 9], [1.0, 2.0, 3.0]),  # duplicate id
                                      ([3, 10, 9], [1.0, 0.0, 3.0]),  # padding not last
                                      ([3, 9, 10], [1.0, 3.0, 0.5])])  # padding value
def test_convert_refuses_rows_the_kernel_cannot_search(row, vals):
    arrays = {"u": {"kind": "compact", "indices": np.array([row, [1, 10, 10]], np.int32),
                    "values": np.array([vals, [1.0, 0.0, 0.0]]), "dim": 10,
                    "slot_of": {7: 0, 8: 1}, "random_effect_type": "userId",
                    "feature_shard": "u", "task": TaskType.LOGISTIC_REGRESSION.value}}
    with pytest.raises(ValueError, match="compact"):
        convert.game_model_from_arrays(arrays)
