"""The port's regularization path (``models/training.py``) against the JAX
package's, on the CPU in float64.

``train_glm_reg_path`` on the same numpy inputs: the same descending order,
the same warm starts (previous weight, a supplied warm-start model, zeros),
the same solver iterations per weight, and models within rtol 1e-6 (the
two sides take the same steps; they differ in the summation order of their
float64 dot products).  Cases: L2 on each task, variances, a box, a
STANDARDIZATION context with an intercept, L1 and elastic net (OWLQN, run to
the float64 plateau as tests/test_torch_owlqn.py does), TRON, and the
first-weight dispatch.  Under a context the port publishes the variances in
original space, as the means and as the GAME coordinates do; the JAX version
returns them in the transformed space, so the test maps the JAX variances
out through the JAX context before comparing.  ``select_best_glm`` picks the
JAX package's weight for ``auc`` and ``logistic_loss``, and under every
task's default metric (``rmse`` for linear, ``poisson_loss`` for Poisson).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import normalization as jn
from photon_ml_tpu.core.regularization import RegularizationType as JRegType
from photon_ml_tpu.models.glm import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GLMModel as JModel
from photon_ml_tpu.models.training import select_best_glm as j_select
from photon_ml_tpu.models.training import train_glm_reg_path as j_path
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import NormalizationType as JKind
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core.regularization import RegularizationType
from photon_ml_tpu_torch.models import training
from photon_ml_tpu_torch.models.glm import Coefficients, GLMModel
from photon_ml_tpu_torch.models.training import select_best_glm, train_glm_reg_path
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (NormalizationType, OptimizerType, TaskType,
                                       VarianceComputationType)

FIT_RTOL = 1e-6
WEIGHTS = [0.1, 10.0, 1.0, 3.0]
TASKS = {
    "logistic": (TaskType.LOGISTIC_REGRESSION, JTask.LOGISTIC_REGRESSION),
    "smoothed_hinge": (TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
                       JTask.SMOOTHED_HINGE_LOSS_LINEAR_SVM),
    "linear": (TaskType.LINEAR_REGRESSION, JTask.LINEAR_REGRESSION),
    "poisson": (TaskType.POISSON_REGRESSION, JTask.POISSON_REGRESSION),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _glm(task="logistic", n=400, d=6, seed=3):
    """(x, y, offset, weight): column 0 an intercept, the others scaled and
    shifted so that a context is far from the identity."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.uniform(-1.0, 1.0, d)
    x[:, 0] = 1.0
    z = x @ (rng.normal(size=d) * 0.3)
    y = {"linear": z + rng.normal(size=n),
         "poisson": rng.poisson(np.exp(np.clip(z, -3, 3))).astype(np.float64)}.get(
        task, (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64))
    return x, y, rng.normal(size=n) * 0.1, rng.random(n) + 0.5


def _contexts(x):
    """STANDARDIZATION with column 0 as the intercept, on both sides."""
    j = jn.build_normalization(JKind.STANDARDIZATION,
                               jn.compute_feature_stats(jnp.asarray(x), intercept_index=0))
    t = tn.build_normalization(NormalizationType.STANDARDIZATION,
                               tn.compute_feature_stats(torch.from_numpy(x),
                                                        intercept_index=0))
    return j, t


PLATEAU = dict(max_iters=300, tolerance=1e-14)
CASES = {
    # case: (task, keyword arguments of both sides or the name of a setting)
    "l2": ("logistic", {}),
    "smoothed_hinge": ("smoothed_hinge", {}),
    "linear": ("linear", {}),
    "poisson": ("poisson", {}),
    "no_warm_start": ("logistic", dict(use_warm_start=False)),
    "warm_start_models": ("logistic", "warm"),
    "simple_variances": ("logistic", "simple"),
    "full_variances": ("poisson", "full"),
    "box": ("logistic", "box"),
    "context": ("logistic", "context"),
    "l1": ("logistic", "l1"),
    "elastic_net": ("linear", "elastic_net"),
    "tron": ("logistic", "tron"),
    "first_weight_dispatch": ("logistic", "first_weight"),
}


def _case_args(case, x):
    """(JAX keyword arguments, port keyword arguments, weights) of a case."""
    task, spec = CASES[case]
    d = x.shape[1]
    j, t, weights = {}, {}, WEIGHTS
    if isinstance(spec, dict):
        j, t = dict(spec), dict(spec)
    elif spec == "warm":
        means = [np.linspace(-0.2, 0.3, d), np.full(d, 0.1)]
        j["warm_start_models"] = {5.0: JModel(JCoefficients(means=means[0])),
                                  0.5: JModel(JCoefficients(means=means[1]))}
        t["warm_start_models"] = {5.0: GLMModel(Coefficients(means=means[0])),
                                  0.5: GLMModel(Coefficients(means=means[1]))}
        j["use_warm_start"] = t["use_warm_start"] = False
    elif spec in ("simple", "full"):
        j["variance"] = JVar(spec)
        t["variance"] = VarianceComputationType(spec)
    elif spec == "box":
        lo, hi = np.full(d, -np.inf), np.full(d, np.inf)
        lo[1], hi[2], lo[3], hi[3] = 0.0, 0.05, -0.02, 0.02
        j["box"] = (jnp.asarray(lo), jnp.asarray(hi))
        t["box"] = (lo, hi)
    elif spec == "context":
        jctx, tctx = _contexts(x)
        j.update(norm=jctx, intercept_index=0, variance=JVar.SIMPLE)
        t.update(norm=tctx, intercept_index=0, variance=VarianceComputationType.SIMPLE)
    elif spec in ("l1", "elastic_net", "first_weight"):
        kind = "l1" if spec != "elastic_net" else "elastic_net"
        j.update(reg_type=JRegType(kind), elastic_net_alpha=0.5,
                 solver=JSolver(**PLATEAU))
        t.update(reg_type=RegularizationType(kind), elastic_net_alpha=0.5,
                 solver=SolverConfig(**PLATEAU))
        weights = {"l1": [20.0, 5.0, 60.0, 1.0], "elastic_net": [300.0, 80.0, 900.0, 10.0],
                   "first_weight": [0.0, 20.0, 5.0, 1.0]}[spec]
    elif spec == "tron":
        j["optimizer"], t["optimizer"] = JOpt.TRON, OptimizerType.TRON
    return task, j, t, weights


@pytest.mark.parametrize("case", list(CASES))
def test_reg_path_matches_jax(case):
    """Per weight: the order (descending), the iterations and reasons, the
    means and the variances of the JAX version on the same inputs."""
    x, y, off, wt = _glm(CASES[case][0])
    task, jkw, tkw, weights = _case_args(case, x)
    ttask, jtask = TASKS[task]
    jp, jt = j_path(x, y, jtask, weights, offset=off, weight=wt, dtype=np.float64, **jkw)
    tp, tt = train_glm_reg_path(x, y, ttask, weights, offset=off, weight=wt,
                                dtype=torch.float64, device="cpu", **tkw)
    assert [lam for lam, _ in tp] == [lam for lam, _ in jp] == sorted(weights, reverse=True)
    assert set(tt) == set(jt) == set(weights)
    for (lam, tm), (_, jm) in zip(tp, jp):
        assert tm.task == ttask
        assert tt[lam].iterations == int(jt[lam].iterations)
        assert tt[lam].reason == int(jt[lam].reason)
        assert _rel(tm.coefficients.means, jm.coefficients.means) <= FIT_RTOL
        jv = jm.coefficients.variances
        if jv is None:
            assert tm.coefficients.variances is None
            continue
        if "norm" in jkw:  # the JAX version's variances are transformed-space ones
            jv = jkw["norm"].model_to_original_space(jnp.asarray(jv), 0)
        assert _rel(tm.coefficients.variances, jv) <= FIT_RTOL
    if case in ("l1", "elastic_net"):
        zeros = [np.asarray(m.coefficients.means) == 0 for _, m in jp]
        for (_, tm), z in zip(tp, zeros):
            np.testing.assert_array_equal(tm.coefficients.means == 0, z)
        assert zeros[0].any()
    if case == "box":
        for _, tm in tp:
            w = tm.coefficients.means
            assert w[1] >= 0.0 and w[2] <= 0.05 and -0.02 <= w[3] <= 0.02


def test_reg_path_on_a_tensor_design_needs_no_copy():
    """A tensor design stays where it is (no copy on its device), and gives
    the numpy design's path bitwise."""
    x, y, _, _ = _glm()
    xt = torch.from_numpy(x)
    seen = []
    real = training.dense_batch

    def spy(x_, *args, **kw):
        seen.append(x_.data_ptr())
        return real(x_, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(training, "dense_batch", spy)
        tp, _ = train_glm_reg_path(xt, y, TaskType.LOGISTIC_REGRESSION, WEIGHTS,
                                   dtype=torch.float64, device="cpu")
    assert seen == [xt.data_ptr()]
    np_path, _ = train_glm_reg_path(x, y, TaskType.LOGISTIC_REGRESSION, WEIGHTS,
                                    dtype=torch.float64, device="cpu")
    for (_, a), (_, b) in zip(tp, np_path):
        np.testing.assert_array_equal(a.coefficients.means, b.coefficients.means)


@pytest.mark.parametrize("metric", [None, "auc", "logistic_loss"])
def test_select_best_glm_matches_jax(metric):
    """The best weight on held-out rows, by the task's default (AUC) or a
    named metric, with offsets and weights: the JAX package's choice."""
    x, y, off, wt = _glm(n=900, d=12, seed=9)
    weights = [1e-3, 1.0, 30.0, 300.0, 3000.0]
    jp, _ = j_path(x[:300], y[:300], JTask.LOGISTIC_REGRESSION, weights, dtype=np.float64)
    tp, _ = train_glm_reg_path(x[:300], y[:300], TaskType.LOGISTIC_REGRESSION, weights,
                               dtype=torch.float64, device="cpu")
    val = (x[300:], y[300:])
    kw = dict(offset=off[300:], weight=wt[300:])
    jlam, _ = j_select(jp, *val, metric=metric, **kw)
    tlam, tmodel = select_best_glm(tp, *val, metric=metric, device="cpu", **kw)
    assert tlam == jlam and tmodel is dict(tp)[tlam]
    assert tlam not in (weights[0], weights[-1])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card refusal")
def test_select_best_glm_scores_on_the_asked_device():
    """Numpy validation rows go to ``device``, whose default is the card:
    with no card present the default raises, as every entry point does,
    instead of scoring on the CPU unasked."""
    x, y, _, _ = _glm()
    path, _ = train_glm_reg_path(x, y, TaskType.LOGISTIC_REGRESSION, [1.0, 10.0],
                                 dtype=torch.float64, device="cpu")
    for device in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            select_best_glm(path, x, y, **device)


@pytest.mark.parametrize("task", ["linear", "poisson"])
def test_select_best_glm_default_metric_matches_jax(task):
    """Linear and Poisson paths selected by their default metrics (``rmse``,
    ``poisson_loss``) on held-out rows: the JAX package's weight."""
    t_task, j_task = TASKS[task]
    x, y, off, wt = _glm(task, n=900, d=12, seed=10)
    weights = [1e-3, 1.0, 30.0, 300.0, 3000.0]
    jp, _ = j_path(x[:300], y[:300], j_task, weights, dtype=np.float64)
    tp, _ = train_glm_reg_path(x[:300], y[:300], t_task, weights, dtype=torch.float64,
                               device="cpu")
    kw = dict(offset=off[300:], weight=wt[300:])
    jlam, _ = j_select(jp, x[300:], y[300:], **kw)
    tlam, tmodel = select_best_glm(tp, x[300:], y[300:], device="cpu", **kw)
    assert tlam == jlam and tmodel is dict(tp)[tlam]


def test_reference_errors():
    """The reference's ValueErrors (no weights, an empty path, task NONE
    without a metric, an unknown metric, a grouped metric without group
    ids), and the task defaults of linear (``rmse``) and Poisson
    (``poisson_loss``) tasks selecting without an error."""
    x, y, _, _ = _glm()
    with pytest.raises(ValueError, match="at least one regularization weight"):
        train_glm_reg_path(x, y, TaskType.LOGISTIC_REGRESSION, [], device="cpu")
    with pytest.raises(ValueError, match="empty regularization path"):
        select_best_glm([], x, y)
    with pytest.raises(ValueError, match="no default metric"):
        select_best_glm([(1.0, GLMModel(Coefficients(np.zeros(6)), TaskType.NONE))], x, y)
    with pytest.raises(ValueError, match="TRON does not support L1"):
        train_glm_reg_path(x, y, TaskType.LOGISTIC_REGRESSION, [1.0],
                           reg_type=RegularizationType.L1, optimizer=OptimizerType.TRON,
                           device="cpu")
    path = [(1.0, GLMModel(Coefficients(np.zeros(6)), TaskType.LOGISTIC_REGRESSION))]
    with pytest.raises(ValueError, match="not a valid EvaluatorType"):
        select_best_glm(path, x, y, metric="auroc", device="cpu")
    with pytest.raises(ValueError, match="needs group ids"):
        select_best_glm(path, x, y, metric="auc:userId", device="cpu")
    for task in (TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION):
        path = [(1.0, GLMModel(Coefficients(np.zeros(6)), task))]
        assert select_best_glm(path, x, y, device="cpu") == path[0]
