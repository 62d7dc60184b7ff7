"""Regularization-path GLM training, the reference's legacy single-model API.

Port of photon_ml_tpu/models/training.py (reference
ModelTraining.trainGeneralizedLinearModel:106-228 and
ModelSelection.scala:29-92).  ``train_glm_reg_path`` trains one GLM per
regularization weight, in descending order, each warm-started from the
previous weight's solution; ``select_best_glm`` picks the (weight, model)
with the best validation metric.

The design may be a numpy array or a tensor; a tensor already on the device
is used where it lies, so a design made on the card never crosses to the
host.  A dense design on the card runs the fused value-and-gradient kernel
(and, under TRON, the Hessian-vector kernel) through ``GLMObjective``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.batch import dense_batch
from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.core.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.core.objective import GLMObjective
from photon_ml_tpu_torch.core.regularization import Regularization, RegularizationType
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype
from photon_ml_tpu_torch.evaluation.evaluator import make_evaluator
from photon_ml_tpu_torch.models.glm import Coefficients, GLMModel
from photon_ml_tpu_torch.opt.solve import (check_box_support, check_supported,
                                           compute_variances, make_solver)
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

Tensor = torch.Tensor

# the legacy API's model-selection metric by task (ModelSelection.scala)
DEFAULT_METRIC = {
    TaskType.LOGISTIC_REGRESSION: "auc",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "auc",
    TaskType.LINEAR_REGRESSION: "rmse",
    TaskType.POISSON_REGRESSION: "poisson_loss",
}


def _tensor(a, dtype: Optional[torch.dtype], device) -> Tensor:
    """``a`` as a tensor on ``device``; no copy when it already is one."""
    return torch.as_tensor(a if isinstance(a, Tensor) else np.asarray(a), dtype=dtype,
                           device=device)


def train_glm_reg_path(
    x,
    y,
    task: TaskType,
    reg_weights: Sequence[float],
    reg_type: RegularizationType = RegularizationType.L2,
    elastic_net_alpha: float = 1.0,
    optimizer: OptimizerType = OptimizerType.LBFGS,
    solver: Optional[SolverConfig] = None,
    offset=None,
    weight=None,
    norm: Optional[NormalizationContext] = None,
    intercept_index: Optional[int] = None,
    box=None,
    warm_start_models: Optional[Dict[float, GLMModel]] = None,
    use_warm_start: bool = True,
    variance: VarianceComputationType = VarianceComputationType.NONE,
    dtype=torch.float32,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> Tuple[List[Tuple[float, GLMModel]], Dict[float, SolverResult]]:
    """Train one GLM per regularization weight along a warm-started path.

    Returns ``(weight, model)`` pairs in descending weight order (the
    training order) and each weight's ``SolverResult``.  Each weight starts
    from the previous weight's transformed-space solution (with
    ``use_warm_start``), else from the largest-weight model of
    ``warm_start_models`` mapped in, else from zeros.  Whether the path runs
    OWLQN is fixed by the first weight given: OWLQN, or L-BFGS with that
    weight's L1 part above 0.  Under ``norm`` the solves run in its
    transformed space and the models (means and variances) are published in
    original space, the shift folded into ``intercept_index``.  ``box`` is
    (lower [d], upper [d]) in the solve space, for L-BFGS."""
    if not reg_weights:
        raise ValueError("need at least one regularization weight")
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    x = _tensor(x, dtype, device)
    n, d = x.shape
    batch = dense_batch(x, _tensor(y, dtype, device),
                        None if offset is None else _tensor(offset, dtype, device),
                        None if weight is None else _tensor(weight, dtype, device))
    norm_ctx = no_normalization() if norm is None else norm.to(dtype, device)
    if box is not None:
        box = tuple(_tensor(b, dtype, device) for b in box)

    reg0 = Regularization.from_context(reg_type, float(reg_weights[0]), elastic_net_alpha)
    check_supported(optimizer, reg0.l1)
    if box is not None:
        check_box_support(optimizer, reg0.l1 > 0.0)
    owlqn = optimizer == OptimizerType.OWLQN or (optimizer == OptimizerType.LBFGS
                                                 and reg0.l1 > 0.0)
    loss = loss_for_task(task)

    path: List[Tuple[float, GLMModel]] = []
    trackers: Dict[float, SolverResult] = {}
    prev_w: Optional[Tensor] = None
    for lam in sorted((float(w) for w in reg_weights), reverse=True):
        if prev_w is not None and use_warm_start:
            w0 = prev_w
        elif warm_start_models:
            means = warm_start_models[max(warm_start_models)].coefficients.means
            w0 = norm_ctx.model_to_transformed_space(_tensor(means, dtype, device),
                                                     intercept_index)
        else:
            w0 = torch.zeros(d, dtype=dtype, device=device)
        reg = Regularization.from_context(reg_type, lam, elastic_net_alpha)
        objective = GLMObjective(loss=loss, reg=reg, norm=norm_ctx)
        # the first weight's dispatch: a smooth solver leaves an L1 part out
        solve = make_solver(
            objective if owlqn else GLMObjective(loss=loss, reg=Regularization(l2=reg.l2),
                                                 norm=norm_ctx),
            OptimizerType.OWLQN if owlqn else optimizer, solver, box=box)
        res = solve(w0, batch)
        prev_w = res.w
        v = compute_variances(objective, res.w, batch, variance)
        means = norm_ctx.model_to_original_space(res.w, intercept_index)
        variances = None if v is None else norm_ctx.model_to_original_space(
            v, intercept_index)
        path.append((lam, GLMModel(
            coefficients=Coefficients(
                means=means.cpu().numpy(),
                variances=None if variances is None else variances.cpu().numpy()),
            task=task)))
        trackers[lam] = res
    return path, trackers


def select_best_glm(path: List[Tuple[float, GLMModel]], x_val, y_val,
                    metric: Optional[str] = None, offset=None, weight=None,
                    device: "str | torch.device" = DEFAULT_DEVICE) -> Tuple[float, GLMModel]:
    """The (weight, model) of ``path`` with the best ``metric`` on the
    validation rows, the first among equals; the metric defaults to the
    task's (``DEFAULT_METRIC``).  The validation rows are scored on
    ``device`` (a tensor already there is used in place) and evaluated in
    float64."""
    if not path:
        raise ValueError("empty regularization path")
    task = path[0][1].task
    if metric is None:
        if task == TaskType.NONE:
            raise ValueError("task NONE has no default metric; pass metric=")
        metric = DEFAULT_METRIC[task]
    evaluator = make_evaluator(metric)
    device = resolve_device(device)
    x_val = _tensor(x_val, None, device)
    as_f64 = lambda a: _tensor(a, torch.float64, device)
    n = x_val.shape[0]
    y_val = as_f64(y_val)
    offset = torch.zeros(n, dtype=torch.float64, device=device) if offset is None \
        else as_f64(offset)
    weight = torch.ones(n, dtype=torch.float64, device=device) if weight is None \
        else as_f64(weight)
    best: Optional[Tuple[float, GLMModel, float]] = None
    for lam, model in path:
        value = evaluator.evaluate(model.score(x_val).double() + offset, y_val, weight)
        if best is None or evaluator.better_than(value, best[2]):
            best = (lam, model, value)
    return best[0], best[1]
