"""Training coordinates: the per-coordinate update/score contract.

Port of photon_ml_tpu/game/coordinate.py:

- ``FixedEffectCoordinate``: a dense or sparse shard, no mesh, L-BFGS,
  OWLQN (L1 / elastic net, as one lane of the lane solver) or TRON, with
  optional box constraints under L-BFGS.  The design is laid out on the
  device once; each update re-solves
  with new residual offsets through ``GLMObjective``, in the transformed
  space of the shard's normalization context (warm starts mapped in, the
  model published in original space).  On a dense shard its
  value and gradient (and, under TRON, Hessian-vector products) come from
  the fused CUDA kernels on the card; rows are not padded, the kernels mask
  their ragged last block.  A sparse shard (``SparseBatch``) takes the
  gather / scatter-add path in plain PyTorch, as the JAX package leaves it
  to XLA.
- ``RandomEffectCoordinate``: entities are bucketed once and each bucket
  stays on the device.  A dense shard under the IDENTITY projector solves
  at full width; a dense shard under INDEX_MAP, and every sparse shard
  (``bucket_by_entity_sparse``), solves each entity in the compact space of
  its observed columns and publishes by scattering back to full width.
  Narrow buckets (the reference's gate on the solve-space shapes: solve dim
  <= 16, cap*d^2 <= 2560, a smooth loss) are held lanes-last ([cap, d, L])
  and solved by ``solve_newton_soa``, whose step is the CUDA Newton kernel,
  whichever of L-BFGS and TRON is configured, as in the reference.  Every
  other coordinate holds its buckets lanes-first ([L, cap, d]) and solves
  each with the lane-batched L-BFGS or TRON of ``opt.solve.make_lane_solver``,
  one GLM per lane with its own L2 (the coordinate's weight times the
  entity's multiplier).  The published [E, d] stack is built on the device
  (``publish_stack``).  Scoring covers every sample, including the rows the
  active cap left out of training; on a sparse shard it never builds
  [n, d_full].  A dense IDENTITY coordinate may carry one normalization
  context shared by every entity.  Under compaction the shard's context is
  projected into each entity's compact space, as the reference does: factor
  and shift rows gathered through each lane's column map (padded slots get
  factor 1 and shift 0), and each lane's own compact intercept position,
  into which the coefficient maps fold the shift.  L1 runs the lane OWLQN;
  box constraints run the lane L-BFGS with full-width bounds, or on compact
  lanes with per-lane bounds gathered the same way (padded slots pinned to
  [0, 0]), and unobserved features publish clip(0, lo, hi).  The SoA gate
  excludes normalization, box constraints and L1, as in the reference.
  Under the RANDOM projector every entity solves in the span of one shared
  Gaussian matrix A [d, k] (``parallel/projection.RandomProjection``,
  drawn from the coordinate's seed): a dense shard's buckets are projected
  as x·A on the device, a sparse shard's compact lanes through A's rows at
  their column ids (the [E, S, d] tensor never exists), and the lanes
  publish as lanes·Aᵀ at full width.  A normalization context is then one
  context shared by every entity, pushed through A, with the intercept
  pass-through slot as its intercept, even on a sparse shard.  The Gaussian
  projection has no exact inverse, so every update under RANDOM starts cold
  in the projected space, from a prior model and in a fused sweep alike
  (the reference's fused sweep starts from the previous update's projected
  lanes, and agrees with its host loop only to ~2e-3).  Variances and box
  constraints have no meaning there and are refused, as the reference
  refuses them.

Coefficient variances (SIMPLE: 1 / diag(H); FULL: diag(H⁻¹)) are computed at
the transformed-space optimum of each solve, with the update's offsets, and
mapped through the same coefficient map as the means, as the reference does
(so under STANDARDIZATION the intercept's entry takes -⟨v∘f, s⟩ and can be
negative).  On compact lanes they are expanded to full width with the
prior-only 1/λ2 of each lane's L2 at unobserved features, which is exact:
the full-space Hessian is block-diagonal there.

Over a λ grid a coordinate's device data is built once: ``rebind(config)``
returns a shallow copy that shares it and binds ``config``'s optimization
settings anew (objective, solver, box, per-lane L2, the fixed effect's
context maps; a random effect crossing the SoA gate permutes its buckets on
the device), and raises ValueError where ``config`` needs other data.  The
fixed effect's ``down_sampling_rate`` draws each update's rows on the host
from ``numpy.random.default_rng(seed)``, as the reference's host-paced path
does, and uploads the [n] weight multiplier.

A warm start's entity ids (``existing_model_keys``) shape a random
effect's lanes through the lower bound: an entity under
``min_active_samples`` is left out only when the prior covers it, and its
prior row then passes through the published model unchanged
(``merge_carry_through``) and scores through the model's ``slot_of``.

Narrow storage (``storage_dtype`` "bfloat16" / "float16" on either config):
the fixed effect's design (a sparse shard's values) and each random-effect
solve bucket's design reside on the device at that width, y, offsets and
weights at the compute dtype.  A host array is cast on the host (numpy has
no bfloat16), so what crosses to the device is already narrow; a device
tensor at the storage width is kept without a copy, and one at another
width is cast on the device.  The random effect's full-sample design for
scoring stays at the compute dtype, or at its own width where it is a
device tensor at a narrower one (scoring widens it).  The published
coefficients keep the compute dtype.  A change of ``storage_dtype`` is a
new layout: ``rebind`` refuses it, so ``GameEstimator.fit`` rebuilds.

The sweep interface (``init_sweep_state``, ``trace_update``,
``trace_publish``, ``trace_variances``, ``export_model``,
``carry_through_scores``, ``sweep_key``) is what ``game/fused.FusedSweep``
runs: the same solve as ``update`` on the same offsets and weights
(``_solve_update``), its state, scores and published coefficients left on
the device and nothing copied to the host, so that a fused descent is
bitwise the host loop's.  Publishing, the compact variances and the FULL
variances' Cholesky read nothing on the host either (sink rows and columns
in place of boolean masks; ``cholesky_ex``).  A validated sweep
(``FusedSweep.run_validated``) scores held-out data through
``external_data`` (uploaded once), ``trace_score_external`` and
``carry_through_scores_on``, which compute what the exported model's
``score`` computes, with the same functions at the same dtype, so that its
evaluations are bitwise the host loop's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.batch import DenseBatch, SparseBatch, narrow, widened_mv
from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.core.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.core.objective import GLMObjective, LaneObjective
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.config import (CoordinateConfig, FixedEffectConfig,
                                             RandomEffectConfig, storage_torch_dtype)
from photon_ml_tpu_torch.game.data import GameData, SparseShard
from photon_ml_tpu_torch.models.game import (DatumScoringModel, FixedEffectModel,
                                             RandomEffectModel, _dense_shard, _sparse_shard,
                                             cached_device_copies, dense_random_effect,
                                             seed_device_copies)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.ops.fused_glm import storage_narrowing_ok
from photon_ml_tpu_torch.opt.constraints import box_arrays
from photon_ml_tpu_torch.opt.newton_soa import soa_eligible, solve_newton_soa
from photon_ml_tpu_torch.opt.solve import (check_box_support, check_supported,
                                           compute_soa_variances, compute_variances,
                                           default_config, make_lane_solver, make_solver)
from photon_ml_tpu_torch.opt.types import SolverResult, summarize_solver_results
from photon_ml_tpu_torch.parallel.bucketing import (bucket_by_entity,
                                                    bucket_by_entity_sparse, publish_stack,
                                                    score_samples, score_samples_sparse,
                                                    slots_from)
from photon_ml_tpu_torch.parallel.projection import (RandomProjection,
                                                     build_random_projection,
                                                     check_projector, project_buckets)
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

Tensor = torch.Tensor

# cap * d^2 at or below this keeps a random-effect coordinate on the SoA
# Newton path (the reference gate, game/coordinate.py: cap*d^2/2 <= 1280)
SOA_MAX_CAP_D2 = 2 * 1280


def _refuse_unported(coordinate_id: str, config: CoordinateConfig) -> None:
    """The reference's ValueErrors for the RANDOM projector (variances and
    box constraints have no meaning in a space whose projection mixes
    features), then the optimizer check."""
    where = f"coordinate {coordinate_id!r}: "
    if getattr(config, "projector", None) == ProjectorType.RANDOM:
        if config.variance != VarianceComputationType.NONE:
            raise ValueError(where + "per-entity variances are not defined under a "
                             "RANDOM projection (the Gaussian matrix mixes features)")
        if config.constraints:
            raise ValueError(where + "box constraints have no meaning in a "
                             "RANDOM-projected solve space (the Gaussian matrix mixes "
                             "features); use IDENTITY or INDEX_MAP")
    check_supported(config.optimizer, config.reg.l1)


def _box_from_constraints(constraints, dim: int, dtype: torch.dtype, device: torch.device,
                          norm: Optional[NormalizationContext] = None,
                          space: str = "original") -> Optional[Tuple[Tensor, Tensor]]:
    """(lower, upper) [dim] bounds in the solve space.  With
    ``space="original"`` they bound the published coefficients: under scaling
    (w = f·w') the solver's box is [lo/f, hi/f], and a shift is refused (the
    intercept fold makes per-feature bounds non-separable).  With
    ``space="transformed"`` the bounds apply as written to the solver's
    coefficients whatever the context."""
    if not constraints:
        return None
    if space == "transformed":
        norm = None
    lo, hi = (_as_device(a, dtype, device) for a in box_arrays(
        {j: (low, high) for j, low, high in constraints}, dim, _numpy_dtype(dtype)))
    if norm is not None:
        if norm.shifts is not None:
            raise ValueError(
                "box constraints with shift normalization are not supported "
                "(original-space bounds are non-separable under shifts); use a "
                "scaling-only normalization type, or constraint_space='transformed' "
                "for raw bounds on the transformed iterate")
        if norm.factors is not None:
            f = norm.factors.to(dtype=dtype, device=device)
            lo, hi = lo / f, hi / f
    return lo, hi


def _coordinate_norm(coordinate_id: str, norm: Optional[NormalizationContext],
                     intercept_index: Optional[int], dtype: torch.dtype,
                     device: torch.device) -> NormalizationContext:
    """The coordinate's context in its dtype and on its device (None is the
    identity); a shift needs the intercept column that absorbs it."""
    if norm is None or norm.is_identity:
        return no_normalization()
    if norm.shifts is not None and intercept_index is None:
        raise ValueError(f"coordinate {coordinate_id!r}: shift normalization requires "
                         "an intercept (set intercept_index)")
    return norm.to(dtype, device)


def _numpy_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _as_device(a, dtype: Optional[torch.dtype], device: torch.device) -> Tensor:
    """A contiguous tensor on ``device`` (``dtype`` None keeps the dtype); no
    copy when ``a`` already is one.  A host array is cast on the host, so it
    crosses to the device at ``dtype`` (numpy has no bfloat16)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
        if dtype is not None:
            a = narrow(a, dtype)
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


def _upload_without_wait(a: np.ndarray, device: torch.device) -> Tensor:
    """A host array on ``device``; to a card it goes from pinned memory
    without a blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _storage(config: CoordinateConfig, dtype: torch.dtype) -> torch.dtype:
    """The design's dtype on the device: ``config.storage_dtype``, else the
    compute dtype."""
    return storage_torch_dtype(config.storage_dtype) or dtype

class Coordinate:
    """update/score contract (reference Coordinate.scala:28-81), and the
    sweep interface that ``game/fused.FusedSweep`` runs (module docstring
    of ``game/fused.py``): ``init_sweep_state``, ``trace_update``,
    ``trace_publish``, ``trace_variances``, ``export_model``,
    ``carry_through_scores`` and ``sweep_key``."""

    coordinate_id: str
    config: CoordinateConfig
    norm_source: Optional[NormalizationContext] = None  # the context built with
    _n: int

    @property
    def num_samples(self) -> int:
        return self._n

    def base_offset(self) -> Tensor:
        """Dataset base offsets [n], float64 on the coordinate's device."""
        return self._base_offset

    def update(self, total_offsets: Tensor, seed: int,
               init: Optional[DatumScoringModel]) -> Tuple[DatumScoringModel, object]:
        """Train with residual-folded offsets; returns (model, solver results)."""
        raise NotImplementedError

    def score(self, model: DatumScoringModel) -> Tensor:
        """This coordinate's raw score for every training sample."""
        raise NotImplementedError

    def rebind(self, config: CoordinateConfig) -> "Coordinate":
        """This coordinate's device data under ``config``'s optimization
        settings; ValueError where ``config`` needs other data."""
        raise NotImplementedError

    # -- the sweep interface: every update on the device, nothing read on the
    # host; ``update`` runs the same solve on the same inputs

    def sweep_data(self):
        """The device data a sweep update reads.  The port's coordinates keep
        it themselves (the reference passes it into its compiled program as
        arguments), so None."""
        return None

    def init_sweep_state(self, init: Optional[DatumScoringModel] = None):
        """A sweep's starting state: cold, or the warm start ``init``."""
        raise NotImplementedError

    def trace_update(self, state, offsets: Tensor, key: Optional[Tensor] = None,
                     carried: Optional[Tensor] = None) -> Tuple[object, Tensor]:
        """One update against the residual-folded ``offsets`` [n] (float64 on
        the device): (the next state, this coordinate's score [n] at the
        compute dtype), as ``update`` followed by ``score`` gives them.
        ``key``: the update's down-sampling draw ([n] bool on the device),
        None for none.  ``carried``: the scores of the warm start's entities
        that this coordinate does not retrain (``carry_through_scores``)."""
        raise NotImplementedError

    def trace_publish(self, state) -> Tensor:
        """The state's published coefficients on the device."""
        raise NotImplementedError

    def trace_variances(self, state, offsets: Tensor,
                        key: Optional[Tensor] = None) -> Optional[Tensor]:
        """The published variances at the state's optimum, on the offsets and
        draw that its update solved with; None without variances."""
        raise NotImplementedError

    def export_model(self, published: np.ndarray) -> DatumScoringModel:
        """The model of a published array brought to the host."""
        raise NotImplementedError

    def carry_through_scores(self, init: Optional[DatumScoringModel]
                             ) -> Optional[Tensor]:
        """[n] scores of the warm start's part that an update passes through
        untrained (``merge_carry_through``), None where nothing is carried."""
        return None

    # -- external scoring: the held-out margins of a validated sweep
    # (``FusedSweep.run_validated``).  A coordinate without it inherits these
    # refusals, and the estimator runs the host loop for its validated fits

    def external_data(self, data: GameData):
        """``data``'s inputs for scoring this coordinate's published
        coefficients (``trace_score_external``), on the device once."""
        raise NotImplementedError

    def trace_score_external(self, published: Tensor, vdata) -> Tensor:
        """This coordinate's raw score of every sample of ``external_data``
        from ``published`` (``trace_publish``), computed as the exported
        model's ``score`` computes it."""
        raise NotImplementedError

    def carry_through_scores_on(self, init: Optional[DatumScoringModel],
                                data: GameData) -> Optional[Tensor]:
        """``carry_through_scores`` on the samples of ``data``: the scores of
        the warm start's part that an update passes through, None where
        nothing is carried."""
        return None

    def score_external(self, model: DatumScoringModel, vdata, data: GameData) -> Tensor:
        """``model.score(data)`` on this coordinate's device, from the model's
        device copy and ``vdata`` (``external_data(data)``) where the model
        is laid out as this coordinate publishes, so that nothing crosses to
        the device."""
        return model.score(data, self.base_offset().device)

    def data_key(self) -> tuple:
        """The identity of the device data an update reads."""
        raise NotImplementedError

    def sweep_key(self) -> tuple:
        """What a sweep over this coordinate is built for: the device data
        and every config field except the regularization values, which a
        sweep takes per run.  The L1 regime stays in the key (OWLQN against
        a smooth solver), as the reference keeps it."""
        regime = dataclasses.replace(self.config.reg, l1=1.0 if self.config.reg.l1 > 0 else 0.0,
                                     l2=0.0)
        return self.data_key(), dataclasses.replace(self.config, reg=regime)


# tasks whose down-sampling keeps every positive (DownSamplerHelper.scala)
_BINARY_TASKS = (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


class FixedEffectCoordinate(Coordinate):
    """Global GLM coordinate over a dense or sparse shard."""

    def __init__(self, coordinate_id: str, data: GameData, config: FixedEffectConfig,
                 task: TaskType, dtype: torch.dtype, device: torch.device,
                 norm: Optional[NormalizationContext] = None):
        _refuse_unported(coordinate_id, config)
        self.norm_source = norm
        self._norm = _coordinate_norm(coordinate_id, norm, config.intercept_index, dtype,
                                      device)
        self.coordinate_id = coordinate_id
        self.config = config
        self.task = task
        self.dim = data.shard_dim(config.feature_shard)
        self._n = data.num_samples
        self._dtype = dtype
        self._device = device
        self._base_offset = _as_device(data.offset, torch.float64, device)
        shard = data.features[config.feature_shard]
        rows = dict(y=_as_device(data.y, dtype, device),
                    offset=_as_device(data.offset, dtype, device),
                    weight=_as_device(data.weight, dtype, device))
        sd = _storage(config, dtype)
        if isinstance(shard, SparseShard):
            self._batch = SparseBatch(indices=_as_device(shard.indices, torch.int64, device),
                                      values=_as_device(shard.values, sd, device),
                                      dim=shard.dim, **rows)
        else:
            self._batch = DenseBatch(x=_as_device(shard, sd, device), **rows)
        self._bind_solver()

    def _bind_solver(self) -> None:
        """The objective, box and solver of ``self.config`` over the kept
        batch and context."""
        config = self.config
        self._objective = GLMObjective(loss=loss_for_task(self.task), reg=config.reg,
                                       norm=self._norm)
        box = _box_from_constraints(config.constraints, self.dim, self._dtype, self._device,
                                    self._norm, config.constraint_space)
        self._solve = make_solver(self._objective, config.optimizer, config.solver, box=box)
        # the binary down-sampling rule's positives, on the device; None
        # where no rule needs them
        self._positive = None
        if config.down_sampling_rate < 1.0 and self.task in _BINARY_TASKS:
            self._positive = self._batch.y > 0.5

    def rebind(self, config: FixedEffectConfig) -> "FixedEffectCoordinate":
        """A shallow copy over the same device batch under ``config``'s
        optimization settings; its objective, box and solver are bound
        anew, and so is the context when ``intercept_index`` changes.  A new
        feature shard or storage dtype is a new design: ValueError."""
        if (not isinstance(config, FixedEffectConfig)
                or config.feature_shard != self.config.feature_shard
                or config.storage_dtype != self.config.storage_dtype):
            raise ValueError("rebind cannot change the feature shard or its storage dtype")
        _refuse_unported(self.coordinate_id, config)
        new = copy.copy(self)
        new.config = config
        if config.intercept_index != self.config.intercept_index:
            new._norm = _coordinate_norm(self.coordinate_id, self.norm_source,
                                         config.intercept_index, self._dtype, self._device)
        new._bind_solver()
        return new

    def _down_sample_keep(self, seed: int) -> np.ndarray:
        """[n] rows drawn by this update: the first n of the host stream
        ``default_rng(seed).random`` below the rate (the reference draws its
        padded row count from the same stream, of which these are a
        prefix)."""
        return np.random.default_rng(seed).random(self._n) < self.config.down_sampling_rate

    def _down_sample_mult(self, keep: Tensor) -> Tensor:
        """Per-row weight multipliers of a draw (reference
        DownSamplerHelper.scala:33-40): binary tasks keep every positive and
        reweight kept negatives by 1 / rate; linear and Poisson tasks keep
        the drawn rows, unweighted."""
        mult = keep.to(self._dtype)
        if self.task in _BINARY_TASKS:
            return torch.where(self._positive, 1.0,
                               mult * (1.0 / self.config.down_sampling_rate))
        return mult

    def _down_sample_draw(self, seed: int) -> Optional[Tensor]:
        """The update's [n] draw on the device, None at a rate of 1 or more.
        The draw is the host's; its mask crosses without a wait."""
        if self.config.down_sampling_rate >= 1.0:
            return None
        return _upload_without_wait(self._down_sample_keep(seed), self._device)

    def _down_sample_weights(self, seed: int) -> Tensor:
        """The update's row weights: the data's, times the multipliers of a
        fresh draw when the rate is below 1."""
        return self._update_batch(self._batch.offset, self._down_sample_draw(seed)).weight

    def _update_batch(self, offsets: Tensor, keep: Optional[Tensor]):
        """What an update solves on: the kept batch with ``offsets`` and the
        weights of the draw ``keep`` (None: the data's).  The one definition
        for ``update``, ``trace_update`` and ``trace_variances``."""
        weight = self._batch.weight
        if keep is not None:
            weight = weight * self._down_sample_mult(keep)
        return self._batch.replace(offset=_as_device(offsets, self._dtype, self._device),
                                   weight=weight)

    def _solve_update(self, start: Optional[Tensor], offsets: Tensor,
                      keep: Optional[Tensor]):
        """(solver result, published means, the batch solved on): a solve in
        transformed space from the original-space means ``start`` (None:
        zeros) mapped in, published in original space."""
        ii = self.config.intercept_index
        if start is not None:
            w0 = self._norm.model_to_transformed_space(start, ii)
        else:
            w0 = torch.zeros(self.dim, dtype=self._dtype, device=self._device)
        batch = self._update_batch(offsets, keep)
        res = self._solve(w0, batch)
        return res, self._norm.model_to_original_space(res.w, ii), batch

    def _variances(self, w: Tensor, batch) -> Optional[Tensor]:
        """Original-space variances at the transformed-space optimum ``w``."""
        v = compute_variances(self._objective, w, batch, self.config.variance)
        return (None if v is None else
                self._norm.model_to_original_space(v, self.config.intercept_index))

    def update(self, total_offsets: Tensor, seed: int = 0,
               init: Optional[FixedEffectModel] = None
               ) -> Tuple[FixedEffectModel, SolverResult]:
        """Solve in transformed space from the (original-space) warm start
        mapped in, on this update's (down-sampled) weights; publish means and
        variances in original space."""
        start = None if init is None else self._device_means(init)
        res, means, batch = self._solve_update(start, total_offsets,
                                               self._down_sample_draw(seed))
        variances = self._variances(res.w, batch)
        host_means = means.detach().cpu().numpy()
        model = FixedEffectModel(
            coefficients=Coefficients(
                means=host_means,
                variances=None if variances is None else variances.cpu().numpy()),
            feature_shard=self.config.feature_shard, task=self.task)
        # the published means stay on the device for the next warm start and
        # for scoring
        seed_device_copies(model, (host_means,), (means.detach(),))
        return model, res

    # -- the sweep interface.  State: (the transformed-space optimum, the
    # published means), either None before the first update

    def init_sweep_state(self, init: Optional[FixedEffectModel] = None):
        return None, None if init is None else self._device_means(init)

    def trace_update(self, state, offsets: Tensor, key: Optional[Tensor] = None,
                     carried: Optional[Tensor] = None):
        res, means, _ = self._solve_update(state[1], offsets, key)
        return (res.w, means), self._batch.margins(means)

    def trace_publish(self, state) -> Tensor:
        return state[1]

    def trace_variances(self, state, offsets: Tensor,
                        key: Optional[Tensor] = None) -> Optional[Tensor]:
        return self._variances(state[0], self._update_batch(offsets, key))

    def export_model(self, published: np.ndarray) -> FixedEffectModel:
        return FixedEffectModel(coefficients=Coefficients(means=published),
                                feature_shard=self.config.feature_shard, task=self.task)

    # -- external scoring, as ``FixedEffectModel.score`` scores: the design at
    # its own dtype (the reference uploads it at the compute dtype)

    def external_data(self, data: GameData):
        shard = data.features[self.config.feature_shard]
        if isinstance(shard, SparseShard):
            idx, vals = _sparse_shard(shard, self._device)
            return {"x_idx": idx.long(), "x_val": vals}
        return {"x": _dense_shard(data, self.config.feature_shard, self._device)}

    def trace_score_external(self, published: Tensor, vdata) -> Tensor:
        if "x" in vdata:
            return widened_mv(vdata["x"], published)
        vals = vdata["x_val"]
        dt = torch.promote_types(published.dtype, vals.dtype)
        return (vals.to(dt) * published.to(dt)[vdata["x_idx"]]).sum(dim=-1)

    def score_external(self, model: FixedEffectModel, vdata, data: GameData) -> Tensor:
        if (not isinstance(model, FixedEffectModel)
                or model.feature_shard != self.config.feature_shard):
            return super().score_external(model, vdata, data)
        (w,) = cached_device_copies(model, self._device, model.coefficients.means)
        return self.trace_score_external(w, vdata)

    def data_key(self) -> tuple:
        return "fixed", id(self._batch), id(self.norm_source)

    def _device_means(self, model: FixedEffectModel) -> Tensor:
        """A model's means on the device at the compute dtype: the copy an
        update published with them, or one made once per model."""
        (w,) = cached_device_copies(model, self._device, model.coefficients.means)
        return w.to(self._dtype)

    def score(self, model: FixedEffectModel) -> Tensor:
        return self._batch.margins(self._device_means(model))

    def tracker_summary(self, result: SolverResult) -> dict:
        """The update's solver statistics for the job log."""
        return summarize_solver_results(result)


def _re_data_key(config: RandomEffectConfig) -> tuple:
    """The fields that shape a random-effect coordinate's device data (the
    buckets, the projection and the per-lane contexts); configs that differ
    elsewhere share it through ``rebind``."""
    return (config.random_effect_type, config.feature_shard, config.active_cap,
            config.min_active_samples, config.projector, config.projected_dim,
            config.features_to_samples_ratio, config.intercept_index,
            config.storage_dtype)


def _refuse_lane_context_variances(coordinate_id: str, config: RandomEffectConfig,
                                   per_lane: bool) -> None:
    """Variances with per-lane contexts under compaction: refused, as the
    reference refuses them."""
    if per_lane and config.variance != VarianceComputationType.NONE:
        raise NotImplementedError(
            "coefficient variances under compaction do not support per-entity "
            "normalization contexts; drop the normalization or use an "
            f"uncompacted (IDENTITY, dense) layout (coordinate {coordinate_id!r})")


class RandomEffectCoordinate(Coordinate):
    """Per-entity GLM coordinate over a dense or sparse shard: SoA Newton
    lanes inside the reference's gate, lane-batched L-BFGS / TRON outside
    it; compact solve spaces for INDEX_MAP and every sparse shard not under
    RANDOM, and the shared Gaussian space under RANDOM."""

    def __init__(self, coordinate_id: str, data: GameData, config: RandomEffectConfig,
                 task: TaskType, seed: int, dtype: torch.dtype, device: torch.device,
                 norm: Optional[NormalizationContext] = None,
                 existing_model_keys: Optional[frozenset] = None):
        _refuse_unported(coordinate_id, config)
        shard = data.features[config.feature_shard]
        self._sparse = isinstance(shard, SparseShard)
        random = config.projector == ProjectorType.RANDOM
        if random:
            check_projector(config.projector, config.projected_dim,
                            config.features_to_samples_ratio)
            if (norm is not None and norm.shifts is not None
                    and config.intercept_index is None):
                raise ValueError(
                    f"coordinate {coordinate_id!r}: shift normalization under a RANDOM "
                    "projection needs intercept_index (the Gaussian matrix then carries "
                    "the reference's intercept pass-through slot)")
        # compact solve spaces: the observed columns of each entity, which
        # RANDOM projects further into its shared space
        compact = not random and (self._sparse or config.projector == ProjectorType.INDEX_MAP)
        self.norm_source = norm
        self._norm = _coordinate_norm(coordinate_id, norm, config.intercept_index, dtype,
                                      device)
        # per-lane contexts: the shard's context projected into each entity's
        # compact space (the reference keeps no variances for them)
        per_lane = compact and not self._norm.is_identity
        _refuse_lane_context_variances(coordinate_id, config, per_lane)
        self._compact = compact
        self.coordinate_id = coordinate_id
        self.config = config
        self.task = task
        self.dim = data.shard_dim(config.feature_shard)
        self._n = data.num_samples
        self._dtype = dtype
        self._device = device
        self._loss = loss_for_task(task)
        self._base_offset = _as_device(data.offset, torch.float64, device)
        # a warm start's entity ids: the lower bound drops only entities that
        # the prior covers (their models pass through, ``merge_carry_through``)
        self.existing_model_keys = existing_model_keys
        np_dtype = _numpy_dtype(dtype)
        entity_ids = data.id_tags[config.random_effect_type]
        rows = dict(y=np.asarray(data.y, np_dtype),
                    offset=np.asarray(data.offset, np_dtype),
                    weight=np.asarray(data.weight, np_dtype),
                    active_cap=config.active_cap,
                    min_active_samples=config.min_active_samples, seed=seed,
                    dtype=np_dtype, existing_model_keys=existing_model_keys)

        # solve_buckets: the buckets in the space the solvers see (compact
        # for sparse shards and INDEX_MAP, Gaussian under RANDOM);
        # projections (or the shared matrix) map them back
        projections = None
        self._random: Optional[RandomProjection] = None
        sd = _storage(config, dtype)
        if self._sparse:
            # full-sample scoring stays sparse: [n, k] arrays on the device
            self._x_idx = _as_device(shard.indices, torch.int64, device)
            self._x_val = _as_device(shard.values, dtype, device)
            ratio = (config.features_to_samples_ratio
                     if config.projector == ProjectorType.INDEX_MAP else None)
            self.buckets, projections = bucket_by_entity_sparse(
                entity_ids, shard.indices, shard.values, self.dim,
                features_to_samples_ratio=ratio,
                intercept_index=config.intercept_index, **rows)
            solve_buckets = self.buckets.buckets
            if random:
                # the compact lanes go to the device at the compute dtype and
                # are projected there, then narrowed, as the reference narrows
                # the projected bucket
                self._random = build_random_projection(
                    self.dim, config.projected_dim, seed, dtype=dtype,
                    intercept_index=config.intercept_index, device=device)
                solve_buckets = [dataclasses.replace(b, x=narrow(self._random.project_compact(
                    b.x.to(device), p.indices), sd)) for b, p in zip(solve_buckets, projections)]
                projections = None
        else:
            # the design moves to the device once; the buckets are gathered
            # there.  A device tensor at a narrower width keeps it (scoring
            # widens it), as the reference keeps a device-resident shard
            keep = isinstance(shard, torch.Tensor) and storage_narrowing_ok(shard.dtype, dtype)
            self._x_full = _as_device(shard, shard.dtype if keep else dtype, device)
            self.buckets = bucket_by_entity(entity_ids, self._x_full, **rows)
            solve_buckets = self.buckets.buckets
            if config.projector == ProjectorType.INDEX_MAP:
                proj = project_buckets(self.buckets, config.projector,
                                       features_to_samples_ratio=config.features_to_samples_ratio,
                                       intercept_index=config.intercept_index)
                solve_buckets, projections = proj.buckets, proj.projections
            elif random:
                proj = project_buckets(self.buckets, config.projector,
                                       projected_dim=config.projected_dim,
                                       intercept_index=config.intercept_index, seed=seed)
                self._random = next(iter(proj.projections), None)
                solve_buckets = [dataclasses.replace(b, x=narrow(b.x, sd))
                                 for b in proj.buckets]

        # compact lanes' column ids on the device: they gather the per-lane
        # contexts and bounds, publish the lanes and expand the variances
        self._proj_idx = (None if projections is None else
                          [_as_device(p.indices, torch.int64, device) for p in projections])
        self._lane_norms = None
        if per_lane:
            self._lane_norms = [self._lane_context(idx, b.entity_lanes)
                                for idx, b in zip(self._proj_idx, self.buckets.buckets)]
        # the (context, intercept position) every bucket shares otherwise:
        # the shard's, or under RANDOM the shard's pushed through the matrix
        # with the pass-through slot as its intercept
        self._shared_norm = (self._norm, config.intercept_index)
        if self._random is not None:
            self._shared_norm = self._random.project_normalization(self._norm)
        # (capacity, solve width) of every bucket: the SoA gate's shapes
        self._solve_shapes = [(b.capacity, b.x.shape[2]) for b in solve_buckets]

        # stacked-model slot order = sorted entity id
        self._slot_of = {eid: i for i, eid in enumerate(sorted(self.buckets.lane_of))}
        self._entity_ids = np.asarray(entity_ids, np.int64)
        self._sample_slots = torch.as_tensor(slots_from(self._slot_of, self._entity_ids),
                                             device=device)
        self._lane_slots = [torch.as_tensor(slots_from(self._slot_of, b.entity_lanes),
                                            device=device)
                            for b in self.buckets.buckets]

        # buckets on the device once, lanes-first (x [L, cap, d] at the
        # storage width; y / wt at the compute dtype; rows / valid [L, cap]);
        # ``_bind_solver`` lays them lanes-last (x [cap, d, L]; the rest
        # [cap, L]) for SoA Newton
        widths = dict(x=sd, y=dtype, wt=dtype)
        self._dev = [
            {k: _as_device(v, widths.get(k), device)
             for k, v in dict(x=b.x, y=b.y, wt=b.weight,
                              rows=np.where(b.rows < 0, 0, b.rows).astype(np.int64),
                              valid=b.rows >= 0).items()}
            for b in solve_buckets]
        self.use_soa = False
        self._bind_solver()

    def _bind_solver(self) -> None:
        """What ``self.config``'s optimization settings derive from the kept
        buckets: the box, the SoA gate and the bucket layout it reads, the
        lane solver and each bucket's per-lane L2."""
        config = self.config
        self._box, self._box_lanes, self._box_fill = self._bind_box()
        # the SoA Newton gate (reference game/coordinate.py:1179-1198) on the
        # solve-space shapes: the solve width, the cap*d^2 traffic guard, a
        # smooth loss, no normalization, no box and no L1, under L-BFGS or
        # TRON (a TRON coordinate inside the gate runs SoA Newton).
        worst = max((cap * d ** 2 for cap, d in self._solve_shapes), default=0)
        max_dim = max((d for _, d in self._solve_shapes), default=0)
        use_soa = (soa_eligible(max_dim, self._loss.name) and worst <= SOA_MAX_CAP_D2
                   and self._norm.is_identity and not config.constraints
                   and config.reg.l1 == 0.0
                   and config.optimizer in (OptimizerType.LBFGS, OptimizerType.TRON))
        if use_soa != self.use_soa:
            # one layout at a time, permuted on the device into a new list
            # (a coordinate this one was rebound from keeps its own)
            x_order = (1, 2, 0) if use_soa else (2, 0, 1)
            self._dev = [{k: (v.permute(*x_order) if k == "x" else v.T).contiguous()
                          for k, v in dev.items()} for dev in self._dev]
            self.use_soa = use_soa
        self._solver_config = config.solver or default_config(config.optimizer)
        self._solve_lanes = (None if use_soa else
                             make_lane_solver(self._loss, config.optimizer,
                                              self._solver_config, l1=config.reg.l1))
        # [L] per bucket: the coordinate's L2 weight times each lane's entity
        # multiplier (1 for padding lanes)
        mult = dict(config.per_entity_l2_multipliers or ())
        np_dtype = _numpy_dtype(self._dtype)
        # uploaded without a wait: a sweep rebinds to each grid point's L2
        self._l2 = [config.reg.l2 * _upload_without_wait(
            np.asarray([mult.get(int(e), 1.0) for e in b.entity_lanes], np_dtype),
            self._device) for b in self.buckets.buckets]

    def rebind(self, config: RandomEffectConfig) -> "RandomEffectCoordinate":
        """A shallow copy over the same device buckets under ``config``'s
        optimization settings (regularization, per-entity multipliers,
        optimizer and solver, variances, box): what they derive is bound
        anew, and a change across the SoA gate permutes the buckets on the
        device.  The buckets, and the ``existing_model_keys`` that shaped
        them, carry over.  A change of the data configuration (the fields of
        ``_re_data_key``) is a new layout: ValueError."""
        if (not isinstance(config, RandomEffectConfig)
                or _re_data_key(config) != _re_data_key(self.config)):
            raise ValueError("rebind cannot change the data configuration")
        _refuse_unported(self.coordinate_id, config)
        _refuse_lane_context_variances(self.coordinate_id, config,
                                       self._lane_norms is not None)
        new = copy.copy(self)
        new.config = config
        new._bind_solver()
        return new

    def _lane_context(self, idx: Tensor, entity_lanes: np.ndarray
                      ) -> Tuple[NormalizationContext, Optional[Tensor]]:
        """The shard's context in a compact bucket's lanes: factor and shift
        rows [L, d_compact] gathered through the column ids ``idx`` (padded
        slots: factor 1, shift 0), and under shifts each lane's compact
        intercept position [L], which every entity must observe."""
        obs = idx >= 0
        safe = torch.where(obs, idx, 0)
        f = self._norm.factors
        factors = (torch.where(obs, f[safe], 1.0) if f is not None
                   else torch.ones(idx.shape, dtype=self._dtype, device=idx.device))
        if self._norm.shifts is None:
            return NormalizationContext(factors=factors, shifts=None), None
        shifts = torch.where(obs, self._norm.shifts[safe], 0.0)
        hit = idx == self.config.intercept_index
        valid = torch.as_tensor(np.asarray(entity_lanes) >= 0, device=idx.device)
        if not bool(hit.any(dim=1)[valid].all()):
            raise ValueError(
                f"coordinate {self.coordinate_id!r}: shift normalization under "
                "compaction requires the intercept column (feature "
                f"{self.config.intercept_index}) observed in every entity's active "
                "samples, but some entity never observes it")
        return (NormalizationContext(factors=factors, shifts=shifts),
                hit.to(torch.int8).argmax(dim=1))

    def _bind_box(self):
        """(box, box_lanes, fill): on a dense IDENTITY shard the full-width
        bounds in the solve space; on compact lanes each bucket's per-lane
        bounds in the compact space of each lane's columns (padded slots
        pinned to [0, 0], scaled by the lane's factors) and clip(0, lo, hi),
        the published value of an unobserved feature."""
        cfg = self.config
        if not cfg.constraints:
            return None, None, None
        check_box_support(cfg.optimizer, cfg.reg.l1 > 0.0)
        if not self._compact:
            return _box_from_constraints(cfg.constraints, self.dim, self._dtype,
                                         self._device, self._norm,
                                         cfg.constraint_space), None, None
        where = f"coordinate {self.coordinate_id!r}: "
        if self._norm.shifts is not None:
            raise ValueError(where + "box constraints with shift normalization are not "
                             "supported under compaction (original-space bounds are "
                             "non-separable under shifts; constraint_space='transformed' "
                             "covers non-compact coordinates only)")
        if cfg.constraint_space == "transformed" and not self._norm.is_identity:
            raise ValueError(where + "constraint_space='transformed' is not supported for "
                             "compact (sparse/INDEX_MAP) solves under normalization; use "
                             "the IDENTITY projector for raw bounds on the transformed "
                             "iterate")
        lo, hi = _box_from_constraints(cfg.constraints, self.dim, self._dtype,
                                       self._device)
        box_lanes = []
        for bi, idx in enumerate(self._proj_idx):
            obs = idx >= 0
            safe = torch.where(obs, idx, 0)
            lo_c, hi_c = torch.where(obs, lo[safe], 0.0), torch.where(obs, hi[safe], 0.0)
            if self._lane_norms is not None:  # original-space bounds -> solve space
                f = self._lane_norms[bi][0].factors
                lo_c, hi_c = lo_c / f, hi_c / f
            box_lanes.append((lo_c, hi_c))
        return None, box_lanes, torch.clamp(torch.zeros_like(lo), lo, hi)

    def _bucket_norm(self, bucket_index: int):
        """(context, intercept position) of a bucket's solves: the shared
        context and its intercept (under RANDOM the projected ones), or the
        bucket's per-lane rows and positions."""
        if self._lane_norms is None:
            return self._shared_norm
        return self._lane_norms[bucket_index]

    def _solve_extras(self, bucket_index: int) -> dict:
        """A bucket's context and box, for its lane solve."""
        return dict(norm=self._bucket_norm(bucket_index)[0],
                    box=self._box if self._box_lanes is None
                    else self._box_lanes[bucket_index])

    def _start_rows(self, init: RandomEffectModel) -> Tuple[Tensor, List[Tensor]]:
        """A prior model's stack on the device at the compute dtype, and each
        bucket's lanes' rows in it (-1: unknown).  A model this coordinate
        published keeps its stack and slots on the device; any other crosses
        once."""
        (w_stack,) = cached_device_copies(init, self._device, init.w_stack)
        if init.slot_of == self._slot_of:
            return w_stack.to(self._dtype), self._lane_slots
        return w_stack.to(self._dtype), [
            torch.as_tensor(slots_from(init.slot_of, b.entity_lanes), device=self._device)
            for b in self.buckets.buckets]

    def _warm_start(self, bucket_index: int, w_stack: Tensor, slots: Tensor) -> Tensor:
        """[L, d_solve] start from the rows ``slots`` of ``w_stack``, gathered
        on the device at each lane's compact columns where the bucket is
        compact (zeros for unknown entities and padding columns)."""
        known = slots >= 0
        rows = torch.where(known, slots, 0)
        if self._proj_idx is None:
            w0 = torch.where(known[:, None], w_stack[rows], 0.0)
        else:
            idx = self._proj_idx[bucket_index]
            w0 = torch.where(known[:, None] & (idx >= 0),
                             w_stack[rows[:, None], torch.where(idx >= 0, idx, 0)], 0.0)
        # models are original-space, solves transformed; under per-lane
        # contexts the shift dot is the compact one (observed columns only),
        # the exact inverse of the publish fold: the compact objective has no
        # data term at the unobserved columns to cancel a full-width dot
        norm, ii = self._bucket_norm(bucket_index)
        return norm.model_to_transformed_space(w0, ii)

    def _lanes_to_original(self, lanes: Tensor, bucket_index: int) -> Tensor:
        """A bucket's transformed-space lane vectors [L, d] in original space."""
        norm, ii = self._bucket_norm(bucket_index)
        return norm.model_to_original_space(lanes, ii)

    def _expand_compact_variances(self, v: Tensor, bucket_index: int,
                                  l2: Tensor) -> Tensor:
        """Compact lane variances [L, d_compact] at full width [L, d]:
        unobserved features take the prior-only 1/λ2 of the lane's L2 (the
        entity's multiplier included); padded compact slots are dropped."""
        idx = self._proj_idx[bucket_index]
        fill = 1.0 / torch.clamp(l2, min=1e-30)
        # padded slots write to a sink column past the last, dropped (no
        # boolean mask: its count would be read on the host)
        out = torch.cat([fill[:, None].expand(v.shape[0], self.dim),
                         fill.new_zeros(v.shape[0], 1)], 1)
        rows = torch.arange(v.shape[0], device=v.device)[:, None].expand_as(idx)
        out[rows, torch.where(idx >= 0, idx, self.dim)] = v
        return out[:, :self.dim]

    def _solve_update(self, offsets: Tensor, start: Optional[Tuple[Tensor, List[Tensor]]]
                      ) -> Tuple[List[SolverResult], Tensor]:
        """Every bucket's solve from the rows ``start`` (a stack and each
        bucket's slots in it; None, and always under RANDOM: zeros) against
        ``offsets``: (the solver results, the published [E, d] stack on the
        device: lanes back-projected where compact or projected, unobserved
        features at the box fill, scattered into the stack)."""
        offs = _as_device(offsets, self._dtype, self._device)
        coeffs, results = [], []
        for bi, (b, dev, l2) in enumerate(zip(self.buckets.buckets, self._dev, self._l2)):
            if start is not None and self._random is None:
                w0 = self._warm_start(bi, start[0], start[1][bi])
            else:
                # cold; under RANDOM always, as the Gaussian projection has no
                # exact inverse (and zeros are zeros in any transformed space)
                solve_dim = dev["x"].shape[1 if self.use_soa else 2]
                w0 = torch.zeros((b.num_lanes, solve_dim), dtype=self._dtype,
                                 device=self._device)
            off = self._bucket_offsets(bi, offs)
            if self.use_soa:
                res = solve_newton_soa(self._loss, w0.T.contiguous(), dev["x"], dev["y"],
                                       off, dev["wt"], l2, self._solver_config)
                w_lanes = res.w.T
            else:
                batch = DenseBatch(x=dev["x"], y=dev["y"], offset=off, weight=dev["wt"])
                res = self._solve_lanes(w0, batch, l2, **self._solve_extras(bi))
                w_lanes = res.w
            lanes = self._lanes_to_original(w_lanes, bi)
            coeffs.append(lanes if self._random is None else self._random.back_project(lanes))
            results.append(res)
        w_dev = publish_stack(coeffs, self._lane_slots, len(self._slot_of), self.dim,
                              self._proj_idx, fill=self._box_fill)
        return results, w_dev

    def _bucket_offsets(self, bucket_index: int, offs: Tensor) -> Tensor:
        """The residual offsets gathered into a bucket's layout."""
        dev = self._dev[bucket_index]
        return torch.where(dev["valid"], offs[dev["rows"]], 0.0)

    def _variance_stack(self, lanes: List[Tensor], offsets: Tensor) -> Optional[Tensor]:
        """The published [E, d] variances at each bucket's optimum ``lanes``
        (the solvers' layout) against ``offsets``, full width; None without
        variances."""
        kind = self.config.variance
        if kind == VarianceComputationType.NONE:
            return None
        offs = _as_device(offsets, self._dtype, self._device)
        variances = []
        for bi, (w, dev, l2) in enumerate(zip(lanes, self._dev, self._l2)):
            off = self._bucket_offsets(bi, offs)
            if self.use_soa:
                v = compute_soa_variances(self._loss, w, dev["x"], dev["y"], off,
                                          dev["wt"], l2, kind)
            else:
                batch = DenseBatch(x=dev["x"], y=dev["y"], offset=off, weight=dev["wt"])
                v = compute_variances(LaneObjective(self._loss, l2, self._norm), w, batch,
                                      kind)
            if self._proj_idx is not None:
                v = self._expand_compact_variances(v, bi, l2)
            variances.append(self._lanes_to_original(v, bi))
        return publish_stack(variances, self._lane_slots, len(self._slot_of), self.dim)

    def update(self, total_offsets: Tensor, seed: int = 0,
               init: Optional[RandomEffectModel] = None
               ) -> Tuple[RandomEffectModel, List[SolverResult]]:
        init = None if init is None else dense_random_effect(init)
        results, w_dev = self._solve_update(
            total_offsets, None if init is None else self._start_rows(init))
        var_dev = self._variance_stack([r.w for r in results], total_offsets)
        # the host copy is the model's, and the device stack becomes its
        # scoring copy
        w_stack = w_dev.cpu().numpy()
        model = RandomEffectModel(
            w_stack=w_stack, slot_of=dict(self._slot_of),
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard, task=self.task,
            variances=None if var_dev is None else var_dev.cpu().numpy())
        seed_device_copies(model, (w_stack,), (w_dev,))
        return merge_carry_through(model, init), results

    # -- the sweep interface.  State: (each bucket's optimum in the solvers'
    # layout, the stack the next update starts from, each bucket's rows in
    # it); the optima None before the first update, the stack None for a
    # cold start

    def init_sweep_state(self, init: Optional[RandomEffectModel] = None):
        if init is None:
            return None, None, None
        return (None,) + self._start_rows(dense_random_effect(init))

    def trace_update(self, state, offsets: Tensor, key: Optional[Tensor] = None,
                     carried: Optional[Tensor] = None):
        results, w_dev = self._solve_update(offsets, None if state[1] is None else state[1:])
        score = self._score_stack(w_dev, self._sample_slots)
        if carried is not None:  # a sample is one entity's: one side is 0
            score = score + carried
        return ([r.w for r in results], w_dev, self._lane_slots), score

    def trace_publish(self, state) -> Tensor:
        return state[1]

    def trace_variances(self, state, offsets: Tensor,
                        key: Optional[Tensor] = None) -> Optional[Tensor]:
        return self._variance_stack(state[0], offsets)

    def export_model(self, published: np.ndarray) -> RandomEffectModel:
        return RandomEffectModel(w_stack=published, slot_of=dict(self._slot_of),
                                 random_effect_type=self.config.random_effect_type,
                                 feature_shard=self.config.feature_shard, task=self.task)

    def carry_through_scores(self, init: Optional[RandomEffectModel]) -> Optional[Tensor]:
        if init is None:
            return None
        init = dense_random_effect(init)
        carried = [eid for eid in init.slot_of if eid not in self._slot_of]
        if not carried:
            return None
        slots = np.where(np.isin(self._entity_ids, carried),
                         slots_from(init.slot_of, self._entity_ids), -1)
        (w,) = cached_device_copies(init, self._device, init.w_stack)
        return self._score_stack(w.to(self._dtype), torch.as_tensor(slots, device=self._device))

    # -- external scoring, as ``RandomEffectModel.score`` scores: the design at
    # its own dtype (the reference uploads it at the compute dtype); entities
    # this coordinate does not train take slot -1 and score 0

    def external_data(self, data: GameData):
        shard = data.features[self.config.feature_shard]
        ids = np.asarray(data.id_tags[self.config.random_effect_type], np.int64)
        out = {"slots": torch.as_tensor(slots_from(self._slot_of, ids), device=self._device)}
        if isinstance(shard, SparseShard):
            out["x_idx"], out["x_val"] = _sparse_shard(shard, self._device)
        else:
            out["x"] = _dense_shard(data, self.config.feature_shard, self._device)
        return out

    def trace_score_external(self, published: Tensor, vdata) -> Tensor:
        if "x" in vdata:
            x = vdata["x"]
            dt = torch.promote_types(x.dtype, published.dtype)
            return score_samples(published.to(dt), vdata["slots"], x.to(dt))
        return score_samples_sparse(published, vdata["slots"], vdata["x_idx"],
                                    vdata["x_val"].to(published.dtype))

    def carry_through_scores_on(self, init: Optional[RandomEffectModel],
                                data: GameData) -> Optional[Tensor]:
        """The carried rows as ``merge_carry_through`` publishes them (at the
        published dtype), scored by ``RandomEffectModel.score``: on each
        sample exactly one of this and the trained score is nonzero."""
        if init is None:
            return None
        init = dense_random_effect(init)
        carried = sorted(eid for eid in init.slot_of if eid not in self._slot_of)
        if not carried:
            return None
        rows = np.stack([init.w_stack[init.slot_of[eid]] for eid in carried]
                        ).astype(_numpy_dtype(self._dtype))
        model = dataclasses.replace(init, w_stack=rows, variances=None,
                                    slot_of={eid: i for i, eid in enumerate(carried)})
        return model.score(data, self._device)

    def score_external(self, model: RandomEffectModel, vdata, data: GameData) -> Tensor:
        if (not isinstance(model, RandomEffectModel) or model.slot_of != self._slot_of
                or model.feature_shard != self.config.feature_shard):
            return super().score_external(model, vdata, data)
        (w,) = cached_device_copies(model, self._device, model.w_stack)
        return self.trace_score_external(w, vdata)

    def data_key(self) -> tuple:
        return "random", id(self.buckets), id(self.norm_source)

    def score(self, model: RandomEffectModel) -> Tensor:
        model = dense_random_effect(model)
        (w,) = cached_device_copies(model, self._device, model.w_stack)
        if model.slot_of == self._slot_of:
            slots = self._sample_slots
        else:
            slots = torch.as_tensor(slots_from(model.slot_of, self._entity_ids),
                                    device=self._device)
        return self._score_stack(w.to(self._dtype), slots)

    def _score_stack(self, w: Tensor, slots: Tensor) -> Tensor:
        """Every sample's score against the rows ``slots`` of ``w``."""
        if self._sparse:
            return score_samples_sparse(w, slots, self._x_idx, self._x_val)
        return score_samples(w, slots, self._x_full)

    def tracker_summary(self, results: List[SolverResult]) -> dict:
        """Statistics over the update's per-entity solves, one result per
        bucket, padding lanes left out."""
        masks = [np.asarray(b.entity_lanes) >= 0 for b in self.buckets.buckets]
        return summarize_solver_results(list(results), valid_masks=masks)


def merge_carry_through(model: RandomEffectModel,
                        init: Optional[RandomEffectModel]) -> RandomEffectModel:
    """Prior-model entities this update did not retrain keep their old
    coefficients in the published model (the reference's leftOuterJoin
    passthrough, RandomEffectCoordinate.scala:114-127).  Where the model has
    variances, carried rows keep the prior's, or 0 ("not estimated") when the
    prior has none."""
    if init is None:
        return model
    carried = sorted(eid for eid in init.slot_of if eid not in model.slot_of)
    if not carried:
        return model
    rows = np.stack([init.w_stack[init.slot_of[eid]] for eid in carried]
                    ).astype(model.w_stack.dtype)
    slot_of = dict(model.slot_of)
    for i, eid in enumerate(carried):
        slot_of[eid] = len(model.slot_of) + i
    var_stack = model.variances
    if var_stack is not None:
        vrows = (np.stack([init.variances[init.slot_of[eid]] for eid in carried])
                 .astype(rows.dtype) if init.variances is not None
                 else np.zeros_like(rows))
        var_stack = np.concatenate([var_stack, vrows])
    return dataclasses.replace(model, w_stack=np.concatenate([model.w_stack, rows]),
                               slot_of=slot_of, variances=var_stack)


def build_coordinate(coordinate_id: str, data: GameData, config: CoordinateConfig,
                     task: TaskType, seed: int = 0, dtype: torch.dtype = torch.float32,
                     device: "torch.device | str" = "cuda",
                     norm: Optional[NormalizationContext] = None,
                     existing_model_keys: Optional[frozenset] = None) -> Coordinate:
    """Construct the coordinate for ``config`` on ``device`` (default: the
    card, raising when none is present), in the transformed space of
    ``norm`` (the shard's normalization context; None is the identity).
    ``existing_model_keys``: a warm start's entity ids for a random effect's
    lower bound (``parallel.bucketing._group_rows``)."""
    device = resolve_device(device)
    if isinstance(config, FixedEffectConfig):
        return FixedEffectCoordinate(coordinate_id, data, config, task, dtype, device,
                                     norm)
    if isinstance(config, RandomEffectConfig):
        return RandomEffectCoordinate(coordinate_id, data, config, task, seed, dtype,
                                      device, norm, existing_model_keys)
    raise TypeError(f"unknown coordinate config {type(config)!r}")
