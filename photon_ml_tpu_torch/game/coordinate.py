"""Training coordinates: the per-coordinate update/score contract.

Port of photon_ml_tpu/game/coordinate.py:

- ``FixedEffectCoordinate``: a dense or sparse shard, no mesh, L-BFGS or
  TRON.  The design is laid out on the device once; each update re-solves
  with new residual offsets through ``GLMObjective``.  On a dense shard its
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
  [n, d_full].

Anything outside the port raises NotImplementedError naming the ROADMAP item
that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.batch import DenseBatch, SparseBatch
from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.core.objective import GLMObjective
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.config import (CoordinateConfig, FixedEffectConfig,
                                             RandomEffectConfig)
from photon_ml_tpu_torch.game.data import GameData, SparseShard
from photon_ml_tpu_torch.models.game import (DatumScoringModel, FixedEffectModel,
                                             RandomEffectModel, cached_device_copies,
                                             dense_random_effect, seed_device_copies)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.opt.newton_soa import soa_eligible, solve_newton_soa
from photon_ml_tpu_torch.opt.solve import (check_supported, default_config,
                                           make_lane_solver, make_solver)
from photon_ml_tpu_torch.opt.types import SolverResult
from photon_ml_tpu_torch.parallel.bucketing import (bucket_by_entity,
                                                    bucket_by_entity_sparse, publish_stack,
                                                    score_samples, score_samples_sparse,
                                                    slots_from)
from photon_ml_tpu_torch.parallel.projection import RANDOM_REFUSAL, project_buckets
from photon_ml_tpu_torch.types import ProjectorType, TaskType, VarianceComputationType

Tensor = torch.Tensor

# cap * d^2 at or below this keeps a random-effect coordinate on the SoA
# Newton path (the reference gate, game/coordinate.py: cap*d^2/2 <= 1280)
SOA_MAX_CAP_D2 = 2 * 1280


def _refuse_unported(coordinate_id: str, config: CoordinateConfig) -> None:
    """Raise NotImplementedError for the configuration fields the port does
    not carry yet, naming the ROADMAP item; then the optimizer check."""
    where = f"coordinate {coordinate_id!r}: "
    if config.variance != VarianceComputationType.NONE:
        raise NotImplementedError(
            where + "coefficient variances are not ported yet: ROADMAP.md 'Next "
            "slices', variances (hessian_diag / hessian, compute_variances)")
    if config.constraints:
        raise NotImplementedError(
            where + "box constraints are not ported yet: ROADMAP.md 'Modules "
            "still to port', opt/constraints.py and the projected L-BFGS")
    if getattr(config, "projector", None) == ProjectorType.RANDOM:
        raise NotImplementedError(where + RANDOM_REFUSAL)
    check_supported(config.optimizer, config.reg.l1)


def _numpy_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _as_device(a, dtype: Optional[torch.dtype], device: torch.device) -> Tensor:
    """A contiguous tensor on ``device`` (``dtype`` None keeps the dtype); no
    copy when ``a`` already is one."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

class Coordinate:
    """update/score contract (reference Coordinate.scala:28-81)."""

    coordinate_id: str
    config: CoordinateConfig
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


class FixedEffectCoordinate(Coordinate):
    """Global GLM coordinate over a dense or sparse shard."""

    def __init__(self, coordinate_id: str, data: GameData, config: FixedEffectConfig,
                 task: TaskType, dtype: torch.dtype, device: torch.device):
        _refuse_unported(coordinate_id, config)
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
        if isinstance(shard, SparseShard):
            self._batch = SparseBatch(indices=_as_device(shard.indices, torch.int64, device),
                                      values=_as_device(shard.values, dtype, device),
                                      dim=shard.dim, **rows)
        else:
            self._batch = DenseBatch(x=_as_device(shard, dtype, device), **rows)
        self._objective = GLMObjective(loss=loss_for_task(task), reg=config.reg)
        self._solve = make_solver(self._objective, config.optimizer, config.solver)

    def update(self, total_offsets: Tensor, seed: int = 0,
               init: Optional[FixedEffectModel] = None
               ) -> Tuple[FixedEffectModel, SolverResult]:
        if init is not None:
            w0 = _as_device(init.coefficients.means, self._dtype, self._device)
        else:
            w0 = torch.zeros(self.dim, dtype=self._dtype, device=self._device)
        offs = _as_device(total_offsets, self._dtype, self._device)
        res = self._solve(w0, self._batch.replace(offset=offs))
        model = FixedEffectModel(
            coefficients=Coefficients(means=res.w.detach().cpu().numpy()),
            feature_shard=self.config.feature_shard, task=self.task)
        return model, res

    def score(self, model: FixedEffectModel) -> Tensor:
        w = _as_device(model.coefficients.means, self._dtype, self._device)
        return self._batch.margins(w)


class RandomEffectCoordinate(Coordinate):
    """Per-entity GLM coordinate over a dense or sparse shard: SoA Newton
    lanes inside the reference's gate, lane-batched L-BFGS / TRON outside
    it; compact solve spaces for INDEX_MAP and every sparse shard."""

    def __init__(self, coordinate_id: str, data: GameData, config: RandomEffectConfig,
                 task: TaskType, seed: int, dtype: torch.dtype, device: torch.device):
        _refuse_unported(coordinate_id, config)
        shard = data.features[config.feature_shard]
        self._sparse = isinstance(shard, SparseShard)
        self.coordinate_id = coordinate_id
        self.config = config
        self.task = task
        self.dim = data.shard_dim(config.feature_shard)
        self._n = data.num_samples
        self._dtype = dtype
        self._device = device
        self._loss = loss_for_task(task)
        self._base_offset = _as_device(data.offset, torch.float64, device)
        np_dtype = _numpy_dtype(dtype)
        entity_ids = data.id_tags[config.random_effect_type]
        rows = dict(y=np.asarray(data.y, np_dtype),
                    offset=np.asarray(data.offset, np_dtype),
                    weight=np.asarray(data.weight, np_dtype),
                    active_cap=config.active_cap,
                    min_active_samples=config.min_active_samples, seed=seed,
                    dtype=np_dtype)

        # solve_buckets: the buckets in the space the solvers see (compact
        # for sparse shards and INDEX_MAP); projections map them back
        self._projections = None
        if self._sparse:
            # full-sample scoring stays sparse: [n, k] arrays on the device
            self._x_idx = _as_device(shard.indices, torch.int64, device)
            self._x_val = _as_device(shard.values, dtype, device)
            ratio = (config.features_to_samples_ratio
                     if config.projector == ProjectorType.INDEX_MAP else None)
            self.buckets, self._projections = bucket_by_entity_sparse(
                entity_ids, shard.indices, shard.values, self.dim,
                features_to_samples_ratio=ratio,
                intercept_index=config.intercept_index, **rows)
            solve_buckets = self.buckets.buckets
        else:
            # the design moves to the device once; the buckets are gathered there
            self._x_full = _as_device(shard, dtype, device)
            self.buckets = bucket_by_entity(entity_ids, self._x_full, **rows)
            solve_buckets = self.buckets.buckets
            if config.projector == ProjectorType.INDEX_MAP:
                proj = project_buckets(self.buckets, config.projector,
                                       config.features_to_samples_ratio,
                                       config.intercept_index)
                solve_buckets, self._projections = proj.buckets, proj.projections

        # the SoA Newton gate (reference game/coordinate.py:1179-1198) on the
        # solve-space shapes; with no normalization, box or L1 in the port,
        # what remains is the solve width, the cap*d^2 traffic guard and a
        # smooth loss.  The optimizer does not enter: a TRON coordinate
        # inside the gate runs SoA Newton.
        worst = max((b.capacity * b.x.shape[2] ** 2 for b in solve_buckets), default=0)
        max_dim = max((b.x.shape[2] for b in solve_buckets), default=0)
        self.use_soa = soa_eligible(max_dim, self._loss.name) and worst <= SOA_MAX_CAP_D2
        self._solver_config = config.solver or default_config(config.optimizer)
        if not self.use_soa:
            self._solve_lanes = make_lane_solver(self._loss, config.optimizer,
                                                 self._solver_config)

        # stacked-model slot order = sorted entity id
        self._slot_of = {eid: i for i, eid in enumerate(sorted(self.buckets.lane_of))}
        self._entity_ids = np.asarray(entity_ids, np.int64)
        self._sample_slots = torch.as_tensor(slots_from(self._slot_of, self._entity_ids),
                                             device=device)
        self._lane_slots = [torch.as_tensor(slots_from(self._slot_of, b.entity_lanes),
                                            device=device)
                            for b in self.buckets.buckets]

        # buckets on the device once, lanes-last for SoA Newton (x [cap, d, L];
        # y / wt / rows / valid [cap, L]), else lanes-first (x [L, cap, d];
        # the rest [L, cap]); l2 [L] is the coordinate's weight times each
        # lane's entity multiplier (1 for padding lanes)
        mult = dict(config.per_entity_l2_multipliers or ())
        self._dev = []
        for b in solve_buckets:
            lane_major = dict(
                x=b.x, y=b.y, wt=b.weight,
                rows=np.where(b.rows < 0, 0, b.rows).astype(np.int64),
                valid=b.rows >= 0)
            if self.use_soa:
                lane_major = {k: (v.permute(1, 2, 0) if k == "x" else v.T)
                              for k, v in lane_major.items()}
            dev = {k: _as_device(v, dtype if k in ("x", "y", "wt") else None, device)
                   for k, v in lane_major.items()}
            m = np.asarray([mult.get(int(e), 1.0) for e in b.entity_lanes], np_dtype)
            dev["l2"] = config.reg.l2 * torch.as_tensor(m, device=device)
            self._dev.append(dev)

    def _warm_start(self, bucket_index: int, init: RandomEffectModel) -> Tensor:
        """[L, d_solve] start from a prior model's rows, gathered at each
        lane's compact columns where the bucket is compact (zeros for unknown
        entities and padding columns)."""
        b = self.buckets.buckets[bucket_index]
        slots = slots_from(init.slot_of, b.entity_lanes)
        known = slots >= 0
        rows = np.where(known, slots, 0)
        w_stack = np.asarray(init.w_stack, _numpy_dtype(self._dtype))
        if self._projections is None:
            w0 = np.where(known[:, None], w_stack[rows], 0.0)
        else:
            idx = self._projections[bucket_index].indices
            w0 = np.where(known[:, None] & (idx >= 0),
                          w_stack[rows[:, None], np.where(idx >= 0, idx, 0)], 0.0)
        return _as_device(w0, self._dtype, self._device)

    def update(self, total_offsets: Tensor, seed: int = 0,
               init: Optional[RandomEffectModel] = None
               ) -> Tuple[RandomEffectModel, List[SolverResult]]:
        init = None if init is None else dense_random_effect(init)
        offs = _as_device(total_offsets, self._dtype, self._device)
        coeffs, results = [], []
        for bi, (b, dev) in enumerate(zip(self.buckets.buckets, self._dev)):
            if init is not None:
                w0 = self._warm_start(bi, init)
            else:
                solve_dim = dev["x"].shape[1 if self.use_soa else 2]
                w0 = torch.zeros((b.num_lanes, solve_dim), dtype=self._dtype,
                                 device=self._device)
            # residual offsets gathered into the bucket layout
            off = torch.where(dev["valid"], offs[dev["rows"]], 0.0)
            if self.use_soa:
                res = solve_newton_soa(self._loss, w0.T.contiguous(), dev["x"], dev["y"],
                                       off, dev["wt"], dev["l2"], self._solver_config)
                coeffs.append(res.w.T)
            else:
                batch = DenseBatch(x=dev["x"], y=dev["y"], offset=off, weight=dev["wt"])
                res = self._solve_lanes(w0, batch, dev["l2"])
                coeffs.append(res.w)
            results.append(res)
        # publish: lanes (back-projected where compact) scattered into the
        # [E, d] stack on the device; the host copy is the model's, and the
        # device stack becomes its scoring copy
        w_dev = publish_stack(coeffs, self._lane_slots, len(self._slot_of), self.dim,
                              self._projections)
        w_stack = w_dev.cpu().numpy()
        model = RandomEffectModel(
            w_stack=w_stack, slot_of=dict(self._slot_of),
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard, task=self.task)
        seed_device_copies(model, (w_stack,), (w_dev,))
        return merge_carry_through(model, init), results

    def score(self, model: RandomEffectModel) -> Tensor:
        model = dense_random_effect(model)
        (w,) = cached_device_copies(model, self._device, model.w_stack)
        w = w.to(self._dtype)
        if model.slot_of == self._slot_of:
            slots = self._sample_slots
        else:
            slots = torch.as_tensor(slots_from(model.slot_of, self._entity_ids),
                                    device=self._device)
        if self._sparse:
            return score_samples_sparse(w, slots, self._x_idx, self._x_val)
        return score_samples(w, slots, self._x_full)


def merge_carry_through(model: RandomEffectModel,
                        init: Optional[RandomEffectModel]) -> RandomEffectModel:
    """Prior-model entities this update did not retrain keep their old
    coefficients in the published model (the reference's leftOuterJoin
    passthrough, RandomEffectCoordinate.scala:114-127)."""
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
    return dataclasses.replace(model, w_stack=np.concatenate([model.w_stack, rows]),
                               slot_of=slot_of)


def build_coordinate(coordinate_id: str, data: GameData, config: CoordinateConfig,
                     task: TaskType, seed: int = 0, dtype: torch.dtype = torch.float32,
                     device: "torch.device | str" = "cuda") -> Coordinate:
    """Construct the coordinate for ``config`` on ``device`` (default: the
    card, raising when none is present)."""
    device = resolve_device(device)
    if isinstance(config, FixedEffectConfig):
        return FixedEffectCoordinate(coordinate_id, data, config, task, dtype, device)
    if isinstance(config, RandomEffectConfig):
        return RandomEffectCoordinate(coordinate_id, data, config, task, seed, dtype,
                                      device)
    raise TypeError(f"unknown coordinate config {type(config)!r}")
