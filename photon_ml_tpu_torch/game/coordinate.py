"""Training coordinates: the per-coordinate update/score contract.

Port of photon_ml_tpu/game/coordinate.py for this slice:

- ``FixedEffectCoordinate``: a dense shard, no mesh, L-BFGS.  The design is
  laid out on the device once; each update re-solves with new residual
  offsets through ``GLMObjective``, whose value and gradient come from the
  fused CUDA kernel on the card.  Rows are not padded: the kernel masks its
  ragged last block.
- ``RandomEffectCoordinate``: a dense shard, the IDENTITY projector and the
  structure-of-arrays Newton branch only.  Entities are bucketed once; each
  bucket is held on the device lanes-last ([cap, d, L]) and every update runs
  ``solve_newton_soa`` per bucket, whose step is the CUDA Newton kernel.
  Scoring covers every sample, including the rows the active cap left out
  of training.

Anything outside the slice raises NotImplementedError naming the ROADMAP item
that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.batch import DenseBatch
from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.core.objective import GLMObjective
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.config import (CoordinateConfig, FixedEffectConfig,
                                             RandomEffectConfig)
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.models.game import (DatumScoringModel, FixedEffectModel,
                                             RandomEffectModel)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.opt.newton_soa import soa_eligible, solve_newton_soa
from photon_ml_tpu_torch.opt.solve import check_supported, make_solver
from photon_ml_tpu_torch.opt.types import SolverConfig, SolverResult
from photon_ml_tpu_torch.parallel.bucketing import (bucket_by_entity, score_samples,
                                                    slots_from, stacked_coefficients)
from photon_ml_tpu_torch.types import OptimizerType, TaskType

Tensor = torch.Tensor

# cap * d^2 at or below this keeps a random-effect coordinate on the SoA
# Newton path (the reference gate, game/coordinate.py: cap*d^2/2 <= 1280)
SOA_MAX_CAP_D2 = 2 * 1280
_NON_SOA = ("random-effect lanes outside the SoA Newton gate (d <= 16, "
            "cap*d^2 <= 2560, a smooth loss) need the vmapped per-lane solver, "
            "not ported yet: ROADMAP.md 'Next slices', non-SoA random-effect lanes")


def _numpy_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _as_device(a, dtype: torch.dtype, device: torch.device) -> Tensor:
    """A contiguous tensor on ``device``; no copy when ``a`` already is one."""
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
    """Global GLM coordinate over a dense shard."""

    def __init__(self, coordinate_id: str, data: GameData, config: FixedEffectConfig,
                 task: TaskType, dtype: torch.dtype, device: torch.device):
        check_supported(config.optimizer, config.reg.l1)
        self.coordinate_id = coordinate_id
        self.config = config
        self.task = task
        self.dim = data.shard_dim(config.feature_shard)
        self._n = data.num_samples
        self._dtype = dtype
        self._device = device
        self._base_offset = _as_device(data.offset, torch.float64, device)
        self._batch = DenseBatch(
            x=_as_device(data.features[config.feature_shard], dtype, device),
            y=_as_device(data.y, dtype, device),
            offset=_as_device(data.offset, dtype, device),
            weight=_as_device(data.weight, dtype, device))
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
    """Per-entity GLM coordinate over a dense shard, SoA Newton lanes."""

    def __init__(self, coordinate_id: str, data: GameData, config: RandomEffectConfig,
                 task: TaskType, seed: int, dtype: torch.dtype, device: torch.device):
        if config.reg.l1 > 0.0 or config.optimizer == OptimizerType.OWLQN:
            check_supported(OptimizerType.OWLQN, config.reg.l1)
        if config.optimizer not in (OptimizerType.LBFGS, OptimizerType.TRON):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
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

        # the design moves to the device once; the buckets are gathered there
        self._x_full = _as_device(data.features[config.feature_shard], dtype, device)
        entity_ids = data.id_tags[config.random_effect_type]
        self.buckets = bucket_by_entity(
            entity_ids, self._x_full, np.asarray(data.y, np_dtype),
            offset=np.asarray(data.offset, np_dtype),
            weight=np.asarray(data.weight, np_dtype),
            active_cap=config.active_cap,
            min_active_samples=config.min_active_samples, seed=seed, dtype=np_dtype)

        # the SoA Newton gate (reference game/coordinate.py:1183-1210); with no
        # normalization, box or L1 in this slice, what remains is the width,
        # the cap*d^2 traffic guard and a smooth loss
        worst = max((b.capacity * self.dim * self.dim for b in self.buckets.buckets),
                    default=0)
        if not (soa_eligible(self.dim, self._loss.name) and worst <= SOA_MAX_CAP_D2):
            raise NotImplementedError(f"coordinate {coordinate_id!r}: {_NON_SOA}")
        self._solver_config = config.solver or SolverConfig.lbfgs_default()

        # stacked-model slot order = sorted entity id (stacked_coefficients)
        self._slot_of = {eid: i for i, eid in enumerate(sorted(self.buckets.lane_of))}
        self._entity_ids = np.asarray(entity_ids, np.int64)
        self._sample_slots = torch.as_tensor(slots_from(self._slot_of, self._entity_ids),
                                             device=device)

        # buckets lanes-last, once: x [cap, d, L]; y / wt / rows / valid [cap, L]
        self._dev = []
        for b in self.buckets.buckets:
            self._dev.append(dict(
                x_t=b.x.permute(1, 2, 0).contiguous(),
                y_t=_as_device(b.y.T, dtype, device),
                wt_t=_as_device(b.weight.T, dtype, device),
                rows_t=torch.as_tensor(
                    np.ascontiguousarray(np.where(b.rows < 0, 0, b.rows).T, np.int64),
                    device=device),
                valid_t=torch.as_tensor(np.ascontiguousarray((b.rows >= 0).T),
                                        device=device),
                l2=torch.full((b.num_lanes,), config.reg.l2, dtype=dtype, device=device)))

    def _warm_start(self, bucket_index: int, init: RandomEffectModel) -> Tensor:
        """[d, L] start from a prior model's rows (zeros for unknown entities)."""
        b = self.buckets.buckets[bucket_index]
        slots = slots_from(init.slot_of, b.entity_lanes)
        w_stack = np.asarray(init.w_stack, _numpy_dtype(self._dtype))
        w0 = np.where((slots >= 0)[:, None], w_stack[np.where(slots >= 0, slots, 0)], 0.0)
        return _as_device(w0.T, self._dtype, self._device)

    def update(self, total_offsets: Tensor, seed: int = 0,
               init: Optional[RandomEffectModel] = None
               ) -> Tuple[RandomEffectModel, List[SolverResult]]:
        offs = _as_device(total_offsets, self._dtype, self._device)
        coeffs, results = [], []
        for bi, (b, dev) in enumerate(zip(self.buckets.buckets, self._dev)):
            if init is not None:
                w0 = self._warm_start(bi, init)
            else:
                w0 = torch.zeros((self.dim, b.num_lanes), dtype=self._dtype,
                                 device=self._device)
            # residual offsets gathered into the bucket layout
            off_t = torch.where(dev["valid_t"], offs[dev["rows_t"]], 0.0)
            res = solve_newton_soa(self._loss, w0, dev["x_t"], dev["y_t"], off_t,
                                   dev["wt_t"], dev["l2"], self._solver_config)
            coeffs.append(res.w.T)
            results.append(res)
        w_stack, slot_of = stacked_coefficients(coeffs, self.buckets)
        model = RandomEffectModel(
            w_stack=w_stack, slot_of=slot_of,
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard, task=self.task)
        return merge_carry_through(model, init), results

    def score(self, model: RandomEffectModel) -> Tensor:
        w = _as_device(model.w_stack, self._dtype, self._device)
        if model.slot_of == self._slot_of:
            slots = self._sample_slots
        else:
            slots = torch.as_tensor(slots_from(model.slot_of, self._entity_ids),
                                    device=self._device)
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
