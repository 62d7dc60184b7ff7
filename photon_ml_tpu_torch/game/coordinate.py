"""Training coordinates: the per-coordinate update/score contract.

Port of photon_ml_tpu/game/coordinate.py for dense shards:

- ``FixedEffectCoordinate``: a dense shard, no mesh, L-BFGS or TRON.  The
  design is laid out on the device once; each update re-solves with new
  residual offsets through ``GLMObjective``, whose value and gradient (and,
  under TRON, Hessian-vector products) come from the fused CUDA kernels on
  the card.  Rows are not padded: the kernels mask their ragged last block.
- ``RandomEffectCoordinate``: a dense shard and the IDENTITY projector.
  Entities are bucketed once and each bucket stays on the device.  Narrow
  buckets (the reference's gate: solve dim <= 16, cap*d^2 <= 2560, a smooth
  loss) are held lanes-last ([cap, d, L]) and solved by ``solve_newton_soa``,
  whose step is the CUDA Newton kernel, whichever of L-BFGS and TRON is
  configured, as in the reference.  Every other coordinate holds its buckets
  lanes-first ([L, cap, d]) and solves each with the lane-batched L-BFGS or
  TRON of ``opt.solve.make_lane_solver``, one GLM per lane with its own L2
  (the coordinate's weight times the entity's multiplier).  Scoring covers
  every sample, including the rows the active cap left out of training.

Anything outside the port raises NotImplementedError naming the ROADMAP item
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
from photon_ml_tpu_torch.opt.solve import (check_supported, default_config,
                                           make_lane_solver, make_solver)
from photon_ml_tpu_torch.opt.types import SolverResult
from photon_ml_tpu_torch.parallel.bucketing import (bucket_by_entity, score_samples,
                                                    slots_from, stacked_coefficients)
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
    if getattr(config, "projector", ProjectorType.IDENTITY) != ProjectorType.IDENTITY:
        raise NotImplementedError(
            where + f"the {config.projector.name} projector is not ported yet: "
            "ROADMAP.md 'Modules still to port', random-effect projectors")
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
    """Global GLM coordinate over a dense shard."""

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
    """Per-entity GLM coordinate over a dense shard: SoA Newton lanes inside
    the reference's gate, lane-batched L-BFGS / TRON outside it."""

    def __init__(self, coordinate_id: str, data: GameData, config: RandomEffectConfig,
                 task: TaskType, seed: int, dtype: torch.dtype, device: torch.device):
        _refuse_unported(coordinate_id, config)
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

        # the SoA Newton gate (reference game/coordinate.py:1184-1198); with no
        # normalization, box or L1 in the port, what remains is the solve
        # width, the cap*d^2 traffic guard and a smooth loss.  The optimizer
        # does not enter: a TRON coordinate inside the gate runs SoA Newton.
        worst = max((b.capacity * b.x.shape[2] ** 2 for b in self.buckets.buckets),
                    default=0)
        max_dim = max((b.x.shape[2] for b in self.buckets.buckets), default=0)
        self.use_soa = soa_eligible(max_dim, self._loss.name) and worst <= SOA_MAX_CAP_D2
        self._solver_config = config.solver or default_config(config.optimizer)
        if not self.use_soa:
            self._solve_lanes = make_lane_solver(self._loss, config.optimizer,
                                                 self._solver_config)

        # stacked-model slot order = sorted entity id (stacked_coefficients)
        self._slot_of = {eid: i for i, eid in enumerate(sorted(self.buckets.lane_of))}
        self._entity_ids = np.asarray(entity_ids, np.int64)
        self._sample_slots = torch.as_tensor(slots_from(self._slot_of, self._entity_ids),
                                             device=device)

        # buckets on the device once, lanes-last for SoA Newton (x [cap, d, L];
        # y / wt / rows / valid [cap, L]), else lanes-first (x [L, cap, d];
        # the rest [L, cap]); l2 [L] is the coordinate's weight times each
        # lane's entity multiplier (1 for padding lanes)
        mult = dict(config.per_entity_l2_multipliers or ())
        self._dev = []
        for b in self.buckets.buckets:
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
        """[L, d] start from a prior model's rows (zeros for unknown entities)."""
        b = self.buckets.buckets[bucket_index]
        slots = slots_from(init.slot_of, b.entity_lanes)
        w_stack = np.asarray(init.w_stack, _numpy_dtype(self._dtype))
        w0 = np.where((slots >= 0)[:, None], w_stack[np.where(slots >= 0, slots, 0)], 0.0)
        return _as_device(w0, self._dtype, self._device)

    def update(self, total_offsets: Tensor, seed: int = 0,
               init: Optional[RandomEffectModel] = None
               ) -> Tuple[RandomEffectModel, List[SolverResult]]:
        offs = _as_device(total_offsets, self._dtype, self._device)
        coeffs, results = [], []
        for bi, (b, dev) in enumerate(zip(self.buckets.buckets, self._dev)):
            if init is not None:
                w0 = self._warm_start(bi, init)
            else:
                w0 = torch.zeros((b.num_lanes, self.dim), dtype=self._dtype,
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
