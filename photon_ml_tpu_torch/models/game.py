"""GAME model containers: fixed effect, dense random effect, composite model.

Port of photon_ml_tpu/models/game.py (``FixedEffectModel``, the dense
``RandomEffectModel`` and ``GameModel``).  Coefficients live on the host as
numpy; scoring moves them to the device it runs on.  A random effect is a
stacked matrix W[num_entities, d] plus an entity-id -> row map; entities
without a model score 0.  The compact sparse container and its
``_match_dot_kernel`` scoring are a later slice.

``score(data, device=...)`` defaults to the card (``device="cuda"``) and
raises there when no card is present; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.parallel.bucketing import score_samples, slots_from
from photon_ml_tpu_torch.types import TaskType

if TYPE_CHECKING:
    from photon_ml_tpu_torch.game.data import GameData

Tensor = torch.Tensor


class DatumScoringModel:
    """Contract: raw per-sample scores of a GameData."""

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        raise NotImplementedError


def _shard(data: "GameData", shard: str, device: torch.device) -> Tensor:
    return torch.as_tensor(data.features[shard], device=device)


@dataclasses.dataclass(frozen=True)
class FixedEffectModel(DatumScoringModel):
    """Global GLM over one feature shard."""

    coefficients: Coefficients
    feature_shard: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        dev = resolve_device(device)
        return self.coefficients.score(_shard(data, self.feature_shard, dev))


@dataclasses.dataclass(frozen=True)
class RandomEffectModel(DatumScoringModel):
    """Per-entity GLMs as a stacked coefficient matrix:
    ``w_stack[slot_of[entity_id]]`` is that entity's coefficient vector."""

    w_stack: np.ndarray  # [num_entities, d]
    slot_of: Dict[int, int]
    random_effect_type: str  # the id-tag column name
    feature_shard: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    @property
    def num_entities(self) -> int:
        return self.w_stack.shape[0]

    def slots_for(self, data: "GameData") -> np.ndarray:
        return slots_from(self.slot_of, data.id_tags[self.random_effect_type])

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        dev = resolve_device(device)
        x = _shard(data, self.feature_shard, dev)
        w = torch.as_tensor(self.w_stack, device=dev)
        dt = torch.promote_types(x.dtype, w.dtype)
        slots = torch.as_tensor(self.slots_for(data), device=dev)
        return score_samples(w.to(dt), slots, x.to(dt))


@dataclasses.dataclass
class GameModel:
    """Composite model: coordinate id -> scoring model."""

    models: Dict[str, DatumScoringModel]

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        """Sum of the coordinates' raw scores (float64, offsets not added)."""
        from photon_ml_tpu_torch.game.scoring import additive_total

        dev = resolve_device(device)
        return additive_total(data.num_samples,
                              (m.score(data, dev) for m in self.models.values()),
                              device=dev)

    def __getitem__(self, cid: str) -> DatumScoringModel:
        return self.models[cid]

    def __contains__(self, cid: str) -> bool:
        return cid in self.models
