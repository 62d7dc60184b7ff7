"""Per-coordinate configuration.

Port of photon_ml_tpu/game/config.py, holding the fields this slice trains
with.  The rest of the reference's fields (down-sampling, normalization
intercepts, variances, storage dtypes, feature sharding, constraints,
projectors, per-entity L2 multipliers) arrive with the slices that carry
them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import OptimizerType, TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectConfig:
    """One global GLM coordinate."""

    feature_shard: str
    optimizer: OptimizerType = OptimizerType.LBFGS
    solver: Optional[SolverConfig] = None
    reg: Regularization = Regularization()


@dataclasses.dataclass(frozen=True)
class RandomEffectConfig:
    """One per-entity coordinate."""

    random_effect_type: str  # id-tag column with entity ids
    feature_shard: str
    optimizer: OptimizerType = OptimizerType.LBFGS
    solver: Optional[SolverConfig] = None
    reg: Regularization = Regularization()
    active_cap: Optional[int] = None  # per-entity sample cap (reservoir)
    min_active_samples: int = 1  # lower-bound entity filter


CoordinateConfig = Union[FixedEffectConfig, RandomEffectConfig]


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """Ordered coordinates (the order is the descent order) plus the task."""

    task: TaskType
    coordinates: "dict[str, CoordinateConfig]"
    num_outer_iterations: int = 1
