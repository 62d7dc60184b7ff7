"""Per-coordinate configuration.

Port of photon_ml_tpu/game/config.py, holding the fields the port trains
with, plus the reference's variance, box-constraint and projector fields,
whose non-default values the coordinates refuse (NotImplementedError naming
the ROADMAP item that brings them; the RANDOM projector is one of them), and
the INDEX_MAP projector's ``features_to_samples_ratio`` / ``intercept_index``.
The rest of the reference's fields (``projected_dim`` of the RANDOM
projector, down-sampling, storage dtypes, feature sharding) arrive with the
slices that carry them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

# Per-feature-index box constraints: ((index, lo, hi), ...), as the reference.
ConstraintMap = Tuple[Tuple[int, float, float], ...]


@dataclasses.dataclass(frozen=True)
class FixedEffectConfig:
    """One global GLM coordinate."""

    feature_shard: str
    optimizer: OptimizerType = OptimizerType.LBFGS
    solver: Optional[SolverConfig] = None
    reg: Regularization = Regularization()
    variance: VarianceComputationType = VarianceComputationType.NONE
    constraints: Optional[ConstraintMap] = None


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
    # Feature projection: INDEX_MAP (and any sparse shard) solves each entity
    # in the compact space of its observed columns
    projector: ProjectorType = ProjectorType.IDENTITY
    features_to_samples_ratio: Optional[float] = None  # per-entity Pearson top-k cap
    intercept_index: Optional[int] = None  # column the Pearson filter must keep
    variance: VarianceComputationType = VarianceComputationType.NONE
    # Per-entity regularization: multiplicative factors on this coordinate's
    # L2 weight, keyed by entity id (default 1).  Accepts a dict or pairs;
    # stored canonically as a sorted tuple of (int id, float factor).
    per_entity_l2_multipliers: Optional[Tuple[Tuple[int, float], ...]] = None
    constraints: Optional[ConstraintMap] = None

    def __post_init__(self):
        m = self.per_entity_l2_multipliers
        if m is not None:
            pairs = m.items() if isinstance(m, dict) else m
            object.__setattr__(self, "per_entity_l2_multipliers",
                               tuple(sorted((int(k), float(v)) for k, v in pairs)))


CoordinateConfig = Union[FixedEffectConfig, RandomEffectConfig]


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """Ordered coordinates (the order is the descent order) plus the task."""

    task: TaskType
    coordinates: "dict[str, CoordinateConfig]"
    num_outer_iterations: int = 1
