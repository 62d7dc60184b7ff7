"""Per-coordinate configuration.

Port of photon_ml_tpu/game/config.py, holding the fields the port trains
with: variances, each coordinate's ``intercept_index`` (the column that
absorbs a shift normalization, that the INDEX_MAP filter keeps and that
the RANDOM projection passes through), box constraints with their
``constraint_space``, the fixed effect's ``down_sampling_rate``, the
projector with the RANDOM projector's ``projected_dim`` (refused at
construction under any other projector, as the reference refuses it), and
``storage_dtype``: the design held at a narrower float ("bfloat16",
"float16") while the solver state, labels, offsets, weights and the
published coefficients stay at the compute dtype (``storage_torch_dtype``
resolves the name).  The reference's feature sharding arrives with the
multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import (OptimizerType, ProjectorType, TaskType,
                                       VarianceComputationType)

# Per-feature-index box constraints: ((index, lo, hi), ...), as the reference.
ConstraintMap = Tuple[Tuple[int, float, float], ...]

# storage dtype names (the reference resolves them through numpy and
# ml_dtypes, which the port does not use)
_STORAGE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "float32": torch.float32, "float64": torch.float64}


def storage_torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype of a ``storage_dtype`` name, None when unset;
    ValueError for a name it does not know, as ``numpy.dtype`` raises."""
    if name is None:
        return None
    try:
        return _STORAGE_DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown storage dtype {name!r} (expected one of "
                         f"{sorted(_STORAGE_DTYPES)})") from None


@dataclasses.dataclass(frozen=True)
class FixedEffectConfig:
    """One global GLM coordinate."""

    feature_shard: str
    optimizer: OptimizerType = OptimizerType.LBFGS
    solver: Optional[SolverConfig] = None
    reg: Regularization = Regularization()
    # each update trains on a fresh draw: binary tasks keep every positive
    # and each negative with this probability at weight / rate; linear and
    # Poisson tasks keep each row with this probability, unweighted; >= 1
    # keeps every row
    down_sampling_rate: float = 1.0
    variance: VarianceComputationType = VarianceComputationType.NONE
    constraints: Optional[ConstraintMap] = None  # L-BFGS only
    # which coefficients the bounds constrain: "original" (published) or
    # "transformed" (solver space; see _canonicalize_constraints)
    constraint_space: str = "original"
    intercept_index: Optional[int] = None  # column that absorbs a shift normalization
    # the design's width on the device ("bfloat16", "float16"); None keeps the
    # compute dtype.  Products round the coefficients (and residuals) to it and
    # accumulate at the compute dtype
    storage_dtype: Optional[str] = None

    def __post_init__(self):
        storage_torch_dtype(self.storage_dtype)
        _canonicalize_constraints(self)


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
    # in the compact space of its observed columns; RANDOM solves every
    # entity in the span of one shared Gaussian matrix of projected_dim columns
    projector: ProjectorType = ProjectorType.IDENTITY
    projected_dim: Optional[int] = None  # required for ProjectorType.RANDOM
    features_to_samples_ratio: Optional[float] = None  # per-entity Pearson top-k cap
    # column the Pearson filter must keep, and that absorbs a shift normalization
    intercept_index: Optional[int] = None
    variance: VarianceComputationType = VarianceComputationType.NONE
    # Per-entity regularization: multiplicative factors on this coordinate's
    # L2 weight, keyed by entity id (default 1).  Accepts a dict or pairs;
    # stored canonically as a sorted tuple of (int id, float factor).
    per_entity_l2_multipliers: Optional[Tuple[Tuple[int, float], ...]] = None
    # bounds on every entity's coefficients (L-BFGS only), and their space
    constraints: Optional[ConstraintMap] = None
    constraint_space: str = "original"
    storage_dtype: Optional[str] = None  # each bucket's design width (FixedEffectConfig)

    def __post_init__(self):
        storage_torch_dtype(self.storage_dtype)
        m = self.per_entity_l2_multipliers
        if m is not None:
            pairs = m.items() if isinstance(m, dict) else m
            object.__setattr__(self, "per_entity_l2_multipliers",
                               tuple(sorted((int(k), float(v)) for k, v in pairs)))
        if self.projected_dim is not None and self.projector != ProjectorType.RANDOM:
            raise ValueError("projected_dim applies only to ProjectorType.RANDOM "
                             f"(got projector={self.projector.name})")
        _canonicalize_constraints(self)


def _canonicalize_constraints(cfg) -> None:
    """Accept a dict {index: (lo, hi)} or triples (index, lo, hi); store a
    sorted tuple; refuse a duplicate index, lo >= hi and a pair of infinite
    bounds.

    ``constraint_space``: "original" (default) bounds the published
    original-space coefficients, so under scaling normalization the solver's
    box is [lo/f, hi/f] and shift normalization is refused; "transformed"
    applies the bounds as written to the solver-space coefficients, as the
    reference's own optimizers do, and the published coefficients may then
    lie outside them."""
    if cfg.constraint_space not in ("original", "transformed"):
        raise ValueError(f"constraint_space must be 'original' or 'transformed' "
                         f"(got {cfg.constraint_space!r})")
    c = cfg.constraints
    if c is None:
        return
    if isinstance(c, dict):
        c = tuple((int(j), *map(float, bounds)) for j, bounds in c.items())
    else:
        c = tuple((int(j), float(lo), float(hi)) for j, lo, hi in c)
    seen = set()
    for j, lo, hi in c:
        if j in seen:
            raise ValueError(f"duplicate constraint for feature index {j} (later entries "
                             "would silently overwrite earlier bounds)")
        seen.add(j)
        if not lo < hi:
            raise ValueError(f"constraint on feature {j}: lower bound {lo} must be < "
                             f"upper bound {hi}")
        if lo == float("-inf") and hi == float("inf"):
            raise ValueError(f"constraint on feature {j}: both bounds infinite "
                             "(not a constraint)")
    object.__setattr__(cfg, "constraints", tuple(sorted(c)))


CoordinateConfig = Union[FixedEffectConfig, RandomEffectConfig]


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """Ordered coordinates (the order is the descent order) plus the task."""

    task: TaskType
    coordinates: "dict[str, CoordinateConfig]"
    num_outer_iterations: int = 1
