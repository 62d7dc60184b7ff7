"""Shared enums and type aliases.

Reference: photon-lib .../TaskType.scala:25, .../Types.scala:21-44,
optimization/VarianceComputationType.scala:25, util/ConvergenceReason.scala:38.
"""

from __future__ import annotations

import enum
from typing import Mapping, Tuple

# Reference Types.scala: UniqueSampleId = Long, CoordinateId/REType/REId/FeatureShardId = String.
UniqueSampleId = int
CoordinateId = str
REType = str
REId = str
FeatureShardId = str

# Box constraints: feature index -> (lower, upper).  Reference OptimizationUtils.scala.
ConstraintMap = Mapping[int, Tuple[float, float]]


class TaskType(enum.Enum):
    """Training-task types (reference TaskType.scala:25)."""

    LOGISTIC_REGRESSION = "logistic_regression"
    LINEAR_REGRESSION = "linear_regression"
    POISSON_REGRESSION = "poisson_regression"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "smoothed_hinge_loss_linear_svm"
    NONE = "none"


class VarianceComputationType(enum.Enum):
    """Coefficient-variance computation (reference VarianceComputationType.scala:25).

    SIMPLE = 1 / diag(H); FULL = diag(H^-1) via Cholesky
    (reference DistributedOptimizationProblem.scala:84-108).
    """

    NONE = "none"
    SIMPLE = "simple"
    FULL = "full"


class ConvergenceReason(enum.IntEnum):
    """Why an optimizer stopped (reference util/ConvergenceReason.scala:38).

    IntEnum with a stable device-side encoding: solvers carry the reason as an
    int32 inside jitted while_loops; NOT_CONVERGED means still running.
    """

    NOT_CONVERGED = 0
    FUNCTION_VALUES_CONVERGED = 1
    GRADIENT_CONVERGED = 2
    MAX_ITERATIONS = 3
    OBJECTIVE_NOT_IMPROVING = 4


class NormalizationType(enum.Enum):
    """Feature-normalization flavors (reference NormalizationType.scala:42)."""

    NONE = "none"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    STANDARDIZATION = "standardization"


class OptimizerType(enum.Enum):
    """Reference OptimizerType.scala:23 {LBFGS, TRON} + OWLQN (selected implicitly
    by L1 regularization in the reference; explicit here)."""

    LBFGS = "lbfgs"
    TRON = "tron"
    OWLQN = "owlqn"


class ProjectorType(enum.Enum):
    """Random-effect feature projection (reference ProjectorType.scala:30)."""

    IDENTITY = "identity"
    INDEX_MAP = "index_map"
    RANDOM = "random"
