"""GLM coefficients and models.

Port of ``Coefficients`` and ``GLMModel`` in photon_ml_tpu/models/glm.py:
host numpy means (and optional variances) with their raw dot-product score,
and a trained GLM, the regularization path's model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.core.batch import widened_mv
from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """means[d] + optional variances[d]."""

    means: np.ndarray
    variances: Optional[np.ndarray] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def score(self, x: Tensor) -> Tensor:
        """Raw dot-product scores x @ means, in x's and the means' common dtype
        (a narrow-stored x is widened a row chunk at a time)."""
        return widened_mv(x, torch.as_tensor(self.means, device=x.device))

    @classmethod
    def zeros(cls, dim: int, dtype=np.float32) -> "Coefficients":
        return cls(means=np.zeros(dim, dtype))


@dataclasses.dataclass(frozen=True)
class GLMModel:
    """A trained GLM: coefficients and task."""

    coefficients: Coefficients
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    def score(self, x: Tensor) -> Tensor:
        return self.coefficients.score(x)

    def predict(self, x: Tensor, offset: Optional[Tensor] = None) -> Tensor:
        """The task's mean (inverse link) of x·w plus ``offset``."""
        z = self.score(x)
        if offset is not None:
            z = z + offset
        return loss_for_task(self.task).mean(z)
