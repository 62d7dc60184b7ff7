"""Pointwise GLM losses l(z, y) at margin z = w·x + offset, with closed-form
first and second derivatives in z and the inverse link.

Port of photon_ml_tpu/core/losses.py: the same four losses with the same
conventions (logistic labels in {0,1}; squared l = (z-y)^2/2; Poisson
l = exp(z) - y*z; Rennie's smoothed hinge with labels thresholded at 0.5 and
d2 = 1 strictly inside the quadratic region, 0 outside).

``code`` is the loss's index in the CUDA kernels' loss template
(csrc/glm_losses.cuh); it is the one place the two sides agree on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


def log1p_exp(z: Tensor) -> Tensor:
    """Numerically stable log(1 + exp(z))."""
    return torch.logaddexp(torch.zeros_like(z), z)


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss with derivatives and the GLM mean (inverse link)."""

    name: str
    code: int
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]

    def loss_and_d1(self, z: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
        return self.loss(z, y), self.d1(z, y)


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


logistic_loss = PointwiseLoss(
    name="logistic", code=0,
    loss=lambda z, y: log1p_exp(z) - y * z,
    d1=lambda z, y: torch.sigmoid(z) - y,
    d2=_logistic_d2,
    mean=torch.sigmoid,
)


def _squared_loss(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


squared_loss = PointwiseLoss(
    name="squared", code=1,
    loss=_squared_loss,
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
)

poisson_loss = PointwiseLoss(
    name="poisson", code=2,
    loss=lambda z, y: torch.exp(z) - y * z,
    d1=lambda z, y: torch.exp(z) - y,
    d2=lambda z, y: torch.exp(z),
    mean=torch.exp,
)


def _hinge_sign(y: Tensor) -> Tensor:
    # labels in {0,1}, soft labels thresholded at 0.5 to s in {-1,+1}
    return torch.where(y >= 0.5, 1.0, -1.0).to(y.dtype)


def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    # t >= 1: 0;  t <= 0: 1/2 - t;  else: (1-t)^2 / 2
    t = _hinge_sign(y) * z
    quad = 0.5 * (1.0 - t) ** 2
    return torch.where(t >= 1.0, torch.zeros_like(t),
                       torch.where(t <= 0.0, 0.5 - t, quad))


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    s = _hinge_sign(y)
    t = s * z
    dldt = torch.where(t >= 1.0, torch.zeros_like(t),
                       torch.where(t <= 0.0, -torch.ones_like(t), t - 1.0))
    return s * dldt


def _smoothed_hinge_d2(z: Tensor, y: Tensor) -> Tensor:
    t = _hinge_sign(y) * z
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


smoothed_hinge_loss = PointwiseLoss(
    name="smoothed_hinge", code=3,
    loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    mean=lambda z: z,  # score-based classifier: the raw margin
)

_TASK_LOSS = {
    TaskType.LOGISTIC_REGRESSION: logistic_loss,
    TaskType.LINEAR_REGRESSION: squared_loss,
    TaskType.POISSON_REGRESSION: poisson_loss,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: smoothed_hinge_loss,
}

_NAME_LOSS = {l.name: l for l in _TASK_LOSS.values()}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    try:
        return _TASK_LOSS[task]
    except KeyError:
        raise ValueError(f"no pointwise loss for task {task!r}")


def loss_by_name(name: str) -> PointwiseLoss:
    try:
        return _NAME_LOSS[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; valid: {sorted(_NAME_LOSS)}")
