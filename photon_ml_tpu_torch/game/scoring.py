"""Shared score composition: the one definition of GAME additive scoring.

Port of photon_ml_tpu/game/scoring.py: the total score is the sum of the
coordinates' raw margins, accumulated from zero in coordinate order; the
raw score adds the data's offsets, and the output transform is the task's
inverse link of it.  Scores are float64 tensors, as in the reference's
double-precision mode (the reference returns numpy arrays).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable

import torch

from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.types import TaskType

if TYPE_CHECKING:
    from photon_ml_tpu_torch.game.data import GameData
    from photon_ml_tpu_torch.models.game import GameModel

Tensor = torch.Tensor


def additive_total(num_samples: int, margins: Iterable[Tensor],
                   device: "torch.device | str" = "cpu") -> Tensor:
    """Sum per-coordinate raw margins [n] into the total score vector."""
    total = torch.zeros(num_samples, dtype=torch.float64, device=device)
    for m in margins:
        total = total + m
    return total


def raw_scores(model: "GameModel", data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
    """The model's total margin plus the data's offsets, per sample: what
    the evaluators and the mean transform take."""
    dev = resolve_device(device)
    return model.score(data, dev) + torch.as_tensor(data.offset, device=dev)


def output_scores(raw: Tensor, task: TaskType, predict_mean: bool = False) -> Tensor:
    """Raw margins, or the task's inverse-link mean of them."""
    return loss_for_task(task).mean(raw) if predict_mean else raw
