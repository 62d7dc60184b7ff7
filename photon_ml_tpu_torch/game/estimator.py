"""GameEstimator: the top-level fit API.

Port of photon_ml_tpu/game/estimator.py along its host-paced path
(``GameEstimator(fused=False)``, the parity target): build the coordinates
on the device once, run coordinate descent per configuration, and warm-start
each configuration from the previous one's model.  ``normalization`` maps a
feature shard to the context that every coordinate on that shard solves
under (models come out in original space).  The whole-sweep fused program
(``FusedSweep``), locked coordinates and checkpoints are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.core.normalization import NormalizationContext
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.config import GameConfig
from photon_ml_tpu_torch.game.coordinate import Coordinate, build_coordinate
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.descent import CoordinateDescent, DescentHistory
from photon_ml_tpu_torch.models.game import GameModel


def torch_dtype(dtype) -> torch.dtype:
    """torch.float32/float64 from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"compute dtype must be float32 or float64, not {dtype!r}")
    return out


@dataclasses.dataclass(eq=False)
class GameFitResult:
    """One (configuration, model, validation) outcome."""

    model: GameModel
    config: GameConfig
    evaluation: Optional[EvaluationResults]
    history: DescentHistory


class GameEstimator:
    """fit() over one or more GAME configurations, warm-starting each from
    the previous one.

    ``device``: where the coordinates live and train; the default ``"cuda"``
    raises when no card is present.  ``dtype``: compute precision
    (float32 on the card; float64 for reference-precision runs).
    ``normalization``: feature shard -> ``NormalizationContext``, applied to
    every coordinate on that shard, fixed and random alike."""

    def __init__(self, device: "str | torch.device" = DEFAULT_DEVICE,
                 validation_suite: Optional[EvaluationSuite] = None,
                 dtype=torch.float32,
                 normalization: Optional[Dict[str, NormalizationContext]] = None):
        self.device = resolve_device(device)
        self.validation_suite = validation_suite
        self.dtype = torch_dtype(dtype)
        self.normalization = normalization or {}

    def fit(self, data: GameData, configs: Sequence[GameConfig],
            validation_data: Optional[GameData] = None,
            seed: int = 0) -> List[GameFitResult]:
        results: List[GameFitResult] = []
        warm: Optional[GameModel] = None
        prev: Dict[str, Coordinate] = {}
        for config in configs:
            coordinates = {}
            for cid, ccfg in config.coordinates.items():
                norm = self.normalization.get(ccfg.feature_shard)
                old = prev.get(cid)
                if (old is not None and old.config == ccfg and old.task == config.task
                        and old.norm_source is norm):
                    coordinates[cid] = old  # same data layout, solver and context: reuse
                else:
                    coordinates[cid] = build_coordinate(
                        cid, data, ccfg, config.task, seed=seed, dtype=self.dtype,
                        device=self.device, norm=norm)
            prev = coordinates
            validation = None
            if validation_data is not None and self.validation_suite is not None:
                validation = (validation_data, self.validation_suite)
            descent = CoordinateDescent(coordinates, order=list(config.coordinates),
                                        num_iterations=config.num_outer_iterations,
                                        validation=validation)
            model, history, ev = descent.run(self.device, initial=warm, seed=seed)
            results.append(GameFitResult(model=model, config=config, evaluation=ev,
                                         history=history))
            warm = model
        return results
