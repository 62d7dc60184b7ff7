"""GAME training: data, configuration, coordinates, descent and the estimator."""

from photon_ml_tpu_torch.game.config import (FixedEffectConfig, GameConfig,
                                             RandomEffectConfig)
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.estimator import GameEstimator, GameFitResult

__all__ = ["FixedEffectConfig", "GameConfig", "GameData", "GameEstimator",
           "GameFitResult", "RandomEffectConfig"]
