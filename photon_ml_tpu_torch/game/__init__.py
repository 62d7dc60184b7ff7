"""GAME training: data, configuration, coordinates, descent and the estimator."""

from photon_ml_tpu_torch.game.config import (FixedEffectConfig, GameConfig,
                                             RandomEffectConfig)
from photon_ml_tpu_torch.game.data import GameData, SparseShard
from photon_ml_tpu_torch.game.estimator import (GameEstimator, GameFitResult,
                                                GameTransformer)

__all__ = ["FixedEffectConfig", "GameConfig", "GameData", "GameEstimator",
           "GameFitResult", "GameTransformer", "RandomEffectConfig", "SparseShard"]
