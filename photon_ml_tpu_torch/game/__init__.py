"""GAME training: data, configuration, coordinates, descent and the estimator."""

from photon_ml_tpu_torch.game.config import (FixedEffectConfig, GameConfig,
                                             RandomEffectConfig)
from photon_ml_tpu_torch.game.data import GameData, SparseShard
from photon_ml_tpu_torch.game.estimator import (GameEstimator, GameFitResult,
                                                GameTransformer)
from photon_ml_tpu_torch.game.fused import FusedSweep

__all__ = ["FixedEffectConfig", "FusedSweep", "GameConfig", "GameData", "GameEstimator",
           "GameFitResult", "GameTransformer", "RandomEffectConfig", "SparseShard"]
