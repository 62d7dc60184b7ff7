"""Carry GAME model weights across between the JAX package and the port.

The exchange format is a plain dict of numpy arrays and strings, so this
module never sees an object of the other package:

    {coordinate_id: {"kind": "fixed", "means": [d], "feature_shard": str,
                     "task": TaskType value},
     coordinate_id: {"kind": "random", "w_stack": [E, d], "slot_of": {id: row},
                     "random_effect_type": str, "feature_shard": str,
                     "task": TaskType value}}

A caller holding a JAX ``GameModel`` fills the dict from its fixed
``coefficients.means`` and its random effects' ``w_stack``, ``slot_of``,
``random_effect_type``, ``feature_shard`` and ``task``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.types import TaskType


def game_model_from_arrays(d: Dict[str, dict]) -> GameModel:
    """The port's GameModel from the exchange dict."""
    models = {}
    for cid, c in d.items():
        task = TaskType(c["task"])
        if c["kind"] == "fixed":
            models[cid] = FixedEffectModel(
                coefficients=Coefficients(means=np.array(c["means"])),
                feature_shard=c["feature_shard"], task=task)
        elif c["kind"] == "random":
            models[cid] = RandomEffectModel(
                w_stack=np.array(c["w_stack"]),
                slot_of={int(k): int(v) for k, v in c["slot_of"].items()},
                random_effect_type=c["random_effect_type"],
                feature_shard=c["feature_shard"], task=task)
        else:
            raise ValueError(f"coordinate {cid!r}: unknown kind {c['kind']!r}")
    return GameModel(models=models)


def game_model_to_arrays(model: GameModel) -> Dict[str, dict]:
    """The exchange dict of the port's GameModel (inverse of the above)."""
    out = {}
    for cid, m in model.models.items():
        if isinstance(m, FixedEffectModel):
            out[cid] = {"kind": "fixed", "means": np.array(m.coefficients.means),
                        "feature_shard": m.feature_shard, "task": m.task.value}
        elif isinstance(m, RandomEffectModel):
            out[cid] = {"kind": "random", "w_stack": np.array(m.w_stack),
                        "slot_of": dict(m.slot_of),
                        "random_effect_type": m.random_effect_type,
                        "feature_shard": m.feature_shard, "task": m.task.value}
        else:
            raise TypeError(f"coordinate {cid!r}: cannot export {type(m).__name__}")
    return out
