"""Carry GAME model weights across between the JAX package and the port.

The exchange format is a plain dict of numpy arrays and strings, so this
module never sees an object of the other package:

    {coordinate_id: {"kind": "fixed", "means": [d], "variances": [d] or None,
                     "feature_shard": str, "task": TaskType value},
     coordinate_id: {"kind": "random", "w_stack": [E, d],
                     "variances": [E, d] or None, "slot_of": {id: row},
                     "random_effect_type": str, "feature_shard": str,
                     "task": TaskType value},
     coordinate_id: {"kind": "compact", "indices": [E, k] int32,
                     "values": [E, k], "dim": int, "slot_of": {id: row},
                     "random_effect_type": str, "feature_shard": str,
                     "task": TaskType value}}

A caller holding a JAX ``GameModel`` fills the dict from its fixed
``coefficients.means`` and ``coefficients.variances``, its dense random
effects' ``w_stack`` and ``variances`` (a missing "variances" key reads as
None), and its
``CompactRandomEffectModel``s' ``indices``, ``values`` and ``dim``, each
with ``slot_of``, ``random_effect_type``, ``feature_shard`` and ``task``.
Compact rows are checked on the way in (``models.game.check_compact_rows``):
sorted ascending, unique ids, padding last, as scoring relies on.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from photon_ml_tpu_torch.models.game import (CompactRandomEffectModel, FixedEffectModel,
                                             GameModel, RandomEffectModel,
                                             check_compact_rows)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.types import TaskType


def _slot_of(c: dict) -> Dict[int, int]:
    return {int(k): int(v) for k, v in c["slot_of"].items()}


def _array_or_none(a) -> Optional[np.ndarray]:
    return None if a is None else np.array(a)


def game_model_from_arrays(d: Dict[str, dict]) -> GameModel:
    """The port's GameModel from the exchange dict."""
    models = {}
    for cid, c in d.items():
        task = TaskType(c["task"])
        if c["kind"] == "fixed":
            models[cid] = FixedEffectModel(
                coefficients=Coefficients(means=np.array(c["means"]),
                                          variances=_array_or_none(c.get("variances"))),
                feature_shard=c["feature_shard"], task=task)
        elif c["kind"] == "random":
            models[cid] = RandomEffectModel(
                w_stack=np.array(c["w_stack"]), slot_of=_slot_of(c),
                random_effect_type=c["random_effect_type"],
                feature_shard=c["feature_shard"], task=task,
                variances=_array_or_none(c.get("variances")))
        elif c["kind"] == "compact":
            indices, values = np.array(c["indices"], np.int32), np.array(c["values"])
            check_compact_rows(indices, values, int(c["dim"]))
            models[cid] = CompactRandomEffectModel(
                indices=indices, values=values, dim=int(c["dim"]), slot_of=_slot_of(c),
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
                        "variances": _array_or_none(m.coefficients.variances),
                        "feature_shard": m.feature_shard, "task": m.task.value}
        elif isinstance(m, RandomEffectModel):
            out[cid] = {"kind": "random", "w_stack": np.array(m.w_stack),
                        "variances": _array_or_none(m.variances), "slot_of": dict(m.slot_of),
                        "random_effect_type": m.random_effect_type,
                        "feature_shard": m.feature_shard, "task": m.task.value}
        elif isinstance(m, CompactRandomEffectModel):
            out[cid] = {"kind": "compact", "indices": np.array(m.indices),
                        "values": np.array(m.values), "dim": m.dim,
                        "slot_of": dict(m.slot_of),
                        "random_effect_type": m.random_effect_type,
                        "feature_shard": m.feature_shard, "task": m.task.value}
        else:
            raise TypeError(f"coordinate {cid!r}: cannot export {type(m).__name__}")
    return out
