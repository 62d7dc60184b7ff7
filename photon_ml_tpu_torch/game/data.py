"""GAME dataset container.

Port of photon_ml_tpu/game/data.py for dense shards: one columnar container
for the whole dataset, labels/offsets/weights as flat arrays, one [n, d]
design per feature shard and integer entity-id columns per id tag.  Row i
everywhere is the same example.

A dense shard may be a numpy array or a torch tensor already on the device
(a design generated on the card never crosses to the host).  Sparse shards
are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

ShardData = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class GameData:
    """Columnar GAME dataset (training or validation)."""

    y: np.ndarray  # [n]
    features: Dict[str, ShardData]  # shard id -> dense [n, d]
    offset: Optional[np.ndarray] = None  # [n]
    weight: Optional[np.ndarray] = None  # [n]
    id_tags: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.y = np.asarray(self.y)
        n = len(self.y)
        if self.offset is None:
            self.offset = np.zeros(n, self.y.dtype if self.y.dtype.kind == "f"
                                   else np.float32)
        if self.weight is None:
            self.weight = np.ones(n, self.offset.dtype)
        self.offset = np.asarray(self.offset)
        self.weight = np.asarray(self.weight)
        for shard, x in self.features.items():
            if not isinstance(x, (np.ndarray, torch.Tensor)):
                raise NotImplementedError(
                    f"feature shard {shard!r} is a {type(x).__name__}; sparse "
                    "shards are not ported yet (ROADMAP.md 'Next slices', "
                    "sparse shards + _match_dot_kernel)")
            if x.ndim != 2 or x.shape[0] != n:
                raise ValueError(f"feature shard {shard!r} has shape "
                                 f"{tuple(x.shape)}, expected ({n}, d)")
        for tag, ids in self.id_tags.items():
            if len(ids) != n:
                raise ValueError(f"id tag {tag!r} has {len(ids)} rows, expected {n}")
            self.id_tags[tag] = np.asarray(ids, np.int64)

    @property
    def num_samples(self) -> int:
        return len(self.y)

    def shard_dim(self, shard: str) -> int:
        return self.features[shard].shape[1]
