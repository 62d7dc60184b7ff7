"""GAME dataset container.

Port of photon_ml_tpu/game/data.py: one columnar container for the whole
dataset, labels/offsets/weights as flat arrays, one design per feature shard
and integer entity-id columns per id tag.  Row i everywhere is the same
example.

A dense shard is [n, d]: a numpy array or a torch tensor already on the
device (a design generated on the card never crosses to the host).  A
``SparseShard`` holds a wide vocabulary as row-padded COO arrays [n, k].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.shards import SparseShard

ShardData = Union[np.ndarray, torch.Tensor, SparseShard]


@dataclasses.dataclass
class GameData:
    """Columnar GAME dataset (training or validation)."""

    y: np.ndarray  # [n]
    features: Dict[str, ShardData]  # shard id -> dense [n, d] or SparseShard
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
            if isinstance(x, SparseShard):
                if x.indices.shape != x.values.shape or x.indices.ndim != 2:
                    raise ValueError(
                        f"sparse shard {shard!r}: indices {x.indices.shape} and "
                        f"values {x.values.shape} must be one [n, k] shape")
                if x.indices.size and (x.indices.min() < 0 or x.indices.max() >= x.dim):
                    # out-of-range ids would be a device-side fault in the
                    # gathers and scatter-adds on the card
                    raise ValueError(f"sparse shard {shard!r}: column ids must lie in "
                                     f"[0, {x.dim})")
                rows = x.indices.shape[0]
            elif isinstance(x, (np.ndarray, torch.Tensor)):
                if x.ndim != 2:
                    raise ValueError(f"feature shard {shard!r} has shape "
                                     f"{tuple(x.shape)}, expected ({n}, d)")
                rows = x.shape[0]
            else:
                raise TypeError(f"feature shard {shard!r} is a {type(x).__name__}; "
                                "expected an array, a tensor or a SparseShard")
            if rows != n:
                raise ValueError(f"feature shard {shard!r} has {rows} rows, "
                                 f"expected {n}")
        for tag, ids in self.id_tags.items():
            if len(ids) != n:
                raise ValueError(f"id tag {tag!r} has {len(ids)} rows, expected {n}")
            self.id_tags[tag] = np.asarray(ids, np.int64)

    @property
    def num_samples(self) -> int:
        return len(self.y)

    def shard_dim(self, shard: str) -> int:
        return self.features[shard].shape[1]
