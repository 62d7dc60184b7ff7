"""The sparse feature shard, in a module of its own so that both the GAME
data container (``game/data.py``) and the models that score it
(``models/game.py``) can import it without an import cycle."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SparseShard:
    """Row-padded COO design for a wide sparse vocabulary: ``indices`` [n, k]
    column ids in [0, dim) and ``values`` [n, k], padded slots (index 0,
    value 0) inert.  Duplicate indices within a row accumulate."""

    indices: np.ndarray  # [n, k] integer column ids
    values: np.ndarray  # [n, k] float
    dim: int  # vocabulary size

    @property
    def shape(self):
        """(n, dim): the shape of the dense matrix it stands for."""
        return (self.indices.shape[0], self.dim)
