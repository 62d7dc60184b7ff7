"""Box-constraint projection.

Port of photon_ml_tpu/opt/constraints.py: a {feature index: (lo, hi)} map
becomes a dense pair of (lower, upper) arrays with ±inf for unconstrained
entries, and the projection onto the box is one clamp.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def box_arrays(constraint_map: Optional[Mapping[int, Tuple[float, float]]], dim: int,
               dtype=np.float32) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Densify a {feature index: (lo, hi)} map into (lower[d], upper[d])."""
    if not constraint_map:
        return None
    lower = np.full((dim,), -np.inf, dtype)
    upper = np.full((dim,), np.inf, dtype)
    for idx, (lo, hi) in constraint_map.items():
        if not 0 <= idx < dim:
            raise ValueError(f"constraint index {idx} out of range [0, {dim})")
        if lo > hi:
            raise ValueError(f"constraint lo > hi at index {idx}: ({lo}, {hi})")
        lower[idx] = lo
        upper[idx] = hi
    return lower, upper


def project_to_box(lower: Tensor, upper: Tensor) -> Callable[[Tensor], Tensor]:
    """Return a projection w -> clip(w, lower, upper) for solver use; the
    bounds broadcast against w ([d] bounds over [L, d] lanes, or [L, d])."""

    def project(w: Tensor) -> Tensor:
        return torch.clamp(w, lower, upper)

    return project
