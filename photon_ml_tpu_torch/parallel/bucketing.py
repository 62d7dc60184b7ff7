"""Entity bucketing: per-entity sample groups packed into power-of-two
capacity buckets, plus the stacked-model helpers random-effect scoring uses.

Port of the numpy host path of photon_ml_tpu/parallel/bucketing.py
(``bucket_by_entity`` with the deterministic ``_splitmix64`` reservoir cap
and count/cap weight rescale, ``stacked_coefficients``, ``score_samples``).
The grouping and packing are numpy and give bitwise the reference's buckets.
The bucket design blocks are one masked gather on the design's tensor, so a
shard that is already on the device never crosses to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix for reservoir keys (the reference hashes the
    unique sample id; any fixed avalanche mix is recompute-stable)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class Bucket:
    """One capacity class of entities.

    x [E, S, d] (a tensor on the design shard's device),
    y/offset/weight [E, S], rows [E, S] int32 (original sample row of each
    slot, -1 for padding), counts [E] int32, entity_lanes [E] int64 (entity
    id per lane, -1 for padding lanes)."""

    x: Tensor
    y: np.ndarray
    offset: np.ndarray
    weight: np.ndarray
    rows: np.ndarray
    counts: np.ndarray
    entity_lanes: np.ndarray

    @property
    def num_lanes(self) -> int:
        return self.x.shape[0]

    @property
    def capacity(self) -> int:
        return self.x.shape[1]


@dataclasses.dataclass
class EntityBuckets:
    """All buckets of one random-effect coordinate plus the entity directory
    ``lane_of``: entity id -> (bucket index, lane)."""

    buckets: List[Bucket]
    lane_of: Dict[int, Tuple[int, int]]
    dim: int
    num_entities: int
    num_samples: int


def _group_rows(entity_ids: np.ndarray, active_cap: Optional[int],
                min_active_samples: int, seed: int
                ) -> Tuple[List[np.ndarray], List[int], List[float]]:
    """Group sample rows by entity with the deterministic reservoir cap +
    weight rescale count/cap and the min-active lower bound."""
    uniq, inverse, counts = np.unique(entity_ids, return_inverse=True,
                                      return_counts=True)
    order = np.argsort(inverse, kind="stable")  # rows grouped by entity
    starts = np.concatenate([[0], np.cumsum(counts)])

    kept_rows: List[np.ndarray] = []
    kept_entities: List[int] = []
    rescale: List[float] = []
    for e in range(len(uniq)):
        rows = order[starts[e]: starts[e + 1]]
        if len(rows) < min_active_samples:
            continue
        scale = 1.0
        if active_cap is not None and len(rows) > active_cap:
            keys = _splitmix64(rows.astype(np.uint64) ^ np.uint64(seed))
            rows = rows[np.argsort(keys, kind="stable")[:active_cap]]
            scale = len(keys) / active_cap  # weight rescale count/cap
        kept_rows.append(np.sort(rows))
        kept_entities.append(int(uniq[e]))
        rescale.append(scale)
    return kept_rows, kept_entities, rescale


def _capacity_classes(kept_rows: List[np.ndarray]) -> np.ndarray:
    """Per-entity bucket capacity: next power of two of the active count."""
    return np.asarray([max(1, 1 << (len(r) - 1).bit_length()) for r in kept_rows])


def _pack_lane_meta(n_lanes, cap, idxs, kept_rows, kept_entities, rescale,
                    y, offset, weight, dtype, lane_of, bucket_index):
    """Fill one capacity class's label, offset, rescaled weight, row map,
    count and entity arrays; ``lane_of`` is updated in place."""
    by = np.zeros((n_lanes, cap), dtype)
    boff = np.zeros((n_lanes, cap), dtype)
    bw = np.zeros((n_lanes, cap), dtype)
    brows = np.full((n_lanes, cap), -1, np.int32)
    bcounts = np.zeros((n_lanes,), np.int32)
    blanes = np.full((n_lanes,), -1, np.int64)
    for lane, ei in enumerate(idxs):
        rows = kept_rows[ei]
        k = len(rows)
        by[lane, :k] = y[rows]
        boff[lane, :k] = offset[rows]
        bw[lane, :k] = weight[rows] * rescale[ei]
        brows[lane, :k] = rows
        bcounts[lane] = k
        blanes[lane] = kept_entities[ei]
        lane_of[kept_entities[ei]] = (bucket_index, lane)
    return by, boff, bw, brows, bcounts, blanes


def bucket_by_entity(entity_ids: np.ndarray, x: "np.ndarray | Tensor", y: np.ndarray,
                     offset: Optional[np.ndarray] = None,
                     weight: Optional[np.ndarray] = None,
                     active_cap: Optional[int] = None, min_active_samples: int = 1,
                     lane_multiple: int = 1, seed: int = 0,
                     dtype=np.float32) -> EntityBuckets:
    """Group samples by entity into power-of-two-capacity buckets.

    ``active_cap``: deterministic reservoir cap per entity with weight
    rescale count/cap; overflow samples are dropped from training (scoring
    still covers them).  ``min_active_samples``: entities with fewer samples
    are excluded.  ``lane_multiple``: pad each bucket's lane count to a
    multiple.  ``x`` may be numpy or a torch tensor (e.g. on the device):
    the bucket design blocks are gathered where it lives."""
    n = len(entity_ids)
    entity_ids = np.asarray(entity_ids, np.int64)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype))
    y = np.asarray(y, dtype)
    offset = np.zeros(n, dtype) if offset is None else np.asarray(offset, dtype)
    weight = np.ones(n, dtype) if weight is None else np.asarray(weight, dtype)
    d = x.shape[1]

    kept_rows, kept_entities, rescale = _group_rows(
        entity_ids, active_cap, min_active_samples, seed)
    caps = _capacity_classes(kept_rows)
    buckets: List[Bucket] = []
    lane_of: Dict[int, Tuple[int, int]] = {}
    for cap in sorted(set(caps.tolist())):
        idxs = np.nonzero(caps == cap)[0]
        n_lanes = ((len(idxs) + lane_multiple - 1) // lane_multiple) * lane_multiple
        by, boff, bw, brows, bcounts, blanes = _pack_lane_meta(
            n_lanes, cap, idxs, kept_rows, kept_entities, rescale,
            y, offset, weight, dtype, lane_of, len(buckets))
        # rows copy exactly and padding slots are exact zeros
        valid = torch.as_tensor(brows >= 0, device=x.device)
        safe = torch.as_tensor(np.where(brows >= 0, brows, 0).astype(np.int64),
                               device=x.device)
        bx = torch.where(valid[..., None], x[safe], 0.0)
        buckets.append(Bucket(x=bx, y=by, offset=boff, weight=bw, rows=brows,
                              counts=bcounts, entity_lanes=blanes))
    return EntityBuckets(buckets=buckets, lane_of=lane_of, dim=d,
                         num_entities=len(kept_entities), num_samples=n)


def slots_from(slot_of: Dict[int, int], entity_ids: np.ndarray) -> np.ndarray:
    """Vectorized entity-id -> slot lookup (-1 for unknown ids)."""
    entity_ids = np.asarray(entity_ids, np.int64)
    if not slot_of:
        return np.full(len(entity_ids), -1, np.int32)
    keys = np.fromiter(slot_of.keys(), np.int64, len(slot_of))
    vals = np.fromiter(slot_of.values(), np.int32, len(slot_of))
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    pos = np.clip(np.searchsorted(keys, entity_ids), 0, len(keys) - 1)
    return np.where(keys[pos] == entity_ids, vals[pos], -1).astype(np.int32)


def stacked_coefficients(coeffs: Sequence[Tensor], buckets: EntityBuckets
                         ) -> Tuple[np.ndarray, Dict[int, int]]:
    """Stack per-bucket lane coefficients [E_b, d] into W[num_entities, d]
    (rows in sorted entity-id order) plus the id -> row map.  One host
    transfer per bucket."""
    host = [c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
            for c in coeffs]
    slot_of: Dict[int, int] = {}
    parts = []
    for eid in sorted(buckets.lane_of):
        bi, lane = buckets.lane_of[eid]
        slot_of[eid] = len(slot_of)
        parts.append(host[bi][lane])
    if parts:
        w = np.stack(parts)
    else:
        w = np.zeros((0, buckets.dim), host[0].dtype if host else np.float32)
    return w, slot_of


def score_samples(w_stack: Tensor, slots: Tensor, x: Tensor) -> Tensor:
    """Raw per-sample scores x_i · w_entity(i); slot -1 (no model) scores 0."""
    safe = torch.where(slots >= 0, slots, 0).long()
    margins = (x * w_stack[safe]).sum(dim=1)
    return torch.where(slots >= 0, margins, 0.0)
