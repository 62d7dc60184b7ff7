"""Entity bucketing: per-entity sample groups packed into power-of-two
capacity buckets, plus the stacked-model helpers random-effect scoring uses.

Port of the numpy host path of photon_ml_tpu/parallel/bucketing.py
(``bucket_by_entity`` with the deterministic ``_splitmix64`` reservoir cap
and count/cap weight rescale, ``bucket_by_entity_sparse``,
``score_samples``, ``score_samples_sparse``).  The grouping and packing are
numpy and give bitwise the reference's buckets.  Dense bucket design blocks
are one masked gather on the design's tensor, so a shard that is already on
the device never crosses to the host; sparse (compact) blocks are built on
the host from the row-sparse arrays and are [E, S, d_obs], never
[E, S, d_full].  ``publish_stack`` scatters trained bucket lanes into the
[num_entities, d] stack on the coefficients' device.
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
    ``lane_of``: entity id -> (bucket index, lane).  ``dim`` is the full
    width, also for the sparse bucketer's compact blocks."""

    buckets: List[Bucket]
    lane_of: Dict[int, Tuple[int, int]]
    dim: int
    num_entities: int
    num_samples: int


def _group_rows(entity_ids: np.ndarray, active_cap: Optional[int],
                min_active_samples: int, seed: int,
                existing_model_keys: Optional[frozenset] = None
                ) -> Tuple[List[np.ndarray], List[int], List[float]]:
    """Group sample rows by entity with the deterministic reservoir cap +
    weight rescale count/cap and the min-active lower bound.

    ``existing_model_keys`` (a warm start's entity ids): an entity under the
    bound is dropped only when the prior model covers it, and that model
    then passes through unchanged; an under-bound new entity still trains
    (RandomEffectDataset.scala:322-333)."""
    uniq, inverse, counts = np.unique(entity_ids, return_inverse=True,
                                      return_counts=True)
    order = np.argsort(inverse, kind="stable")  # rows grouped by entity
    starts = np.concatenate([[0], np.cumsum(counts)])

    kept_rows: List[np.ndarray] = []
    kept_entities: List[int] = []
    rescale: List[float] = []
    for e in range(len(uniq)):
        rows = order[starts[e]: starts[e + 1]]
        if len(rows) < min_active_samples and (
                existing_model_keys is None or int(uniq[e]) in existing_model_keys):
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
                     lane_multiple: int = 1, seed: int = 0, dtype=np.float32,
                     existing_model_keys: Optional[frozenset] = None) -> EntityBuckets:
    """Group samples by entity into power-of-two-capacity buckets.

    ``active_cap``: deterministic reservoir cap per entity with weight
    rescale count/cap; overflow samples are dropped from training (scoring
    still covers them).  ``min_active_samples``: entities with fewer samples
    are excluded, except new ones when ``existing_model_keys`` (a warm
    start's entity ids) is given.  ``lane_multiple``: pad each bucket's lane count to a
    multiple.  ``x`` may be numpy or a torch tensor (e.g. on the device):
    the bucket design blocks are gathered where it lives."""
    n = len(entity_ids)
    entity_ids = np.asarray(entity_ids, np.int64)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype))
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    y = np.asarray(y, dtype)
    offset = np.zeros(n, dtype) if offset is None else np.asarray(offset, dtype)
    weight = np.ones(n, dtype) if weight is None else np.asarray(weight, dtype)
    d = x.shape[1]

    kept_rows, kept_entities, rescale = _group_rows(
        entity_ids, active_cap, min_active_samples, seed, existing_model_keys)
    caps = _capacity_classes(kept_rows)
    buckets: List[Bucket] = []
    lane_of: Dict[int, Tuple[int, int]] = {}
    for cap in sorted(set(caps.tolist())):
        idxs = np.nonzero(caps == cap)[0]
        n_lanes = ((len(idxs) + lane_multiple - 1) // lane_multiple) * lane_multiple
        by, boff, bw, brows, bcounts, blanes = _pack_lane_meta(
            n_lanes, cap, idxs, kept_rows, kept_entities, rescale,
            y, offset, weight, dtype, lane_of, len(buckets))
        # rows copy exactly and padding slots are exact zeros; a design at
        # another width is cast after the gather (on its device), so no
        # full-size copy of it exists
        valid = torch.as_tensor(brows >= 0, device=x.device)
        safe = torch.as_tensor(np.where(brows >= 0, brows, 0).astype(np.int64),
                               device=x.device)
        bx = torch.where(valid[..., None], x[safe].to(tdtype), 0.0)
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


def publish_stack(coeffs: Sequence[Tensor], lane_slots: Sequence[Tensor],
                  num_entities: int, dim: int,
                  projections: Optional[Sequence] = None,
                  fill: Optional[Tensor] = None) -> Tensor:
    """The [num_entities, dim] coefficient stack, built on the coefficients'
    device: lane l of bucket b goes to row ``lane_slots[b][l]``; a padding
    lane (slot -1) is dropped.  With
    ``projections`` (one ``BucketProjection`` per bucket, or its [L, k]
    column ids as a tensor), each lane's
    compact coefficients scatter to their full-width columns and every other
    column takes ``fill`` ([dim]; 0 without it), except in a lane that
    observes no column, which stays 0.  Padded compact slots are dropped, so
    they never overwrite an observed column.  What is dropped goes to a sink
    row and column past the last, so no count is read on the host."""
    dev = coeffs[0].device if coeffs else torch.device("cpu")
    dt = coeffs[0].dtype if coeffs else torch.float32
    out = torch.zeros((num_entities + 1, dim + 1), dtype=dt, device=dev)  # last: sinks
    for b, (c, slots) in enumerate(zip(coeffs, lane_slots)):
        slots = slots.to(dev).long()
        rows = torch.where(slots < 0, num_entities, slots)
        if projections is None:
            out[rows, :dim] = c
            continue
        proj = projections[b]
        idx = torch.as_tensor(proj if isinstance(proj, Tensor) else proj.indices,
                              device=dev).long()
        keep = idx >= 0
        if fill is not None:
            out[torch.where(keep.any(dim=1), rows, num_entities), :dim] = fill.to(dt)
        out[rows[:, None].expand_as(idx), torch.where(keep, idx, dim)] = c
    return out[:num_entities, :dim].contiguous()


def score_samples(w_stack: Tensor, slots: Tensor, x: Tensor) -> Tensor:
    """Raw per-sample scores x_i · w_entity(i); slot -1 (no model) scores 0.
    A narrow-stored x is widened; w is not rounded."""
    safe = torch.where(slots >= 0, slots, 0).long()
    margins = (x.to(w_stack.dtype) * w_stack[safe]).sum(dim=1)
    return torch.where(slots >= 0, margins, 0.0)


def score_samples_sparse(w_stack: Tensor, slots: Tensor, indices: Tensor,
                         values: Tensor) -> Tensor:
    """Raw per-sample scores over row-sparse features:
    Σ_k w_stack[slot_i, indices[i, k]] · values[i, k], a two-level gather
    that never builds [n, d_full].  Padded COO slots carry value 0; slot -1
    (no model) scores 0."""
    safe = torch.where(slots >= 0, slots, 0).long()
    gathered = w_stack[safe[:, None], indices.long()]
    margins = (gathered * values).sum(dim=-1)
    return torch.where(slots >= 0, margins, 0.0)


def bucket_by_entity_sparse(entity_ids: np.ndarray, indices: np.ndarray,
                            values: np.ndarray, dim: int, y: np.ndarray,
                            offset: Optional[np.ndarray] = None,
                            weight: Optional[np.ndarray] = None,
                            active_cap: Optional[int] = None,
                            min_active_samples: int = 1, lane_multiple: int = 1,
                            seed: int = 0, dtype=np.float32,
                            features_to_samples_ratio: Optional[float] = None,
                            intercept_index: Optional[int] = None,
                            existing_model_keys: Optional[frozenset] = None):
    """Compact per-entity buckets built directly from row-sparse features.

    Each entity solves in the space of the columns its active samples
    observe (a nonzero value), so bucket design blocks are [E, S, d_obs],
    never [E, S, d_full].  ``indices``/``values``: a SparseShard's [n, k]
    arrays (zero values ignored, duplicate indices within a row accumulate).
    ``features_to_samples_ratio`` / ``intercept_index``: the per-entity
    |Pearson| top-k filter, as ``build_observed_indices`` applies it.
    ``existing_model_keys``: the lower bound's warm-start rule, as in
    ``bucket_by_entity``.

    Returns ``(EntityBuckets, projections)``: compact buckets (``x`` a CPU
    tensor) plus one ``BucketProjection`` per bucket mapping compact columns
    back to the full vocabulary (``EntityBuckets.dim`` stays the full
    width)."""
    from photon_ml_tpu_torch.parallel.projection import (BucketProjection,
                                                         _pow2_at_least,
                                                         pearson_top_k)

    n = len(entity_ids)
    entity_ids = np.asarray(entity_ids, np.int64)
    indices = np.asarray(indices, np.int64)
    values = np.asarray(values, dtype)
    y = np.asarray(y, dtype)
    offset = np.zeros(n, dtype) if offset is None else np.asarray(offset, dtype)
    weight = np.ones(n, dtype) if weight is None else np.asarray(weight, dtype)

    kept_rows, kept_entities, rescale = _group_rows(
        entity_ids, active_cap, min_active_samples, seed, existing_model_keys)

    def _compact_lane(rows: np.ndarray):
        """(observed columns, compact dense block [len(rows), n_obs])."""
        iv, vv = indices[rows], values[rows]
        nz_r, nz_c = np.nonzero(vv != 0)
        obs = np.unique(iv[nz_r, nz_c]) if nz_r.size else np.empty(0, np.int64)
        x = np.zeros((len(rows), len(obs)), dtype)
        if nz_r.size:
            pos = np.searchsorted(obs, iv[nz_r, nz_c])
            np.add.at(x, (nz_r, pos), vv[nz_r, nz_c])  # duplicates accumulate
        if features_to_samples_ratio is not None and obs.size:
            keep_n = max(1, int(np.ceil(features_to_samples_ratio * len(rows))))
            if obs.size > keep_n:
                top = pearson_top_k(x, y[rows], weight[rows], obs, keep_n,
                                    intercept_index)
                obs, x = obs[top], x[:, top]
        return obs.astype(np.int32), x

    caps = _capacity_classes(kept_rows)
    buckets: List[Bucket] = []
    projections = []
    lane_of: Dict[int, Tuple[int, int]] = {}
    for cap in sorted(set(caps.tolist())):
        idxs = np.nonzero(caps == cap)[0]
        compacted = [_compact_lane(kept_rows[ei]) for ei in idxs]
        d_proj = min(_pow2_at_least(max((len(o) for o, _ in compacted), default=1)),
                     dim)
        n_lanes = ((len(idxs) + lane_multiple - 1) // lane_multiple) * lane_multiple
        by, boff, bw, brows, bcounts, blanes = _pack_lane_meta(
            n_lanes, cap, idxs, kept_rows, kept_entities, rescale,
            y, offset, weight, dtype, lane_of, len(buckets))
        bx = np.zeros((n_lanes, cap, d_proj), dtype)
        bidx = np.full((n_lanes, d_proj), -1, np.int32)
        for lane, ei in enumerate(idxs):
            k = len(kept_rows[ei])
            obs, x = compacted[lane]
            bx[lane, :k, :len(obs)] = x
            bidx[lane, :len(obs)] = obs
        buckets.append(Bucket(x=torch.from_numpy(bx), y=by, offset=boff, weight=bw,
                              rows=brows, counts=bcounts, entity_lanes=blanes))
        projections.append(BucketProjection(indices=bidx, d_full=dim))
    ents = EntityBuckets(buckets=buckets, lane_of=lane_of, dim=dim,
                         num_entities=len(kept_entities), num_samples=n)
    return ents, projections
