"""Per-entity feature projection for random-effect coordinates: INDEX_MAP.

Port of photon_ml_tpu/parallel/projection.py for the INDEX_MAP projector
(``_pow2_at_least``, ``pearson_scores``, ``pearson_top_k``,
``BucketProjection``, ``build_observed_indices``, ``ProjectedBuckets``,
``project_buckets``).  Each entity solves in the compact space of the
columns its active samples observe: per-lane gather indices
``idx[E, d_proj]`` (-1 = padding), a projected design block
``x[E, S, d_proj]``, and a back-projection that scatters the trained
coefficients to full width, so margins are exactly preserved.  An
unobserved feature has zero data gradient and stays at exactly 0 under L2
from a zero start, which is why the compact solve is the full-space solve.

The index building (observed columns, the |Pearson| filter) is host numpy
and gives bitwise the reference's indices; the gather and the scatter run on
the tensors' device.  The RANDOM projector (a shared Gaussian matrix) is not
ported: ``project_buckets`` refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.parallel.bucketing import Bucket, EntityBuckets
from photon_ml_tpu_torch.types import ProjectorType

Tensor = torch.Tensor

RANDOM_REFUSAL = ("the RANDOM projector is not ported yet: ROADMAP.md 'Modules "
                  "still to port', item 10, random-effect projectors (RANDOM)")


def _pow2_at_least(k: int) -> int:
    return max(1, 1 << (max(0, k - 1)).bit_length())


def pearson_scores(x: np.ndarray, y: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """|Pearson correlation| of each column of x with y over weighted samples;
    near-constant columns score 0."""
    w = weight / max(float(weight.sum()), 1e-12)
    mx = w @ x
    my = float(w @ y)
    dx = x - mx
    dy = y - my
    cov = (w * dy) @ dx
    vx = w @ (dx * dx)
    vy = float(w @ (dy * dy))
    denom = np.sqrt(np.maximum(vx * vy, 0.0))
    near_const = vx <= 1e-12 * np.maximum(1.0, np.abs(mx) ** 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        score = np.abs(cov) / np.where(denom > 0, denom, 1.0)
    out = np.where(denom > 0, score, 0.0)
    out[near_const] = 0.0
    return out


def pearson_top_k(x: np.ndarray, y: np.ndarray, w: np.ndarray, obs: np.ndarray,
                  keep_n: int, intercept_index: Optional[int] = None) -> np.ndarray:
    """Sorted positions (into ``obs``) of the top-``keep_n`` |Pearson| columns
    of ``x``; the intercept column (found by its full-width id in ``obs``)
    always survives.  Shared by the dense and the row-sparse bucketers."""
    scores = pearson_scores(x, y, w)
    if intercept_index is not None:
        at = np.nonzero(obs == intercept_index)[0]
        if at.size:
            scores[at[0]] = np.inf
    return np.sort(np.argsort(-scores, kind="stable")[:keep_n])


@dataclasses.dataclass
class BucketProjection:
    """INDEX_MAP projection of one bucket: per-lane gather indices
    ``indices[E, d_proj]`` (int32, -1 padding) into ``d_full`` columns."""

    indices: np.ndarray
    d_full: int

    @property
    def d_proj(self) -> int:
        return self.indices.shape[1]

    def project_x(self, x: Tensor) -> Tensor:
        """[E, S, d_full] -> [E, S, d_proj] on x's device; padding columns 0."""
        idx = torch.as_tensor(self.indices, device=x.device).long()
        safe = torch.where(idx < 0, 0, idx)
        out = torch.gather(x, 2, safe[:, None, :].expand(-1, x.shape[1], -1))
        return torch.where((idx >= 0)[:, None, :], out, 0.0)


def build_observed_indices(bucket: Bucket, d_full: int,
                           features_to_samples_ratio: Optional[float] = None,
                           intercept_index: Optional[int] = None) -> BucketProjection:
    """Observed-feature gather indices for every lane of one dense bucket.

    A feature is observed for an entity when any of its active samples has a
    nonzero value in that column.  With ``features_to_samples_ratio``, an
    entity keeps at most ceil(ratio * active count) of them, ranked by
    |Pearson| with the label; the intercept column is always kept.  Host
    numpy (the bucket's design comes to the host once)."""
    x_all = bucket.x.detach().cpu().numpy()
    e = x_all.shape[0]
    per_lane: List[np.ndarray] = []
    for lane in range(e):
        k = int(bucket.counts[lane])
        if k == 0:
            per_lane.append(np.empty(0, np.int32))
            continue
        x = x_all[lane, :k]
        observed = np.nonzero(np.any(x != 0.0, axis=0))[0]
        if features_to_samples_ratio is not None and observed.size > 0:
            keep_n = max(1, int(np.ceil(features_to_samples_ratio * k)))
            if observed.size > keep_n:
                top = pearson_top_k(x[:, observed], bucket.y[lane, :k],
                                    bucket.weight[lane, :k], observed, keep_n,
                                    intercept_index)
                observed = observed[top]
        per_lane.append(observed.astype(np.int32))

    d_proj = min(_pow2_at_least(max((len(o) for o in per_lane), default=1)), d_full)
    indices = np.full((e, d_proj), -1, np.int32)
    for lane, obs in enumerate(per_lane):
        obs = obs[:d_proj]
        indices[lane, :len(obs)] = obs
    return BucketProjection(indices=indices, d_full=d_full)


@dataclasses.dataclass
class ProjectedBuckets:
    """Entity buckets re-laid-out in their compact feature spaces:
    ``buckets[i]`` has design blocks of width ``projections[i].d_proj``;
    lanes, rows, weights and the directory are ``base``'s."""

    base: EntityBuckets
    buckets: List[Bucket]
    projections: List[BucketProjection]


def project_buckets(buckets: EntityBuckets, kind: ProjectorType,
                    features_to_samples_ratio: Optional[float] = None,
                    intercept_index: Optional[int] = None) -> ProjectedBuckets:
    """Apply a projector to every bucket (a one-time layout step)."""
    if kind == ProjectorType.IDENTITY:
        raise ValueError("IDENTITY projection needs no ProjectedBuckets")
    if kind == ProjectorType.RANDOM:
        raise NotImplementedError(RANDOM_REFUSAL)
    if kind != ProjectorType.INDEX_MAP:
        raise ValueError(f"unknown projector {kind!r}")
    new_buckets: List[Bucket] = []
    projections: List[BucketProjection] = []
    for b in buckets.buckets:
        proj = build_observed_indices(b, buckets.dim, features_to_samples_ratio,
                                      intercept_index)
        new_buckets.append(dataclasses.replace(b, x=proj.project_x(b.x)))
        projections.append(proj)
    return ProjectedBuckets(base=buckets, buckets=new_buckets, projections=projections)
