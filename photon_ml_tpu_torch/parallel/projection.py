"""Per-entity feature projection for random-effect coordinates.

Port of photon_ml_tpu/parallel/projection.py:

- INDEX_MAP (``_pow2_at_least``, ``pearson_scores``, ``pearson_top_k``,
  ``BucketProjection``, ``build_observed_indices``): each entity solves in
  the compact space of the columns its active samples observe: per-lane
  gather indices ``idx[E, d_proj]`` (-1 = padding), a projected design block
  ``x[E, S, d_proj]``, and a back-projection that scatters the trained
  coefficients to full width, so margins are exactly preserved.  An
  unobserved feature has zero data gradient and stays at exactly 0 under L2
  from a zero start, which is why the compact solve is the full-space solve.
  The index building (observed columns, the |Pearson| filter) is host numpy
  and gives bitwise the reference's indices; the gather and the scatter run
  on the tensors' device.
- RANDOM (``RandomProjection``, ``build_random_projection``): one Gaussian
  matrix A [d_full, d_proj] shared by every entity of a coordinate
  (reference ProjectionMatrix.scala:127); x' = x·A, and the back-projection
  w = A·w' preserves margins by construction (w'ᵀ(Aᵀx) = (Aw')ᵀx).  The
  matrix is drawn on the host from ``numpy.random.default_rng(seed)`` in
  float64 and cast to the design's dtype, so it is bitwise the reference's;
  the products run on the tensors' device, in full float32 where float32.

``project_buckets`` applies either to every bucket of an ``EntityBuckets``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.core.batch import full_f32_matmul
from photon_ml_tpu_torch.core.normalization import NormalizationContext
from photon_ml_tpu_torch.parallel.bucketing import Bucket, EntityBuckets
from photon_ml_tpu_torch.types import ProjectorType

Tensor = torch.Tensor


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
class RandomProjection:
    """Shared Gaussian projection (reference ProjectionMatrix.scala:127):
    ``matrix`` [d_full, d_proj] on its device.

    ``intercept_index``: the original-space intercept column, when the matrix
    carries the reference's intercept pass-through (an extra projected slot
    that copies the intercept exactly, ProjectionMatrix.scala:112-120, a
    column here under the [d_full, d_proj] convention).  The projected
    intercept is then the last projected slot."""

    matrix: Tensor
    intercept_index: Optional[int] = None

    @property
    def d_full(self) -> int:
        return self.matrix.shape[0]

    @property
    def d_proj(self) -> int:
        return self.matrix.shape[1]

    @property
    def projected_intercept(self) -> Optional[int]:
        return None if self.intercept_index is None else self.d_proj - 1

    def project_x(self, x: Tensor) -> Tensor:
        """[..., d_full] -> [..., d_proj] on x's device, at x's dtype."""
        full_f32_matmul()
        return x @ self.matrix.to(device=x.device, dtype=x.dtype)

    def project_compact(self, x: Tensor, indices: "np.ndarray | Tensor") -> Tensor:
        """Compact lanes x [L, S, d_c], whose columns are the full-width ids
        ``indices`` [L, d_c] (-1 padding), projected to [L, S, d_proj] on x's
        device: the matrix's rows gathered through each lane's ids (padding
        rows 0) and contracted per lane.  It is what x·A gives on the
        densified lanes, since unobserved columns contribute 0 either way,
        and the [L, S, d_full] tensor never exists."""
        full_f32_matmul()
        idx = torch.as_tensor(indices, device=x.device).long()
        a = self.matrix.to(device=x.device, dtype=x.dtype)
        rows = torch.where((idx >= 0)[..., None], a[torch.where(idx >= 0, idx, 0)], 0.0)
        return torch.einsum("lsd,ldp->lsp", x, rows)

    def back_project(self, w_proj: Tensor) -> Tensor:
        """[..., d_proj] -> [..., d_full] (margin-exact) on w's device."""
        full_f32_matmul()
        return w_proj @ self.matrix.to(device=w_proj.device, dtype=w_proj.dtype).T

    def project_normalization(self, norm: NormalizationContext):
        """Reference ProjectionMatrixBroadcast.projectNormalizationContext
        (:102-112): factors and shifts pushed through the matrix, the
        projected intercept the pass-through slot.  Returns ``(projected
        context, projected intercept index)`` at the matrix's dtype and on
        its device."""
        full_f32_matmul()
        push = lambda a: None if a is None else a.to(self.matrix) @ self.matrix
        return (NormalizationContext(factors=push(norm.factors), shifts=push(norm.shifts)),
                self.projected_intercept)


def build_random_projection(d_full: int, d_proj: int, seed: int = 0,
                            dtype: torch.dtype = torch.float32,
                            intercept_index: Optional[int] = None,
                            device: "torch.device | str" = "cpu") -> RandomProjection:
    """A [d_full, d_proj] Gaussian matrix of scale 1/sqrt(d_proj), drawn on the
    host in float64 from ``default_rng(seed)`` and cast to ``dtype``.

    ``intercept_index``: append the intercept pass-through slot (the
    reference builds every random-effect projection with
    isKeepingInterceptTerm=true, RandomEffectProjector.scala:80): the matrix
    gets d_proj + 1 columns, the last copying the intercept column exactly,
    and the intercept's Gaussian row is zeroed so that its signal lands only
    there."""
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.normal(scale=1.0 / np.sqrt(d_proj), size=(d_full, d_proj)))
    m = m.to(dtype)
    if intercept_index is not None:
        e = torch.zeros((d_full, 1), dtype=dtype)
        e[intercept_index, 0] = 1.0
        m[intercept_index, :] = 0.0
        m = torch.cat([m, e], dim=1)
    return RandomProjection(matrix=m.to(device), intercept_index=intercept_index)


@dataclasses.dataclass
class ProjectedBuckets:
    """Entity buckets re-laid-out in their projected feature spaces:
    ``buckets[i]`` has design blocks of width ``projections[i].d_proj``;
    lanes, rows, weights and the directory are ``base``'s.  Under RANDOM
    every bucket holds the one shared ``RandomProjection``."""

    base: EntityBuckets
    buckets: List[Bucket]
    projections: List[Union[BucketProjection, RandomProjection]]


def check_projector(kind: ProjectorType, projected_dim: Optional[int] = None,
                    features_to_samples_ratio: Optional[float] = None) -> None:
    """The reference's refusals of a projector's settings: IDENTITY needs no
    projection, the |Pearson| ratio is INDEX_MAP's, ``projected_dim`` is
    RANDOM's and RANDOM needs it."""
    if kind == ProjectorType.IDENTITY:
        raise ValueError("IDENTITY projection needs no ProjectedBuckets")
    if kind == ProjectorType.RANDOM and features_to_samples_ratio is not None:
        raise ValueError("features_to_samples_ratio applies only to INDEX_MAP projection; "
                         "RANDOM would silently ignore it")
    if kind == ProjectorType.INDEX_MAP and projected_dim is not None:
        raise ValueError("projected_dim applies only to RANDOM projection; INDEX_MAP "
                         "derives its dimension from observed features per entity")
    if kind == ProjectorType.RANDOM and projected_dim is None:
        raise ValueError("RANDOM projection requires projected_dim")
    if kind not in (ProjectorType.INDEX_MAP, ProjectorType.RANDOM):
        raise ValueError(f"unknown projector {kind!r}")


def project_buckets(buckets: EntityBuckets, kind: ProjectorType,
                    projected_dim: Optional[int] = None,
                    features_to_samples_ratio: Optional[float] = None,
                    intercept_index: Optional[int] = None,
                    seed: int = 0) -> ProjectedBuckets:
    """Apply a projector to every bucket (a one-time layout step, on the
    buckets' device).  RANDOM draws its matrix once, at the first bucket's
    dtype, from ``seed``."""
    check_projector(kind, projected_dim, features_to_samples_ratio)
    new_buckets: List[Bucket] = []
    projections: list = []
    shared: Optional[RandomProjection] = None
    for b in buckets.buckets:
        if kind == ProjectorType.INDEX_MAP:
            proj = build_observed_indices(b, buckets.dim, features_to_samples_ratio,
                                          intercept_index)
        else:
            if shared is None:
                shared = build_random_projection(buckets.dim, projected_dim, seed,
                                                 dtype=b.x.dtype,
                                                 intercept_index=intercept_index,
                                                 device=b.x.device)
            proj = shared
        new_buckets.append(dataclasses.replace(b, x=proj.project_x(b.x)))
        projections.append(proj)
    return ProjectedBuckets(base=buckets, buckets=new_buckets, projections=projections)
