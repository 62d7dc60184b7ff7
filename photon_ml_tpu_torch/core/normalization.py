"""Feature normalization: feature statistics, the normalization context and
its coefficient-space maps.

Port of photon_ml_tpu/core/normalization.py.
With x' = (x - shift) .* factor, margins against the raw x are
eff(w)·x + margin_shift(w), eff(w) = w .* factor and
margin_shift(w) = -eff(w)·shift, so the design matrix is never transformed.

Coefficient-space maps, margin-invariant (the intercept absorbs the shift):
  to original space:    w_j = w'_j * factor_j ;  b = b' - Σ_j w'_j factor_j shift_j
  to transformed space: w'_j = w_j / factor_j ;  b' = b + Σ_j w_j shift_j

``build_normalization`` makes a context from ``FeatureStats`` for each
``NormalizationType``; the intercept column keeps factor 1 and shift 0.

A context may also hold per-lane rows ([L, d] factors and shifts): the
shard's context projected into each random-effect entity's compact space.
Its coefficient maps then take each lane's own intercept position, an [L]
index tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureStats:
    """Per-feature summary statistics ([d] tensors; ``count`` 0-d)."""

    mean: Tensor
    variance: Tensor
    min: Tensor
    max: Tensor
    abs_max: Tensor
    num_nonzeros: Tensor
    count: Tensor  # number of (weighted) examples
    intercept_index: Optional[int] = None


def compute_feature_stats(x: Tensor, weight: Optional[Tensor] = None,
                          intercept_index: Optional[int] = None) -> FeatureStats:
    """Stats of a dense design [n, d] on its own device and in its dtype:
    the sample variance (ddof 1) unweighted, or Σ w (x - mean)² /
    max(Σw - 1, 1) weighted."""
    n = x.shape[0]
    if weight is None:
        mean = x.mean(dim=0)
        var = x.var(dim=0, correction=1) if n > 1 else torch.zeros_like(mean)
        count = torch.tensor(float(n), dtype=x.dtype, device=x.device)
    else:
        weight = weight.to(x.dtype)
        wsum = weight.sum()
        mean = (weight @ x) / wsum
        var = (weight @ (x - mean) ** 2) / torch.clamp(wsum - 1.0, min=1.0)
        count = wsum
    return FeatureStats(mean=mean, variance=var, min=x.amin(dim=0), max=x.amax(dim=0),
                        abs_max=x.abs().amax(dim=0),
                        num_nonzeros=(x != 0).sum(dim=0).to(x.dtype), count=count,
                        intercept_index=intercept_index)


def compute_feature_stats_sparse(indices, values, dim: int, weight=None,
                                 intercept_index: Optional[int] = None) -> FeatureStats:
    """Stats of a row-padded COO design ([n, k] ids and values) without
    densifying it, in float64 on the host.  Implicit zeros count toward every
    moment; padded slots (value 0) add nothing.  A column not observed
    (nonzero) in every row takes 0 into its min and max."""
    idx = np.asarray(indices)
    val = np.asarray(values, np.float64)
    n = idx.shape[0]
    w = np.ones(n, np.float64) if weight is None else np.asarray(weight, np.float64)
    wsum = float(w.sum())
    wv = w[:, None] * val
    s1, s2 = np.zeros(dim), np.zeros(dim)  # Σ w x, Σ w x²
    nnz, amax = np.zeros(dim), np.zeros(dim)
    flat = idx.ravel()
    np.add.at(s1, flat, wv.ravel())
    np.add.at(s2, flat, (wv * val).ravel())
    np.add.at(nnz, flat, (val != 0).ravel())
    np.maximum.at(amax, flat, np.abs(val).ravel())
    vmin, vmax = np.full(dim, np.inf), np.full(dim, -np.inf)
    nz = val != 0
    np.minimum.at(vmin, idx[nz], val[nz])
    np.maximum.at(vmax, idx[nz], val[nz])
    rows_with = np.zeros(dim, np.int64)  # rows in which each column is nonzero
    if nz.any():
        r = np.nonzero(nz)[0].astype(np.int64)
        keys = np.unique(r * np.int64(dim) + idx[nz].astype(np.int64))
        np.add.at(rows_with, keys % np.int64(dim), 1)
    has_zero = rows_with < n
    vmin = np.where(has_zero, np.minimum(vmin, 0.0), vmin)
    vmax = np.where(has_zero, np.maximum(vmax, 0.0), vmax)
    mean = s1 / max(wsum, 1e-300)
    # Σ w (x - m)² = Σ w x² - 2 m Σ w x + m² Σ w
    var = np.maximum(s2 - 2.0 * mean * s1 + mean * mean * wsum, 0.0) / max(wsum - 1.0, 1.0)
    t = torch.from_numpy
    return FeatureStats(mean=t(mean), variance=t(var), min=t(vmin), max=t(vmax),
                        abs_max=t(amax), num_nonzeros=t(nnz),
                        count=torch.tensor(wsum, dtype=torch.float64),
                        intercept_index=intercept_index)


def _intercept(w: Tensor, intercept_index: "Optional[int] | Tensor"):
    """The index of ``w``'s intercept entries: column ``intercept_index`` of
    every vector, or lane l's column intercept_index[l] of a stack [L, d]."""
    if intercept_index is None:
        raise ValueError("shift normalization requires an intercept")
    if isinstance(intercept_index, Tensor):
        return torch.arange(w.shape[0], device=w.device), intercept_index
    return (..., intercept_index)


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Affine feature normalization; ``factors``/``shifts`` None = identity.
    Every map takes a coefficient vector [d] or a stack of them [..., d];
    per-lane rows [L, d] take a stack [L, d]."""

    factors: Optional[Tensor]  # [d], [L, d] or None
    shifts: Optional[Tensor]  # [d], [L, d] or None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def to(self, dtype: torch.dtype, device: torch.device) -> "NormalizationContext":
        """The same context with its vectors in ``dtype`` on ``device``."""
        cast = lambda a: None if a is None else torch.as_tensor(a).to(device=device,
                                                                       dtype=dtype)
        return NormalizationContext(factors=cast(self.factors), shifts=cast(self.shifts))

    def effective_coefficients(self, w: Tensor) -> Tensor:
        return w if self.factors is None else w * self.factors

    def transform_features(self, x: Tensor) -> Tensor:
        """(x - shift) * factor over the last axis, materialized (Hessians of
        small d only)."""
        if self.shifts is not None:
            x = x - self.shifts
        if self.factors is not None:
            x = x * self.factors
        return x

    def margin_shift(self, w: Tensor) -> Tensor:
        """-dot(eff(w), shift), added to every margin ([...] for w [..., d])."""
        if self.shifts is None:
            return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
        return -(self.effective_coefficients(w) * self.shifts).sum(-1)

    def model_to_original_space(self, w: Tensor,
                                intercept_index: "Optional[int] | Tensor") -> Tensor:
        """Transformed-space coefficients to original space, the shift folded
        into the intercept: column ``intercept_index``, or with per-lane rows
        each lane's own column (an [L] index tensor)."""
        out = self.effective_coefficients(w)
        if self.shifts is not None:
            out = out.clone()
            out[_intercept(out, intercept_index)] -= (out * self.shifts).sum(-1)
        return out

    def model_to_transformed_space(self, w: Tensor,
                                   intercept_index: "Optional[int] | Tensor") -> Tensor:
        """The inverse of ``model_to_original_space``."""
        out = w
        if self.shifts is not None:
            out = out.clone()
            out[_intercept(out, intercept_index)] += (w * self.shifts).sum(-1)
        if self.factors is not None:
            out = out / self.factors
        return out


def no_normalization() -> NormalizationContext:
    return NormalizationContext(factors=None, shifts=None)


def build_normalization(kind: NormalizationType, stats: FeatureStats) -> NormalizationContext:
    """The context of ``kind`` from feature stats: 1/abs_max, 1/std, or 1/std
    with the mean as shift; a feature with no spread keeps factor 1.  The
    intercept column keeps factor 1 and shift 0; STANDARDIZATION needs one."""
    if kind == NormalizationType.NONE:
        return no_normalization()
    if kind == NormalizationType.STANDARDIZATION and stats.intercept_index is None:
        raise ValueError("STANDARDIZATION requires feature stats with an intercept_index")

    def inverse(a: Tensor) -> Tensor:
        return 1.0 / torch.where(a == 0.0, torch.ones_like(a), a)

    if kind == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = inverse(stats.abs_max), None
    elif kind == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = inverse(torch.sqrt(stats.variance)), None
    elif kind == NormalizationType.STANDARDIZATION:
        factors, shifts = inverse(torch.sqrt(stats.variance)), stats.mean.clone()
    else:
        raise ValueError(f"unknown normalization type {kind!r}")
    ii = stats.intercept_index
    if ii is not None:
        factors[ii] = 1.0
        if shifts is not None:
            shifts[ii] = 0.0
    return NormalizationContext(factors=factors, shifts=shifts)
