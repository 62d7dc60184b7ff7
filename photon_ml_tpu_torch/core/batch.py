"""Training batches: dense ``x[n, d]`` and row-padded sparse COO.

Port of photon_ml_tpu/core/batch.py (``DenseBatch``, ``SparseBatch``).
Padded or invalid examples carry weight 0 and the weighted-sum algebra
ignores them.  A sparse row pads with (index 0, value 0): a zero value is
inert in margins and gradients wherever it points.  Duplicate indices within
a row accumulate.

Mixed-precision storage, as in the reference: ``x`` (or a sparse batch's
``values``) may be held at a narrower float than the solver state (bf16 or
f16 against float32), while y, offset and weight stay at the solver dtype.
A dense product then rounds the coefficient (or residual) vector to the
storage width and accumulates at the solver width: both operands are
widened, which is exact, and the widened design exists only one row chunk
at a time (``storage_mv`` / ``storage_rmv``).  Sparse values are widened and
the coefficients are not rounded.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

Tensor = torch.Tensor


# a product with a widened design widens this many elements at a time (64 MB
# in float32), so the widened copy never exists at full size
WIDEN_CHUNK_ELEMS = 1 << 24


def narrow(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t`` cast to ``dtype`` as the reference casts it.  Float64 to f16
    rounds to nearest even once (XLA's cast); PyTorch's goes through
    float32, which rounds twice and can miss by one unit where the float32
    value lands on a tie (a residual of -0.53735352 did), so here the
    float32 step rounds to odd (toward zero, the last bit set where
    inexact), after which the second rounding is exact.  Float64 to bf16
    goes through float32 in XLA and ml_dtypes as in PyTorch: a plain cast."""
    if t.dtype != torch.float64 or dtype != torch.float16:
        return t.to(dtype)
    y = t.to(torch.float32)
    yd = y.to(torch.float64)
    y = torch.where(yd.abs() > t.abs(), torch.nextafter(y, torch.zeros_like(y)), y)
    bits = y.view(torch.int32)
    y = torch.where(yd != t, bits | 1, bits).view(torch.float32)
    return y.to(dtype)


def to_storage(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t`` rounded to ``dtype`` and widened back to its own dtype (the
    identity where the two are one dtype)."""
    return t if t.dtype == dtype else narrow(t, dtype).to(t.dtype)


def _row_chunks(x: Tensor):
    step = max(1, WIDEN_CHUNK_ELEMS // max(x.shape[-1], 1))
    return range(0, x.shape[0], step), step


def _chunked_mv(x: Tensor, w: Tensor) -> Tensor:
    """x @ w at w's dtype, x cast to it a row chunk at a time."""
    full_f32_matmul()
    if x.dtype == w.dtype:
        return torch.mv(x, w)
    starts, step = _row_chunks(x)
    return torch.cat([torch.mv(x[i:i + step].to(w.dtype), w) for i in starts])


def storage_mv(x: Tensor, w: Tensor, acc: torch.dtype) -> Tensor:
    """x @ w at ``acc`` for x [n, d] at its storage dtype: w rounded to x's
    dtype, both widened to ``acc`` (exact)."""
    return _chunked_mv(x, narrow(w, x.dtype).to(acc))


def widened_mv(x: Tensor, w: Tensor) -> Tensor:
    """x @ w at the two's common dtype, w not rounded (a model's score of a
    narrow-stored design)."""
    return _chunked_mv(x, w.to(torch.promote_types(x.dtype, w.dtype)))


def storage_rmv(r: Tensor, x: Tensor) -> Tensor:
    """r @ x at r's dtype for x [n, d] at its storage dtype: r rounded to
    x's dtype, both widened (exact), summed over row chunks of x."""
    full_f32_matmul()
    acc = r.dtype
    r = to_storage(r, x.dtype)
    if x.dtype == acc:
        return r @ x
    starts, step = _row_chunks(x)
    out = None
    for i in starts:
        part = r[i:i + step] @ x[i:i + step].to(acc)
        out = part if out is None else out + part
    return out


def full_f32_matmul() -> None:
    """Keep float32 products in full float32 on the card.  PyTorch's default
    is already off, but TF32 keeps ~3 decimal digits, which the solvers'
    tolerances cannot absorb, so the port states it where it multiplies."""
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """x[n, d] at the storage dtype, y/offset/weight[n] at the solver dtype,
    on one device."""

    x: Tensor
    y: Tensor
    offset: Tensor
    weight: Tensor

    @property
    def num_examples(self) -> int:
        return self.x.shape[-2]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    def margins(self, w: Tensor) -> Tensor:
        """Raw margins x·w at w's dtype (callers add offset and normalization
        shift); under narrow storage w is rounded to x's dtype first."""
        return storage_mv(self.x, w, w.dtype)

    def rescale_weights(self, scale) -> "DenseBatch":
        """The batch with its row weights times ``scale``; x keeps its width."""
        return self.replace(weight=self.weight * scale)

    def replace(self, **kw) -> "DenseBatch":
        return dataclasses.replace(self, **kw)


def dense_batch(x, y, offset=None, weight=None, dtype=None, device=None) -> DenseBatch:
    """Convenience constructor with default offset 0 / weight 1."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    n = x.shape[-2]
    offset = (torch.zeros(n, dtype=x.dtype, device=x.device) if offset is None
              else torch.as_tensor(offset, dtype=x.dtype, device=x.device))
    weight = (torch.ones(n, dtype=x.dtype, device=x.device) if weight is None
              else torch.as_tensor(weight, dtype=x.dtype, device=x.device))
    return DenseBatch(x=x, y=y, offset=offset, weight=weight)


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """Row-padded sparse batch: ``indices[n, k]`` (int64) column ids and
    ``values[n, k]``, padded with value 0; ``dim`` is the vocabulary size.
    Indices must lie in [0, dim)."""

    indices: Tensor
    values: Tensor
    y: Tensor
    offset: Tensor
    weight: Tensor
    dim: int

    @property
    def num_examples(self) -> int:
        return self.values.shape[-2]

    def margins(self, w: Tensor) -> Tensor:
        """Raw margins: a gather of w at each row's indices and a row sum;
        narrow-stored values are widened, w is not rounded."""
        return (self.values.to(w.dtype) * w[self.indices]).sum(dim=-1)

    def rescale_weights(self, scale) -> "SparseBatch":
        """The batch with its row weights times ``scale``; the values keep
        their width."""
        return self.replace(weight=self.weight * scale)

    def replace(self, **kw) -> "SparseBatch":
        return dataclasses.replace(self, **kw)

    def to_dense(self) -> DenseBatch:
        """The dense twin (tests and tiny problems only); duplicates add."""
        n, k = self.values.shape
        x = torch.zeros((n, self.dim), dtype=self.values.dtype,
                        device=self.values.device)
        rows = torch.arange(n, device=x.device)[:, None].expand(n, k)
        x.index_put_((rows, self.indices), self.values, accumulate=True)
        return DenseBatch(x=x, y=self.y, offset=self.offset, weight=self.weight)


Batch = Union[DenseBatch, SparseBatch]


def sparse_batch(indices, values, y, dim: int, offset=None, weight=None, dtype=None,
                 device=None) -> SparseBatch:
    """Convenience constructor with default offset 0 / weight 1."""
    values = torch.as_tensor(values, dtype=dtype, device=device)
    indices = torch.as_tensor(indices, device=values.device).to(torch.int64)
    y = torch.as_tensor(y, dtype=values.dtype, device=values.device)
    n = values.shape[-2]
    offset = (torch.zeros(n, dtype=values.dtype, device=values.device) if offset is None
              else torch.as_tensor(offset, dtype=values.dtype, device=values.device))
    weight = (torch.ones(n, dtype=values.dtype, device=values.device) if weight is None
              else torch.as_tensor(weight, dtype=values.dtype, device=values.device))
    return SparseBatch(indices=indices, values=values, y=y, offset=offset,
                       weight=weight, dim=int(dim))
