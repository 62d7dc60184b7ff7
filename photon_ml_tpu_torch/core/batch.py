"""Training batches: dense ``x[n, d]`` and row-padded sparse COO.

Port of photon_ml_tpu/core/batch.py (``DenseBatch``, ``SparseBatch``).
Padded or invalid examples carry weight 0 and the weighted-sum algebra
ignores them.  A sparse row pads with (index 0, value 0): a zero value is
inert in margins and gradients wherever it points.  Duplicate indices within
a row accumulate.  Mixed-precision storage (bf16 values against f32 solver
state) is a later slice: both batches hold one dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

Tensor = torch.Tensor


def full_f32_matmul() -> None:
    """Keep float32 products in full float32 on the card.  PyTorch's default
    is already off, but TF32 keeps ~3 decimal digits, which the solvers'
    tolerances cannot absorb, so the port states it where it multiplies."""
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """x[n, d], y/offset/weight[n], all of one dtype on one device."""

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
        """Raw margins x·w (callers add offset and normalization shift)."""
        full_f32_matmul()
        return torch.mv(self.x, w)

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
        """Raw margins: a gather of w at each row's indices and a row sum."""
        return (self.values * w[self.indices]).sum(dim=-1)

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
