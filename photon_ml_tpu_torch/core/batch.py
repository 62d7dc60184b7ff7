"""Dense training batch.

Port of photon_ml_tpu/core/batch.py (``DenseBatch`` only; sparse batches are
a later slice).  Padded or invalid examples carry weight 0 and the
weighted-sum algebra ignores them.
"""

from __future__ import annotations

import dataclasses

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
