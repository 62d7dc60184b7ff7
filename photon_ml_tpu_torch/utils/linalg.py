"""Dense linear-algebra helpers.

Port of ``cholesky_inverse`` in photon_ml_tpu/utils/linalg.py, used for FULL
coefficient variances (diag(H⁻¹)): Cholesky factor L, its triangular
inverse, then L⁻ᵀ L⁻¹.  Batched over any leading dimensions.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.core.batch import full_f32_matmul

Tensor = torch.Tensor


def cholesky_inverse(a: Tensor) -> Tensor:
    """Inverse of symmetric positive-definite matrices [..., d, d] via
    Cholesky."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol = torch.linalg.cholesky(a)
    inv_l = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    full_f32_matmul()
    return inv_l.mT @ inv_l
