"""Dense linear-algebra helpers.

Port of ``cholesky_inverse`` and ``solve_psd`` in
photon_ml_tpu/utils/linalg.py.  ``cholesky_inverse`` serves FULL coefficient
variances (diag(H⁻¹)): Cholesky factor L, its triangular inverse, then
L⁻ᵀ L⁻¹, batched over any leading dimensions.  ``solve_psd`` solves
a x = b by the same factor and two triangular solves.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.core.batch import full_f32_matmul

Tensor = torch.Tensor


def cholesky_inverse(a: Tensor) -> Tensor:
    """Inverse of symmetric positive-definite matrices [..., d, d] via
    Cholesky.  A matrix that is not positive definite gives NaNs, as the
    reference's factor does; its failure is not read on the host."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a)
    chol = torch.where((info == 0)[..., None, None], chol, float("nan"))
    inv_l = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    full_f32_matmul()
    return inv_l.mT @ inv_l


def solve_psd(a: Tensor, b: Tensor, jitter: float = 0.0) -> Tensor:
    """Solve ``a x = b`` for symmetric positive-definite ``a`` [d, d] by
    Cholesky, ``jitter * I`` added first; ``b`` is [d] or [d, k]."""
    if jitter:
        a = a + jitter * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol = torch.linalg.cholesky(a)
    rhs = b.unsqueeze(-1) if b.dim() == 1 else b
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return x.squeeze(-1) if b.dim() == 1 else x
