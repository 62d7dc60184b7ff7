"""The per-lane Newton step of the structure-of-arrays solver.

Port of ``newton_step`` in photon_ml_tpu/ops/soa_newton.py, whose TPU kernel
``_newton_step_kernel`` becomes the CUDA C++ kernel in ``csrc/soa_newton.cu``
(source note there: bytes-bound on the H100, one thread per lane with the
Hessian triangle, its Cholesky factor and both solves in registers).

On a CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor
it runs ``newton_step_plain``: ``soa_margins``, ``hessian_soa`` and
``cholesky_solve_soa`` below, which follow the XLA path of
photon_ml_tpu/opt/newton_soa.py (``_margins``, ``_hess``,
``_cholesky_solve_soa``) op for op.  Unlike the TPU kernel (L % 128 == 0)
any lane count is taken.  ``launches`` counts kernel launches only.

Storage width: ``x_t`` may be held at a narrower float than w (bf16 or f16
against float32; ``ops.fused_glm.storage_narrowing_ok``); the kernel and the
plain version widen each element of x and do not round w, as the reference
computes at promote(x, w).  Every other input is at w's dtype.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.fused_glm import DTYPE_CODE, storage_narrowing_ok

Tensor = torch.Tensor

MAX_DIM = 16  # the kernel's D template range, and the SoA gate's width cap
KERNEL_LOSSES = ("logistic", "squared", "poisson")  # what the SoA gate admits


def soa_margins(w: Tensor, x_t: Tensor, off_t: Tensor) -> Tensor:
    """[cap, L] margins: sum over the d axis of x_t [cap, d, L] (widened to
    w's dtype) * w [d, L]."""
    return (x_t.to(w.dtype) * w[None]).sum(dim=1) + off_t


def hessian_soa(loss: PointwiseLoss, w, x_t, y_t, off_t, wt_t, l2) -> List[List[Tensor]]:
    """Lower-triangle Hessian entries hh[i][j] (and their mirror) as [L]
    tensors, l2 on the diagonal."""
    z = soa_margins(w, x_t, off_t)
    q = wt_t * loss.d2(z, y_t)                       # [cap, L]
    d = w.shape[0]
    x_t = x_t.to(q.dtype)
    xq = x_t * q[:, None, :]                         # [cap, d, L]
    hh = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            hij = (xq[:, i, :] * x_t[:, j, :]).sum(0)
            if i == j:
                hij = hij + l2
            hh[i][j] = hij
            hh[j][i] = hij
    return hh


def cholesky_solve_soa(hh: List[List[Tensor]], g: Tensor, jitter: Tensor) -> Tensor:
    """x = (H + jitter I)^-1 g, unrolled over d, elementwise over lanes, with
    the sqrt(max(s, jitter)) floor."""
    d = g.shape[0]
    lo = [[None] * d for _ in range(d)]
    for i in range(d):
        s = hh[i][i] + jitter
        for k in range(i):
            s = s - lo[i][k] * lo[i][k]
        lii = torch.sqrt(torch.maximum(s, jitter))
        lo[i][i] = lii
        for j in range(i + 1, d):
            s2 = hh[j][i]
            for k in range(i):
                s2 = s2 - lo[j][k] * lo[i][k]
            lo[j][i] = s2 / lii
    z = [None] * d
    for i in range(d):
        s = g[i]
        for k in range(i):
            s = s - lo[i][k] * z[k]
        z[i] = s / lo[i][i]
    x = [None] * d
    for i in reversed(range(d)):
        s = z[i]
        for k in range(i + 1, d):
            s = s - lo[k][i] * x[k]
        x[i] = s / lo[i][i]
    return torch.stack(x)


def newton_step_plain(loss: PointwiseLoss, w, g, x_t, y_t, off_t, wt_t, l2) -> Tensor:
    """The plain PyTorch version of ``newton_step``."""
    d = w.shape[0]
    hh = hessian_soa(loss, w, x_t, y_t, off_t, wt_t, l2)
    eps = torch.finfo(w.dtype).eps
    diag_max = torch.stack([hh[i][i] for i in range(d)]).abs().amax(0)
    return cholesky_solve_soa(hh, g, eps * (diag_max + 1.0))


def _check(w, g, x_t, y_t, off_t, wt_t, l2) -> None:
    d, num_l = w.shape
    cap = x_t.shape[0]
    shapes = {"g": (g, (d, num_l)), "x_t": (x_t, (cap, d, num_l)),
              "y_t": (y_t, (cap, num_l)), "off_t": (off_t, (cap, num_l)),
              "wt_t": (wt_t, (cap, num_l)), "l2": (l2, (num_l,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"newton_step: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != w.dtype and not (name == "x_t"
                                        and storage_narrowing_ok(t.dtype, w.dtype)):
            raise ValueError(f"newton_step: {name} is {t.dtype}, w is {w.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"newton_step: {name} must be contiguous (lanes last)")
    if not w.is_contiguous():
        raise ValueError("newton_step: w must be contiguous (lanes last)")


def newton_step(loss: PointwiseLoss, w: Tensor, g: Tensor, x_t: Tensor, y_t: Tensor,
                off_t: Tensor, wt_t: Tensor, l2: Tensor) -> Tensor:
    """step = (H(w) + jitter I)^-1 g per lane.

    ``w``/``g``: [d, L]; ``x_t``: [cap, d, L]; ``y/off/wt_t``: [cap, L];
    ``l2``: [L] per-lane L2 weight.  Returns the [d, L] Newton step."""
    _check(w, g, x_t, y_t, off_t, wt_t, l2)
    if not w.is_cuda:
        return newton_step_plain(loss, w, g, x_t, y_t, off_t, wt_t, l2)
    return _launch(loss, w, g, x_t, y_t, off_t, wt_t, l2)


newton_step.launches = 0


def _launch(loss, w, g, x_t, y_t, off_t, wt_t, l2) -> Tensor:
    from photon_ml_tpu_torch.ops import _build

    d, num_l = w.shape
    cap = x_t.shape[0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"newton_step kernel takes 1 <= d <= {MAX_DIM}, got {d}")
    if loss.name not in KERNEL_LOSSES:
        raise ValueError(f"newton_step kernel takes losses {KERNEL_LOSSES}, "
                         f"not {loss.name!r}")
    if w.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"newton_step kernel takes w in float32/float64, not {w.dtype}")
    if cap < 1 or num_l < 1:
        raise ValueError(f"newton_step: empty bucket (cap {cap}, lanes {num_l})")
    tensors = (w, g, x_t, y_t, off_t, wt_t, l2)
    if any(t.device != w.device for t in tensors):
        raise ValueError("newton_step: all tensors must be on one device")
    lib = _build.load("soa_newton")
    out = torch.empty_like(w)
    P = ctypes.c_void_p
    eps = torch.finfo(w.dtype).eps
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.newton_step_launch(
            DTYPE_CODE[w.dtype], DTYPE_CODE[x_t.dtype], loss.code, d, P(w.data_ptr()), P(g.data_ptr()),
            P(x_t.data_ptr()), P(y_t.data_ptr()), P(off_t.data_ptr()),
            P(wt_t.data_ptr()), P(l2.data_ptr()), cap, num_l, eps,
            P(out.data_ptr()), P(stream))
    if err != 0:
        raise RuntimeError(f"newton_step kernel launch failed (code {err}: CUDA "
                           "error, or -1 for unsupported arguments)")
    newton_step.launches += 1
    return out
