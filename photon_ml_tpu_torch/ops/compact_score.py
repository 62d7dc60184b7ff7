"""Compact sparse random-effect scoring: the match-dot.

Port of photon_ml_tpu/ops/compact_score.py, whose TPU kernel
``_match_dot_kernel`` becomes the CUDA C++ kernel in ``csrc/compact_score.cu``
(source note there: bytes-bound on the H100, one warp per sample, the slot
gather fused into the kernel).  Per sample i with entity e = slots[i]:

    out[i] = Σ_f Σ_m [w_idx[e, m] == f_idx[i, f]] · w_val[e, m] · f_val[i, f]

exact because an entity's columns are unique (sorted nonzeros), model
padding carries value 0 and COO padding carries value 0; duplicate feature
ids accumulate, as in ``SparseBatch.margins``.  A slot outside [0, E) (slot
-1: no model) scores 0.

``eligible`` is the reference's gate on the match work, k_model·k_feat <=
4096, where the compare-select beats a binary search; callers
(``models.game.score_compact_sparse``) take the searchsorted chain for other
shapes.  On a CUDA tensor ``match_dot`` launches the kernel or raises; on a
CPU tensor it runs ``match_dot_plain``, a broadcast compare of
[rows, k_feat, 1] against [rows, 1, k_model] in sample chunks.
``match_dot.launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

MAX_MATCH_WORK = 4096  # k_model * k_feat above this keeps the searchsorted chain
_PLAIN_CHUNK = 1 << 24  # compare elements per chunk of the plain version
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def eligible(k_model: int, k_feat: int) -> bool:
    """True when the match-dot takes the place of the searchsorted chain."""
    return k_model >= 1 and k_feat >= 1 and k_model * k_feat <= MAX_MATCH_WORK


def match_dot_plain(w_idx: Tensor, w_val: Tensor, slots: Tensor, f_idx: Tensor,
                    f_val: Tensor) -> Tensor:
    """The plain PyTorch version of ``match_dot``."""
    n = slots.shape[0]
    num_e, k_model = w_idx.shape
    out = torch.empty(n, dtype=w_val.dtype, device=w_val.device)
    step = max(1, _PLAIN_CHUNK // (k_model * f_idx.shape[1]))
    for lo in range(0, n, step):
        s = slots[lo:lo + step]
        has = (s >= 0) & (s < num_e)
        e = torch.where(has, s, 0).long()
        hit = f_idx[lo:lo + step, :, None] == w_idx[e][:, None, :]
        wv = torch.where(hit, w_val[e][:, None, :], 0.0).sum(dim=-1)  # [rows, k_feat]
        out[lo:lo + step] = torch.where(has, (f_val[lo:lo + step] * wv).sum(dim=-1), 0.0)
    return out


def _check(w_idx, w_val, slots, f_idx, f_val) -> None:
    if w_idx.dim() != 2 or w_val.shape != w_idx.shape:
        raise ValueError(f"match_dot: w_idx {tuple(w_idx.shape)} and w_val "
                         f"{tuple(w_val.shape)} must be one [E, k_model] shape")
    if f_idx.dim() != 2 or f_val.shape != f_idx.shape or slots.shape != f_idx.shape[:1]:
        raise ValueError(f"match_dot: f_idx {tuple(f_idx.shape)}, f_val "
                         f"{tuple(f_val.shape)} and slots {tuple(slots.shape)} must "
                         "be [n, k_feat], [n, k_feat] and [n]")
    if w_val.dtype != f_val.dtype:
        raise ValueError(f"match_dot: w_val {w_val.dtype} and f_val {f_val.dtype} differ")
    if not eligible(w_idx.shape[1], f_idx.shape[1]):
        raise ValueError(f"match_dot called on an ineligible shape (k_model "
                         f"{w_idx.shape[1]} x k_feat {f_idx.shape[1]} > "
                         f"{MAX_MATCH_WORK}); gate on eligible()")


def match_dot(w_idx: Tensor, w_val: Tensor, slots: Tensor, f_idx: Tensor,
              f_val: Tensor) -> Tensor:
    """Per-sample compact margins [n] of samples (``f_idx``/``f_val``
    [n, k_feat]) against their entities' model rows (``w_idx``/``w_val``
    [E, k_model], picked by ``slots`` [n]).  Callers gate on ``eligible``."""
    _check(w_idx, w_val, slots, f_idx, f_val)
    if not w_val.is_cuda:
        return match_dot_plain(w_idx, w_val, slots, f_idx, f_val)
    return _launch(w_idx, w_val, slots, f_idx, f_val)


match_dot.launches = 0


def _launch(w_idx, w_val, slots, f_idx, f_val) -> Tensor:
    from photon_ml_tpu_torch.ops import _build

    dev = w_val.device
    if w_val.dtype not in _DTYPE_CODE:
        raise ValueError(f"match_dot kernel takes float32/float64, not {w_val.dtype}")
    tensors = (w_idx, w_val, slots, f_idx, f_val)
    if any(t.device != dev for t in tensors):
        raise ValueError("match_dot: all tensors must be on one device")
    w_idx, slots, f_idx = (t.to(torch.int32).contiguous() for t in (w_idx, slots, f_idx))
    w_val, f_val = w_val.contiguous(), f_val.contiguous()
    n = slots.shape[0]
    out = torch.empty(n, dtype=w_val.dtype, device=dev)
    if n == 0:
        return out
    lib = _build.load("compact_score")
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.match_dot_launch(
            _DTYPE_CODE[w_val.dtype], P(w_idx.data_ptr()), P(w_val.data_ptr()),
            w_idx.shape[0], w_idx.shape[1], P(slots.data_ptr()), P(f_idx.data_ptr()),
            P(f_val.data_ptr()), n, f_idx.shape[1], P(out.data_ptr()), P(stream))
    if err != 0:
        raise RuntimeError(f"match_dot kernel launch failed (code {err}: CUDA error, "
                           "or -1 for unsupported arguments)")
    match_dot.launches += 1
    return out
