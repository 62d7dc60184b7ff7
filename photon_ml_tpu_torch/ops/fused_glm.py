"""Fused GLM value and gradient: (Σ wt·l, Xᵀr, Σ r) in one read of X.

Port of ``fused_value_and_grad`` in photon_ml_tpu/ops/fused_glm.py, whose TPU
kernel ``_value_grad_kernel`` becomes the CUDA C++ kernel in
``csrc/fused_glm.cu`` (source note there: bytes-bound on the H100, one HBM
read of X, per-block partials reduced in a fixed order, no float atomics).

On a CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor
it runs ``fused_value_and_grad_plain``, the same function in plain PyTorch
(the reference math of GLMObjective's XLA path).  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.core.batch import DenseBatch, full_f32_matmul
from photon_ml_tpu_torch.core.losses import PointwiseLoss

Tensor = torch.Tensor

_TILE_BYTES = 32 << 10  # staged rows per tile: ~32 KB of X
_MAX_TILE_ROWS = 256
_BLOCKS_PER_SM = 4
_SMEM_LIMIT = 227 << 10  # H100 shared memory a block may use
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _check(loss: PointwiseLoss, w_eff: Tensor, batch: DenseBatch) -> None:
    x = batch.x
    if x.dim() != 2 or w_eff.shape != (x.shape[1],):
        raise ValueError(f"fused_value_and_grad: x {tuple(x.shape)} and w "
                         f"{tuple(w_eff.shape)} do not match")
    tensors = (x, w_eff, batch.y, batch.offset, batch.weight)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_value_and_grad: tensors must be contiguous")
    dts = {t.dtype for t in tensors}
    if len(dts) != 1:
        raise ValueError(
            f"fused_value_and_grad needs one uniform dtype (x {x.dtype} vs w "
            f"{w_eff.dtype}, y/offset/weight {batch.y.dtype}); narrower "
            "storage is a later slice (ROADMAP: bf16 storage)")


def fused_value_and_grad_plain(loss: PointwiseLoss, w_eff: Tensor, batch: DenseBatch,
                               margin_shift: "Tensor | float" = 0.0):
    """The plain PyTorch version: (Σ wt·l, Xᵀr, Σ r)."""
    z = batch.margins(w_eff) + batch.offset + margin_shift
    z = torch.where(batch.weight > 0, z, 0.0)  # weight-0 rows stay finite
    l, d1 = loss.loss_and_d1(z, batch.y)
    r = batch.weight * d1
    full_f32_matmul()
    return torch.sum(batch.weight * l), r @ batch.x, torch.sum(r)


def launch_shape(n: int, d: int, itemsize: int, num_sms: int):
    """(tile_rows, rows_per_block, num_blocks) for the CUDA kernel: tiles of
    ~32 KB of whole rows, about four blocks per SM, each block a contiguous
    range of whole tiles."""
    tile_rows = max(1, min(_MAX_TILE_ROWS, _TILE_BYTES // (d * itemsize), n))
    tiles = -(-n // tile_rows)
    blocks = max(1, min(tiles, num_sms * _BLOCKS_PER_SM))
    rows_per_block = -(-tiles // blocks) * tile_rows
    return tile_rows, rows_per_block, -(-n // rows_per_block)


def fused_value_and_grad(loss: PointwiseLoss, w_eff: Tensor, batch: DenseBatch,
                         margin_shift: "Tensor | float" = 0.0):
    """(Σ wt·l, Xᵀr, Σ r) with z = X·w_eff + offset + margin_shift, z = 0 where
    weight <= 0, r = wt·l'(z, y).  Raw-space sums: the caller applies the
    normalization chain rule and L2."""
    _check(loss, w_eff, batch)
    if not batch.x.is_cuda:
        return fused_value_and_grad_plain(loss, w_eff, batch, margin_shift)
    return _launch(loss, w_eff, batch, margin_shift)


fused_value_and_grad.launches = 0


def _launch(loss, w_eff, batch, margin_shift):
    from photon_ml_tpu_torch.ops import _build

    x = batch.x
    n, d = x.shape
    dev = x.device
    if n == 0:
        raise ValueError("fused_value_and_grad: empty batch")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_value_and_grad kernel takes float32/float64, "
                         f"not {x.dtype}")
    tensors = (x, w_eff, batch.y, batch.offset, batch.weight)
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_value_and_grad: all tensors must be on one device")
    lib = _build.load("fused_glm")
    code = _DTYPE_CODE[x.dtype]
    itemsize = x.element_size()
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_rows, rows_per_block, blocks = launch_shape(n, d, itemsize, num_sms)
    if lib.fvg_smem_bytes(code, d, tile_rows) > _SMEM_LIMIT:
        raise ValueError(f"fused_value_and_grad: d={d} does not fit one block's "
                         "shared memory")
    shift = torch.as_tensor(margin_shift, dtype=x.dtype, device=dev).reshape(1)
    partials = torch.empty((blocks, d + 2), dtype=x.dtype, device=dev)
    out = torch.empty(d + 2, dtype=x.dtype, device=dev)
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fvg_launch(code, loss.code, P(x.data_ptr()), P(w_eff.data_ptr()),
                             P(batch.y.data_ptr()), P(batch.offset.data_ptr()),
                             P(batch.weight.data_ptr()), P(shift.data_ptr()), n, d,
                             rows_per_block, tile_rows, blocks,
                             P(partials.data_ptr()), P(out.data_ptr()), P(stream))
    if err != 0:
        raise RuntimeError(f"fused_value_and_grad kernel launch failed "
                           f"(code {err}: CUDA error, or -1 for unsupported "
                           "arguments)")
    fused_value_and_grad.launches += 1
    return out[d], out[:d], out[d + 1]
