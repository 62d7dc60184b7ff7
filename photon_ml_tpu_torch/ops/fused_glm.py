"""Fused GLM passes, each in one read of X: value and gradient
(Σ wt·l, Xᵀr, Σ r), and the Hessian-vector product (Xᵀq, Σ q).

Port of ``fused_value_and_grad`` and ``fused_hvp`` in
photon_ml_tpu/ops/fused_glm.py, whose TPU kernels ``_value_grad_kernel`` and
``_hvp_kernel`` become the CUDA C++ kernels in ``csrc/fused_glm.cu`` (source
note there: bytes-bound on the H100, one HBM read of X through an
asynchronous ring of row tiles, per-block partials reduced in a fixed order,
no float atomics).  ``launch_plan`` sizes the ring and the persistent grid.

Storage width, the reference's mixed-precision contract: X and the
coefficient vectors (w_eff, v_eff) share one dtype, the storage dtype, and
y, offset, weight, the shifts and the outputs share the accumulation dtype,
which is the solver's.  The two are equal, or storage is a strictly
narrower float (bf16 or f16 against float32; those or float32 against
float64: ``storage_narrowing_ok``).  Each element of X and the coefficients
is widened as it is read, and the per-row residual r (q in the
Hessian-vector product) is rounded to the storage dtype before Xᵀr, as the
reference's kernels round ``r.astype(x.dtype)``; its sums (Σ r, Σ q) are
not rounded.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its ``*_plain`` version, the same function in plain PyTorch (the
reference math of GLMObjective's XLA path, rounding for rounding).  Each
wrapper's ``launches`` counts its kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from photon_ml_tpu_torch.core.batch import DenseBatch, storage_mv, storage_rmv
from photon_ml_tpu_torch.core.losses import PointwiseLoss

Tensor = torch.Tensor

_WARPS = 8  # csrc/fused_glm.cu kThreads / 32
_TILE_BYTES = 40 << 10  # one stage of the ring: ~40 KB of rows, with their y, offset, weight
_MAX_TILE_ROWS = 256
_MAX_STAGES = 8  # csrc/fused_glm.cu kMaxStages
_BLOCKS_PER_SM = 2  # persistent blocks an SM, where two fit
_SMEM_PER_SM = 228 << 10  # H100: shared memory of one SM ...
_SMEM_RESERVED = 1 << 10  # ... of which each resident block costs 1 KB more
_SMEM_LIMIT = 227 << 10  # ... and the most one block may use
# element type codes of the C interface (csrc/fused_glm.cu, csrc/soa_newton.cu)
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def storage_narrowing_ok(x_dtype: torch.dtype, w_dtype: torch.dtype) -> bool:
    """The one definition of the mixed-precision storage contract: x at the
    solver dtype, or at a strictly narrower float that promotes to it (bf16
    or f16 against float32 or float64, float32 against float64).  Wider
    storage (float64 x under a float32 solver) is out: it takes the plain
    path, routed from the dtypes before any launch."""
    if x_dtype == w_dtype:
        return True
    return (x_dtype in _FLOATS and w_dtype in _FLOATS
            and torch.finfo(x_dtype).bits < torch.finfo(w_dtype).bits
            and torch.promote_types(x_dtype, w_dtype) == w_dtype)


def _check(name: str, batch: DenseBatch, *coefs: Tensor) -> None:
    x = batch.x
    if x.dim() != 2 or any(c.shape != (x.shape[1],) for c in coefs):
        raise ValueError(f"{name}: x {tuple(x.shape)} and coefficients "
                         f"{[tuple(c.shape) for c in coefs]} do not match")
    tensors = (x, *coefs, batch.y, batch.offset, batch.weight)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    acc = batch.y.dtype
    if any(c.dtype != x.dtype for c in coefs) or \
            {batch.offset.dtype, batch.weight.dtype} != {acc}:
        raise ValueError(
            f"{name} needs x and the coefficients at one uniform dtype, and "
            f"y/offset/weight at another (x {x.dtype}, coefficients "
            f"{[c.dtype for c in coefs]}, y/offset/weight {batch.y.dtype}/"
            f"{batch.offset.dtype}/{batch.weight.dtype})")
    if not storage_narrowing_ok(x.dtype, acc):
        raise ValueError(f"{name}: storage {x.dtype} is not a narrowing of the "
                         f"accumulation dtype {acc}")


def _safe_margins(w_eff: Tensor, batch: DenseBatch, margin_shift) -> Tensor:
    z = storage_mv(batch.x, w_eff, batch.y.dtype) + batch.offset + margin_shift
    return torch.where(batch.weight > 0, z, 0.0)  # weight-0 rows stay finite


def fused_value_and_grad_plain(loss: PointwiseLoss, w_eff: Tensor, batch: DenseBatch,
                               margin_shift: "Tensor | float" = 0.0):
    """The plain PyTorch version: (Σ wt·l, Xᵀr, Σ r), r rounded to the
    storage dtype for Xᵀr."""
    z = _safe_margins(w_eff, batch, margin_shift)
    l, d1 = loss.loss_and_d1(z, batch.y)
    r = batch.weight * d1
    return torch.sum(batch.weight * l), storage_rmv(r, batch.x), torch.sum(r)


def fused_hvp_plain(loss: PointwiseLoss, w_eff: Tensor, v_eff: Tensor,
                    batch: DenseBatch, margin_shift: "Tensor | float" = 0.0,
                    v_shift: "Tensor | float" = 0.0):
    """The plain PyTorch version: (Xᵀq, Σ q), q rounded to the storage
    dtype for Xᵀq."""
    z = _safe_margins(w_eff, batch, margin_shift)
    mv = storage_mv(batch.x, v_eff, batch.y.dtype) + v_shift
    q = batch.weight * loss.d2(z, batch.y) * mv
    return storage_rmv(q, batch.x), torch.sum(q)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _reg_coefs(acc_itemsize: int) -> int:
    """Columns a lane holds in registers, widened to the accumulation dtype
    (csrc/fused_glm.cu kRegCoefs)."""
    return 24 if acc_itemsize == 4 else 8


def row_lanes(d: int, acc_itemsize: int) -> int:
    """Lanes that form one row's dot products in the kernels (csrc/fused_glm.cu
    ``row_lanes``): the fewest of 8, 16 and 32 that hold the row in
    registers at the accumulation dtype; 32 when none does."""
    k = _reg_coefs(acc_itemsize)
    return 8 if d <= 8 * k else 16 if d <= 16 * k else 32


def _smem_bytes(d: int, tile_rows: int, stages: int, itemsize: int,
                acc_itemsize: "int | None" = None) -> int:
    """Shared memory of one block (csrc/fused_glm.cu ``smem_bytes``): ``stages``
    ring buffers, each the tile's rows of X (``itemsize`` bytes an element)
    behind up to 16 bytes of pad, then its rows' y, offset and weight
    (``acc_itemsize`` bytes each), in whole 16-byte pieces; then the [d]
    accumulator, the tile's row coefficients, 16 per-warp scalar sums (all
    at the accumulation dtype) and, from the next 8-byte boundary, one
    8-byte mbarrier per stage."""
    acc = itemsize if acc_itemsize is None else acc_itemsize
    vw = 16 // itemsize
    stage_x = itemsize * _round_up(tile_rows * d + vw - 1, vw)
    stage = _round_up(stage_x + 3 * tile_rows * acc, 16)
    return _round_up(stages * stage + acc * (d + tile_rows + 2 * _WARPS), 8) + 8 * stages


class LaunchPlan(NamedTuple):
    tile_rows: int
    stages: int
    rows_per_block: int
    blocks: int
    smem_bytes: int


def launch_plan(n: int, d: int, itemsize: int, num_sms: int,
                acc_itemsize: "int | None" = None) -> LaunchPlan:
    """The CUDA kernels' plan for X of ``itemsize`` bytes an element and an
    accumulation dtype of ``acc_itemsize`` (default: X's): tiles of ~40 KB
    of whole rows (a whole number of waves, the rows the block's 8 warps
    take at once, where a wave fits), a ring of 2-8 of them per block, two
    persistent blocks per SM where that leaves at least two stages (else
    one), each block a contiguous range of whole tiles.  Raises where even
    one row in two stages does not fit a block's shared memory."""
    acc = itemsize if acc_itemsize is None else acc_itemsize
    wave = _WARPS * (32 // row_lanes(d, acc))
    tile_rows = max(1, min(_MAX_TILE_ROWS, _TILE_BYTES // (d * itemsize + 3 * acc), n))
    if tile_rows >= wave:
        tile_rows -= tile_rows % wave
    smem = lambda rows, stages: _smem_bytes(d, rows, stages, itemsize, acc)
    for per_sm in (_BLOCKS_PER_SM, 1):
        budget = min(_SMEM_LIMIT, _SMEM_PER_SM // per_sm - _SMEM_RESERVED)
        stages = next((s for s in range(_MAX_STAGES, 1, -1)
                       if smem(tile_rows, s) <= budget), 0)
        if stages:
            break
    else:
        raise ValueError(f"d={d} does not fit one block's shared memory "
                         f"({smem(1, 2)} bytes for two one-row "
                         f"stages, limit {_SMEM_LIMIT})")
    tiles = -(-n // tile_rows)
    blocks = max(1, min(tiles, num_sms * per_sm))
    rows_per_block = -(-tiles // blocks) * tile_rows
    return LaunchPlan(tile_rows, stages, rows_per_block, -(-n // rows_per_block),
                      smem(tile_rows, stages))


def fused_value_and_grad(loss: PointwiseLoss, w_eff: Tensor, batch: DenseBatch,
                         margin_shift: "Tensor | float" = 0.0):
    """(Σ wt·l, Xᵀr, Σ r) with z = X·w_eff + offset + margin_shift, z = 0 where
    weight <= 0, r = wt·l'(z, y).  Raw-space sums: the caller applies the
    normalization chain rule and L2."""
    _check("fused_value_and_grad", batch, w_eff)
    if not batch.x.is_cuda:
        return fused_value_and_grad_plain(loss, w_eff, batch, margin_shift)
    out = _run("fvg_launch", "fused_value_and_grad", loss, batch, (w_eff,),
               (margin_shift,), width=batch.x.shape[1] + 2)
    fused_value_and_grad.launches += 1
    d = batch.x.shape[1]
    return out[d], out[:d], out[d + 1]


fused_value_and_grad.launches = 0


def fused_hvp(loss: PointwiseLoss, w_eff: Tensor, v_eff: Tensor, batch: DenseBatch,
              margin_shift: "Tensor | float" = 0.0, v_shift: "Tensor | float" = 0.0):
    """(Xᵀq, Σ q) with q = wt·l''(z, y)·(X·v_eff + v_shift), z as in
    ``fused_value_and_grad``.  Raw-space sums: the caller applies the
    normalization chain rule and L2."""
    _check("fused_hvp", batch, w_eff, v_eff)
    if not batch.x.is_cuda:
        return fused_hvp_plain(loss, w_eff, v_eff, batch, margin_shift, v_shift)
    out = _run("hvp_launch", "fused_hvp", loss, batch, (w_eff, v_eff),
               (margin_shift, v_shift), width=batch.x.shape[1] + 1)
    fused_hvp.launches += 1
    d = batch.x.shape[1]
    return out[:d], out[d]


fused_hvp.launches = 0


def _run(entry: str, name: str, loss: PointwiseLoss, batch: DenseBatch, coefs, shifts,
         width: int) -> Tensor:
    """Launch the C entry point ``entry`` of the kernel library on
    (x, coefs, y, offset, weight, shifts); returns its [width] output at the
    accumulation dtype."""
    from photon_ml_tpu_torch.ops import _build

    x = batch.x
    n, d = x.shape
    dev = x.device
    acc = batch.y.dtype
    if n == 0:
        raise ValueError(f"{name}: empty batch")
    if x.dtype not in DTYPE_CODE or acc not in (torch.float32, torch.float64):
        raise ValueError(f"{name} kernel takes x in float32/float64/bfloat16/float16 "
                         f"accumulating in float32/float64, not {x.dtype} in {acc}")
    tensors = (x, *coefs, batch.y, batch.offset, batch.weight)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    lib = _build.load("fused_glm")
    codes = (DTYPE_CODE[x.dtype], DTYPE_CODE[acc])
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    acc_item = batch.y.element_size()
    plan = launch_plan(n, d, x.element_size(), num_sms, acc_item)
    if lib.glm_smem_bytes(*codes, d, plan.tile_rows, plan.stages) != plan.smem_bytes:
        raise RuntimeError(f"{name}: the plan's shared memory {plan.smem_bytes} is not "
                           "the kernel's (launch_plan and csrc/fused_glm.cu disagree)")
    shift_t = [torch.as_tensor(s, dtype=acc, device=dev).reshape(1) for s in shifts]
    partials = torch.empty((plan.blocks, width), dtype=acc, device=dev)
    out = torch.empty(width, dtype=acc, device=dev)
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*codes, loss.code,
                                  *[P(t.data_ptr()) for t in (*tensors, *shift_t)],
                                  n, d, plan.rows_per_block, plan.tile_rows,
                                  plan.stages, plan.blocks,
                                  P(partials.data_ptr()), P(out.data_ptr()), P(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {err}: CUDA error, "
                           "or -1 for unsupported arguments)")
    return out
