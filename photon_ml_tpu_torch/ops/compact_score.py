"""Compact sparse random-effect scoring: the match-dot.

Port of photon_ml_tpu/ops/compact_score.py, whose TPU kernel
``_match_dot_kernel`` becomes the CUDA C++ kernel in ``csrc/compact_score.cu``
(source note there: bytes-bound on the H100; one lane per (sample, feature)
binary-searches the feature id in its entity's sorted model row, several
samples in flight per warp, the slot gather fused into the kernel).  Per
sample i with entity e = slots[i]:

    out[i] = Σ_f Σ_m [w_idx[e, m] == f_idx[i, f]] · w_val[e, m] · f_val[i, f]

exact because an entity's columns are unique (sorted nonzeros), model
padding carries value 0 and COO padding carries value 0; duplicate feature
ids accumulate, as in ``SparseBatch.margins``.  A slot outside [0, E) (slot
-1: no model) scores 0.

The kernel relies on what every producer of compact rows gives
(``CompactRandomEffectModel.to_compact``, ``convert``'s ``"compact"`` kind,
which checks it): each model row sorted ascending, its ids unique apart
from the trailing padding (id ``dim``, value 0).  The reference's
searchsorted chain relies on the same order.

``eligible`` is the reference's gate on the match work, k_model·k_feat <=
4096, where the compare-select beats a binary search; callers
(``models.game.score_compact_sparse``) take the searchsorted chain for other
shapes.  ``match_plan`` sizes the kernel's lane groups to the shape.  On a
CUDA tensor ``match_dot`` launches the kernel or raises; on a CPU tensor it
runs ``match_dot_plain``, a broadcast compare of [rows, k_feat, 1] against
[rows, 1, k_model] in sample chunks.  ``match_dot.launches`` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

Tensor = torch.Tensor

MAX_MATCH_WORK = 4096  # k_model * k_feat above this keeps the searchsorted chain
_PLAIN_CHUNK = 1 << 24  # compare elements per chunk of the plain version
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def eligible(k_model: int, k_feat: int) -> bool:
    """True when the match-dot takes the place of the searchsorted chain."""
    return k_model >= 1 and k_feat >= 1 and k_model * k_feat <= MAX_MATCH_WORK


_LANE_BATCH = 4  # features a lane searches at once, at most (kMaxBatch in the kernel)


@dataclasses.dataclass(frozen=True)
class MatchPlan:
    """How the kernel spreads one sample: a group of ``2**log_group`` lanes,
    each taking ``feats_per_lane`` of its features and spending ``steps``
    dependent loads on each (the binary-search probes and the final one)."""

    log_group: int
    feats_per_lane: int
    steps: int

    @property
    def group(self) -> int:
        return 1 << self.log_group

    @property
    def lane_steps(self) -> int:
        """Lane-steps one sample occupies, idle lanes of its group included."""
        return self.group * self.feats_per_lane * self.steps


def search_steps(k_model: int) -> int:
    """Dependent loads of one lower-bound search in a row of ``k_model``:
    ceil(log2 k_model) probes and the final compare."""
    return (k_model - 1).bit_length() + 1


def flat_trips(k_model: int, k_feat: int) -> int:
    """Warp trips per sample of a warp striding over the flattened
    (feature, model entry) pairs: ceil(k_model·k_feat / 32)."""
    return -(-k_model * k_feat // 32)


@functools.lru_cache(maxsize=None)
def match_plan(k_model: int, k_feat: int) -> MatchPlan:
    """The lane group of one sample: among groups whose lanes take at most
    one batch of features each, the one that leaves fewest lanes idle (the
    wider on a tie), else a whole warp; then halved until the sample's
    lane-steps fit in the flattened walk's 32·ceil(k_model·k_feat / 32).
    Cached: the wrapper asks once per call."""
    steps = search_steps(k_model)

    def plan(lg: int) -> MatchPlan:
        return MatchPlan(lg, -(-k_feat // (1 << lg)), steps)

    one_batch = [plan(lg) for lg in range(6) if plan(lg).feats_per_lane <= _LANE_BATCH]
    best = (min(one_batch, key=lambda p: (p.group * p.feats_per_lane, -p.group))
            if one_batch else plan(5))
    while best.log_group > 0 and best.lane_steps > 32 * flat_trips(k_model, k_feat):
        best = plan(best.log_group - 1)
    return best


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


def score_sparse_compact(w_idx: Tensor, w_val: Tensor, slots: Tensor, f_idx: Tensor,
                         f_val: Tensor) -> Tensor:
    """The reference's wrapper of its kernel: per-sample compact margins [n],
    each sample's entity row gathered by slot and matched against its
    features, samples without an entity (slot -1) scored 0.  Here the slot
    gather and the zeroing happen inside ``match_dot`` (the kernel on the
    card, ``match_dot_plain`` on the CPU)."""
    return match_dot(w_idx, w_val, slots, f_idx, f_val)


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
    plan = match_plan(w_idx.shape[1], f_idx.shape[1])
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.match_dot_launch(
            _DTYPE_CODE[w_val.dtype], P(w_idx.data_ptr()), P(w_val.data_ptr()),
            w_idx.shape[0], w_idx.shape[1], P(slots.data_ptr()), P(f_idx.data_ptr()),
            P(f_val.data_ptr()), n, f_idx.shape[1], plan.log_group, plan.feats_per_lane,
            P(out.data_ptr()), P(stream))
    if err != 0:
        raise RuntimeError(f"match_dot kernel launch failed (code {err}: CUDA error, "
                           "or -1 for unsupported arguments)")
    match_dot.launches += 1
    return out
