"""GAME model containers: fixed effect, dense and compact random effects,
and the composite model.

Port of photon_ml_tpu/models/game.py.  Coefficients live on the host as
numpy; scoring moves them to the device it runs on, once per model instance
and device (``cached_device_copies``).  A dense random effect is a stacked
matrix W[num_entities, d] plus an entity-id -> row map; entities without a
model score 0.  ``RandomEffectModel.to_compact`` gives the wide-vocabulary
twin, ``CompactRandomEffectModel``: per-entity sorted column ids and values
[E, k], scored without ever building [E, d].  On a sparse shard its scoring
is the match-dot of ``ops.compact_score`` (the CUDA kernel that replaces
``_match_dot_kernel``) where ``eligible`` admits the shape, else the
reference's searchsorted chain, in PyTorch, on either device.

``score(data, device=...)`` defaults to the card (``device="cuda"``) and
raises there when no card is present; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.shards import SparseShard
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.ops import compact_score
from photon_ml_tpu_torch.parallel.bucketing import (score_samples, score_samples_sparse,
                                                    slots_from)
from photon_ml_tpu_torch.types import TaskType

if TYPE_CHECKING:
    from photon_ml_tpu_torch.game.data import GameData

Tensor = torch.Tensor


class DatumScoringModel:
    """Contract: raw per-sample scores of a GameData."""

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        raise NotImplementedError


def _canonical(device: torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def cached_device_copies(model, device, *arrays) -> tuple:
    """Device copies of a model's host arrays, made once per instance and
    device.  The cache is keyed by the arrays' identities, so a model
    rebuilt with ``dataclasses.replace`` starts without one."""
    device = _canonical(device)
    cache = getattr(model, "_dev_cache", None)
    if cache is not None and cache[1] == device and len(cache[0]) == len(arrays) \
            and all(c is a for c, a in zip(cache[0], arrays)):
        return cache[2]
    dev = tuple(torch.as_tensor(a, device=device) for a in arrays)
    seed_device_copies(model, arrays, dev)
    return dev


def seed_device_copies(model, arrays: tuple, tensors: tuple) -> None:
    """Hand a model the device copies of its arrays that the caller already
    holds (a coordinate publishing a stack it built on the card)."""
    object.__setattr__(model, "_dev_cache", (arrays, _canonical(tensors[0].device),
                                             tensors))


def _dense_shard(data: "GameData", shard: str, device: torch.device) -> Tensor:
    return torch.as_tensor(data.features[shard], device=device)


def _sparse_shard(shard, device: torch.device, dtype: Optional[torch.dtype] = None):
    """(indices int32, values, in ``dtype`` if given) of a SparseShard on
    ``device``."""
    vals = torch.as_tensor(shard.values, device=device)
    return (torch.as_tensor(np.asarray(shard.indices, np.int32), device=device),
            vals if dtype is None else vals.to(dtype))


@dataclasses.dataclass(frozen=True)
class FixedEffectModel(DatumScoringModel):
    """Global GLM over one feature shard."""

    coefficients: Coefficients
    feature_shard: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        dev = resolve_device(device)
        shard = data.features[self.feature_shard]
        if isinstance(shard, SparseShard):
            w = torch.as_tensor(self.coefficients.means, device=dev)
            idx, vals = _sparse_shard(shard, dev)
            dt = torch.promote_types(w.dtype, vals.dtype)
            return (vals.to(dt) * w.to(dt)[idx.long()]).sum(dim=-1)
        return self.coefficients.score(_dense_shard(data, self.feature_shard, dev))


@dataclasses.dataclass(frozen=True)
class RandomEffectModel(DatumScoringModel):
    """Per-entity GLMs as a stacked coefficient matrix:
    ``w_stack[slot_of[entity_id]]`` is that entity's coefficient vector."""

    w_stack: np.ndarray  # [num_entities, d]
    slot_of: Dict[int, int]
    random_effect_type: str  # the id-tag column name
    feature_shard: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    @property
    def num_entities(self) -> int:
        return self.w_stack.shape[0]

    def slots_for(self, data: "GameData") -> np.ndarray:
        return slots_from(self.slot_of, data.id_tags[self.random_effect_type])

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        dev = resolve_device(device)
        (w,) = cached_device_copies(self, dev, self.w_stack)
        slots = torch.as_tensor(self.slots_for(data), device=dev)
        shard = data.features[self.feature_shard]
        if isinstance(shard, SparseShard):
            # row-sparse shard: an O(n*k) two-level gather, never [n, d_full]
            idx, vals = _sparse_shard(shard, dev, w.dtype)
            return score_samples_sparse(w, slots, idx, vals)
        x = _dense_shard(data, self.feature_shard, dev)
        dt = torch.promote_types(x.dtype, w.dtype)
        return score_samples(w.to(dt), slots, x.to(dt))

    def to_compact(self, k: Optional[int] = None) -> "CompactRandomEffectModel":
        """The sparse per-entity container: each entity's nonzero columns,
        ascending, padded with ``dim`` (value 0) to ``k`` (default: the
        densest entity's count).  A ``k`` below that count is an error:
        truncation would change scores.  An O(nnz) build on the host."""
        w = np.asarray(self.w_stack)
        e, d = w.shape
        rows, cols = np.nonzero(w)  # row-major: columns ascend within a row
        counts = np.bincount(rows, minlength=e)
        k_need = int(counts.max()) if e else 0
        if k is None:
            k = max(1, k_need)
        elif k < k_need:
            raise ValueError(
                f"capacity k={k} < densest entity's {k_need} nonzero "
                "coefficients; truncation would silently change scores")
        offsets = np.zeros(e + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        pos = np.arange(len(rows)) - offsets[rows]
        idx = np.full((e, k), d, np.int32)
        val = np.zeros((e, k), w.dtype)
        idx[rows, pos] = cols
        val[rows, pos] = w[rows, cols]
        return CompactRandomEffectModel(
            indices=idx, values=val, dim=d, slot_of=dict(self.slot_of),
            random_effect_type=self.random_effect_type,
            feature_shard=self.feature_shard, task=self.task)


def score_compact_dense(w_idx: Tensor, w_val: Tensor, slots: Tensor, x: Tensor) -> Tensor:
    """Σ_t w_val[e, t] · x[i, w_idx[e, t]]: the dense design gathered at each
    entity's columns (padding columns, id = dim, add 0)."""
    e = torch.where(slots >= 0, slots, 0).long()
    idx = w_idx[e].long()
    xv = torch.gather(x, 1, idx.clamp(0, x.shape[1] - 1))
    s = (w_val[e] * torch.where(idx < x.shape[1], xv, 0.0)).sum(dim=1)
    return torch.where(slots >= 0, s, 0.0)


def score_compact_sparse_search(w_idx: Tensor, w_val: Tensor, slots: Tensor,
                                f_idx: Tensor, f_val: Tensor) -> Tensor:
    """The searchsorted chain: each sample feature id binary-searched in its
    entity's sorted columns (a miss adds 0).  The reference's route for
    shapes the match-dot gate refuses."""
    e = torch.where(slots >= 0, slots, 0).long()
    rows_idx = w_idx[e]  # [n, k_model], sorted, padded with dim
    rows_val = w_val[e]
    f_idx = f_idx.to(rows_idx.dtype).contiguous()
    pos = torch.searchsorted(rows_idx, f_idx).clamp(0, rows_idx.shape[1] - 1)
    hit = torch.gather(rows_idx, 1, pos) == f_idx
    wv = torch.where(hit, torch.gather(rows_val, 1, pos), 0.0)
    s = (f_val * wv).sum(dim=1)
    return torch.where(slots >= 0, s, 0.0)


def score_compact_sparse(w_idx: Tensor, w_val: Tensor, slots: Tensor, f_idx: Tensor,
                         f_val: Tensor) -> Tensor:
    """Sparse-features x compact-model margins: the match-dot
    (``ops.compact_score.match_dot``: the CUDA kernel on the card, its plain
    version on the CPU) where ``eligible`` admits the shape, else the
    searchsorted chain."""
    if compact_score.eligible(w_idx.shape[1], f_idx.shape[1]):
        return compact_score.match_dot(w_idx, w_val, slots, f_idx, f_val)
    return score_compact_sparse_search(w_idx, w_val, slots, f_idx, f_val)


def check_compact_rows(indices: np.ndarray, values: np.ndarray, dim: int) -> None:
    """Raise unless every compact row is what the match-dot kernel and the
    searchsorted chain rely on: column ids in [0, dim) strictly ascending,
    then only padding (id ``dim``, value 0)."""
    idx, val = np.asarray(indices), np.asarray(values)
    if idx.shape != val.shape or idx.ndim != 2:
        raise ValueError(f"compact indices {idx.shape} and values {val.shape} must be "
                         "one [E, k] shape")
    pad = idx == dim
    if ((idx < 0) | (idx > dim)).any() or (val[pad] != 0).any():
        raise ValueError(f"compact ids must lie in [0, {dim}], padding (id {dim}) "
                         "carrying value 0")
    if (pad[:, :-1] & ~pad[:, 1:]).any() or \
            ((np.diff(idx, axis=1) <= 0) & ~pad[:, 1:]).any():
        raise ValueError("compact rows must be sorted ascending with unique ids, "
                         "padding last")


@dataclasses.dataclass(frozen=True)
class CompactRandomEffectModel(DatumScoringModel):
    """Per-entity GLMs as sparse coefficient rows, the wide-vocabulary
    published container.  ``indices[slot]`` are that entity's column ids,
    ascending, padded with ``dim``; ``values`` align, padded with 0.  Dense
    shards gather x at the entity's columns; sparse shards match each sample
    feature against them.  Missing entities score 0."""

    indices: np.ndarray  # [num_entities, k] int32, sorted, dim-padded
    values: np.ndarray  # [num_entities, k]
    dim: int
    slot_of: Dict[int, int]
    random_effect_type: str
    feature_shard: str
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    @property
    def num_entities(self) -> int:
        return self.indices.shape[0]

    def slots_for(self, data: "GameData") -> np.ndarray:
        return slots_from(self.slot_of, data.id_tags[self.random_effect_type])

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        shard = data.features[self.feature_shard]
        if shard.shape[1] != self.dim:
            # the padding masks would otherwise zero real coefficients silently
            raise ValueError(f"shard {self.feature_shard!r} has {shard.shape[1]} "
                             f"features but this model was trained on {self.dim}")
        dev = resolve_device(device)
        slots = torch.as_tensor(self.slots_for(data), device=dev)
        w_idx, w_val = cached_device_copies(self, dev, self.indices, self.values)
        if isinstance(shard, SparseShard):
            f_idx, f_val = _sparse_shard(shard, dev, w_val.dtype)
            return score_compact_sparse(w_idx, w_val, slots, f_idx, f_val)
        x = _dense_shard(data, self.feature_shard, dev).to(w_val.dtype)
        return score_compact_dense(w_idx, w_val, slots, x)

    def to_dense(self) -> RandomEffectModel:
        e, k = self.indices.shape
        w = np.zeros((e, self.dim), self.values.dtype)
        rows = np.repeat(np.arange(e), k)
        idx = self.indices.reshape(-1)
        keep = idx < self.dim
        w[rows[keep], idx[keep]] = self.values.reshape(-1)[keep]
        return RandomEffectModel(w_stack=w, slot_of=dict(self.slot_of),
                                 random_effect_type=self.random_effect_type,
                                 feature_shard=self.feature_shard, task=self.task)


def dense_random_effect(model) -> RandomEffectModel:
    """A random effect as the dense container (a compact one densified)."""
    return model.to_dense() if isinstance(model, CompactRandomEffectModel) else model


@dataclasses.dataclass
class GameModel:
    """Composite model: coordinate id -> scoring model."""

    models: Dict[str, DatumScoringModel]

    def score(self, data: "GameData", device=DEFAULT_DEVICE) -> Tensor:
        """Sum of the coordinates' raw scores (float64, offsets not added)."""
        from photon_ml_tpu_torch.game.scoring import additive_total

        dev = resolve_device(device)
        return additive_total(data.num_samples,
                              (m.score(data, dev) for m in self.models.values()),
                              device=dev)

    def __getitem__(self, cid: str) -> DatumScoringModel:
        return self.models[cid]

    def __contains__(self, cid: str) -> bool:
        return cid in self.models
