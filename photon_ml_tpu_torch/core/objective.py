"""GLM objective: weighted-sum pointwise loss over a batch plus L2.

Port of photon_ml_tpu/core/objective.py, keeping the raw/finish split:
``raw_value_and_grad`` returns plain data sums (Σ wt·l, Xᵀr, Σ r) that a
multi-GPU caller would all-reduce, and ``finish_value_and_grad`` applies the
normalization chain rule and L2.  The raw sums come from
``ops.fused_glm.fused_value_and_grad``, and ``raw_hvp`` likewise splits from
``finish_hvp`` over ``ops.fused_glm.fused_hvp``: the CUDA kernel for a batch
on the card, its plain version for a batch on the CPU.

A ``SparseBatch`` (row-padded COO) takes the JAX package's XLA path, which
is no Pallas kernel: margins are a gather and a row sum, and Xᵀr is a
scatter-add (``index_add_``) of value·r into each row's feature slots, in
plain PyTorch.  Each column's terms are added in row order on both devices
(``_xt_dot_sparse``), so the CPU tests hold the sparse objective to the JAX
package's within 1e-12 relative in float64 (tests/test_torch_sparse.py), and
a sparse fit on the card is bitwise repeatable: with atomics, the order of
the float32 sums would change from run to run, and with it TRON's path near
the optimum (its accepted and rejected steps).  Card and CPU fits over sparse
shards are compared within the float32 path tolerance of chip_smoke.py
(5e-3 relative), not bitwise: exp and log round differently.

``LaneObjective`` is the same objective over a random-effect bucket held
lanes-first (x [L, cap, d], one GLM per lane, a per-lane L2 [L], and a
normalization context shared by every lane or per-lane factor and shift
rows [L, d]): what the JAX package computes as a ``jax.vmap`` of the plain
XLA path, written out as batched products.

``hessian_diag`` and ``hessian`` (coefficient variances) are plain PyTorch
on either device, as the JAX package computes them in plain XLA outside any
Pallas kernel: the dense diagonal Σ wt·l''·x_j² runs over row chunks so the
squared design never exists at full size.  ``soa_hessian_diag`` /
``soa_hessian`` are their forms for the lanes-last buckets [cap, d, L] of
the SoA Newton path (no normalization there: its gate excludes it).

Narrow storage follows the reference's mixed-precision contract on every
path that reads a design.  A dense batch whose ``x`` is a narrowing of the
solver dtype (``ops.fused_glm.storage_narrowing_ok``: bf16 / f16 against
float32) goes to the fused kernels with the effective coefficients rounded
to the storage width; the kernels round the residual to it before Xᵀr and
accumulate at the solver width.  Any other mix (wider storage) takes the
plain path: margins and Xᵀr with the same roundings (``storage_mv`` /
``storage_rmv``), decided from the dtypes before any launch.  Sparse values
are widened and neither the coefficients nor the residual are rounded.  The
Hessian diagonal forms x² at the storage width and rounds q to it, as the
reference's ``hessian_diag`` does through its mixed Xᵀr; the full Hessian
widens x.  ``LaneObjective`` rounds w and r as the dense batch does.

Objectives are weighted SUMS, not means, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from photon_ml_tpu_torch.core.batch import (Batch, DenseBatch, SparseBatch, full_f32_matmul,
                                            narrow, storage_rmv, to_storage)
from photon_ml_tpu_torch.core.losses import PointwiseLoss
from photon_ml_tpu_torch.core.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_value_and_grad,
                                               storage_narrowing_ok)
from photon_ml_tpu_torch.ops.soa_newton import hessian_soa, soa_margins

Tensor = torch.Tensor

# the dense Hessian diagonal squares the design one row chunk at a time; a
# chunk holds at most this many elements (64 MB in float32)
HESSIAN_DIAG_CHUNK_ELEMS = 1 << 24


def _xt_dot_sparse(batch: SparseBatch, r: Tensor) -> Tensor:
    """Xᵀr of a sparse batch: value·r scatter-added into each row's feature
    slots; padded slots carry value 0 and add nothing wherever they point.
    Each column's terms are added in row order on either device: on the CPU
    by ``index_add_``; on CUDA, where ``index_add_`` adds with atomics in an
    order that changes from run to run, by ``index_put_(accumulate=True)``,
    which stable-sorts the slots by column first."""
    contrib = batch.values.to(r.dtype) * r[:, None]
    out = torch.zeros(batch.dim, dtype=contrib.dtype, device=contrib.device)
    idx, terms = batch.indices.reshape(-1), contrib.reshape(-1)
    if out.is_cuda:
        return out.index_put_((idx,), terms, accumulate=True)
    return out.index_add_(0, idx, terms)


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    loss: PointwiseLoss
    reg: Regularization = Regularization()
    norm: NormalizationContext = dataclasses.field(default_factory=no_normalization)

    def with_reg(self, reg: Regularization) -> "GLMObjective":
        return dataclasses.replace(self, reg=reg)

    # -- margins -----------------------------------------------------------

    def margins(self, w: Tensor, batch: Batch) -> Tensor:
        eff = self.norm.effective_coefficients(w)
        return batch.margins(eff) + batch.offset + self.norm.margin_shift(w)

    def _safe_margins(self, w: Tensor, batch: Batch) -> Tensor:
        """Margins with weight-0 rows zeroed, so unbounded losses stay finite
        on padded rows."""
        return torch.where(batch.weight > 0, self.margins(w, batch), 0.0)

    # -- objective value -------------------------------------------------------

    def raw_value(self, w: Tensor, batch: Batch) -> Tensor:
        """Σ wt·l, no regularization; plain PyTorch on either device, as the
        reference computes it outside its kernels."""
        z = self._safe_margins(w, batch)
        return torch.sum(batch.weight * self.loss.loss(z, batch.y))

    def l2_term(self, w: Tensor) -> Tensor:
        return 0.5 * self.reg.l2 * torch.dot(w, w)

    def l1_term(self, w: Tensor) -> Tensor:
        return self.reg.l1 * torch.sum(w.abs())

    def value(self, w: Tensor, batch: Batch) -> Tensor:
        """The smooth objective: the loss sum plus L2 (OWLQN carries L1)."""
        return self.raw_value(w, batch) + self.l2_term(w)

    # -- gradient ------------------------------------------------------------

    def _chain(self, g_raw: Tensor, r_sum: Tensor) -> Tensor:
        """Normalization chain rule: g = factor * (Xᵀr - (Σr)·shift)."""
        g = g_raw
        if self.norm.shifts is not None:
            g = g - r_sum * self.norm.shifts
        if self.norm.factors is not None:
            g = g * self.norm.factors
        return g

    def raw_value_and_grad(self, w: Tensor, batch: Batch
                           ) -> Tuple[Tensor, Tensor, Tensor]:
        """(Σ wt·l, Xᵀr, Σ r) with no regularization or chain rule applied."""
        if isinstance(batch, DenseBatch) and storage_narrowing_ok(batch.x.dtype, w.dtype):
            eff = narrow(self.norm.effective_coefficients(w), batch.x.dtype)
            return fused_value_and_grad(self.loss, eff, batch,
                                        margin_shift=self.norm.margin_shift(w))
        z = self._safe_margins(w, batch)
        l, d1 = self.loss.loss_and_d1(z, batch.y)
        r = batch.weight * d1
        return torch.sum(batch.weight * l), self._xt_dot(batch, r), torch.sum(r)

    @staticmethod
    def _xt_dot(batch: Batch, r: Tensor) -> Tensor:
        """Xᵀr outside the kernels: a sparse scatter-add, or a dense product
        with r rounded to the storage width."""
        if isinstance(batch, SparseBatch):
            return _xt_dot_sparse(batch, r)
        return storage_rmv(r, batch.x)

    def finish_value_and_grad(self, w: Tensor, raw_val: Tensor, g_raw: Tensor,
                              r_sum: Tensor) -> Tuple[Tensor, Tensor]:
        val = raw_val + self.l2_term(w)
        g = self._chain(g_raw, r_sum) + self.reg.l2 * w
        return val, g

    def value_and_grad(self, w: Tensor, batch: Batch) -> Tuple[Tensor, Tensor]:
        return self.finish_value_and_grad(w, *self.raw_value_and_grad(w, batch))

    def gradient(self, w: Tensor, batch: Batch) -> Tensor:
        """The gradient, through ``value_and_grad`` (kernel 1 on the card)."""
        return self.value_and_grad(w, batch)[1]

    # -- Hessian-vector product ------------------------------------------------

    def raw_hvp(self, w: Tensor, batch: Batch, v: Tensor) -> Tuple[Tensor, Tensor]:
        """(Xᵀq, Σ q) raw sums, q = wt·l''(z)·(margin derivative along v)."""
        if isinstance(batch, DenseBatch) and storage_narrowing_ok(batch.x.dtype, w.dtype):
            sd = batch.x.dtype
            return fused_hvp(self.loss, narrow(self.norm.effective_coefficients(w), sd),
                             narrow(self.norm.effective_coefficients(v), sd), batch,
                             margin_shift=self.norm.margin_shift(w),
                             v_shift=self.norm.margin_shift(v))
        z = self._safe_margins(w, batch)
        mv = batch.margins(self.norm.effective_coefficients(v)) + self.norm.margin_shift(v)
        q = batch.weight * self.loss.d2(z, batch.y) * mv
        return self._xt_dot(batch, q), torch.sum(q)

    def finish_hvp(self, v: Tensor, hv_raw: Tensor, q_sum: Tensor) -> Tensor:
        return self._chain(hv_raw, q_sum) + self.reg.l2 * v

    def hvp(self, w: Tensor, batch: Batch, v: Tensor) -> Tensor:
        """H·v = Xnᵀ diag(wt·l'') Xn v + l2·v."""
        return self.finish_hvp(v, *self.raw_hvp(w, batch, v))

    # -- Hessian diagonal / full matrix (variances) ----------------------------

    def _curvature(self, w: Tensor, batch: Batch) -> Tensor:
        """q = wt·l''(z) per row."""
        return batch.weight * self.loss.d2(self._safe_margins(w, batch), batch.y)

    def hessian_diag(self, w: Tensor, batch: Batch) -> Tensor:
        """diag(H)_j = Σ wt·l''·((x_j - s_j)·f_j)² + l2, from the raw sums
        Σ q x_j² and Σ q x_j (x² at the storage width, q rounded to it)."""
        q = self._curvature(w, batch)
        with_shift = self.norm.shifts is not None
        if isinstance(batch, SparseBatch):
            x2 = _xt_dot_sparse(batch.replace(values=batch.values * batch.values), q)
            x1 = _xt_dot_sparse(batch, q) if with_shift else None
        else:
            full_f32_matmul()
            n, d = batch.x.shape
            step = max(1, HESSIAN_DIAG_CHUNK_ELEMS // max(d, 1))
            x2 = torch.zeros(d, dtype=q.dtype, device=q.device)
            x1 = torch.zeros_like(x2) if with_shift else None
            qs = to_storage(q, batch.x.dtype)
            for i in range(0, n, step):
                xc, qc = batch.x[i:i + step], qs[i:i + step]
                x2 += qc @ (xc * xc).to(q.dtype)
                if with_shift:
                    x1 += qc @ xc.to(q.dtype)
        diag = x2
        if with_shift:
            s = self.norm.shifts
            diag = x2 - 2.0 * s * x1 + s * s * q.sum()
        if self.norm.factors is not None:
            diag = diag * self.norm.factors * self.norm.factors
        return diag + self.reg.l2

    def hessian(self, w: Tensor, batch: Batch) -> Tensor:
        """The full d×d Hessian Xnᵀ diag(q) Xn + l2·I; a sparse batch is
        densified (small d only)."""
        dense = batch.to_dense() if isinstance(batch, SparseBatch) else batch
        q = self._curvature(w, dense)
        xn = self.norm.transform_features(dense.x.to(q.dtype))
        full_f32_matmul()
        h = (xn * q[:, None]).T @ xn
        return h + self.reg.l2 * torch.eye(w.shape[-1], dtype=h.dtype, device=h.device)

    # -- predictions -----------------------------------------------------------

    def scores(self, w: Tensor, batch: Batch) -> Tensor:
        """The margins, offsets and shifts included."""
        return self.margins(w, batch)

    def means(self, w: Tensor, batch: Batch) -> Tensor:
        """The inverse link of the margins."""
        return self.loss.mean(self.margins(w, batch))


def lane_margins(x: Tensor, w: Tensor) -> Tensor:
    """[L, cap] raw margins of lanes-first x [L, cap, d] against w [L, d], at
    w's dtype (w rounded to a narrower x's dtype, both widened)."""
    full_f32_matmul()
    return torch.bmm(x.to(w.dtype), to_storage(w, x.dtype).unsqueeze(-1)).squeeze(-1)


def _lane_xt(x: Tensor, r: Tensor) -> Tensor:
    """[L, d] = per-lane r [L, cap] @ x [L, cap, d], at r's dtype (r rounded
    to a narrower x's dtype, both widened)."""
    full_f32_matmul()
    return torch.bmm(to_storage(r, x.dtype).unsqueeze(1), x.to(r.dtype)).squeeze(1)


def lane_dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane dot product of [L, d] tensors."""
    return (a * b).sum(-1)


def lane_norm(a: Tensor) -> Tensor:
    """Per-lane Euclidean norm of an [L, d] tensor."""
    return torch.sqrt(lane_dot(a, a))


@dataclasses.dataclass(frozen=True)
class LaneObjective:
    """One GLM per lane over a bucket held lanes-first: ``batch.x`` is
    [L, cap, d] and ``batch.y``/``offset``/``weight`` are [L, cap]; ``l2`` is
    the per-lane L2 weight [L]; ``norm`` is one context shared by every lane
    ([d] vectors) or per-lane rows ([L, d]: each entity's compact context;
    values, gradients and Hessian-vector products only), with
    ``GLMObjective``'s margin algebra and chain rule.  Values are [L],
    gradients and Hessian-vector products [L, d]."""

    loss: PointwiseLoss
    l2: Tensor
    norm: NormalizationContext = dataclasses.field(default_factory=no_normalization)

    def _margins(self, w: Tensor, batch: Batch) -> Tensor:
        """[L, cap] margins against the raw x, normalization folded in."""
        z = lane_margins(batch.x, self.norm.effective_coefficients(w))
        if self.norm.shifts is not None:
            z = z + self.norm.margin_shift(w)[:, None]
        return z

    def _safe_margins(self, w: Tensor, batch: Batch) -> Tensor:
        z = self._margins(w, batch) + batch.offset
        return torch.where(batch.weight > 0, z, 0.0)

    def _chain(self, g_raw: Tensor, r: Tensor) -> Tensor:
        """factor * (Xᵀr - (Σr)·shift), per lane."""
        g = g_raw
        if self.norm.shifts is not None:
            g = g - r.sum(-1)[:, None] * self.norm.shifts
        if self.norm.factors is not None:
            g = g * self.norm.factors
        return g

    def value_and_grad(self, w: Tensor, batch: DenseBatch) -> Tuple[Tensor, Tensor]:
        z = self._safe_margins(w, batch)
        l, d1 = self.loss.loss_and_d1(z, batch.y)
        r = batch.weight * d1
        val = (batch.weight * l).sum(-1) + 0.5 * self.l2 * lane_dot(w, w)
        return val, self._chain(_lane_xt(batch.x, r), r) + self.l2[:, None] * w

    def hvp(self, w: Tensor, batch: Batch, v: Tensor) -> Tensor:
        z = self._safe_margins(w, batch)
        q = batch.weight * self.loss.d2(z, batch.y) * self._margins(v, batch)
        return self._chain(_lane_xt(batch.x, q), q) + self.l2[:, None] * v

    def hessian_diag(self, w: Tensor, batch: DenseBatch) -> Tensor:
        """[L, d] per-lane diag(H), from the raw sums Σ q x_j² and Σ q x_j as
        ``GLMObjective.hessian_diag`` forms them."""
        q = batch.weight * self.loss.d2(self._safe_margins(w, batch), batch.y)
        diag = _lane_xt(batch.x * batch.x, q)
        if self.norm.shifts is not None:
            s = self.norm.shifts
            diag = diag - 2.0 * s * _lane_xt(batch.x, q) + s * s * q.sum(-1)[:, None]
        if self.norm.factors is not None:
            diag = diag * self.norm.factors * self.norm.factors
        return diag + self.l2[:, None]

    def hessian(self, w: Tensor, batch: DenseBatch) -> Tensor:
        """[L, d, d] per-lane Hessians."""
        q = batch.weight * self.loss.d2(self._safe_margins(w, batch), batch.y)
        xn = self.norm.transform_features(batch.x.to(q.dtype))
        full_f32_matmul()
        h = torch.bmm((xn * q[..., None]).mT, xn)
        eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
        return h + self.l2[:, None, None] * eye


def soa_hessian_diag(loss: PointwiseLoss, w_t: Tensor, x_t: Tensor, y_t: Tensor,
                     off_t: Tensor, wt_t: Tensor, l2: Tensor) -> Tensor:
    """[d, L] per-lane diag(H) of lanes-last buckets (w_t [d, L], x_t
    [cap, d, L], the rest [cap, L], l2 [L]); x² at the storage width and q
    rounded to it, as ``GLMObjective.hessian_diag``."""
    q = wt_t * loss.d2(soa_margins(w_t, x_t, off_t), y_t)
    qs = to_storage(q, x_t.dtype)
    return ((x_t * x_t).to(q.dtype) * qs[:, None, :]).sum(0) + l2


def soa_hessian(loss: PointwiseLoss, w_t: Tensor, x_t: Tensor, y_t: Tensor,
                off_t: Tensor, wt_t: Tensor, l2: Tensor) -> Tensor:
    """[L, d, d] per-lane Hessians of lanes-last buckets, from the Newton
    step's plain Hessian assembly."""
    hh = hessian_soa(loss, w_t, x_t, y_t, off_t, wt_t, l2)
    return torch.stack([torch.stack(row) for row in hh]).permute(2, 0, 1)
