"""Narrow design storage (bf16 / f16) in the PyTorch port against the JAX
package, on the CPU.

The reference's mixed-precision contract: a design held at a narrower float
than the solver; dense products round the coefficients (and, before Xᵀr,
the residual) to the storage width and accumulate at the solver width;
sparse values are widened; kernel 3 widens x and does not round w.  On the
CPU each port wrapper runs its plain version; the JAX side runs its Pallas
kernels in interpret mode, or its plain XLA path (``fused=False``).

Inputs are drawn with numpy from a seed, and every design is made of values
that bf16 (or f16) represents exactly, so both sides hold the same narrow
design however they cast it (``jnp`` / ``ml_dtypes`` and ``torch`` both
round to nearest even).

Tolerances, relative to the largest magnitude of each output:

- float64 accumulation: 1e-12 for objectives and kernels (both sides form
  the same narrow products exactly and differ in summation order only) and
  1e-6 for fits (the solvers amplify that rounding along flat directions).
- float32 accumulation: 1e-5 for one kernel or objective call (sums of
  10^2-10^3 float32 terms in other orders, ~1e-7 apart in practice), and
  F32_FIT_RTOL for fits.  Under narrow storage the margins round w to the
  storage width, so the data term is piecewise constant in w at bf16
  resolution and a float32 solve stops anywhere in a region whose size that
  sets: on the lane path the JAX package's float32 fit lies 2.4e-2 from its
  own float64 fit and the port's 1.9e-2 from its own (the per-user stack),
  and the two float32 fits 2.9e-2 apart.  F32_FIT_RTOL = 5e-2 holds that
  spread; an algebraic fault moves the fits by O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core.batch import DenseBatch as JBatch
from photon_ml_tpu.core.batch import SparseBatch as JSparse
from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.game import FixedEffectConfig as JFixed
from photon_ml_tpu.game import GameData as JData
from photon_ml_tpu.game import GameEstimator as JEstimator
from photon_ml_tpu.game import RandomEffectConfig as JRandom
from photon_ml_tpu.game.config import GameConfig as JConfig
from photon_ml_tpu.game.data import SparseShard as JShard
from photon_ml_tpu.ops import fused_glm as jfused
from photon_ml_tpu.ops import soa_newton as jsoa
from photon_ml_tpu.opt.types import SolverConfig as JSolver
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.core import batch as tbatch
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.core.batch import SparseBatch as TSparse
from photon_ml_tpu_torch.core.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.objective import LaneObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.data import synthetic as tsynth
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig, SparseShard)
from photon_ml_tpu_torch.game import coordinate as tcoord
from photon_ml_tpu_torch.game import estimator as testimator
from photon_ml_tpu_torch.game.config import storage_torch_dtype
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.ops import fused_glm as tfused
from photon_ml_tpu_torch.ops import soa_newton as tsoa
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import OptimizerType, ProjectorType, TaskType

F64_RTOL = 1e-12
F32_RTOL = 1e-5
F64_FIT_RTOL = 1e-6
F32_FIT_RTOL = 5e-2
NARROW = ["bfloat16", "float16"]
NP_NARROW = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16}


def _rel(a, b):
    a = np.asarray(torch.as_tensor(a).double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _exact(a, storage):
    """``a`` (float64) at values the storage dtype represents exactly."""
    return np.asarray(a).astype(NP_NARROW[storage]).astype(np.float64)


def _rows(n, seed, loss="logistic"):
    rng = np.random.default_rng(seed)
    y = (rng.poisson(2.0, size=n).astype(np.float64) if loss == "poisson"
         else (rng.random(n) < 0.5).astype(np.float64))
    wt = rng.uniform(0.5, 2.0, size=n)
    wt[: n // 10] = 0.0
    return y, rng.normal(size=n) * 0.1, wt


def _batches(x, y, off, wt, storage, acc):
    """The same narrow dense batch on both sides, y / offset / weight at acc."""
    np_acc = {torch.float32: np.float32, torch.float64: np.float64}[acc]
    jb = JBatch(x=jnp.asarray(x.astype(np.float32)).astype(getattr(jnp, storage)),
                y=jnp.asarray(y.astype(np_acc)), offset=jnp.asarray(off.astype(np_acc)),
                weight=jnp.asarray(wt.astype(np_acc)))
    tb = TBatch(x=torch.from_numpy(x.astype(np.float32)).to(getattr(torch, storage)),
                y=torch.from_numpy(y).to(acc), offset=torch.from_numpy(off).to(acc),
                weight=torch.from_numpy(wt).to(acc))
    return jb, tb


def _norms(d, seed, acc):
    rng = np.random.default_rng(seed)
    fac, sh = rng.uniform(0.5, 2.0, size=d), rng.normal(size=d) * 0.2
    np_acc = {torch.float32: np.float32, torch.float64: np.float64}[acc]
    return (JNorm(factors=jnp.asarray(fac.astype(np_acc)), shifts=jnp.asarray(sh.astype(np_acc))),
            TNorm(factors=torch.from_numpy(fac).to(acc), shifts=torch.from_numpy(sh).to(acc)))


# -- names and the narrowing rule ---------------------------------------------


def test_storage_dtype_names_and_value_error():
    assert storage_torch_dtype(None) is None
    assert storage_torch_dtype("bfloat16") is torch.bfloat16
    assert storage_torch_dtype("float16") is torch.float16
    assert storage_torch_dtype("float32") is torch.float32
    assert storage_torch_dtype("float64") is torch.float64
    for bad in ("bf16", "int8", "float8", 3):
        with pytest.raises(ValueError, match="unknown storage dtype"):
            storage_torch_dtype(bad)
    with pytest.raises(ValueError, match="unknown storage dtype"):
        FixedEffectConfig(feature_shard="g", storage_dtype="half")
    with pytest.raises(ValueError, match="unknown storage dtype"):
        RandomEffectConfig(random_effect_type="u", feature_shard="u", storage_dtype="bf16")


@pytest.mark.parametrize("x", ["bfloat16", "float16", "float32", "float64"])
@pytest.mark.parametrize("w", ["bfloat16", "float16", "float32", "float64"])
def test_storage_narrowing_ok_matches_jax(x, w):
    assert tfused.storage_narrowing_ok(getattr(torch, x), getattr(torch, w)) == \
        jfused.storage_narrowing_ok(getattr(jnp, x), getattr(jnp, w))


# -- kernels 1 and 2: plain versions ------------------------------------------


@pytest.mark.parametrize("storage", NARROW)
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
@pytest.mark.parametrize("normalized", [False, True])
def test_fused_plain_matches_pallas_interpret(storage, loss, normalized):
    """The plain kernels 1 and 2 at narrow storage and float32 accumulation
    against the JAX kernels in interpret mode (the reference's bf16 parity
    inputs, tests/test_ops.py), the effective coefficients rounded to the
    storage width by both callers."""
    n, d = 96, 16
    rng = np.random.default_rng(7 + normalized)
    x = _exact(rng.normal(size=(n, d)) * 0.3, storage)
    y, off, wt = _rows(n, 8, loss)
    jb, tb = _batches(x, y, off, wt, storage, torch.float32)
    w = (rng.normal(size=d) * 0.2).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    jn, tn = _norms(d, 9, torch.float32) if normalized else (JNorm(None, None),
                                                              TNorm(None, None))
    jw, jv = jnp.asarray(w), jnp.asarray(v)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    sd, tsd = getattr(jnp, storage), getattr(torch, storage)
    jl_, tl_ = jl.loss_by_name(loss), tl.loss_by_name(loss)
    before = tfused.fused_value_and_grad.launches, tfused.fused_hvp.launches
    ref = jfused.fused_value_and_grad(jl_, jn.effective_coefficients(jw).astype(sd), jb,
                                      margin_shift=jn.margin_shift(jw), block_rows=32,
                                      interpret=True)
    got = tfused.fused_value_and_grad(tl_, tn.effective_coefficients(tw).to(tsd), tb,
                                      margin_shift=tn.margin_shift(tw))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and _rel(a, b) <= F32_RTOL
    ref = jfused.fused_hvp(jl_, jn.effective_coefficients(jw).astype(sd),
                           jn.effective_coefficients(jv).astype(sd), jb,
                           margin_shift=jn.margin_shift(jw), v_shift=jn.margin_shift(jv),
                           block_rows=32, interpret=True)
    got = tfused.fused_hvp(tl_, tn.effective_coefficients(tw).to(tsd),
                           tn.effective_coefficients(tv).to(tsd), tb,
                           margin_shift=tn.margin_shift(tw), v_shift=tn.margin_shift(tv))
    for a, b in zip(got, ref):
        assert _rel(a, b) <= F32_RTOL
    assert (tfused.fused_value_and_grad.launches, tfused.fused_hvp.launches) == before


@pytest.mark.parametrize("storage", NARROW)
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("normalized", [False, True])
def test_objective_matches_xla_mixed_path(storage, loss, acc, normalized):
    """GLMObjective over a narrow dense batch (the port routes it to the
    fused wrappers) against the JAX package's XLA mixed path (fused=False):
    value, gradient, Hessian-vector product, Hessian diagonal and full
    Hessian."""
    n, d = 96, 16
    rng = np.random.default_rng(11 + normalized)
    x = _exact(rng.normal(size=(n, d)) * 0.3, storage)
    y, off, wt = _rows(n, 12, loss)
    jb, tb = _batches(x, y, off, wt, storage, acc)
    jn, tn = _norms(d, 13, acc) if normalized else (JNorm(None, None), TNorm(None, None))
    np_acc = np.float64 if acc == torch.float64 else np.float32
    w = (rng.normal(size=d) * 0.2).astype(np_acc)
    v = rng.normal(size=d).astype(np_acc)
    jo = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.05), norm=jn)
    to = TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.05), norm=tn)
    jw, jv, tw, tv = jnp.asarray(w), jnp.asarray(v), torch.from_numpy(w), torch.from_numpy(v)
    tol = F64_RTOL if acc == torch.float64 else F32_RTOL
    jf, jg = jo.value_and_grad(jw, jb)
    tf, tg = to.value_and_grad(tw, tb)
    assert tf.dtype == tg.dtype == acc
    assert _rel(tf, jf) <= tol and _rel(tg, jg) <= tol
    assert _rel(to.hvp(tw, tb, tv), jo.hvp(jw, jb, jv)) <= tol
    assert _rel(to.hessian_diag(tw, tb), jo.hessian_diag(jw, jb)) <= tol
    assert _rel(to.hessian(tw, tb), jo.hessian(jw, jb)) <= tol
    assert _rel(to.margins(tw, tb), jo.margins(jw, jb)) <= tol


@pytest.mark.parametrize("storage", NARROW)
@pytest.mark.parametrize("normalized", [False, True])
def test_sparse_objective_widens_values(storage, normalized):
    """A SparseBatch with narrow values: margins, gradients and
    Hessian-vector products widen the values and round nothing; the Hessian
    diagonal squares them at the storage width."""
    n, dim, k = 120, 30, 5
    rng = np.random.default_rng(21)
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    vals = _exact(rng.normal(size=(n, k)), storage)
    vals[rng.random((n, k)) < 0.2] = 0.0
    y, off, wt = _rows(n, 22)
    jn, tn = _norms(dim, 23, torch.float64) if normalized else (JNorm(None, None),
                                                                 TNorm(None, None))
    jb = JSparse(indices=jnp.asarray(idx), values=jnp.asarray(vals).astype(getattr(jnp, storage)),
                 y=jnp.asarray(y), offset=jnp.asarray(off), weight=jnp.asarray(wt), dim=dim)
    tb = TSparse(indices=torch.from_numpy(idx).long(),
                 values=torch.from_numpy(vals).to(getattr(torch, storage)),
                 y=torch.from_numpy(y), offset=torch.from_numpy(off),
                 weight=torch.from_numpy(wt), dim=dim)
    w, v = rng.normal(size=dim) * 0.3, rng.normal(size=dim)
    jo = JObjective(loss=jl.logistic_loss, reg=JReg(l2=0.3), norm=jn)
    to = TObjective(loss=tl.logistic_loss, reg=TReg(l2=0.3), norm=tn)
    jw, jv, tw, tv = (jnp.asarray(w), jnp.asarray(v), torch.from_numpy(w),
                      torch.from_numpy(v))
    jf, jg = jo.value_and_grad(jw, jb)
    tf, tg = to.value_and_grad(tw, tb)
    assert _rel(tf, jf) <= F64_RTOL and _rel(tg, jg) <= F64_RTOL
    assert _rel(to.hvp(tw, tb, tv), jo.hvp(jw, jb, jv)) <= F64_RTOL
    assert _rel(to.hessian_diag(tw, tb), jo.hessian_diag(jw, jb)) <= F64_RTOL
    assert _rel(to.hessian(tw, tb), jo.hessian(jw, jb)) <= F64_RTOL


@pytest.mark.parametrize("storage", NARROW)
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("normalized", [False, True])
def test_lane_objective_matches_vmapped_glm_objective(storage, acc, normalized):
    """LaneObjective over a narrow lanes-first bucket against jax.vmap of
    the JAX GLMObjective, one lane per entity with its own L2: value,
    gradient, Hessian-vector product, Hessian diagonal and Hessian."""
    num_l, cap, d = 5, 12, 6
    rng = np.random.default_rng(31)
    x = _exact(rng.normal(size=(num_l, cap, d)) * 0.5, storage)
    y = (rng.random((num_l, cap)) < 0.5).astype(np.float64)
    off = rng.normal(size=(num_l, cap)) * 0.1
    wt = rng.uniform(0.5, 1.5, size=(num_l, cap))
    wt[:, -3:] = 0.0
    np_acc = np.float64 if acc == torch.float64 else np.float32
    w = (rng.normal(size=(num_l, d)) * 0.3).astype(np_acc)
    v = rng.normal(size=(num_l, d)).astype(np_acc)
    l2 = rng.uniform(0.5, 2.0, size=num_l).astype(np_acc)
    jn, tn = _norms(d, 32, acc) if normalized else (JNorm(None, None), TNorm(None, None))
    jx = jnp.asarray(x.astype(np.float32)).astype(getattr(jnp, storage))
    cast = lambda a: jnp.asarray(a.astype(np_acc))
    tb = TBatch(x=torch.from_numpy(x.astype(np.float32)).to(getattr(torch, storage)),
                y=torch.from_numpy(y).to(acc), offset=torch.from_numpy(off).to(acc),
                weight=torch.from_numpy(wt).to(acc))
    to = LaneObjective(tl.logistic_loss, torch.from_numpy(l2), tn)

    def per_lane(fn):
        def one(ww, vv, xx, yy, oo, wtt, ll):
            o = JObjective(loss=jl.logistic_loss, reg=JReg(l2=ll), norm=jn)
            return fn(o, ww, vv, JBatch(x=xx, y=yy, offset=oo, weight=wtt))
        return jax.vmap(one)(jnp.asarray(w), jnp.asarray(v), jx, cast(y), cast(off),
                             cast(wt), jnp.asarray(l2))

    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    tol = F64_RTOL if acc == torch.float64 else F32_RTOL
    tf, tg = to.value_and_grad(tw, tb)
    jf, jg = per_lane(lambda o, ww, vv, b: o.value_and_grad(ww, b))
    assert _rel(tf, jf) <= tol and _rel(tg, jg) <= tol
    assert _rel(to.hvp(tw, tb, tv), per_lane(lambda o, ww, vv, b: o.hvp(ww, b, vv))) <= tol
    assert _rel(to.hessian_diag(tw, tb),
                per_lane(lambda o, ww, vv, b: o.hessian_diag(ww, b))) <= tol
    assert _rel(to.hessian(tw, tb), per_lane(lambda o, ww, vv, b: o.hessian(ww, b))) <= tol


def test_wider_storage_takes_the_plain_path(monkeypatch):
    """float64 storage under a float32 solver is no narrowing: the objective
    never reaches the fused wrappers (routing from the dtypes), while a
    narrow batch always does."""
    n, d = 40, 8
    rng = np.random.default_rng(41)
    x = rng.normal(size=(n, d))
    y, off, wt = _rows(n, 42)
    f32 = lambda a: torch.from_numpy(a).float()
    wide = TBatch(x=torch.from_numpy(x), y=f32(y), offset=f32(off), weight=f32(wt))
    narrow = wide.replace(x=wide.x.to(torch.bfloat16))
    to = TObjective(loss=tl.logistic_loss, reg=TReg(l2=0.1))
    w = f32(rng.normal(size=d) * 0.2)
    calls = []
    real = tfused.fused_value_and_grad

    def spy(*a, **k):
        calls.append(a[2].x.dtype)
        return real(*a, **k)

    monkeypatch.setattr("photon_ml_tpu_torch.core.objective.fused_value_and_grad", spy)
    f, g = to.value_and_grad(w, wide)
    assert calls == [] and f.dtype == g.dtype == torch.float32 and torch.isfinite(g).all()
    to.value_and_grad(w, narrow)
    assert calls == [torch.bfloat16]


def test_fused_wrappers_refuse_wider_storage_and_mismatched_coefficients():
    n, d = 16, 8
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.normal(size=(n, d)))
    y, off, wt = (torch.from_numpy(a).float() for a in _rows(n, 44))
    b = TBatch(x=x, y=y, offset=off, weight=wt)  # float64 x, float32 accumulation
    with pytest.raises(ValueError, match="not a narrowing"):
        tfused.fused_value_and_grad(tl.logistic_loss, x[0].clone(), b)
    nb = b.replace(x=x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="uniform dtype"):
        tfused.fused_hvp(tl.logistic_loss, x[0].to(torch.bfloat16), x[0].float(), nb)
    with pytest.raises(ValueError, match="uniform dtype"):
        tfused.fused_value_and_grad(tl.logistic_loss, x[0].to(torch.bfloat16),
                                    nb.replace(offset=off.double()))


# -- kernel 3 ------------------------------------------------------------------


@pytest.mark.parametrize("storage", NARROW)
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
@pytest.mark.parametrize("d", [1, 4, 16])
def test_newton_step_plain_matches_pallas_interpret(storage, acc, loss, d):
    """The plain Newton step with x_t at the storage width against the JAX
    kernel in interpret mode (x widened, w not rounded)."""
    num_l, cap = 128, 16
    rng = np.random.default_rng(d + 3)
    x = _exact(rng.normal(size=(cap, d, num_l)), storage)
    np_acc = np.float64 if acc == torch.float64 else np.float32
    y = (rng.random((cap, num_l)) < 0.5).astype(np_acc)
    off = (rng.normal(size=(cap, num_l)) * 0.1).astype(np_acc)
    wt = (rng.random((cap, num_l)) < 0.9).astype(np_acc)
    w = (rng.normal(size=(d, num_l)) * 0.3).astype(np_acc)
    g = rng.normal(size=(d, num_l)).astype(np_acc)
    l2 = np.ones(num_l, np_acc)
    jx = jnp.asarray(x.astype(np.float32)).astype(getattr(jnp, storage))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, storage))
    ref = jsoa.newton_step(jl.loss_by_name(loss), jnp.asarray(w), jnp.asarray(g), jx,
                           jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt),
                           jnp.asarray(l2), interpret=True)
    before = tsoa.newton_step.launches
    got = tsoa.newton_step(tl.loss_by_name(loss), *(torch.from_numpy(a) for a in (w, g)), tx,
                           *(torch.from_numpy(a) for a in (y, off, wt, l2)))
    assert tsoa.newton_step.launches == before and got.dtype == acc
    assert _rel(got, ref) <= (F64_RTOL if acc == torch.float64 else 1e-4)


def test_newton_step_refuses_wider_x():
    w = torch.zeros((2, 3), dtype=torch.float32)
    args = (torch.zeros((4, 2, 3), dtype=torch.float64), *[torch.zeros((4, 3))] * 3,
            torch.ones(3))
    with pytest.raises(ValueError, match="x_t is torch.float64"):
        tsoa.newton_step(tl.logistic_loss, w, w.clone(), *args)


# -- the launch plan at 2-byte elements ----------------------------------------


def _fits_mixed(d, item, acc, plan):
    """The plan's shared memory is csrc/fused_glm.cu smem_bytes at X's
    element size ``item`` and the accumulation size ``acc``: each stage the
    tile's span behind up to 16 bytes of pad in whole 16-byte pieces, then
    3 rows' worth of y / offset / weight at acc, rounded to 16 bytes; then
    the accumulator, row coefficients and 16 sums at acc; then 8-byte
    mbarriers.  Two or more stages fit, the span fits at every pad."""
    vw = 16 // item
    rows = plan.tile_rows
    x_bytes = -(-(rows * d + vw - 1) // vw) * 16
    stage = -(-(x_bytes + 3 * rows * acc) // 16) * 16
    body = plan.stages * stage + acc * (d + rows + 16)
    assert plan.smem_bytes == -(-body // 8) * 8 + 8 * plan.stages
    assert 2 <= plan.stages <= 8 and plan.smem_bytes <= 227 << 10
    per_sm = -(-plan.blocks // 132)
    assert per_sm * (plan.smem_bytes + 1024) <= 228 << 10
    for pad in range(vw):
        assert (pad + rows * d) * item <= x_bytes


@pytest.mark.parametrize("d", [*range(1, 18), 127, 128, 129, 255, 256, 257, 258, 512,
                               4096, 8192])
@pytest.mark.parametrize("acc", [4, 8])
def test_launch_plan_at_itemsize_two(d, acc):
    """bf16 / f16 X at float32 or float64 accumulation, every row width
    (odd ones too: a bf16 row of 257 is 514 bytes): rows per lane group from
    the accumulation width (the coefficients sit widened in registers),
    tiles of whole waves, ~40 KB of X and y / offset / weight per stage, the
    blocks cover n once, and the shared memory is the kernel's formula.  At
    an equal width the formula is the one-dtype plan's."""
    lanes = tfused.row_lanes(d, acc)
    assert lanes == next((g for g in (8, 16) if d <= g * (24 if acc == 4 else 8)), 32)
    wave = 8 * (32 // lanes)
    tile = tfused.launch_plan(10**6, d, 2, num_sms=132, acc_itemsize=acc).tile_rows
    assert tile % wave == 0 or tile < wave
    assert tile * (2 * d + 3 * acc) <= 40 << 10 or tile == 1
    for n in (1, max(1, tile - 1), tile + 1, 1_000_003, 8_388_608):
        plan = tfused.launch_plan(n, d, 2, num_sms=132, acc_itemsize=acc)
        assert plan.rows_per_block % plan.tile_rows == 0
        assert (plan.blocks - 1) * plan.rows_per_block < n <= plan.blocks * plan.rows_per_block
        _fits_mixed(d, 2, acc, plan)
    same = tfused.launch_plan(524_288, d, 4, num_sms=132)
    assert same == tfused.launch_plan(524_288, d, 4, num_sms=132, acc_itemsize=4)


def test_launch_plan_bf16_stage_holds_twice_the_rows():
    """At glmix_chip's d = 512 a bf16 stage holds twice the rows of an f32
    one (the ring stages bytes)."""
    f32 = tfused.launch_plan(8_388_608, 512, 4, num_sms=132)
    bf16 = tfused.launch_plan(8_388_608, 512, 2, num_sms=132, acc_itemsize=4)
    assert bf16.tile_rows == 2 * f32.tile_rows


# -- helpers of the narrow paths -----------------------------------------------


def test_row_chunked_products_equal_whole(monkeypatch):
    """storage_mv, storage_rmv and the model's widened score give the same
    numbers a row chunk at a time as in one product."""
    rng = np.random.default_rng(51)
    x = torch.from_numpy(_exact(rng.normal(size=(97, 6)), "bfloat16")).to(torch.bfloat16)
    w, r = torch.from_numpy(rng.normal(size=6)), torch.from_numpy(rng.normal(size=97))
    whole = (tbatch.storage_mv(x, w, torch.float64), tbatch.storage_rmv(r, x),
             Coefficients(means=w.numpy()).score(x))
    monkeypatch.setattr(tbatch, "WIDEN_CHUNK_ELEMS", 6 * 10)
    chunked = (tbatch.storage_mv(x, w, torch.float64), tbatch.storage_rmv(r, x),
               Coefficients(means=w.numpy()).score(x))
    for a, b in zip(chunked, whole):
        assert a.dtype == torch.float64 and _rel(a, b) <= F64_RTOL
    xd, wb = x.double(), w.to(torch.bfloat16).double()
    assert _rel(whole[0], xd @ wb) <= F64_RTOL  # w rounded, both widened
    assert _rel(whole[1], r.to(torch.bfloat16).double() @ xd) <= F64_RTOL  # r rounded
    assert _rel(whole[2], xd @ w) <= F64_RTOL  # the model's score rounds nothing


def test_chip_design_narrow_is_the_float32_design_rounded():
    x32 = tsynth.chip_design(3000, "cpu")
    xbf = tsynth.chip_design(3000, "cpu", dtype=torch.bfloat16)
    assert xbf.dtype == torch.bfloat16 and xbf.element_size() == 2
    assert torch.equal(xbf, x32.to(torch.bfloat16))


def test_synth_glmix_storage_rounds_the_designs_once():
    plain = tsynth.synth_glmix(16, three=True)
    narrow = tsynth.synth_glmix(16, three=True, storage="bfloat16")
    for k in ("xg", "xu", "xi"):
        assert narrow[k].dtype == torch.bfloat16
        assert torch.equal(narrow[k], torch.from_numpy(plain[k]).to(torch.bfloat16))
    for k in ("y", "uids", "iids", "logits"):
        np.testing.assert_array_equal(narrow[k], plain[k])


# -- fits through GameEstimator.fit --------------------------------------------


def _game_inputs(path, storage, seed=2024):
    """(JAX data, port data, JAX config, port config, random-effect path) of
    a two-coordinate GAME at narrow storage on both coordinates; every design
    value exact at the storage width.  ``path``: "soa" (4 per-user features,
    cap 32: SoA Newton), "lanes" (20 per-user features: the lane L-BFGS),
    "lanes_tron" (the same under TRON on both coordinates: kernel 2 and the
    lane TRON), "sparse" (sparse fixed and per-user shards: compact lanes)
    or "index_map" (a dense per-user shard under INDEX_MAP)."""
    rng = np.random.default_rng(seed)
    users = 40
    counts = rng.integers(2, 60, size=users)
    uids = rng.permutation(np.repeat(np.arange(users) * 3 + 1, counts))
    n = len(uids)
    y = (rng.random(n) < 0.5).astype(np.float64)
    off, wt = rng.normal(size=n) * 0.05, rng.random(n) + 0.5
    du = 4 if path == "soa" else 20
    if path == "sparse":
        k, dim_g, dim_u = 6, 300, 80
        gi = rng.integers(0, dim_g, size=(n, k)).astype(np.int32)
        gv = _exact(rng.normal(size=(n, k)) * 0.3, storage)
        ui = rng.integers(0, dim_u, size=(n, k)).astype(np.int32)
        uv = _exact(rng.normal(size=(n, k)), storage)
        uv[rng.random((n, k)) < 0.2] = 0.0
        jf = {"g": JShard(indices=gi, values=gv, dim=dim_g),
              "u": JShard(indices=ui, values=uv, dim=dim_u)}
        tf = {"g": SparseShard(indices=gi, values=gv, dim=dim_g),
              "u": SparseShard(indices=ui, values=uv, dim=dim_u)}
    else:
        xg = _exact(rng.normal(size=(n, 64)) * 0.2, storage)
        xu = _exact(rng.normal(size=(n, du)) * (rng.random((n, du)) < 0.5
                                                if path == "index_map" else 1.0), storage)
        if path == "index_map":
            xu[:, 0] = 1.0
        jf = tf = {"g": xg, "u": xu}
    s = dict(max_iters=30, tolerance=1e-7)
    opt = "tron" if path == "lanes_tron" else "lbfgs"
    extra = (dict(projector=ProjectorType.INDEX_MAP, features_to_samples_ratio=0.5,
                  intercept_index=0) if path == "index_map" else {})
    jextra = {k: (JProj(v.value) if k == "projector" else v) for k, v in extra.items()}
    jcfg = JConfig(task=JTask.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": JFixed(feature_shard="g", optimizer=JOpt(opt), solver=JSolver(**s),
                        reg=JReg(l2=1.0), storage_dtype=storage),
        "per-user": JRandom(random_effect_type="userId", feature_shard="u",
                            optimizer=JOpt(opt), solver=JSolver(**s), reg=JReg(l2=1.0),
                            active_cap=32, storage_dtype=storage, **jextra)})
    tcfg = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                      coordinates={
        "fixed": FixedEffectConfig(feature_shard="g", optimizer=OptimizerType(opt),
                                   solver=SolverConfig(**s), reg=TReg(l2=1.0),
                                   storage_dtype=storage),
        "per-user": RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                                       optimizer=OptimizerType(opt),
                                       solver=SolverConfig(**s), reg=TReg(l2=1.0),
                                       active_cap=32, storage_dtype=storage, **extra)})
    common = dict(y=y, offset=off, weight=wt, id_tags={"userId": uids})
    return JData(features=jf, **common), GameData(features=tf, **common), jcfg, tcfg


PATHS = ["soa", "lanes", "lanes_tron", "sparse", "index_map"]


@pytest.mark.parametrize("path", PATHS)
def test_fit_float64_compute_bf16_storage_matches_jax(path, monkeypatch):
    """GameEstimator.fit with float64 compute and bf16 storage on every
    random-effect path against the JAX package's GameEstimator(fused=False):
    coefficients and scores within 1e-6; the designs resident at bf16, the
    published coefficients float64."""
    jdata, tdata, jcfg, tcfg = _game_inputs(path, "bfloat16")
    built = {}
    real = testimator.build_coordinate

    def spy(cid, *a, **k):
        built[cid] = real(cid, *a, **k)
        return built[cid]

    monkeypatch.setattr(testimator, "build_coordinate", spy)
    jm = JEstimator(fused=False, dtype=np.float64).fit(jdata, [jcfg])[0].model
    tm = GameEstimator(device="cpu", dtype=torch.float64).fit(tdata, [tcfg])[0].model
    fixed, user = built["fixed"], built["per-user"]
    fx = fixed._batch.values if path == "sparse" else fixed._batch.x
    assert fx.dtype == torch.bfloat16
    assert all(dev["x"].dtype == torch.bfloat16 and dev["y"].dtype == torch.float64
               for dev in user._dev)
    assert user.use_soa == (path == "soa")
    assert fixed._batch.y.dtype == torch.float64
    assert tm["fixed"].coefficients.means.dtype == np.float64
    assert tm["per-user"].w_stack.dtype == np.float64
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= F64_FIT_RTOL
    assert tm["per-user"].slot_of == jm["per-user"].slot_of
    assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= F64_FIT_RTOL
    assert _rel(tm.score(tdata, device="cpu"), jm.score(jdata)) <= F64_FIT_RTOL


@pytest.mark.parametrize("path", PATHS)
def test_fit_float32_compute_bf16_storage_matches_jax(path):
    """The same fits in float32 against the JAX package's float32 fits,
    within F32_FIT_RTOL, and within the reference's own bf16-vs-float32
    gate (tests/test_game.py) of the port's float32-storage fit."""
    jdata, tdata, jcfg, tcfg = _game_inputs(path, "bfloat16")
    jm = JEstimator(fused=False, dtype=np.float32).fit(jdata, [jcfg])[0].model
    tm = GameEstimator(device="cpu", dtype=torch.float32).fit(tdata, [tcfg])[0].model
    assert tm["fixed"].coefficients.means.dtype == np.float32
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= F32_FIT_RTOL
    assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= F32_FIT_RTOL
    assert _rel(tm.score(tdata, device="cpu"), jm.score(jdata)) <= F32_FIT_RTOL
    wide = dataclasses.replace(tcfg, coordinates={
        k: dataclasses.replace(c, storage_dtype=None) for k, c in tcfg.coordinates.items()})
    t32 = GameEstimator(device="cpu", dtype=torch.float32).fit(tdata, [wide])[0].model
    np.testing.assert_allclose(tm["fixed"].coefficients.means,
                               t32["fixed"].coefficients.means, rtol=0.08, atol=0.08)
    np.testing.assert_allclose(tm["per-user"].w_stack, t32["per-user"].w_stack,
                               rtol=0.15, atol=0.15)


def test_fit_float16_storage_matches_jax():
    """float16 storage through the SoA path, float64 compute."""
    jdata, tdata, jcfg, tcfg = _game_inputs("soa", "float16", seed=7)
    jm = JEstimator(fused=False, dtype=np.float64).fit(jdata, [jcfg])[0].model
    tm = GameEstimator(device="cpu", dtype=torch.float64).fit(tdata, [tcfg])[0].model
    assert _rel(tm["fixed"].coefficients.means, jm["fixed"].coefficients.means) <= F64_FIT_RTOL
    assert _rel(tm["per-user"].w_stack, jm["per-user"].w_stack) <= F64_FIT_RTOL


def test_storage_change_rebuilds_and_rebind_refuses(monkeypatch):
    """A grid whose second point changes only storage_dtype builds each
    coordinate anew (rebind refuses a new storage width), and a third point
    that changes only L2 rebinds the second's narrow coordinates."""
    _, tdata, _, tcfg = _game_inputs("lanes", "bfloat16")
    wide = dataclasses.replace(tcfg, coordinates={
        k: dataclasses.replace(c, storage_dtype=None) for k, c in tcfg.coordinates.items()})
    lam = dataclasses.replace(tcfg, coordinates={
        k: dataclasses.replace(c, reg=TReg(l2=0.5)) for k, c in tcfg.coordinates.items()})
    builds = []
    real = testimator.build_coordinate

    def spy(cid, data, config, *a, **k):
        builds.append((cid, config.storage_dtype))
        return real(cid, data, config, *a, **k)

    monkeypatch.setattr(testimator, "build_coordinate", spy)
    res = GameEstimator(device="cpu", dtype=torch.float64).fit(tdata, [wide, tcfg, lam])
    assert builds == [("fixed", None), ("per-user", None),
                      ("fixed", "bfloat16"), ("per-user", "bfloat16")]
    assert len(res) == 3
    c = tcoord.build_coordinate("fixed", tdata, wide.coordinates["fixed"],
                                TaskType.LOGISTIC_REGRESSION, dtype=torch.float64,
                                device="cpu")
    with pytest.raises(ValueError, match="storage dtype"):
        c.rebind(tcfg.coordinates["fixed"])
    r = tcoord.build_coordinate("per-user", tdata, wide.coordinates["per-user"],
                                TaskType.LOGISTIC_REGRESSION, dtype=torch.float64,
                                device="cpu")
    with pytest.raises(ValueError, match="data configuration"):
        r.rebind(tcfg.coordinates["per-user"])


def test_narrow_device_design_is_kept_without_a_copy():
    """A design tensor already at the storage width is the fixed effect's
    batch itself; a float32 tensor is cast; a host array crosses narrow."""
    _, tdata, _, tcfg = _game_inputs("soa", "bfloat16")
    xg = torch.from_numpy(tdata.features["g"]).to(torch.bfloat16)
    data = dataclasses.replace(tdata, features={"g": xg, "u": tdata.features["u"]})
    cfg = tcfg.coordinates["fixed"]
    c = tcoord.build_coordinate("fixed", data, cfg, TaskType.LOGISTIC_REGRESSION,
                                dtype=torch.float32, device="cpu")
    assert c._batch.x.data_ptr() == xg.data_ptr()
    f32 = dataclasses.replace(data, features={"g": xg.float(), "u": tdata.features["u"]})
    c2 = tcoord.build_coordinate("fixed", f32, cfg, TaskType.LOGISTIC_REGRESSION,
                                 dtype=torch.float32, device="cpu")
    assert c2._batch.x.dtype == torch.bfloat16 and torch.equal(c2._batch.x, xg)
    u = tcoord.build_coordinate("per-user", data, tcfg.coordinates["per-user"],
                                TaskType.LOGISTIC_REGRESSION, dtype=torch.float32,
                                device="cpu")
    assert u._x_full.dtype == torch.float32
    assert all(dev["x"].dtype == torch.bfloat16 for dev in u._dev)
    # a per-user design tensor at the storage width keeps its width for
    # scoring (widened there) and is cast after the bucket gather: the same
    # buckets, model and scores as from the host array, bitwise
    xu = torch.from_numpy(tdata.features["u"]).to(torch.bfloat16)
    ut = tcoord.build_coordinate(
        "per-user", dataclasses.replace(data, features={"g": xg, "u": xu}),
        tcfg.coordinates["per-user"], TaskType.LOGISTIC_REGRESSION,
        dtype=torch.float32, device="cpu")
    assert ut._x_full.dtype == torch.bfloat16
    for a, b in zip(ut._dev, u._dev):
        assert torch.equal(a["x"], b["x"])
    off = torch.zeros(tdata.num_samples)
    mt, m = ut.update(off)[0], u.update(off)[0]
    np.testing.assert_array_equal(mt.w_stack, m.w_stack)
    assert torch.equal(ut.score(mt), u.score(m))


@pytest.mark.parametrize("path", ["soa", "sparse"])
def test_warm_start_locked_and_compact_over_narrow_storage(path):
    """The estimator surface over bf16 designs: a fit warm-started from a
    first fit's model with the fixed effect locked, in float64, against the
    JAX package's fit from the same prior within 1e-6 (the locked fixed
    effect passes through bitwise); the compact twin of the per-user model
    scores as its dense model on a sparse shard."""
    from tests.test_torch_estimator_surface import _to_jax

    jdata, tdata, jcfg, tcfg = _game_inputs(path, "bfloat16", seed=11)
    est = GameEstimator(device="cpu", dtype=torch.float64)
    prior = est.fit(tdata, [tcfg])[0].model
    t = est.fit(tdata, [tcfg], initial_model=prior, locked_coordinates={"fixed"})[0].model
    j = JEstimator(fused=False, dtype=np.float64).fit(
        jdata, [jcfg], initial_model=_to_jax(prior),
        locked_coordinates={"fixed"})[0].model
    np.testing.assert_array_equal(t["fixed"].coefficients.means,
                                  prior["fixed"].coefficients.means)
    assert _rel(t["per-user"].w_stack, j["per-user"].w_stack) <= F64_FIT_RTOL
    assert _rel(t.score(tdata, device="cpu"), j.score(jdata)) <= F64_FIT_RTOL
    compact = t["per-user"].to_compact()
    assert _rel(compact.score(tdata, device="cpu"),
                t["per-user"].score(tdata, device="cpu")) <= F64_RTOL
