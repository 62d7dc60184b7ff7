"""The PyTorch port's kernel modules against the JAX package's kernels.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA kernels
are held against those same plain versions on the card by chip_smoke.py);
the JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do.  Inputs are drawn with numpy from a seed and handed to both.

Tolerance: float64 throughout, rtol 1e-10 (relative to the largest
magnitude of each output).  The two sides sum in different orders (the
Pallas kernel over 32-row blocks into 32 accumulator rows, PyTorch in its
own blocking), so results agree to rounding, not bitwise; 1e-10 leaves
~10^5 ulps for that and still catches any algebraic difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core.batch import DenseBatch as JBatch
from photon_ml_tpu.ops import fused_glm as jfused
from photon_ml_tpu.ops import soa_newton as jsoa
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.ops import fused_glm as tfused
from photon_ml_tpu_torch.ops import soa_newton as tsoa

RTOL = 1e-10
LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, (np.abs(a - b).max(), scale)


def _glm_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * 0.2
    y = (rng.random(n) < 0.4).astype(np.float64)
    off = rng.normal(size=n) * 0.3
    wt = rng.random(n) + 0.5
    wt[::5] = 0.0  # weight-0 rows must stay inert
    x[::5] *= 1e3  # ... even with wild features (poisson exp would overflow)
    w = rng.normal(size=d) * 0.3
    return x, y, off, wt, w


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_value_and_grad_plain_matches_pallas_interpret(d, loss):
    n = 203  # ragged against the 32-row blocks
    x, y, off, wt, w = _glm_inputs(n, d, seed=d)
    shift = 0.125
    jv, jg, jr = jfused.fused_value_and_grad(
        jl.loss_by_name(loss), jnp.asarray(w),
        JBatch(x=jnp.asarray(x), y=jnp.asarray(y), offset=jnp.asarray(off),
               weight=jnp.asarray(wt)),
        margin_shift=shift, block_rows=32, interpret=True)
    before = tfused.fused_value_and_grad.launches
    tv, tg, tr = tfused.fused_value_and_grad(
        tl.loss_by_name(loss), torch.from_numpy(w),
        TBatch(x=torch.from_numpy(x), y=torch.from_numpy(y),
               offset=torch.from_numpy(off), weight=torch.from_numpy(wt)),
        margin_shift=torch.tensor(shift, dtype=torch.float64))
    assert tfused.fused_value_and_grad.launches == before  # CPU: plain version
    assert np.isfinite(tv.item())
    _close(tv, jv)
    _close(tg, jg)
    _close(tr, jr)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("loss", LOSSES)
def test_fused_hvp_plain_matches_pallas_interpret(d, loss):
    n = 203
    x, y, off, wt, w = _glm_inputs(n, d, seed=d + 1)
    v = np.random.default_rng(d).normal(size=d)
    shift, v_shift = 0.125, -0.375
    jh, jq = jfused.fused_hvp(
        jl.loss_by_name(loss), jnp.asarray(w), jnp.asarray(v),
        JBatch(x=jnp.asarray(x), y=jnp.asarray(y), offset=jnp.asarray(off),
               weight=jnp.asarray(wt)),
        margin_shift=shift, v_shift=v_shift, block_rows=32, interpret=True)
    before = tfused.fused_hvp.launches
    th, tq = tfused.fused_hvp(
        tl.loss_by_name(loss), torch.from_numpy(w), torch.from_numpy(v),
        TBatch(x=torch.from_numpy(x), y=torch.from_numpy(y),
               offset=torch.from_numpy(off), weight=torch.from_numpy(wt)),
        margin_shift=torch.tensor(shift, dtype=torch.float64), v_shift=v_shift)
    assert tfused.fused_hvp.launches == before  # CPU: plain version
    assert np.isfinite(th.numpy()).all() and np.isfinite(tq.item())
    _close(th, jh)
    _close(tq, jq)


@pytest.mark.parametrize("loss", LOSSES)
def test_objective_hvp_matches_jax(loss):
    """GLMObjective.hvp (raw_hvp through fused_hvp, then the chain rule and
    L2) against the JAX method, under a normalization context with factors
    and shifts."""
    from photon_ml_tpu.core.normalization import NormalizationContext as JNorm
    from photon_ml_tpu.core.objective import GLMObjective as JObjective
    from photon_ml_tpu.core.regularization import Regularization as JReg
    from photon_ml_tpu_torch.core.normalization import NormalizationContext as TNorm
    from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
    from photon_ml_tpu_torch.core.regularization import Regularization as TReg

    d = 40
    x, y, off, wt, w = _glm_inputs(150, d, seed=3)
    rng = np.random.default_rng(4)
    v = rng.normal(size=d)
    fac, sh = rng.random(d) + 0.5, rng.normal(size=d) * 0.1
    j = JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.3),
                   norm=JNorm(factors=jnp.asarray(fac), shifts=jnp.asarray(sh))).hvp(
        jnp.asarray(w), JBatch(x=jnp.asarray(x), y=jnp.asarray(y),
                               offset=jnp.asarray(off), weight=jnp.asarray(wt)),
        jnp.asarray(v))
    t = TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.3),
                   norm=TNorm(factors=torch.from_numpy(fac), shifts=torch.from_numpy(sh))
                   ).hvp(torch.from_numpy(w),
                         TBatch(x=torch.from_numpy(x), y=torch.from_numpy(y),
                                offset=torch.from_numpy(off), weight=torch.from_numpy(wt)),
                         torch.from_numpy(v))
    _close(t, j)


def test_fused_hvp_rejects_mixed_dtypes():
    x, y, off, wt, w = _glm_inputs(16, 8, seed=0)
    b = TBatch(x=torch.from_numpy(x), y=torch.from_numpy(y),
               offset=torch.from_numpy(off), weight=torch.from_numpy(wt))
    with pytest.raises(ValueError, match="uniform dtype"):
        tfused.fused_hvp(tl.logistic_loss, torch.from_numpy(w),
                         torch.from_numpy(w).float(), b)
    with pytest.raises(ValueError, match="do not match"):
        tfused.fused_hvp(tl.logistic_loss, torch.from_numpy(w),
                         torch.from_numpy(w[:4]), b)


def test_fused_value_and_grad_rejects_mixed_dtypes():
    x, y, off, wt, w = _glm_inputs(16, 8, seed=0)
    b = TBatch(x=torch.from_numpy(x).float(), y=torch.from_numpy(y).float(),
               offset=torch.from_numpy(off).float(), weight=torch.from_numpy(wt).float())
    with pytest.raises(ValueError, match="uniform dtype"):
        tfused.fused_value_and_grad(tl.logistic_loss, torch.from_numpy(w), b)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).T
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_value_and_grad(tl.logistic_loss, torch.from_numpy(w), TBatch(
            x=xt, y=torch.from_numpy(y), offset=torch.from_numpy(off),
            weight=torch.from_numpy(wt)))


def _covered_once(n, plan):
    """Every row lies in exactly one block's contiguous range, each range a
    whole number of tiles (the last one cut at n) and none empty."""
    assert plan.rows_per_block % plan.tile_rows == 0
    assert (plan.blocks - 1) * plan.rows_per_block < n <= plan.blocks * plan.rows_per_block
    starts = np.arange(plan.blocks) * plan.rows_per_block
    ends = np.minimum(starts + plan.rows_per_block, n)
    assert starts[0] == 0 and ends[-1] == n and (starts[1:] == ends[:-1]).all()
    assert (ends > starts).all()


def _fits(d, item, plan):
    """The plan's shared memory is the kernel's formula (csrc/fused_glm.cu
    smem_bytes: the ring of stages, each the tile's rows of X behind up to
    16 bytes of pad plus its rows' y, offset and weight in whole 16-byte
    pieces; the [d] accumulator, the tile's row coefficients and 16 scalar
    sums, then from the next 8-byte boundary an 8-byte mbarrier per stage),
    fits one block's 227 KB with two or more stages, and leaves room for the
    blocks per SM that the grid assumes."""
    vw = 16 // item
    rows = plan.tile_rows
    x_region = -(-(rows * d + vw - 1) // vw) * vw
    stage = -(-(x_region + 3 * rows) // vw) * vw
    body = item * (plan.stages * stage + d + rows + 16)
    assert plan.smem_bytes == -(-body // 8) * 8 + 8 * plan.stages
    assert 2 <= plan.stages <= 8 and plan.smem_bytes <= 227 << 10
    per_sm = -(-plan.blocks // 132)
    assert per_sm * (plan.smem_bytes + 1024) <= 228 << 10
    # the tile's span fits the stage's X region at every misalignment of its start
    for pad in range(vw):
        assert pad + rows * d <= x_region


def test_launch_shape_covers_rows_once():
    for n, d, item in [(8_388_608, 512, 4), (1001, 1, 4), (77, 8192, 8), (5, 100, 4)]:
        plan = tfused.launch_plan(n, d, item, num_sms=132)
        _covered_once(n, plan)
        assert plan.tile_rows * (d + 3) * item <= 40 << 10 or plan.tile_rows == 1
        assert plan.blocks <= 132 * 2


@pytest.mark.parametrize("d", [1, 3, 100, 256, 512, 8192])
@pytest.mark.parametrize("item", [4, 8])
def test_launch_shape_tiles_every_row_once_and_fits_shared_memory(d, item):
    """The fused kernels' plan at n below one tile, ragged n and glmix2's n:
    the blocks' contiguous tile ranges cover every row exactly once, and a
    block's ring fits the H100's 227 KB with at least two stages."""
    for n in (3, 1_000_003, 524_288):
        plan = tfused.launch_plan(n, d, item, num_sms=132)
        _covered_once(n, plan)
        _fits(d, item, plan)


@pytest.mark.parametrize("d", [*range(1, 18), 127, 128, 129, 255, 256, 257, 258, 512,
                               4096, 8192])
@pytest.mark.parametrize("item", [4, 8])
def test_launch_plan_fits_every_row_width(d, item):
    """Every width the kernels take, not only multiples of the 16-byte
    vector: two or more stages fit, a tile is a whole number of waves where
    a wave fits (the rows 8 warps take at once: a row per group of lanes,
    the fewest of 8, 16 or 32 that hold d columns in registers, 24 a lane in
    f32 and 8 in f64, else a whole warp), and the blocks cover n rows once,
    for n below one tile, at one tile + 1 and at a ragged large n."""
    lanes = tfused.row_lanes(d, item)
    per_lane = 24 if item == 4 else 8
    assert lanes == next((g for g in (8, 16) if d <= g * per_lane), 32)
    wave = 8 * (32 // lanes)
    tile = tfused.launch_plan(10**6, d, item, num_sms=132).tile_rows
    assert tile % wave == 0 or tile < wave
    for n in (1, max(1, tile - 1), tile + 1, 1_000_003):
        plan = tfused.launch_plan(n, d, item, num_sms=132)
        _covered_once(n, plan)
        _fits(d, item, plan)


def test_launch_plan_refuses_rows_that_cannot_fit():
    # one float64 row of 16,384 features is 128 KB: two stages of it do not
    # fit beside its accumulator
    with pytest.raises(ValueError, match="does not fit"):
        tfused.launch_plan(100, 16_384, 8, num_sms=132)
    assert tfused.launch_plan(100, 16_384, 4, num_sms=132).stages == 2


def _soa_inputs(d, num_l, cap, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(cap, d, num_l))
    y = (rng.random((cap, num_l)) < 0.5).astype(np.float64)
    off = rng.normal(size=(cap, num_l)) * 0.2
    wt = (rng.random((cap, num_l)) < 0.8).astype(np.float64)
    wt[:, :3] = 0.0  # weightless lanes: H = l2 I
    w = rng.normal(size=(d, num_l)) * 0.3
    g = rng.normal(size=(d, num_l))
    l2 = 0.5 + rng.random(num_l)
    return w, g, x, y, off, wt, l2


@pytest.mark.parametrize("d,num_l,loss", [
    (1, 128, "logistic"), (1, 128, "squared"), (1, 128, "poisson"),
    (4, 256, "logistic"), (4, 256, "squared"), (4, 256, "poisson"),
    (16, 128, "logistic"), (16, 256, "poisson"),
])
def test_newton_step_plain_matches_pallas_interpret(d, num_l, loss):
    args = _soa_inputs(d, num_l, cap=8, seed=d * 1000 + num_l)
    j = jsoa.newton_step(jl.loss_by_name(loss), *[jnp.asarray(a) for a in args],
                         interpret=True)
    before = tsoa.newton_step.launches
    t = tsoa.newton_step(tl.loss_by_name(loss), *[torch.from_numpy(a) for a in args])
    assert tsoa.newton_step.launches == before  # CPU: plain version
    assert t.shape == (d, num_l)
    _close(t, j)


def test_newton_step_rejects_bad_shapes():
    w, g, x, y, off, wt, l2 = [torch.from_numpy(a) for a in _soa_inputs(4, 8, 4, 0)]
    with pytest.raises(ValueError, match="x_t"):
        tsoa.newton_step(tl.logistic_loss, w, g, x[:, :3], y, off, wt, l2)
    # the kernel reads lanes-last contiguous storage; the CPU path holds the
    # callers to the same layout
    with pytest.raises(ValueError, match="off_t must be contiguous"):
        tsoa.newton_step(tl.logistic_loss, w, g, x, y, off.T.contiguous().T, wt, l2)
