#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py            # from the repository root

Phases, each printing its result and wall time on its own line:

1. the device (torch's name, and nvidia-smi's name and power limit);
2. the build of every CUDA kernel from ``photon_ml_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once), with ptxas's registers
   and spill-store bytes for every template instantiation;
3. ``fused_value_and_grad`` and ``fused_hvp`` against their plain PyTorch
   versions on the card: the main paths' shapes (glmix_chip's n = 8,388,608,
   d = 512 and glmix2's n = 524,288, d = 256, float32), d in {1, 3, 100,
   8192} with ragged n and n below one tile, all four losses, weight-0 rows,
   nonzero shifts, float32 and float64, each kernel twice (bitwise equal);
   times of each kernel (CUDA events over back-to-back calls with the shifts
   as 0-d tensors on the card, as ``GLMObjective`` passes them, and its
   device time alone from a ``torch.profiler`` trace, which must show no
   stream sync or host-to-device copy in the wrapper), its plain version and
   a library yardstick (``torch.mv`` / ``torch.mm`` calls, never used by the
   port);
4. ``newton_step`` against its plain version on the card: d in {1, 4, 16},
   cap in {16, 32}, L in {131072, 1000}, logistic / squared / Poisson;
   times and device time as above (yardstick: batched ``torch.linalg.cholesky`` +
   ``torch.cholesky_solve`` on einsum-built Hessians);
5. the main path, glmix_chip at full width: 512 fixed / 4 per-user features,
   active cap 32, 131,072 users x 64 rows (the 17.2 GB float32 design is
   generated on the card): ``GameEstimator(device="cuda").fit`` for two
   outer sweeps of at most 30 solver iterations, ``GameModel.score`` and
   AUC, with both kernels' launch counts (reset just before, read just
   after; each must be > 0) and AUC >= 0.75;
6. the same path at a reduced size on the card and on the CPU (the CPU run
   uses the plain versions), compared within a stated float32 tolerance;
7. glmix2 at full width under TRON on both coordinates (2048 users x 256
   rows, 256 fixed / 16 per-user features; the per-user lanes are outside
   the SoA gate and run the lane-batched TRON): fit, score, AUC against the
   task's Bayes AUC, ``fused_hvp`` launches > 0, and the GAME objective
   against an L-BFGS fit of the same configuration;
8. glmix3 at full width under L-BFGS (262,144 rows, 128 fixed / 16 per-user
   / 16 per-item features, 1,024 items in buckets of ragged capacity):
   fit, score, AUC against the Bayes AUC, ``fused_value_and_grad`` launches;
9. glmix2-TRON at a reduced depth on the card and on the CPU, compared
   within a stated float32 tolerance;
10. ``match_dot`` against its plain version on the card: the compact-scoring
    bench shape (E 20,000, dim 50,000, k_model 16, k_feat 24, n 32,768) and
    n in {1, 1000, 1,048,576} x (k_model, k_feat) in {(1, 1), (16, 24),
    (64, 64), (4096, 1)}, and n in {1000, 131,072} x every lane-group width
    of ``match_plan`` and both sides of its thresholds, with duplicate
    feature ids, zero-valued padded slots, dim-padded model rows and slot -1,
    float32 and float64, the kernel twice (bitwise equal); times (events and
    device time alone) of the kernel, its plain version and the searchsorted
    chain (the reference's route for shapes outside the match-dot gate) at
    n = 32,768 and 1,048,576;
11. sparse1m at full width (131,072 rows, a 1,000,000-column vocabulary, 32
    nonzeros a row, Poisson, TRON): fit time, iterations and the objective
    against the w = 0 objective, a second card fit bitwise equal to the
    first, and the same fit on the CPU compared within a stated float32
    tolerance;
12. glmix_sparse at full width (sparse1m's rows and fixed shard under TRON,
    4,096 users x 32 rows with a 50,000-column per-user shard on compact
    lanes under L-BFGS): fit, ``to_compact``, ``GameModel.score`` through
    ``match_dot`` (launches > 0), AUC against the Bayes AUC, the objective
    below the fixed effect's alone, compact against dense scores, peak
    device memory, and ``match_dot``'s times at this shape;
13. phase 12's fit against the same full-width fit on the CPU (the plain
    match-dot scores there): coefficients, compact-model scores and the
    GAME objective, within stated float32 tolerances;
14. one JSON line describing each kernel, with its launches on each path
    and its device time alone (``device_ms``) beside the event time (``ms``).

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero and prints no result; so does a run without a
CUDA device or without the package beside this script.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)

F32_KERNEL_RTOL = 1e-4  # fused kernels vs plain, float32: both sum
# 10^3..10^7 terms in different orders (the kernel sequentially per block,
# PyTorch pairwise / cuBLAS), ~10^-6 apart in practice
F64_KERNEL_RTOL = 1e-10  # either kernel vs plain in float64: ~10^5 ulps of headroom
NEWTON_F32_FACTOR = 4.0  # newton_step in float32 solves H s = g with cond(H) up
# to ~10^4 (Poisson lanes at d = 16), so any two float32 orderings differ by
# ~eps*cond; the kernel must be within 4x of the plain version's own error
# against a float64 evaluation of the same inputs (floor 1e-5)
F32_PATH_RTOL = 5e-3  # card vs CPU fits, float32: both stop at the working-
# precision plateau of the objective (4 ulps of f); along the flattest
# direction that leaves the coefficients ~1e-3 relative apart
AUC_FLOOR = 0.75  # the task's Bayes AUC is ~0.8
BAYES_MARGIN = 0.03  # glmix2 / glmix3: training AUC >= Bayes AUC - 0.03.  The
# fitted model sees the same 16-feature random effects the labels were drawn
# from (training AUC lands near or above Bayes); a broken solver or residual
# fold falls well below it
F32_OBJECTIVE_RTOL = 1e-4  # glmix2 GAME objective, TRON vs L-BFGS on the card,
# and glmix_sparse's, card vs CPU: both fits minimize the same strictly
# convex coordinate objectives and stop at the float32 plateau (4 ulps of f,
# ~5e-7 relative) or 1e-7; two sweeps of coordinate descent from both leave
# the objectives ~1e-6 apart

COMPACT_F32_RTOL = 1e-5  # match_dot vs plain, float32, relative to the
# largest score: a sample sums at most k_model matched products (64 at the
# largest tested width) in another order, a few ulps of the largest term
COMPACT_VS_DENSE_RTOL = 1e-5  # glmix_sparse per-user scores, compact model
# vs its dense twin (score_samples_sparse): the same 24 products per sample,
# summed in another order
SPARSE1M_OBJ_RTOL = 1e-5  # sparse1m objective, card vs CPU: both stop at
# TRON's 1e-5 gradient tolerance from the same start; Xᵀr adds each column's
# terms in row order on both devices, and only exp and log round differently

MAIN_N, MAIN_D = 8_388_608, 512
MAIN_CAP, MAIN_DU, MAIN_USERS = 32, 4, 131_072
REDUCED_USERS = 4096
GLMIX2_N, GLMIX2_D = 524_288, 256
GLMIX3_N = 262_144
REDUCED_GLMIX2_SCALE = 8  # 2048 users x 32 rows
FUSED_CASES = [(MAIN_N, MAIN_D, "float32"), (GLMIX2_N, GLMIX2_D, "float32"),
               (3_000_001, 1, "float32"),
               (1_000_003, 100, "float32"), (65_537, 8192, "float32"),
               (1_000_003, 1, "float64"), (200_003, 100, "float64"),
               (16_411, 8192, "float64"),
               (7, 256, "float32"),  # n below one tile of rows
               (100_003, 3, "float32")]  # rows not a whole number of 16-byte vectors
NEWTON_LANES = (MAIN_USERS, 1000)
COMPACT_BENCH = dict(num_e=20_000, dim=50_000, k_model=16, k_feat=24)  # bench.py:3296
COMPACT_NS = (1, 1000, 1_048_576)
COMPACT_WIDTHS = ((1, 1), (16, 24), (64, 64), (4096, 1))
# every lane-group width of ops/compact_score.match_plan (8: k_feat 24, 32:
# k_feat 32, 2, 4, 16, and 1 with 1,365 features a lane) and both sides of
# the search-depth step at k_model 32 / 33
COMPACT_EDGE_WIDTHS = ((32, 24), (8, 24), (33, 24), (24, 32), (16, 2), (16, 12),
                       (16, 16), (3, 1365))
COMPACT_EDGE_NS = (1000, 131_072)
COMPACT_TIMED_NS = (32_768, 1_048_576)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    import torch

    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def abs_err(a, b) -> float:
    import torch

    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after a
    warm-up call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps: int, kernels) -> dict:
    """``fn``'s device time alone, from a ``torch.profiler`` trace of
    ``reps`` calls after a warm-up call: the summed CUDA time of every kernel
    whose name contains one of ``kernels``, over ``reps`` (ms).  Also the
    host calls per ``fn`` call that would hold the card back inside a
    wrapper: stream synchronizations and host-to-device copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us, syncs, htod = 0.0, 0, 0
    for e in prof.key_averages():
        if any(k in e.key for k in kernels):
            dev_us += getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total
        if e.key == "cudaStreamSynchronize":
            syncs += e.count
        if "HtoD" in e.key:
            htod += e.count
    if dev_us <= 0:
        raise AssertionError(f"the profiler trace shows no device time for {kernels}")
    return dict(device_ms=dev_us / 1e3 / reps, syncs_per_call=syncs / reps,
                htod_per_call=htod / reps)


class Phase:
    """Prints a phase's wall time; a failure propagates (no result line)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, kind, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f"== phase {self.name}: {'FAILED' if kind else 'ok'} in {dt:.2f} s")
        return False


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {name}; "
        f"devices: {count}; capability {torch.cuda.get_device_capability(0)}")
    log(line)  # the card's name and power limit, as nvidia-smi gives them
    return name, count, line


def ptxas_table(report: str) -> dict:
    """ptxas -v output -> {(kernel, dtype, other template ints): {first
    template int: (registers, spill-store bytes)}}; a kernel templated on
    the type alone has first int None."""
    table: dict = {}
    entries = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                         r"(\d+) bytes spill stores.*\n.*Used (\d+) registers", report)
    for fn, spill, regs in entries:
        m = re.search(r"\d+([a-z_]+_kernel)I([fd])((?:Li\d+E)*)E", fn)
        if m is None:
            raise AssertionError(f"unrecognised kernel symbol {fn}")
        ints = [int(i) for i in re.findall(r"Li(\d+)E", m.group(3))] or [None]
        key = (m.group(1), {"f": "float32", "d": "float64"}[m.group(2)], tuple(ints[1:]))
        table.setdefault(key, {})[ints[0]] = (int(regs), int(spill))
    return table


def phase_build():
    from photon_ml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {sorted(secs) or 'nothing (cached)'} in {time.perf_counter() - t0:.2f} s "
        f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        table = ptxas_table(_build.ptxas_report(name) or "")
        if not table:
            raise AssertionError(f"no ptxas report for {name}")
        for (kernel, dt, rest), by_first in sorted(table.items(), key=str):
            star = ", *" if None not in by_first else ""
            cells = " ".join(f"{r}/{s}" if k is None else f"*={k}: {r}/{s}"
                             for k, (r, s) in sorted(by_first.items(),
                                                     key=lambda kv: kv[0] or 0))
            log(f"ptxas {kernel}<{dt}{star}{''.join(f', {i}' for i in rest)}> "
                f"registers/spill-store bytes: {cells}")


def _glm_batch(n, d, dtype, gen, scale=0.05):
    import torch

    from photon_ml_tpu_torch.core.batch import DenseBatch

    dev = "cuda"
    x = torch.randn((n, d), generator=gen, device=dev, dtype=dtype)
    y = (torch.rand(n, generator=gen, device=dev) < 0.4).to(dtype)
    off = torch.randn(n, generator=gen, device=dev, dtype=dtype) * 0.1
    wt = torch.rand(n, generator=gen, device=dev, dtype=dtype) + 0.5
    wt[::10] = 0.0
    w = torch.randn(d, generator=gen, device=dev, dtype=dtype) * (scale / max(1, d) ** 0.5)
    return w, DenseBatch(x=x, y=y, offset=off, weight=wt)


def _bound(nbytes: float, flops: float):
    """(bound ms, what bounds it) on the H100's HBM rate and FP32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _check_close(label, k, again, p, tol):
    """Each output of a kernel against its plain version, relative to the
    largest magnitude, and against a second call of the kernel on the same
    inputs, bitwise; returns the largest absolute difference."""
    import torch

    errs = [rel_err(a, c) for a, c in zip(k, p)]
    same = all(torch.equal(a, c) for a, c in zip(k, again))
    ok = (all(e <= tol for e in errs) and all(bool(torch.isfinite(t).all()) for t in k)
          and same)
    log(f"{label}: rel err {' '.join(f'{e:.2e}' for e in errs)} (tol {tol:g}), "
        f"{'bitwise repeatable' if same else 'NOT REPEATABLE'} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version or itself")
    return max(abs_err(a, c) for a, c in zip(k, p))


def phase_fused_glm(stats: dict):
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_hvp_plain,
                                                   fused_value_and_grad,
                                                   fused_value_and_grad_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 yardstick and plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    losses = (L.logistic_loss, L.squared_loss, L.poisson_loss, L.smoothed_hinge_loss)
    shift, v_shift = 0.03, -0.02
    cases = [(n, d, getattr(torch, dt)) for n, d, dt in FUSED_CASES]
    worst = {"fused_value_and_grad": 0.0, "fused_hvp": 0.0}
    for n, d, dt in cases:
        w, b = _glm_batch(n, d, dt, gen)
        v = torch.randn(d, generator=gen, device="cuda", dtype=dt) / max(1, d) ** 0.5
        tol = F32_KERNEL_RTOL if dt == torch.float32 else F64_KERNEL_RTOL
        tag = f"n={n} d={d} {str(dt)[6:]}"
        for loss in losses:
            def fvg():
                return fused_value_and_grad(loss, w, b, margin_shift=shift)

            def hvp():
                return fused_hvp(loss, w, v, b, margin_shift=shift, v_shift=v_shift)

            e1 = _check_close(
                f"fused_value_and_grad {tag} {loss.name} (value grad rsum)", fvg(), fvg(),
                fused_value_and_grad_plain(loss, w, b, margin_shift=shift), tol)
            e2 = _check_close(
                f"fused_hvp {tag} {loss.name} (Xtq sum q)", hvp(), hvp(),
                fused_hvp_plain(loss, w, v, b, margin_shift=shift, v_shift=v_shift), tol)
            if loss is L.logistic_loss and (n, d, dt) == (MAIN_N, MAIN_D, torch.float32):
                worst["fused_value_and_grad"] = e1
            if loss is L.logistic_loss and (n, d, dt) == (GLMIX2_N, GLMIX2_D, torch.float32):
                worst["fused_hvp"] = e2
        if dt == torch.float32 and (n, d) in ((MAIN_N, MAIN_D), (GLMIX2_N, GLMIX2_D)):
            _time_fused(stats, n, d, w, v, b, shift, v_shift, gen)
        del w, v, b
        torch.cuda.empty_cache()
    for k, e in worst.items():
        stats.setdefault(k, {})["max_abs_err"] = e


def _time_fused(stats, n, d, w, v, b, shift, v_shift, gen):
    """Kernel, plain and library times of both fused kernels at one main-path
    shape (float32, logistic).  glmix_chip's shape is kernel 1's main path,
    glmix2's is kernel 2's; the other shape is logged beside it.  The shifts
    are 0-d tensors on the card, made once, as ``GLMObjective`` passes them:
    a Python float costs the wrapper a blocking host-to-device copy per call,
    which the event time would count (printed beside it as "float shifts")."""
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_hvp_plain,
                                                   fused_value_and_grad,
                                                   fused_value_and_grad_plain)

    loss = L.logistic_loss
    item = b.x.element_size()
    sh, vsh = (torch.tensor(s, dtype=b.x.dtype, device="cuda") for s in (shift, v_shift))
    r = torch.rand(n, generator=gen, device="cuda", dtype=b.x.dtype)
    wv = torch.stack([w, v], dim=1)
    reps = 10 if n * d > 1 << 28 else 50
    rows = {
        "fused_value_and_grad": dict(
            kernel=lambda: fused_value_and_grad(loss, w, b, sh),
            float_shifts=lambda: fused_value_and_grad(loss, w, b, shift),
            plain=lambda: fused_value_and_grad_plain(loss, w, b, sh),
            library=lambda: (torch.mv(b.x, w), torch.mv(b.x.T, r)),
            library_name="torch.mv x2", names=("fvg_",),
            nbytes=(n * d + 3 * n + d + d + 2) * item, flops=4 * n * d,
            main=(n, d) == (MAIN_N, MAIN_D)),
        "fused_hvp": dict(
            kernel=lambda: fused_hvp(loss, w, v, b, sh, vsh),
            float_shifts=lambda: fused_hvp(loss, w, v, b, shift, v_shift),
            plain=lambda: fused_hvp_plain(loss, w, v, b, sh, vsh),
            library=lambda: (torch.mm(b.x, wv), torch.mv(b.x.T, r)),
            library_name="torch.mm X[w|v] + torch.mv Xtq", names=("hvp_",),
            nbytes=(n * d + 3 * n + 2 * d + d + 1) * item, flops=6 * n * d,
            main=(n, d) == (GLMIX2_N, GLMIX2_D)),
    }
    for name, row in rows.items():
        ms = cuda_ms(row["kernel"], reps)
        float_ms = cuda_ms(row["float_shifts"], reps)
        prof = profiled(row["kernel"], reps, row["names"] + ("reduce_partials",))
        plain_ms = cuda_ms(row["plain"], reps)
        lib_ms = cuda_ms(row["library"], reps)
        bound, by = _bound(row["nbytes"], row["flops"])
        log(f"{name} timing n={n} d={d} float32 logistic: kernel {ms:.4f} ms (events; "
            f"device alone {prof['device_ms']:.4f} ms, {prof['syncs_per_call']:g} stream "
            f"syncs and {prof['htod_per_call']:g} HtoD copies per call; float shifts "
            f"{float_ms:.4f} ms), plain {plain_ms:.4f} ms, library ({row['library_name']}) "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({row['nbytes'] / 1e9:.3f} GB, {by}), "
            f"{bound / prof['device_ms']:.0%} of bound, "
            f"{row['nbytes'] / (prof['device_ms'] * 1e-3) / 1e12:.2f} TB/s")
        if prof["syncs_per_call"] or prof["htod_per_call"]:
            raise AssertionError(f"{name} syncs or copies to the card on the real path")
        if row["main"]:
            stats.setdefault(name, {}).update(ms=ms, device_ms=prof["device_ms"],
                                              plain_ms=plain_ms, library_ms=lib_ms,
                                              bound_ms=bound, bound_by=by)


def _soa_inputs(d, cap, num_l, dtype, gen):
    import torch

    dev = "cuda"
    x = torch.randn((cap, d, num_l), generator=gen, device=dev, dtype=dtype)
    y = (torch.rand((cap, num_l), generator=gen, device=dev) < 0.5).to(dtype)
    off = torch.randn((cap, num_l), generator=gen, device=dev, dtype=dtype) * 0.1
    wt = (torch.rand((cap, num_l), generator=gen, device=dev) < 0.9).to(dtype)
    wt[:, :7] = 0.0  # weightless lanes: H = l2 I
    w = torch.randn((d, num_l), generator=gen, device=dev, dtype=dtype) * 0.3
    g = torch.randn((d, num_l), generator=gen, device=dev, dtype=dtype)
    l2 = torch.ones(num_l, device=dev, dtype=dtype)
    return w, g, x, y, off, wt, l2


def _library_newton(loss, w, g, x, y, off, wt, l2):
    """Yardstick: the same step with einsum Hessians and batched Cholesky."""
    import torch

    z = torch.einsum("cdl,dl->cl", x, w) + off
    q = wt * loss.d2(z, y)
    h = torch.einsum("cil,cjl,cl->lij", x, x, q)
    h = h + torch.diag_embed(l2[:, None].expand(-1, w.shape[0]))
    c = torch.linalg.cholesky(h)
    return torch.cholesky_solve(g.T[:, :, None], c)[:, :, 0].T


def phase_soa_newton(stats: dict):
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.soa_newton import newton_step, newton_step_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = 0.0
    cases = [(d, cap, nl, torch.float32) for d in (1, 4, 16) for cap in (16, 32)
             for nl in NEWTON_LANES]
    cases += [(d, 32, 1000, torch.float64) for d in (1, 4, 16)]
    for d, cap, nl, dt in cases:
        args = _soa_inputs(d, cap, nl, dt, gen)
        for loss in (L.logistic_loss, L.squared_loss, L.poisson_loss):
            k = newton_step(loss, *args)
            p = newton_step_plain(loss, *args)
            torch.cuda.synchronize()
            e = rel_err(k, p)
            if dt == torch.float32:
                ref = newton_step_plain(loss, *[a.double() for a in args])
                e_k, e_p = rel_err(k, ref), rel_err(p, ref)
                tol = max(NEWTON_F32_FACTOR * e_p, 1e-5)
                ok = e_k <= tol
                detail = f"vs float64: kernel {e_k:.2e}, plain {e_p:.2e} (tol {tol:.2e})"
            else:
                ok = e <= F64_KERNEL_RTOL
                detail = f"(tol {F64_KERNEL_RTOL:g})"
            ok = ok and bool(torch.isfinite(k).all())
            log(f"newton_step d={d} cap={cap} L={nl} {str(dt)[6:]} {loss.name}: "
                f"rel err vs plain {e:.2e}, {detail} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"newton_step disagrees at d={d} cap={cap} "
                                     f"L={nl} {dt} {loss.name}")
            if (d, cap, nl, dt) == (MAIN_DU, MAIN_CAP, MAIN_USERS, torch.float32) \
                    and loss is L.logistic_loss:
                worst = abs_err(k, p)
                lib = _library_newton(loss, *args)
                log(f"newton_step library yardstick rel err {rel_err(lib, p):.2e}")
        if (d, cap, nl, dt) == (MAIN_DU, MAIN_CAP, MAIN_USERS, torch.float32):
            loss = L.logistic_loss
            ms = cuda_ms(lambda: newton_step(loss, *args), 20)
            prof = profiled(lambda: newton_step(loss, *args), 20, ("newton_step_kernel",))
            plain_ms = cuda_ms(lambda: newton_step_plain(loss, *args), 5)
            lib_ms = cuda_ms(lambda: _library_newton(loss, *args), 5)
            item = args[0].element_size()
            nbytes = (cap * d * nl + 3 * cap * nl + 3 * d * nl + nl) * item
            flops = nl * (cap * (2 * d + 10 + d + d * (d + 1)) + d ** 3 // 3 + 2 * d * d)
            bound, by = _bound(nbytes, flops)
            log(f"newton_step timing d={d} cap={cap} L={nl} float32 logistic: kernel "
                f"{ms:.4f} ms (events; device alone {prof['device_ms']:.4f} ms, "
                f"{prof['syncs_per_call']:g} stream syncs and {prof['htod_per_call']:g} "
                f"HtoD copies per call), plain {plain_ms:.3f} ms, library (einsum + "
                f"cholesky + cholesky_solve) {lib_ms:.3f} ms, bound {bound:.4f} ms "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP), "
                f"{bound / prof['device_ms']:.0%} of bound")
            if prof["syncs_per_call"] or prof["htod_per_call"]:
                raise AssertionError("newton_step syncs or copies to the card")
            stats["newton_step"] = dict(ms=ms, device_ms=prof["device_ms"],
                                        plain_ms=plain_ms, library_ms=lib_ms,
                                        bound_ms=bound, bound_by=by)
    stats.setdefault("newton_step", {})["max_abs_err"] = worst


def _glmix_config(num_iters=2):
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import TaskType

    s = SolverConfig(max_iters=30, tolerance=1e-7)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(feature_shard="g", solver=s,
                                                     reg=Regularization(l2=1.0)),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              solver=s, reg=Regularization(l2=1.0),
                              active_cap=MAIN_CAP)})


def _baseline_config(three: bool, optimizer):
    """BASELINE glmix2 (three False) / glmix3: L2 1.0 on every coordinate, 30
    solver iterations at tolerance 1e-7, two sweeps (bench.py _glmix_coords),
    every coordinate under ``optimizer``."""
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import TaskType

    s = SolverConfig(max_iters=30, tolerance=1e-7)
    reg = Regularization(l2=1.0)
    coords = {"fixed": FixedEffectConfig(feature_shard="g", optimizer=optimizer,
                                         solver=s, reg=reg),
              "per-user": RandomEffectConfig(random_effect_type="userId",
                                             feature_shard="u", optimizer=optimizer,
                                             solver=s, reg=reg)}
    if three:
        coords["per-item"] = RandomEffectConfig(random_effect_type="itemId",
                                                feature_shard="i", optimizer=optimizer,
                                                solver=s, reg=reg)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                      coordinates=coords)


def _baseline_data(host: dict):
    from photon_ml_tpu_torch.game import GameData

    feats = {"g": host["xg"], "u": host["xu"]}
    tags = {"userId": host["uids"]}
    if "xi" in host:
        feats["i"] = host["xi"]
        tags["itemId"] = host["iids"]
    return GameData(y=host["y"], features=feats, id_tags=tags)


def _fit_and_score(data, device, config):
    import torch

    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.game import GameEstimator

    t0 = time.perf_counter()
    res = GameEstimator(device=device).fit(data, [config])[0]
    if device == "cuda":
        torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = res.model.score(data, device=device)
    y = torch.as_tensor(data.y, device=device).double()
    w = torch.as_tensor(data.weight, device=device).double()
    auc = float(auc_roc(scores + torch.as_tensor(data.offset, device=device), y, w))
    t_score = time.perf_counter() - t0
    return res, scores, auc, t_fit, t_score


def _counted_kernels() -> dict:
    from photon_ml_tpu_torch.ops.compact_score import match_dot
    from photon_ml_tpu_torch.ops.fused_glm import fused_hvp, fused_value_and_grad
    from photon_ml_tpu_torch.ops.soa_newton import newton_step

    return {"fused_value_and_grad": fused_value_and_grad, "fused_hvp": fused_hvp,
            "newton_step": newton_step, "match_dot": match_dot}


def _drive(path: str, data, config, stats: dict, required):
    """One main path on the card: fit -> score -> AUC, with every kernel's
    launch count set to 0 just before and read just after; each kernel in
    ``required`` must have launched, and the scores must be finite."""
    import torch

    kernels = _counted_kernels()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, scores, auc, t_fit, t_score = _fit_and_score(data, "cuda", config)
    launches = {name: k.launches for name, k in kernels.items()}
    upd = ", ".join(f"it{s['iteration']} {s['coordinate']} {s['seconds']:.3f} s"
                    for s in res.history.steps)
    t_upd = sum(s["seconds"] for s in res.history.steps)
    log(f"{path}: fit {t_fit:.2f} s (coordinates built, bucketing included, in "
        f"{t_fit - t_upd:.2f} s; updates {upd}), score + AUC {t_score:.2f} s, "
        f"AUC {auc:.4f}, launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not bool(torch.isfinite(scores).all()) or scores.shape != (data.num_samples,):
        raise AssertionError(f"{path} scores are not finite of shape [n]")
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    for name, v in launches.items():
        stats.setdefault(name, {}).setdefault("launches_by_path", {})[path] = v
    stats[path] = dict(fit_s=t_fit, build_s=t_fit - t_upd, score_s=t_score, auc=auc)
    return res, scores, auc


def phase_main_path(stats: dict):
    import torch

    from photon_ml_tpu_torch.data.synthetic import chip_design, synth_glmix_chip
    from photon_ml_tpu_torch.game import GameData

    t0 = time.perf_counter()
    host = synth_glmix_chip()
    n = host["n"]
    assert (n, host["users"]) == (MAIN_N, MAIN_USERS), (n, host["users"])
    xg = chip_design(n, "cuda")
    torch.cuda.synchronize()
    log(f"glmix_chip data: {n} rows x {xg.shape[1]} fixed + {host['xu'].shape[1]} per-user "
        f"features, {host['users']} users, design {xg.numel() * 4 / 1e9:.1f} GB on the "
        f"card; generated in {time.perf_counter() - t0:.2f} s")
    data = GameData(y=host["y"], features={"g": xg, "u": host["xu"]},
                    id_tags={"userId": host["uids"]})
    _, _, auc = _drive("glmix_chip", data, _glmix_config(), stats,
                       required=("fused_value_and_grad", "newton_step"))
    if auc < AUC_FLOOR:
        raise AssertionError(f"glmix_chip AUC {auc:.4f} < {AUC_FLOOR}")
    return host, xg


def _bayes_auc(host: dict) -> float:
    """The AUC of the generative logits: what the task's label noise allows."""
    import torch

    from photon_ml_tpu_torch.evaluation.metrics import auc_roc

    t = [torch.as_tensor(host[k], device="cuda").double() for k in ("logits", "y")]
    return float(auc_roc(t[0], t[1], torch.ones_like(t[1])))


def _logistic_objective(scores, data, penalties) -> float:
    """Σ wt·logloss(score + offset) plus Σ (l2 / 2)·||coef||² over the
    (l2, coef) pairs of ``penalties``, in float64 on the card."""
    import torch

    from photon_ml_tpu_torch.core.losses import logistic_loss

    z = scores.to("cuda").double() + torch.as_tensor(data.offset, device="cuda")
    y = torch.as_tensor(data.y, device="cuda").double()
    wt = torch.as_tensor(data.weight, device="cuda").double()
    val = float((wt * logistic_loss.loss(z, y)).sum())
    for l2, coef in penalties:
        val += 0.5 * l2 * float(torch.as_tensor(coef, device="cuda").double().square().sum())
    return val


def _game_objective(res, data, config) -> float:
    """The GAME objective of a fitted model: Σ wt·logloss(total score) plus
    each coordinate's (l2 / 2)·||w||², in float64."""
    return _logistic_objective(
        res.model.score(data, device="cuda"), data,
        [(c.reg.l2, res.model[cid].coefficients.means if cid == "fixed"
          else res.model[cid].w_stack) for cid, c in config.coordinates.items()])


def _check_bayes(path: str, auc: float, bayes: float) -> None:
    ok = auc >= bayes - BAYES_MARGIN
    log(f"{path}: training AUC {auc:.4f}, Bayes AUC {bayes:.4f} (gate: >= Bayes - "
        f"{BAYES_MARGIN}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{path} AUC {auc:.4f} < Bayes {bayes:.4f} - {BAYES_MARGIN}")


def phase_glmix2_tron(stats: dict):
    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.types import OptimizerType

    t0 = time.perf_counter()
    host = synth_glmix(1, three=False)
    assert host["xg"].shape == (GLMIX2_N, GLMIX2_D), host["xg"].shape
    data = _baseline_data(host)
    log(f"glmix2 data: {GLMIX2_N} rows x {GLMIX2_D} fixed + 16 per-user features, "
        f"2048 users, generated on the host in {time.perf_counter() - t0:.2f} s")
    cfg = _baseline_config(False, OptimizerType.TRON)
    res, _, auc = _drive("glmix2_tron", data, cfg, stats,
                         required=("fused_value_and_grad", "fused_hvp"))
    _check_bayes("glmix2_tron", auc, _bayes_auc(host))

    f_tron = _game_objective(res, data, cfg)
    lcfg = _baseline_config(False, OptimizerType.LBFGS)
    lres, _, lauc, lt_fit, _ = _fit_and_score(data, "cuda", lcfg)
    f_lbfgs = _game_objective(lres, data, lcfg)
    rel = abs(f_tron - f_lbfgs) / abs(f_lbfgs)
    ok = rel <= F32_OBJECTIVE_RTOL
    log(f"glmix2 GAME objective: TRON {f_tron:.6f}, L-BFGS {f_lbfgs:.6f} (L-BFGS fit "
        f"{lt_fit:.2f} s, AUC {lauc:.4f}); rel diff {rel:.2e} (tol {F32_OBJECTIVE_RTOL:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("glmix2 TRON and L-BFGS objectives disagree")
    stats["glmix2_tron"].update(objective=f_tron, objective_lbfgs=f_lbfgs,
                                lbfgs_fit_s=lt_fit)


def phase_glmix3(stats: dict):
    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.types import OptimizerType

    t0 = time.perf_counter()
    host = synth_glmix(1, three=True)
    assert host["xg"].shape[0] == GLMIX3_N, host["xg"].shape
    data = _baseline_data(host)
    log(f"glmix3 data: {GLMIX3_N} rows x 128 fixed + 16 per-user + 16 per-item "
        f"features, 2048 users, {len(set(host['iids'].tolist()))} items, generated on "
        f"the host in {time.perf_counter() - t0:.2f} s")
    _, _, auc = _drive("glmix3", data, _baseline_config(True, OptimizerType.LBFGS),
                       stats, required=("fused_value_and_grad",))
    _check_bayes("glmix3", auc, _bayes_auc(host))


def _compare_fits(label, data_gpu, data_cpu, config, coords):
    rg, sg, auc_g, tg, _ = _fit_and_score(data_gpu, "cuda", config)
    rc, sc, auc_c, tc, _ = _fit_and_score(data_cpu, "cpu", config)
    errs = {"fixed": rel_err(rg.model["fixed"].coefficients.means,
                             rc.model["fixed"].coefficients.means)}
    for cid in coords:
        if rg.model[cid].slot_of != rc.model[cid].slot_of:
            raise AssertionError(f"{label}: card and CPU {cid} models have different "
                                 "entities")
        errs[cid] = rel_err(rg.model[cid].w_stack, rc.model[cid].w_stack)
    errs["scores"] = rel_err(sg.cpu(), sc)
    ok = max(errs.values()) <= F32_PATH_RTOL and abs(auc_g - auc_c) <= 1e-3
    log(f"card vs CPU, {label}: fit {tg:.2f} s vs {tc:.2f} s; max rel diff "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {F32_PATH_RTOL:g}); AUC {auc_g:.5f} vs {auc_c:.5f} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: card and CPU fits disagree beyond the float32 "
                             "tolerance")


def phase_glmix2_card_vs_cpu():
    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.types import OptimizerType

    data = _baseline_data(synth_glmix(REDUCED_GLMIX2_SCALE, three=False))
    _compare_fits(f"glmix2-TRON at scale {REDUCED_GLMIX2_SCALE} ({data.num_samples} rows)",
                  data, data, _baseline_config(False, OptimizerType.TRON), ["per-user"])


def phase_card_vs_cpu(host, xg):
    from photon_ml_tpu_torch.game import GameData

    m = REDUCED_USERS * host["per_user"]
    # the first REDUCED_USERS users' rows (ids are laid out user by user)
    assert int(host["uids"][m - 1]) == REDUCED_USERS - 1
    parts = dict(y=host["y"][:m], offset=None, weight=None,
                 id_tags={"userId": host["uids"][:m]})
    gpu = GameData(features={"g": xg[:m].contiguous(), "u": host["xu"][:m]}, **parts)
    cpu = GameData(features={"g": xg[:m].cpu(), "u": host["xu"][:m]}, **parts)
    _compare_fits(f"glmix_chip at {REDUCED_USERS} users x {host['per_user']} rows "
                  f"({m} rows)", gpu, cpu, _glmix_config(), ["per-user"])


def _compact_case(num_e, dim, k_model, n, k_feat, dtype, gen, dev="cuda"):
    """match_dot inputs on ``dev``: sorted unique model rows (one id block
    per entry), ragged and padded with ``dim`` (value 0); slots in [-1, E);
    features mostly drawn from their entity's row, with a duplicate id in
    every third row and about 20% zero-valued padded slots."""
    import torch

    block = dim // k_model
    w_idx = (torch.arange(k_model, device=dev) * block)[None, :] + torch.randint(
        0, block, (num_e, k_model), generator=gen, device=dev)
    length = torch.randint(0, k_model + 1, (num_e, 1), generator=gen, device=dev)
    length[::4] = k_model
    pad = torch.arange(k_model, device=dev)[None, :] >= length
    w_idx = torch.where(pad, dim, w_idx).to(torch.int32)
    w_val = torch.randn((num_e, k_model), generator=gen, device=dev, dtype=dtype)
    w_val = torch.where(pad, 0.0, w_val)
    slots = torch.randint(-1, num_e, (n,), generator=gen, device=dev, dtype=torch.int32)
    pick = torch.randint(0, k_model, (n, k_feat), generator=gen, device=dev)
    own = w_idx[slots.clamp(min=0).long()[:, None], pick]
    f_idx = torch.randint(0, dim, (n, k_feat), generator=gen, device=dev, dtype=torch.int32)
    take = (torch.rand((n, k_feat), generator=gen, device=dev) < 0.6) & (own < dim)
    f_idx = torch.where(take, own, f_idx).contiguous()
    if k_feat > 1:
        f_idx[::3, 1] = f_idx[::3, 0]
    f_val = torch.randn((n, k_feat), generator=gen, device=dev, dtype=dtype)
    f_val[torch.rand((n, k_feat), generator=gen, device=dev) < 0.2] = 0.0
    return w_idx, w_val, slots, f_idx, f_val


def _compact_bound(args):
    """(bound ms, what bounds it, bytes, compare-selects) of one match_dot:
    slots, features and output once, and the model row of each entity the
    slots touch, once (many samples share a row, and the [E, k_model] tables
    fit in the 50 MB L2, so a shared row costs HBM traffic once); the
    compare-selects are k_model * k_feat per scored sample."""
    import torch

    w_idx, w_val, slots, f_idx, _ = args
    n, k_feat = f_idx.shape
    k_model = w_idx.shape[1]
    item = w_val.element_size()
    valid = (slots >= 0) & (slots < w_idx.shape[0])
    scored = int(valid.sum())
    touched = int(torch.unique(slots[valid]).numel())
    nbytes = n * 4 + n * k_feat * (4 + item) + n * item + touched * k_model * (4 + item)
    ops = scored * k_model * k_feat
    return (*_bound(nbytes, ops), nbytes, ops)


def _time_match_dot(label, args, reps):
    """Kernel, plain and searchsorted-chain times of match_dot on ``args``."""
    from photon_ml_tpu_torch.models.game import score_compact_sparse_search
    from photon_ml_tpu_torch.ops.compact_score import match_dot, match_dot_plain

    ms = cuda_ms(lambda: match_dot(*args), reps)
    prof = profiled(lambda: match_dot(*args), reps, ("match_dot",))
    plain_ms = cuda_ms(lambda: match_dot_plain(*args), reps)
    lib_ms = cuda_ms(lambda: score_compact_sparse_search(*args), reps)
    bound, by, nbytes, ops = _compact_bound(args)
    log(f"match_dot timing {label}: kernel {ms:.4f} ms (events; device alone "
        f"{prof['device_ms']:.4f} ms, {prof['syncs_per_call']:g} stream syncs and "
        f"{prof['htod_per_call']:g} HtoD copies per call), plain {plain_ms:.4f} ms, "
        f"library (searchsorted chain) {lib_ms:.4f} ms, bound {bound:.4f} ms "
        f"({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M compare-selects, {by}), "
        f"{bound / prof['device_ms']:.0%} of bound, "
        f"{nbytes / (prof['device_ms'] * 1e-3) / 1e12:.3f} TB/s")
    if prof["syncs_per_call"] or prof["htod_per_call"]:
        raise AssertionError("match_dot syncs or copies to the card")
    return dict(ms=ms, device_ms=prof["device_ms"], plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by)


def _check_match_dot(label, args) -> float:
    """match_dot against its plain version on the same inputs; returns the
    largest absolute difference."""
    import torch

    from photon_ml_tpu_torch.ops.compact_score import match_dot, match_dot_plain

    k = match_dot(*args)
    again = match_dot(*args)
    p = match_dot_plain(*args)
    torch.cuda.synchronize()
    tol = COMPACT_F32_RTOL if k.dtype == torch.float32 else F64_KERNEL_RTOL
    e = rel_err(k, p)
    same = torch.equal(k, again)
    no_model = args[2] < 0
    ok = (e <= tol and bool(torch.isfinite(k).all()) and same
          and not bool((k[no_model] != 0).any()))
    log(f"match_dot {label}: rel err vs plain {e:.2e} (tol {tol:g}), "
        f"{'bitwise repeatable' if same else 'NOT REPEATABLE'}, "
        f"{int(no_model.sum())} no-model samples score 0 {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"match_dot disagrees with its plain version or itself at "
                             f"{label}")
    return abs_err(k, p)


def phase_match_dot():
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    b = COMPACT_BENCH
    cases = [(COMPACT_TIMED_NS[0], b["k_model"], b["k_feat"])]
    cases += [(n, km, kf) for n in COMPACT_NS for km, kf in COMPACT_WIDTHS]
    cases += [(n, km, kf) for n in COMPACT_EDGE_NS for km, kf in COMPACT_EDGE_WIDTHS]
    cases += [(n, b["k_model"], b["k_feat"]) for n in COMPACT_TIMED_NS[1:]
              if n not in COMPACT_NS]
    for dt in (torch.float32, torch.float64):
        for n, km, kf in cases:
            args = _compact_case(b["num_e"], b["dim"], km, n, kf, dt, gen)
            tag = f"E={b['num_e']} dim={b['dim']} k_model={km} k_feat={kf} n={n} " \
                  f"{str(dt)[6:]}"
            _check_match_dot(tag, args)
            if dt == torch.float32 and (km, kf) == (b["k_model"], b["k_feat"]) \
                    and n in COMPACT_TIMED_NS:
                _time_match_dot(tag, args, 50 if n < 100_000 else 10)
            del args
    torch.cuda.empty_cache()


def _sparse1m_config():
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    # bench.py run_sparse1m: TRON with its default settings, L2 1.0
    return GameConfig(task=TaskType.POISSON_REGRESSION, num_outer_iterations=1,
                      coordinates={"fixed": FixedEffectConfig(
                          feature_shard="g", optimizer=OptimizerType.TRON,
                          solver=SolverConfig.tron_default(),
                          reg=Regularization(l2=1.0))})


def _poisson_objective(w, host, device) -> float:
    """The sparse1m objective Σ (exp(z) - y z) + (1 / 2)||w||² at ``w``, in
    float64 on ``device``."""
    import torch

    from photon_ml_tpu_torch.core.batch import sparse_batch
    from photon_ml_tpu_torch.core.losses import poisson_loss
    from photon_ml_tpu_torch.core.objective import GLMObjective
    from photon_ml_tpu_torch.core.regularization import Regularization

    b = sparse_batch(host["indices"], host["values"], host["y"], host["dim"],
                     dtype=torch.float64, device=device)
    obj = GLMObjective(loss=poisson_loss, reg=Regularization(l2=1.0))
    return float(obj.value_and_grad(torch.as_tensor(w, device=device).double(), b)[0])


def phase_sparse1m(stats: dict):
    import torch

    from photon_ml_tpu_torch.data.synthetic import synth_sparse1m
    from photon_ml_tpu_torch.game import GameData, GameEstimator, SparseShard

    t0 = time.perf_counter()
    host = synth_sparse1m(1)
    n, k = host["indices"].shape
    data = GameData(y=host["y"], features={"g": SparseShard(
        indices=host["indices"], values=host["values"], dim=host["dim"])})
    log(f"sparse1m data: {n} rows x {k} nonzeros over {host['dim']} columns "
        f"({n * k} nonzeros), generated on the host in {time.perf_counter() - t0:.2f} s")
    kernels = _counted_kernels()
    for kern in kernels.values():
        kern.launches = 0
    cfg = _sparse1m_config()
    fits = {}
    for where, device in (("card", "cuda"), ("card again", "cuda"), ("cpu", "cpu")):
        t0 = time.perf_counter()
        res = GameEstimator(device=device).fit(data, [cfg])[0]
        if where == "card":
            torch.cuda.synchronize()
            launches = {name: kern.launches for name, kern in kernels.items()}
        fits[where] = (res, time.perf_counter() - t0)
    again = fits.pop("card again")[0].model["fixed"].coefficients.means
    w = {k: fits[k][0].model["fixed"].coefficients.means for k in fits}
    repeatable = torch.equal(torch.as_tensor(w["card"]), torch.as_tensor(again))
    obj = {k: _poisson_objective(w[k], host, "cuda") for k in fits}
    obj0 = _poisson_objective(torch.zeros(host["dim"]), host, "cuda")
    it = {k: fits[k][0].history.steps[0]["solver_iterations"] for k in fits}
    scores = fits["card"][0].model.score(data, device="cuda")
    w_err = rel_err(w["card"], w["cpu"])
    o_err = abs(obj["card"] - obj["cpu"]) / abs(obj["cpu"])
    ok = (obj["card"] < obj0 and o_err <= SPARSE1M_OBJ_RTOL and w_err <= F32_PATH_RTOL
          and repeatable and bool(torch.isfinite(scores).all()) and scores.shape == (n,))
    log(f"sparse1m: card fit {fits['card'][1]:.2f} s ({it['card']} TRON iterations), "
        f"objective {obj['card']:.6f} vs {obj0:.6f} at w = 0; CPU fit {fits['cpu'][1]:.2f} s "
        f"({it['cpu']} iterations), objective {obj['cpu']:.6f}; rel diff objective "
        f"{o_err:.2e} (tol {SPARSE1M_OBJ_RTOL:g}), coefficients {w_err:.2e} (tol "
        f"{F32_PATH_RTOL:g}); a second card fit "
        f"{'bitwise equal' if repeatable else 'NOT BITWISE EQUAL'}; launches {launches} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("sparse1m: the card fit is wrong or disagrees with the CPU")
    for name, v in launches.items():
        stats.setdefault(name, {}).setdefault("launches_by_path", {})["sparse1m"] = v
    stats["sparse1m"] = dict(fit_s=fits["card"][1], cpu_fit_s=fits["cpu"][1],
                             iterations=it["card"], objective=obj["card"],
                             objective_w0=obj0)


def _glmix_sparse_config(num_iters=2):
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    reg = Regularization(l2=1.0)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(
                              feature_shard="g", optimizer=OptimizerType.TRON,
                              solver=SolverConfig.tron_default(), reg=reg),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              solver=SolverConfig(max_iters=30, tolerance=1e-7), reg=reg)})


def _glmix_sparse_data(host):
    from photon_ml_tpu_torch.game import GameData, SparseShard

    return GameData(y=host["y"], features={"g": SparseShard(**host["fixed"]),
                                           "u": SparseShard(**host["user"])},
                    id_tags={"userId": host["uids"]})


def phase_glmix_sparse(stats: dict):
    import torch

    from photon_ml_tpu_torch.data.synthetic import synth_glmix_sparse
    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.models.game import GameModel
    from photon_ml_tpu_torch.ops.compact_score import match_dot
    from photon_ml_tpu_torch.parallel.bucketing import bucket_by_entity_sparse

    t0 = time.perf_counter()
    host = synth_glmix_sparse(1)
    data = _glmix_sparse_data(host)
    n = data.num_samples
    log(f"glmix_sparse data: {n} rows, {len(set(host['uids'].tolist()))} users, fixed "
        f"shard {host['fixed']['indices'].shape[1]} of {host['fixed']['dim']} columns, "
        f"per-user shard {host['user']['indices'].shape[1]} of {host['user']['dim']} "
        f"columns; generated on the host in {time.perf_counter() - t0:.2f} s")
    kernels = _counted_kernels()
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = GameEstimator(device="cuda").fit(data, [_glmix_sparse_config()])[0]
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_re = res.model["per-user"]
    compact = dense_re.to_compact()
    t_compact = time.perf_counter() - t0
    model = GameModel(models={"fixed": res.model["fixed"], "per-user": compact})
    fit_launches = {name: kern.launches for name, kern in kernels.items()}
    match_dot.launches = 0  # counted from here: the compact scoring
    t0 = time.perf_counter()
    scores = model.score(data, device="cuda")
    y = torch.as_tensor(data.y, device="cuda").double()
    auc = float(auc_roc(scores, y, torch.ones_like(y)))
    t_score = time.perf_counter() - t0
    launches = dict(fit_launches, match_dot=match_dot.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    upd = ", ".join(f"it{st['iteration']} {st['coordinate']} {st['seconds']:.3f} s "
                    f"({st['solver_iterations']} iterations)" for st in res.history.steps)
    t_upd = sum(st["seconds"] for st in res.history.steps)
    log(f"glmix_sparse: fit {t_fit:.2f} s (coordinates built, bucketing included, in "
        f"{t_fit - t_upd:.2f} s; updates {upd}), to_compact {t_compact:.2f} s (k_model "
        f"{compact.indices.shape[1]}), score + AUC {t_score:.2f} s, AUC {auc:.4f}, launches "
        f"{launches}, peak device memory {peak:.2f} GB")
    if not bool(torch.isfinite(scores).all()) or scores.shape != (n,):
        raise AssertionError("glmix_sparse scores are not finite of shape [n]")
    if launches["match_dot"] <= 0:
        raise AssertionError("kernel match_dot was not launched on the glmix_sparse path")
    bayes = _bayes_auc(host)
    _check_bayes("glmix_sparse", auc, bayes)

    # The training AUC saturates (the 1M-column fixed effect memorizes the
    # rows), so it cannot see a per-user coordinate that learned nothing or
    # compact scores that are wrong.  The per-user update is the last of the
    # sweep and minimizes the objective with the fixed effect held, from a
    # start no worse than w = 0: the objective scored through match_dot must
    # lie below the fixed effect's alone.
    cfg = _glmix_sparse_config()
    l2 = {cid: c.reg.l2 for cid, c in cfg.coordinates.items()}
    w_fixed = res.model["fixed"].coefficients.means
    f_full = _logistic_objective(scores, data, [(l2["fixed"], w_fixed),
                                                (l2["per-user"], compact.values)])
    f_fixed = _logistic_objective(res.model["fixed"].score(data, device="cuda"), data,
                                  [(l2["fixed"], w_fixed)])
    ok = f_full < f_fixed
    log(f"glmix_sparse objective: {f_full:.6f} with the compact per-user model, "
        f"{f_fixed:.6f} with the fixed effect alone {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("glmix_sparse: the per-user model does not lower the objective")

    # the per-user coordinate's host bucketing alone (part of the build time)
    t0 = time.perf_counter()
    u = host["user"]
    buckets, _ = bucket_by_entity_sparse(host["uids"], u["indices"], u["values"], u["dim"],
                                         host["y"])
    t_bucket = time.perf_counter() - t0
    log(f"glmix_sparse: host bucket_by_entity_sparse of {buckets.num_entities} users "
        f"{t_bucket:.3f} s (compact widths {[b.x.shape[2] for b in buckets.buckets]})")

    # compact scores against the dense twin's (score_samples_sparse)
    s_dense = dense_re.score(data, device="cuda")
    s_compact = compact.score(data, device="cuda")
    e = rel_err(s_compact, s_dense)
    ok = e <= COMPACT_VS_DENSE_RTOL
    log(f"glmix_sparse per-user scores, compact vs dense model: rel diff {e:.2e} (tol "
        f"{COMPACT_VS_DENSE_RTOL:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("glmix_sparse compact and dense scores disagree")

    # match_dot at this path's shape: against its plain version, and timed
    w_idx = torch.as_tensor(compact.indices, device="cuda")
    w_val = torch.as_tensor(compact.values, device="cuda")
    slots = torch.as_tensor(compact.slots_for(data), device="cuda")
    f_idx = torch.as_tensor(host["user"]["indices"], device="cuda")
    f_val = torch.as_tensor(host["user"]["values"], device="cuda")
    args = (w_idx, w_val, slots, f_idx, f_val)
    tag = (f"glmix_sparse shape E={w_idx.shape[0]} k_model={w_idx.shape[1]} "
           f"k_feat={f_idx.shape[1]} n={n} float32")
    err = _check_match_dot(tag, args)
    stats.setdefault("match_dot", {}).update(_time_match_dot(tag, args, 50),
                                             max_abs_err=err)
    for name, v in launches.items():
        stats.setdefault(name, {}).setdefault("launches_by_path", {})["glmix_sparse"] = v
    stats["glmix_sparse"] = dict(fit_s=t_fit, build_s=t_fit - t_upd, score_s=t_score,
                                 auc=auc, bayes_auc=bayes, peak_gb=peak,
                                 bucket_s=t_bucket, objective=f_full,
                                 objective_fixed_only=f_fixed)
    return dict(data=data, res=res, scores=scores, auc=auc, objective=f_full)


def phase_glmix_sparse_card_vs_cpu(card: dict):
    """Phase 12's full-width card fit against the same fit on the CPU: the
    fixed and per-user coefficients, the scores of the compact models
    (match_dot on the card, the plain match-dot on the CPU) and the GAME
    objective."""
    import torch

    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.models.game import GameModel

    data, rg = card["data"], card["res"]
    cfg = _glmix_sparse_config()
    t0 = time.perf_counter()
    rc = GameEstimator(device="cpu").fit(data, [cfg])[0]
    t_fit = time.perf_counter() - t0
    compact = rc.model["per-user"].to_compact()
    model = GameModel(models={"fixed": rc.model["fixed"], "per-user": compact})
    scores = model.score(data, device="cpu")
    y = torch.as_tensor(data.y).double()
    auc = float(auc_roc(scores, y, torch.ones_like(y)))
    w_fixed = rc.model["fixed"].coefficients.means
    f_cpu = _logistic_objective(scores, data, [(cfg.coordinates["fixed"].reg.l2, w_fixed),
                                               (cfg.coordinates["per-user"].reg.l2,
                                                compact.values)])
    if rg.model["per-user"].slot_of != rc.model["per-user"].slot_of:
        raise AssertionError("glmix_sparse: card and CPU per-user models have different "
                             "entities")
    errs = {"fixed": rel_err(rg.model["fixed"].coefficients.means, w_fixed),
            "per-user": rel_err(*(torch.as_tensor(m.model["per-user"].w_stack, device="cuda")
                                  for m in (rg, rc))),
            "scores": rel_err(card["scores"].cpu(), scores)}
    o_err = abs(card["objective"] - f_cpu) / abs(f_cpu)
    ok = (max(errs.values()) <= F32_PATH_RTOL and o_err <= F32_OBJECTIVE_RTOL
          and abs(card["auc"] - auc) <= 1e-3)
    log(f"card vs CPU, glmix_sparse at full width ({data.num_samples} rows): CPU fit "
        f"{t_fit:.2f} s; max rel diff " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {F32_PATH_RTOL:g}); objective {card['objective']:.6f} vs {f_cpu:.6f}, "
        f"rel diff {o_err:.2e} (tol {F32_OBJECTIVE_RTOL:g}); AUC {card['auc']:.5f} vs "
        f"{auc:.5f} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("glmix_sparse: card and CPU fits disagree beyond the float32 "
                             "tolerance")


KERNELS = {
    "fused_value_and_grad": dict(
        source="photon_ml_tpu_torch/csrc/fused_glm.cu",
        replaces="photon_ml_tpu/ops/fused_glm.py:139 (_value_grad_kernel; "
                 "pallas_call at :262)"),
    "fused_hvp": dict(
        source="photon_ml_tpu_torch/csrc/fused_glm.cu",
        replaces="photon_ml_tpu/ops/fused_glm.py:166 (_hvp_kernel; "
                 "pallas_call at :320)"),
    "newton_step": dict(
        source="photon_ml_tpu_torch/csrc/soa_newton.cu",
        replaces="photon_ml_tpu/ops/soa_newton.py:79 (_newton_step_kernel; "
                 "pallas_call at :166)"),
    "match_dot": dict(
        source="photon_ml_tpu_torch/csrc/compact_score.cu",
        replaces="photon_ml_tpu/ops/compact_score.py:64 (_match_dot_kernel; "
                 "pallas_call at :109)"),
}


def main() -> int:
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (root / "photon_ml_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: the photon_ml_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    stats: dict = {}
    with Phase("1 device"):
        name, count, _ = phase_device()
    with Phase("2 kernel build"):
        phase_build()
    with Phase("3 fused_value_and_grad and fused_hvp vs plain"):
        phase_fused_glm(stats)
    with Phase("4 newton_step vs plain"):
        phase_soa_newton(stats)
    with Phase("5 main path glmix_chip full width"):
        host, xg = phase_main_path(stats)
    with Phase("6 card vs CPU reduced glmix_chip"):
        phase_card_vs_cpu(host, xg)
    del xg, host
    with Phase("7 main path glmix2 TRON full width"):
        phase_glmix2_tron(stats)
    with Phase("8 main path glmix3 L-BFGS full width"):
        phase_glmix3(stats)
    with Phase("9 card vs CPU reduced glmix2 TRON"):
        phase_glmix2_card_vs_cpu()
    with Phase("10 match_dot vs plain"):
        phase_match_dot()
    with Phase("11 sparse1m full width, card and CPU"):
        phase_sparse1m(stats)
    with Phase("12 glmix_sparse full width"):
        card = phase_glmix_sparse(stats)
    with Phase("13 card vs CPU full-width glmix_sparse"):
        phase_glmix_sparse_card_vs_cpu(card)
    del card
    with Phase("14 kernels"):
        kernels = []
        for kname, meta in KERNELS.items():
            s = stats[kname]
            by_path = s["launches_by_path"]
            kernels.append({"name": kname, "route": "cuda", "source": meta["source"],
                            "replaces": meta["replaces"],
                            "launches": sum(by_path.values()),
                            "launches_by_path": by_path,
                            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                            "device_ms": s["device_ms"],
                            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
        log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.exit(rc)
