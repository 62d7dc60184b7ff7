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
   d = 512 and glmix2's n = 524,288, d = 256, float32), d in {1, 100, 8192}
   with ragged n, all four losses, weight-0 rows, nonzero shifts, float32
   and float64; times of each kernel, its plain version and a library
   yardstick (``torch.mv`` / ``torch.mm`` calls, never used by the port);
4. ``newton_step`` against its plain version on the card: d in {1, 4, 16},
   cap in {16, 32}, L in {131072, 1000}, logistic / squared / Poisson;
   times as above (yardstick: batched ``torch.linalg.cholesky`` +
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
10. one JSON line describing each kernel, with its launches on each path.

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
F32_OBJECTIVE_RTOL = 1e-4  # glmix2 GAME objective, TRON vs L-BFGS on the card:
# both minimize the same strictly convex coordinate objectives and stop at
# the float32 plateau (4 ulps of f, ~5e-7 relative) or 1e-7; two sweeps of
# coordinate descent from both leave the objectives ~1e-6 apart

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
               (16_411, 8192, "float64")]
NEWTON_LANES = (MAIN_USERS, 1000)


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


def _check_close(label, k, p, tol):
    """Each output of a kernel against its plain version, relative to the
    largest magnitude; returns the largest absolute difference."""
    import torch

    errs = [rel_err(a, c) for a, c in zip(k, p)]
    ok = all(e <= tol for e in errs) and all(bool(torch.isfinite(t).all()) for t in k)
    log(f"{label}: rel err {' '.join(f'{e:.2e}' for e in errs)} (tol {tol:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
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
            e1 = _check_close(
                f"fused_value_and_grad {tag} {loss.name} (value grad rsum)",
                fused_value_and_grad(loss, w, b, margin_shift=shift),
                fused_value_and_grad_plain(loss, w, b, margin_shift=shift), tol)
            e2 = _check_close(
                f"fused_hvp {tag} {loss.name} (Xtq sum q)",
                fused_hvp(loss, w, v, b, margin_shift=shift, v_shift=v_shift),
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
    glmix2's is kernel 2's; the other shape is logged beside it."""
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_hvp_plain,
                                                   fused_value_and_grad,
                                                   fused_value_and_grad_plain)

    loss = L.logistic_loss
    item = b.x.element_size()
    r = torch.rand(n, generator=gen, device="cuda", dtype=b.x.dtype)
    wv = torch.stack([w, v], dim=1)
    reps = 10 if n * d > 1 << 28 else 50
    rows = {
        "fused_value_and_grad": dict(
            kernel=lambda: fused_value_and_grad(loss, w, b, shift),
            plain=lambda: fused_value_and_grad_plain(loss, w, b, shift),
            library=lambda: (torch.mv(b.x, w), torch.mv(b.x.T, r)),
            library_name="torch.mv x2",
            nbytes=(n * d + 3 * n + d + d + 2) * item, flops=4 * n * d,
            main=(n, d) == (MAIN_N, MAIN_D)),
        "fused_hvp": dict(
            kernel=lambda: fused_hvp(loss, w, v, b, shift, v_shift),
            plain=lambda: fused_hvp_plain(loss, w, v, b, shift, v_shift),
            library=lambda: (torch.mm(b.x, wv), torch.mv(b.x.T, r)),
            library_name="torch.mm X[w|v] + torch.mv Xtq",
            nbytes=(n * d + 3 * n + 2 * d + d + 1) * item, flops=6 * n * d,
            main=(n, d) == (GLMIX2_N, GLMIX2_D)),
    }
    for name, row in rows.items():
        ms = cuda_ms(row["kernel"], reps)
        plain_ms = cuda_ms(row["plain"], reps)
        lib_ms = cuda_ms(row["library"], reps)
        bound, by = _bound(row["nbytes"], row["flops"])
        log(f"{name} timing n={n} d={d} float32 logistic: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library ({row['library_name']}) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({row['nbytes'] / 1e9:.3f} GB, {by}), "
            f"{row['nbytes'] / (ms * 1e-3) / 1e12:.2f} TB/s")
        if row["main"]:
            stats.setdefault(name, {}).update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
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
            plain_ms = cuda_ms(lambda: newton_step_plain(loss, *args), 5)
            lib_ms = cuda_ms(lambda: _library_newton(loss, *args), 5)
            item = args[0].element_size()
            nbytes = (cap * d * nl + 3 * cap * nl + 3 * d * nl + nl) * item
            flops = nl * (cap * (2 * d + 10 + d + d * (d + 1)) + d ** 3 // 3 + 2 * d * d)
            bound, by = _bound(nbytes, flops)
            log(f"newton_step timing d={d} cap={cap} L={nl} float32 logistic: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.3f} ms, library (einsum + cholesky + "
                f"cholesky_solve) {lib_ms:.3f} ms, bound {bound:.4f} ms "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP)")
            stats["newton_step"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
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
    from photon_ml_tpu_torch.ops.fused_glm import fused_hvp, fused_value_and_grad
    from photon_ml_tpu_torch.ops.soa_newton import newton_step

    return {"fused_value_and_grad": fused_value_and_grad, "fused_hvp": fused_hvp,
            "newton_step": newton_step}


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


def _game_objective(res, data, config) -> float:
    """The GAME objective of a fitted model: Σ wt·logloss(total score) plus
    each coordinate's (l2 / 2)·||w||², in float64."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.core.losses import logistic_loss

    z = res.model.score(data, device="cuda") + torch.as_tensor(data.offset, device="cuda")
    y = torch.as_tensor(data.y, device="cuda").double()
    wt = torch.as_tensor(data.weight, device="cuda").double()
    val = float((wt * logistic_loss.loss(z, y)).sum())
    for cid, c in config.coordinates.items():
        m = res.model[cid]
        coef = m.coefficients.means if cid == "fixed" else m.w_stack
        val += 0.5 * c.reg.l2 * float(np.sum(np.asarray(coef, np.float64) ** 2))
    return val


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
    with Phase("10 kernels"):
        kernels = []
        for kname, meta in KERNELS.items():
            s = stats[kname]
            by_path = s["launches_by_path"]
            kernels.append({"name": kname, "route": "cuda", "source": meta["source"],
                            "replaces": meta["replaces"],
                            "launches": sum(by_path.values()),
                            "launches_by_path": by_path,
                            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
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
