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
   d = 512, glmix2's n = 524,288, d = 256, glmix2-norm-var's d = 257 and
   glmix3's n = 262,144, d = 128, float32, timed too), d in {1, 2, 3, 5,
   100, 127, 129, 8192} with ragged n, X not 16-byte aligned (rows 1.. of
   a contiguous tensor, odd d), n below one tile and n = one tile + 1, all
   four losses, weight-0 rows, nonzero shifts, float32 and float64, each
   kernel twice (bitwise equal), each case's launch plan logged (tile rows,
   stages, blocks, shared memory); times of each kernel after 0.3 s of
   calls at the shape (CUDA events over back-to-back calls with the shifts
   as 0-d tensors on the card, as ``GLMObjective`` passes them, and its
   device time alone, and the partials' reduction's, from a
   ``torch.profiler`` trace, which must show no stream sync or
   host-to-device copy in the wrapper), its plain version and a library
   yardstick (``torch.mv`` / ``torch.mm`` calls, never used by the port);
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
   uses the plain versions), compared within a stated float32 tolerance, and
   the last three points of phase 19's grid (rebound coordinates, the fixed
   effect down-sampled from the same host draws) likewise;
19. (run after phase 6, on phase 5's data) glmix_chip-grid at full width:
    one ``GameEstimator.fit`` over five configurations, fixed and per-user
    L2 in descending order and then the fixed effect down-sampled at 0.5,
    on the first 56 rows of every user; the last 8 of every user (1,048,576
    rows, gathered on the card) are the validation data (auc,
    logistic_loss and the per-user AUC ``auc:userId`` over 131,072 groups),
    so they read both coordinates; each
    coordinate built once for the whole grid (a wrapper around the
    estimator's ``build_coordinate`` counts), later points rebound; per
    point its construction and fit time, solver iterations, kernels 1 and 3
    launches (> 0), training AUC against the Bayes AUC, held-out metrics and
    what its grouped evaluations cost;
    ``GameEstimator.best`` at the argmax of the held-out AUCs; the last point
    refit from the same warm start on freshly built coordinates, bitwise
    equal to the rebound fit;
20. glmix_chip-reg-path at full width: ``train_glm_reg_path`` over phase
    19's training rows of the fixed design on the card at four L2 weights, per
    weight its time, iterations and kernel-1 launches (> 0) and its float64
    gradient norm at the solution against the norm at w = 0;
    ``select_best_glm`` on the held-out rows at the argmax of their AUCs;
22. (after phase 20) every evaluator on the card: phase 19's ``best`` model
    and held-out rows through ``GameTransformer.evaluate`` with auc, aupr,
    rmse, the four losses, precision@1000 and the per-user auc, aupr and
    precision@4: auc, logistic_loss and auc:userId bitwise equal to
    ``best.evaluation``'s, ``score`` / ``predict`` equal to the model's,
    every metric within 1e-9 of a float64 host recomputation by other means
    (Mann-Whitney ranks, numpy sorts, closed-form losses, pairwise per-user
    AUC), and each metric's time (CUDA events), the grouped ones with and
    without the padded layout's build;
23. (after phase 22) glmix_chip-retrain at full width, the daily partial
    retrain: (a) phase 19's held-out rows as the day's data (users whose id
    % 8 == 1 keep 4 of their 8 rows, under a per-user lower bound of 8),
    fitted by ``best.config`` warm-started from ``best.model`` without the
    users whose id % 16 == 1 and with the fixed effect locked: the fixed
    effect bitwise the prior's with no kernel-1 launch in the fit, kernel 3
    launched, the 8,192 under-bound users the prior covers without a lane
    and bitwise the prior's, the 8,192 new ones trained, 122,880 lanes; (b)
    the grid's first three points on phase 19's rows with a checkpoint hook
    (12 saves: the reference's cursors, ``updated`` None on each
    configuration's first save, ``best`` None before its first complete
    sweep), then a resume from the save after point 1's third update: 2
    results, at least the checkpointed best, kernels 1 and 3 launched, and
    every save and result within 3x the spread of a resume from the same
    checkpoint nudged by one float32 ulp; (c) both at 4,096 users, card
    against CPU within F32_PATH_RTOL;
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
21. glmix_sparse held out: phase 12's rows split inside each user (the last
    8 of its 32, in order of appearance, validate: 32,768 rows), fitted with
    validation (auc, auc:userId, logistic_loss), compacted, and the held-out
    rows evaluated through ``GameTransformer`` (``match_dot`` launches > 0):
    the held-out AUC at least the fixed effect's alone + 0.01 and at most
    the held-out Bayes AUC + 0.005, the compact model's within 1e-6 of its
    dense twin's; training AUC, fit and scoring times logged;
15. glmix2-norm-var at full width: glmix2's rows with an intercept column
    (257 fixed features), the fixed shard under STANDARDIZATION (nonzero
    margin shifts through both fused kernels) with SIMPLE variances, the
    per-user shard under SCALE_WITH_STANDARD_DEVIATION (a shared context:
    lane TRON) with FULL variances; TRON on both; feature stats on the card;
    ``fused_value_and_grad`` and ``fused_hvp`` launches > 0, AUC against the
    Bayes AUC, the fixed SIMPLE variances against a float64 recomputation
    from the raw design, the per-user FULL variances finite, positive and,
    for 16 seeded users, against float64 inverse Hessians; the fit time and
    what variances add to it;
16. card against CPU with normalization and variances, within the float32
    path tolerance: (a) phase 15's configuration at scale 8; (b) sparse1m at
    full width under SCALE_WITH_MAX_MAGNITUDE from its sparse stats, SIMPLE
    variances (objectives within 1e-5, a second card fit bitwise equal);
    (c) glmix_chip at 4,096 users with SIMPLE variances on both coordinates
    (the per-user one on the SoA path, ``newton_step`` launches > 0); (d)
    glmix_sparse at full width with SIMPLE variances on the compact per-user
    coordinate (``to_compact`` must refuse the model; scores through the
    dense model);
17. glmix_sparse-norm-en at full width: glmix_sparse with an intercept
    column in the per-user shard, which is standardized from its sparse
    stats (per-lane factor and shift rows on the compact lanes) and solved
    under elastic net (the lane OWLQN, L1 chosen by CPU fits at scale 8):
    fit, ``to_compact`` and ``GameModel.score`` through ``match_dot``
    (launches > 0), the objective with its L1 term below the fixed effect's
    alone, the share of zero coefficients, the float64 pseudo-gradient
    recomputed from the raw rows, the fold's size, the compact scores
    against the dense model's and ``match_dot`` against its plain version
    on this model's inputs, and the same fit on the CPU (objective;
    coefficients within a multiple of the CPU fit's own spread under
    one-ulp nudges of the data; zero-set disagreements); (b) the per-lane
    fold where the shifts are large: glmix2's per-user shard shifted, with
    an intercept and unobserved columns per user, under INDEX_MAP and
    STANDARDIZATION at scale 8, card against CPU within 3x the CPU fit's own
    spread under one-ulp nudges of the per-user values (F32_PATH_RTOL where
    larger), where a publish without the fold must fail the comparison by
    more than its per-user tolerance;
18. glmix2-en-box at full width: glmix2-norm-var's data and contexts, the
    fixed effect under elastic net (OWLQN as one lane over
    ``fused_value_and_grad`` with shifts, launches > 0; L1 chosen by CPU
    fits at scale 8), the per-user coefficients of features 0-7 bounded to
    [0, inf) (the box-constrained lane L-BFGS): AUC against the Bayes AUC,
    the bounds held and binding, the float64 pseudo- and projected-gradient
    norms, and the same configuration at scale 8 on the card and the CPU;
24. after phase 18, narrow design storage (``storage_dtype="bfloat16"`` on
    both coordinates): (a) glmix_chip-bf16 at full width, the design
    generated at bf16 on the card (8.59 GB, 2 bytes an element), the peak
    allocation from generation to the end of the fit below the float32
    design's 17.2 GB, AUC >= 0.75, kernels 1 and 3 launched, and the
    reference's bf16-vs-float32 gate against phase 5's fit (fixed
    coefficients allclose at 0.08, per-user at 0.15, |dAUC| <= 5e-3); (b)
    glmix2-TRON-bf16 at full width (kernels 1 and 2, the lane TRON over a
    narrow ``LaneObjective``), AUC against Bayes and the same gate against
    phase 7's fit; (c) both at a reduced size on the card and the CPU from
    the same bf16 inputs, within F32_PATH_RTOL or 3x the CPU fit's own
    spread under one-ulp nudges of the row weights; (d, e) the bf16 / f16
    instantiations of kernels 1 and 2 (glmix_chip's and glmix2's shapes,
    d = 257, odd rows, an unaligned X, n below a tile and one tile + 1,
    float64 accumulation) against their plain versions, twice bitwise, and
    of kernel 3 (x_t at bf16 / f16) within phase 4's gate, each main-path
    shape timed as phases 3 and 4 time theirs;
25. after phase 24, host syncs and the device's idle share per fit, on
    glmix_chip, glmix2-TRON, glmix3 and glmix_sparse at full width, each
    built as in phases 5, 7, 8 and 12 and fitted three times: timed; under
    ``torch.cuda.set_sync_debug_mode("warn")`` with every warning recorded
    (each sync names the Python line that made the card wait: the count a
    fit, split into construction and each coordinate update, per solver
    loop trip, and the top sites by file:line); and under ``torch.profiler``
    (the idle share, 1 - the union of the device's
    kernel, memcpy and memset intervals over the wall time, of the fit and
    of its updates, these between two ``torch.cuda._sleep`` marks on the
    card's clock; the same busy time also over the timed fit's untraced
    wall times; a trace short of records, by each kernel's device records
    against its launch counter or by the host's kernel launch calls against
    the device's kernel records, marks included, makes the shares upper
    bounds).  On glmix3 six more fits time the solvers' state tracking,
    off, on, on, off, off, on.
    Every ``torch.profiler`` trace of the script runs 0.5 s before its first
    call and after its last, since late in a run traces lost the records of
    whole runs of calls.
    Gates: the counted fit bitwise the timed one (or within the spread of
    the timed and profiled fits), and the untracked fits too, syncs > 0,
    none in the state tracker's lines, ``num_states == iterations + 1`` on
    every tracked valid lane and scalar solve, and each coordinate's
    ``tracker_summary`` counting its solves.  The solvers' loops (each
    module's ``while_loop``, wrapped for the counted fit) are counted by
    the line that runs them: each update sync whose innermost frame is in
    ``opt/`` must be ``opt/loop.while_loop``'s read, each loop must read
    once a trip and once where it ends (the syncs per trip of every loop
    level are printed), and no update may upload through
    ``game/coordinate._as_device``; the update syncs of the four cells are
    printed against the 1,552 before the solvers' loop form;
26. after phase 25, the fused sweep (``game/fused.FusedSweep``, the
    default ``GameEstimator()`` path for fits without per-update host
    work): glmix_chip, glmix2-TRON, glmix3, glmix_sparse and
    glmix2-norm-var at full width, each cell's coordinates built once and
    run through the host loop (``CoordinateDescent.run``) and
    ``FusedSweep.run``.  Gates: coefficients, variances and final scores
    bitwise the host loop's; kernels 1, 2 and 3 launched as often; the
    fused run's host syncs (counted as phase 25 counts them) fewer than
    the host loop's and than the loop form's update syncs
    (LOOP_FORM_UPDATE_SYNCS), each a solver loop's read at
    ``opt/loop.while_loop`` but the one export in ``game/fused.py``.
    Reported: graphs captured by each run, the descents' untraced seconds
    (the median of five each, interleaved), and the card's idle share over
    them: 1 - the device's busy time in one traced descent each (the union
    of its kernel, memcpy and memset records) over the untraced median.  Then glmix_chip-grid's five
    points through ``GameEstimator()``: every point fused and bitwise the
    host loop's, one sweep per sweep key (the down-sampled point is a key
    of its own, as in the reference), no graph captured after the first
    point.  Phases whose gates or logs read the host loop's per-update
    history (11, 12, 17, 19, 23, 25 and ``--ab``) pin ``fused=False``, and
    so do the host-loop sides of phases 26 and 27; the paths that
    ``_drive`` runs (5, 7, 8, 15, 18, 24) and phase 21 take the default
    (phase 21's validated fit runs ``FusedSweep.run_validated``);
27. after phase 26, the validated fused sweep (``FusedSweep.run_validated``
    with a ``ValidationPlan``, the default ``GameEstimator()`` path for a
    fit with a validation suite): glmix_chip-grid's five points at full
    width with GRID_SUITE on the 1,048,576 held-out rows (the down-sampled
    point included), and glmix_sparse-held-out with GS_HELD_OUT_SUITE,
    each through ``GameEstimator()`` and ``GameEstimator(fused=False)``.
    Gates: every point's coefficients, every evaluation and ``best``
    bitwise the host loop's; kernels 1-3 launched as often; one
    ``ValidationPlan`` a sweep; the fused descents' host syncs (counted as
    phase 25 counts them) fewer than the host loop's, each a solver loop's
    read at ``opt/loop.while_loop``, a read inside a boundary evaluation
    or the one export of each fit.  Reported: the plans' device bytes, the
    first point's descent seconds both ways on one set of coordinates
    (untraced, the median of five each, interleaved) and the card's idle
    share over them, read as phase 26 reads it;
28. after phase 27, the RANDOM projector (a per-user coordinate solved in
    the span of one shared Gaussian matrix): glmix2-random (glmix2 at full
    width, the per-user coordinate RANDOM at projected_dim 8 on lanes, the
    fixed effect's L-BFGS on ``fused_value_and_grad``),
    glmix_sparse-norm-random (glmix_sparse-norm-en's rows at full width, the
    per-user shard standardized, RANDOM at projected_dim 16 with the
    intercept's pass-through slot: solve width 17; up to RANDOM_GSN_ITERS
    L-BFGS iterations; the fixed effect's sparse TRON) and the SoA branch
    (glmix2 at scale 8, cap 32, projected_dim 7: ``newton_step`` at width 7),
    each built once through ``GameEstimator.build_one_coordinate`` (its
    seconds, and the projection's own apart: the matrix's draw, the designs'
    projection and the context's) and fitted through ``GameEstimator()`` and
    ``GameEstimator(fused=False)``.  Gates: the fits bitwise equal, kernels
    launched as often (kernel 1 once an objective evaluation), the fused
    sweep and the host loop bitwise equal on the built coordinates too; the
    published stack bitwise the last update's solved lanes mapped to
    original space and back-projected through Aᵀ, and the per-user scores
    within RANDOM_MARGIN_RTOL of the projected designs' margins; the float64
    gradient in the transformed projected space at the card's optimum at
    most STATIONARY_RATIO of its norm at w = 0; and card against CPU at a
    reduced size (glmix2-random at scale 8 and the SoA cell within
    F32_PATH_RTOL; glmix_sparse-norm-random at scale 8, its coefficients,
    scores and GAME objective within F32_PATH_RTOL / F32_OBJECTIVE_RTOL or
    3x the CPU fit's own one-ulp spread where larger).  Reported:
    construction, projection, fit and descent seconds (untraced descents
    interleaved, three each way, one on the sparse cell), syncs of one
    descent each way (counted as phase 25 counts them) and peak device
    memory;
14. printed last, after phases 15-18 and 24-28: one JSON line describing each
    kernel, with its launches on each path and its device time alone
    (``device_ms``) beside the event time (``ms``); the storage-width shapes
    sit under ``by_shape`` with the launches of the path that runs them.

Every path that records its kernels' launches also counts the
``GLMObjective.value_and_grad`` calls on kernel 1's path (a dense batch on
the card), the fixed effect's objective evaluations: kernel 1 must launch
once for each.  Each fixed-effect L-BFGS solve on that path must launch it
as often as the solver counts its own evaluations (1 and each line
search's, from the searches' state on the card), and every path as often
as the scalar host loop did before the solvers took the loop form
(``SCALAR_LOOP_KERNEL1``).

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero and prints no result; so does a run without a
CUDA device or without the package beside this script.

    python3 chip_smoke.py --ab TREE  # one side of an A/B of the fused kernels

runs only phases 1-2 against the package in directory TREE, then times
both fused kernels at the four main-path shapes (after one parity check
each against the plain version), fits glmix2-TRON, glmix3 and
glmix2-en-box at scale 8 once untimed (every solver path's first launches),
and fits glmix_chip, glmix2-TRON, glmix3, glmix2-norm-var and glmix2-en-box
at full width, each AB_REPEATS times through the host loop
(``fused=False``, whose history times each update), printing per fit each
fixed-effect update's seconds, solver iterations and kernel-1 launches
(which must equal its objective evaluations) and each random-effect
update's seconds and iterations, and one JSON line of device times, fit
times, those updates and a digest of each fit's published coefficients
last.  To compare two trees on one
card, unpack both into git-ignored directories and run one process per
tree in the order A B B A.

    python3 chip_smoke.py --ab-summary LOG...  # medians of --ab runs' logs

reads the last JSON line of each log and prints, per cell, the medians over
each tree's fits of their seconds and summed fixed- and random-effect
update seconds, the later tree's ratios to the first, the kernel-1
launches a fixed update and whether every
run published the same coefficients.
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

VARIANCE_F32_RTOL = 1e-4  # glmix2-norm-var's float32 variances on the card vs a
# float64 recomputation at the same published optimum: the SIMPLE diagonal
# sums 524,288 float32 terms a feature in row chunks (~1e-6 relative), and
# the FULL variances invert 16x16 float32 Hessians of condition ~10^2 by
# Cholesky (~eps·cond); both well inside 1e-4

COMPACT_F32_RTOL = 1e-5  # match_dot vs plain, float32, relative to the
# largest score: a sample sums at most k_model matched products (64 at the
# largest tested width) in another order, a few ulps of the largest term
COMPACT_VS_DENSE_RTOL = 1e-5  # glmix_sparse per-user scores, compact model
# vs its dense twin (score_samples_sparse): the same 24 products per sample,
# summed in another order
F32_SPREAD_SEEDS = (8, 9, 10)  # glmix_sparse-norm-en: one-ulp nudges of the
F32_SPREAD_MULTIPLE = 3.0  # per-user values, one CPU fit each; the card's float32
# coefficients lie within F32_PATH_RTOL or this multiple of their largest
# card-free spread, whichever is larger.  Standardized lanes (factors up to
# ~200) under elastic net, stopped at the float32 plateau or 30 iterations,
# leave the published coefficients determined only to a few percent, more
# than two CPU fits of the same rows reproduce at 5e-3; the card's rounding
# is another such perturbation
F64_COORD_RTOL = 1e-6  # glmix_sparse-norm-en's per-user coordinate in float64,
# card vs CPU on the same offsets: the two differ in the rounding of their
# sums (~1e-16), which 30 OWLQN iterations on lanes standardized by factors
# up to ~200 amplify by orders of magnitude; phase 17 logs what it reads
SPARSE1M_OBJ_RTOL = 1e-5  # sparse1m objective, card vs CPU: both stop at
# TRON's 1e-5 gradient tolerance from the same start; Xᵀr adds each column's
# terms in row order on both devices, and only exp and log round differently

MAIN_N, MAIN_D = 8_388_608, 512
MAIN_CAP, MAIN_DU, MAIN_USERS = 32, 4, 131_072
REDUCED_USERS = 4096
GLMIX2_N, GLMIX2_D = 524_288, 256
GLMIX3_N = 262_144
REDUCED_GLMIX2_SCALE = 8  # 2048 users x 32 rows
NORM_VAR_II = GLMIX2_D  # glmix2-norm-var: the intercept column appended to glmix2's
FULL_VARIANCE_ENTITIES, FULL_VARIANCE_SEED = 16, 6  # per-user FULL variance check
NORM_VAR_SCALE_SEED = 7  # glmix2-norm-var: the per-column scales and shifts
GLMIX3_D = 128
GSN_II = 50_000  # glmix_sparse-norm-en: the per-user shard's intercept column
L1_CHOICE_SCALE = 8  # the L1 weights are chosen from CPU fits at this scale
GSN_L1_CHOICES = (1.0, 10.0, 100.0)  # glmix_sparse-norm-en per-user L1, smallest first
EN_BOX_L1_CHOICES = (10.0, 100.0, 1000.0)  # glmix2-en-box fixed-effect L1
ZERO_SHARE_RANGE = (0.10, 0.90)  # the chosen L1 zeroes this share of the coefficients
STATIONARY_RATIO = 1e-2  # a fit's float64 pseudo- (or projected-) gradient norm,
# recomputed from the raw data, over its norm at w = 0: both solvers stop on a
# 1e-7 relative change of the objective or 30 iterations, which leaves the
# first-order residual ~1e-3 of its start on these problems (scale 8 on the CPU)
EN_BOX_FEATURES = 8  # glmix2-en-box: per-user features 0-7 bounded to [0, inf)
BOX_BIND_SHARE = 0.01  # at least this share of the bounded coefficients at 0
BOX_NEG_SLACK = 1e-6  # a bounded published coefficient w = f·w' >= -1e-6·f
AB_EN_BOX_L1 = 100.0  # glmix2-en-box's fixed L1 in the A/B: the weight phase 18's
# CPU fits choose
AB_REPEATS = 6  # fits of each cell in one A/B process: host times vary by tens of
# percent from fit to fit on one machine, and by ~10% from process to process
FOLD_SEED = 8  # 17(b): the per-user shifts and each user's unobserved columns
GRID_HELD_OUT_PER_USER = 8  # glmix_chip-grid: the last rows of every user (of 64)
# are the validation data (1,048,576 rows); the rest train
# (fixed, per-user) L2 of the grid's points.  The fixed effect's data
# curvature is ~1e6 a coefficient (7.3M rows), so its weights reach that
# scale for its solution to move
GRID_L2 = ((1e5, 2.0), (1e4, 1.0), (1e3, 0.5), (1e2, 0.25))
GRID_DOWN_SAMPLING = 0.5  # the grid's last point: the fourth, fixed effect down-sampled
GRID_SUITE = ["auc", "logistic_loss", "auc:userId"]  # glmix_chip-grid's validation
GS_HELD_OUT_PER_USER = 8  # glmix_sparse held out: the last rows of every user (of 32),
# in order of appearance, validate (32,768 rows); the rest train (98,304)
GS_HELD_OUT_SUITE = ["auc", "auc:userId", "logistic_loss"]
GS_PER_USER_GAIN = 0.01  # glmix_sparse's held-out AUC >= the fixed effect's alone +
# this: a per-user coordinate that learned nothing, or compact scores that are
# wrong, fall back to the fixed effect's (0.549 against 0.568 in a float32 CPU
# fit at full width, a gap of 0.019; the gate sits at half of it)
GS_BAYES_SLACK = 0.005  # ... and <= the held-out rows' Bayes AUC + this: above it
# the model would read the labels' noise, which only leakage can do
GS_COMPACT_AUC_TOL = 1e-6  # held-out AUC, compact model vs its dense twin
RETRAIN_THIN, RETRAIN_THIN_ROWS = 8, 4  # glmix_chip-retrain: the users whose id % 8
# == 1 keep only the first 4 of their 8 held-out rows, under the bound (16,384 users)
RETRAIN_NEW = 16  # the prior leaves out the users whose id % 16 == 1: 8,192 of the
# thinned users are new and train, the other 8,192 pass through from the prior
RETRAIN_MIN_ACTIVE = 8  # the per-user lower bound of glmix_chip-retrain
RESUME_POINTS = 3  # 23(b): the grid's first three points, two sweeps of two coordinates
RESUME_CRASH = {"config": 1, "iteration": 1, "coordinate": 1}  # after point 1's third
# update; the resume recomputes the total score as a fresh sum where the run
# accumulated it, so it is held within F32_SPREAD_MULTIPLE x the spread of a
# resume from the same checkpoint nudged by one float32 ulp
SUITE_SPECS = ["auc", "aupr", "rmse", "logistic_loss", "squared_loss", "poisson_loss",
               "smoothed_hinge_loss", "precision@1000", "auc:userId", "aupr:userId",
               "precision@4:userId"]  # phase 22: every evaluator type, three grouped
SUITE_HOST_RTOL = 1e-9  # phase 22: each metric on the card against a float64 host
# recomputation by other means; both sum ~10^6 float64 terms in other orders
SUITE_TIMING_REPS = 7  # phase 22: CUDA-event timings, the median of this many
REG_PATH_WEIGHTS = (1e6, 1e5, 1e4, 1e3)  # glmix_chip-reg-path's L2 weights
GRADIENT_CHUNK_ROWS = 1 << 18  # float64 gradients over the design, a chunk at a time
FUSED_CASES = [(MAIN_N, MAIN_D, "float32"), (GLMIX2_N, GLMIX2_D, "float32"),
               (GLMIX2_N, NORM_VAR_II + 1, "float32"),  # glmix2-norm-var: odd rows
               (GLMIX3_N, GLMIX3_D, "float32"),  # glmix3's fixed effect
               (3_000_001, 1, "float32"),
               (1_000_003, 100, "float32"), (65_537, 8192, "float32"),
               (1_000_003, 1, "float64"), (200_003, 100, "float64"),
               (16_411, 8192, "float64"),
               (7, 256, "float32"),  # n below one tile of rows
               (5, 129, "float64"),
               # rows not a whole number of 16-byte vectors: each tile's span
               # has a ragged head and tail around its 16-byte interior
               (100_003, 2, "float32"), (100_003, 3, "float32"),
               (100_003, 5, "float32"), (100_003, 127, "float32"),
               (100_003, 129, "float32"), (100_001, 3, "float64"),
               (100_001, 5, "float64"), (100_001, 129, "float64")]
# X is rows 1.. of a contiguous [n + 1, d] tensor: with odd d its data_ptr is
# not 16-byte aligned, so even the first tile's span starts mid-vector
FUSED_UNALIGNED = [(100_003, 257, "float32"), (100_003, 3, "float32"),
                   (100_001, 129, "float64")]
# n = the plan's tile rows + 1: one whole tile and a one-row tile
FUSED_TILE_PLUS_ONE = [(257, "float32"), (5, "float32"), (100, "float64")]
# the main paths' fixed effects, timed: glmix_chip (kernel 1), glmix2-TRON
# (kernels 1 and 2), glmix2-norm-var (both, d = 257), glmix3 (kernel 1)
FUSED_TIMED = [(MAIN_N, MAIN_D), (GLMIX2_N, GLMIX2_D), (GLMIX2_N, NORM_VAR_II + 1),
               (GLMIX3_N, GLMIX3_D)]
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


def settle(fn, seconds: float = 0.3) -> None:
    """Calls ``fn`` back to back for ``seconds`` before a timing: right after
    another shape's work, the card's first timings at a new shape read
    slow."""
    import torch

    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()


PROFILE_ATTEMPTS = 5  # traces of one measurement: a trace can come back
# without the device records of a kernel the calls did launch (seen once for
# the 2 us partials' reduction, and for most launches of the bf16 kernels at
# glmix_chip's shape on an H100 80GB HBM3: 0.44 ms of device time where the
# events read 4.38 ms, under the 2.59 ms bound; late in a run, all 10 calls
# of both kernels in three traces running)
PROFILE_PAD_S = 0.5  # a trace runs this long before its first call and after
# its last.  Late in a run the first trace of a measurement lost the records
# of whole runs of calls, most often all of them, and the next trace of the
# same calls kept them; with no padding three traces in a row lost them


def profiled(fn, reps: int, kernels) -> dict:
    """``fn``'s device time alone, from a ``torch.profiler`` trace of
    ``reps`` calls after a warm-up call: the summed CUDA time of every kernel
    whose name contains one of ``kernels``, over ``reps`` (ms).  Also the
    host calls per ``fn`` call that would hold the card back inside a
    wrapper: stream synchronizations and host-to-device copies.  Each call
    launches each of ``kernels`` once, so a kernel's time per call is its
    recorded time over its recorded launches; a trace with no record of one
    of them is taken again, up to PROFILE_ATTEMPTS traces in all, and one
    with fewer than ``reps`` records is logged.  Where every trace lacks a
    kernel's records the measurement fails: the device time and the sync and
    copy counts come only from a trace that recorded the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        syncs, htod = 0, 0
        dev_us, records = dict.fromkeys(kernels, 0.0), dict.fromkeys(kernels, 0)
        for e in prof.key_averages():
            for k in kernels:
                if k in e.key:
                    dev_us[k] += (getattr(e, "self_device_time_total", 0)
                                  or e.self_cuda_time_total)
                    records[k] += e.count
            if e.key == "cudaStreamSynchronize":
                syncs += e.count
            if "HtoD" in e.key:
                htod += e.count
        if min(records.values()) < reps:
            log(f"profiler trace {attempt} of {PROFILE_ATTEMPTS} shows {records} device "
                f"records of {reps} calls of {kernels}")
        if all(records.values()) and all(dev_us.values()):
            return dict(device_ms=sum(dev_us[k] / records[k] for k in kernels) / 1e3,
                        syncs_per_call=syncs / reps, htod_per_call=htod / reps)
    raise AssertionError(f"no profiler trace of {PROFILE_ATTEMPTS} shows device time "
                         f"for every one of {kernels}")


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


_MANGLED_TYPES = {"f": "float32", "d": "float64", "13__nv_bfloat16": "bfloat16",
                  "6__half": "float16"}


def ptxas_table(report: str) -> dict:
    """ptxas -v output -> {(kernel, dtypes, other template ints): {first
    template int: (registers, spill-store bytes)}}; ``dtypes`` joins the
    template's types with "/" (storage and accumulation types of the
    storage-width instantiations); a kernel templated on types alone has
    first int None."""
    table: dict = {}
    entries = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
                         r"(\d+) bytes spill stores.*\n.*Used (\d+) registers", report)
    types = "|".join(sorted(_MANGLED_TYPES, key=len, reverse=True))
    for fn, spill, regs in entries:
        m = re.search(rf"\d+([a-z_]+_kernel)I((?:{types})+)((?:Li\d+E)*)E", fn)
        if m is None:
            raise AssertionError(f"unrecognised kernel symbol {fn}")
        ints = [int(i) for i in re.findall(r"Li(\d+)E", m.group(3))] or [None]
        dts = "/".join(_MANGLED_TYPES[t] for t in re.findall(types, m.group(2)))
        key = (m.group(1), dts, tuple(ints[1:]))
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


def _glm_batch(n, d, dtype, gen, scale=0.05, skip_rows=0):
    """(w, batch) on the card; X is rows ``skip_rows``.. of a contiguous
    [n + skip_rows, d] tensor."""
    import torch

    from photon_ml_tpu_torch.core.batch import DenseBatch

    dev = "cuda"
    x = torch.randn((n + skip_rows, d), generator=gen, device=dev, dtype=dtype)[skip_rows:]
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


def _fused_plan(n, d, dtype):
    """The wrappers' launch plan at (n, d), or None for a package without
    one (the A/B mode's parent tree)."""
    import torch

    from photon_ml_tpu_torch.ops import fused_glm

    if not hasattr(fused_glm, "launch_plan"):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return fused_glm.launch_plan(n, d, torch.tensor([], dtype=dtype).element_size(), sms)


def _plan_text(plan) -> str:
    if plan is None:
        return "plan: not reported"
    return (f"plan: tile rows {plan.tile_rows}, stages {plan.stages}, blocks "
            f"{plan.blocks} x {plan.rows_per_block} rows, shared memory "
            f"{plan.smem_bytes} bytes")


def _fused_cases():
    """(n, d, dtype, rows skipped at X's start) of phase 3."""
    import torch

    cases = [(n, d, getattr(torch, dt), 0) for n, d, dt in FUSED_CASES]
    cases += [(n, d, getattr(torch, dt), 1) for n, d, dt in FUSED_UNALIGNED]
    cases += [(_fused_plan(10**6, d, getattr(torch, dt)).tile_rows + 1, d,
               getattr(torch, dt), 0) for d, dt in FUSED_TILE_PLUS_ONE]
    return cases


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
    worst = {"fused_value_and_grad": 0.0, "fused_hvp": 0.0}
    for n, d, dt, skip in _fused_cases():
        w, b = _glm_batch(n, d, dt, gen, skip_rows=skip)
        v = torch.randn(d, generator=gen, device="cuda", dtype=dt) / max(1, d) ** 0.5
        tol = F32_KERNEL_RTOL if dt == torch.float32 else F64_KERNEL_RTOL
        tag = f"n={n} d={d} {str(dt)[6:]}" + (f" data_ptr%16={b.x.data_ptr() % 16}"
                                               if skip else "")
        log(f"fused {tag}: {_plan_text(_fused_plan(n, d, dt))}")
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
        if dt == torch.float32 and not skip and (n, d) in FUSED_TIMED:
            _time_fused(stats, n, d, w, v, b, shift, v_shift, gen)
        del w, v, b
        torch.cuda.empty_cache()
    for k, e in worst.items():
        stats.setdefault(k, {})["max_abs_err"] = e


def _time_fused(stats, n, d, w, v, b, shift, v_shift, gen, path_launches=None):
    """Kernel, plain and library times of both fused kernels at one main-path
    shape (logistic; X at float32, or at a storage width with w and v at it
    and y / offset / weight at float32).  glmix_chip's shape is kernel 1's
    main path, glmix2's is kernel 2's; the other shape is logged beside it.
    The shifts are 0-d tensors on the card, made once, as ``GLMObjective``
    passes them: a Python float costs the wrapper a blocking host-to-device
    copy per call, which the event time would count (printed beside it as
    "float shifts").  A storage-width shape is recorded under "NxD dtype" with
    ``path_launches`` ({kernel: (path, launches)}) where a path ran it; the
    library yardstick then takes its operands at the storage width."""
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_hvp_plain,
                                                   fused_value_and_grad,
                                                   fused_value_and_grad_plain)

    loss = L.logistic_loss
    item, acc = b.x.element_size(), b.y.element_size()
    dt = str(b.x.dtype)[6:]
    narrow = b.x.dtype != b.y.dtype
    sh, vsh = (torch.tensor(s, dtype=b.y.dtype, device="cuda") for s in (shift, v_shift))
    r = torch.rand(n, generator=gen, device="cuda").to(b.x.dtype)
    wv = torch.stack([w, v], dim=1)
    reps = 10 if n * d * item > 1 << 30 else 50
    rows = {
        "fused_value_and_grad": dict(
            kernel=lambda: fused_value_and_grad(loss, w, b, sh),
            float_shifts=lambda: fused_value_and_grad(loss, w, b, shift),
            plain=lambda: fused_value_and_grad_plain(loss, w, b, sh),
            library=lambda: (torch.mv(b.x, w), torch.mv(b.x.T, r)),
            library_name=f"torch.mv x2, {dt} operands", names=("fvg_",),
            nbytes=(n * d + d) * item + (3 * n + d + 2) * acc, flops=4 * n * d,
            main=(n, d) == (MAIN_N, MAIN_D) and not narrow),
        "fused_hvp": dict(
            kernel=lambda: fused_hvp(loss, w, v, b, sh, vsh),
            float_shifts=lambda: fused_hvp(loss, w, v, b, shift, v_shift),
            plain=lambda: fused_hvp_plain(loss, w, v, b, sh, vsh),
            library=lambda: (torch.mm(b.x, wv), torch.mv(b.x.T, r)),
            library_name=f"torch.mm X[w|v] + torch.mv Xtq, {dt} operands", names=("hvp_",),
            nbytes=(n * d + 2 * d) * item + (3 * n + d + 1) * acc, flops=6 * n * d,
            main=(n, d) == (GLMIX2_N, GLMIX2_D) and not narrow),
    }
    for name, row in rows.items():
        settle(row["kernel"])
        ms = cuda_ms(row["kernel"], reps)
        float_ms = cuda_ms(row["float_shifts"], reps)
        prof = profiled(row["kernel"], reps, row["names"] + ("reduce_partials",))
        red = profiled(row["kernel"], reps, ("reduce_partials",))["device_ms"]
        plain_ms = cuda_ms(row["plain"], reps)
        lib_ms = cuda_ms(row["library"], reps)
        bound, by = _bound(row["nbytes"], row["flops"])
        log(f"{name} timing n={n} d={d} {dt} logistic: kernel {ms:.4f} ms (events; "
            f"device alone {prof['device_ms']:.4f} ms, of which the partials' "
            f"reduction {red:.4f} ms; {prof['syncs_per_call']:g} stream "
            f"syncs and {prof['htod_per_call']:g} HtoD copies per call; float shifts "
            f"{float_ms:.4f} ms), plain {plain_ms:.4f} ms, library ({row['library_name']}) "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({row['nbytes'] / 1e9:.3f} GB, {by}), "
            f"{bound / prof['device_ms']:.0%} of bound, "
            f"{row['nbytes'] / (prof['device_ms'] * 1e-3) / 1e12:.2f} TB/s; "
            f"{_plan_text(_fused_plan(n, d, b.x.dtype))}")
        if prof["syncs_per_call"] or prof["htod_per_call"]:
            raise AssertionError(f"{name} syncs or copies to the card on the real path")
        timed = dict(ms=ms, device_ms=prof["device_ms"], reduce_ms=red, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=bound, bound_by=by)
        key = f"{n}x{d}"
        if narrow:
            key += f" {dt}"
            path, count = (path_launches or {}).get(name, (None, 0))
            timed.update(path=path, launches=count, library=row["library_name"])
        stats.setdefault(name, {}).setdefault("by_shape", {})[key] = timed
        if row["main"]:
            stats[name].update(timed)


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


def _glmix_config(num_iters=2, variance="none", storage=None):
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

    s = SolverConfig(max_iters=30, tolerance=1e-7)
    var = VarianceComputationType(variance)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(feature_shard="g", solver=s,
                                                     reg=Regularization(l2=1.0),
                                                     variance=var, storage_dtype=storage),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              solver=s, reg=Regularization(l2=1.0),
                              active_cap=MAIN_CAP, variance=var,
                              storage_dtype=storage)})


def _baseline_config(three: bool, optimizer, storage=None):
    """BASELINE glmix2 (three False) / glmix3: L2 1.0 on every coordinate, 30
    solver iterations at tolerance 1e-7, two sweeps (bench.py _glmix_coords),
    every coordinate under ``optimizer`` and at ``storage`` (the storage
    dtype of every coordinate, as bench.py's PHOTON_BENCH_STORAGE)."""
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import TaskType

    s = SolverConfig(max_iters=30, tolerance=1e-7)
    reg = Regularization(l2=1.0)
    coords = {"fixed": FixedEffectConfig(feature_shard="g", optimizer=optimizer,
                                         solver=s, reg=reg, storage_dtype=storage),
              "per-user": RandomEffectConfig(random_effect_type="userId",
                                             feature_shard="u", optimizer=optimizer,
                                             solver=s, reg=reg, storage_dtype=storage)}
    if three:
        coords["per-item"] = RandomEffectConfig(random_effect_type="itemId",
                                                feature_shard="i", optimizer=optimizer,
                                                solver=s, reg=reg, storage_dtype=storage)
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


def _fit_and_score(data, device, config, normalization=None, fused="auto"):
    """fit -> score -> AUC through ``GameEstimator(fused=fused)``: (result,
    scores, AUC, fit seconds, score seconds)."""
    import torch

    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.game import GameEstimator

    t0 = time.perf_counter()
    res = GameEstimator(device=device, normalization=normalization, fused=fused).fit(
        data, [config])[0]
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


class _ObjectiveEvaluations:
    """``GLMObjective.value_and_grad`` calls on kernel 1's path (a dense
    batch on the card at a storage width the kernel takes): the fixed
    effect's objective evaluations, 1 + its line searches' a solve, counted
    beside the kernels' launches (``_count_objective_evaluations``)."""

    launches = 0


def _count_objective_evaluations() -> None:
    """Wrap ``GLMObjective.value_and_grad``, once for the run, to count
    its calls on kernel 1's path in ``_ObjectiveEvaluations``."""
    from photon_ml_tpu_torch.core.batch import DenseBatch
    from photon_ml_tpu_torch.core.objective import GLMObjective
    from photon_ml_tpu_torch.ops.fused_glm import storage_narrowing_ok

    real = GLMObjective.value_and_grad
    if getattr(real, "counts_evaluations", False):
        return

    def value_and_grad(self, w, batch):
        if (isinstance(batch, DenseBatch) and batch.x.is_cuda
                and storage_narrowing_ok(batch.x.dtype, w.dtype)):
            _ObjectiveEvaluations.launches += 1
        return real(self, w, batch)

    value_and_grad.counts_evaluations = True
    GLMObjective.value_and_grad = value_and_grad


class _SolverEvaluations:
    """Per single L-BFGS solve (``opt/solve.py``'s fixed-effect L-BFGS):
    kernel 1's launches in it and the solver's own count of its objective
    evaluations, 1 and each line search's from the search's state on the
    card (kept there until a path is recorded), so that a solve that
    evaluates outside its searches, or twice for one, shows
    (``_count_solver_evaluations``)."""

    solves: list = []  # (kernel-1 launches, [each search's evaluations, 0-d])


def _count_solver_evaluations() -> None:
    """Wrap ``opt/solve.py``'s ``minimize_lbfgs`` and ``opt/lbfgs.py``'s
    ``replay``, once for the run, to keep each single solve's counts in
    ``_SolverEvaluations``: the search state an iteration ends with is
    copied on the card as the iteration's end is replayed."""
    import photon_ml_tpu_torch.opt.lbfgs as lbfgs
    import photon_ml_tpu_torch.opt.linesearch as linesearch
    import photon_ml_tpu_torch.opt.solve as solve
    from photon_ml_tpu_torch.ops.fused_glm import fused_value_and_grad

    real_solve, real_replay = solve.minimize_lbfgs, lbfgs.replay
    if getattr(real_solve, "counts_evaluations", False):
        return
    open_solves: list = []

    def replay(fn, *args):
        if fn is lbfgs._finish and open_solves:
            open_solves[-1].append(args[1].s[..., linesearch._EVALS].clone())
        return real_replay(fn, *args)

    def minimize_lbfgs(*args, **kwargs):
        before = fused_value_and_grad.launches
        open_solves.append([])
        try:
            res = real_solve(*args, **kwargs)
        finally:
            evals = open_solves.pop()
        _SolverEvaluations.solves.append((fused_value_and_grad.launches - before, evals))
        return res

    minimize_lbfgs.counts_evaluations = True
    solve.minimize_lbfgs = minimize_lbfgs
    lbfgs.replay = replay


def _check_solver_evaluations(path: str) -> int:
    """Every single L-BFGS solve kept since the last check that ran on
    kernel 1's path launched it once an evaluation the solver counted: 1
    and its searches'.  Returns the solves checked."""
    solves = [(k1, evals) for k1, evals in _SolverEvaluations.solves if k1 > 0]
    _SolverEvaluations.solves = []
    for k1, evals in solves:
        counted = 1 + sum(int(e) for e in evals)
        if k1 != counted:
            raise AssertionError(f"{path}: a fixed-effect L-BFGS solve launched kernel 1 {k1} "
                                 f"times for {counted} objective evaluations (1 + its line "
                                 f"searches' {[int(e) for e in evals]})")
    return len(solves)


def _counted_kernels() -> dict:
    """The four kernels' wrappers, whose ``launches`` count their launches,
    and the objective evaluations that should launch kernel 1."""
    from photon_ml_tpu_torch.ops.compact_score import match_dot
    from photon_ml_tpu_torch.ops.fused_glm import fused_hvp, fused_value_and_grad
    from photon_ml_tpu_torch.ops.soa_newton import newton_step

    return {"fused_value_and_grad": fused_value_and_grad, "fused_hvp": fused_hvp,
            "newton_step": newton_step, "match_dot": match_dot,
            "objective_evaluations": _ObjectiveEvaluations}


def _zero_launches() -> dict:
    kernels = _counted_kernels()
    for k in kernels.values():
        k.launches = 0
    _SolverEvaluations.solves = []
    return kernels


def _record_launches(path: str, kernels: dict, stats: dict, required) -> dict:
    """Each kernel's launches since ``_zero_launches``, recorded under
    ``path``; each kernel in ``required`` must have launched."""
    launches = {name: k.launches for name, k in kernels.items()}
    _record_path_launches(path, launches, stats, required)
    return launches


def _drive(path: str, data, config, stats: dict, required, normalization=None):
    """One main path on the card: fit -> score -> AUC, with every kernel's
    launch count set to 0 just before and read just after; each kernel in
    ``required`` must have launched, and the scores must be finite."""
    import torch

    kernels = _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    res, scores, auc, t_fit, t_score = _fit_and_score(data, "cuda", config, normalization)
    launches = _record_launches(path, kernels, stats, required)
    log(f"{path}: fit {t_fit:.2f} s through GameEstimator's default (the fused sweep, no "
        f"per-update history), score + AUC {t_score:.2f} s, AUC {auc:.4f}, launches "
        f"{launches}, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if res.history.steps:
        raise AssertionError(f"{path}: the default fit ran the host loop")
    if not bool(torch.isfinite(scores).all()) or scores.shape != (data.num_samples,):
        raise AssertionError(f"{path} scores are not finite of shape [n]")
    stats[path] = dict(fit_s=t_fit, score_s=t_score, auc=auc)
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
    res, _, auc = _drive("glmix_chip", data, _glmix_config(), stats,
                         required=("fused_value_and_grad", "newton_step"))
    if auc < AUC_FLOOR:
        raise AssertionError(f"glmix_chip AUC {auc:.4f} < {AUC_FLOOR}")
    stats["glmix_chip"]["model"] = res.model  # phase 24(a)'s float32 yardstick
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
                                lbfgs_fit_s=lt_fit, model=res.model)


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


def _compare_fits(label, data_gpu, data_cpu, config, coords, norms=(None, None),
                  path=None, stats=None, required=(), check_card=None, tols=None):
    """Card and CPU fits of ``config`` (under the normalization contexts
    ``norms``, one per device): coefficients, variances where the config
    asks for them, scores and AUC; random-effect stacks are compared on the
    card.  With ``path``, the card fit's kernel launches are counted (from
    0) and recorded under it.  ``check_card`` gets the card fit's result
    before the CPU fit.  ``tols(cpu_result, cpu_scores)`` gives each
    compared quantity's tolerance (default: F32_PATH_RTOL for all)."""
    import torch

    kernels = _zero_launches()
    rg, sg, auc_g, tg, _ = _fit_and_score(data_gpu, "cuda", config, norms[0])
    if path is not None:
        _record_launches(path, kernels, stats, required)
    if check_card is not None:
        check_card(rg)
    rc, sc, auc_c, tc, _ = _fit_and_score(data_cpu, "cpu", config, norms[1])
    errs = _model_errors(label, rg.model, rc.model, coords)
    errs["scores"] = rel_err(sg.cpu(), sc)
    tol = {k: F32_PATH_RTOL for k in errs} if tols is None else tols(rc, sc)
    ok = all(errs[k] <= tol[k] for k in errs) and abs(auc_g - auc_c) <= 1e-3
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())
    log(f"card vs CPU, {label}: fit {tg:.2f} s vs {tc:.2f} s; max rel diff {fmt(errs)} "
        + (f"(tol {F32_PATH_RTOL:g})" if tols is None else f"(tol {fmt(tol)})")
        + f"; AUC {auc_g:.5f} vs {auc_c:.5f} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: card and CPU fits disagree beyond the float32 "
                             "tolerance")
    return rg, rc


def _model_errors(label, mg, mc, coords) -> dict:
    """Relative differences of a card model from a CPU model: fixed means,
    each random-effect stack in ``coords`` (compared on the card), and their
    variances where the models have them."""
    import torch

    fg, fc = mg["fixed"].coefficients, mc["fixed"].coefficients
    errs = {"fixed": rel_err(fg.means, fc.means)}
    if (fg.variances is None) != (fc.variances is None):
        raise AssertionError(f"{label}: only one of the fits has fixed-effect variances")
    if fc.variances is not None:
        errs["fixed variances"] = rel_err(fg.variances, fc.variances)
    on_card = lambda a: torch.as_tensor(a, device="cuda")
    for cid in coords:
        g, c = mg[cid], mc[cid]
        if g.slot_of != c.slot_of:
            raise AssertionError(f"{label}: card and CPU {cid} models have different "
                                 "entities")
        errs[cid] = rel_err(on_card(g.w_stack), on_card(c.w_stack))
        if (g.variances is None) != (c.variances is None):
            raise AssertionError(f"{label}: only one of the fits has {cid} variances")
        if c.variances is not None:
            errs[f"{cid} variances"] = rel_err(on_card(g.variances), on_card(c.variances))
    return errs


def phase_glmix2_card_vs_cpu():
    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.types import OptimizerType

    data = _baseline_data(synth_glmix(REDUCED_GLMIX2_SCALE, three=False))
    _compare_fits(f"glmix2-TRON at scale {REDUCED_GLMIX2_SCALE} ({data.num_samples} rows)",
                  data, data, _baseline_config(False, OptimizerType.TRON), ["per-user"])


def _grid_configs():
    """glmix_chip-grid: ``_glmix_config`` at each (fixed, per-user) L2 of
    GRID_L2, in descending order, then the last again with the fixed effect
    down-sampled at GRID_DOWN_SAMPLING."""
    import dataclasses

    from photon_ml_tpu_torch.core.regularization import Regularization

    base = _glmix_config()

    def point(fixed_l2, user_l2, rate=1.0):
        c = base.coordinates
        return dataclasses.replace(base, coordinates={
            "fixed": dataclasses.replace(c["fixed"], reg=Regularization(l2=fixed_l2),
                                         down_sampling_rate=rate),
            "per-user": dataclasses.replace(c["per-user"], reg=Regularization(l2=user_l2))})

    return [point(f, u) for f, u in GRID_L2] + [point(*GRID_L2[-1], GRID_DOWN_SAMPLING)]


def _compare_grids(label, data_gpu, data_cpu, configs, coords):
    """One ``GameEstimator.fit`` over ``configs`` on the card and one on the
    CPU: every grid point's models and scores within F32_PATH_RTOL."""
    import torch

    from photon_ml_tpu_torch.game import GameEstimator

    t0 = time.perf_counter()
    rg = GameEstimator(device="cuda").fit(data_gpu, configs)
    torch.cuda.synchronize()
    tg, t0 = time.perf_counter() - t0, time.perf_counter()
    rc = GameEstimator(device="cpu").fit(data_cpu, configs)
    tc = time.perf_counter() - t0
    worst = []
    for i, (a, b) in enumerate(zip(rg, rc)):
        errs = _model_errors(f"{label}, point {i}", a.model, b.model, coords)
        errs["scores"] = rel_err(a.model.score(data_gpu, device="cuda").cpu(),
                                 b.model.score(data_cpu, device="cpu"))
        worst.append(max(errs.values()))
    ok = max(worst) <= F32_PATH_RTOL
    log(f"card vs CPU, {label}: grid of {len(configs)} in {tg:.2f} s vs {tc:.2f} s; max "
        f"rel diff per point (coefficients and scores) "
        + ", ".join(f"{w:.2e}" for w in worst)
        + f" (tol {F32_PATH_RTOL:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: card and CPU grids disagree beyond the float32 "
                             "tolerance")


def phase_card_vs_cpu(host, xg):
    from photon_ml_tpu_torch.game import GameData

    m = REDUCED_USERS * host["per_user"]
    # the first REDUCED_USERS users' rows (ids are laid out user by user)
    assert int(host["uids"][m - 1]) == REDUCED_USERS - 1
    parts = dict(y=host["y"][:m], offset=None, weight=None,
                 id_tags={"userId": host["uids"][:m]})
    gpu = GameData(features={"g": xg[:m].contiguous(), "u": host["xu"][:m]}, **parts)
    cpu = GameData(features={"g": xg[:m].cpu(), "u": host["xu"][:m]}, **parts)
    label = f"glmix_chip at {REDUCED_USERS} users x {host['per_user']} rows ({m} rows)"
    _compare_fits(label, gpu, cpu, _glmix_config(), ["per-user"])
    # the grid's last three points: rebinds, and the down-sampled fixed effect
    # (the same host draws on both devices)
    _compare_grids(label, gpu, cpu, _grid_configs()[-3:], ["per-user"])
    # phase 16 (c) fits these rows again: a copy of its own, since the slice
    # above is a view that would keep the whole 17 GB design on the card
    gpu = GameData(features={"g": xg[:m].clone(), "u": host["xu"][:m]}, **parts)
    return label, gpu, cpu


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


def _sparse1m_config(variance="none"):
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    # bench.py run_sparse1m: TRON with its default settings, L2 1.0
    return GameConfig(task=TaskType.POISSON_REGRESSION, num_outer_iterations=1,
                      coordinates={"fixed": FixedEffectConfig(
                          feature_shard="g", optimizer=OptimizerType.TRON,
                          solver=SolverConfig.tron_default(),
                          reg=Regularization(l2=1.0),
                          variance=VarianceComputationType(variance))})


def _poisson_objective(w, host, device, norm=None) -> float:
    """The sparse1m objective Σ (exp(z) - y z) + (1 / 2)||w'||² at the
    original-space ``w``, w' its transformed-space twin under ``norm`` (w
    itself without one), in float64 on ``device``."""
    import torch

    from photon_ml_tpu_torch.core.batch import sparse_batch
    from photon_ml_tpu_torch.core.losses import poisson_loss
    from photon_ml_tpu_torch.core.normalization import no_normalization
    from photon_ml_tpu_torch.core.objective import GLMObjective
    from photon_ml_tpu_torch.core.regularization import Regularization

    b = sparse_batch(host["indices"], host["values"], host["y"], host["dim"],
                     dtype=torch.float64, device=device)
    norm = (norm or no_normalization()).to(torch.float64, torch.device(device))
    w_t = norm.model_to_transformed_space(torch.as_tensor(w, device=device).double(), None)
    obj = GLMObjective(loss=poisson_loss, reg=Regularization(l2=1.0), norm=norm)
    return float(obj.value_and_grad(w_t, b)[0])


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
        res = GameEstimator(device=device, fused=False).fit(data, [cfg])[0]
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


def _glmix_sparse_config(num_iters=2, user_variance="none"):
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    reg = Regularization(l2=1.0)
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(
                              feature_shard="g", optimizer=OptimizerType.TRON,
                              solver=SolverConfig.tron_default(), reg=reg),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              solver=SolverConfig(max_iters=30, tolerance=1e-7), reg=reg,
                              variance=VarianceComputationType(user_variance))})


def _glmix_sparse_data(host):
    from photon_ml_tpu_torch.game import GameData, SparseShard

    return GameData(y=host["y"], features={"g": SparseShard(**host["fixed"]),
                                           "u": SparseShard(**host["user"])},
                    id_tags={"userId": host["uids"]})


def _check_compact(label, data, dense_re, compact, user):
    """A compact per-user model's scores against its dense twin's
    (score_samples_sparse) within COMPACT_VS_DENSE_RTOL, and match_dot
    against its plain version on the compact model's own inputs (``user``:
    the shard's host indices and values).  Returns (tag, match_dot's
    arguments, its largest absolute difference from plain)."""
    import torch

    e = rel_err(compact.score(data, device="cuda"), dense_re.score(data, device="cuda"))
    ok = e <= COMPACT_VS_DENSE_RTOL
    log(f"{label} per-user scores, compact vs dense model: rel diff {e:.2e} (tol "
        f"{COMPACT_VS_DENSE_RTOL:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label} compact and dense scores disagree")
    on_card = lambda a: torch.as_tensor(a, device="cuda")
    args = (on_card(compact.indices), on_card(compact.values),
            on_card(compact.slots_for(data)), on_card(user["indices"]),
            on_card(user["values"]))
    tag = (f"{label} shape E={args[0].shape[0]} k_model={args[0].shape[1]} "
           f"k_feat={args[3].shape[1]} n={data.num_samples} float32")
    return tag, args, _check_match_dot(tag, args)


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
    res = GameEstimator(device="cuda", fused=False).fit(data, [_glmix_sparse_config()])[0]
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

    # compact scores against the dense twin's, and match_dot at this path's
    # shape against its plain version; then timed
    tag, args, err = _check_compact("glmix_sparse", data, dense_re, compact, host["user"])
    stats.setdefault("match_dot", {}).update(_time_match_dot(tag, args, 50),
                                             max_abs_err=err)
    for name, v in launches.items():
        stats.setdefault(name, {}).setdefault("launches_by_path", {})["glmix_sparse"] = v
    stats["glmix_sparse"] = dict(fit_s=t_fit, build_s=t_fit - t_upd, score_s=t_score,
                                 auc=auc, bayes_auc=bayes, peak_gb=peak,
                                 bucket_s=t_bucket, objective=f_full,
                                 objective_fixed_only=f_fixed)
    return dict(host=host, data=data, res=res, scores=scores, auc=auc, objective=f_full)


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


def _with_intercept(host: dict) -> dict:
    """glmix2's data, scaled and shifted as raw features are, with a column
    of ones appended to the fixed shard as its intercept (d = 257, index
    NORM_VAR_II).  Fixed column j becomes xg_j·a_j + c_j and per-user column
    j becomes xu_j·b_j, with a and b log-uniform in [1/2, 2] and c uniform in
    [-1, 1] (seed NORM_VAR_SCALE_SEED).  STANDARDIZATION of the fixed shard
    and SCALE_WITH_STANDARD_DEVIATION of the per-user shard undo these maps
    up to sampling noise, so the transformed problems and the Bayes AUC stay
    glmix2's while the shifts and factors are far from the identity's."""
    import numpy as np

    rng = np.random.default_rng(NORM_VAR_SCALE_SEED)
    n, d_g = host["xg"].shape
    d_u = host["xu"].shape[1]
    a = np.exp(rng.uniform(-np.log(2.0), np.log(2.0), d_g)).astype(np.float32)
    c = rng.uniform(-1.0, 1.0, d_g).astype(np.float32)
    b = np.exp(rng.uniform(-np.log(2.0), np.log(2.0), d_u)).astype(np.float32)
    xg = np.concatenate([host["xg"] * a + c, np.ones((n, 1), np.float32)], axis=1)
    return dict(host, xg=xg, xu=host["xu"] * b)


def _norm_var_config(variances=True, num_iters=2):
    """glmix2-norm-var: ``_baseline_config``'s glmix2 under TRON, the fixed
    effect with its intercept and SIMPLE variances, the per-user coordinate
    with FULL variances (NONE for both when ``variances`` is False)."""
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

    s = SolverConfig(max_iters=30, tolerance=1e-7)
    reg = Regularization(l2=1.0)
    var = VarianceComputationType
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(
                              feature_shard="g", optimizer=OptimizerType.TRON, solver=s,
                              reg=reg, intercept_index=NORM_VAR_II,
                              variance=var.SIMPLE if variances else var.NONE),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              optimizer=OptimizerType.TRON, solver=s, reg=reg,
                              variance=var.FULL if variances else var.NONE)})


def _norm_var_contexts(xg, xu):
    """({shard: context}, seconds): STANDARDIZATION of the fixed shard and
    SCALE_WITH_STANDARD_DEVIATION of the per-user shard, from their dense
    feature stats on the tensors' device."""
    import torch

    from photon_ml_tpu_torch.core.normalization import (build_normalization,
                                                        compute_feature_stats)
    from photon_ml_tpu_torch.types import NormalizationType

    t0 = time.perf_counter()
    ctx_g = build_normalization(NormalizationType.STANDARDIZATION,
                                compute_feature_stats(xg, intercept_index=NORM_VAR_II))
    ctx_u = build_normalization(NormalizationType.SCALE_WITH_STANDARD_DEVIATION,
                                compute_feature_stats(xu))
    if xg.is_cuda:
        torch.cuda.synchronize()
    return {"g": ctx_g, "u": ctx_u}, time.perf_counter() - t0


def _norm_var_data(host: dict, device: str):
    """(GameData, xg, xu): the shards as tensors on ``device``."""
    import torch

    from photon_ml_tpu_torch.game import GameData

    xg = torch.as_tensor(host["xg"], device=device)
    xu = torch.as_tensor(host["xu"], device=device)
    data = GameData(y=host["y"], features={"g": xg, "u": xu},
                    id_tags={"userId": host["uids"]})
    return data, xg, xu


def _elementwise_rel(a, b) -> float:
    import torch

    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double().to(a.device)
    return float(((a - b).abs() / b.abs()).max())


def _fixed_simple_variance_err(res, xg, ctx, offsets, l2: float):
    """The fixed effect's published SIMPLE variances, every feature but the
    intercept, against a float64 recomputation on the card from the raw
    design: at the transformed-space optimum w' (``model_to_transformed_space``
    of the published means), Σ p(1-p)·((x_j - s_j)·f_j)² + λ with p the
    logistic mean of ((x - s)·f)·w' + offset, inverted and mapped by the same
    coefficient map as the means.  Returns (the largest relative difference,
    the same measure for variances from a diagonal without the shift terms,
    Σ p(1-p)·(x_j·f_j)² + λ): the second must lie far above the gate for the
    gate to see the shifts."""
    import torch

    ctx = ctx.to(torch.float64, xg.device)
    coef = res.model["fixed"].coefficients
    w_t = ctx.model_to_transformed_space(
        torch.as_tensor(coef.means, device=xg.device).double(), NORM_VAR_II)
    diag, unshifted = torch.zeros_like(w_t), torch.zeros_like(w_t)
    step = 1 << 16
    for lo in range(0, xg.shape[0], step):
        xc = xg[lo:lo + step].double()
        xn = (xc - ctx.shifts) * ctx.factors
        q = torch.sigmoid(xn @ w_t + offsets[lo:lo + step])
        q = q * (1.0 - q)
        diag += q @ (xn * xn)
        unshifted += q @ (xc * ctx.factors) ** 2
    expected, wrong = (ctx.model_to_original_space(1.0 / (h + l2), NORM_VAR_II)
                       for h in (diag, unshifted))
    keep = torch.arange(len(w_t), device=xg.device) != NORM_VAR_II
    return (_elementwise_rel(torch.as_tensor(coef.variances, device=xg.device)[keep],
                             expected[keep]),
            _elementwise_rel(wrong[keep], expected[keep]))


def _user_full_variance_err(res, xu, uids, ctx, offsets, l2: float) -> float:
    """The per-user FULL variances of FULL_VARIANCE_ENTITIES seeded entities
    against the diagonal of a float64 ``torch.linalg.inv`` of each entity's
    transformed-space Hessian at its published optimum (all its rows), mapped
    by the same coefficient map; the largest relative difference."""
    import numpy as np
    import torch

    ctx = ctx.to(torch.float64, xu.device)
    model = res.model["per-user"]
    ids = np.random.default_rng(FULL_VARIANCE_SEED).choice(
        sorted(model.slot_of), FULL_VARIANCE_ENTITIES, replace=False)
    uids = torch.as_tensor(uids, device=xu.device)
    eye = torch.eye(xu.shape[1], dtype=torch.float64, device=xu.device)
    worst = 0.0
    for e in ids:
        rows = uids == int(e)
        slot = model.slot_of[int(e)]
        w_t = ctx.model_to_transformed_space(
            torch.as_tensor(model.w_stack[slot], device=xu.device).double(), None)
        xn = xu[rows].double() * ctx.factors
        p = torch.sigmoid(xn @ w_t + offsets[rows])
        h = (xn * (p * (1.0 - p))[:, None]).T @ xn + l2 * eye
        expected = ctx.model_to_original_space(torch.diagonal(torch.linalg.inv(h)), None)
        worst = max(worst, _elementwise_rel(
            torch.as_tensor(model.variances[slot], device=xu.device), expected))
    return worst


def phase_glmix2_norm_var(stats: dict):
    """glmix2-norm-var at full width: normalization and variances through
    ``GameEstimator.fit`` on the card, with nonzero margin shifts in the
    fused kernels."""
    import torch

    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.game import GameEstimator

    t0 = time.perf_counter()
    host = _with_intercept(synth_glmix(1, three=False))
    data, xg, xu = _norm_var_data(host, "cuda")
    assert tuple(xg.shape) == (GLMIX2_N, NORM_VAR_II + 1), tuple(xg.shape)
    log(f"glmix2-norm-var data: {GLMIX2_N} rows x {NORM_VAR_II + 1} fixed (intercept "
        f"column {NORM_VAR_II}) + {xu.shape[1]} per-user features, 2048 users, generated "
        f"on the host in {time.perf_counter() - t0:.2f} s")
    norms, t_stats = _norm_var_contexts(xg, xu)
    spread = lambda f: (float(f.min()), float(f.max()))
    log(f"glmix2-norm-var feature stats + contexts on the card {t_stats:.4f} s; fixed "
        f"shard STANDARDIZATION (max |shift| {float(norms['g'].shifts.abs().max()):.3e}, "
        f"factors in [{spread(norms['g'].factors)[0]:.3f}, "
        f"{spread(norms['g'].factors)[1]:.3f}]), per-user SCALE_WITH_STANDARD_DEVIATION "
        f"(factors in [{spread(norms['u'].factors)[0]:.3f}, "
        f"{spread(norms['u'].factors)[1]:.3f}])")
    res, scores, auc = _drive("glmix2_norm_var", data, _norm_var_config(), stats,
                              required=("fused_value_and_grad", "fused_hvp"),
                              normalization=norms)
    bayes = _bayes_auc(host)
    _check_bayes("glmix2_norm_var", auc, bayes)

    # what variances add to the fit: the same fit without them, then with
    # them again (both after the driven fit, so neither pays a first call)
    _, _, _, t_plain, _ = _fit_and_score(data, "cuda", _norm_var_config(False), norms)
    _, _, _, t_var, _ = _fit_and_score(data, "cuda", _norm_var_config(), norms)
    t_fit = stats["glmix2_norm_var"]["fit_s"]
    log(f"glmix2-norm-var: fit with variances {t_fit:.3f} s (driven) and {t_var:.3f} s "
        f"(again), without {t_plain:.3f} s (variances add {t_var - t_plain:.3f} s); "
        f"feature stats {t_stats:.4f} s")

    # the offsets each coordinate's last update saw: the fixed effect (first
    # in the sweep) the per-user model of sweep 1; the per-user coordinate
    # the final fixed model
    one = GameEstimator(device="cuda", normalization=norms).fit(
        data, [_norm_var_config(False, num_iters=1)])[0]
    off_fixed = one.model["per-user"].score(data, device="cuda").double()
    off_user = res.model["fixed"].score(data, device="cuda").double()
    l2 = 1.0
    v_user = torch.as_tensor(res.model["per-user"].variances, device="cuda")
    positive = bool(torch.isfinite(v_user).all()) and bool((v_user > 0).all())
    e_fixed, e_unshifted = _fixed_simple_variance_err(res, xg, norms["g"], off_fixed, l2)
    e_user = _user_full_variance_err(res, xu, host["uids"], norms["u"], off_user, l2)
    intercept_var = float(res.model["fixed"].coefficients.variances[NORM_VAR_II])
    ok = (positive and e_fixed <= VARIANCE_F32_RTOL and e_user <= VARIANCE_F32_RTOL
          and e_unshifted > 100 * VARIANCE_F32_RTOL)
    log(f"glmix2-norm-var variances: fixed SIMPLE vs float64 recomputation, every "
        f"feature but the intercept, max rel diff {e_fixed:.2e} (a diagonal without the "
        f"shift terms would read {e_unshifted:.2e}; must exceed "
        f"{100 * VARIANCE_F32_RTOL:g}); the intercept's mapped "
        f"entry {intercept_var:.6e}; per-user FULL {tuple(v_user.shape)} finite and "
        f"positive: {positive}; {FULL_VARIANCE_ENTITIES} entities vs float64 inverse "
        f"Hessians, max rel diff {e_user:.2e} (tol {VARIANCE_F32_RTOL:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("glmix2-norm-var: the variances are wrong")
    var_ms = _time_norm_var_variances(res, host, xg, xu, norms, off_fixed, off_user, l2)
    stats["glmix2_norm_var"].update(fit_plain_s=t_plain, fit_var_again_s=t_var,
                                    stats_s=t_stats, bayes_auc=bayes, fixed_var_err=e_fixed,
                                    fixed_var_unshifted_err=e_unshifted,
                                    user_var_err=e_user, **var_ms)


def _time_norm_var_variances(res, host, xg, xu, norms, off_fixed, off_user, l2) -> dict:
    """CUDA-event times of one update's variance computations at
    glmix2-norm-var's published optimum: the fixed effect's SIMPLE diagonal
    (``compute_variances``) and the per-user FULL variances of the one
    [2048, 256, 16] bucket (``compute_variances`` over a ``LaneObjective``), each warm."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.core.batch import DenseBatch
    from photon_ml_tpu_torch.core.losses import logistic_loss
    from photon_ml_tpu_torch.core.objective import GLMObjective, LaneObjective
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.opt.solve import compute_variances
    from photon_ml_tpu_torch.types import VarianceComputationType as Var

    y = torch.as_tensor(host["y"], device="cuda")
    ctx_g, ctx_u = norms["g"], norms["u"]
    w_g = ctx_g.model_to_transformed_space(
        torch.as_tensor(res.model["fixed"].coefficients.means, device="cuda"), NORM_VAR_II)
    obj = GLMObjective(loss=logistic_loss, reg=Regularization(l2=l2), norm=ctx_g)
    batch = DenseBatch(x=xg, y=y, offset=off_fixed.float(), weight=torch.ones_like(y))
    fixed_ms = cuda_ms(lambda: compute_variances(obj, w_g, batch, Var.SIMPLE), 10)

    model = res.model["per-user"]
    order = torch.as_tensor(np.argsort(host["uids"], kind="stable"), device="cuda")
    users = len(model.slot_of)
    lanes = lambda t: t[order].reshape(users, -1, *t.shape[1:])
    ids = np.unique(host["uids"])
    w_u = ctx_u.model_to_transformed_space(torch.as_tensor(
        model.w_stack[[model.slot_of[int(e)] for e in ids]], device="cuda"), None)
    lane_batch = DenseBatch(x=lanes(xu), y=lanes(y), offset=lanes(off_user.float()),
                            weight=torch.ones_like(lanes(y)))
    lobj = LaneObjective(logistic_loss, torch.full((users,), l2, device="cuda"), ctx_u)
    user_ms = cuda_ms(lambda: compute_variances(lobj, w_u, lane_batch, Var.FULL), 10)
    log(f"glmix2-norm-var variance computations, one update, warm (CUDA events): fixed "
        f"SIMPLE over [{xg.shape[0]}, {xg.shape[1]}] {fixed_ms:.4f} ms; per-user FULL over "
        f"{tuple(lane_batch.x.shape)} {user_ms:.4f} ms")
    return dict(fixed_var_ms=fixed_ms, user_var_ms=user_ms)


def phase_norm_var_card_vs_cpu(stats: dict, glmix_chip_reduced):
    """Card against CPU, normalization and variances: (a) glmix2-norm-var at
    REDUCED_GLMIX2_SCALE; (b) sparse1m at full width, SCALE_WITH_MAX_MAGNITUDE
    from its sparse stats and SIMPLE variances; (c) glmix_chip at
    REDUCED_USERS, SIMPLE variances on both coordinates (per-user on the SoA
    path); (d) glmix_sparse at full width, SIMPLE variances on the compact
    per-user coordinate."""
    import torch

    from photon_ml_tpu_torch.core.normalization import (build_normalization,
                                                        compute_feature_stats_sparse)
    from photon_ml_tpu_torch.data.synthetic import (synth_glmix, synth_glmix_sparse,
                                                    synth_sparse1m)
    from photon_ml_tpu_torch.game import GameData, GameEstimator, SparseShard
    from photon_ml_tpu_torch.types import NormalizationType

    # (a)
    t0 = time.perf_counter()
    host = _with_intercept(synth_glmix(REDUCED_GLMIX2_SCALE, three=False))
    gpu, xg, xu = _norm_var_data(host, "cuda")
    cpu, xg_c, xu_c = _norm_var_data(host, "cpu")
    norm_gpu, _ = _norm_var_contexts(xg, xu)
    norm_cpu, _ = _norm_var_contexts(xg_c, xu_c)
    _compare_fits(f"glmix2-norm-var at scale {REDUCED_GLMIX2_SCALE} ({gpu.num_samples} "
                  "rows)", gpu, cpu, _norm_var_config(), ["per-user"],
                  norms=(norm_gpu, norm_cpu), path="glmix2_norm_var_reduced", stats=stats,
                  required=("fused_value_and_grad", "fused_hvp"))
    stats["card_vs_cpu_a_s"] = time.perf_counter() - t0

    # (b)
    t0 = time.perf_counter()
    host = synth_sparse1m(1)
    data = GameData(y=host["y"], features={"g": SparseShard(
        indices=host["indices"], values=host["values"], dim=host["dim"])})
    t1 = time.perf_counter()
    ctx = build_normalization(NormalizationType.SCALE_WITH_MAX_MAGNITUDE,
                              compute_feature_stats_sparse(host["indices"], host["values"],
                                                           host["dim"]))
    t_stats = time.perf_counter() - t1
    cfg = _sparse1m_config("simple")
    fits = {}
    for where, device in (("card", "cuda"), ("card again", "cuda"), ("cpu", "cpu")):
        kernels = _zero_launches()
        t1 = time.perf_counter()
        fits[where] = GameEstimator(device=device, normalization={"g": ctx}).fit(
            data, [cfg])[0].model["fixed"].coefficients
        if where == "card":
            torch.cuda.synchronize()
            _record_launches("sparse1m_norm_var", kernels, stats, ())
            t_card = time.perf_counter() - t1
    c, again, p = fits["card"], fits["card again"], fits["cpu"]
    repeatable = (torch.equal(torch.as_tensor(c.means), torch.as_tensor(again.means))
                  and torch.equal(torch.as_tensor(c.variances),
                                  torch.as_tensor(again.variances)))
    obj = {k: _poisson_objective(fits[k].means, host, "cuda", ctx) for k in ("card", "cpu")}
    obj0 = _poisson_objective(torch.zeros(host["dim"]), host, "cuda", ctx)
    o_err = abs(obj["card"] - obj["cpu"]) / abs(obj["cpu"])
    errs = {"coefficients": rel_err(c.means, p.means),
            "variances": rel_err(c.variances, p.variances)}
    ok = (obj["card"] < obj0 and o_err <= SPARSE1M_OBJ_RTOL and repeatable
          and max(errs.values()) <= F32_PATH_RTOL
          and bool(torch.isfinite(torch.as_tensor(c.variances)).all()))
    log(f"card vs CPU, sparse1m-norm-var at full width: sparse feature stats on the host "
        f"{t_stats:.2f} s; card fit {t_card:.2f} s; objective {obj['card']:.6f} vs "
        f"{obj['cpu']:.6f} (w = 0: {obj0:.6f}), rel diff {o_err:.2e} (tol "
        f"{SPARSE1M_OBJ_RTOL:g}); max rel diff " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {F32_PATH_RTOL:g}); a "
        f"second card fit {'bitwise equal' if repeatable else 'NOT BITWISE EQUAL'} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("sparse1m-norm-var: the card fit is wrong or disagrees with "
                             "the CPU")
    stats["card_vs_cpu_b_s"] = time.perf_counter() - t0

    # (c)
    t0 = time.perf_counter()
    label, gpu, cpu = glmix_chip_reduced
    _compare_fits(label + ", SIMPLE variances", gpu, cpu, _glmix_config(variance="simple"),
                  ["per-user"], path="glmix_chip_var_reduced", stats=stats,
                  required=("fused_value_and_grad", "newton_step"))
    stats["card_vs_cpu_c_s"] = time.perf_counter() - t0

    # (d)
    t0 = time.perf_counter()
    data = _glmix_sparse_data(synth_glmix_sparse(1))

    def refuses_compact(res):
        try:
            res.model["per-user"].to_compact()
        except ValueError as e:
            log(f"glmix_sparse-var: to_compact refused the per-user model with variances "
                f"{res.model['per-user'].variances.shape} ({e}); scoring is dense")
        else:
            raise AssertionError("glmix_sparse-var: to_compact kept a model with variances")

    _compare_fits(f"glmix_sparse-var at full width ({data.num_samples} rows)", data, data,
                  _glmix_sparse_config(user_variance="simple"), ["per-user"],
                  path="glmix_sparse_var", stats=stats, check_card=refuses_compact)
    stats["card_vs_cpu_d_s"] = time.perf_counter() - t0


def _choose_l1(label, choices, zero_share):
    """The smallest L1 weight of ``choices`` whose scale-L1_CHOICE_SCALE CPU
    fit zeroes a share of the coefficients inside ZERO_SHARE_RANGE
    (``zero_share(l1)`` fits and returns that share)."""
    lo, hi = ZERO_SHARE_RANGE
    shares = {}
    t0 = time.perf_counter()
    for l1 in choices:
        shares[l1] = zero_share(l1)
        if lo <= shares[l1] <= hi:
            log(f"{label}: L1 {l1:g} chosen from {choices} by CPU fits at scale "
                f"{L1_CHOICE_SCALE} (zero shares " + ", ".join(
                    f"{k:g}: {v:.4f}" for k, v in shares.items())
                + f"; {time.perf_counter() - t0:.2f} s)")
            return l1, shares
    raise AssertionError(f"{label}: no L1 weight of {choices} zeroes {lo:.0%}-{hi:.0%} of "
                         f"the coefficients at scale {L1_CHOICE_SCALE} ({shares})")


def _gsn_config(l1, num_iters=2):
    """glmix_sparse-norm-en: ``_glmix_sparse_config``'s fixed effect (TRON)
    and the per-user coordinate under L-BFGS with elastic net (L2 1.0, L1
    ``l1``: OWLQN on the compact lanes), its intercept column GSN_II."""
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(
                              feature_shard="g", optimizer=OptimizerType.TRON,
                              solver=SolverConfig.tron_default(),
                              reg=Regularization(l2=1.0)),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u",
                              solver=SolverConfig(max_iters=30, tolerance=1e-7),
                              reg=Regularization(l1=l1, l2=1.0), intercept_index=GSN_II)})


def _gsn_context(host):
    """STANDARDIZATION of the per-user shard from its sparse feature stats
    (the intercept keeps factor 1 and shift 0)."""
    from photon_ml_tpu_torch.core.normalization import (build_normalization,
                                                        compute_feature_stats_sparse)
    from photon_ml_tpu_torch.types import NormalizationType

    u = host["user"]
    return build_normalization(NormalizationType.STANDARDIZATION, compute_feature_stats_sparse(
        u["indices"], u["values"], u["dim"], intercept_index=GSN_II))


class _ObservedPairs:
    """The (entity, column) pairs of the per-user shard's nonzero values, in
    a model's slots: ``ps`` / ``pc`` [P] the pairs' slots and columns,
    ``pair`` [n, k] each value's pair (0 where ``nz`` is False), ``slots``
    [n] each row's slot."""

    def __init__(self, host, slot_of):
        import numpy as np

        from photon_ml_tpu_torch.parallel.bucketing import slots_from

        u = host["user"]
        dim = u["dim"]
        self.slots = slots_from(slot_of, host["uids"]).astype(np.int64)
        self.nz = u["values"] != 0
        keys = self.slots[:, None] * dim + u["indices"]
        uniq = np.unique(keys[self.nz])
        self.pair = np.where(self.nz, np.searchsorted(uniq, keys), 0)
        self.ps, self.pc = uniq // dim, uniq % dim
        self.num_entities = len(slot_of)
        self.values = u["values"].astype(np.float64)
        self.intercept = self.pc == GSN_II

    def transformed(self, w_stack, ctx):
        """(w', fold): the per-user coefficients at the pairs mapped back to
        the solve space in float64 (w'_j = w_j / f_j, and each intercept
        w'_ii = w_ii + Σ_j w_j·s_j over its entity's observed columns), and
        each entity's fold Σ_j w_j·s_j."""
        import numpy as np

        f, sh = (ctx.factors.double().cpu().numpy(), ctx.shifts.double().cpu().numpy())
        w = np.asarray(w_stack, np.float64)[self.ps, self.pc]
        fold = np.bincount(self.ps, weights=w * sh[self.pc], minlength=self.num_entities)
        wt = w / f[self.pc]
        wt[self.intercept] += fold[self.ps[self.intercept]]
        return wt, fold

    def pseudo_gradient(self, wt, ctx, y, offsets, l1, l2):
        """The float64 pseudo-gradient at the pairs of the per-user objective
        Σ logloss(Σ_j w'_j f_j (x_j - s_j) + offset) + l2/2·||w'||² + l1·||w'||₁,
        recomputed from the raw rows."""
        import numpy as np
        import torch

        from photon_ml_tpu_torch.opt.lbfgs import pseudo_gradient

        f = ctx.factors.double().cpu().numpy()[self.pc]
        sh = ctx.shifts.double().cpu().numpy()[self.pc]
        eff = wt * f
        margin_shift = np.bincount(self.ps, weights=eff * sh, minlength=self.num_entities)
        z = (offsets + np.where(self.nz, eff[self.pair] * self.values, 0.0).sum(axis=1)
             - margin_shift[self.slots])
        r = torch.sigmoid(torch.from_numpy(z)).numpy() - np.asarray(y, np.float64)
        gx = np.bincount(self.pair[self.nz], weights=(r[:, None] * self.values)[self.nz],
                         minlength=len(wt))
        rsum = np.bincount(self.slots, weights=r, minlength=self.num_entities)
        g = f * (gx - sh * rsum[self.ps]) + l2 * wt
        return pseudo_gradient(torch.from_numpy(wt), torch.from_numpy(g), l1).numpy()


def _sparse_scores_f64(w, shard):
    """A fixed model's float64 scores over a sparse shard, on the host."""
    import numpy as np

    return (np.asarray(shard["values"], np.float64)
            * np.asarray(w, np.float64)[shard["indices"]]).sum(axis=1)


def phase_glmix_sparse_norm_en(stats: dict):
    """glmix_sparse-norm-en at full width: per-lane STANDARDIZATION contexts
    on compact lanes under elastic net (the lane OWLQN), ``to_compact`` and
    scoring through ``match_dot``; then (b) per-lane contexts whose shifts
    are large, on the card and the CPU."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.data.synthetic import synth_glmix_sparse_norm
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.game.coordinate import build_coordinate
    from photon_ml_tpu_torch.models.game import GameModel

    t0 = time.perf_counter()
    host = synth_glmix_sparse_norm(1)
    data = _glmix_sparse_data(host)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = _gsn_context(host)
    t_stats = time.perf_counter() - t0
    observed = ctx.factors[:GSN_II] != 1.0
    log(f"glmix_sparse-norm-en data: {data.num_samples} rows, per-user shard "
        f"{host['user']['indices'].shape[1]} of {host['user']['dim']} columns (intercept "
        f"{GSN_II}); generated on the host in {t_data:.2f} s; sparse feature stats "
        f"{t_stats:.2f} s; STANDARDIZATION factors of the observed columns in "
        f"[{float(ctx.factors[:GSN_II][observed].min()):.2f}, "
        f"{float(ctx.factors[:GSN_II][observed].max()):.2f}], max |shift| "
        f"{float(ctx.shifts.abs().max()):.2e}")

    small = synth_glmix_sparse_norm(L1_CHOICE_SCALE)
    small_data, small_ctx = _glmix_sparse_data(small), _gsn_context(small)

    def zero_share(l1):
        res = GameEstimator(device="cpu", normalization={"u": small_ctx}).fit(
            small_data, [_gsn_config(l1)])[0]
        pairs = _ObservedPairs(small, res.model["per-user"].slot_of)
        wt, _ = pairs.transformed(res.model["per-user"].w_stack, small_ctx)
        return float((wt[~pairs.intercept] == 0).mean())

    l1, shares = _choose_l1("glmix_sparse-norm-en per-user", GSN_L1_CHOICES, zero_share)
    cfg = _gsn_config(l1)
    l2 = 1.0

    kernels = _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = GameEstimator(device="cuda", normalization={"u": ctx}, fused=False).fit(
        data, [cfg])[0]
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    dense_re = res.model["per-user"]
    t0 = time.perf_counter()
    compact = dense_re.to_compact()
    t_compact = time.perf_counter() - t0
    scores = GameModel(models={"fixed": res.model["fixed"], "per-user": compact}).score(
        data, device="cuda")
    launches = _record_launches("glmix_sparse_norm_en", kernels, stats, ("match_dot",))
    peak = torch.cuda.max_memory_allocated() / 1e9
    upd = ", ".join(f"it{st['iteration']} {st['coordinate']} {st['seconds']:.3f} s "
                    f"({st['solver_iterations']} iterations)" for st in res.history.steps)
    t_upd = sum(st["seconds"] for st in res.history.steps)
    log(f"glmix_sparse-norm-en: fit {t_fit:.2f} s (coordinates built, bucketing and the "
        f"per-lane contexts included, in {t_fit - t_upd:.2f} s; updates {upd}), "
        f"to_compact {t_compact:.2f} s (k_model {compact.indices.shape[1]}), launches "
        f"{launches}, peak device memory {peak:.2f} GB")
    if not bool(torch.isfinite(scores).all()) or scores.shape != (data.num_samples,):
        raise AssertionError("glmix_sparse-norm-en scores are not finite of shape [n]")
    _, _, err = _check_compact("glmix_sparse-norm-en", data, dense_re, compact,
                               host["user"])
    stats["match_dot"]["max_abs_err"] = max(stats["match_dot"]["max_abs_err"], err)

    pairs = _ObservedPairs(host, dense_re.slot_of)
    wt, fold = pairs.transformed(dense_re.w_stack, ctx)
    share = float((wt[~pairs.intercept] == 0).mean())
    w_fixed = res.model["fixed"].coefficients.means
    penalty = float(0.5 * l2 * (wt * wt).sum() + l1 * np.abs(wt).sum())
    f_full = _logistic_objective(scores, data, [(l2, w_fixed)]) + penalty
    f_fixed = _logistic_objective(res.model["fixed"].score(data, device="cuda"), data,
                                  [(l2, w_fixed)])
    offsets = _sparse_scores_f64(w_fixed, host["fixed"])
    pg = pairs.pseudo_gradient(wt, ctx, host["y"], offsets, l1, l2)
    pg0 = pairs.pseudo_gradient(np.zeros_like(wt), ctx, host["y"], offsets, l1, l2)
    ratio = float(np.linalg.norm(pg) / np.linalg.norm(pg0))
    lane = lambda v: np.sqrt(np.bincount(pairs.ps, weights=v * v,
                                         minlength=pairs.num_entities))
    lanes0 = lane(pg0)
    worst = float((lane(pg) / np.where(lanes0 > 0, lanes0, 1.0)).max())
    w_max = float(np.abs(dense_re.w_stack).max())
    lo, hi = ZERO_SHARE_RANGE
    ok = lo <= share <= hi and f_full < f_fixed and ratio <= STATIONARY_RATIO
    log(f"glmix_sparse-norm-en gates: zero share of the {int((~pairs.intercept).sum())} "
        f"observed per-user coefficients {share:.4f} (in [{lo}, {hi}]); objective with the "
        f"L1 term {f_full:.6f} through match_dot < fixed effect alone {f_fixed:.6f}; "
        f"float64 pseudo-gradient norm at the fit / at w = 0 {ratio:.3e} (tol "
        f"{STATIONARY_RATIO:g}; worst lane {worst:.3e}); the intercept fold "
        f"max |Σ w_j·s_j| {float(np.abs(fold).max()):.3e}, {float(np.abs(fold).max()) / w_max:.2e} "
        f"of the largest coefficient {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("glmix_sparse-norm-en: a gate failed")

    # the same fit on the CPU, in float32 and, where the coefficients are
    # determined, in float64 on both devices
    on_card = lambda a: torch.as_tensor(a, device="cuda")
    per_column = np.bincount(pairs.pc, minlength=GSN_II + 1)[:GSN_II]
    rows = np.bincount(host["user"]["indices"][pairs.nz], minlength=GSN_II + 1)[:GSN_II]
    density = float(np.median(rows[per_column > 0])) / data.num_samples

    def fit(device, dtype, d=data):
        t0 = time.perf_counter()
        r = GameEstimator(device=device, dtype=dtype, normalization={"u": ctx}).fit(
            d, [cfg])[0]
        return r, time.perf_counter() - t0

    def objective(r):
        wt_r, _ = pairs.transformed(r.model["per-user"].w_stack, ctx)
        w_f = r.model["fixed"].coefficients.means
        return (_logistic_objective(r.model.score(data, device="cuda"), data, [(l2, w_f)])
                + float(0.5 * l2 * (wt_r * wt_r).sum() + l1 * np.abs(wt_r).sum())), wt_r

    def compare(a, b):
        if a.model["per-user"].slot_of != b.model["per-user"].slot_of:
            raise AssertionError("glmix_sparse-norm-en: the fits have different entities")
        (fa, wta), (fb, wtb) = objective(a), objective(b)
        errs = {"fixed": rel_err(a.model["fixed"].coefficients.means,
                                 b.model["fixed"].coefficients.means),
                "per-user": rel_err(on_card(a.model["per-user"].w_stack),
                                    on_card(b.model["per-user"].w_stack))}
        return errs, abs(fa - fb) / abs(fb), int(((wta == 0) != (wtb == 0)).sum()), fa, fb

    rc, t_cpu = fit("cpu", torch.float32)
    errs32, o_err, zero_diff, f_card, f_cpu = compare(res, rc)
    # the float32 coefficients' own spread: CPU fits of the same rows with
    # every per-user value moved by about one float32 ulp, one per seed
    spreads = []
    for seed in F32_SPREAD_SEEDS:
        values = host["user"]["values"]
        values = values * (1 + np.float32(2 ** -23) * np.random.default_rng(seed).choice(
            np.float32([-1, 1]), values.shape))
        nudged = dict(host, user=dict(host["user"], values=values))
        spreads.append(compare(fit("cpu", torch.float32, _glmix_sparse_data(nudged))[0],
                               rc)[0])
    # each quantity within F32_PATH_RTOL, or F32_SPREAD_MULTIPLE x its
    # largest nudged spread where larger
    tol32 = {k: max(F32_PATH_RTOL, F32_SPREAD_MULTIPLE * max(sp[k] for sp in spreads))
             for k in errs32}
    # the per-user coordinate alone in float64, card against CPU: one update
    # from zero and one warm-started from the card's model, both with the
    # card fit's final fixed-effect scores as offsets
    coord64 = {}
    for where, device in (("card", "cuda"), ("host", "cpu")):
        t0 = time.perf_counter()
        c = build_coordinate("per-user", data, cfg.coordinates["per-user"], cfg.task,
                             dtype=torch.float64, device=device, norm=ctx)
        off = torch.as_tensor(offsets, device=device)
        cold, _ = c.update(off)
        warm, _ = c.update(-off, init=dense_re)
        coord64[where] = (cold, warm, time.perf_counter() - t0)
    errs64 = {}
    for k, name in enumerate(("cold", "warm")):
        a, b = coord64["card"][k], coord64["host"][k]
        errs64[name] = rel_err(on_card(a.w_stack), on_card(b.w_stack))
        za, zb = (pairs.transformed(m.w_stack, ctx)[0] == 0 for m in (a, b))
        errs64[name + " zero-set flips"] = int((za != zb).sum())
    # a publish without the per-lane fold: each intercept keeps w'_ii
    unfolded = np.array(dense_re.w_stack, np.float64)
    unfolded[:, GSN_II] += fold
    e_unfolded = rel_err(on_card(unfolded), on_card(rc.model["per-user"].w_stack))
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())
    ok = (o_err <= F32_OBJECTIVE_RTOL and errs64["cold"] <= F64_COORD_RTOL
          and errs64["warm"] <= F64_COORD_RTOL
          and all(errs32[k] <= tol32[k] for k in errs32))
    log(f"card vs CPU, glmix_sparse-norm-en at full width: float32 CPU fit {t_cpu:.2f} s; "
        f"objective {f_card:.6f} vs {f_cpu:.6f}, rel diff {o_err:.2e} (tol "
        f"{F32_OBJECTIVE_RTOL:g}); coefficients max rel diff {fmt(errs32)} (tol "
        f"{fmt(tol32)}: "
        f"{F32_SPREAD_MULTIPLE:g} x the largest of the float32 CPU fit's own spreads under "
        f"one-ulp nudges of the per-user values, seeds {F32_SPREAD_SEEDS}: "
        + "; ".join(fmt(sp) for sp in spreads)
        + f". Standardizing columns nonzero in a median {density:.2e} of the rows gives "
        f"factors up to {float(ctx.factors.max()):.0f}, so rounding moves the published "
        f"coefficients by percents while the objective holds); zero sets differ at "
        f"{zero_diff} of {len(wt)}. The per-user coordinate "
        f"alone in float64, same offsets (card {coord64['card'][2]:.2f} s, CPU "
        f"{coord64['host'][2]:.2f} s): max rel diff "
        + ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in errs64.items())
        + f" (tol {F64_COORD_RTOL:g}). A publish without the fold would read "
        f"{e_unfolded:.2e} against the float32 CPU fit (the fold is "
        f"{float(np.abs(fold).max()) / w_max:.2e} of the largest coefficient: the shifts "
        f"are column means over all rows; phase 17(b) shows the fold where they are "
        f"large) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("glmix_sparse-norm-en: card and CPU disagree beyond the "
                             "tolerance")
    stats["glmix_sparse_norm_en"] = dict(
        fit_s=t_fit, build_s=t_fit - t_upd, to_compact_s=t_compact, cpu_fit_s=t_cpu,
        stats_s=t_stats, l1=l1, l1_zero_shares=shares, zero_share=share,
        objective=f_full, objective_fixed_only=f_fixed, pseudo_grad_ratio=ratio,
        fold_rel=float(np.abs(fold).max()) / w_max, card_vs_cpu_f32=errs32,
        f32_spreads=spreads, objective_rel=o_err, zero_set_diff=zero_diff,
        coordinate_f64=errs64, unfolded_rel=e_unfolded, peak_gb=peak)
    del data, res, rc, compact, scores, coord64
    torch.cuda.empty_cache()
    phase_fold_card_vs_cpu(stats)


def _fold_host(scale: int) -> dict:
    """glmix2's data with a per-user shard whose contexts are far from the
    identity: column j becomes xu_j·b_j + c_j (b log-uniform in [1/2, 2], c
    uniform in [1, 3], seed FOLD_SEED), each user leaves ~15% of its columns
    unobserved (zero in all its rows), and a column of ones is appended as
    the intercept (index 16)."""
    import numpy as np

    from photon_ml_tpu_torch.data.synthetic import synth_glmix

    host = synth_glmix(scale, three=False)
    rng = np.random.default_rng(FOLD_SEED)
    d_u = host["xu"].shape[1]
    b = np.exp(rng.uniform(-np.log(2.0), np.log(2.0), d_u)).astype(np.float32)
    c = rng.uniform(1.0, 3.0, d_u).astype(np.float32)
    dropped = rng.random((int(host["uids"].max()) + 1, d_u)) < 0.15
    xu = (host["xu"] * b + c) * ~dropped[host["uids"]]
    xu = np.concatenate([xu, np.ones((len(xu), 1), np.float32)], axis=1)
    return dict(host, xu=xu.astype(np.float32))


def phase_fold_card_vs_cpu(stats: dict):
    """17(b): per-lane STANDARDIZATION contexts under INDEX_MAP on a dense
    per-user shard whose shifts are large (``_fold_host`` at scale
    REDUCED_GLMIX2_SCALE), elastic net, card against CPU; a publish without
    the per-lane intercept fold must fail that comparison by more than its
    tolerance."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.core.normalization import (build_normalization,
                                                        compute_feature_stats)
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import NormalizationType, ProjectorType, TaskType

    host = _fold_host(REDUCED_GLMIX2_SCALE)
    ii = host["xu"].shape[1] - 1
    s = SolverConfig(max_iters=30, tolerance=1e-7)
    cfg = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
        "fixed": FixedEffectConfig(feature_shard="g", solver=s, reg=Regularization(l2=1.0)),
        "per-user": RandomEffectConfig(
            random_effect_type="userId", feature_shard="u", solver=s,
            reg=Regularization(l1=1.0, l2=1.0), projector=ProjectorType.INDEX_MAP,
            intercept_index=ii)})
    norms = []
    for device in ("cuda", "cpu"):
        xu = torch.as_tensor(host["xu"], device=device)
        norms.append({"u": build_normalization(NormalizationType.STANDARDIZATION,
                                               compute_feature_stats(xu, intercept_index=ii))})
    data = _baseline_data(host)
    label = (f"fold check, glmix2 per-user shard shifted, INDEX_MAP, STANDARDIZATION, "
             f"elastic net, at scale {REDUCED_GLMIX2_SCALE} ({data.num_samples} rows)")
    spreads, tol = [], {}

    def spread_tols(rc, sc):
        # the comparison's own float32 spread: CPU fits of the same rows with
        # every per-user value moved by about one ulp, one per seed; each
        # quantity within F32_PATH_RTOL, or F32_SPREAD_MULTIPLE x its largest
        # spread where larger, as in phase 17
        for seed in F32_SPREAD_SEEDS:
            xu = host["xu"] * (1 + np.float32(2 ** -23) * np.random.default_rng(seed).choice(
                np.float32([-1, 1]), host["xu"].shape))
            rn, sn, _, _, _ = _fit_and_score(_baseline_data(dict(host, xu=xu)), "cpu", cfg,
                                             norms[1])
            sp = _model_errors(label, rn.model, rc.model, ["per-user"])
            sp["scores"] = rel_err(sn, sc)
            spreads.append(sp)
        tol.update({k: max(F32_PATH_RTOL, F32_SPREAD_MULTIPLE * max(sp[k] for sp in spreads))
                    for k in spreads[0]})
        log(f"fold check: the float32 CPU fit's own spread under one-ulp nudges of the "
            f"per-user values, seeds {F32_SPREAD_SEEDS}: "
            + "; ".join(", ".join(f"{k} {v:.2e}" for k, v in sp.items()) for sp in spreads))
        return tol

    rg, rc = _compare_fits(label, data, data, cfg, ["per-user"], norms=tuple(norms),
                           path="fold_reduced", stats=stats,
                           required=("fused_value_and_grad",), tols=spread_tols)
    shifts = norms[1]["u"].shifts.double().numpy()
    w = np.asarray(rg.model["per-user"].w_stack, np.float64)
    unfolded = w.copy()
    unfolded[:, ii] += w @ shifts  # unobserved columns publish 0
    e_unfolded = rel_err(unfolded, rc.model["per-user"].w_stack)
    ok = e_unfolded > tol["per-user"]
    log(f"fold check: max |shift| {float(np.abs(shifts).max()):.3f}; a publish without the "
        f"per-lane intercept fold reads rel diff {e_unfolded:.2e} against the CPU fit, "
        f"{e_unfolded / tol['per-user']:.1f}x the per-user tolerance "
        f"{tol['per-user']:.2e} (must exceed it) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("fold check: the card-vs-CPU comparison cannot see the fold")
    stats["fold_reduced"] = dict(unfolded_rel=e_unfolded, f32_spreads=spreads, tol=tol)


def _en_box_config(l1, num_iters=2):
    """glmix2-en-box: glmix2-norm-var's coordinates under L-BFGS with
    variances NONE; the fixed effect with elastic net (L2 1.0, L1 ``l1``:
    OWLQN as one lane over the fused kernel), the per-user coefficients of
    features 0..EN_BOX_FEATURES-1 bounded to [0, inf)."""
    from photon_ml_tpu_torch.core.regularization import Regularization
    from photon_ml_tpu_torch.game import FixedEffectConfig, GameConfig, RandomEffectConfig
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import TaskType

    s = SolverConfig(max_iters=30, tolerance=1e-7)
    box = tuple((j, 0.0, float("inf")) for j in range(EN_BOX_FEATURES))
    return GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=num_iters,
                      coordinates={
                          "fixed": FixedEffectConfig(
                              feature_shard="g", solver=s,
                              reg=Regularization(l1=l1, l2=1.0), intercept_index=NORM_VAR_II),
                          "per-user": RandomEffectConfig(
                              random_effect_type="userId", feature_shard="u", solver=s,
                              reg=Regularization(l2=1.0), constraints=box)})


def _fixed_pseudo_gradient_ratio(w_pub, xg, ctx, offsets, y, l1: float, l2: float) -> float:
    """The fixed effect's float64 pseudo-gradient norm at its transformed
    optimum (``model_to_transformed_space`` of the published means) over its
    norm at w' = 0, recomputed on the card from the raw design."""
    import torch

    from photon_ml_tpu_torch.opt.lbfgs import pseudo_gradient

    x = xg.double()
    f, s = ctx.factors.double(), ctx.shifts.double()
    wt = type(ctx)(factors=f, shifts=s).model_to_transformed_space(
        torch.as_tensor(w_pub, device="cuda").double(), NORM_VAR_II)

    def norm(w):
        eff = w * f
        z = x @ eff - (eff * s).sum() + offsets
        r = torch.sigmoid(z) - y
        g = f * (x.T @ r - r.sum() * s) + l2 * w
        return torch.linalg.vector_norm(pseudo_gradient(w, g, l1))

    return float(norm(wt) / norm(torch.zeros_like(wt)))


def _user_projected_gradient_ratio(w_stack, xu, uids, ctx, offsets, y, l2: float) -> float:
    """The per-user lanes' float64 projected-gradient norm ||w' - clip(w' -
    g, lo, hi)|| at their transformed optimum (w' = w / f) over its norm at
    w' = 0, recomputed on the card from the raw rows; lo = 0 on the bounded
    features (0 / f), -inf elsewhere."""
    import torch

    x = xu.double()
    f = ctx.factors.double()
    slot = torch.as_tensor(uids, device="cuda").long()
    wt = torch.as_tensor(w_stack, device="cuda").double() / f
    lo = torch.full_like(f, -float("inf"))
    lo[:EN_BOX_FEATURES] = 0.0

    def residual(w):
        z = (x * (w * f)[slot]).sum(dim=1) + offsets
        r = torch.sigmoid(z) - y
        g = f * torch.zeros_like(w).index_add_(0, slot, r[:, None] * x) + l2 * w
        return torch.linalg.vector_norm(w - torch.clamp(w - g, min=lo))

    return float(residual(wt) / residual(torch.zeros_like(wt)))


def phase_glmix2_en_box(stats: dict):
    """glmix2-en-box at full width: OWLQN on the fixed effect through the
    fused kernel with shifts, the box-constrained lane L-BFGS on the
    per-user coordinate; then scale REDUCED_GLMIX2_SCALE on card and CPU."""
    import torch

    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.game import GameEstimator

    t0 = time.perf_counter()
    host = _with_intercept(synth_glmix(1, three=False))
    data, xg, xu = _norm_var_data(host, "cuda")
    norms, _ = _norm_var_contexts(xg, xu)
    log(f"glmix2-en-box data: glmix2-norm-var's rows and contexts, generated in "
        f"{time.perf_counter() - t0:.2f} s")

    small = _with_intercept(synth_glmix(L1_CHOICE_SCALE, three=False))
    small_data, sxg, sxu = _norm_var_data(small, "cpu")
    small_norms, _ = _norm_var_contexts(sxg, sxu)

    def zero_share(l1):
        res = GameEstimator(device="cpu", normalization=small_norms).fit(
            small_data, [_en_box_config(l1)])[0]
        return float((res.model["fixed"].coefficients.means[:NORM_VAR_II] == 0).mean())

    l1, shares = _choose_l1("glmix2-en-box fixed effect", EN_BOX_L1_CHOICES, zero_share)
    cfg = _en_box_config(l1)
    l2 = 1.0
    res, scores, auc = _drive("glmix2_en_box", data, cfg, stats,
                              required=("fused_value_and_grad",), normalization=norms)
    bayes = _bayes_auc(host)
    _check_bayes("glmix2_en_box", auc, bayes)

    w_fixed = res.model["fixed"].coefficients.means
    w_user = res.model["per-user"].w_stack
    f_u = norms["u"].factors.cpu().numpy()
    bounded = w_user[:, :EN_BOX_FEATURES]
    worst = float((bounded / f_u[:EN_BOX_FEATURES]).min())
    at_bound = float((bounded == 0).mean())
    fixed_zero = float((w_fixed[:NORM_VAR_II] == 0).mean())
    # the offsets of each coordinate's last update: the fixed effect's come
    # from the per-user model of sweep 1, the per-user's from the final fixed
    one = GameEstimator(device="cuda", normalization=norms).fit(
        data, [_en_box_config(l1, num_iters=1)])[0]
    y = torch.as_tensor(host["y"], device="cuda").double()
    off_fixed = one.model["per-user"].score(data, device="cuda").double()
    off_user = res.model["fixed"].score(data, device="cuda").double()
    r_fixed = _fixed_pseudo_gradient_ratio(w_fixed, xg, norms["g"], off_fixed, y, l1, l2)
    r_user = _user_projected_gradient_ratio(w_user, xu, host["uids"], norms["u"], off_user,
                                            y, l2)
    ok = (worst >= -BOX_NEG_SLACK and at_bound >= BOX_BIND_SHARE
          and r_fixed <= STATIONARY_RATIO and r_user <= STATIONARY_RATIO)
    log(f"glmix2-en-box gates: bounded per-user coefficients {bounded.shape}, least "
        f"w / f {worst:.3e} (>= -{BOX_NEG_SLACK:g}), {at_bound:.4f} at the bound 0 (>= "
        f"{BOX_BIND_SHARE}); fixed zero share {fixed_zero:.4f}; float64 norm at the fit / "
        f"at w = 0: fixed pseudo-gradient {r_fixed:.3e}, per-user projected gradient "
        f"{r_user:.3e} (tol {STATIONARY_RATIO:g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("glmix2-en-box: a gate failed")
    stats["glmix2_en_box"].update(l1=l1, l1_zero_shares=shares, bayes_auc=bayes,
                                  at_bound=at_bound, fixed_zero_share=fixed_zero,
                                  fixed_pseudo_grad_ratio=r_fixed,
                                  user_projected_grad_ratio=r_user)
    del data, xg, xu, res, one, scores
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    host = _with_intercept(synth_glmix(REDUCED_GLMIX2_SCALE, three=False))
    gpu, xg, xu = _norm_var_data(host, "cuda")
    cpu, xg_c, xu_c = _norm_var_data(host, "cpu")
    _compare_fits(f"glmix2-en-box at scale {REDUCED_GLMIX2_SCALE} ({gpu.num_samples} rows)",
                  gpu, cpu, cfg, ["per-user"],
                  norms=(_norm_var_contexts(xg, xu)[0], _norm_var_contexts(xg_c, xu_c)[0]),
                  path="glmix2_en_box_reduced", stats=stats,
                  required=("fused_value_and_grad",))
    stats["glmix2_en_box"]["card_vs_cpu_s"] = time.perf_counter() - t0


def _launches_since(kernels: dict, before: dict) -> dict:
    return {name: k.launches - before[name] for name, k in kernels.items()}


# kernel 1's launches by path under the fixed effect's scalar host-loop
# L-BFGS, which the solvers' loop form replaced (PERF.md section 6; each
# equal to the objective evaluations): the loop form evaluates as often on every path
SCALAR_LOOP_KERNEL1 = {
    "glmix_chip": 13, "glmix_chip_grid_0": 12, "glmix_chip_grid_1": 12,
    "glmix_chip_grid_2": 13, "glmix_chip_grid_3": 11, "glmix_chip_grid_4": 10,
    "glmix_chip_reg_path_1e+06": 6, "glmix_chip_reg_path_100000": 7,
    "glmix_chip_reg_path_10000": 6, "glmix_chip_reg_path_1000": 6, "glmix_chip_retrain_a": 0,
    "glmix_chip_retrain_b": 37, "glmix_chip_retrain_b_resume": 13, "glmix2_tron": 12,
    "glmix3": 11, "sparse1m": 0, "glmix_sparse": 0, "glmix_sparse_held_out": 0,
    "glmix2_norm_var": 9, "glmix2_norm_var_reduced": 11, "sparse1m_norm_var": 0,
    "glmix_chip_var_reduced": 16, "glmix_sparse_var": 0, "glmix_sparse_norm_en": 0,
    "fold_reduced": 12, "glmix2_en_box": 13, "glmix2_en_box_reduced": 12,
    "glmix_chip_bf16": 38, "glmix2_tron_bf16": 9}


def _record_path_launches(path: str, launches: dict, stats: dict, required) -> None:
    """``launches`` of one part of a main path, recorded under ``path``;
    each kernel in ``required`` must have launched; kernel 1 once an
    objective evaluation on its path, where they were counted, once an
    evaluation each fixed-effect L-BFGS solve counted itself, and as often
    as under the scalar loop (``SCALAR_LOOP_KERNEL1``)."""
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
    k1 = launches["fused_value_and_grad"]
    evals = launches.get("objective_evaluations")
    if evals is not None and k1 != evals:
        raise AssertionError(f"{path}: kernel 1 launched {k1} times for {evals} objective "
                             f"evaluations")
    solves = _check_solver_evaluations(path)
    if path in SCALAR_LOOP_KERNEL1 and k1 != SCALAR_LOOP_KERNEL1[path]:
        raise AssertionError(f"{path}: kernel 1 launched {k1} times, the scalar loop "
                             f"{SCALAR_LOOP_KERNEL1[path]}")
    stats.setdefault("lbfgs_solves_checked", {})[path] = solves
    for name, v in launches.items():
        stats.setdefault(name, {}).setdefault("launches_by_path", {})[path] = v


def _per_user_split(host, xg):
    """glmix_chip-grid's data: the last GRID_HELD_OUT_PER_USER rows of every
    user (a user's rows are contiguous) validate and the rest train, as two
    dicts of y, uids, xu, logits (host) and xg (gathered on the card)."""
    users, per = host["users"], host["per_user"]
    k = per - GRID_HELD_OUT_PER_USER
    parts = ({}, {})
    for key in ("y", "uids", "xu", "logits", "xg"):
        a = xg if key == "xg" else host[key]
        by_user = a.reshape(users, per, *a.shape[1:])
        for part, rows in zip(parts, (by_user[:, :k], by_user[:, k:])):
            part[key] = rows.reshape(-1, *a.shape[1:])  # a contiguous copy
    return parts


def _part_data(part: dict, device: str = "cuda", users=None):
    """GameData of a ``_per_user_split`` part (of its first ``users`` users
    where given), the fixed design moved to ``device``."""
    from photon_ml_tpu_torch.game import GameData

    m = len(part["y"]) if users is None else users * (len(part["y"]) // MAIN_USERS)
    return GameData(y=part["y"][:m], features={"g": part["xg"][:m].to(device),
                                               "u": part["xu"][:m]},
                    id_tags={"userId": part["uids"][:m]})


def phase_glmix_chip_grid(stats: dict, train: dict, val: dict) -> dict:
    """glmix_chip-grid at full width: one ``GameEstimator.fit`` over the grid
    of ``_grid_configs`` on ``train`` (``_per_user_split``), with validation
    on ``val`` (GRID_SUITE: auc, logistic_loss and the per-user AUC); then
    ``best``.  Gates: one build per coordinate for the whole grid (a wrapper
    around the estimator's ``build_coordinate``), kernels 1 and 3 launched
    at every point, every point's training AUC against the Bayes AUC,
    ``best`` at the argmax of the held-out AUCs, and the last point refit
    from the same warm start on freshly built coordinates bitwise equal to
    the rebound fit.  Each point also logs what its grouped evaluations cost
    (a wrapper around ``grouped_evaluate``).  Returns ``best`` and the
    held-out GameData."""
    import numpy as np
    import torch

    import photon_ml_tpu_torch.evaluation.evaluator as ev_mod
    import photon_ml_tpu_torch.game.estimator as est_mod
    from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite
    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.game.coordinate import build_coordinate
    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    m, n_val = len(train["y"]), len(val["y"])
    bayes = _bayes_auc(train)
    train, val = _part_data(train), _part_data(val)
    groups = len(np.unique(val.id_tags["userId"]))
    suite = EvaluationSuite.from_specs(GRID_SUITE)
    configs = _grid_configs()
    built, points, grouped = [], [], []
    real_build, real_run = est_mod.build_coordinate, CoordinateDescent.run
    real_grouped = ev_mod.grouped_evaluate
    kernels = _zero_launches()

    def counting_build(cid, *args, **kw):
        built.append(cid)
        return real_build(cid, *args, **kw)

    def timed_grouped(*args, **kw):
        # one grouped evaluation's wall time (it ends in a read to the host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_grouped(*args, **kw)
        grouped.append(time.perf_counter() - t0)
        return out

    def timed_run(self, *args, **kw):
        # one grid point's descent: its wall time, kernel launches and
        # grouped evaluations
        torch.cuda.synchronize()
        before = {name: k.launches for name, k in kernels.items()}
        g0 = len(grouped)
        t0 = time.perf_counter()
        out = real_run(self, *args, **kw)
        torch.cuda.synchronize()
        points.append(dict(start=t0, end=time.perf_counter(),
                           launches=_launches_since(kernels, before),
                           grouped_s=sum(grouped[g0:]), grouped_evals=len(grouped) - g0))
        return out

    est_mod.build_coordinate, CoordinateDescent.run = counting_build, timed_run
    ev_mod.grouped_evaluate = timed_grouped
    try:
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        # the host loop: the wrapper above times and counts each point
        est = GameEstimator(device="cuda", validation_suite=suite, fused=False)
        results = est.fit(train, configs, validation_data=val)
        torch.cuda.synchronize()
        t_grid = time.perf_counter() - t_start
    finally:
        est_mod.build_coordinate, CoordinateDescent.run = real_build, real_run
        ev_mod.grouped_evaluate = real_grouped
    peak = torch.cuda.max_memory_allocated() / 1e9
    if built != ["fixed", "per-user"]:
        raise AssertionError(f"glmix_chip-grid built {built}, not one of each coordinate")

    y = torch.as_tensor(train.y, device="cuda").double()
    rows, prev_end = [], t_start
    for i, (r, p) in enumerate(zip(results, points)):
        _record_path_launches(f"glmix_chip_grid_{i}", p["launches"], stats,
                              ("fused_value_and_grad", "newton_step"))
        scores = r.model.score(train, device="cuda")
        if not bool(torch.isfinite(scores).all()) or scores.shape != (m,):
            raise AssertionError(f"glmix_chip-grid point {i}: scores not finite of shape [n]")
        auc = float(auc_roc(scores, y, torch.ones_like(y)))
        _check_bayes(f"glmix_chip-grid point {i}", auc, bayes)
        fixed = r.config.coordinates["fixed"]
        rows.append(dict(
            fixed_l2=fixed.reg.l2, user_l2=r.config.coordinates["per-user"].reg.l2,
            down_sampling_rate=fixed.down_sampling_rate, build_s=p["start"] - prev_end,
            fit_s=p["end"] - p["start"], train_auc=auc, held_out=r.evaluation.values,
            solver_iterations=[st["solver_iterations"] for st in r.history.steps],
            launches={k: v for k, v in p["launches"].items() if v},
            grouped_eval_s=p["grouped_s"], grouped_evals=p["grouped_evals"]))
        prev_end = p["end"]
        log(f"glmix_chip-grid point {i}: L2 fixed {rows[-1]['fixed_l2']:g} / per-user "
            f"{rows[-1]['user_l2']:g}, fixed down-sampling {fixed.down_sampling_rate:g}: "
            f"construction {rows[-1]['build_s']:.3f} s, fit {rows[-1]['fit_s']:.3f} s (of "
            f"it {p['grouped_evals']} auc:userId evaluations over {n_val} rows in "
            f"{groups} groups, {p['grouped_s']:.4f} s), "
            f"solver iterations {rows[-1]['solver_iterations']}, launches "
            f"{rows[-1]['launches']}, training AUC {auc:.4f}, held-out "
            + ", ".join(f"{k} {v:.6f}" for k, v in r.evaluation.values.items()))
    held = [r.evaluation.values["auc"] for r in results]
    pick = results.index(est.best(results))
    ok = pick == int(np.argmax(held))
    log(f"glmix_chip-grid: {len(configs)} points over {m} training rows ({n_val} "
        f"held out) in {t_grid:.2f} s, coordinates built {built}; best point {pick}, "
        f"argmax of the held-out AUCs {int(np.argmax(held))} {'ok' if ok else 'FAILED'}; "
        f"peak device memory {peak:.2f} GB")
    if not ok:
        raise AssertionError("glmix_chip-grid: best is not the argmax of the held-out AUCs")

    # the last point again, from the same warm start, on fresh coordinates
    last = configs[-1]
    t0 = time.perf_counter()
    coords = {cid: build_coordinate(cid, train, c, last.task, device="cuda")
              for cid, c in last.coordinates.items()}
    fresh, _, _ = CoordinateDescent(coords, order=list(last.coordinates),
                                    num_iterations=last.num_outer_iterations,
                                    validation=(val, suite)).run(
        torch.device("cuda"), initial=results[-2].model, seed=0)
    torch.cuda.synchronize()
    t_fresh = time.perf_counter() - t0
    del coords
    rebound = results[-1].model
    same = (np.array_equal(fresh["fixed"].coefficients.means,
                           rebound["fixed"].coefficients.means)
            and fresh["per-user"].slot_of == rebound["per-user"].slot_of
            and np.array_equal(fresh["per-user"].w_stack, rebound["per-user"].w_stack))
    log(f"glmix_chip-grid: the last point on freshly built coordinates in {t_fresh:.2f} s, "
        f"{'bitwise equal to' if same else 'DIFFERENT FROM'} the rebound fit")
    if not same:
        raise AssertionError("glmix_chip-grid: the rebound fit differs from a fresh build")
    stats["glmix_chip_grid"] = dict(grid_s=t_grid, builds=len(built), points=rows,
                                    best=pick, bayes_auc=bayes, fresh_last_point_s=t_fresh,
                                    peak_gb=peak)
    return dict(best=results[pick], val=val)


def _retrain_data(part: dict, device: str):
    """glmix_chip-retrain's data of the day: ``part``'s held-out rows
    (GRID_HELD_OUT_PER_USER a user, contiguous), except that every user
    whose id % RETRAIN_THIN == 1 keeps only its first RETRAIN_THIN_ROWS;
    the fixed design is gathered where it lives, then moved to ``device``."""
    import numpy as np
    import torch

    pos = np.arange(len(part["uids"])) % GRID_HELD_OUT_PER_USER
    rows = np.nonzero((part["uids"] % RETRAIN_THIN != 1) | (pos < RETRAIN_THIN_ROWS))[0]
    idx = torch.as_tensor(rows, device=part["xg"].device)
    return _part_data({k: v[idx] if k == "xg" else v[rows] for k, v in part.items()}, device)


def _retrain_prior(model, users=None):
    """glmix_chip-retrain's prior: ``model`` without the per-user rows of the
    users whose id % RETRAIN_NEW == 1 (and, with ``users``, of every id from
    ``users`` on)."""
    import dataclasses

    import numpy as np

    from photon_ml_tpu_torch.models.game import GameModel

    re = model["per-user"]
    keep = [u for u in sorted(re.slot_of)
            if u % RETRAIN_NEW != 1 and (users is None or u < users)]
    rows = np.asarray([re.slot_of[u] for u in keep])
    re = dataclasses.replace(re, w_stack=re.w_stack[rows],
                             slot_of={u: i for i, u in enumerate(keep)},
                             variances=None if re.variances is None else re.variances[rows])
    return GameModel(models={**model.models, "per-user": re})


def _retrain_config(config):
    """``config`` with the per-user lower bound at RETRAIN_MIN_ACTIVE."""
    import dataclasses

    c = config.coordinates
    return dataclasses.replace(config, coordinates={
        **c, "per-user": dataclasses.replace(c["per-user"],
                                             min_active_samples=RETRAIN_MIN_ACTIVE)})


def _observed_fit(device: str, data, configs, specs=None, **kw) -> dict:
    """One ``GameEstimator.fit`` on ``device`` (validated by ``specs``),
    its construction timed by a wrapper around the estimator's
    ``build_coordinate``, which keeps the coordinates built, and the card's
    kernel launches counted from 0.  Returns the results, the coordinates
    built, construction and fit seconds, launches and each update's solver
    iterations."""
    import torch

    import photon_ml_tpu_torch.game.estimator as est_mod
    from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite
    from photon_ml_tpu_torch.game import GameEstimator

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    real_build, built, build_s = est_mod.build_coordinate, {}, []

    def timed_build(cid, *args, **kwargs):
        t0 = time.perf_counter()
        built[cid] = real_build(cid, *args, **kwargs)
        sync()
        build_s.append(time.perf_counter() - t0)
        return built[cid]

    suite = None if specs is None else EvaluationSuite.from_specs(specs)
    kernels = _zero_launches()
    est_mod.build_coordinate = timed_build
    try:
        sync()
        t0 = time.perf_counter()
        results = GameEstimator(device=device, validation_suite=suite, fused=False).fit(
            data, configs, **kw)
        sync()
        total = time.perf_counter() - t0
    finally:
        est_mod.build_coordinate = real_build
    return dict(results=results, built=built, build_s=sum(build_s),
                fit_s=total - sum(build_s),
                launches={name: k.launches for name, k in kernels.items()},
                iterations=[[st["solver_iterations"] for st in r.history.steps]
                            for r in results])


def _log_fit(label: str, out: dict) -> None:
    log(f"{label}: construction {out['build_s']:.3f} s ({len(out['built'])} coordinates "
        f"built), fit {out['fit_s']:.3f} s, solver iterations {out['iterations']}, "
        f"launches {out['launches']}")


def _retrain(label: str, device: str, today, prior, config) -> dict:
    """23(a) on ``device``: ``config`` fitted on ``today`` from ``prior``
    with the fixed effect locked.  Gates: the fixed effect is the prior's,
    bitwise; the under-bound users that the prior covers have no lane and
    keep the prior's rows bitwise; the under-bound new users have lanes and
    trained (finite, nonzero) rows; every other user has a lane."""
    import numpy as np

    out = _observed_fit(device, today, [config], initial_model=prior,
                        locked_coordinates={"fixed"})
    _log_fit(label, out)
    model = out["results"][0].model
    lanes = out["built"]["per-user"].buckets.lane_of
    re, re_prior = model["per-user"], prior["per-user"]
    ids, counts = np.unique(today.id_tags["userId"], return_counts=True)
    under = ids[counts < RETRAIN_MIN_ACTIVE]
    covered = np.asarray([u for u in under.tolist() if u in re_prior.slot_of])
    new = np.asarray([u for u in under.tolist() if u not in re_prior.slot_of])
    rows = lambda m, us: m.w_stack[[m.slot_of[u] for u in us.tolist()]]
    trained = rows(re, new)
    checks = {
        "fixed effect bitwise the prior's": np.array_equal(
            model["fixed"].coefficients.means, prior["fixed"].coefficients.means),
        f"{len(covered)} covered under-bound users without a lane":
            len(covered) > 0 and not any(u in lanes for u in covered.tolist()),
        "their rows bitwise the prior's": np.array_equal(rows(re, covered),
                                                         rows(re_prior, covered)),
        f"{len(new)} new under-bound users with lanes":
            len(new) > 0 and all(u in lanes for u in new.tolist()),
        "their rows trained": bool(np.isfinite(trained).all()
                                   and (np.abs(trained).max(axis=1) > 0).all()),
        f"{len(lanes)} lanes = {len(ids)} users - {len(covered)}":
            len(lanes) == len(ids) - len(covered),
    }
    log(f"{label}: " + "; ".join(f"{k} {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{label}: a warm-start gate failed")
    out.update(covered=len(covered), new=len(new), lanes=len(lanes))
    return out


def _cursor_rule(num_configs: int, num_iters: int, num_coords: int) -> list:
    """The reference's checkpoint cursors: after update (ci, it, k), the
    next update's."""
    return [{"config": ci, "iteration": it + (k + 1) // num_coords,
             "coordinate": (k + 1) % num_coords}
            for ci in range(num_configs) for it in range(num_iters)
            for k in range(num_coords)]


def _checkpoint_resume(label: str, device: str, train, val, nudge_seed=None) -> dict:
    """23(b) on ``device``: the first RESUME_POINTS points of the grid with
    a hook that keeps every save in memory, then a resume from the save at
    RESUME_CRASH with its model, cursor and best (with ``nudge_seed``, also
    from that model with every coefficient moved by about one float32 ulp).
    Gates: the saves' number, cursors, ``updated`` and ``best`` as the
    reference's rule gives them; the resume's result count and its best at
    least the checkpointed best."""
    import dataclasses

    import numpy as np

    from photon_ml_tpu_torch.models.game import GameModel

    configs = _grid_configs()[:RESUME_POINTS]
    order = list(configs[0].coordinates)
    iters = configs[0].num_outer_iterations
    saves = []
    full = _observed_fit(device, train, configs, GRID_SUITE, validation_data=val,
                         checkpoint_hook=lambda m, cur, **h: saves.append((m, cur, h)))
    _log_fit(f"{label}, uninterrupted", full)
    per_config = iters * len(order)
    first = [i % per_config == 0 for i in range(len(saves))]
    checks = {
        f"{len(saves)} saves": len(saves) == RESUME_POINTS * per_config,
        "cursors": [c for _, c, _ in saves] == _cursor_rule(RESUME_POINTS, iters, len(order)),
        "updated None on each configuration's first save": [h["updated"] for _, _, h in saves]
        == [None if f else order[i % len(order)] for i, f in enumerate(first)],
        "best None before each configuration's first complete sweep":
            [h["best"] is None for _, _, h in saves] == first,
    }
    crash = [c for _, c, _ in saves].index(RESUME_CRASH)
    model, cursor, h = saves[crash]

    def resume(m):
        later = []
        out = _observed_fit(device, train, configs, GRID_SUITE, validation_data=val,
                            initial_model=m, resume_cursor=cursor, resume_best=h["best"],
                            checkpoint_hook=lambda m, cur, **k: later.append((m, cur, k)))
        out["saves"] = later
        return out

    resumed = resume(model)
    _log_fit(f"{label}, resumed at {cursor}", resumed)
    res = resumed["results"]
    best_primary = h["best"][1].primary
    checks[f"{len(res)} results"] = len(res) == RESUME_POINTS - cursor["config"]
    checks["the resume's cursors those after the crash"] = (
        [c for _, c, _ in resumed["saves"]] == [c for _, c, _ in saves[crash + 1:]])
    checks[f"resumed point {cursor['config']}'s {GRID_SUITE[0]} {res[0].evaluation.primary:.6f}"
           f" >= the checkpointed best's {best_primary:.6f} - 1e-9"] = (
        res[0].evaluation.primary >= best_primary - 1e-9)
    log(f"{label}: " + "; ".join(f"{k} {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{label}: a checkpoint or resume gate failed")
    full.update(saves=saves, resumed=resumed, crash=crash)
    if nudge_seed is not None:
        rng = np.random.default_rng(nudge_seed)
        nudge = lambda a: a * (1 + np.float32(2 ** -23) * rng.choice(np.float32([-1, 1]),
                                                                     a.shape))
        fixed, re = model["fixed"], model["per-user"]
        full["nudged"] = resume(GameModel(models={
            "fixed": dataclasses.replace(fixed, coefficients=dataclasses.replace(
                fixed.coefficients, means=nudge(fixed.coefficients.means))),
            "per-user": dataclasses.replace(re, w_stack=nudge(re.w_stack))}))
        _log_fit(f"{label}, resumed from the nudged checkpoint", full["nudged"])
    return full


def phase_glmix_chip_retrain(stats: dict, grid: dict, train: dict, val: dict):
    """glmix_chip-retrain at full width: (a) a warm start from phase 19's
    ``best`` with the fixed effect locked, on the day's data, through the
    existing-model lower bound; (b) checkpoint and resume of the grid's
    first points, the resume within a gate derived from its own one-ulp
    spread; (c) both at REDUCED_USERS, card against CPU."""
    import torch

    best = grid["best"]
    config = _retrain_config(best.config)
    t0 = time.perf_counter()
    today = _retrain_data(val, "cuda")
    torch.cuda.synchronize()
    log(f"glmix_chip-retrain data: {today.num_samples} rows of the held-out part, gathered "
        f"on the card in {time.perf_counter() - t0:.3f} s; prior: best point's model "
        f"without the users whose id % {RETRAIN_NEW} == 1; per-user lower bound "
        f"{RETRAIN_MIN_ACTIVE}")
    a = _retrain("glmix_chip-retrain (a) warm start, locked fixed effect", "cuda", today,
                 _retrain_prior(best.model), config)
    _record_path_launches("glmix_chip_retrain_a", a["launches"], stats, ("newton_step",))
    if a["launches"]["fused_value_and_grad"] != 0:
        raise AssertionError("glmix_chip-retrain (a): the locked fixed effect launched "
                             "kernel 1")
    del today

    train_d, val_d = _part_data(train), _part_data(val)
    b = _checkpoint_resume("glmix_chip-retrain (b) checkpoint and resume", "cuda", train_d,
                           val_d, nudge_seed=F32_SPREAD_SEEDS[0])
    _record_path_launches("glmix_chip_retrain_b", b["launches"], stats,
                          ("fused_value_and_grad", "newton_step"))
    _record_path_launches("glmix_chip_retrain_b_resume", b["resumed"]["launches"], stats,
                          ("fused_value_and_grad", "newton_step"))
    start = RESUME_CRASH["config"]
    # the models compared: every save after the crash (the iterates), then
    # the results (each point's best); a point's best can be the checkpointed
    # one, which a nudge of the resume's start does not reach
    states = lambda o, saves: [m for m, _, _ in saves] + [r.model for r in o["results"]]
    uninterrupted = [m for m, _, _ in b["saves"][b["crash"] + 1:]] + [
        r.model for r in b["results"][start:]]
    resumed = states(b["resumed"], b["resumed"]["saves"])
    nudged = states(b["nudged"], b["nudged"]["saves"])
    compare = lambda x, y: _model_errors("glmix_chip-retrain (b)", x, y, ["per-user"])
    gaps = [compare(r, u) for r, u in zip(resumed, uninterrupted)]
    spreads = [compare(n, r) for n, r in zip(nudged, resumed)]
    tol = {k: F32_SPREAD_MULTIPLE * max(sp[k] for sp in spreads) for k in spreads[0]}
    ok = all(g[k] <= tol[k] for g in gaps for k in g)
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())
    worst = lambda errs: {k: max(e[k] for e in errs) for k in errs[0]}
    log(f"glmix_chip-retrain (b): resumed against uninterrupted over {len(gaps)} models "
        f"(the {len(b['resumed']['saves'])} saves after the crash and the "
        f"{len(b['resumed']['results'])} results): largest rel diff {fmt(worst(gaps))}, "
        f"per model " + "; ".join(fmt(g) for g in gaps)
        + f" (tol {fmt(tol)}: {F32_SPREAD_MULTIPLE:g} x the largest spread of a resume from "
        f"the checkpoint nudged by one ulp, per model " + "; ".join(fmt(sp) for sp in spreads)
        + f") {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("glmix_chip-retrain (b): the resume differs from the "
                             "uninterrupted run beyond its spread")

    # (c) both at REDUCED_USERS, card against CPU
    sides = {}
    for device in ("cuda", "cpu"):
        t_d, v_d = (_part_data(p, device, REDUCED_USERS) for p in (train, val))
        v_part = {k: val[k][:REDUCED_USERS * GRID_HELD_OUT_PER_USER] for k in val}
        sides[device] = (
            _retrain(f"glmix_chip-retrain (c) at {REDUCED_USERS} users, {device}, (a)",
                     device, _retrain_data(v_part, device),
                     _retrain_prior(best.model, REDUCED_USERS), config),
            _checkpoint_resume(f"glmix_chip-retrain (c) at {REDUCED_USERS} users, {device}, "
                               "(b)", device, t_d, v_d))
    (ga, gb), (ca, cb) = sides["cuda"], sides["cpu"]
    errs = {"(a)": _model_errors("(c) (a)", ga["results"][0].model, ca["results"][0].model,
                                 ["per-user"])}
    for i, (g, c) in enumerate(zip(gb["results"], cb["results"])):
        errs[f"(b) point {i}"] = _model_errors("(c) (b)", g.model, c.model, ["per-user"])
    for i, (g, c) in enumerate(zip(gb["resumed"]["results"], cb["resumed"]["results"])):
        errs[f"(b) resumed point {start + i}"] = _model_errors("(c) (b)", g.model, c.model,
                                                               ["per-user"])
    same_saves = ([(c, h["updated"], h["best"] is None) for _, c, h in gb["saves"]]
                  == [(c, h["updated"], h["best"] is None) for _, c, h in cb["saves"]])
    worst = max(max(e.values()) for e in errs.values())
    ok = worst <= F32_PATH_RTOL and same_saves
    log(f"card vs CPU, glmix_chip-retrain at {REDUCED_USERS} users: max rel diff "
        + "; ".join(f"{k} {fmt(e)}" for k, e in errs.items())
        + f" (tol {F32_PATH_RTOL:g}); the saves' cursors, updated and best "
        f"{'the same' if same_saves else 'DIFFERENT'} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("glmix_chip-retrain: card and CPU disagree")
    part = lambda o: dict(build_s=o["build_s"], fit_s=o["fit_s"], iterations=o["iterations"],
                          launches=o["launches"])
    stats["glmix_chip_retrain"] = dict(
        a=dict(part(a), covered=a["covered"], new=a["new"], lanes=a["lanes"]),
        b=part(b), b_resumed=part(b["resumed"]), b_nudged=part(b["nudged"]),
        resume_gaps=gaps, resume_spreads=spreads, resume_tol=tol, card_vs_cpu=errs)


def _logistic_gradient_f64(x, y, w, l2: float):
    """Σ (σ(x·w) - y)·x + l2·w in float64, over row chunks of ``x``."""
    import torch

    g = l2 * w
    for lo in range(0, x.shape[0], GRADIENT_CHUNK_ROWS):
        xc = x[lo:lo + GRADIENT_CHUNK_ROWS].double()
        g = g + xc.T @ (torch.sigmoid(xc @ w) - y[lo:lo + GRADIENT_CHUNK_ROWS])
    return g


def phase_glmix_chip_reg_path(stats: dict, train: dict, val: dict):
    """glmix_chip-reg-path at full width: ``train_glm_reg_path`` over
    glmix_chip's fixed design on the card (phase 19's training rows) at
    REG_PATH_WEIGHTS, then ``select_best_glm`` on its held-out rows.  Gates:
    kernel 1 launched at every weight, each weight's float64 gradient norm
    at its solution within STATIONARY_RATIO of the norm at w = 0, and the
    selection at the argmax of the held-out AUCs."""
    import numpy as np
    import torch

    import photon_ml_tpu_torch.models.training as training
    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import TaskType

    x = train["xg"]
    solves = []
    real_make = training.make_solver
    kernels = _zero_launches()

    def timed_make(*args, **kw):
        solve = real_make(*args, **kw)

        def timed(w0, batch):
            # one weight's solve: its wall time and kernel launches
            torch.cuda.synchronize()
            before = {name: k.launches for name, k in kernels.items()}
            t0 = time.perf_counter()
            res = solve(w0, batch)
            torch.cuda.synchronize()
            solves.append(dict(fit_s=time.perf_counter() - t0,
                               launches=_launches_since(kernels, before)))
            return res

        return timed

    training.make_solver = timed_make
    try:
        t0 = time.perf_counter()
        path, trackers = training.train_glm_reg_path(
            x, train["y"], TaskType.LOGISTIC_REGRESSION, REG_PATH_WEIGHTS,
            solver=SolverConfig(max_iters=30, tolerance=1e-7), device="cuda")
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
    finally:
        training.make_solver = real_make
    if [lam for lam, _ in path] != sorted(REG_PATH_WEIGHTS, reverse=True):
        raise AssertionError("glmix_chip-reg-path: not trained in descending order")

    y = torch.as_tensor(train["y"], device="cuda", dtype=torch.float64)
    zero = torch.zeros(x.shape[1], dtype=torch.float64, device="cuda")
    g0 = float(torch.linalg.vector_norm(_logistic_gradient_f64(x, y, zero, 0.0)))
    y_val = torch.as_tensor(val["y"], device="cuda", dtype=torch.float64)
    rows = []
    for (lam, model), s in zip(path, solves):
        _record_path_launches(f"glmix_chip_reg_path_{lam:g}", s["launches"], stats,
                              ("fused_value_and_grad",))
        w = torch.as_tensor(model.coefficients.means, device="cuda", dtype=torch.float64)
        ratio = float(torch.linalg.vector_norm(_logistic_gradient_f64(x, y, w, lam))) / g0
        auc = float(auc_roc(model.score(val["xg"]).double(), y_val, torch.ones_like(y_val)))
        res = trackers[lam]
        rows.append(dict(l2=lam, fit_s=s["fit_s"], iterations=res.iterations,
                         reason=res.reason, gradient_ratio=ratio, held_out_auc=auc,
                         launches={k: v for k, v in s["launches"].items() if v}))
        ok = ratio <= STATIONARY_RATIO
        log(f"glmix_chip-reg-path L2 {lam:g}: fit {s['fit_s']:.3f} s, {res.iterations} "
            f"iterations (reason {res.reason}), launches {rows[-1]['launches']}, float64 "
            f"gradient norm {ratio:.2e} of its norm at w = 0 (gate {STATIONARY_RATIO:g}), "
            f"held-out AUC {auc:.6f} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"glmix_chip-reg-path L2 {lam:g}: not stationary")
    t0 = time.perf_counter()
    lam_best, _ = training.select_best_glm(path, val["xg"], val["y"], device="cuda")
    t_select = time.perf_counter() - t0
    want = rows[int(np.argmax([r["held_out_auc"] for r in rows]))]["l2"]
    ok = lam_best == want
    log(f"glmix_chip-reg-path: {len(path)} weights over {x.shape[0]} rows x {x.shape[1]} in "
        f"{t_path:.2f} s; select_best_glm {lam_best:g} in {t_select:.3f} s, argmax of the "
        f"held-out AUCs {want:g} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("glmix_chip-reg-path: select_best_glm is not the argmax")
    stats["glmix_chip_reg_path"] = dict(path_s=t_path, select_s=t_select, weights=rows,
                                        best=lam_best)


def _gs_held_out_split(host: dict):
    """glmix_sparse's (training, held-out) GameData and the held-out rows'
    mask: the last GS_HELD_OUT_PER_USER rows of every user, in order of
    appearance."""
    from photon_ml_tpu_torch.data.synthetic import last_rows_per_entity
    from photon_ml_tpu_torch.game import GameData, SparseShard

    held = last_rows_per_entity(host["uids"], GS_HELD_OUT_PER_USER)

    def part(rows):
        return GameData(y=host["y"][rows], features={
            k: SparseShard(indices=host[s]["indices"][rows], values=host[s]["values"][rows],
                           dim=host[s]["dim"]) for k, s in (("g", "fixed"), ("u", "user"))},
            id_tags={"userId": host["uids"][rows]})

    return part(~held), part(held), held


def phase_glmix_sparse_held_out(stats: dict, card: dict):
    """glmix_sparse held out: phase 12's data split inside each user (the
    last GS_HELD_OUT_PER_USER of its 32 rows, in order of appearance,
    validate), fitted with phase 12's configuration and GS_HELD_OUT_SUITE
    as the validation suite, compacted, and the held-out rows evaluated
    through ``GameTransformer`` (``match_dot`` launches > 0).  Gates: the
    held-out AUC at least the fixed effect's alone + GS_PER_USER_GAIN, at
    most the held-out Bayes AUC + GS_BAYES_SLACK, and the compact model's
    within GS_COMPACT_AUC_TOL of its dense twin's."""
    import torch

    from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite
    from photon_ml_tpu_torch.evaluation.metrics import auc_roc
    from photon_ml_tpu_torch.game import GameEstimator, GameTransformer
    from photon_ml_tpu_torch.models.game import GameModel
    from photon_ml_tpu_torch.types import TaskType

    host = card["host"]
    train, val, held = _gs_held_out_split(host)
    suite = EvaluationSuite.from_specs(GS_HELD_OUT_SUITE)
    task = TaskType.LOGISTIC_REGRESSION
    kernels = _zero_launches()
    t0 = time.perf_counter()
    res = GameEstimator(device="cuda", validation_suite=suite).fit(
        train, [_glmix_sparse_config()], validation_data=val)[0]
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    compact = res.model["per-user"].to_compact()
    t_compact = time.perf_counter() - t0
    model = GameModel(models={"fixed": res.model["fixed"], "per-user": compact})
    t0 = time.perf_counter()
    ev = GameTransformer(model, task, device="cuda").evaluate(val, suite).values
    t_score = time.perf_counter() - t0
    launches = _record_launches("glmix_sparse_held_out", kernels, stats, ("match_dot",))

    dense = GameTransformer(res.model, task, device="cuda").evaluate(val, suite).values
    fixed = GameTransformer(GameModel(models={"fixed": res.model["fixed"]}), task,
                            device="cuda").evaluate(val, suite).values
    train_auc = GameTransformer(model, task, device="cuda").evaluate(
        train, EvaluationSuite.from_specs(["auc"])).values["auc"]
    y = torch.as_tensor(val.y, device="cuda").double()
    bayes = float(auc_roc(torch.as_tensor(host["logits"][held], device="cuda").double(), y,
                          torch.ones_like(y)))
    auc = ev["auc"]
    gates = {"per-user gain": auc >= fixed["auc"] + GS_PER_USER_GAIN,
             "Bayes bound": auc <= bayes + GS_BAYES_SLACK,
             "compact vs dense": abs(auc - dense["auc"]) <= GS_COMPACT_AUC_TOL}
    fmt = lambda v: ", ".join(f"{k} {x:.6f}" for k, x in v.items())
    log(f"glmix_sparse held out: {train.num_samples} rows train, {val.num_samples} "
        f"validate; fit {t_fit:.2f} s (descent's best: {fmt(res.evaluation.values)}), "
        f"to_compact {t_compact:.2f} s, held-out evaluation through the compact model "
        f"{t_score:.3f} s, launches {launches}; training AUC {train_auc:.4f}; held out: "
        f"compact model {fmt(ev)}; dense twin {fmt(dense)}; fixed effect alone "
        f"{fmt(fixed)}; Bayes AUC {bayes:.4f}")
    log(f"glmix_sparse held-out gates: AUC {auc:.6f} >= fixed alone {fixed['auc']:.6f} + "
        f"{GS_PER_USER_GAIN:g}; <= Bayes {bayes:.6f} + {GS_BAYES_SLACK:g}; compact vs "
        f"dense |{auc - dense['auc']:.2e}| <= {GS_COMPACT_AUC_TOL:g}: "
        + ", ".join(f"{k} {'ok' if v else 'FAILED'}" for k, v in gates.items()))
    if not all(gates.values()):
        raise AssertionError(f"glmix_sparse held out: {[k for k, v in gates.items() if not v]}")
    stats["glmix_sparse_held_out"] = dict(
        fit_s=t_fit, compact_s=t_compact, score_s=t_score, train_auc=train_auc,
        held_out=ev, dense=dense, fixed_only=fixed, bayes_auc=bayes)


def _host_aupr_rows(s, y):
    """AUPR of each row of [R, m] float64 scores, unit weights: per tie
    group, the recall step times the mean of the precisions at its end and
    at the previous group's end (1 before the first); no positives give 0."""
    import numpy as np

    order = np.argsort(-s, axis=1, kind="stable")
    ss = np.take_along_axis(s, order, 1)
    pos = np.take_along_axis(y > 0.5, order, 1)
    tp, fp = np.cumsum(pos, 1).astype(float), np.cumsum(~pos, 1).astype(float)
    r, m = s.shape
    is_end = np.ones((r, m), bool)
    is_end[:, :-1] = ss[:, :-1] != ss[:, 1:]
    ends = np.flatnonzero(is_end)
    row = ends // m
    tpe, fpe = tp.ravel()[ends], fp.ravel()[ends]
    first = np.ones(len(ends), bool)
    first[1:] = row[1:] != row[:-1]
    tpp = np.where(first, 0.0, np.roll(tpe, 1))
    fpp = np.where(first, 0.0, np.roll(fpe, 1))
    p = tp[:, -1]
    prec_prev = np.where(tpp + fpp > 0, tpp / np.maximum(tpp + fpp, 1.0), 1.0)
    area = (tpe - tpp) / np.maximum(p[row], 1.0) * 0.5 * (tpe / (tpe + fpe) + prec_prev)
    return np.where(p == 0, 0.0, np.bincount(row, weights=area, minlength=r))


def _host_pairwise_auc_rows(s, y):
    """AUC of each row of [R, m] scores by its definition: the share of
    (positive, negative) pairs ordered right, a tie counting 0.5; a row
    without positives or negatives reads 0.5."""
    import numpy as np

    pos = y > 0.5
    beats = (s[:, :, None] > s[:, None, :]) + 0.5 * (s[:, :, None] == s[:, None, :])
    num = (beats * (pos[:, :, None] & ~pos[:, None, :])).sum((1, 2))
    p, n = pos.sum(1), (~pos).sum(1)
    return np.where((p == 0) | (n == 0), 0.5, num / np.maximum(p * n, 1))


def _host_precision_rows(k: int, s, y):
    """Precision among each row's top k scores (a stable sort; unit weights)."""
    import numpy as np

    top = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(y, top, 1) > 0.5).sum(1) / top.shape[1]


def _host_suite_metrics(raw, y, per_group: int) -> dict:
    """SUITE_SPECS' metrics of float64 ``raw`` scores and labels ``y`` with
    unit weights, recomputed on the host by other means than the port's:
    AUC by Mann-Whitney average ranks (``scipy.stats.rankdata``), AUPR and
    precision by numpy sorts, the losses in closed form; the grouped metrics
    over the [groups, per_group] reshape of rows laid out group by group."""
    import numpy as np
    from scipy.stats import rankdata

    pos = y > 0.5
    p, n = pos.sum(), (~pos).sum()
    ranks = rankdata(raw)  # ascending, ties averaged
    t = np.where(pos, 1.0, -1.0) * raw
    gs, gy = raw.reshape(-1, per_group), y.reshape(-1, per_group)
    return {
        "auc": float((ranks[pos].sum() - p * (p + 1) / 2) / (p * n)),
        "aupr": float(_host_aupr_rows(raw[None], y[None])[0]),
        "rmse": float(np.sqrt(np.mean((raw - y) ** 2))),
        "logistic_loss": float(np.sum(np.logaddexp(0.0, raw) - y * raw)),
        "squared_loss": float(np.sum(0.5 * (raw - y) ** 2)),
        "poisson_loss": float(np.sum(np.exp(raw) - y * raw)),
        "smoothed_hinge_loss": float(np.sum(np.where(
            t >= 1.0, 0.0, np.where(t <= 0.0, 0.5 - t, 0.5 * (1.0 - t) ** 2)))),
        "precision_at_k@1000": float(_host_precision_rows(1000, raw[None], y[None])[0]),
        "auc:userId": float(np.mean(_host_pairwise_auc_rows(gs, gy))),
        "aupr:userId": float(np.mean(_host_aupr_rows(gs, gy))),
        "precision_at_k@4:userId": float(np.mean(_host_precision_rows(4, gs, gy))),
    }


def _median_event_ms(fn, reps: int = SUITE_TIMING_REPS) -> float:
    """The median over ``reps`` calls of ``fn``'s CUDA-event time, each call
    timed alone after a warm-up call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_evaluation_suite(stats: dict, grid: dict):
    """Every evaluator on the card: glmix_chip-grid's ``best`` model
    (phase 19) and held-out rows through ``GameTransformer`` with
    SUITE_SPECS.  Gates: the transformer's auc, logistic_loss and
    auc:userId bitwise equal to ``best.evaluation``'s; ``score`` equal to
    ``GameModel.score`` and ``predict`` to the sigmoid of score + offset;
    every metric within SUITE_HOST_RTOL of ``_host_suite_metrics``.  Then
    each metric's time on the card (CUDA events, median of repeats), the
    grouped ones with and without the padded layout's build."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.evaluation.evaluator import (EvaluationSuite, grouped_mean,
                                                          pad_groups)
    from photon_ml_tpu_torch.game import GameTransformer
    from photon_ml_tpu_torch.game.scoring import raw_scores
    from photon_ml_tpu_torch.types import TaskType

    best, val = grid["best"], grid["val"]
    uids = val.id_tags["userId"]
    per = GRID_HELD_OUT_PER_USER
    by_user = uids.reshape(-1, per)
    if not ((by_user == by_user[:, :1]).all() and len(np.unique(by_user[:, 0])) ==
            len(by_user) and (val.weight == 1).all()):
        raise AssertionError(f"the held-out rows are not {per} contiguous unit-weight rows "
                             "a user")
    suite = EvaluationSuite.from_specs(SUITE_SPECS)
    tr = GameTransformer(best.model, TaskType.LOGISTIC_REGRESSION, device="cuda")
    t0 = time.perf_counter()
    values = tr.evaluate(val, suite).values
    t_suite = time.perf_counter() - t0
    same = {k: values[k] == v for k, v in best.evaluation.values.items()}
    log(f"evaluation suite on the card: {len(SUITE_SPECS)} evaluators over "
        f"{val.num_samples} held-out rows ({len(by_user)} users) in {t_suite:.3f} s; "
        "bitwise equal to best.evaluation: " + ", ".join(f"{k} {'ok' if v else 'DIFFERENT'}"
                                                      for k, v in same.items()))
    if not all(same.values()):
        raise AssertionError("the transformer's evaluation differs from best.evaluation")

    score, predict = tr.score(val), tr.predict(val)
    raw = raw_scores(best.model, val, device="cuda")
    ok = (torch.equal(score, best.model.score(val, device="cuda"))
          and torch.equal(predict, torch.sigmoid(raw))
          and torch.equal(raw, score + torch.as_tensor(val.offset, device="cuda")))
    log(f"GameTransformer score == GameModel.score, predict == sigmoid(score + offset): "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("GameTransformer's score or predict is not the model's")

    t0 = time.perf_counter()
    host = _host_suite_metrics(raw.cpu().numpy(), np.asarray(val.y, np.float64), per)
    t_host = time.perf_counter() - t0
    errs = {k: abs(values[k] - v) / max(abs(v), 1e-300) for k, v in host.items()}
    ok = set(host) == set(values) and max(errs.values()) <= SUITE_HOST_RTOL
    log(f"card vs host float64 recomputation ({t_host:.2f} s on the host): "
        + ", ".join(f"{k} {values[k]:.10g} vs {host[k]:.10g} ({errs[k]:.1e})" for k in host)
        + f" (tol {SUITE_HOST_RTOL:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("an evaluator disagrees with its host recomputation")

    y = torch.as_tensor(val.y, device="cuda", dtype=torch.float64)
    w = torch.ones_like(y)
    padded = pad_groups(uids, raw, y, w)
    timing = {}
    for ev in suite.evaluators:
        fn = ev.metric_fn()
        if ev.group_name is None:
            timing[ev.name] = dict(ms=_median_event_ms(lambda: fn(raw, y, w)))
        else:
            timing[ev.name] = dict(
                ms=_median_event_ms(lambda: ev.evaluate(raw, y, w, uids)),
                without_layout_ms=_median_event_ms(
                    lambda: grouped_mean(fn(*padded), padded[2])))
    layout_ms = _median_event_ms(lambda: pad_groups(uids, raw, y, w))
    ids_ms = _median_event_ms(lambda: torch.as_tensor(uids, device="cuda"))
    log(f"evaluator times on the card (CUDA events, median of {SUITE_TIMING_REPS}): "
        + ", ".join(f"{k} {v['ms']:.3f} ms" + (f" ({v['without_layout_ms']:.3f} ms on the "
                                                "padded layout)" if len(v) > 1 else "")
                    for k, v in timing.items())
        + f"; the padded layout alone {layout_ms:.3f} ms, of it the ids' host-to-device "
        f"copy {ids_ms:.3f} ms (its host part; the largest group's size is the one read "
        "back)")
    stats["evaluation_suite"] = dict(values=values, host=host, suite_s=t_suite,
                                     host_s=t_host, timing=timing, layout_ms=layout_ms,
                                     ids_upload_ms=ids_ms)


# Phase 24: narrow design storage.  The fused kernels' storage-width cases
# (n, d, storage, accumulation, rows skipped at X's start): the main paths'
# shapes, odd rows (d = 3 and 257 at 2 bytes: 6- and 514-byte rows, whose
# tile spans start and end off the 16-byte grid), X rows 1.. of a
# contiguous tensor (data_ptr % 16 == 2 at d = 257: a lone 2-byte element
# ahead of the first 4-byte word), n below one tile, and float64
# accumulation
NARROW_FUSED_CASES = [(MAIN_N, MAIN_D, "bfloat16", "float32", 0),
                      (GLMIX2_N, GLMIX2_D, "bfloat16", "float32", 0),
                      (GLMIX2_N, NORM_VAR_II + 1, "bfloat16", "float32", 0),
                      (GLMIX2_N, GLMIX2_D, "float16", "float32", 0),
                      (100_003, 3, "bfloat16", "float32", 0),
                      (100_003, 129, "float16", "float32", 0),
                      (7, 256, "bfloat16", "float32", 0),
                      (100_003, 257, "bfloat16", "float32", 1),
                      (100_003, 3, "float16", "float32", 1),
                      (100_003, 129, "bfloat16", "float64", 0),
                      (100_001, 5, "float16", "float64", 1)]
NARROW_TILE_PLUS_ONE = [(257, "bfloat16"), (512, "float16")]  # n = the plan's tile + 1
NARROW_TIMED = [(MAIN_N, MAIN_D, "bfloat16"), (GLMIX2_N, GLMIX2_D, "bfloat16"),
                (GLMIX2_N, NORM_VAR_II + 1, "bfloat16"), (GLMIX2_N, GLMIX2_D, "float16")]
# newton_step with x_t at a storage width: (d, cap, lanes, storage, solver dtype)
NARROW_NEWTON = [(MAIN_DU, MAIN_CAP, MAIN_USERS, "bfloat16", "float32"),
                 (MAIN_DU, MAIN_CAP, MAIN_USERS, "float16", "float32"),
                 (16, 16, 1000, "bfloat16", "float32"), (1, 32, 1000, "float16", "float32"),
                 (4, 32, 1000, "bfloat16", "float64")]
NARROW_CHUNK_ROWS = 1 << 19  # a narrow design is drawn in float32 a chunk at a time
BF16_FIXED_TOL, BF16_USER_TOL = 0.08, 0.15  # bf16 against float32 fits, rtol and atol:
# the reference's own gate (tests/test_game.py, test_storage_dtype_mixed_precision_fit)
BF16_AUC_TOL = 5e-3  # |training AUC(bf16) - AUC(float32)| on the same data


def _narrow_glm_batch(n, d, storage, acc, gen, skip_rows=0, scale=0.05):
    """(w, batch) on the card with X at ``storage`` (rows ``skip_rows``.. of a
    contiguous tensor, drawn in float32 chunks and rounded), w at the
    storage width (the effective coefficients as ``GLMObjective`` hands them
    to the kernels), y / offset / weight at ``acc``."""
    import torch

    from photon_ml_tpu_torch.core.batch import DenseBatch

    dev, sd, at = "cuda", getattr(torch, storage), getattr(torch, acc)
    x = torch.empty((n + skip_rows, d), dtype=sd, device=dev)
    for lo in range(0, n + skip_rows, NARROW_CHUNK_ROWS):
        hi = min(lo + NARROW_CHUNK_ROWS, n + skip_rows)
        x[lo:hi] = torch.randn((hi - lo, d), generator=gen, device=dev).to(sd)
    y = (torch.rand(n, generator=gen, device=dev) < 0.4).to(at)
    off = torch.randn(n, generator=gen, device=dev, dtype=at) * 0.1
    wt = torch.rand(n, generator=gen, device=dev, dtype=at) + 0.5
    wt[::10] = 0.0
    w = (torch.randn(d, generator=gen, device=dev) * (scale / max(1, d) ** 0.5)).to(sd)
    return w, DenseBatch(x=x[skip_rows:], y=y, offset=off, weight=wt)


def _narrow_fused_cases():
    import torch

    from photon_ml_tpu_torch.ops import fused_glm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = list(NARROW_FUSED_CASES)
    for d, storage in NARROW_TILE_PLUS_ONE:
        item = getattr(torch, storage).itemsize
        cases.append((fused_glm.launch_plan(10**6, d, item, sms, 4).tile_rows + 1, d,
                      storage, "float32", 0))
    return cases


def phase_narrow_kernels(stats: dict):
    """24(d) and (e): the storage-width instantiations of kernels 1, 2 and 3
    against their plain versions on the card (F32_KERNEL_RTOL, or
    F64_KERNEL_RTOL at float64 accumulation; kernels 1 and 2 twice, bitwise
    equal; kernel 3 within phase 4's gate against a float64 evaluation of the
    same narrow inputs), then each main-path shape timed as phases 3 and 4
    time theirs, with the launches of the phase 24 path that runs it."""
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_hvp_plain,
                                                   fused_value_and_grad,
                                                   fused_value_and_grad_plain,
                                                   launch_plan)
    from photon_ml_tpu_torch.ops.soa_newton import newton_step, newton_step_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    losses = (L.logistic_loss, L.squared_loss, L.poisson_loss, L.smoothed_hinge_loss)
    shift, v_shift = 0.03, -0.02
    paths = {(MAIN_N, MAIN_D, "bfloat16"): "glmix_chip_bf16",
             (GLMIX2_N, GLMIX2_D, "bfloat16"): "glmix2_tron_bf16"}
    for n, d, storage, acc, skip in _narrow_fused_cases():
        w, b = _narrow_glm_batch(n, d, storage, acc, gen, skip)
        v = (torch.randn(d, generator=gen, device="cuda") / max(1, d) ** 0.5).to(w.dtype)
        tol = F32_KERNEL_RTOL if acc == "float32" else F64_KERNEL_RTOL
        plan = launch_plan(n, d, b.x.element_size(), sms, b.y.element_size())
        tag = (f"n={n} d={d} {storage} in {acc}"
               + (f" data_ptr%16={b.x.data_ptr() % 16}" if skip else ""))
        log(f"fused {tag}: {_plan_text(plan)}")
        errs = {}
        for loss in losses:
            def fvg():
                return fused_value_and_grad(loss, w, b, margin_shift=shift)

            def hvp():
                return fused_hvp(loss, w, v, b, margin_shift=shift, v_shift=v_shift)

            errs[("fused_value_and_grad", loss.name)] = _check_close(
                f"fused_value_and_grad {tag} {loss.name} (value grad rsum)", fvg(), fvg(),
                fused_value_and_grad_plain(loss, w, b, margin_shift=shift), tol)
            errs[("fused_hvp", loss.name)] = _check_close(
                f"fused_hvp {tag} {loss.name} (Xtq sum q)", hvp(), hvp(),
                fused_hvp_plain(loss, w, v, b, margin_shift=shift, v_shift=v_shift), tol)
        if acc == "float32" and not skip and (n, d, storage) in NARROW_TIMED:
            path = paths.get((n, d, storage))
            launches = {k: (path, stats[k]["launches_by_path"].get(path, 0) if path else 0)
                        for k in ("fused_value_and_grad", "fused_hvp")}
            _time_fused(stats, n, d, w, v, b, shift, v_shift, gen, launches)
            for k in ("fused_value_and_grad", "fused_hvp"):
                stats[k]["by_shape"][f"{n}x{d} {storage}"]["max_abs_err"] = \
                    errs[(k, "logistic")]
        del w, v, b
        torch.cuda.empty_cache()

    for d, cap, nl, storage, acc in NARROW_NEWTON:
        w, g, x, y, off, wt, l2 = _soa_inputs(d, cap, nl, getattr(torch, acc), gen)
        x = x.to(getattr(torch, storage))
        args = (w, g, x, y, off, wt, l2)
        for loss in (L.logistic_loss, L.squared_loss, L.poisson_loss):
            k = newton_step(loss, *args)
            p = newton_step_plain(loss, *args)
            ref = newton_step_plain(loss, *[a.double() for a in args])
            e_k, e_p = rel_err(k, ref), rel_err(p, ref)
            tol = max(NEWTON_F32_FACTOR * e_p, 1e-5) if acc == "float32" else F64_KERNEL_RTOL
            ok = e_k <= tol and bool(torch.isfinite(k).all())
            log(f"newton_step d={d} cap={cap} L={nl} x_t {storage}, {acc} {loss.name}: rel "
                f"err vs plain {rel_err(k, p):.2e}, vs float64 of the same inputs: kernel "
                f"{e_k:.2e}, plain {e_p:.2e} (tol {tol:.2e}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"newton_step disagrees at d={d} cap={cap} L={nl} "
                                     f"x_t {storage} {loss.name}")
        if (d, cap, nl, acc) == (MAIN_DU, MAIN_CAP, MAIN_USERS, "float32"):
            _time_narrow_newton(stats, storage, args)


def _time_narrow_newton(stats, storage, args):
    """newton_step's times at glmix_chip's per-user shape with x_t at a
    storage width (phase 4's measurements; the yardstick widens x_t)."""
    import torch

    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.ops.soa_newton import newton_step, newton_step_plain

    loss = L.logistic_loss
    w, x = args[0], args[2]
    d, nl = w.shape
    cap = x.shape[0]
    ms = cuda_ms(lambda: newton_step(loss, *args), 20)
    prof = profiled(lambda: newton_step(loss, *args), 20, ("newton_step_kernel",))
    plain_ms = cuda_ms(lambda: newton_step_plain(loss, *args), 5)
    lib_ms = cuda_ms(lambda: _library_newton(loss, *args[:2], x.float(), *args[3:]), 5)
    nbytes = cap * d * nl * x.element_size() + (3 * cap * nl + 3 * d * nl + nl) * 4
    flops = nl * (cap * (2 * d + 10 + d + d * (d + 1)) + d ** 3 // 3 + 2 * d * d)
    bound, by = _bound(nbytes, flops)
    log(f"newton_step timing d={d} cap={cap} L={nl} x_t {storage} logistic: kernel "
        f"{ms:.4f} ms (events; device alone {prof['device_ms']:.4f} ms, "
        f"{prof['syncs_per_call']:g} stream syncs and {prof['htod_per_call']:g} HtoD "
        f"copies per call), plain {plain_ms:.3f} ms, library (einsum on x_t widened to "
        f"float32 + cholesky + cholesky_solve) {lib_ms:.3f} ms, bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP), "
        f"{bound / prof['device_ms']:.0%} of bound")
    if prof["syncs_per_call"] or prof["htod_per_call"]:
        raise AssertionError("newton_step syncs or copies to the card")
    path = "glmix_chip_bf16" if storage == "bfloat16" else None
    st = stats["newton_step"]
    st.setdefault("by_shape", {})[f"{d}x{cap}x{nl} {storage}"] = dict(
        ms=ms, device_ms=prof["device_ms"], plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound, bound_by=by, max_abs_err=abs_err(newton_step(loss, *args),
                                                         newton_step_plain(loss, *args)),
        path=path, launches=st["launches_by_path"].get(path, 0) if path else 0,
        library="einsum + cholesky + cholesky_solve, x_t widened to float32")


def _bf16_vs_f32(label, model, f32_model, auc, f32_auc) -> dict:
    """The reference's bf16-against-float32 gate on one model pair: fixed
    coefficients within rtol and atol BF16_FIXED_TOL, the per-user stack
    within BF16_USER_TOL (elementwise, numpy.allclose), and the training AUCs
    within BF16_AUC_TOL."""
    import numpy as np

    fb = np.asarray(model["fixed"].coefficients.means, np.float64)
    ff = np.asarray(f32_model["fixed"].coefficients.means, np.float64)
    ub = np.asarray(model["per-user"].w_stack, np.float64)
    uf = np.asarray(f32_model["per-user"].w_stack, np.float64)
    if model["per-user"].slot_of != f32_model["per-user"].slot_of:
        raise AssertionError(f"{label}: the bf16 and float32 models have other entities")
    # the largest |a - b| - atol - rtol |b|: <= 0 passes numpy.allclose
    excess = lambda a, b, t: float((np.abs(a - b) - t - t * np.abs(b)).max())
    out = dict(fixed_excess=excess(fb, ff, BF16_FIXED_TOL),
               user_excess=excess(ub, uf, BF16_USER_TOL),
               fixed_rel=rel_err(fb, ff), user_rel=rel_err(ub, uf),
               auc_diff=abs(auc - f32_auc))
    ok = out["fixed_excess"] <= 0 and out["user_excess"] <= 0 and \
        out["auc_diff"] <= BF16_AUC_TOL
    log(f"{label} against float32: fixed max rel diff {out['fixed_rel']:.2e} (allclose at "
        f"{BF16_FIXED_TOL}: excess {out['fixed_excess']:.3g}), per-user {out['user_rel']:.2e} "
        f"(allclose at {BF16_USER_TOL}: excess {out['user_excess']:.3g}), AUC {auc:.5f} vs "
        f"{f32_auc:.5f}, |diff| {out['auc_diff']:.2e} (tol {BF16_AUC_TOL:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: bf16 storage moves the fit beyond the reference's "
                             "bf16-vs-float32 gate")
    return out


def phase_glmix_chip_bf16(stats: dict, host: dict):
    """24(a): glmix_chip at full width with storage_dtype "bfloat16" on both
    coordinates (the reference's chip settings, bench.py run_glmix_chip): the
    [n, 512] design generated at bf16 on the card (8.59 GB), fitted through
    GameEstimator.fit with the kernel-1 and kernel-3 launches counted; X held
    at 2 bytes an element, the peak allocation from data generation to the
    end of the fit below the float32 design's 17.2 GB, AUC >= AUC_FLOOR, and
    the reference's bf16-vs-float32 gate against phase 5's float32 fit of
    the same data."""
    import torch

    from photon_ml_tpu_torch.data.synthetic import chip_design
    from photon_ml_tpu_torch.game import GameData

    f32_bytes = MAIN_N * MAIN_D * 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    xg = chip_design(host["n"], "cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    gen_peak = torch.cuda.max_memory_allocated()
    log(f"glmix_chip-bf16 data: design {tuple(xg.shape)} {xg.dtype}, "
        f"{xg.element_size()} bytes an element, {xg.numel() * xg.element_size() / 1e9:.2f} GB "
        f"on the card (float32: {f32_bytes / 1e9:.2f} GB); generated in "
        f"{time.perf_counter() - t0:.2f} s, peak {gen_peak / 1e9:.2f} GB "
        f"({held / 1e9:.2f} GB held before)")
    if xg.element_size() != 2:
        raise AssertionError("glmix_chip-bf16's design is not 2 bytes an element")
    data = GameData(y=host["y"], features={"g": xg, "u": host["xu"]},
                    id_tags={"userId": host["uids"]})
    res, _, auc = _drive("glmix_chip_bf16", data, _glmix_config(storage="bfloat16"), stats,
                         required=("fused_value_and_grad", "newton_step"))
    peak = max(gen_peak, torch.cuda.max_memory_allocated())
    ok = peak < f32_bytes and auc >= AUC_FLOOR
    log(f"glmix_chip-bf16: peak device memory from data generation to the end of the fit "
        f"{peak / 1e9:.2f} GB (gate: below the float32 design's {f32_bytes / 1e9:.2f} GB), "
        f"AUC {auc:.4f} (gate: >= {AUC_FLOOR}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("glmix_chip-bf16 peak memory or AUC gate failed")
    if res.model["fixed"].coefficients.means.dtype.name != "float32":
        raise AssertionError("glmix_chip-bf16 publishes coefficients that are not float32")
    f32 = stats["glmix_chip"]
    stats["glmix_chip_bf16"].update(peak_gb=peak / 1e9, **_bf16_vs_f32(
        "glmix_chip-bf16", res.model, f32["model"], auc, f32["auc"]))
    log(f"glmix_chip-bf16 vs glmix_chip on this card: fit {stats['glmix_chip_bf16']['fit_s']:.2f}"
        f" s vs {f32['fit_s']:.2f} s")
    return xg


def phase_glmix2_tron_bf16(stats: dict):
    """24(b): glmix2 under TRON on both coordinates with storage_dtype
    "bfloat16" (bench.py's PHOTON_BENCH_STORAGE), the designs rounded once on
    the host (synth_glmix's storage option): kernels 1 and 2 on the fixed
    effect, the lane TRON over a narrow LaneObjective on the per-user one;
    AUC against the Bayes AUC and the bf16-vs-float32 gate against phase 7."""
    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.types import OptimizerType

    host = synth_glmix(1, three=False, storage="bfloat16")
    data = _baseline_data(host)
    res, _, auc = _drive("glmix2_tron_bf16", data,
                         _baseline_config(False, OptimizerType.TRON, storage="bfloat16"),
                         stats, required=("fused_value_and_grad", "fused_hvp"))
    _check_bayes("glmix2_tron_bf16", auc, _bayes_auc(host))
    f32 = stats["glmix2_tron"]
    stats["glmix2_tron_bf16"].update(**_bf16_vs_f32(
        "glmix2-TRON-bf16", res.model, f32["model"], auc, f32["auc"]))


def phase_narrow_card_vs_cpu(host: dict, xg):
    """24(c): both phase 24 configurations at REDUCED_USERS users on the card
    and on the CPU from the same bf16 inputs, within F32_PATH_RTOL or
    F32_SPREAD_MULTIPLE x the CPU fit's own spread where larger: CPU fits
    with every row weight moved by one float32 ulp (the weights stay at
    float32 under narrow storage), one per seed of F32_SPREAD_SEEDS."""
    import numpy as np

    from photon_ml_tpu_torch.data.synthetic import synth_glmix
    from photon_ml_tpu_torch.game import GameData
    from photon_ml_tpu_torch.types import OptimizerType

    m = REDUCED_USERS * host["per_user"]
    chip = dict(y=host["y"][:m], id_tags={"userId": host["uids"][:m]})
    glmix2 = synth_glmix(REDUCED_GLMIX2_SCALE, three=False, storage="bfloat16")
    cases = [
        (f"glmix_chip-bf16 at {REDUCED_USERS} users ({m} rows)",
         GameData(features={"g": xg[:m].clone(), "u": host["xu"][:m]}, **chip),
         GameData(features={"g": xg[:m].cpu(), "u": host["xu"][:m]}, **chip),
         _glmix_config(storage="bfloat16")),
        (f"glmix2-TRON-bf16 at scale {REDUCED_GLMIX2_SCALE}", _baseline_data(glmix2),
         _baseline_data(glmix2),
         _baseline_config(False, OptimizerType.TRON, storage="bfloat16"))]
    for label, gpu, cpu, cfg in cases:
        def spread_tols(rc, sc, label=label, cpu=cpu, cfg=cfg):
            spreads = []
            for seed in F32_SPREAD_SEEDS[:2]:
                rng = np.random.default_rng(seed)
                wt = (1 + np.float32(2 ** -23) * rng.choice(np.float32([-1, 1]),
                                                            cpu.num_samples))
                nudged = GameData(y=cpu.y, features=cpu.features, id_tags=cpu.id_tags,
                                  weight=wt.astype(np.float32))
                rn, sn, _, _, _ = _fit_and_score(nudged, "cpu", cfg)
                sp = _model_errors(label, rn.model, rc.model, ["per-user"])
                sp["scores"] = rel_err(sn, sc)
                spreads.append(sp)
            log(f"card vs CPU, {label}: the float32 CPU fit's own spread under one-ulp "
                f"nudges of the row weights, seeds {F32_SPREAD_SEEDS[:2]}: "
                + "; ".join(", ".join(f"{k} {v:.2e}" for k, v in sp.items())
                            for sp in spreads))
            return {k: max(F32_PATH_RTOL, F32_SPREAD_MULTIPLE * max(sp[k] for sp in spreads))
                    for k in spreads[0]}

        _compare_fits(label, gpu, cpu, cfg, ["per-user"], tols=spread_tols)


# -- phase 25: host syncs and device idle share per fit -----------------------

SYNC_TOP_SITES = 8  # sync sites listed per cell, most frequent first
LOOP_FORM_BEFORE_SYNCS = 1552  # the four cells' update syncs before the solvers'
# loop form (PERF.md section 5)
# what torch's sync debug mode puts in each sync's warning; its notice that the
# mode is a prototype ("... synchronizing operations"), once a process on the
# first switch to "warn", is no sync
SYNC_MESSAGE = "called a synchronizing CUDA operation"
MARK_KERNEL, MARK_CYCLES = "spin_kernel", 1000  # torch.cuda._sleep's kernel marks
# where the descent starts and ends on the card's timeline
LAUNCH_CALL = re.compile(r"^cu(da)?Launch\w*Kernel")  # the host's CUDA API
# calls that launch one kernel (cudaLaunchKernel, cuLaunchKernelEx, ...)
COPY_OR_SET = ("Memcpy", "Memset")  # device records that are no kernel
TRACK_AB_CELLS = ("glmix3",)  # lane cells whose fit is timed with and without
TRACK_AB_ORDER = (False, True, True, False, False, True)  # the solvers' state
# tracking, in this order (off, on, on, off, off, on)
TRACED_KERNELS = {"fused_value_and_grad": "fvg_partial_kernel",
                  "fused_hvp": "hvp_partial_kernel",
                  "newton_step": "newton_step_kernel", "match_dot": "match_dot_kernel"}


def _sync_cells(host: dict):
    """(cell, a function making its data, config) of phase 25's four
    cells, each built as phases 5, 7, 8 and 12 build it; ``host`` is phase
    5's host data."""
    from photon_ml_tpu_torch.data.synthetic import (chip_design, synth_glmix,
                                                    synth_glmix_sparse)
    from photon_ml_tpu_torch.game import GameData
    from photon_ml_tpu_torch.types import OptimizerType

    def glmix_chip():
        return GameData(y=host["y"], features={"g": chip_design(host["n"], "cuda"),
                                               "u": host["xu"]},
                        id_tags={"userId": host["uids"]})

    return [("glmix_chip", glmix_chip, _glmix_config()),
            ("glmix2_tron", lambda: _baseline_data(synth_glmix(1, three=False)),
             _baseline_config(False, OptimizerType.TRON)),
            ("glmix3", lambda: _baseline_data(synth_glmix(1, three=True)),
             _baseline_config(True, OptimizerType.LBFGS)),
            ("glmix_sparse", lambda: _glmix_sparse_data(synth_glmix_sparse(1)),
             _glmix_sparse_config())]


def _coefficients(model) -> dict:
    """Each coordinate's published coefficients (fixed means, random-effect
    stacks) as host arrays."""
    return {cid: (m.coefficients.means if hasattr(m, "coefficients") else m.w_stack)
            for cid, m in model.models.items()}


def _coefficient_diff(a: dict, b: dict) -> float:
    import numpy as np

    return max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
                     .max(initial=0.0)) for k in a)


def _tracker_lines() -> set:
    """(file, line) of the StateTracker's own code and of every solver line
    that makes or records into a tracker."""
    import inspect
    import os

    from photon_ml_tpu_torch.opt import lbfgs, solve, tron, types

    lines = set()
    for obj in (types.StateTracker, types.new_tracker):
        src, start = inspect.getsourcelines(obj)
        path = os.path.realpath(inspect.getsourcefile(obj))
        lines |= {(path, start + i) for i in range(len(src))}
    for mod in (lbfgs, tron, solve):
        path = os.path.realpath(inspect.getsourcefile(mod))
        with open(path) as f:
            lines |= {(path, i) for i, text in enumerate(f, 1) if "tracker" in text}
    return lines


def _port_frames() -> list:
    """(file, line) of the photon_ml_tpu_torch frames on the calling
    thread's stack, innermost first."""
    import os

    pkg = str(Path(__file__).resolve().parent / "photon_ml_tpu_torch") + os.sep
    frames, f = [], sys._getframe(1)
    while f is not None:
        path = os.path.realpath(f.f_code.co_filename)
        if path.startswith(pkg):
            frames.append((path, f.f_lineno))
        f = f.f_back
    return frames


def _site(frame) -> str:
    """A port frame's file:line relative to the package."""
    pkg = str(Path(__file__).resolve().parent / "photon_ml_tpu_torch") + "/"
    path, line = frame
    return f"{path[len(pkg):] if path.startswith(pkg) else path}:{line}"


def _helper_site() -> tuple:
    """(file, line) of ``opt/loop.while_loop``'s host read, the one host
    read of every solver loop."""
    import inspect
    import os

    from photon_ml_tpu_torch.opt import loop

    src, start = inspect.getsourcelines(loop.while_loop)
    line = start + next(i for i, text in enumerate(src) if "bool(cond(state))" in text)
    return os.path.realpath(inspect.getsourcefile(loop.while_loop)), line


def _upload_lines() -> set:
    """(file, line) of the coordinates' host-array upload helper
    (``game/coordinate._as_device``), which no update may reach."""
    import inspect
    import os

    import photon_ml_tpu_torch.game.coordinate as coord_mod

    src, start = inspect.getsourcelines(coord_mod._as_device)
    path = os.path.realpath(inspect.getsourcefile(coord_mod._as_device))
    return {(path, start + i) for i in range(len(src))}


def _solve_trips(coord, results) -> list:
    """Per solve of one update: (valid lanes, loop trips = the most
    iterations of any valid lane, [(num_states, iterations)] of its valid
    lanes where it tracked states).  A scalar solve is one lane."""
    import numpy as np
    import torch

    if not isinstance(results, (list, tuple)):
        results, masks = [results], [None]
    else:
        masks = [np.asarray(b.entity_lanes) >= 0 for b in coord.buckets.buckets]
    out = []
    for res, mask in zip(results, masks):
        its = np.atleast_1d(torch.as_tensor(res.iterations).cpu().numpy())
        mask = np.ones(its.shape, bool) if mask is None else mask
        pairs = []
        if res.tracker is not None:
            states = np.atleast_1d(res.tracker.num_states.cpu().numpy())
            pairs = list(zip(states[mask].tolist(), its[mask].tolist()))
        out.append((int(mask.sum()), int(its[mask].max(initial=0)), pairs))
    return out


def _syncs_during(fn, syncs=None, stacks=None, frames=True):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` inside
    ``warnings.catch_warnings(record=True)`` with every warning let through:
    each sync's warning is kept (appended to ``syncs`` as it happens) with
    the port's frames on the stack when it was raised, innermost first, so
    a sync names the Python line that made the card wait and the lines that
    called it (with ``frames`` False an empty list, for a count of
    thousands of syncs without walking each one's stack); ``stacks``, where
    given, takes each sync's whole stack as text.  The debug mode and the warning filters are restored in a
    ``finally``.  Returns (its result, the syncs)."""
    import traceback
    import warnings

    import torch

    syncs = [] if syncs is None else syncs

    def shown(message, *args, **kwargs):
        if SYNC_MESSAGE in str(message):
            syncs.append(_port_frames() if frames else [])
            if stacks is not None:
                stacks.append("".join(traceback.format_stack(limit=14)[:-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = shown  # restored by catch_warnings
        try:
            torch.cuda.set_sync_debug_mode("warn")
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, syncs


def _counted_fit(data, config) -> dict:
    """One host-loop ``GameEstimator.fit`` with its syncs kept
    (``_syncs_during``).  Wrappers mark where the descent starts and where
    each update ends (``DescentHistory.add``) and keep each update's
    coordinate and solver results; all are restored in a ``finally``."""
    import collections

    import photon_ml_tpu_torch.game.coordinate as coord_mod
    import photon_ml_tpu_torch.game.descent as descent
    from photon_ml_tpu_torch.game import GameEstimator
    from photon_ml_tpu_torch.opt import lbfgs, linesearch, loop, newton_soa, tron

    syncs, marks, updates = [], [], []
    real = dict(run=descent.CoordinateDescent.run, add=descent.DescentHistory.add,
                fixed=coord_mod.FixedEffectCoordinate.update,
                random=coord_mod.RandomEffectCoordinate.update)
    solver_modules = (linesearch, lbfgs, tron, newton_soa)
    # per solver loop, by the line that runs it: loops entered, trips, and
    # the qualified name of its body
    loops = collections.defaultdict(collections.Counter)
    bodies = {}

    def counted_loop(cond, body, state):
        site = _site(_port_frames()[0])
        loops[site]["loops"] += 1
        bodies[site] = body.__qualname__

        def trip(st):
            loops[site]["trips"] += 1
            return body(st)

        return loop.while_loop(cond, trip, state)

    def keep_results(update):
        def wrapped(self, *args, **kwargs):
            model, results = update(self, *args, **kwargs)
            updates.append((self, results))
            return model, results
        return wrapped

    def run(self, *args, **kwargs):
        marks.append(("construction", len(syncs)))
        return real["run"](self, *args, **kwargs)

    def add(self, iteration, coordinate_id, *args, **kwargs):
        marks.append((f"it{iteration} {coordinate_id}", len(syncs)))
        return real["add"](self, iteration, coordinate_id, *args, **kwargs)

    descent.CoordinateDescent.run = run
    descent.DescentHistory.add = add
    coord_mod.FixedEffectCoordinate.update = keep_results(real["fixed"])
    coord_mod.RandomEffectCoordinate.update = keep_results(real["random"])
    for mod in solver_modules:
        mod.while_loop = counted_loop
    try:
        res, _ = _syncs_during(
            lambda: GameEstimator(device="cuda", fused=False).fit(data, [config])[0], syncs)
    finally:
        descent.CoordinateDescent.run = real["run"]
        descent.DescentHistory.add = real["add"]
        coord_mod.FixedEffectCoordinate.update = real["fixed"]
        coord_mod.RandomEffectCoordinate.update = real["random"]
        for mod in solver_modules:
            mod.while_loop = loop.while_loop
    parts = {"construction": marks[0][1],
             "updates": {label: pos - marks[k][1]
                         for k, (label, pos) in enumerate(marks[1:])},
             "after": len(syncs) - marks[-1][1]}
    return dict(res=res, syncs=syncs, parts=parts, updates=updates,
                update_syncs=syncs[marks[0][1]:marks[-1][1]], loops=loops, bodies=bodies)


def _loop_syncs(cell: str, counted: dict) -> dict:
    """Gates on a counted fit's update syncs: each one whose innermost
    port frame is in ``opt/`` is the loop helper's read, no update uploads
    through ``game/coordinate._as_device``, and each solver loop reads once
    a trip and once where it ends.  Returns per loop (by the line that runs
    it) its syncs, trips, loops and syncs a trip."""
    import collections
    import os

    helper = _helper_site()
    opt_dir = os.path.dirname(helper[0]) + os.sep
    upd = counted["update_syncs"]
    off_helper = collections.Counter(_site(s[0]) for s in upd
                                     if s and s[0][0].startswith(opt_dir) and s[0] != helper)
    if off_helper:
        raise AssertionError(f"{cell}: update syncs in opt/ off the loop helper: "
                             f"{dict(off_helper)}")
    uploads = [s for s in upd if s and s[0] in _upload_lines()]
    if uploads:
        raise AssertionError(f"{cell}: {len(uploads)} update syncs upload through "
                             f"game/coordinate._as_device, from "
                             f"{sorted(set(' < '.join(map(_site, s[:3])) for s in uploads))}")
    by_loop = collections.Counter(_site(s[1]) if len(s) > 1 else "outside the package"
                                  for s in upd if s and s[0] == helper)
    levels = {}
    for site, c in counted["loops"].items():
        n = by_loop.pop(site, 0)
        levels[site] = dict(body=counted["bodies"][site], syncs=n, trips=c["trips"],
                            loops=c["loops"], syncs_per_trip=n / max(c["trips"], 1))
        if n != c["trips"] + c["loops"]:
            raise AssertionError(f"{cell}: the loop at {site} read {n} times in "
                                 f"{c['trips']} trips of {c['loops']} loops")
    if by_loop:
        raise AssertionError(f"{cell}: helper reads from loops not counted: {dict(by_loop)}")
    return levels


def _busy_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` (start, end) clipped to [lo, hi]."""
    busy, reach = 0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            busy += end - start
            reach = end
    return busy


def _profiled_fit(data, config) -> dict:
    """One ``GameEstimator.fit`` under ``torch.profiler`` (CPU and CUDA
    activity; with CUDA activity alone traces lost device records, in two
    of four cells a descent mark): the device idle share, 1 - (union of the
    device's kernel, memcpy and memset intervals) / (wall time).  Over the
    fit: every device record of the trace is the fit's, over the fit's host
    wall time.  Over its descent: between two ``torch.cuda._sleep`` marks
    that the card runs when the descent starts and ends (after a sync
    each), on the card's own clock; None where the trace lost a mark.  Also
    the records the trace lost: each kernel's device records against its
    launch counter, and the host's kernel launch calls whose correlation id
    has no device kernel record (by count where the trace's ids do not pair
    up), the marks included.  The trace's raw events are read, without
    building the profiler's event tree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import photon_ml_tpu_torch.game.descent as descent
    from photon_ml_tpu_torch.game import GameEstimator

    real_run = descent.CoordinateDescent.run

    def mark():
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)

    def run(self, *args, **kwargs):
        mark()
        try:
            return real_run(self, *args, **kwargs)
        finally:
            mark()

    kernels = _zero_launches()
    descent.CoordinateDescent.run = run
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            res = GameEstimator(device="cuda", fused=False).fit(data, [config])[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
    finally:
        descent.CoordinateDescent.run = real_run
    launches = {name: k.launches for name, k in kernels.items()}
    device, marks, calls, ran = [], [], [], set()
    records = dict.fromkeys(TRACED_KERNELS, 0)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            if LAUNCH_CALL.match(name):
                calls.append(e.correlation_id())
            continue
        if not name.startswith(COPY_OR_SET):
            ran.add(e.correlation_id())
        if MARK_KERNEL in name:
            marks.append((e.start_ns(), e.end_ns()))
            continue
        device.append((e.start_ns(), e.end_ns()))
        for k, sym in TRACED_KERNELS.items():
            records[k] += sym in name
    if ran & set(calls):
        unrecorded = sum(c not in ran for c in calls)
    else:  # ids that do not pair up: compare the counts
        unrecorded = max(len(calls) - len(ran), 0)
    busy = _busy_ns(device, -(1 << 62), 1 << 62)
    shares = dict(fit=dict(wall_ms=wall * 1e3, busy_ms=busy / 1e6,
                           idle_share=1.0 - busy / (wall * 1e9)),
                  updates=dict(wall_ms=None, busy_ms=None, idle_share=None))
    if len(marks) == 2:
        (_, lo), (hi, _) = sorted(marks)
        busy = _busy_ns(device, lo, hi)
        shares["updates"] = dict(wall_ms=(hi - lo) / 1e6, busy_ms=busy / 1e6,
                                 idle_share=1.0 - busy / (hi - lo))
    return dict(res=res, wall_s=wall, shares=shares, launches=launches, records=records,
                device_events=len(device), marks=len(marks), launch_calls=len(calls),
                kernel_records=len(ran), unrecorded=unrecorded)


def _timed_fit(data, config) -> dict:
    """One untraced, uncounted ``GameEstimator.fit``: its wall time, and
    that of its descent, between a sync where the descent starts and one
    where it ends (as ``_profiled_fit``'s marks)."""
    import torch

    import photon_ml_tpu_torch.game.descent as descent
    from photon_ml_tpu_torch.game import GameEstimator

    real_run, descent_s = descent.CoordinateDescent.run, []

    def run(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real_run(self, *args, **kwargs)
        finally:
            torch.cuda.synchronize()
            descent_s.append(time.perf_counter() - t0)

    descent.CoordinateDescent.run = run
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = GameEstimator(device="cuda", fused=False).fit(data, [config])[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        descent.CoordinateDescent.run = real_run
    return dict(res=res, wall_s=wall, updates_s=sum(descent_s))


def _untracked(config):
    """``config`` with every coordinate's solver set to ``track_states=False``."""
    import dataclasses

    return dataclasses.replace(config, coordinates={
        cid: dataclasses.replace(c, solver=dataclasses.replace(c.solver, track_states=False))
        for cid, c in config.coordinates.items()})


def _tracking_ab(cell: str, data, config, base: dict, spread: float) -> dict:
    """More untraced fits of ``cell``, without and with the solvers' state
    tracking in TRACK_AB_ORDER: the least and the median wall time of the
    fit and of its descent each way.  Gate: the untracked fits'
    coefficients equal the tracked timed fit's, within ``spread``."""
    import statistics

    fits = {False: [], True: []}
    for track in TRACK_AB_ORDER:
        fit = _timed_fit(data, config if track else _untracked(config))
        fits[track].append(fit)
        if not track:
            diff = _coefficient_diff(_coefficients(fit["res"].model), base)
            if diff > spread:
                raise AssertionError(f"{cell}: track_states=False changed the fit by "
                                     f"{diff:.3e} (spread {spread:.3e})")
    row = {}
    for track, fs in fits.items():
        fit_s, upd_s = [f["wall_s"] for f in fs], [f["updates_s"] for f in fs]
        row["tracked" if track else "untracked"] = dict(
            fit_s_min=min(fit_s), fit_s_median=statistics.median(fit_s),
            updates_s_min=min(upd_s), updates_s_median=statistics.median(upd_s),
            fit_s_each=fit_s, updates_s_each=upd_s)
    on, off = row["tracked"], row["untracked"]
    log(f"{cell}: state tracking on / off over {len(TRACK_AB_ORDER)} fits "
        f"{['on' if t else 'off' for t in TRACK_AB_ORDER]}: descent least "
        f"{on['updates_s_min'] * 1e3:.1f} / {off['updates_s_min'] * 1e3:.1f} ms "
        f"({(on['updates_s_min'] / off['updates_s_min'] - 1) * 100:+.1f}%), median "
        f"{on['updates_s_median'] * 1e3:.1f} / {off['updates_s_median'] * 1e3:.1f} ms; "
        f"fit least {on['fit_s_min'] * 1e3:.1f} / {off['fit_s_min'] * 1e3:.1f} ms; "
        f"untracked coefficients within the spread")
    return row


def phase_sync_counts(stats: dict, host: dict):
    """Phase 25 (module docstring): per cell an uncounted timed fit, a
    counted fit and a profiled fit, and on TRACK_AB_CELLS the tracking
    A/B."""
    import collections

    import torch

    no_tracker = _tracker_lines()
    out = {}
    for cell, make_data, config in _sync_cells(host):
        clock = [time.perf_counter()]

        def lap() -> float:
            clock.append(time.perf_counter())
            return clock[-1] - clock[-2]

        data = make_data()
        t_data = lap()
        timed = _timed_fit(data, config)
        t_timed = lap()
        counted = _counted_fit(data, config)
        t_counted = lap()
        traced = _profiled_fit(data, config)
        t_traced = lap()

        # gates: the counted fit is the uncounted one, bitwise (or within
        # the spread of two uncounted fits where they differ)
        base = _coefficients(timed["res"].model)
        spread = _coefficient_diff(_coefficients(traced["res"].model), base)
        diff = _coefficient_diff(_coefficients(counted["res"].model), base)
        log(f"{cell}: counted fit vs uncounted: max |diff| {diff:.3e}; two uncounted "
            f"fits (timed, profiled): {spread:.3e} {'ok' if diff <= spread else 'MISMATCH'}")
        if diff > spread:
            raise AssertionError(f"{cell}: counting the syncs changed the fit")
        tracking = (_tracking_ab(cell, data, config, base, spread)
                    if cell in TRACK_AB_CELLS else None)
        t_tracking = lap()
        del data
        torch.cuda.empty_cache()
        syncs = counted["syncs"]
        if not syncs:
            raise AssertionError(f"{cell}: the counted fit saw no host sync")
        in_tracker = [s for s in syncs if any(f in no_tracker for f in s)]
        if in_tracker:
            raise AssertionError(f"{cell}: {len(in_tracker)} syncs in tracker code, from "
                                 f"{sorted(set(_site(s[0]) for s in in_tracker))}")
        levels = _loop_syncs(cell, counted)
        log(f"{cell}: update syncs by solver loop (the line running it: syncs / trips, "
            f"loops): " + "; ".join(
                f"{site} {v['body']}: {v['syncs']} / {v['trips']} = "
                f"{v['syncs_per_trip']:.3f} a trip, {v['loops']} loops"
                for site, v in sorted(levels.items())))

        trips, tracked = [], 0
        for coord, results in counted["updates"]:
            solves = _solve_trips(coord, results)
            trips.append(sum(t for _, t, _ in solves))
            for _, _, pairs in solves:
                bad = [(n, it) for n, it in pairs if n != it + 1]
                if bad:
                    raise AssertionError(f"{cell} {coord.coordinate_id}: num_states != "
                                         f"iterations + 1 on {len(bad)} lanes, e.g. {bad[:3]}")
                tracked += len(pairs)
            summary = coord.tracker_summary(results)
            lanes = sum(v for v, _, _ in solves)
            log(f"{cell} {coord.coordinate_id} tracker_summary: {summary}")
            if summary.get("count") != lanes:
                raise AssertionError(f"{cell} {coord.coordinate_id}: summary counts "
                                     f"{summary.get('count')} solves, not {lanes}")

        parts = counted["parts"]
        n_upd = sum(parts["updates"].values())
        top = collections.Counter(_site(s[0]) if s else "outside the package"
                                  for s in syncs).most_common(SYNC_TOP_SITES)
        chains = collections.Counter(" < ".join(_site(f) for f in s[:3])
                                     for s in syncs).most_common(SYNC_TOP_SITES)
        dropped = {k: (traced["records"][k], traced["launches"][k]) for k in TRACED_KERNELS
                   if traced["records"][k] < traced["launches"][k]}
        lost = bool(dropped) or traced["unrecorded"] > 0 or traced["marks"] != 2
        sh = traced["shares"]
        # the same device busy time over the untraced fit's wall times: the
        # trace's own host cost lengthens the traced fit
        untraced = dict(
            fit=1.0 - sh["fit"]["busy_ms"] / (timed["wall_s"] * 1e3),
            updates=(None if sh["updates"]["busy_ms"] is None else
                     1.0 - sh["updates"]["busy_ms"] / (timed["updates_s"] * 1e3)))
        row = dict(syncs=len(syncs), construction=parts["construction"],
                   updates=parts["updates"], after=parts["after"],
                   solver_trips=trips, syncs_per_trip=n_upd / max(sum(trips), 1),
                   tracked_solves=tracked, top_sites=top, top_chains=chains,
                   fit_s=timed["wall_s"], traced_fit_s=traced["wall_s"],
                   idle_fit=sh["fit"]["idle_share"], idle_updates=sh["updates"]["idle_share"],
                   busy_ms=sh["fit"]["busy_ms"], busy_updates_ms=sh["updates"]["busy_ms"],
                   updates_wall_ms=sh["updates"]["wall_ms"],
                   untraced_updates_ms=timed["updates_s"] * 1e3,
                   idle_fit_untraced=untraced["fit"], idle_updates_untraced=untraced["updates"],
                   device_events=traced["device_events"], records=traced["records"],
                   launches=traced["launches"], launch_calls=traced["launch_calls"],
                   kernel_records=traced["kernel_records"],
                   unrecorded_launches=traced["unrecorded"], marks=traced["marks"],
                   idle_is_upper_bound=lost, tracking=tracking, loops=levels,
                   seconds=dict(data=t_data, timed=t_timed, counted=t_counted,
                                traced=t_traced, tracking=t_tracking))
        log(f"{cell}: {len(syncs)} host syncs a fit: construction {parts['construction']}, "
            f"updates {parts['updates']}, after {parts['after']}; solver loop trips per "
            f"update {trips}, {row['syncs_per_trip']:.2f} update syncs a trip; "
            f"{tracked} tracked solves with num_states == iterations + 1")
        log(f"{cell}: top sync sites {top}")
        log(f"{cell}: top sync chains (innermost first) {chains}")
        bound = (f" (upper bounds: the trace lost records: {traced['unrecorded']} of "
                 f"{traced['launch_calls']} kernel launch calls without a device record, "
                 f"{traced['marks']} of 2 marks, kernels short of their counters "
                 f"{dropped})" if lost else "")
        upd = (f"updates not measured: the trace holds {traced['marks']} of the 2 marks"
               if sh["updates"]["idle_share"] is None else
               f"{sh['updates']['idle_share']:.4f} over the updates "
               f"({sh['updates']['wall_ms']:.1f} ms traced), "
               f"{untraced['updates']:.4f} over the untraced updates "
               f"({timed['updates_s'] * 1e3:.1f} ms)")
        log(f"{cell}: device idle share {sh['fit']['idle_share']:.4f} over the fit "
            f"({sh['fit']['wall_ms']:.1f} ms traced), {untraced['fit']:.4f} over the "
            f"untraced fit ({timed['wall_s'] * 1e3:.1f} ms), {upd}{bound}; "
            f"{traced['launch_calls']} kernel launch calls, {traced['kernel_records']} "
            f"device kernel records, {traced['unrecorded']} calls unrecorded; kernel "
            f"records / launches "
            f"{ {k: (traced['records'][k], traced['launches'][k]) for k in TRACED_KERNELS} }; "
            f"seconds: data {t_data:.2f}, timed fit {t_timed:.2f}, counted fit "
            f"{t_counted:.2f}, profiled fit and its trace {t_traced:.2f}, tracking "
            f"on / off {t_tracking:.2f}")
        out[cell] = row
    stats["sync_counts"] = out
    total = sum(sum(row["updates"].values()) for row in out.values())
    solver = sum(v["syncs"] for row in out.values() for v in row["loops"].values())
    log(f"phase 25: {total} update syncs over {', '.join(out)} (before the loop "
        f"form: {LOOP_FORM_BEFORE_SYNCS}), {solver} of them the solver loops' reads at "
        f"{_site(_helper_site())}; no update sync elsewhere in opt/ or in an upload")
    log("phase 25: " + json.dumps(out))


# -- phase 26: the fused sweep ------------------------------------------------

# the four cells' update syncs a fit in the host loop after the solvers' loop
# form (PERF.md section 5); the fused sweep's must lie below them
LOOP_FORM_UPDATE_SYNCS = {"glmix_chip": 169, "glmix2_tron": 108, "glmix3": 302,
                          "glmix_sparse": 302}
FUSED_TIMING_ORDER = ("host", "fused", "fused", "host", "host", "fused", "fused", "host",
                      "host", "fused")  # untraced descents, five each, in this order
FUSED_KERNELS = ("fused_value_and_grad", "fused_hvp", "newton_step")
GRID_SWEEP_KEYS = 2  # glmix_chip-grid: its four λ points share a sweep key; the
# down-sampled point has a key of its own (the rate is a config field)


def _profiled_busy(fn) -> dict:
    """``fn()`` under ``torch.profiler``, between syncs: its host wall time
    and the union of the device's kernel, memcpy and memset intervals in
    the trace (a trace that lost records makes an idle share from it an
    upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    device = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return dict(wall_ms=wall * 1e3, busy_ms=_busy_ns(device, -(1 << 62), 1 << 62) / 1e6,
                records=len(device))


def _fused_cells(host: dict):
    """Phase 26's cells: phase 25's four (``_sync_cells``) and
    glmix2-norm-var, each as (cell, a function making (data,
    normalization), config)."""
    from photon_ml_tpu_torch.data.synthetic import synth_glmix

    def norm_var():
        data, xg, xu = _norm_var_data(_with_intercept(synth_glmix(1, three=False)), "cuda")
        return data, _norm_var_contexts(xg, xu)[0]

    cells = [(cell, (lambda make=make: (make(), None)), config)
             for cell, make, config in _sync_cells(host)]
    return cells + [("glmix2_norm_var", norm_var, _norm_var_config())]


def _published(model) -> dict:
    """Each coordinate's published coefficients and variances, on the host."""
    out = {}
    for cid, m in model.models.items():
        if hasattr(m, "coefficients"):
            out[cid] = (m.coefficients.means, m.coefficients.variances)
        else:
            out[cid] = (m.w_stack, m.variances)
    return out


def _fused_equal_host(cell: str, fused, host) -> None:
    """Gate: the fused model's coefficients and variances bitwise the host
    loop's, the same entities."""
    import numpy as np

    a, b = _published(fused), _published(host)
    for cid in b:
        if hasattr(host[cid], "slot_of") and fused[cid].slot_of != host[cid].slot_of:
            raise AssertionError(f"{cell} {cid}: the fused and host models' entities differ")
        for kind, x, y in zip(("coefficients", "variances"), a[cid], b[cid]):
            if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
                diff = (None if x is None or y is None else
                        float(np.abs(np.asarray(x, np.float64) - y).max()))
                raise AssertionError(f"{cell} {cid}: fused {kind} differ from the host "
                                     f"loop's (max |diff| {diff})")


def phase_fused_sweep(stats: dict, host: dict):
    """Phase 26 (module docstring): per cell, the host loop and
    ``FusedSweep.run`` over the same coordinates; then glmix_chip-grid's
    five points through ``GameEstimator()``."""
    import statistics

    import torch

    import photon_ml_tpu_torch.game.estimator as est_mod
    from photon_ml_tpu_torch.data.synthetic import chip_design
    from photon_ml_tpu_torch.game import FusedSweep, GameEstimator
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.opt import loop

    helper = _helper_site()
    fused_file = str(Path(__file__).resolve().parent / "photon_ml_tpu_torch" / "game" /
                     "fused.py")
    dev = torch.device("cuda")
    out = {}
    for cell, make, config in _fused_cells(host):
        t_cell = time.perf_counter()
        data, norms = make()
        est = GameEstimator(device="cuda", normalization=norms)
        order = list(config.coordinates)
        coords = {cid: est.build_one_coordinate(cid, data, c, config.task)
                  for cid, c in config.coordinates.items()}
        iters = config.num_outer_iterations
        host_run = lambda: CoordinateDescent(coords, order, iters).run(dev)[0]
        fused_run = lambda: FusedSweep(coords, order, iters).run()

        # counted runs: syncs, kernel launches and graphs captured
        kernels = _zero_launches()
        graphs = loop.captured()
        host_model, host_syncs = _syncs_during(host_run)
        host_launches = {k: kernels[k].launches for k in FUSED_KERNELS}
        host_graphs = loop.captured() - graphs
        kernels = _zero_launches()
        graphs = loop.captured()
        (fused_model, scores), fused_syncs = _syncs_during(fused_run)
        fused_graphs = loop.captured() - graphs
        launches = _record_launches(f"fused_{cell}", kernels, stats, ())
        fused_launches = {k: launches[k] for k in FUSED_KERNELS}

        # gates: the same model and scores, the same launches, fewer syncs,
        # each a loop read or the one export
        _fused_equal_host(cell, fused_model, host_model)
        for cid, coord in coords.items():
            if not torch.equal(scores[cid], coord.score(host_model[cid]).double()):
                raise AssertionError(f"{cell} {cid}: the fused final scores differ from the "
                                     f"host model's")
        if fused_launches != host_launches:
            raise AssertionError(f"{cell}: fused launches {fused_launches} != the host "
                                 f"loop's {host_launches}")
        reads = sum(1 for s in fused_syncs if s and s[0] == helper)
        export = sum(1 for s in fused_syncs if s and s[0][0] == fused_file)
        if reads + export != len(fused_syncs) or export != 1:
            others = sorted({_site(s[0]) if s else "outside the package" for s in fused_syncs
                             if not s or (s[0] != helper and s[0][0] != fused_file)})
            raise AssertionError(f"{cell}: fused syncs {len(fused_syncs)}: {reads} loop reads, "
                                 f"{export} at the export, others at {others}")
        bound = LOOP_FORM_UPDATE_SYNCS.get(cell)
        if len(fused_syncs) >= len(host_syncs) or (bound is not None
                                                   and len(fused_syncs) >= bound):
            raise AssertionError(f"{cell}: {len(fused_syncs)} fused syncs, the host loop "
                                 f"{len(host_syncs)}, the loop form's {bound}")
        host_reads = sum(1 for s in host_syncs if s and s[0] == helper)

        # reported: untraced descents, medians of five each; the card's busy
        # time of one traced descent each, over the untraced median
        seconds = {"host": [], "fused": []}
        for side in FUSED_TIMING_ORDER:
            run = host_run if side == "host" else fused_run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds[side].append(time.perf_counter() - t0)
        median = {side: statistics.median(v) for side, v in seconds.items()}
        busy = {"host": _profiled_busy(host_run), "fused": _profiled_busy(fused_run)}
        idle = {side: 1.0 - b["busy_ms"] / (median[side] * 1e3) for side, b in busy.items()}
        row = dict(syncs=dict(host=len(host_syncs), fused=len(fused_syncs),
                              host_loop_reads=host_reads, fused_loop_reads=reads,
                              loop_form=bound),
                   launches=fused_launches, graphs=dict(host=host_graphs, fused=fused_graphs),
                   seconds=seconds, median_s=median, busy=busy, idle_untraced=idle,
                   cell_s=time.perf_counter() - t_cell)
        out[cell] = row
        log(f"{cell}: fused equals the host loop bitwise (coefficients, variances, final "
            f"scores); launches {fused_launches} both; syncs {len(fused_syncs)} fused "
            f"({reads} loop reads + {export} export) against {len(host_syncs)} in the host "
            f"loop ({host_reads} loop reads) and {bound} after the loop form; graphs "
            f"captured host {host_graphs}, fused {fused_graphs}; descent median of 5 "
            f"{median['host'] * 1e3:.1f} ms host, {median['fused'] * 1e3:.1f} ms fused "
            f"({median['fused'] / median['host']:.3f}x); untraced idle share host "
            f"{idle['host']:.4f}, fused {idle['fused']:.4f} (device busy "
            f"{busy['host']['busy_ms']:.1f} / {busy['fused']['busy_ms']:.1f} ms in traced "
            f"descents of {busy['host']['wall_ms']:.1f} / {busy['fused']['wall_ms']:.1f} ms); "
            f"{row['cell_s']:.1f} s")
        del data, coords, norms, est
        torch.cuda.empty_cache()

    # glmix_chip-grid's five points through GameEstimator() at its default:
    # a sweep per sweep key, graphs per point, each point the host loop's
    t_grid = time.perf_counter()
    xg = chip_design(host["n"], "cuda")
    train, _ = _per_user_split(host, xg)
    del xg
    torch.cuda.empty_cache()
    data = _part_data(train)
    configs = _grid_configs()
    real_sweep, real_run = est_mod.FusedSweep, FusedSweep.run
    sweeps, per_point = [], []

    def counted_sweep(*args, **kwargs):
        sweeps.append(real_sweep(*args, **kwargs))
        return sweeps[-1]

    def counted_run(self, *args, **kwargs):
        before = loop.captured()
        try:
            return real_run(self, *args, **kwargs)
        finally:
            per_point.append(loop.captured() - before)

    est_mod.FusedSweep, FusedSweep.run = counted_sweep, counted_run
    try:
        kernels = _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = GameEstimator(device="cuda").fit(data, configs)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        _record_launches("fused_glmix_chip_grid", kernels, stats,
                         ("fused_value_and_grad", "newton_step"))
    finally:
        est_mod.FusedSweep, FusedSweep.run = real_sweep, real_run
    t0 = time.perf_counter()
    host_fit = GameEstimator(device="cuda", fused=False).fit(data, configs)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    if len(per_point) != len(configs) or any(r.history.steps for r in fused):
        raise AssertionError("glmix_chip-grid: not every point ran the fused sweep")
    if len(sweeps) != GRID_SWEEP_KEYS:
        raise AssertionError(f"glmix_chip-grid: {len(sweeps)} sweeps for {GRID_SWEEP_KEYS} "
                             f"sweep keys")
    if any(per_point[1:]):
        raise AssertionError(f"glmix_chip-grid: graphs captured after the first point: "
                             f"{per_point}")
    for k, (f, h) in enumerate(zip(fused, host_fit)):
        _fused_equal_host(f"glmix_chip-grid point {k}", f.model, h.model)
    out["glmix_chip_grid"] = dict(sweeps=len(sweeps), sweep_keys=GRID_SWEEP_KEYS,
                                  graphs_per_point=per_point, fit_s=dict(fused=t_fused,
                                                                         host=t_host),
                                  seconds=time.perf_counter() - t_grid)
    log(f"glmix_chip-grid: {len(configs)} points through GameEstimator() in {t_fused:.2f} s "
        f"(host loop {t_host:.2f} s), {len(sweeps)} sweeps for {GRID_SWEEP_KEYS} sweep keys (the "
        f"down-sampled point is a key of its own, as in the reference), graphs captured per "
        f"point {per_point}; every point bitwise the host loop's")
    stats["fused_sweep"] = out
    log("phase 26: " + json.dumps(out))


# -- phase 27: the validated fused sweep ---------------------------------------

VALIDATED_KERNELS = ("fused_value_and_grad", "newton_step")  # glmix_chip-grid's


def _validated_cells(host: dict):
    """Phase 27's cells: (cell, a function making (training, held-out)
    GameData, configurations, validation specs, the sweeps their keys
    make, kernels that must launch)."""
    from photon_ml_tpu_torch.data.synthetic import chip_design, synth_glmix_sparse

    def grid():
        xg = chip_design(host["n"], "cuda")
        train, val = _per_user_split(host, xg)
        del xg
        return _part_data(train), _part_data(val)

    return [("glmix_chip_grid", grid, _grid_configs(), GRID_SUITE, GRID_SWEEP_KEYS,
             VALIDATED_KERNELS),
            ("glmix_sparse_held_out", lambda: _gs_held_out_split(synth_glmix_sparse(1))[:2],
             [_glmix_sparse_config()], GS_HELD_OUT_SUITE, 1, ())]


def _validated_fit(train, val, configs, suite, fused) -> tuple:
    """One validated ``GameEstimator.fit`` (``fused`` "auto" or False) with
    each descent's syncs counted (``_syncs_during`` around
    ``FusedSweep.run_validated`` or ``CoordinateDescent.run``), the sweeps
    and plans built, and the kernels' launches; the wrappers are restored
    in a ``finally``.  Returns (results, counts)."""
    import torch

    import photon_ml_tpu_torch.game.estimator as est_mod
    from photon_ml_tpu_torch.game import FusedSweep, GameEstimator
    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    real_sweep, real_plan = est_mod.FusedSweep, FusedSweep.validation_plan
    real_validated, real_host = FusedSweep.run_validated, CoordinateDescent.run
    sweeps, plans, descents = [], [], []

    def counted_sweep(*args, **kwargs):
        sweeps.append(real_sweep(*args, **kwargs))
        return sweeps[-1]

    def counted_plan(self, *args, **kwargs):
        plans.append(real_plan(self, *args, **kwargs))
        return plans[-1]

    stacks = []

    def counted(real):
        def run(self, *args, **kwargs):
            out, syncs = _syncs_during(lambda: real(self, *args, **kwargs), stacks=stacks)
            descents.append(syncs)
            return out
        return run

    est_mod.FusedSweep, FusedSweep.validation_plan = counted_sweep, counted_plan
    FusedSweep.run_validated = counted(real_validated)
    CoordinateDescent.run = counted(real_host)
    try:
        kernels = _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = GameEstimator(device="cuda", validation_suite=suite, fused=fused).fit(
            train, configs, validation_data=val)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        est_mod.FusedSweep, FusedSweep.validation_plan = real_sweep, real_plan
        FusedSweep.run_validated, CoordinateDescent.run = real_validated, real_host
    return results, dict(sweeps=len(sweeps), plans=len(plans), descents=descents,
                         stacks=stacks, launches=launches, fit_s=fit_s,
                         plan_bytes=[p.device_bytes for p in plans])


def _evaluator_file() -> str:
    import inspect
    import os

    from photon_ml_tpu_torch.evaluation import evaluator

    return os.path.realpath(inspect.getsourcefile(evaluator))


def phase_fused_validated(stats: dict, host: dict):
    """Phase 27 (module docstring): per cell, the validated fit through
    ``GameEstimator()`` and ``GameEstimator(fused=False)``, gated; then the
    first configuration's descent timed both ways on one set of
    coordinates."""
    import statistics

    import numpy as np
    import torch

    from photon_ml_tpu_torch.evaluation.evaluator import EvaluationSuite
    from photon_ml_tpu_torch.game import FusedSweep, GameEstimator
    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    helper = _helper_site()
    fused_file = str(Path(__file__).resolve().parent / "photon_ml_tpu_torch" / "game" /
                     "fused.py")
    evaluator_file = _evaluator_file()
    dev = torch.device("cuda")
    out = {}
    for cell, make, configs, specs, keys, required in _validated_cells(host):
        t_cell = time.perf_counter()
        train, val = make()
        suite = EvaluationSuite.from_specs(specs)
        fused, fc = _validated_fit(train, val, configs, suite, "auto")
        _record_launches(f"validated_{cell}", _counted_kernels(), stats, required)
        host_fit, hc = _validated_fit(train, val, configs, suite, False)

        # gates: every point fused and bitwise the host loop's, the same best
        # and launches, one plan a sweep, fewer syncs, each a loop read, a
        # boundary evaluation's or the one export
        if any(r.history.steps for r in fused) or len(fc["descents"]) != len(configs):
            raise AssertionError(f"{cell}: not every point ran the validated sweep")
        for k, (f, h) in enumerate(zip(fused, host_fit)):
            _fused_equal_host(f"{cell} point {k}", f.model, h.model)
            if f.evaluation.values != h.evaluation.values:
                raise AssertionError(f"{cell} point {k}: evaluations {f.evaluation.values} "
                                     f"!= the host loop's {h.evaluation.values}")
        est = GameEstimator(device="cuda", validation_suite=suite)
        pick = (fused.index(est.best(fused)), host_fit.index(est.best(host_fit)))
        if pick[0] != pick[1]:
            raise AssertionError(f"{cell}: best point {pick[0]} fused, {pick[1]} host loop")
        launches = {k: (fc["launches"][k], hc["launches"][k]) for k in FUSED_KERNELS}
        if any(a != b for a, b in launches.values()):
            raise AssertionError(f"{cell}: launches (fused, host loop) {launches}")
        if fc["plans"] != fc["sweeps"] or fc["sweeps"] != keys:
            raise AssertionError(f"{cell}: {fc['plans']} plans for {fc['sweeps']} sweeps "
                                 f"({keys} sweep keys)")
        fused_syncs = [s for d in fc["descents"] for s in d]
        host_syncs = [s for d in hc["descents"] for s in d]
        kinds = ["read" if s and s[0] == helper else
                 "evaluation" if any(f[0] == evaluator_file for f in s) else
                 "export" if s and s[0][0] == fused_file else "other" for s in fused_syncs]
        reads, evals, export = (kinds.count(k) for k in ("read", "evaluation", "export"))
        if "other" in kinds or export != len(configs):
            others = [fc["stacks"][i] for i, k in enumerate(kinds) if k == "other"]
            log(f"{cell}: the fused syncs that are no loop read, evaluation or export:\n"
                + "\n".join(others))
            raise AssertionError(f"{cell}: fused syncs {len(fused_syncs)}: {reads} loop reads, "
                                 f"{evals} in evaluations, {export} at the exports, "
                                 f"{len(others)} others")
        if len(fused_syncs) >= len(host_syncs):
            raise AssertionError(f"{cell}: {len(fused_syncs)} fused syncs, the host loop "
                                 f"{len(host_syncs)}")
        host_reads = sum(1 for s in host_syncs if s and s[0] == helper)

        # reported: the first configuration's descent on one set of
        # coordinates, untraced medians of five each, and the card's busy
        # time of one traced descent each over the untraced median
        config = configs[0]
        order, iters = list(config.coordinates), config.num_outer_iterations
        coords = {cid: est.build_one_coordinate(cid, train, c, config.task)
                  for cid, c in config.coordinates.items()}
        sweep = FusedSweep(coords, order, iters)
        plan = sweep.validation_plan(val, suite)
        host_run = lambda: CoordinateDescent(coords, order, iters,
                                             validation=(val, suite)).run(dev)
        fused_run = lambda: sweep.run_validated(plan)
        seconds = {"host": [], "fused": []}
        for side in FUSED_TIMING_ORDER:
            run = host_run if side == "host" else fused_run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds[side].append(time.perf_counter() - t0)
        median = {side: statistics.median(v) for side, v in seconds.items()}
        busy = {"host": _profiled_busy(host_run), "fused": _profiled_busy(fused_run)}
        idle = {side: 1.0 - b["busy_ms"] / (median[side] * 1e3) for side, b in busy.items()}
        row = dict(points=len(configs), rows=dict(train=train.num_samples,
                                                  held_out=val.num_samples),
                   syncs=dict(host=len(host_syncs), fused=len(fused_syncs),
                              host_loop_reads=host_reads, fused_loop_reads=reads,
                              fused_evaluations=evals, fused_exports=export),
                   launches=launches, sweeps=fc["sweeps"], plans=fc["plans"],
                   plan_device_bytes=fc["plan_bytes"], best=pick[0],
                   held_out=[r.evaluation.values for r in fused],
                   fit_s=dict(fused=fc["fit_s"], host=hc["fit_s"]), seconds=seconds,
                   median_s=median, busy=busy, idle_untraced=idle,
                   cell_s=time.perf_counter() - t_cell)
        out[cell] = row
        log(f"{cell}: {len(configs)} validated points through GameEstimator() bitwise the "
            f"host loop's (coefficients, every evaluation, best point {pick[0]}); launches "
            f"(fused, host) {launches}; {fc['sweeps']} sweeps, {fc['plans']} plans holding "
            f"{[b / 1e6 for b in fc['plan_bytes']]} MB on the card; syncs {len(fused_syncs)} "
            f"fused ({reads} loop reads + {evals} in evaluations + {export} exports) against "
            f"{len(host_syncs)} in the host loop ({host_reads} loop reads); fits "
            f"{fc['fit_s']:.2f} s fused, {hc['fit_s']:.2f} s host, construction included; "
            f"point 0's descent median of 5 {median['host'] * 1e3:.1f} ms host, "
            f"{median['fused'] * 1e3:.1f} ms fused ({median['fused'] / median['host']:.3f}x); "
            f"untraced idle share host {idle['host']:.4f}, fused {idle['fused']:.4f} (device "
            f"busy {busy['host']['busy_ms']:.1f} / {busy['fused']['busy_ms']:.1f} ms in traced "
            f"descents of {busy['host']['wall_ms']:.1f} / {busy['fused']['wall_ms']:.1f} ms); "
            f"{row['cell_s']:.1f} s")
        if not np.isfinite([v for r in fused for v in r.evaluation.values.values()]).all():
            raise AssertionError(f"{cell}: an evaluation is not finite")
        del train, val, coords, sweep, plan, fused, host_fit
        torch.cuda.empty_cache()
    stats["fused_validated"] = out
    log("phase 27: " + json.dumps(out))


# -- phase 28: the RANDOM projector ----------------------------------------------

RANDOM_GLMIX2_DIM = 8  # glmix2-random: the per-user coordinate's projected_dim
RANDOM_GSN_DIM = 16  # glmix_sparse-norm-random's; with the intercept's pass-through
# slot the solve width is 17
RANDOM_GSN_ITERS = 200  # its per-user solver's iteration cap (tolerance 1e-7, as
# glmix_sparse's): the STANDARDIZATION context pushed through the matrix has
# factors from 1 to ~2,200 in magnitude, and the lanes leave the float64
# gradient at 2.9e-2 of its start after 30 iterations, 9.3e-3 after 150,
# 5.4e-3 after 200 (CPU fits at scale 8), 2.6e-3 after 300 (full width on
# an H100)
RANDOM_SOA_DIM = 7  # the SoA branch, glmix2 at REDUCED_GLMIX2_SCALE with cap
# MAIN_CAP (32): 32 * 7^2 = 1,568 <= 2,560 keeps it inside the gate
RANDOM_MARGIN_RTOL = 1e-4  # published per-user scores x·(A·w) against the
# projected design's margins (x·A)·w, float32: the same products summed in
# another order, against the largest score; the sparse cell's lanes take
# projected factors in the thousands, whose cancellations cost digits
RANDOM_TIMING_ORDER = ("host", "fused", "fused", "host", "host", "fused")  # untraced
# descents on one set of coordinates, three each, or the first two (one
# each) on the sparse cell, whose descent takes seconds


def _random_user(config, **fields):
    """``config`` with its per-user coordinate under the RANDOM projector."""
    import dataclasses

    from photon_ml_tpu_torch.types import ProjectorType

    user = dataclasses.replace(config.coordinates["per-user"],
                               projector=ProjectorType.RANDOM, **fields)
    return dataclasses.replace(config, coordinates={**config.coordinates, "per-user": user})


def _random_cells():
    """Phase 28's cells: (cell, make(scale) -> (GameData, normalization map or
    None), config, kernels that must launch, the cell's scale, whether the
    per-user coordinate runs SoA Newton, untraced descents each way)."""
    from photon_ml_tpu_torch.data.synthetic import synth_glmix, synth_glmix_sparse_norm
    from photon_ml_tpu_torch.opt.types import SolverConfig
    from photon_ml_tpu_torch.types import OptimizerType

    def glmix2(scale):
        return _baseline_data(synth_glmix(scale, three=False)), None

    def gsn(scale):
        host = synth_glmix_sparse_norm(scale)
        return _glmix_sparse_data(host), {"u": _gsn_context(host)}

    g2 = _baseline_config(False, OptimizerType.LBFGS)
    gsn_solver = SolverConfig(max_iters=RANDOM_GSN_ITERS, tolerance=1e-7)
    return [("glmix2_random", glmix2, _random_user(g2, projected_dim=RANDOM_GLMIX2_DIM),
             ("fused_value_and_grad",), 1, False, 3),
            ("glmix_sparse_norm_random", gsn,
             _random_user(_glmix_sparse_config(), projected_dim=RANDOM_GSN_DIM,
                          intercept_index=GSN_II, solver=gsn_solver), (), 1, False, 1),
            ("glmix2_random_soa", glmix2,
             _random_user(g2, projected_dim=RANDOM_SOA_DIM, active_cap=MAIN_CAP),
             ("fused_value_and_grad", "newton_step"), REDUCED_GLMIX2_SCALE, True, 3)]


class _ProjectionSeconds:
    """Wall seconds of the RANDOM projection's own steps (drawing the
    matrix, projecting the designs, pushing the context through it) while
    open, each step ended by a device sync; the wrappers are restored on
    exit."""

    def __init__(self, device: str):
        self.device, self.seconds, self._real = device, 0.0, []

    def __enter__(self):
        import photon_ml_tpu_torch.game.coordinate as coord_mod
        import photon_ml_tpu_torch.parallel.projection as proj_mod

        targets = [(proj_mod.RandomProjection, name)
                   for name in ("project_x", "project_compact", "project_normalization")]
        targets += [(proj_mod, "build_random_projection"),
                    (coord_mod, "build_random_projection")]
        for owner, name in targets:
            real = getattr(owner, name)
            self._real.append((owner, name, real))
            setattr(owner, name, self._timed(real))
        return self

    def _timed(self, fn):
        import torch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.device == "cuda":
                torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        return timed

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._real):
            setattr(owner, name, real)


class _LastRandomUpdate:
    """While open, keeps the last random-effect update's coordinate,
    offsets, solver results and published stack (``coord``, ``offsets``,
    ``results``, ``w_dev``), from ``RandomEffectCoordinate._solve_update``,
    which the host loop and the fused sweep both call; the method is
    restored on exit."""

    def __enter__(self):
        import photon_ml_tpu_torch.game.coordinate as coord_mod

        cls = coord_mod.RandomEffectCoordinate
        real = self._real = cls._solve_update

        def kept(coord, offsets, start):
            results, w_dev = real(coord, offsets, start)
            self.coord, self.offsets, self.results, self.w_dev = (coord, offsets, results,
                                                                   w_dev)
            return results, w_dev

        cls._solve_update = kept
        return self

    def __exit__(self, *exc):
        import photon_ml_tpu_torch.game.coordinate as coord_mod

        coord_mod.RandomEffectCoordinate._solve_update = self._real


def _solver_lanes(coord, results) -> list:
    """Each bucket's optimum [L, k] in the transformed projected space."""
    return [r.w.T if coord.use_soa else r.w for r in results]


def _random_stack_and_margins(coord, last: _LastRandomUpdate, model) -> dict:
    """Gates on the last update of a RANDOM coordinate: the published stack
    bitwise its solved lanes mapped to original space and back-projected
    through Aᵀ, and the model's per-user scores within RANDOM_MARGIN_RTOL of
    the projected designs' margins (x·A)·w at every active row."""
    import torch

    w_pub = torch.as_tensor(model.w_stack, device=last.w_dev.device)
    if not torch.equal(w_pub, last.w_dev):
        raise AssertionError("the published stack is not the last update's")
    scores = coord.score(model)
    err, top = 0.0, float(scores.abs().max())
    for bi, lanes in enumerate(_solver_lanes(coord, last.results)):
        orig = coord._lanes_to_original(lanes, bi)
        slots = coord._lane_slots[bi]
        valid = slots >= 0
        if not torch.equal(coord._random.back_project(orig)[valid], w_pub[slots[valid]]):
            raise AssertionError(f"bucket {bi}: the published rows are not its lanes "
                                 f"back-projected through the matrix")
        dev = coord._dev[bi]
        x, rows, ok = dev["x"], dev["rows"], dev["valid"]
        if coord.use_soa:  # [S, k, L], [S, L] -> [L, S, k], [L, S]
            x, rows, ok = x.permute(2, 0, 1), rows.T, ok.T
        margins = torch.einsum("lsk,lk->ls", x.to(orig.dtype), orig)
        err = max(err, float(torch.where(ok, (scores[rows] - margins).abs(), 0.0).max()))
    rel = err / max(top, 1e-30)
    if rel > RANDOM_MARGIN_RTOL:
        raise AssertionError(f"per-user scores differ from the projected margins by {rel:.2e} "
                             f"of the largest score (tol {RANDOM_MARGIN_RTOL:g})")
    return dict(margin_rel=rel, max_score=top)


def _projected_rows(shard, rows, a):
    """The raw rows ``rows`` [L, S] of a per-user shard projected through the
    float64 matrix ``a`` [d, k], float64 [L, S, k] on a's device."""
    import torch

    from photon_ml_tpu_torch.game import SparseShard

    if isinstance(shard, SparseShard):
        idx = torch.as_tensor(shard.indices, device=a.device)[rows].long()
        val = torch.as_tensor(shard.values, device=a.device)[rows].double()
        return (val[..., None] * a[idx]).sum(dim=-2)
    return torch.as_tensor(shard, device=a.device)[rows].double() @ a


def _random_gradient_ratio(coord, shard, last: _LastRandomUpdate) -> float:
    """The float64 gradient norm of the per-user objective in the
    transformed projected space at the last update's optimum, over its norm
    at w' = 0, recomputed from the raw rows, the matrix and the projected
    context: per lane Σ wt·logloss(off + x'·(w'∘f) - (w'∘f)·s) + l2/2·||w'||²
    with x' = x·A."""
    import torch

    a = coord._random.matrix.double()
    ctx, _ = coord._shared_norm
    k = a.shape[1]
    f = ctx.factors.double() if ctx.factors is not None else torch.ones(k, device=a.device,
                                                                        dtype=a.dtype)
    s = ctx.shifts.double() if ctx.shifts is not None else torch.zeros_like(f)
    offsets = torch.as_tensor(last.offsets, device=a.device).double()
    sq = {"w": 0.0, "zero": 0.0}
    for b, lanes, l2 in zip(coord.buckets.buckets, _solver_lanes(coord, last.results),
                            coord._l2):
        on = lambda v: torch.as_tensor(v, device=a.device)
        valid = on(b.rows >= 0)
        rows = torch.where(valid, on(b.rows).long(), 0)
        x = _projected_rows(shard, rows, a)
        y, wt, off = on(b.y).double(), on(b.weight).double(), offsets[rows]
        lane = on(b.entity_lanes >= 0)

        def gradient(w):
            eff = w * f
            z = off + torch.einsum("lsk,lk->ls", x, eff) - (eff * s).sum(-1, keepdim=True)
            r = torch.where(valid, wt * (torch.sigmoid(z) - y), 0.0)
            g = f * (torch.einsum("ls,lsk->lk", r, x) - s * r.sum(-1, keepdim=True))
            return (g + l2.double()[:, None] * w)[lane]

        w = lanes.double()
        sq["w"] += float((gradient(w) ** 2).sum())
        sq["zero"] += float((gradient(torch.zeros_like(w)) ** 2).sum())
    return (sq["w"] / sq["zero"]) ** 0.5


def _fit_random(data, device: str, config, norms) -> tuple:
    """``_fit_and_score`` through ``GameEstimator()`` with the per-user
    coordinate's last update kept, and the fit's GAME objective in float64:
    Σ logloss(total score) + the fixed effect's (l2 / 2)·||w||² + each
    entity's (l2 / 2)·||w'||² over its transformed projected lanes.
    Returns (result, scores, AUC, fit seconds, objective)."""
    import torch

    with _LastRandomUpdate() as last:
        res, scores, auc, t_fit, _ = _fit_and_score(data, device, config, norms)
    coord = last.coord
    lanes = [w[torch.as_tensor(b.entity_lanes >= 0, device=w.device)] for b, w in
             zip(coord.buckets.buckets, _solver_lanes(coord, last.results))]
    penalties = [(config.coordinates["fixed"].reg.l2, res.model["fixed"].coefficients.means)]
    penalties += [(config.coordinates["per-user"].reg.l2, w) for w in lanes]
    return res, scores, auc, t_fit, _logistic_objective(scores, data, penalties)


def _gsn_random_card_vs_cpu(config) -> dict:
    """glmix_sparse-norm-random at L1_CHOICE_SCALE, card against CPU, by the
    bound of PERF.md section 2: coefficients and scores within
    F32_PATH_RTOL and the GAME objective within F32_OBJECTIVE_RTOL, or
    F32_SPREAD_MULTIPLE x the CPU fit's own spread under one-ulp nudges of
    the per-user values where larger.  Its lanes are not determined to
    more than a few digits (the nudges move them by tens of percent, and
    the per-user coordinate alone in float64 read 4.6e-1 apart card against
    CPU), so no float64 comparison is made."""
    import numpy as np

    from photon_ml_tpu_torch.data.synthetic import synth_glmix_sparse_norm

    host = synth_glmix_sparse_norm(L1_CHOICE_SCALE)
    data, norms = _glmix_sparse_data(host), {"u": _gsn_context(host)}
    label = f"glmix_sparse-norm-random at scale {L1_CHOICE_SCALE} ({data.num_samples} rows)"
    rg, sg, auc_g, t_card, f_card = _fit_random(data, "cuda", config, norms)
    rc, sc, auc_c, t_cpu, f_cpu = _fit_random(data, "cpu", config, norms)

    def errors(a, sa, fa):
        e = _model_errors(label, a.model, rc.model, ["per-user"])
        e["scores"] = rel_err(sa.cpu(), sc)
        e["objective"] = abs(fa - f_cpu) / abs(f_cpu)
        return e

    errs = errors(rg, sg, f_card)
    spreads = []
    for seed in F32_SPREAD_SEEDS:
        values = host["user"]["values"]
        values = values * (1 + np.float32(2 ** -23) * np.random.default_rng(seed).choice(
            np.float32([-1, 1]), values.shape))
        nudged = _glmix_sparse_data(dict(host, user=dict(host["user"], values=values)))
        rn, sn, _, _, fn = _fit_random(nudged, "cpu", config, norms)
        spreads.append(errors(rn, sn, fn))
    base = {k: F32_OBJECTIVE_RTOL if k == "objective" else F32_PATH_RTOL for k in errs}
    tol = {k: max(base[k], F32_SPREAD_MULTIPLE * max(sp[k] for sp in spreads)) for k in errs}
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())
    ok = all(errs[k] <= tol[k] for k in errs) and abs(auc_g - auc_c) <= 1e-3
    log(f"card vs CPU, {label}: fit {t_card:.2f} s vs {t_cpu:.2f} s; objective {f_card:.6f} vs "
        f"{f_cpu:.6f}; max rel diff {fmt(errs)} (tol {fmt(tol)}: {F32_SPREAD_MULTIPLE:g} x the "
        f"largest of the CPU fit's own spreads under one-ulp nudges of the per-user values, "
        f"seeds {F32_SPREAD_SEEDS}: " + "; ".join(fmt(sp) for sp in spreads)
        + f"); AUC {auc_g:.5f} vs {auc_c:.5f} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{label}: card and CPU disagree beyond the tolerance")
    return dict(f32=errs, f32_tol=tol, f32_spreads=spreads, objective=(f_card, f_cpu),
                auc=(auc_g, auc_c))


def phase_random_projector(stats: dict):
    """Phase 28 (module docstring): per cell, construction with the
    projection timed apart, ``GameEstimator()`` and ``fused=False`` fits,
    descents both ways on one set of coordinates, and the gates; then the
    cells at a reduced size on the card and the CPU."""
    import statistics

    import torch

    from photon_ml_tpu_torch.game import FusedSweep, GameEstimator
    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    dev = torch.device("cuda")
    out = {}
    for cell, make, config, required, scale, soa, repeats in _random_cells():
        t_cell = time.perf_counter()
        data, norms = make(scale)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        est = GameEstimator(device="cuda", normalization=norms)
        with _ProjectionSeconds("cuda") as projection:
            t0 = time.perf_counter()
            coords = {cid: est.build_one_coordinate(cid, data, c, config.task)
                      for cid, c in config.coordinates.items()}
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
        user = coords["per-user"]
        ucfg = config.coordinates["per-user"]
        width = ucfg.projected_dim + (ucfg.intercept_index is not None)
        widths = {dv["x"].shape[1 if user.use_soa else 2] for dv in user._dev}
        if user._random is None or user.use_soa != soa or widths != {width}:
            raise AssertionError(f"{cell}: the per-user coordinate solves at widths {widths} "
                                 f"(SoA {user.use_soa}), not RANDOM at {width} (SoA {soa})")

        # the estimator both ways, kernels counted from 0 for each
        fits, launches = {}, {}
        for side, fused in (("fused", "auto"), ("host", False)):
            kernels = _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = GameEstimator(device="cuda", normalization=norms, fused=fused).fit(
                data, [config])[0]
            torch.cuda.synchronize()
            fits[side] = (res, time.perf_counter() - t0)
            launches[side] = {k: v for k, v in _record_launches(
                cell if side == "fused" else f"{cell}_host", kernels, stats, required).items()
                if k in FUSED_KERNELS}
        if fits["fused"][0].history.steps or not fits["host"][0].history.steps:
            raise AssertionError(f"{cell}: GameEstimator() did not run the fused sweep")
        _fused_equal_host(cell, fits["fused"][0].model, fits["host"][0].model)
        if launches["fused"] != launches["host"]:
            raise AssertionError(f"{cell}: fused launches {launches['fused']} != the host "
                                 f"loop's {launches['host']}")

        # descents on the coordinates built above: counted, kept, timed
        order, iters = list(config.coordinates), config.num_outer_iterations
        host_run = lambda: CoordinateDescent(coords, order, iters).run(dev)[0]
        fused_run = lambda: FusedSweep(coords, order, iters).run()[0]
        with _LastRandomUpdate() as last:
            host_model, host_syncs = _syncs_during(host_run, frames=False)
        fused_model, fused_syncs = _syncs_during(fused_run, frames=False)
        _fused_equal_host(f"{cell} descents", fused_model, host_model)
        _fused_equal_host(f"{cell} estimator against descent", fits["fused"][0].model,
                          host_model)
        gates = _random_stack_and_margins(user, last, host_model["per-user"])
        ratio = _random_gradient_ratio(user, data.features[ucfg.feature_shard], last)
        if ratio > STATIONARY_RATIO:
            raise AssertionError(f"{cell}: float64 projected gradient ratio {ratio:.2e} > "
                                 f"{STATIONARY_RATIO:g}")
        seconds = {"host": [], "fused": []}
        for side in RANDOM_TIMING_ORDER[:2 * repeats]:
            run = host_run if side == "host" else fused_run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds[side].append(time.perf_counter() - t0)
        median = {side: statistics.median(v) for side, v in seconds.items()}
        row = dict(scale=scale, solve_width=width, soa=user.use_soa,
                   construction_s=t_build, projection_s=projection.seconds,
                   fit_s={side: f[1] for side, f in fits.items()}, descent_s=seconds,
                   descent_median_s=median, syncs=dict(host=len(host_syncs),
                                                       fused=len(fused_syncs)),
                   launches=launches["fused"], projected_gradient_ratio=ratio,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, **gates)
        log(f"{cell}: {data.num_samples} rows, per-user RANDOM at width {width} "
            f"({'SoA Newton' if user.use_soa else 'lanes'}); construction {t_build:.3f} s, of "
            f"which the projection {projection.seconds:.3f} s; fit {fits['fused'][1]:.2f} s "
            f"through GameEstimator() (the fused sweep) and {fits['host'][1]:.2f} s with "
            f"fused=False, bitwise equal, launches {launches['fused']} both; descents on one "
            f"set of coordinates bitwise equal, median of {repeats} {median['host'] * 1e3:.1f} "
            f"ms host, "
            f"{median['fused'] * 1e3:.1f} ms fused; syncs {len(host_syncs)} host, "
            f"{len(fused_syncs)} fused; published stack bitwise the solved lanes back-"
            f"projected, scores vs projected margins {gates['margin_rel']:.2e} (tol "
            f"{RANDOM_MARGIN_RTOL:g}); float64 projected gradient ratio {ratio:.2e} (tol "
            f"{STATIONARY_RATIO:g}); peak device memory {row['peak_gb']:.2f} GB")

        # card against CPU at a reduced size (the SoA cell is reduced already)
        if cell == "glmix_sparse_norm_random":
            row["card_vs_cpu"] = _gsn_random_card_vs_cpu(config)
        else:
            small, _ = make(REDUCED_GLMIX2_SCALE)
            _compare_fits(f"{cell} at scale {REDUCED_GLMIX2_SCALE} ({small.num_samples} rows)",
                          small, small, config, ["per-user"])
        row["cell_s"] = time.perf_counter() - t_cell
        out[cell] = row
        del data, coords, est, fits, host_model, fused_model, last
        torch.cuda.empty_cache()
    stats["random_projector"] = out
    log("phase 28: " + json.dumps(out))


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


def run_ab(tree: Path) -> int:
    """One side of an A/B of the fused kernels (module docstring)."""
    import torch

    import photon_ml_tpu_torch
    from photon_ml_tpu_torch.core import losses as L
    from photon_ml_tpu_torch.data.synthetic import chip_design, synth_glmix, synth_glmix_chip
    from photon_ml_tpu_torch.game import GameData
    from photon_ml_tpu_torch.ops.fused_glm import (fused_hvp, fused_hvp_plain,
                                                   fused_value_and_grad,
                                                   fused_value_and_grad_plain)
    from photon_ml_tpu_torch.types import OptimizerType

    pkg = Path(photon_ml_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree:
        raise AssertionError(f"imported {pkg}, not the package of {tree}")
    log(f"A/B side: {pkg}")
    stats: dict = {}
    with Phase("1 device"):
        _, _, smi = phase_device()
    with Phase("2 kernel build"):
        phase_build()
    _count_objective_evaluations()
    with Phase("ab kernels"):
        torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        shift, v_shift, loss = 0.03, -0.02, L.logistic_loss
        for n, d in FUSED_TIMED:
            w, b = _glm_batch(n, d, torch.float32, gen)
            v = torch.randn(d, generator=gen, device="cuda") / d ** 0.5
            _check_close(f"fused_value_and_grad n={n} d={d}",
                         fused_value_and_grad(loss, w, b, shift),
                         fused_value_and_grad(loss, w, b, shift),
                         fused_value_and_grad_plain(loss, w, b, shift), F32_KERNEL_RTOL)
            _check_close(f"fused_hvp n={n} d={d}",
                         fused_hvp(loss, w, v, b, shift, v_shift),
                         fused_hvp(loss, w, v, b, shift, v_shift),
                         fused_hvp_plain(loss, w, v, b, shift, v_shift), F32_KERNEL_RTOL)
            _time_fused(stats, n, d, w, v, b, shift, v_shift, gen)
            del w, v, b
            torch.cuda.empty_cache()
    import hashlib

    import numpy as np

    import photon_ml_tpu_torch.game.coordinate as coord_mod

    fits, fixed, random, digests = {}, {}, {}, {}

    def ab_fit(key, *args):
        real = coord_mod.FixedEffectCoordinate.update
        fits[key], fixed[key], random[key] = [], [], []
        for _ in range(AB_REPEATS):
            counts = []

            def update(self, *a, **kw):
                before = (fused_value_and_grad.launches, _ObjectiveEvaluations.launches)
                out = real(self, *a, **kw)
                counts.append((fused_value_and_grad.launches - before[0],
                               _ObjectiveEvaluations.launches - before[1]))
                return out

            coord_mod.FixedEffectCoordinate.update = update
            try:
                res, _, _, fit_s, _ = _fit_and_score(*args, fused=False)
            finally:
                coord_mod.FixedEffectCoordinate.update = real
            # the published coefficients' bytes, to hold the two trees bitwise
            coefs = _coefficients(res.model)
            digest = {cid: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]
                      for cid, a in sorted(coefs.items())}
            if digests.setdefault(key, digest) != digest:
                raise AssertionError(f"{key}: a repeated fit published other coefficients")
            # the fixed effect's updates: seconds, solver iterations, kernel-1
            # launches and objective evaluations, per sweep
            steps = [st for st in res.history.steps if st["coordinate"] == "fixed"]
            updates = [dict(seconds=st["seconds"], iterations=st["solver_iterations"],
                            kernel1=k1, evaluations=ev)
                       for st, (k1, ev) in zip(steps, counts)]
            for u in updates:
                if u["kernel1"] != u["evaluations"]:
                    raise AssertionError(f"{key}: a fixed update launched kernel 1 "
                                         f"{u['kernel1']} times for {u['evaluations']} "
                                         f"objective evaluations")
            # the random effects' updates: seconds and solver iterations
            others = [dict(coordinate=st["coordinate"], seconds=st["seconds"],
                           iterations=st["solver_iterations"])
                      for st in res.history.steps if st["coordinate"] != "fixed"]
            fits[key].append(fit_s)
            fixed[key].append(updates)
            random[key].append(others)
            log(f"{key}: fit {fit_s:.3f} s; fixed updates " + ", ".join(
                f"{u['seconds'] * 1e3:.2f} ms ({u['iterations']} iterations, {u['kernel1']} "
                f"kernel-1 launches)" for u in updates) + "; random-effect updates " +
                ", ".join(f"{u['coordinate']} {u['seconds'] * 1e3:.2f} ms "
                          f"({u['iterations']} iterations)" for u in others))

    with Phase("ab warm-up"):
        # every solver path once at a reduced scale, so that no timed update
        # below pays for a kernel's first load
        small = synth_glmix(REDUCED_GLMIX2_SCALE, three=False)
        _fit_and_score(_baseline_data(small), "cuda", _baseline_config(False, OptimizerType.TRON),
                       fused=False)
        _fit_and_score(_baseline_data(synth_glmix(REDUCED_GLMIX2_SCALE, three=True)), "cuda",
                       _baseline_config(True, OptimizerType.LBFGS), fused=False)
        data, xg, xu = _norm_var_data(_with_intercept(small), "cuda")
        _fit_and_score(data, "cuda", _en_box_config(AB_EN_BOX_L1), _norm_var_contexts(xg, xu)[0],
                       fused=False)
        del small, data, xg, xu
    with Phase("ab fits"):
        host = synth_glmix_chip()
        xg = chip_design(host["n"], "cuda")
        data = GameData(y=host["y"], features={"g": xg, "u": host["xu"]},
                        id_tags={"userId": host["uids"]})
        ab_fit("glmix_chip", data, "cuda", _glmix_config())
        del data, xg, host
        torch.cuda.empty_cache()
        glmix2 = synth_glmix(1, three=False)
        ab_fit("glmix2_tron", _baseline_data(glmix2), "cuda",
               _baseline_config(False, OptimizerType.TRON))
        ab_fit("glmix3", _baseline_data(synth_glmix(1, three=True)), "cuda",
               _baseline_config(True, OptimizerType.LBFGS))
        host = _with_intercept(glmix2)
        data, xg, xu = _norm_var_data(host, "cuda")
        norms, _ = _norm_var_contexts(xg, xu)
        ab_fit("glmix2_norm_var", data, "cuda", _norm_var_config(), norms)
        ab_fit("glmix2_en_box", data, "cuda", _en_box_config(AB_EN_BOX_L1), norms)
        log("fit seconds: " + ", ".join(f"{k} {v}" for k, v in fits.items()))
    kernels = {k: stats[k]["by_shape"] for k in ("fused_value_and_grad", "fused_hvp")}
    log(json.dumps({"ab": str(tree), "card": smi, "kernels": kernels, "fit_s": fits,
                    "fixed_updates": fixed, "random_updates": random,
                    "coefficient_digests": digests}))
    return 0


def _ms(seconds) -> str:
    return "n/a" if seconds is None else f"{seconds * 1e3:.2f}"


def _ratio(r) -> str:
    return "n/a" if r is None else f"{r:.3f}x"


def ab_summary(logs) -> int:
    """Medians over the ``--ab`` runs whose logs are given: per tree (the
    base name of its directory) and cell, the fit's seconds, the fixed
    effect's update seconds summed over its sweeps, and each update's
    kernel-1 launches; the ratio of the later tree to the first named; and
    whether every run of a cell published the same coefficients."""
    import statistics

    runs = []
    for path in logs:
        lines = [ln for ln in Path(path).read_text().splitlines() if ln.startswith('{"ab"')]
        if not lines:
            print(f"chip_smoke: no A/B result in {path}", file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
    trees = list(dict.fromkeys(Path(r["ab"]).name for r in runs))
    out = {}
    for cell in runs[0]["fit_s"]:
        row = {}
        for tree in trees:
            mine = [r for r in runs if Path(r["ab"]).name == tree]
            fit_s = [s for r in mine for s in r["fit_s"][cell]]
            fits = [f for r in mine for f in r["fixed_updates"][cell]]
            fixed = [sum(u["seconds"] for u in f) for f in fits]
            others = [sum(u["seconds"] for u in f)
                      for r in mine for f in r.get("random_updates", {}).get(cell, [])]
            row[tree] = dict(fit_s=statistics.median(fit_s), fit_s_each=fit_s,
                             fixed_s=statistics.median(fixed), fixed_s_each=fixed,
                             random_s=statistics.median(others) if others else None,
                             random_s_each=others,
                             kernel1=sorted({tuple(u["kernel1"] for u in f) for f in fits}))
        first, last = row[trees[0]], row[trees[-1]]
        row["ratio"] = dict(fit=last["fit_s"] / first["fit_s"],
                            fixed=last["fixed_s"] / first["fixed_s"],
                            random=(last["random_s"] / first["random_s"]
                                    if first["random_s"] and last["random_s"] else None))
        row["same_coefficients"] = len({json.dumps(r["coefficient_digests"][cell],
                                                   sort_keys=True) for r in runs}) == 1
        out[cell] = row
        print(f"{cell}: fit median {first['fit_s']:.3f} / {last['fit_s']:.3f} s "
              f"({row['ratio']['fit']:.3f}x); fixed updates median {first['fixed_s'] * 1e3:.2f} / "
              f"{last['fixed_s'] * 1e3:.2f} ms ({row['ratio']['fixed']:.3f}x); random-effect "
              f"updates median {_ms(first['random_s'])} / {_ms(last['random_s'])} ms "
              f"({_ratio(row['ratio']['random'])}); kernel-1 launches "
              f"a fixed update {first['kernel1']} / {last['kernel1']}; the same coefficients "
              f"in every run: {row['same_coefficients']}  [{trees[0]} / {trees[-1]}]")
    print(json.dumps({"ab_summary": out, "trees": trees, "runs": len(runs)}))
    return 0


def main() -> int:
    root = Path(__file__).resolve().parent
    ab = None
    if sys.argv[1:2] == ["--ab-summary"]:
        return ab_summary(sys.argv[2:])
    if sys.argv[1:2] == ["--ab"]:
        if len(sys.argv) != 3:
            print("usage: chip_smoke.py [--ab TREE | --ab-summary LOG...]", file=sys.stderr)
            return 2
        ab = root = Path(sys.argv[2]).resolve()
        while str(Path(__file__).resolve().parent) in sys.path:  # only TREE's package
            sys.path.remove(str(Path(__file__).resolve().parent))
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

    if ab is not None:
        return run_ab(ab)
    t_all = time.perf_counter()
    stats: dict = {}
    with Phase("1 device"):
        name, count, _ = phase_device()
    with Phase("2 kernel build"):
        phase_build()
    _count_objective_evaluations()
    _count_solver_evaluations()
    with Phase("3 fused_value_and_grad and fused_hvp vs plain"):
        phase_fused_glm(stats)
    with Phase("4 newton_step vs plain"):
        phase_soa_newton(stats)
    with Phase("5 main path glmix_chip full width"):
        host, xg = phase_main_path(stats)
    with Phase("6 card vs CPU reduced glmix_chip"):
        glmix_chip_reduced = phase_card_vs_cpu(host, xg)
    with Phase("19 glmix_chip-grid full width"):
        train, val = _per_user_split(host, xg)
        del xg  # host stays for phase 24
        grid = phase_glmix_chip_grid(stats, train, val)
    with Phase("20 glmix_chip-reg-path full width"):
        phase_glmix_chip_reg_path(stats, train, val)
    with Phase("22 evaluation suite on the card"):
        phase_evaluation_suite(stats, grid)
    with Phase("23 glmix_chip-retrain full width"):
        phase_glmix_chip_retrain(stats, grid, train, val)
    del train, val, grid
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
    with Phase("21 glmix_sparse held out"):
        phase_glmix_sparse_held_out(stats, card)
    del card
    with Phase("15 glmix2-norm-var full width"):
        phase_glmix2_norm_var(stats)
    with Phase("16 card vs CPU, normalization and variances"):
        phase_norm_var_card_vs_cpu(stats, glmix_chip_reduced)
    del glmix_chip_reduced
    with Phase("17 glmix_sparse-norm-en full width, card and CPU"):
        phase_glmix_sparse_norm_en(stats)
    with Phase("18 glmix2-en-box full width"):
        phase_glmix2_en_box(stats)
    with Phase("24(a) glmix_chip-bf16 full width"):
        xg16 = phase_glmix_chip_bf16(stats, host)
    with Phase("24(b) glmix2-TRON-bf16 full width"):
        phase_glmix2_tron_bf16(stats)
    with Phase("24(c) card vs CPU, bf16 storage"):
        phase_narrow_card_vs_cpu(host, xg16)
    del xg16
    with Phase("24(d, e) storage-width kernels vs plain, and their times"):
        phase_narrow_kernels(stats)
    with Phase("25 host syncs and device idle share per fit"):
        phase_sync_counts(stats, host)
    with Phase("26 fused sweep"):
        phase_fused_sweep(stats, host)
    with Phase("27 validated fused sweep"):
        phase_fused_validated(stats, host)
    del host
    with Phase("28 the RANDOM projector: glmix2-random, glmix_sparse-norm-random, SoA"):
        phase_random_projector(stats)
    with Phase("14 kernels"):
        checked = stats.get("lbfgs_solves_checked", {})
        log(f"fixed-effect L-BFGS solves on kernel 1's path held against their own "
            f"evaluation counts: {sum(checked.values())} on "
            f"{sum(1 for v in checked.values() if v)} paths; kernel-1 launches equal the "
            f"scalar loop's on all {len(SCALAR_LOOP_KERNEL1)} of its paths")
        if not sum(checked.values()):
            raise AssertionError("no fixed-effect L-BFGS solve was held against its own "
                                 "evaluation count")
        unrun = set(SCALAR_LOOP_KERNEL1) - set(stats["fused_value_and_grad"]["launches_by_path"])
        if unrun:
            raise AssertionError(f"paths of the scalar loop's counts not run: {sorted(unrun)}")
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
                            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                            **({"by_shape": s["by_shape"]} if "by_shape" in s else {})})
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
