"""The ``glmix_chip`` synthetic GLMix task.

Port of the glmix_chip generator of the repository's ``bench.py``
(``_chip_sizes``, ``_chip_signal_cols``, ``synth_glmix_chip`` and the device
design fill of ``run_glmix_chip``): a logistic fixed effect over 512 dense
features and a 4-feature per-user random effect, 131,072 users x 64 rows at
scale 1 (8,388,608 rows).

Host half (``synth_glmix_chip``): labels, the per-user features and user ids,
bit-for-bit the reference's numpy draws.  Device half (``chip_design``): the
[n, 512] fixed design is made where it is used, never on the host: 16
counter-based signal columns, which the host half reproduces exactly to draw
the labels, then 496 columns of Gaussian noise from a seeded
``torch.Generator`` (other bits than JAX's PRNG; only the distribution
matches).  Generative logits have std ~1.3, so the task has real label noise
(Bayes AUC ~0.8).
"""

from __future__ import annotations

import numpy as np
import torch

D_SIG, D_CHIP_G, D_CHIP_U = 16, 512, 4  # glmix_chip feature widths
CHIP_CAP = 32        # per-entity active-sample cap
CHIP_P = 8191        # prime phase period of the counter-based signal columns
CHIP_CHUNK = 1 << 19  # rows generated per device chunk
CHIP_SEED = 99


def chip_sizes(scale: int):
    """(users, per_user): scale 1 = 131072 users x 64; larger scales shrink
    per_user first (floor 16), then the user count."""
    users = 131072 // max(1, scale // 8)
    per_user = max(16, 64 // min(max(scale, 1), 8))
    return users, per_user


def _signal_phase_np(i: np.ndarray) -> np.ndarray:
    k = 1 + 37 * (np.arange(D_SIG, dtype=np.int32) + 1)
    im = (np.asarray(i) % CHIP_P).astype(np.int32)
    return (im[:, None] * k[None, :]) % CHIP_P  # < P*P < 2^31: exact in int32


_PHASE_SCALE = np.float32(2.0 * np.pi / CHIP_P)


def chip_signal_cols_np(i: np.ndarray) -> np.ndarray:
    """h[i, j] = sin(2π·((i mod P)·k_j mod P)/P) in float32, on the host."""
    return np.sin(_signal_phase_np(i).astype(np.float32) * _PHASE_SCALE)


def chip_signal_cols(i: torch.Tensor) -> torch.Tensor:
    """The same columns for a tensor of row indices, on its device."""
    k = 1 + 37 * (torch.arange(D_SIG, dtype=torch.int32, device=i.device) + 1)
    im = (i % CHIP_P).to(torch.int32)
    ph = (im[:, None] * k[None, :]) % CHIP_P
    return torch.sin(ph.to(torch.float32) * float(_PHASE_SCALE))


def synth_glmix_chip(scale: int = 1) -> dict:
    """Host half: labels, per-user features and user ids (everything but the
    fixed design).  Returns y, uids, xu, n, users, per_user."""
    users, per_user = chip_sizes(scale)
    n = users * per_user
    rng = np.random.default_rng(1234)
    uids = np.repeat(np.arange(users, dtype=np.int64), per_user)
    xu = rng.normal(size=(n, D_CHIP_U)).astype(np.float32)
    wg_sig = rng.normal(size=D_SIG) * 0.4
    wu = (rng.normal(size=(users, D_CHIP_U)) * 0.35).astype(np.float32)
    logits = np.empty(n, np.float64)
    ch = 1 << 20
    for lo in range(0, n, ch):
        hi = min(lo + ch, n)
        i = np.arange(lo, hi, dtype=np.int64)
        h = chip_signal_cols_np(i).astype(np.float64)
        logits[lo:hi] = h @ wg_sig + np.einsum(
            "nd,nd->n", xu[lo:hi].astype(np.float64),
            wu[uids[lo:hi]].astype(np.float64))
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return {"y": y, "uids": uids, "xu": xu, "n": n, "users": users,
            "per_user": per_user}


def chip_design(n: int, device: "torch.device | str", seed: int = CHIP_SEED,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Device half: the [n, 512] fixed design, signal columns then noise,
    filled chunk by chunk on ``device`` from a seeded generator."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.empty((n, D_CHIP_G), dtype=dtype, device=device)
    for lo in range(0, n, CHIP_CHUNK):
        hi = min(lo + CHIP_CHUNK, n)
        i = torch.arange(lo, hi, dtype=torch.int64, device=device)
        x[lo:hi, :D_SIG] = chip_signal_cols(i).to(dtype)
        x[lo:hi, D_SIG:] = torch.randn((hi - lo, D_CHIP_G - D_SIG), generator=gen,
                                       dtype=torch.float32, device=device).to(dtype)
    return x
