"""Synthetic GLMix tasks: ``glmix_chip``, and the BASELINE glmix2 / glmix3.

``synth_glmix(scale, three)`` is a numpy copy of the repository's
``bench.synth_glmix`` (the BASELINE #3 / #4 data, glmix2 and glmix3): 2048
users x 256 rows with 256 fixed and 16 per-user features (glmix2), or 2048
users x 128 rows with 128 fixed, 16 per-user and 16 per-item features over
1024 items (glmix3); ``scale`` divides the rows per user.  The same seed and
draws give bitwise the same arrays; it also returns the generative logits,
from which the task's Bayes AUC (~0.73 at full scale) follows.

The rest of this module is the ``glmix_chip`` task.

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


def synth_glmix(scale: int, three: bool) -> dict:
    """BASELINE glmix2 (``three`` False) / glmix3 (True) data, rows in a
    seeded random order: xg, xu, uids, y (and xi, iids for glmix3) as the
    reference generator gives them, plus the generative ``logits``."""
    rng = np.random.default_rng(42)
    n_users, d_g, d_u = 2048, (128 if three else 256), 16
    per_user = (128 if three else 256) // scale
    n = n_users * per_user
    xg = rng.normal(size=(n, d_g)).astype(np.float32)
    xu = (0.6 * xg[:, :d_u] + 0.8 * rng.normal(size=(n, d_u))).astype(np.float32)
    uids = np.repeat(np.arange(n_users), per_user)
    wg = (rng.normal(size=d_g) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(n_users, d_u)) * 0.15).astype(np.float32)
    logits = xg @ wg + np.einsum("nd,nd->n", xu, wu[uids])
    out = {"xg": xg, "xu": xu, "uids": uids}
    if three:
        n_items, d_i = 1024, 16
        xi = (0.6 * xg[:, d_u:d_u + d_i] + 0.8 * rng.normal(size=(n, d_i))).astype(np.float32)
        iids = rng.integers(0, n_items, size=n)
        wi = (rng.normal(size=(n_items, d_i)) * 0.15).astype(np.float32)
        logits = logits + np.einsum("nd,nd->n", xi, wi[iids])
        out.update(xi=xi, iids=iids)
    out["y"] = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    out["logits"] = logits
    perm = rng.permutation(n)
    return {k: v[perm] for k, v in out.items()}
