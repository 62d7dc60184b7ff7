"""Synthetic tasks: ``glmix_chip``, the BASELINE glmix2 / glmix3, the
BASELINE sparse1m and ``glmix_sparse``.

``synth_sparse1m(scale)`` is a numpy copy of ``bench.synth_sparse1m`` (the
BASELINE #2 data): 131,072 rows over a 1,000,000-column vocabulary, 32
nonzeros per row (half from a 4,096-column hot head), Poisson labels.

``synth_glmix_sparse(scale)`` is a GLMix whose per-user model is compact:
sparse1m's rows and fixed shard, 4,096 users x 32 rows (shuffled), and a
per-user shard over a 50,000-column vocabulary in which each user owns a
bag of 32 columns and each row carries 24 distinct columns of its user's
bag, about 20% of them zero-valued (padded slots).  Logistic labels from
fixed plus per-user logits scaled to unit standard deviation; the logits
are returned for the task's Bayes AUC.

``synth_glmix_sparse_norm(scale)`` is glmix_sparse with an intercept column
in the per-user shard (index 50,000, value 1.0 in every row; dim 50,001,
25 slots a row), the data of glmix_sparse-norm-en, whose per-user shard is
standardized and needs a column to absorb the shifts.

``synth_glmix(scale, three)`` is a numpy copy of the repository's
``bench.synth_glmix`` (the BASELINE #3 / #4 data, glmix2 and glmix3): 2048
users x 256 rows with 256 fixed and 16 per-user features (glmix2), or 2048
users x 128 rows with 128 fixed, 16 per-user and 16 per-item features over
1024 items (glmix3); ``scale`` divides the rows per user.  The same seed and
draws give bitwise the same arrays; it also returns the generative logits,
from which the task's Bayes AUC (~0.73 at full scale) follows.  With
``storage`` ("bfloat16", "float16") the designs come as CPU tensors of that
dtype, rounded once from the float32 draws (numpy has no bfloat16); labels
and logits are drawn from the float32 designs either way.

``generate_binary_classification``, ``generate_poisson``, ``generate_linear``
and ``generate_glmix``, at the end of this module, are the small seeded
generators of photon_ml_tpu/data/synthetic.py, bitwise the same numpy arrays.

The module's middle part is the ``glmix_chip`` task.

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
matches).  At a narrow ``dtype`` each float32 chunk is rounded on the
device as it is made, so the design at bf16 is the float32 design rounded
and no float32 [n, 512] copy exists.  Generative logits have std ~1.3, so the task has real label noise
(Bayes AUC ~0.8).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import GameData

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
    fixed design).  Returns y, uids, xu, n, users, per_user and the
    generative logits (for the task's Bayes AUC)."""
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
            "per_user": per_user, "logits": logits}


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


def synth_glmix(scale: int, three: bool, storage: "str | None" = None) -> dict:
    """BASELINE glmix2 (``three`` False) / glmix3 (True) data, rows in a
    seeded random order: xg, xu, uids, y (and xi, iids for glmix3) as the
    reference generator gives them, plus the generative ``logits``; with
    ``storage`` the designs xg, xu (xi) as CPU tensors of that dtype."""
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
    out = {k: v[perm] for k, v in out.items()}
    if storage is not None:
        from photon_ml_tpu_torch.game.config import storage_torch_dtype

        sd = storage_torch_dtype(storage)
        for k in ("xg", "xu", "xi"):
            if k in out:
                out[k] = torch.from_numpy(out[k]).to(sd)
    return out


def synth_sparse1m(scale: int = 1) -> dict:
    """BASELINE sparse1m, bitwise ``bench.synth_sparse1m``: indices [n, 32]
    int32 (unique within a row), values [n, 32], Poisson y, dim 1,000,000."""
    rng = np.random.default_rng(12)
    n, d, k = 131072 // scale, 1_000_000, 32
    kh = k // 2
    head_block = 4096 // kh
    head = (np.arange(kh) * head_block)[None, :] + rng.integers(0, head_block, size=(n, kh))
    kt = k - kh
    tail_block = (d - 4096) // kt
    tail = 4096 + (np.arange(kt) * tail_block)[None, :] + rng.integers(
        0, tail_block, size=(n, kt))
    idx = np.concatenate([head, tail], axis=1).astype(np.int32)
    vals = rng.exponential(0.5, size=(n, k)).astype(np.float32)
    w_true = rng.normal(size=d) * 0.05
    z = np.clip((vals * w_true[idx]).sum(axis=1), -4, 4)
    y = rng.poisson(np.exp(z)).astype(np.float32)
    return {"indices": idx, "values": vals, "y": y, "dim": d}


GS_PER_USER, GS_VOCAB, GS_BAG, GS_K = 32, 50_000, 32, 24  # glmix_sparse widths


def synth_glmix_sparse(scale: int = 1) -> dict:
    """glmix_sparse data: ``fixed`` (sparse1m's indices / values / dim) and
    ``user`` (indices [n, 24] int32, values [n, 24], dim 50,000) shards,
    ``uids``, logistic ``y`` and the generative ``logits``; 4096 // scale
    users x 32 rows."""
    fixed = synth_sparse1m(scale)
    users = 4096 // scale
    n = users * GS_PER_USER
    assert len(fixed["y"]) == n
    rng = np.random.default_rng(2026)
    uids = rng.permutation(np.repeat(np.arange(users, dtype=np.int64), GS_PER_USER))
    bags = np.stack([rng.choice(GS_VOCAB, GS_BAG, replace=False) for _ in range(users)])
    pos = np.argsort(rng.random((n, GS_BAG)), axis=1)[:, :GS_K]  # 24 distinct slots
    u_idx = bags[uids[:, None], pos].astype(np.int32)
    u_val = rng.normal(size=(n, GS_K)).astype(np.float32)
    u_val[rng.random((n, GS_K)) < 0.2] = 0.0  # padded COO slots
    w_g = rng.normal(size=fixed["dim"]) * 0.1
    w_u = rng.normal(size=(users, GS_BAG)) * 0.15  # one per bag slot
    logits = ((fixed["values"] * w_g[fixed["indices"]]).sum(axis=1)
              + (u_val * w_u[uids[:, None], pos]).sum(axis=1))
    logits = logits / logits.std()
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return {"fixed": {"indices": fixed["indices"], "values": fixed["values"],
                      "dim": fixed["dim"]},
            "user": {"indices": u_idx, "values": u_val, "dim": GS_VOCAB},
            "uids": uids, "y": y, "logits": logits}


def synth_glmix_sparse_norm(scale: int = 1) -> dict:
    """glmix_sparse-norm-en data: ``synth_glmix_sparse(scale)`` with the
    per-user shard's intercept column GS_VOCAB (value 1.0) appended to every
    row, so the shard has dim GS_VOCAB + 1 and GS_K + 1 slots a row."""
    data = synth_glmix_sparse(scale)
    u = data["user"]
    n = len(data["y"])
    u_idx = np.concatenate([u["indices"], np.full((n, 1), GS_VOCAB, np.int32)], axis=1)
    u_val = np.concatenate([u["values"], np.ones((n, 1), np.float32)], axis=1)
    return dict(data, user={"indices": u_idx, "values": u_val, "dim": GS_VOCAB + 1})


def last_rows_per_entity(ids: np.ndarray, count: int) -> np.ndarray:
    """Boolean mask of the last ``count`` rows of every entity of ``ids``, in
    order of appearance (a held-out split inside each entity)."""
    ids = np.asarray(ids)
    _, inverse, counts = np.unique(ids, return_inverse=True, return_counts=True)
    order = np.argsort(inverse, kind="stable")
    rank = np.empty(len(ids), np.int64)
    rank[order] = np.arange(len(ids)) - (np.cumsum(counts) - counts)[inverse[order]]
    return rank >= counts[inverse] - count


# -- the reference's small seeded generators (tests and examples), the same
# numpy draws in the same order, so each array is the reference's bitwise


def generate_binary_classification(n: int, d: int, seed: int = 0, intercept: bool = True,
                                   dtype=np.float32
                                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, w_true) with logits x @ w_true; column 0 is 1 with ``intercept``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    if intercept:
        x[:, 0] = 1.0
    w = (rng.normal(size=d) * 0.5).astype(dtype)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ w)))).astype(dtype)
    return x, y, w


def generate_poisson(n: int, d: int, seed: int = 0, dtype=np.float32
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.3).astype(dtype)
    w = (rng.normal(size=d) * 0.3).astype(dtype)
    lam = np.exp(np.clip(x @ w, -10, 3))
    y = rng.poisson(lam).astype(dtype)
    return x, y, w


def generate_linear(n: int, d: int, noise: float = 0.1, seed: int = 0, dtype=np.float32
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    w = rng.normal(size=d).astype(dtype)
    y = (x @ w + noise * rng.normal(size=n)).astype(dtype)
    return x, y, w


def generate_glmix(n_users: int = 64, per_user: int = 128, d_global: int = 32,
                   d_user: int = 8, n_items: Optional[int] = None, d_item: int = 8,
                   seed: int = 0, dtype=np.float32
                   ) -> Tuple[GameData, Dict[str, np.ndarray]]:
    """Two- or three-coordinate GLMix data (fixed, per-user and, with
    ``n_items``, per-item), logistic response, rows shuffled.  Returns
    (GameData, the true parameters)."""
    rng = np.random.default_rng(seed)
    n = n_users * per_user
    xg = rng.normal(size=(n, d_global)).astype(dtype)
    xu = rng.normal(size=(n, d_user)).astype(dtype)
    uid = np.repeat(np.arange(n_users, dtype=np.int64), per_user)
    wg = (rng.normal(size=d_global) * 0.5).astype(dtype)
    wu = (rng.normal(size=(n_users, d_user))).astype(dtype)
    logits = xg @ wg + np.einsum("nd,nd->n", xu, wu[uid])

    features = {"global": xg, "per_user": xu}
    id_tags = {"userId": uid}
    truth = {"wg": wg, "wu": wu}
    if n_items is not None:
        xi = rng.normal(size=(n, d_item)).astype(dtype)
        iid = rng.integers(0, n_items, size=n).astype(np.int64)
        wi = rng.normal(size=(n_items, d_item)).astype(dtype)
        logits = logits + np.einsum("nd,nd->n", xi, wi[iid])
        features["per_item"] = xi
        id_tags["itemId"] = iid
        truth["wi"] = wi

    perm = rng.permutation(n)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(dtype)
    data = GameData(y=y[perm], features={k: v[perm] for k, v in features.items()},
                    id_tags={k: v[perm] for k, v in id_tags.items()})
    return data, truth
