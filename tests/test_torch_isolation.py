"""The PyTorch port stands alone: it never imports JAX, the JAX package or
bench.py, and its default device is the card, never a silent CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu", "bench")

_TINY_FIT = r"""
import sys
import numpy as np
import torch
from photon_ml_tpu_torch.core.regularization import Regularization
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig)
from photon_ml_tpu_torch.evaluation.metrics import auc_roc
from photon_ml_tpu_torch.opt.types import SolverConfig
from photon_ml_tpu_torch.types import TaskType
import photon_ml_tpu_torch.convert, photon_ml_tpu_torch.data.synthetic
import photon_ml_tpu_torch.ops._build

rng = np.random.default_rng(0)
uids = np.repeat(np.arange(40), 12)
n = len(uids)
xg, xu = rng.normal(size=(n, 16)), rng.normal(size=(n, 4))
y = (rng.random(n) < 0.5).astype(np.float32)
data = GameData(y=y, features={"g": xg, "u": xu}, id_tags={"userId": uids})
s = SolverConfig(max_iters=5)
cfg = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2, coordinates={
    "fixed": FixedEffectConfig(feature_shard="g", solver=s, reg=Regularization(l2=1.0)),
    "user": RandomEffectConfig(random_effect_type="userId", feature_shard="u",
                               solver=s, reg=Regularization(l2=1.0), active_cap=8)})
model = GameEstimator(device="cpu").fit(data, [cfg])[0].model
scores = model.score(data, device="cpu")
assert scores.shape == (n,) and bool(torch.isfinite(scores).all())
auc_roc(scores, torch.from_numpy(y).double(), torch.ones(n, dtype=torch.float64))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "photon_ml_tpu", "bench"))
assert not bad, bad
print("ISOLATED")
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _TINY_FIT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_forbidden_imports_in_port_or_smoke():
    files = sorted((ROOT / "photon_ml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    hits = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
            for f in files for mod, line in _imported_roots(f) if mod in FORBIDDEN]
    assert not hits, hits


def test_default_device_without_cuda_raises(monkeypatch):
    from photon_ml_tpu_torch.device import resolve_device
    from photon_ml_tpu_torch.game import GameEstimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GameEstimator()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
