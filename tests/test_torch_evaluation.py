"""The port's evaluation layer against the JAX package's, on the CPU in
float64.

Every metric of ``evaluation/metrics.py`` and ``grouped_evaluate`` take the
same numpy inputs on both sides and agree within rtol 1e-12 (atol 1e-15 for
values at 0): both sort, cumulate and sum in the same order, and differ only
where a reduction's order does.  Inputs carry tied scores, weight-0 rows,
no positives or no negatives, and ``k`` above the count of valid rows;
grouped inputs add groups of size 1, degenerate groups, an all-zero-weight
group, real 0.0 scores tied with the padding, and unsorted, non-contiguous
ids.  Also: ``make_evaluator``'s names, orderings and errors, a batched
metric against its rows one at a time, and ``EvaluationSuite`` with a
``group_ids`` dict.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import evaluator as jev
from photon_ml_tpu.evaluation import metrics as jm
from photon_ml_tpu_torch import evaluation as tev_pkg
from photon_ml_tpu_torch.evaluation import evaluator as tev
from photon_ml_tpu_torch.evaluation import metrics as tm

RTOL, ATOL = 1e-12, 1e-15
K_VALUES = (1, 5, 1000)  # 1000: above every input's count of valid rows
METRICS = ["auc_roc", "auc_pr", "rmse", "squared_loss_metric", "logistic_loss_metric",
           "poisson_loss_metric", "smoothed_hinge_loss_metric"] + \
    [f"precision_at_k@{k}" for k in K_VALUES]
SPECS = ["auc", "aupr", "rmse", "logistic_loss", "poisson_loss", "squared_loss",
         "smoothed_hinge_loss", "precision@1", "precision@3", "precision@1000"]


def _fns(name):
    """(JAX, port) metric functions of ``name``."""
    if name.startswith("precision_at_k@"):
        k = int(name.split("@")[1])
        return (lambda s, l, w: jm.precision_at_k(k, s, l, w),
                lambda s, l, w: tm.precision_at_k(k, s, l, w))
    return getattr(jm, name), getattr(tm, name)


def _inputs(case: str, n: int = 200, seed: int = 0):
    """(scores, labels, weights), float64 numpy.  Scores on a 0.25 grid, so
    ties are common and some scores are exactly 0.0; every ninth weight 0."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.normal(size=n) * 4) / 4
    y = (rng.random(n) < 0.4).astype(np.float64)
    w = rng.random(n) + 0.25
    w[::9] = 0.0
    if case == "no_positives":
        y[:] = 0.0
    elif case == "no_negatives":
        y[:] = 1.0
    elif case == "zero_weight":
        w[:] = 0.0
    elif case == "distinct":
        s = rng.normal(size=n)
    elif case == "unit_weights":
        w[:] = 1.0
    return s, y, w


def _close(t, j):
    t, j = float(t), float(j)
    assert abs(t - j) <= RTOL * abs(j) + ATOL, (t, j)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("case", ["ties", "distinct", "unit_weights", "no_positives",
                                  "no_negatives", "zero_weight"])
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name, case):
    jf, tf = _fns(name)
    s, y, w = _inputs(case)
    out = tf(*_t(s, y, w))
    assert out.dtype == torch.float64 and out.shape == ()
    _close(out, jf(s, y, w))


@pytest.mark.parametrize("name", METRICS)
def test_metric_batches_over_leading_dimensions(name):
    """A [3, 4, n] call equals each row's own call (the grouped layout's
    batched evaluation), bitwise."""
    _, tf = _fns(name)
    rows = [_inputs(case, n=40, seed=i) for i, case in
            enumerate(["ties", "distinct", "no_positives", "no_negatives"] * 3)]
    s, y, w = (np.stack([r[i] for r in rows]).reshape(3, 4, 40) for i in range(3))
    batched = tf(*_t(s, y, w))
    assert batched.shape == (3, 4)
    for a in range(3):
        for b in range(4):
            assert float(batched[a, b]) == float(tf(*_t(s[a, b], y[a, b], w[a, b])))


def test_metric_edge_values():
    """The reference's conventions: degenerate AUC 0.5, AUPR 0 with no
    positives, RMSE over a total weight of 0 reads 0, precision of an
    all-zero-weight ranking 0, and precision in float32 stays float32."""
    s, y, w = _t(*_inputs("no_positives"))
    assert float(tm.auc_roc(s, y, w)) == 0.5 and float(tm.auc_pr(s, y, w)) == 0.0
    s, y, w = _t(*_inputs("zero_weight"))
    assert float(tm.rmse(s, y, w)) == 0.0 and float(tm.precision_at_k(3, s, y, w)) == 0.0
    s32 = torch.tensor([0.3, 0.1, 0.2], dtype=torch.float32)
    out = tm.precision_at_k(2, s32, torch.tensor([1.0, 0.0, 0.0]), torch.ones(3))
    assert out.dtype == torch.float32 and float(out) == 0.5


def _grouped_inputs(seed: int = 5):
    """Unsorted, non-contiguous ids over 30 groups of sizes 1..12; group 6
    (the first id) all weight 0, group 7 with no positives, group 8 with no
    negatives, groups 9 and 10 of size 1; scores on a 0.5 grid, so real 0.0
    scores tie with the 0.0 padding."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 13, size=30)
    sizes[[9, 10]] = 1
    ids = np.repeat(np.arange(30) * 7 + 6, sizes)
    perm = rng.permutation(len(ids))
    ids = ids[perm]
    n = len(ids)
    s = np.round(rng.normal(size=n) * 2) / 2
    y = (rng.random(n) < 0.5).astype(np.float64)
    w = rng.random(n) + 0.25
    w[ids == 6] = 0.0
    y[ids == 13] = 0.0
    y[ids == 20] = 1.0
    return ids, s, y, w


@pytest.mark.parametrize("name", METRICS)
def test_grouped_evaluate_matches_jax(name):
    jf, tf = _fns(name)
    ids, s, y, w = _grouped_inputs()
    assert (s == 0.0).sum() > 5
    j = jev.grouped_evaluate(jf, ids, s, y, w)
    t = tev.grouped_evaluate(tf, ids, *_t(s, y, w))
    assert isinstance(t, float)
    _close(t, j)


def test_pad_groups_layout():
    """Groups in sorted id order, samples in their original order inside a
    group, padded with 0.0 in every array."""
    ids = np.array([5, 2, 5, 9, 2, 5])
    s = torch.arange(1.0, 7.0, dtype=torch.float64)
    (p,) = tev.pad_groups(ids, s)
    assert p.tolist() == [[2.0, 5.0, 0.0], [1.0, 3.0, 6.0], [4.0, 0.0, 0.0]]
    assert tev.grouped_evaluate(tm.rmse, np.array([], np.int64), *(s[:0],) * 3) != \
        tev.grouped_evaluate(tm.rmse, np.array([], np.int64), *(s[:0],) * 3)  # NaN


@pytest.mark.parametrize("spec,name,larger", [
    ("auc", "auc", True), ("aupr", "aupr", True), ("rmse", "rmse", False),
    ("logistic_loss", "logistic_loss", False), ("poisson_loss", "poisson_loss", False),
    ("squared_loss", "squared_loss", False),
    ("smoothed_hinge_loss", "smoothed_hinge_loss", False),
    ("precision@5", "precision_at_k@5", True), ("auc:userId", "auc:userId", True),
    ("precision@3:songId", "precision_at_k@3:songId", True),
    ("rmse:itemId", "rmse:itemId", False)])
def test_make_evaluator_matches_jax(spec, name, larger):
    t, j = tev.make_evaluator(spec), jev.make_evaluator(spec)
    assert t.name == j.name == name
    assert t.larger_is_better == j.larger_is_better == larger
    assert (t.kind.value, t.k, t.group_name) == (j.kind.value, j.k, j.group_name)
    assert t.better_than(1.0, 2.0) == j.better_than(1.0, 2.0) == (not larger)


@pytest.mark.parametrize("spec", ["nope", "auc_roc", "precision@x", "bogus:userId"])
def test_make_evaluator_refuses_unknown_names(spec):
    with pytest.raises(ValueError):
        jev.make_evaluator(spec)
    with pytest.raises(ValueError):
        tev.make_evaluator(spec)


def test_grouped_evaluator_needs_group_ids():
    s, y, w = _t(*_inputs("ties"))
    with pytest.raises(ValueError, match="needs group ids 'userId'"):
        tev.make_evaluator("auc:userId").evaluate(s, y, w)


def test_evaluation_suite_matches_jax():
    """A suite of every spec, plain and grouped over two id tags, with a
    group_ids dict and numpy labels and weights; names in the reference's
    order."""
    ids, s, y, w = _grouped_inputs(seed=8)
    other = np.random.default_rng(8).integers(0, 4, size=len(ids))
    specs = SPECS + [f"{sp}:userId" for sp in SPECS] + ["auc:itemId", "precision@2:itemId"]
    groups = {"userId": ids, "itemId": other}
    jr = jev.EvaluationSuite.from_specs(specs, primary="aupr:userId").evaluate(
        s, y, w, group_ids=groups)
    tr = tev.EvaluationSuite.from_specs(specs, primary="aupr:userId").evaluate(
        torch.from_numpy(s), y, w, group_ids=groups)
    assert list(tr.values) == list(jr.values) and tr.primary_name == jr.primary_name
    for k in jr.values:
        _close(tr.values[k], jr.values[k])
    assert tr.values["precision_at_k@1000"] == jr.values["precision_at_k@1000"]


def test_package_exports_match_jax():
    import photon_ml_tpu.evaluation as jpkg

    names = {n for n in dir(jpkg) if not n.startswith("_")} - {"evaluator", "metrics"}
    assert names <= set(dir(tev_pkg)), names - set(dir(tev_pkg))
