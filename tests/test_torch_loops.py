"""The solvers' loop form: host reads, evaluations and the one-lane public
forms, on the CPU.

A census of host reads: a ``torch.overrides.TorchFunctionMode`` records
``Tensor.__bool__``, ``Tensor.item``, ``Tensor.__int__``,
``Tensor.__float__``, ``torch.tensor`` and indexing by a 0-d tensor (read
on the host to index) by their caller's file:line while
small ``GameEstimator.fit``s run every solver path (the fixed effect's
L-BFGS plain, boxed and under shifts, OWLQN and TRON; the random effects'
SoA Newton, lane L-BFGS, lane OWLQN and lane TRON).  Inside ``opt/`` the
only read must be ``opt/loop.while_loop``'s, one per test of a loop's
condition, and no ``torch.tensor`` may be called inside a loop body.  Each
solver module's ``while_loop`` is wrapped to count conditions, bodies and
loops; the wrapper calls the helper itself, so the reads stay at its line.

Evaluations against the reference: the JAX ``minimize_lbfgs`` under
``jax.disable_jit()`` (its ``lax.while_loop`` a Python loop) counts its
``value_and_grad`` calls; the port's ``minimize_lbfgs`` must make as many,
with the same iterations and reason, at float64 on three losses, with and
without a box and under a normalization context.  ``strong_wolfe`` and
``two_loop_direction`` are held against the reference's at rtol 1e-10.
"""

import collections
import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from photon_ml_tpu.core import losses as jl
from photon_ml_tpu.core import normalization as jn
from photon_ml_tpu.core.batch import dense_batch as j_dense_batch
from photon_ml_tpu.core.objective import GLMObjective as JObjective
from photon_ml_tpu.core.regularization import Regularization as JReg
from photon_ml_tpu.opt import lbfgs as jlbfgs
from photon_ml_tpu.opt import linesearch as jlinesearch
from photon_ml_tpu.opt import types as jtypes
from photon_ml_tpu_torch.core import losses as tl
from photon_ml_tpu_torch.core import normalization as tn
from photon_ml_tpu_torch.core.batch import dense_batch as t_dense_batch
from photon_ml_tpu_torch.core.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.core.regularization import Regularization as TReg
from photon_ml_tpu_torch.game import (FixedEffectConfig, GameConfig, GameData,
                                      GameEstimator, RandomEffectConfig)
from photon_ml_tpu_torch.opt import lbfgs as tlbfgs
from photon_ml_tpu_torch.opt import linesearch as tlinesearch
from photon_ml_tpu_torch.opt import loop, newton_soa, tron
from photon_ml_tpu_torch.opt import types as ttypes
from photon_ml_tpu_torch.types import NormalizationType, OptimizerType, TaskType

OPT_DIR = Path(inspect.getsourcefile(loop)).resolve().parent
HELPER_SITE = (str(Path(inspect.getsourcefile(loop)).resolve()),
               inspect.getsourcelines(loop.while_loop)[1]
               + next(i for i, line in enumerate(inspect.getsourcelines(loop.while_loop)[0])
                      if "bool(cond(state))" in line))
WATCHED = {torch.Tensor.__bool__: "__bool__", torch.Tensor.item: "item",
           torch.Tensor.__int__: "__int__", torch.Tensor.__float__: "__float__",
           torch.tensor: "torch.tensor"}
SOLVER_MODULES = (tlinesearch, tlbfgs, tron, newton_soa)
RTOL = 1e-10  # the one-lane public forms against the reference, float64


# -- the census ---------------------------------------------------------------


class _Census(TorchFunctionMode):
    """Records each watched call as (kind, caller file, caller line, inside
    a loop body)."""

    def __init__(self, depth):
        super().__init__()
        self.depth = depth
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kind = WATCHED.get(func)
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) and _scalar_index(args[1]):
            kind = "index by a 0-d tensor"  # read on the host to index
        if kind is not None:
            frame = sys._getframe(1)
            self.calls.append((kind, str(Path(frame.f_code.co_filename).resolve()),
                               frame.f_lineno, self.depth[0] > 0))
        return func(*args, **(kwargs or {}))


def _scalar_index(index) -> bool:
    """Whether an index holds a 0-d integer or bool tensor, which indexing
    reads on the host."""
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(p, torch.Tensor) and p.dim() == 0 for p in parts)


def _counting_loops(monkeypatch):
    """Wrap every solver module's ``while_loop``: per loop (its body's
    qualified name) the conditions tested, the bodies run and the loops
    entered; and a depth counter that is positive inside any body."""
    counts = collections.defaultdict(collections.Counter)
    depth = [0]

    def counted(cond, body, state):
        name = body.__qualname__
        counts[name]["loops"] += 1

        def c(s):
            counts[name]["conds"] += 1
            return cond(s)

        def b(s):
            counts[name]["bodies"] += 1
            depth[0] += 1
            try:
                return body(s)
            finally:
                depth[0] -= 1

        return loop.while_loop(c, b, state)

    for mod in SOLVER_MODULES:
        monkeypatch.setattr(mod, "while_loop", counted)
    return counts, depth


def _census_data(seed, d_user):
    rng = np.random.default_rng(seed)
    n_users, per_user = 10, 24
    n = n_users * per_user
    xg = rng.normal(size=(n, 5)) + 0.5
    xg[:, 0] = 1.0
    xu = rng.normal(size=(n, d_user))
    uids = rng.permutation(np.repeat(np.arange(n_users), per_user))
    z = xg @ rng.normal(size=5) * 0.5 + np.einsum("nd,nd->n", xu,
                                                  rng.normal(size=(n_users, d_user))[uids]) * 0.3
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return GameData(y=y, features={"g": xg, "u": xu}, id_tags={"userId": uids})


# path -> (fixed config overrides, per-user config overrides or None, the
# per-user width, the loops that must run)
_LBFGS = {"_lbfgs.<locals>.body", "_lbfgs.<locals>.body.<locals>.search"}
_OWLQN = {"minimize_owlqn_lanes.<locals>.body",
          "minimize_owlqn_lanes.<locals>.body.<locals>.trial"}
_TRON = {"minimize_tron.<locals>.body", "_truncated_cg.<locals>.body"}
_NEWTON = {"solve_newton_soa.<locals>.body", "solve_newton_soa.<locals>.body.<locals>.trial"}
CENSUS_PATHS = {
    "fixed_lbfgs": (dict(), None, 3, _LBFGS),
    "fixed_lbfgs_box": (dict(constraints=((1, -0.05, 0.05), (2, 0.0, float("inf")))), None,
                        3, _LBFGS),
    "fixed_lbfgs_shifts": (dict(intercept_index=0), None, 3, _LBFGS),
    "fixed_owlqn": (dict(reg=TReg(l2=0.5, l1=2.0)), None, 3, _OWLQN),
    "fixed_tron": (dict(optimizer=OptimizerType.TRON), None, 3, _TRON),
    "re_soa_newton": (dict(), dict(), 3, _LBFGS | _NEWTON),
    "re_lbfgs_lanes": (dict(), dict(), 18, _LBFGS),
    "re_owlqn_lanes": (dict(), dict(reg=TReg(l2=1.0, l1=0.5)), 18, _LBFGS | _OWLQN),
    "re_tron_lanes": (dict(), dict(optimizer=OptimizerType.TRON), 18, _LBFGS | _TRON),
}


@pytest.mark.parametrize("path", list(CENSUS_PATHS))
def test_host_reads_only_at_the_loop_helper(path, monkeypatch):
    """Two sweeps through ``GameEstimator.fit`` (warm starts included):
    every read in ``opt/`` is the helper's ``bool(cond(state))``, one per
    condition tested, and no loop body calls ``torch.tensor``."""
    fixed_kw, user_kw, d_user, loops = CENSUS_PATHS[path]
    data = _census_data(len(path), d_user)
    solver = ttypes.SolverConfig(max_iters=20, tolerance=1e-9)
    fixed_kw = dict(dict(feature_shard="g", solver=solver, reg=TReg(l2=0.5)), **fixed_kw)
    coords = {"fixed": FixedEffectConfig(**fixed_kw)}
    if user_kw is not None:
        coords["per-user"] = RandomEffectConfig(
            **dict(dict(random_effect_type="userId", feature_shard="u", solver=solver,
                        reg=TReg(l2=1.0)), **user_kw))
    config = GameConfig(task=TaskType.LOGISTIC_REGRESSION, num_outer_iterations=2,
                        coordinates=coords)
    norm = {}
    if path == "fixed_lbfgs_shifts":
        x = torch.from_numpy(data.features["g"])
        norm["g"] = tn.build_normalization(NormalizationType.STANDARDIZATION,
                                           tn.compute_feature_stats(x, intercept_index=0))
    counts, depth = _counting_loops(monkeypatch)
    census = _Census(depth)
    with census:
        res = GameEstimator(device="cpu", dtype=torch.float64, normalization=norm).fit(
            data, [config])[0]
    assert np.isfinite(res.model["fixed"].coefficients.means).all()

    assert loops <= set(counts), f"loops not run: {loops - set(counts)}"
    in_opt = [c for c in census.calls
              if Path(c[1]).parent == OPT_DIR and c[0] != "torch.tensor"]
    elsewhere = [c for c in in_opt if (c[0], c[1], c[2]) != ("__bool__",) + HELPER_SITE]
    assert not elsewhere, f"host reads in opt/ off the helper: {sorted(set(elsewhere))}"
    conds = sum(c["conds"] for c in counts.values())
    assert len(in_opt) == conds
    for name, c in counts.items():  # one read a trip, and one where the loop ends
        assert c["conds"] == c["bodies"] + c["loops"], name
    made = [c for c in census.calls if c[0] == "torch.tensor" and c[3]]
    assert not made, f"torch.tensor inside a loop body: {sorted(set(made))}"


# -- evaluations against the reference ----------------------------------------


def _glm(n, d, seed, loss):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * 0.4 + 0.3
    z = x @ rng.normal(size=d)
    y = {"logistic": (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64),
         "poisson": rng.poisson(np.exp(np.clip(0.3 * z, -4, 2))).astype(np.float64),
         "squared": z + rng.normal(size=n) * 0.1}[loss]
    return x, y, rng.normal(size=n) * 0.1, rng.random(n) + 0.5


def _both_objectives(loss, variant, x):
    """(JAX objective, port objective), with the variant's shared context."""
    jnorm, tnorm = jn.no_normalization(), tn.no_normalization()
    if variant == "norm":
        factors = 1.0 / (x.std(axis=0) + 0.1)
        shifts = x.mean(axis=0)
        jnorm = jn.NormalizationContext(factors=jnp.asarray(factors),
                                        shifts=jnp.asarray(shifts))
        tnorm = tn.NormalizationContext(factors=torch.from_numpy(factors),
                                        shifts=torch.from_numpy(shifts))
    return (JObjective(loss=jl.loss_by_name(loss), reg=JReg(l2=0.4), norm=jnorm),
            TObjective(loss=tl.loss_by_name(loss), reg=TReg(l2=0.4), norm=tnorm))


@pytest.mark.parametrize("variant", ["plain", "box", "norm"])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_single_lbfgs_evaluations_match_reference(loss, variant):
    """The port's ``minimize_lbfgs`` evaluates the objective as often as the
    reference's, and stops at the same iteration for the same reason."""
    d = 7
    x, y, off, wt = _glm(160, d, seed=3 + len(loss) + len(variant), loss=loss)
    jobj, tobj = _both_objectives(loss, variant, x)
    jb, tb = j_dense_batch(x, y, off, wt), t_dense_batch(x, y, off, wt)
    box = None
    if variant == "box":
        lo, hi = np.full(d, -np.inf), np.full(d, np.inf)
        lo[0], hi[1], lo[2], hi[2] = 0.05, -0.02, -0.1, 0.1
        box = (lo, hi)
    kw = dict(max_iters=40, tolerance=1e-10)
    calls = collections.Counter()

    def jvg(w):
        calls["jax"] += 1
        return jobj.value_and_grad(w, jb)

    def tvg(w):
        calls["port"] += 1
        return tobj.value_and_grad(w, tb)

    with jax.disable_jit():
        jres = jlbfgs.minimize_lbfgs(jvg, jnp.zeros(d), jtypes.SolverConfig(**kw),
                                     box=None if box is None else tuple(map(jnp.asarray, box)))
    tres = tlbfgs.minimize_lbfgs(tvg, torch.zeros(d, dtype=torch.float64),
                                 ttypes.SolverConfig(**kw),
                                 box=None if box is None else tuple(map(torch.from_numpy, box)))
    assert calls["port"] == calls["jax"] > 3
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.reason) == int(jres.reason)
    assert tres.value.dim() == tres.iterations.dim() == tres.reason.dim() == 0
    w, jw = tres.w.numpy(), np.asarray(jres.w)
    assert np.abs(w - jw).max() <= 1e-8 * np.abs(jw).max()


@pytest.mark.parametrize("alpha0", [1e-3, 1.0, 40.0])
def test_strong_wolfe_matches_reference(alpha0):
    """A single search: expansion from a small first step, an accepted unit
    step and a zoom back from a long one."""
    x, y, off, wt = _glm(200, 6, seed=9, loss="logistic")
    jobj, tobj = _both_objectives("logistic", "plain", x)
    jb, tb = j_dense_batch(x, y, off, wt), t_dense_batch(x, y, off, wt)
    w0 = np.random.default_rng(1).normal(size=6) * 0.2
    jf0, jg0 = jobj.value_and_grad(jnp.asarray(w0), jb)
    direction = -np.asarray(jg0)
    jls = jlinesearch.strong_wolfe(
        lambda a: jobj.value_and_grad(jnp.asarray(w0) + a * jnp.asarray(direction), jb),
        jf0, jg0, jnp.asarray(direction), jnp.asarray(alpha0))
    tw0, td = torch.from_numpy(w0), torch.from_numpy(direction)
    tf0, tg0 = tobj.value_and_grad(tw0, tb)
    tls = tlinesearch.strong_wolfe(lambda a: tobj.value_and_grad(tw0 + a * td, tb),
                                   tf0, tg0, td, alpha0)
    assert int(tls.num_evals) == int(jls.num_evals)
    assert bool(tls.success) == bool(jls.success) and bool(tls.wolfe) == bool(jls.wolfe)
    for t, j in ((tls.alpha, jls.alpha), (tls.phi, jls.phi)):
        assert abs(float(t) - float(j)) <= RTOL * abs(float(j))
    np.testing.assert_allclose(tls.g.numpy(), np.asarray(jls.g), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jls.g)).max())


@pytest.mark.parametrize("count,pos", [(0, 0), (3, 3), (10, 4)])
def test_two_loop_direction_matches_reference(count, pos):
    """The masked recursion over circular buffers: empty, part-filled and
    wrapped; slots past the count hold values that must not count."""
    rng = np.random.default_rng(count + pos)
    m, d = 10, 9
    s, y = rng.normal(size=(m, d)), rng.normal(size=(m, d))
    y = y + 2.0 * s  # positive curvature
    rho = 1.0 / np.einsum("md,md->m", s, y)
    g = rng.normal(size=d)
    j = jlbfgs.two_loop_direction(*map(jnp.asarray, (g, s, y, rho)), jnp.int32(count),
                                  jnp.int32(pos))
    t = tlbfgs.two_loop_direction(*map(torch.from_numpy, (g, s, y, rho)),
                                  torch.tensor(count), torch.tensor(pos))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(j)).max())


# -- the replayed single solve ------------------------------------------------


def _stand_in_capture(fn, leaves, structure, device):
    """``loop._capture`` on the CPU: a "graph" whose replay runs ``fn`` on
    the copied inputs and writes its results into the first call's output
    buffers, as a CUDA graph's replay overwrites its own."""
    leaves = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
    args = loop._unflatten(structure, iter(leaves))
    outputs = fn(*args)

    class Graph:
        def replay(self):
            new, old = [], []
            loop._flatten(fn(*args), new)
            loop._flatten(outputs, old)
            for o, n in zip(old, new):
                o.copy_(n)

    return [x for x in leaves if isinstance(x, torch.Tensor)], outputs, Graph()


@pytest.mark.parametrize("variant", ["plain", "box"])
def test_replayed_single_lbfgs_is_the_plain_one(variant, monkeypatch):
    """The single L-BFGS with its bookkeeping replayed from fixed buffers
    (each replay overwrites the last one's outputs) ends bitwise where the
    plain calls do, after as many evaluations, and keeps no buffer of a
    graph in its result: a second solve leaves the first one's intact."""
    d = 7
    x, y, off, wt = _glm(160, d, seed=11, loss="logistic")
    _, tobj = _both_objectives("logistic", "plain", x)
    tb = t_dense_batch(x, y, off, wt)
    box = None
    if variant == "box":
        lo, hi = torch.full((d,), -np.inf, dtype=torch.float64), torch.full((d,), np.inf,
                                                                             dtype=torch.float64)
        lo[0], hi[1] = 0.05, -0.02
        box = (lo, hi)
    config = ttypes.SolverConfig(max_iters=40, tolerance=1e-10)
    calls = collections.Counter()

    def solve(key, w0):
        def vg(w):
            calls[key] += 1
            return tobj.value_and_grad(w, tb)

        return tlbfgs.minimize_lbfgs(vg, w0, config, box=box)

    plain = solve("plain", torch.zeros(d, dtype=torch.float64))
    monkeypatch.setattr(loop, "_replays", lambda t: True)
    monkeypatch.setattr(loop, "_capture", _stand_in_capture)
    monkeypatch.setattr(loop, "_GRAPHS", {})
    replayed = solve("replayed", torch.zeros(d, dtype=torch.float64))
    kept = [t.clone() for t in (replayed.w, replayed.value, replayed.iterations)]
    solve("again", torch.full((d,), 0.3, dtype=torch.float64))
    assert calls["replayed"] == calls["plain"] > 3
    assert len(loop._GRAPHS) == 3  # the direction, a search step, the iteration's end
    for a, b in ((replayed.w, plain.w), (replayed.value, plain.value),
                 (replayed.grad_norm, plain.grad_norm), (replayed.iterations, plain.iterations),
                 (replayed.reason, plain.reason)):
        assert torch.equal(a, b)
    for a, b in zip(kept, (replayed.w, replayed.value, replayed.iterations)):
        assert torch.equal(a, b)
    for a, b in ((replayed.tracker.values, plain.tracker.values),
                 (replayed.tracker.grad_norms, plain.tracker.grad_norms)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
