"""The whole descent on the device: ``FusedSweep``.

Port of ``FusedSweep`` in photon_ml_tpu/game/fused.py, for fits without
validation.  The host-paced ``CoordinateDescent`` (game/descent.py) copies
every update's model to the host, reads each update's solver iterations
there, and builds its history; a fit with no per-update host work (no
validation, checkpoint hook, locked coordinate or resume) needs none of it.
``FusedSweep.run`` keeps the coordinates' states, the per-sample scores and
the residuals on the device from the first update to the last, through
each coordinate's sweep interface (``Coordinate.trace_update`` and its
kin), and brings the published models to the host once, at the end.  What
is left on the host is the solvers' own loop reads (``opt/loop.while_loop``),
whose bodies replay their bookkeeping as CUDA graphs on the card.  The
reference compiles the whole descent into one XLA program; the stops of the
solvers' loops stay on the host here.

Semantics are the host loop's, bitwise:

- The residual bookkeeping is the host loop's float64 arithmetic in the
  same order (``CoordinateDescent.run``): the total carried across
  iterations, each update's offsets the base offsets plus the total less
  its own score.  The reference's program re-sums the scores each
  iteration.
- A warm start's entities that a random effect does not retrain (left out
  by the lower bound) are scored with every update of it
  (``Coordinate.carry_through_scores``, added to the update's score), as
  the host loop's re-scoring of the merged model counts them, and pass
  through into the published model at the end (``_merge_carry_through``).
  The reference folds their scores into the base offsets instead, which
  rounds its float64 sums differently.
- Down-sampling draws the host loop's masks (``default_rng(seed + it)``
  per iteration, as ``FixedEffectCoordinate.update`` draws them), all of
  them at the start of ``run``, uploaded once.  The reference draws from a
  JAX key folded per (iteration, coordinate), a stream the port does not
  reproduce.
- Variances are computed once, at the last iteration, on that update's
  optimum, offsets and weights, as the reference does; they equal the host
  loop's, which computes them at every update and keeps the last.

``run`` returns the model and the per-coordinate final scores as float64
tensors on the device (the reference returns numpy arrays).  A λ grid
reuses one sweep through ``regs``: the coordinates are rebound to each
point's regularization (``Coordinate.rebind``) over the same device data,
and the solvers' graphs, captured per shape, are replayed, not captured
again.

``run_snapshots`` publishes the model after every outer iteration, and
``run_validated`` runs a fit with a validation suite: after each update it
rescores that coordinate's held-out margin from its published coefficients
on the device (``ValidationPlan``: the held-out inputs, uploaded once) and
records the held-out mean loss; after the sweep the host evaluates the
suite at each iteration's end and keeps the best model by the host loop's
strict-improvement rule.  Its evaluations are bitwise the host loop's: each
held-out score is what the exported model's ``score`` computes, summed from
zero in the order of the host loop's ``GameModel`` as
``game/scoring.raw_scores`` sums it.  The reference keeps a running
held-out total instead (``vtotal - vscores[i] + vm``), whose float64
rounding differs.  The grid forms (``run_grid``, ``run_grid_snapshots``)
are ROADMAP item 8, part (f).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.core.losses import loss_for_task
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.coordinate import (Coordinate, _upload_without_wait,
                                                 merge_carry_through)
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.scoring import additive_total
from photon_ml_tpu_torch.models.game import (FixedEffectModel, GameModel, dense_random_effect,
                                             seed_device_copies)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.types import VarianceComputationType

Tensor = torch.Tensor

PART_F_REFUSAL = ("is not ported yet (ROADMAP.md 'Modules still to port', item 8, part "
                  "(f): the grid forms of FusedSweep)")


class FusedSweep:
    """Block coordinate descent over GAME coordinates with every state on
    the device (module docstring).  Semantics match ``CoordinateDescent.run``
    with no validation: a cold start or an ``initial`` warm start, residual
    offsets, warm starts across outer iterations, the final full model."""

    def __init__(self, coordinates: Dict[str, Coordinate],
                 order: Optional[Sequence[str]] = None, num_iterations: int = 1):
        if not coordinates:
            raise ValueError("FusedSweep needs at least one coordinate")
        self.coordinates = coordinates
        self.order = list(order) if order is not None else list(coordinates)
        # a repeated id would count its score twice in the total
        if len(self.order) != len(coordinates) or set(self.order) != set(coordinates):
            raise ValueError(f"order {self.order} != ids {set(coordinates)}")
        self.num_iterations = num_iterations
        first = coordinates[self.order[0]]
        self._n = first.num_samples
        self._base = first.base_offset()
        self._device = self._base.device
        self._needs_var = [coordinates[cid].config.variance != VarianceComputationType.NONE
                           for cid in self.order]
        self._needs_rand = [getattr(coordinates[cid].config, "down_sampling_rate", 1.0) < 1.0
                            for cid in self.order]
        self._rebound: Dict[tuple, Coordinate] = {}
        self._cold = self._init_carry(None)

    def _bound(self, regs: Optional[Sequence]) -> List[Coordinate]:
        """The coordinates, in order, each under its regularization in
        ``regs`` (None: their own), rebound once per value over the same
        device data."""
        coords = [self.coordinates[cid] for cid in self.order]
        if regs is None:
            return coords
        out = []
        for i, (coord, reg) in enumerate(zip(coords, regs)):
            if reg != coord.config.reg:
                key = (i, reg)
                if key not in self._rebound:
                    self._rebound[key] = coord.rebind(dataclasses.replace(coord.config, reg=reg))
                coord = self._rebound[key]
            out.append(coord)
        return out

    def _sweep_iteration(self, coords: List[Coordinate], states: list, scores: list,
                         total: Tensor, it: int, keys: list, carried: dict,
                         on_update=None):
        """One outer iteration's coordinate loop, the descent's one
        definition (CoordinateDescent.scala:197-204): each coordinate
        trains against the residual of the others folded into its offsets,
        and the total takes its new score.  Returns (states, scores, total,
        offsets): offsets[i] is what coordinate i solved against.
        ``on_update(i, state)`` runs after coordinate i's update (the
        validated sweep's held-out bookkeeping)."""
        offsets = []
        for i, cid in enumerate(self.order):
            partial = total - scores[i]
            offs = self._base + partial
            key = None if keys[i] is None else keys[i][it]
            states[i], new_score = coords[i].trace_update(states[i], offs, key=key,
                                                          carried=carried.get(cid))
            scores[i] = new_score.double()
            total = partial + new_score
            offsets.append(offs)
            if on_update is not None:
                on_update(i, states[i])
        return states, scores, total, offsets

    def _init_carry(self, initial: Optional[GameModel]):
        """(states, scores, total) at the start: each coordinate's state and
        float64 score from ``initial`` (zeros where it has no model), and
        their total summed in the coordinates' order, as the host loop sums
        it."""
        states, scores = {}, {}
        for cid, coord in self.coordinates.items():
            init = initial[cid] if initial is not None and cid in initial else None
            states[cid] = coord.init_sweep_state(init)
            scores[cid] = (torch.zeros(self._n, dtype=torch.float64, device=self._device)
                           if init is None else coord.score(init).double())
        total = torch.zeros(self._n, dtype=torch.float64, device=self._device)
        for s in scores.values():
            total = total + s
        return ([states[cid] for cid in self.order], [scores[cid] for cid in self.order],
                total)

    def init_carry(self, initial: Optional[GameModel]):
        """The starting carry for ``initial``: callers re-running one sweep
        from the same initial model compute it once and pass it to
        ``run(carry0=...)``."""
        return self._cold if initial is None else self._init_carry(initial)

    def _draws(self, seed: int) -> list:
        """Per coordinate, its down-sampling draws of every iteration ([T, n]
        bool on the device, uploaded at once), or None."""
        out = []
        for cid, rand in zip(self.order, self._needs_rand):
            if not rand:
                out.append(None)
                continue
            coord = self.coordinates[cid]
            out.append(_upload_without_wait(np.stack(
                [coord._down_sample_keep(seed + it) for it in range(self.num_iterations)]),
                self._device))
        return out

    def _start(self, initial: Optional[GameModel], regs: Optional[Sequence], seed: int,
               carry0):
        """(coordinates, states, scores, total, carried scores, draws) at a
        descent's start."""
        coords = self._bound(regs)
        states, scores, total = carry0 if carry0 is not None else self.init_carry(initial)
        _, carried = self._base_with_carry_through(initial)
        return coords, list(states), list(scores), total, carried, self._draws(seed)

    def run_device(self, initial: Optional[GameModel] = None,
                   regs: Optional[Sequence] = None, seed: int = 0, carry0=None):
        """One descent, its outputs on the device: (published coefficients,
        float64 scores and variances (None where not computed), one each per
        coordinate in order, and the carried scores by coordinate).  Nothing
        is brought to the host."""
        coords, states, scores, total, carried, keys = self._start(initial, regs, seed,
                                                                   carry0)
        variances: List[Optional[Tensor]] = [None] * len(self.order)
        for it in range(self.num_iterations):
            states, scores, total, offsets = self._sweep_iteration(
                coords, states, scores, total, it, keys, carried)
        if self.num_iterations > 0:
            last = self.num_iterations - 1
            for i, needs in enumerate(self._needs_var):
                if needs:
                    variances[i] = coords[i].trace_variances(
                        states[i], offsets[i], key=None if keys[i] is None else keys[i][last])
        published = [coords[i].trace_publish(s) for i, s in enumerate(states)]
        return published, scores, variances, carried

    def run(self, initial: Optional[GameModel] = None, regs: Optional[Sequence] = None,
            seed: int = 0, carry0=None) -> Tuple[GameModel, Dict[str, Tensor]]:
        """One descent: (the model, each coordinate's final scores as a
        float64 tensor on the device).  ``regs``: per-coordinate
        regularizations in order (a λ grid's points over one sweep).
        ``seed``: the down-sampling draws' seed, ``seed + iteration`` for
        each iteration.  ``carry0``: an ``init_carry`` result, in place of
        ``initial``'s.  The published coefficients and variances come to
        the host in one copy."""
        published, scores, variances, _ = self.run_device(initial, regs, seed, carry0)
        host = _to_host(published + [v for v in variances if v is not None])
        host_vars = iter(host[len(published):])
        model = self._export(published, host, initial, self.order,
                             [next(host_vars) if v is not None else None for v in variances])
        return model, {cid: scores[i] for i, cid in enumerate(self.order)}

    def _export(self, published: List[Tensor], host: List[np.ndarray],
                initial: Optional[GameModel], order: Sequence[str],
                variances: Optional[list] = None) -> GameModel:
        """The GameModel of one publication: each coordinate's host array
        exported (its device copy kept for scoring), the variances
        attached, the warm start's carried entities merged, the models in
        ``order``."""
        models = {cid: self.coordinates[cid].export_model(host[i])
                  for i, cid in enumerate(self.order)}
        if variances is not None:
            models = self._attach_variances(models, variances)
        for i, cid in enumerate(self.order):
            m = models[cid]
            arr = m.coefficients.means if isinstance(m, FixedEffectModel) else m.w_stack
            seed_device_copies(m, (arr,), (published[i],))
        models = self._merge_carry_through(models, initial)
        return GameModel(models={cid: models[cid] for cid in order})

    def _base_with_carry_through(self, initial: Optional[GameModel]):
        """(the base offsets [n], float64, and per coordinate the scores of
        the warm start's entities it does not retrain, at its compute dtype,
        None where nothing is carried).  Each update of that coordinate
        adds them to its score, as the host loop's re-scoring of the merged
        model does; the reference adds them to the base offsets instead."""
        carried = {}
        if initial is not None:
            for cid in self.order:
                if cid in initial:
                    c = self.coordinates[cid].carry_through_scores(initial[cid])
                    if c is not None:
                        carried[cid] = c
        return self._base, carried

    def _merge_carry_through(self, models: dict, initial: Optional[GameModel]) -> dict:
        """The warm start's entities that no update retrained pass through
        into the published models, as the host loop merges them
        (``game/coordinate.merge_carry_through``)."""
        if initial is None:
            return models
        out = {}
        for cid, m in models.items():
            init = initial[cid] if cid in initial else None
            if init is not None and not isinstance(m, FixedEffectModel):
                m = merge_carry_through(m, dense_random_effect(init))
            out[cid] = m
        return out

    def _attach_variances(self, models: dict, variances: list) -> dict:
        """The last update's variances, on the host, attached to the
        exported models."""
        out = dict(models)
        for i, cid in enumerate(self.order):
            v = variances[i]
            if v is None:
                continue
            m = out[cid]
            if isinstance(m, FixedEffectModel):
                out[cid] = dataclasses.replace(
                    m, coefficients=Coefficients(means=m.coefficients.means, variances=v))
            else:
                out[cid] = dataclasses.replace(m, variances=v)
        return out

    # -- the validated form and the snapshots

    def validation_plan(self, data: GameData, suite: EvaluationSuite) -> "ValidationPlan":
        """The held-out inputs of ``run_validated`` for ``data`` and
        ``suite``, built once; NotImplementedError for a coordinate without
        external scoring (the estimator then runs the host loop)."""
        return ValidationPlan(self, data, suite)

    def _host_order(self, initial: Optional[GameModel]) -> List[str]:
        """The order of the host loop's GameModel: the warm-started
        coordinates as the coordinates are given, then the others as they
        are first updated."""
        first = [cid for cid in self.coordinates if initial is not None and cid in initial]
        return first + [cid for cid in self.order if cid not in first]

    def run_snapshots(self, initial: Optional[GameModel] = None,
                      regs: Optional[Sequence] = None, seed: int = 0,
                      carry0=None) -> List[GameModel]:
        """One descent, the full model after every outer iteration: snapshot
        t is the host loop's fit of t + 1 iterations.  Every published array
        comes to the host in one copy at the end."""
        if any(self._needs_var):
            raise NotImplementedError(
                "run_snapshots does not compute coefficient variances; use "
                "run() (final model only) or the host CoordinateDescent")
        coords, states, scores, total, carried, keys = self._start(initial, regs, seed,
                                                                   carry0)
        pubs = []
        for it in range(self.num_iterations):
            states, scores, total, _ = self._sweep_iteration(coords, states, scores, total,
                                                             it, keys, carried)
            pubs.append([coords[i].trace_publish(st) for i, st in enumerate(states)])
        host = _to_host([p for ps in pubs for p in ps])
        c, order = len(self.order), self._host_order(initial)
        return [self._export(ps, host[t * c:(t + 1) * c], initial, order)
                for t, ps in enumerate(pubs)]

    def run_validated(self, plan: "ValidationPlan", initial: Optional[GameModel] = None,
                      regs: Optional[Sequence] = None, seed: int = 0, carry0=None
                      ) -> Tuple[GameModel, List[EvaluationResults],
                                 Optional[EvaluationResults], Tensor]:
        """One descent with the validation suite of ``plan``: (the best
        model, the evaluation at each outer iteration's end, the best's
        evaluation, the held-out mean losses [T, C]).

        After every update the coordinate's held-out margin is rescored from
        its published coefficients and the weighted held-out mean loss
        recorded, on the device; ``losses`` is a float64 tensor there (the
        reference returns numpy).  After the sweep the suite evaluates each
        iteration's end and the best is kept by the host loop's
        strict-improvement rule in iteration order; only its model comes to
        the host, in one copy.  Variances are refused, as the reference
        refuses them (the estimator then runs the host loop)."""
        if any(self._needs_var):
            raise NotImplementedError(
                "run_validated does not compute coefficient variances; use "
                "the host CoordinateDescent for variance-computing validated "
                "fits")
        coords, states, scores, total, carried, keys = self._start(initial, regs, seed,
                                                                   carry0)
        margins, carried_on = plan.initial_state(initial)
        order = self._host_order(initial)
        at = [self.order.index(cid) for cid in order]
        losses, ends, pubs = [], [], []

        def on_update(i, state):
            m = coords[i].trace_score_external(coords[i].trace_publish(state), plan.datas[i])
            if carried_on[i] is not None:  # one side of each sample's sum is 0
                m = m + carried_on[i]
            margins[i] = m
            losses.append(plan.mean_loss(plan.raw([margins[j] for j in at])))

        for it in range(self.num_iterations):
            states, scores, total, _ = self._sweep_iteration(
                coords, states, scores, total, it, keys, carried, on_update=on_update)
            ends.append([margins[j] for j in at])
            pubs.append([coords[i].trace_publish(st) for i, st in enumerate(states)])
        evals, best_t, best_ev = [], 0, None
        for t, end in enumerate(ends):
            ev = plan.suite.evaluate(plan.raw(end), plan.data.y, plan.data.weight,
                                     group_ids=plan.data.id_tags)
            evals.append(ev)
            if plan.suite.better_than(ev, best_ev):
                best_ev, best_t = ev, t
        model = self._export(pubs[best_t], _to_host(pubs[best_t]), initial, order)
        return (model, evals, best_ev,
                torch.stack(losses).reshape(self.num_iterations, len(self.order)))

    def run_grid(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.run_grid " + PART_F_REFUSAL)

    def run_grid_snapshots(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.run_grid_snapshots " + PART_F_REFUSAL)


def _to_host(tensors: List[Tensor]) -> List[np.ndarray]:
    """Tensors of one dtype on the host, in one copy, each its own array."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


class ValidationPlan:
    """The held-out inputs of ``FusedSweep.run_validated``, built once per
    (sweep, held-out data, suite): each coordinate's ``external_data`` on
    the device, the offsets, labels and weights there, and the data and
    suite that the host evaluation reads."""

    def __init__(self, sweep: FusedSweep, data: GameData, suite: EvaluationSuite):
        self.sweep, self.data, self.suite = sweep, data, suite
        self.n = data.num_samples
        dev = sweep._device
        # NotImplementedError for a coordinate without external scoring
        self.datas = [sweep.coordinates[cid].external_data(data) for cid in sweep.order]
        self.loss = loss_for_task(sweep.coordinates[sweep.order[0]].task)
        # the offsets as raw_scores adds them; labels and weights in float64
        self.offset = torch.as_tensor(data.offset, device=dev)
        self.y = torch.as_tensor(np.asarray(data.y), dtype=torch.float64, device=dev)
        self.weight = torch.as_tensor(np.asarray(data.weight), dtype=torch.float64,
                                      device=dev)
        self.weight_sum = torch.clamp(self.weight.sum(), min=1e-30)

    @property
    def device_bytes(self) -> int:
        """The bytes the plan holds on the device (tensors it shares with
        the data included)."""
        tensors = [self.offset, self.y, self.weight]
        tensors += [t for d in self.datas for t in d.values()]
        return sum(t.numel() * t.element_size() for t in tensors)

    def initial_state(self, initial: Optional[GameModel]):
        """(each coordinate's held-out margin at the start: the warm start's
        score, None where it has none; each coordinate's carried scores on
        the held-out rows, or None), in the sweep's order."""
        margins, carried = [], []
        for cid, vdata in zip(self.sweep.order, self.datas):
            coord = self.sweep.coordinates[cid]
            init = initial[cid] if initial is not None and cid in initial else None
            margins.append(None if init is None else coord.score_external(init, vdata,
                                                                          self.data))
            carried.append(coord.carry_through_scores_on(init, self.data))
        return margins, carried

    def raw(self, margins: Sequence[Optional[Tensor]]) -> Tensor:
        """The held-out raw scores of ``margins`` (in the host loop's model
        order; None for a coordinate not yet in its model), composed as
        ``game/scoring.raw_scores`` composes them."""
        total = additive_total(self.n, (m for m in margins if m is not None),
                               device=self.offset.device)
        return total + self.offset

    def mean_loss(self, raw: Tensor) -> Tensor:
        """The weighted held-out mean loss of ``raw``, a 0-d float64 tensor."""
        return (self.weight * self.loss.loss(raw, self.y)).sum() / self.weight_sum
