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
again.  The validated and grid forms (``run_validated``, ``run_grid``,
``run_snapshots``, ``run_grid_snapshots``) are ROADMAP item 8, part (d).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.game.coordinate import (Coordinate, _upload_without_wait,
                                                 merge_carry_through)
from photon_ml_tpu_torch.models.game import (FixedEffectModel, GameModel, dense_random_effect,
                                             seed_device_copies)
from photon_ml_tpu_torch.models.glm import Coefficients
from photon_ml_tpu_torch.types import VarianceComputationType

Tensor = torch.Tensor

PART_D_REFUSAL = ("is not ported yet (ROADMAP.md 'Modules still to port', item 8, part "
                  "(d): the validated and grid forms of FusedSweep)")


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
                         total: Tensor, it: int, keys: list, carried: dict):
        """One outer iteration's coordinate loop, the descent's one
        definition (CoordinateDescent.scala:197-204): each coordinate
        trains against the residual of the others folded into its offsets,
        and the total takes its new score.  Returns (states, scores, total,
        offsets): offsets[i] is what coordinate i solved against."""
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

    def run_device(self, initial: Optional[GameModel] = None,
                   regs: Optional[Sequence] = None, seed: int = 0, carry0=None):
        """One descent, its outputs on the device: (published coefficients,
        float64 scores and variances (None where not computed), one each per
        coordinate in order, and the carried scores by coordinate).  Nothing
        is brought to the host."""
        coords = self._bound(regs)
        states, scores, total = carry0 if carry0 is not None else self.init_carry(initial)
        states, scores = list(states), list(scores)
        _, carried = self._base_with_carry_through(initial)
        keys = self._draws(seed)
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
        parts = published + [v for v in variances if v is not None]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        host, at = [], 0
        for p in parts:
            host.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        models = {cid: self.coordinates[cid].export_model(host[i])
                  for i, cid in enumerate(self.order)}
        host_vars = iter(host[len(published):])
        models = self._attach_variances(
            models, [next(host_vars) if v is not None else None for v in variances])
        for i, cid in enumerate(self.order):
            # the published arrays keep their device copies for scoring
            m = models[cid]
            arr = m.coefficients.means if isinstance(m, FixedEffectModel) else m.w_stack
            seed_device_copies(m, (arr,), (published[i],))
        models = self._merge_carry_through(models, initial)
        return (GameModel(models=models),
                {cid: scores[i] for i, cid in enumerate(self.order)})

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

    def run_snapshots(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.run_snapshots " + PART_D_REFUSAL)

    def run_grid(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.run_grid " + PART_D_REFUSAL)

    def run_grid_snapshots(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.run_grid_snapshots " + PART_D_REFUSAL)

    def run_validated(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.run_validated " + PART_D_REFUSAL)

    def validation_plan(self, *args, **kwargs):
        raise NotImplementedError("FusedSweep.validation_plan " + PART_D_REFUSAL)
