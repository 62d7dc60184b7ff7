"""GameEstimator: the top-level fit API.

Port of photon_ml_tpu/game/estimator.py: build the coordinates on the
device once, run coordinate descent per configuration, and warm-start each
configuration from the previous one's model.  ``fused`` picks the descent
as the reference does (``photon_ml_tpu/game/estimator.py:146-215``): by
default (``"auto"``) a configuration with no per-update host work (no
checkpoint hook, locked coordinate or resume) runs as one
``game/fused.FusedSweep`` (``run``, or ``run_validated`` with a validation
suite) whose result carries an empty ``DescentHistory``, and one that has
such work runs the host-paced ``CoordinateDescent``; ``False`` always runs
the host loop, and ``True`` requires the sweep (ValueError on per-update
host work).  As in the reference, a sweep that raises NotImplementedError
(a validated fit with variances, a coordinate without the sweep or the
external-scoring interface) runs the host loop instead, except under
``True`` without a suite, which raises.  Consecutive
configurations whose coordinates differ only in regularization values
reuse one sweep (``Coordinate.sweep_key``), and its ``ValidationPlan`` while
the held-out data is the same object; one that crosses the L1 regime
builds another.  Over a grid of
configurations each coordinate's device data is built once: a later
configuration that changes only optimization settings rebinds the previous
coordinate (``Coordinate.rebind``), and one that changes the data layout
builds afresh.  ``best`` picks the grid point with the best primary metric
on the validation data.  ``normalization`` maps a feature shard to the
context that every coordinate on that shard solves under (models come out
in original space).  ``initial_model`` warm-starts the first
configuration, and its random-effect entity ids feed the lower bound
(an under-bound entity the prior covers keeps its model); locked coordinates
keep their initial model and are only scored; a checkpoint hook sees every
update with its cursor, and a resume skips the work before the cursor.
``GameTransformer`` scores, predicts and evaluates a fitted model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

import torch

from photon_ml_tpu_torch.core.normalization import NormalizationContext
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype
from photon_ml_tpu_torch.evaluation.evaluator import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.config import GameConfig
from photon_ml_tpu_torch.game.coordinate import Coordinate, build_coordinate
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.descent import CoordinateDescent, DescentHistory
from photon_ml_tpu_torch.game.fused import FusedSweep
from photon_ml_tpu_torch.game.scoring import raw_scores
from photon_ml_tpu_torch.models.game import GameModel
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(eq=False)
class GameFitResult:
    """One (configuration, model, validation) outcome."""

    model: GameModel
    config: GameConfig
    evaluation: Optional[EvaluationResults]
    history: DescentHistory


class GameEstimator:
    """fit() over one or more GAME configurations, warm-starting each from
    the previous one.

    ``device``: where the coordinates live and train; the default ``"cuda"``
    raises when no card is present.  ``dtype``: compute precision
    (float32 on the card; float64 for reference-precision runs).
    ``normalization``: feature shard -> ``NormalizationContext``, applied to
    every coordinate on that shard, fixed and random alike.  ``mesh``: only
    None (one device).  ``fused``: "auto" (the default), True or False
    (module docstring)."""

    def __init__(self, device: "str | torch.device" = DEFAULT_DEVICE,
                 validation_suite: Optional[EvaluationSuite] = None,
                 dtype=torch.float32,
                 normalization: Optional[Dict[str, NormalizationContext]] = None,
                 mesh=None, fused: "bool | str" = "auto"):
        if mesh is not None:
            raise NotImplementedError(
                "GameEstimator(mesh=...) is not ported yet (ROADMAP.md 'Modules still "
                "to port', item 11, multi-GPU)")
        self.fused = fused
        self.device = resolve_device(device)
        self.validation_suite = validation_suite
        self.dtype = torch_dtype(dtype)
        self.normalization = normalization or {}

    def build_one_coordinate(self, cid: str, data: GameData, ccfg, task: TaskType,
                             seed: int = 0, initial_model: Optional[GameModel] = None
                             ) -> Coordinate:
        """The one construction call for a coordinate under this estimator's
        device, dtype and normalization.  ``initial_model``: the entity ids
        of its model for ``cid`` (dense or compact) feed a random effect's
        lower bound (RandomEffectDataset.scala:322-333)."""
        keys = None
        if initial_model is not None and cid in initial_model:
            m = initial_model[cid]
            if hasattr(m, "slot_of"):
                keys = frozenset(m.slot_of)
        return build_coordinate(cid, data, ccfg, task, seed=seed, dtype=self.dtype,
                                device=self.device,
                                norm=self.normalization.get(ccfg.feature_shard),
                                existing_model_keys=keys)

    def fit(self, data: GameData, configs: Sequence[GameConfig],
            validation_data: Optional[GameData] = None,
            initial_model: Optional[GameModel] = None,
            locked_coordinates: Optional[Set[str]] = None,
            seed: int = 0, checkpoint_hook=None,
            resume_cursor: Optional[Dict[str, int]] = None,
            resume_best=None) -> List[GameFitResult]:
        """One result per configuration, in order.

        ``initial_model`` warm-starts the first configuration.
        ``locked_coordinates`` keep their model from ``initial_model`` and
        are only scored.  ``checkpoint_hook(model, cursor, updated=cid,
        best=(model, evaluation) | None, best_changed=bool)`` fires after
        every coordinate update with the cursor {"config": ci, "iteration":
        i, "coordinate": k} of the next update; each configuration's first
        save has ``updated=None`` (a full snapshot).  ``resume_cursor``
        skips the work before it (``initial_model`` must then be the
        checkpointed model, and the configurations before the cursor's are
        left out of the results); ``resume_best`` seeds the best-model
        tracking of the configuration resumed."""
        results: List[GameFitResult] = []
        prev_sweep = None  # (sweep key, FusedSweep)
        prev_plan = None  # (sweep, validation data, ValidationPlan)
        warm = initial_model
        # only a warm start feeds the lower bound: on a resume, initial_model
        # is the checkpoint, and an under-bound entity that the run left out
        # of it must stay out, not train as a new one
        prior_for_bounds = initial_model if resume_cursor is None else None
        prev: Dict[str, Coordinate] = {}
        for ci, config in enumerate(configs):
            if resume_cursor is not None and ci < resume_cursor.get("config", 0):
                continue
            coordinates = {}
            for cid, ccfg in config.coordinates.items():
                norm = self.normalization.get(ccfg.feature_shard)
                old = prev.get(cid)
                coord = None
                if old is not None and old.task == config.task and old.norm_source is norm:
                    if old.config == ccfg:
                        coord = old  # same data layout, solver and context: reuse
                    else:
                        try:
                            coord = old.rebind(ccfg)  # same data, new settings
                        except ValueError:
                            pass  # another data layout: build afresh
                if coord is None:
                    coord = self.build_one_coordinate(cid, data, ccfg, config.task, seed,
                                                      initial_model=prior_for_bounds)
                coordinates[cid] = coord
            prev = coordinates
            validation = None
            if validation_data is not None and self.validation_suite is not None:
                validation = (validation_data, self.validation_suite)
            # per-update host work keeps the host-paced loop
            fused_ok = (self.fused is not False and checkpoint_hook is None
                        and not locked_coordinates and resume_cursor is None)
            if fused_ok:
                fitted = None
                try:
                    # regularization values are a run's inputs: a λ grid over
                    # the same data and solvers reuses one sweep
                    key = (tuple((cid, coordinates[cid].sweep_key())
                                 for cid in config.coordinates), config.num_outer_iterations)
                    if prev_sweep is None or prev_sweep[0] != key:
                        prev_sweep = (key, FusedSweep(
                            coordinates, order=list(config.coordinates),
                            num_iterations=config.num_outer_iterations))
                    sweep = prev_sweep[1]
                    regs = [coordinates[cid].config.reg for cid in config.coordinates]
                    if validation is None:
                        model, _ = sweep.run(initial=warm, regs=regs, seed=seed)
                        fitted = (model, None)
                    else:
                        # the held-out inputs go to the device once a sweep
                        if (prev_plan is None or prev_plan[0] is not sweep
                                or prev_plan[1] is not validation_data):
                            prev_plan = (sweep, validation_data, sweep.validation_plan(
                                validation_data, self.validation_suite))
                        model, _, best_ev, _ = sweep.run_validated(
                            prev_plan[2], initial=warm, regs=regs, seed=seed)
                        fitted = (model, best_ev)
                except NotImplementedError:
                    # a validated fit with variances, or a coordinate without
                    # the sweep or external-scoring interface: the host loop
                    if self.fused is True and validation is None:
                        raise
                if fitted is not None:
                    model, ev = fitted
                    results.append(GameFitResult(model=model, config=config, evaluation=ev,
                                                 history=DescentHistory()))
                    warm = model
                    continue
            elif self.fused is True:
                raise ValueError("fused=True needs a fit with no per-update host work "
                                 "(no checkpoint hook, locked coordinates, or resume)")
            descent = CoordinateDescent(coordinates, order=list(config.coordinates),
                                        num_iterations=config.num_outer_iterations,
                                        validation=validation, locked=locked_coordinates)
            hook = None
            if checkpoint_hook is not None:
                first_save = [True]

                def hook(m, cur, ci=ci, first_save=first_save, **kw):
                    # each configuration's first save is a full snapshot: its
                    # warm start may differ from the previous save's model
                    if first_save[0]:
                        kw["updated"] = None
                        first_save[0] = False
                    checkpoint_hook(m, {**cur, "config": ci}, **kw)
            resuming_here = (resume_cursor is not None
                             and ci == resume_cursor.get("config", 0))
            model, history, ev = descent.run(
                self.device, initial=warm, seed=seed, checkpoint_hook=hook,
                resume_cursor=resume_cursor if resuming_here else None,
                resume_best=resume_best if resuming_here else None)
            results.append(GameFitResult(model=model, config=config, evaluation=ev,
                                         history=history))
            warm = model
        return results

    def best(self, results: List[GameFitResult]) -> GameFitResult:
        """The result with the best primary validation metric, the first
        among equals (as photon_ml_tpu/game/estimator.py:246-258);
        the last result when there is no suite or no evaluation."""
        if self.validation_suite is None or all(r.evaluation is None for r in results):
            return results[-1]
        best = None
        for r in results:
            if r.evaluation is None:
                continue
            if best is None or self.validation_suite.primary.better_than(
                    r.evaluation.primary, best.evaluation.primary):
                best = r
        return best


class GameTransformer:
    """Score and evaluate a GameData with a trained GameModel on
    ``device`` (default the card).  Scores are float64 tensors on that
    device; the reference returns numpy arrays."""

    def __init__(self, model: GameModel, task: TaskType,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        self.model = model
        self.task = task
        self.device = resolve_device(device)

    def score(self, data: GameData) -> torch.Tensor:
        """Raw total scores (no offset)."""
        return self.model.score(data, self.device)

    def predict(self, data: GameData) -> torch.Tensor:
        return self.model.predict(data, self.task, self.device)

    def evaluate(self, data: GameData, suite: EvaluationSuite) -> EvaluationResults:
        return suite.evaluate(raw_scores(self.model, data, self.device), data.y,
                              data.weight, group_ids=data.id_tags)
