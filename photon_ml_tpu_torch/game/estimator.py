"""GameEstimator: the top-level fit API.

Port of photon_ml_tpu/game/estimator.py along its host-paced path
(``GameEstimator(fused=False)``, the parity target): build the coordinates
on the device once, run coordinate descent per configuration, and warm-start
each configuration from the previous one's model.  Over a grid of
configurations each coordinate's device data is built once: a later
configuration that changes only optimization settings rebinds the previous
coordinate (``Coordinate.rebind``), and one that changes the data layout
builds afresh.  ``best`` picks the grid point with the best primary metric
on the validation data.  ``normalization`` maps a feature shard to the
context that every coordinate on that shard solves under (models come out
in original space).  ``GameTransformer`` scores, predicts and evaluates a
fitted model.  The whole-sweep fused program (``FusedSweep``), locked
coordinates and checkpoints are later slices.
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
    None (one device).  ``fused``: False or "auto" run the host-paced loop
    ("auto" means that loop until the whole-sweep program is ported);
    True, which requires that program, raises."""

    def __init__(self, device: "str | torch.device" = DEFAULT_DEVICE,
                 validation_suite: Optional[EvaluationSuite] = None,
                 dtype=torch.float32,
                 normalization: Optional[Dict[str, NormalizationContext]] = None,
                 mesh=None, fused: "bool | str" = False):
        if mesh is not None:
            raise NotImplementedError(
                "GameEstimator(mesh=...) is not ported yet (ROADMAP.md 'Modules still "
                "to port', item 11, multi-GPU)")
        if fused is True:
            raise NotImplementedError(
                "GameEstimator(fused=True) is not ported yet (ROADMAP.md 'Modules still "
                "to port', item 8, whole-sweep programs); fused=False or 'auto' run the "
                "host-paced loop")
        self.device = resolve_device(device)
        self.validation_suite = validation_suite
        self.dtype = torch_dtype(dtype)
        self.normalization = normalization or {}

    def fit(self, data: GameData, configs: Sequence[GameConfig],
            validation_data: Optional[GameData] = None,
            initial_model: Optional[GameModel] = None,
            locked_coordinates: Optional[Set[str]] = None,
            seed: int = 0, checkpoint_hook=None,
            resume_cursor: Optional[Dict[str, int]] = None,
            resume_best=None) -> List[GameFitResult]:
        """One result per configuration, in order.  ``initial_model``,
        ``locked_coordinates``, ``checkpoint_hook``, ``resume_cursor`` and
        ``resume_best`` take the reference's positions and are refused
        unless None (or empty)."""
        given = [name for name, v in (("initial_model", initial_model),
                                      ("locked_coordinates", locked_coordinates or None),
                                      ("checkpoint_hook", checkpoint_hook),
                                      ("resume_cursor", resume_cursor),
                                      ("resume_best", resume_best)) if v is not None]
        if given:
            raise NotImplementedError(
                f"GameEstimator.fit({', '.join(given)}) is not ported yet (ROADMAP.md "
                "'Modules still to port', item 6, estimator surface)")
        results: List[GameFitResult] = []
        warm: Optional[GameModel] = None
        prev: Dict[str, Coordinate] = {}
        for config in configs:
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
                    coord = build_coordinate(cid, data, ccfg, config.task, seed=seed,
                                             dtype=self.dtype, device=self.device, norm=norm)
                coordinates[cid] = coord
            prev = coordinates
            validation = None
            if validation_data is not None and self.validation_suite is not None:
                validation = (validation_data, self.validation_suite)
            descent = CoordinateDescent(coordinates, order=list(config.coordinates),
                                        num_iterations=config.num_outer_iterations,
                                        validation=validation)
            model, history, ev = descent.run(self.device, initial=warm, seed=seed)
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
