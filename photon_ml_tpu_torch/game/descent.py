"""Block coordinate descent over GAME coordinates, paced by the host.

Port of photon_ml_tpu/game/descent.py (``CoordinateDescent`` without locked
coordinates, checkpoints or resume).  Each coordinate trains against the
residual of the others folded into its offsets (CoordinateDescent.scala:
197-204), re-scores, and the total is updated; with validation, the full
model is evaluated after every update and the best full model by the primary
evaluator, compared after complete sweeps only, is kept.

The per-sample score vectors stay on the device in float64.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.evaluation.evaluator import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.coordinate import Coordinate
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.models.game import DatumScoringModel, GameModel

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DescentHistory:
    """Per-update record: iteration, coordinate, seconds, solver iterations
    (the most any lane took, for a random effect) and validation."""

    steps: List[dict] = dataclasses.field(default_factory=list)

    def add(self, iteration: int, coordinate_id: str, seconds: float,
            validation: Optional[EvaluationResults], solver_iterations: int = 0) -> None:
        self.steps.append(dict(iteration=iteration, coordinate=coordinate_id,
                               seconds=seconds, validation=validation,
                               solver_iterations=solver_iterations))


def _solver_iterations(results) -> int:
    """Iterations of one update's solver results: a SolverResult or a list
    of them (one per bucket), each an int or a tensor over lanes."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    return max((int(torch.as_tensor(r.iterations).max()) for r in results), default=0)


class CoordinateDescent:
    """run(): descend over the coordinates in order, ``num_iterations`` times.

    ``validation``: (data, suite), evaluated on the full model after every
    coordinate update."""

    def __init__(self, coordinates: Dict[str, Coordinate],
                 order: Optional[Sequence[str]] = None, num_iterations: int = 1,
                 validation: Optional[Tuple[GameData, EvaluationSuite]] = None):
        self.coordinates = coordinates
        self.order = list(order) if order is not None else list(coordinates)
        if set(self.order) != set(coordinates):
            raise ValueError(f"descent order {self.order} != coordinate ids "
                             f"{set(coordinates)}")
        self.num_iterations = num_iterations
        self.validation = validation

    def run(self, device: torch.device, initial: Optional[GameModel] = None,
            seed: int = 0) -> Tuple[GameModel, DescentHistory, Optional[EvaluationResults]]:
        coords = self.coordinates
        n = next(iter(coords.values())).num_samples if coords else 0
        history = DescentHistory()

        models: Dict[str, DatumScoringModel] = {}
        scores: Dict[str, torch.Tensor] = {}
        for cid, coord in coords.items():
            if initial is not None and cid in initial:
                models[cid] = initial[cid]
                scores[cid] = coord.score(initial[cid]).double()
            else:
                scores[cid] = torch.zeros(n, dtype=torch.float64, device=device)
        total = torch.zeros(n, dtype=torch.float64, device=device)
        for s in scores.values():
            total = total + s

        best_model: Optional[GameModel] = None
        best_eval: Optional[EvaluationResults] = None
        last_eval: Optional[EvaluationResults] = None
        last = len(self.order) - 1
        for it in range(self.num_iterations):
            for k, cid in enumerate(self.order):
                coord = coords[cid]
                t0 = time.perf_counter()
                # residual trick: what the other coordinates explain is an offset
                partial = total - scores[cid]
                offsets = coord.base_offset() + partial
                model, results = coord.update(offsets, seed=seed + it,
                                              init=models.get(cid))
                new_score = coord.score(model)
                models[cid] = model
                scores[cid] = new_score.double()
                total = partial + new_score
                dt = time.perf_counter() - t0

                val_res = None
                if self.validation is not None:
                    val_data, suite = self.validation
                    current = GameModel(models=dict(models))
                    val_scores = current.score(val_data, device) + torch.as_tensor(
                        val_data.offset, device=device)
                    val_res = suite.evaluate(val_scores, val_data.y, val_data.weight)
                    last_eval = val_res
                    # best-model retention compares full models only
                    if k == last and suite.better_than(val_res, best_eval):
                        best_eval, best_model = val_res, current
                    logger.info("iter %d coord %s: %s (%.2fs)", it, cid,
                                val_res.values, dt)
                history.add(it, cid, dt, val_res, _solver_iterations(results))

        if best_model is not None:
            return best_model, history, best_eval
        return GameModel(models=models), history, last_eval
