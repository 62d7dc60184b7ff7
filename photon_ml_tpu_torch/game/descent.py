"""Block coordinate descent over GAME coordinates, paced by the host.

Port of photon_ml_tpu/game/descent.py (``CoordinateDescent``).  Each
coordinate trains against the residual of the others folded into its offsets
(CoordinateDescent.scala:197-204), re-scores, and the total is updated; with
validation, the full model is evaluated after every update and the best full
model by the primary evaluator, compared after complete sweeps only, is kept.
Locked coordinates (partial retraining) are scored from the initial model and
never updated.  A checkpoint hook sees the model after every update with the
cursor of the next one, and a resume skips every update before its cursor.
At DEBUG level each update's solver statistics are logged
(``Coordinate.tracker_summary``), built only then, since they read the
results on the host.

The per-sample score vectors stay on the device in float64.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from photon_ml_tpu_torch.evaluation.evaluator import EvaluationResults, EvaluationSuite
from photon_ml_tpu_torch.game.coordinate import Coordinate
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.scoring import raw_scores
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
    of them (one per bucket), each a number or a tensor over lanes.  The
    most of them, read on the host at this one site an update."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    its = [torch.as_tensor(r.iterations).reshape(-1) for r in results]
    return int(torch.cat(its).max()) if its else 0


class CoordinateDescent:
    """run(): descend over the coordinates in order, ``num_iterations`` times.

    ``validation``: (data, suite), evaluated on the full model after every
    coordinate update.  ``locked``: coordinate ids whose model comes from
    ``initial`` and is only scored, never updated."""

    def __init__(self, coordinates: Dict[str, Coordinate],
                 order: Optional[Sequence[str]] = None, num_iterations: int = 1,
                 validation: Optional[Tuple[GameData, EvaluationSuite]] = None,
                 locked: Optional[Set[str]] = None):
        self.coordinates = coordinates
        self.order = list(order) if order is not None else list(coordinates)
        if set(self.order) != set(coordinates):
            raise ValueError(f"descent order {self.order} != coordinate ids "
                             f"{set(coordinates)}")
        self.num_iterations = num_iterations
        self.validation = validation
        self.locked = locked or set()
        missing = self.locked - set(coordinates)
        if missing:
            raise ValueError(f"locked coordinates not present: {missing}")

    def run(self, device: torch.device, initial: Optional[GameModel] = None,
            seed: int = 0, checkpoint_hook=None,
            resume_cursor: Optional[Dict[str, int]] = None,
            resume_best: Optional[Tuple[GameModel, EvaluationResults]] = None,
            ) -> Tuple[GameModel, DescentHistory, Optional[EvaluationResults]]:
        """``checkpoint_hook(model, cursor, updated=cid, best=(m, ev) | None,
        best_changed=bool)`` is called after every coordinate update with
        the current full model and the cursor of the next update
        ({"iteration": i, "coordinate": k}).  ``resume_cursor`` skips the
        updates before it (``initial`` must then be the checkpointed model);
        ``resume_best`` seeds the best-model tracking."""
        coords = self.coordinates
        n = next(iter(coords.values())).num_samples if coords else 0
        history = DescentHistory()

        # warm-start models (and locked coordinates) are scored from the start
        models: Dict[str, DatumScoringModel] = {}
        scores: Dict[str, torch.Tensor] = {}
        for cid, coord in coords.items():
            if initial is not None and cid in initial:
                models[cid] = initial[cid]
                scores[cid] = coord.score(initial[cid]).double()
            else:
                if cid in self.locked:
                    raise ValueError(f"locked coordinate {cid!r} needs an initial model")
                scores[cid] = torch.zeros(n, dtype=torch.float64, device=device)
        total = torch.zeros(n, dtype=torch.float64, device=device)
        for s in scores.values():
            total = total + s

        best_model: Optional[GameModel] = None
        best_eval: Optional[EvaluationResults] = None
        if resume_best is not None:
            best_model, best_eval = resume_best
        last_eval: Optional[EvaluationResults] = None
        # the update that completes a sweep: the last unlocked one
        active = [k for k, c in enumerate(self.order) if c not in self.locked]
        last_active = active[-1] if active else -1
        resume_at = (None if resume_cursor is None else
                     (resume_cursor.get("iteration", 0), resume_cursor.get("coordinate", 0)))
        for it in range(self.num_iterations):
            for k, cid in enumerate(self.order):
                if cid in self.locked:
                    continue  # its score is already in the total
                if resume_at is not None and (it, k) < resume_at:
                    continue  # done before the checkpoint
                coord = coords[cid]
                t0 = time.perf_counter()
                # residual trick: what the other coordinates explain is an offset
                partial = total - scores[cid]
                offsets = coord.base_offset() + partial
                model, results = coord.update(offsets, seed=seed + it,
                                              init=models.get(cid))
                if logger.isEnabledFor(logging.DEBUG):
                    try:
                        logger.debug("coord %s solvers: %s", cid,
                                     coord.tracker_summary(results))
                    except Exception:  # telemetry never stops training
                        logger.debug("coord %s: tracker summary unavailable", cid,
                                     exc_info=True)
                new_score = coord.score(model)
                models[cid] = model
                scores[cid] = new_score.double()
                total = partial + new_score
                dt = time.perf_counter() - t0

                val_res = None
                best_changed = False
                if self.validation is not None:
                    val_data, suite = self.validation
                    current = GameModel(models=dict(models))
                    val_res = suite.evaluate(raw_scores(current, val_data, device),
                                             val_data.y, val_data.weight,
                                             group_ids=val_data.id_tags)
                    last_eval = val_res
                    # best-model retention compares full models only
                    if k == last_active and suite.better_than(val_res, best_eval):
                        best_eval, best_model = val_res, current
                        best_changed = True
                    logger.info("iter %d coord %s: %s (%.2fs)", it, cid,
                                val_res.values, dt)
                history.add(it, cid, dt, val_res, _solver_iterations(results))
                if checkpoint_hook is not None:
                    nxt = (it, k + 1) if k + 1 < len(self.order) else (it + 1, 0)
                    best = ((best_model, best_eval)
                            if best_model is not None and best_eval is not None else None)
                    checkpoint_hook(GameModel(models=dict(models)),
                                    {"iteration": nxt[0], "coordinate": nxt[1]},
                                    updated=cid, best=best, best_changed=best_changed)

        if best_model is not None:
            return best_model, history, best_eval
        return GameModel(models=models), history, last_eval
