"""evaluation layer of the PyTorch port (see the package docstring)."""

from photon_ml_tpu_torch.evaluation.evaluator import (EvaluationResults,  # noqa: F401
                                                      EvaluationSuite, Evaluator,
                                                      EvaluatorType, grouped_evaluate,
                                                      make_evaluator)
from photon_ml_tpu_torch.evaluation.metrics import (auc_pr, auc_roc,  # noqa: F401
                                                    logistic_loss_metric,
                                                    poisson_loss_metric, precision_at_k,
                                                    rmse, smoothed_hinge_loss_metric,
                                                    squared_loss_metric)
