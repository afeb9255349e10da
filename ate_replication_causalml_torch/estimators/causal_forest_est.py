"""Causal-forest ATE estimator — the reference's estimator #15, written
inline in the notebook (``ate_replication.Rmd:249-272``).

Port of ``ate_replication_causalml_tpu/estimators/causal_forest_est.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.models.causal_forest import (
    average_treatment_effect,
    fit_causal_forest,
    incorrect_forest_ate,
    predict_cate,
    stage,
)


class CausalForestReport(NamedTuple):
    """Both outputs of the notebook's causal-forest chunk: the
    deliberately "incorrect" mean-of-CATEs ATE/SE it prints
    (``Rmd:258-262``) and the doubly-robust result row."""

    result: EstimatorResult
    incorrect_ate: float
    incorrect_se: float


def causal_forest_ate(
    frame: CausalFrame,
    key: torch.Tensor | None = None,
    n_trees: int = 2000,
    method_name: str = "Causal Forest(GRF)",
    **fit_kwargs,
) -> EstimatorResult:
    """Honest causal forest → doubly-robust ATE
    (``grf::estimate_average_effect``, ``ate_replication.Rmd:265-270``)."""
    fitted = fit_causal_forest(frame, key=key, n_trees=n_trees, **fit_kwargs)
    eff = average_treatment_effect(fitted)
    return EstimatorResult.from_point_se(method_name, float(eff.estimate), float(eff.std_err))


def causal_forest_report(
    frame: CausalFrame,
    key: torch.Tensor | None = None,
    n_trees: int = 2000,
    method_name: str = "Causal Forest(GRF)",
    variance_compat: str = "unbiased",
    stage_times: dict | None = None,
    **fit_kwargs,
) -> CausalForestReport:
    """One fit, both outputs of the notebook chunk, sharing the fitted
    forest and its CATE predictions. ``variance_compat`` as in
    :func:`~..models.causal_forest.predict_cate`. ``stage_times``, when
    given, receives the wall seconds of each stage: "nuisance",
    "causal_grow", "predict_cate" and "aipw"."""
    fitted = fit_causal_forest(frame, key=key, n_trees=n_trees, stage_times=stage_times,
                               **fit_kwargs)
    with stage(stage_times, "predict_cate", frame.device):
        cate = predict_cate(fitted.forest, fitted.x, oob=True, variance_compat=variance_compat)
    with stage(stage_times, "aipw", frame.device):
        ate_bad, se_bad = incorrect_forest_ate(cate)
        eff = average_treatment_effect(fitted, cate=cate)
    return CausalForestReport(
        result=EstimatorResult.from_point_se(method_name, float(eff.estimate),
                                             float(eff.std_err)),
        incorrect_ate=float(ate_bad),
        incorrect_se=float(se_bad),
    )
