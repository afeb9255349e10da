"""LASSO-based estimators: single-equation, usual, and LASSO propensity.

Port of ``ate_replication_causalml_tpu/estimators/lasso_est.py``:

* ``ate_condmean_lasso`` (``ate_functions.R:89-108``): gaussian
  ``cv.glmnet`` of Y on [X, W] with **penalty.factor 0 on W** (W never
  shrunk); the ATE is W's coefficient at ``lambda.1se`` (R's
  ``coef(cvfit)`` default). A point estimate with no SE;
* ``ate_lasso`` (``ate_functions.R:111-130``): the same with W penalized
  like every other column;
* ``prop_score_lasso`` (``ate_functions.R:133-146``): binomial-logit
  LASSO of W on X; the **in-sample** fitted probabilities at
  ``lambda.1se``, which the notebook feeds to the IPW estimator as
  "Propensity_Weighting_LASSOPS" (``ate_replication.Rmd:183-188``).

The reference treats the binary outcome as gaussian in both outcome
LASSOs; kept. Each runs on the device of the frame it is given.
"""

from __future__ import annotations

import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.ops.lasso import cv_glmnet, predict_path


def _xw_design(frame: CausalFrame) -> torch.Tensor:
    """[X, W] matrix: covariates in schema order then treatment
    (``ate_functions.R:91-94``)."""
    return torch.cat([frame.x, frame.w[:, None]], dim=1)


def ate_condmean_lasso(
    frame: CausalFrame,
    foldid=None,
    key: torch.Tensor | None = None,
    fold_axis: str | None = None,
    method: str = "Single-equation LASSO",
) -> EstimatorResult:
    x = _xw_design(frame)
    pfac = torch.cat([torch.ones(frame.p, dtype=x.dtype, device=x.device),
                      torch.zeros(1, dtype=x.dtype, device=x.device)])
    cv = cv_glmnet(x, frame.y, family="gaussian", penalty_factor=pfac, foldid=foldid,
                   key=key, fold_axis=fold_axis)
    _, coefs = cv.coef_at("1se")
    return EstimatorResult.point_only(method, coefs[-1])


def ate_lasso(
    frame: CausalFrame,
    foldid=None,
    key: torch.Tensor | None = None,
    fold_axis: str | None = None,
    method: str = "Usual LASSO",
) -> EstimatorResult:
    x = _xw_design(frame)
    cv = cv_glmnet(x, frame.y, family="gaussian", foldid=foldid, key=key, fold_axis=fold_axis)
    _, coefs = cv.coef_at("1se")
    return EstimatorResult.point_only(method, coefs[-1])


def prop_score_lasso(
    frame: CausalFrame, foldid=None, key: torch.Tensor | None = None,
    fold_axis: str | None = None,
) -> torch.Tensor:
    """LASSO-logit propensity vector at lambda.1se, in-sample."""
    cv = cv_glmnet(frame.x, frame.w, family="binomial", foldid=foldid, key=key,
                   fold_axis=fold_axis)
    eta = predict_path(cv.path, frame.x, cv.index_1se)
    return torch.sigmoid(eta)
