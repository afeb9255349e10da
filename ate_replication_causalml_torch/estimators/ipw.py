"""Inverse-propensity estimators: weighting and weighted regression.

Port of ``ate_replication_causalml_tpu/estimators/ipw.py``:

* ``prop_score_weight`` (``ate_functions.R:44-63``): the
  transformed-outcome IPW, per-row ``tau_i = ((W-p)·Y)/(p(1-p))``, point
  estimate ``mean(tau_i)``; the SE regresses ``tau_i`` on
  ``d = X·(W-p)`` and uses ``sqrt(mean(resid²))/sqrt(N)``;
* ``prop_score_ols`` (``ate_functions.R:67-86``): WLS of ``Y ~ W`` with
  weights ``W/p + (1-W)/(1-p)``; tau and SE from the W coefficient;
* the inline logistic propensity (``ate_replication.Rmd:164-168``):
  ``glm(W ~ X, binomial)`` fitted probabilities, in-sample.
"""

from __future__ import annotations

import math

import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.ops.glm import logistic_glm
from ate_replication_causalml_torch.ops.linalg import add_intercept, ols, wls


def logistic_propensity(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """In-sample logistic propensity p(W=1|X) (``ate_replication.Rmd:164-168``);
    a batch x (B, n, p), w (B, n) fits each lane."""
    return logistic_glm(add_intercept(x), w).fitted


def _psw_core(x, w, y, p):
    """One frame, or each lane of a batch x (B, n, p), w, y and p (B, n)."""
    tau_i = ((w - p) * y) / (p * (1.0 - p))
    d = x * (w - p)[..., None]
    e = ols(add_intercept(d), tau_i).residuals
    se = torch.sqrt(torch.mean(e * e, dim=-1)) / math.sqrt(x.shape[-2])
    return torch.mean(tau_i, dim=-1), se


def prop_score_weight(frame: CausalFrame, p: torch.Tensor,
                      method: str = "Propensity_Weighting") -> EstimatorResult:
    tau, se = _psw_core(frame.x, frame.w, frame.y, torch.as_tensor(p).to(frame.x))
    return EstimatorResult.from_point_se(method, tau, se)


def _psols_core(w, y, p):
    weights = w / p + (1.0 - w) / (1.0 - p)
    design = torch.stack([torch.ones_like(w), w], dim=1)
    fit = wls(design, y, weights)
    return fit.coef[1], fit.se[1]


def prop_score_ols(frame: CausalFrame, p: torch.Tensor,
                   method: str = "Propensity_Regression") -> EstimatorResult:
    tau, se = _psols_core(frame.w, frame.y, torch.as_tensor(p).to(frame.w))
    return EstimatorResult.from_point_se(method, tau, se)
