"""Regression adjustment ("Direct Method"): OLS of Y on covariates + W.

Port of ``ate_replication_causalml_tpu/estimators/ols.py``
(``ate_condmean_ols``, ``ate_functions.R:25-39``): fit ``lm(Y ~ .)`` on
the frame and report the W coefficient and its classical standard
error. The design is [1, X, W] in schema order, as R's formula
expansion lays out a frame [covariates..., W, Y].
"""

from __future__ import annotations

import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.ops.linalg import ols


def _direct_core(x, w, y):
    design = torch.cat([torch.ones_like(x[:, :1]), x, w[:, None]], dim=1)
    fit = ols(design, y)
    return fit.coef[-1], fit.se[-1]


def ate_condmean_ols(frame: CausalFrame, method: str = "Direct Method") -> EstimatorResult:
    tau, se = _direct_core(frame.x, frame.w, frame.y)
    return EstimatorResult.from_point_se(method, tau, se)
