"""Approximate residual balancing (Athey–Imbens–Wager).

Port of ``ate_replication_causalml_tpu/estimators/balance.py``, the
equivalent of ``balanceHD::residualBalance.ate`` as the reference's
``residual_balance_ATE`` calls it (``ate_functions.R:393-405``,
``ate_replication.Rmd:240-243``). Per arm: balancing weights γ over the
arm's rows toward the population covariate mean (the float64 ADMM of
``ops/qp.py``), an elastic-net outcome regression on the arm (α = 0.9,
λ by 10-fold CV), and

    mu_hat(arm) = target . beta_hat + sum_i gamma_i * (Y_i - X_i . beta_hat);

tau_hat = mu_hat(treated) - mu_hat(control), SE the plug-in
sqrt(sum_arm sigma2_arm * sum(gamma_arm^2)). Runs on the device of the
frame it is given; each arm's CV fit is one ``cd_path`` launch on the
card.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.lasso import cv_glmnet, predict_path
from ate_replication_causalml_torch.ops.qp import balance_qp_x64


def approx_balance(
    x: torch.Tensor,
    target: torch.Tensor,
    zeta: float = 0.5,
    ub: float = math.inf,
    max_iters: int = 4000,
) -> torch.Tensor:
    """Balancing weights over rows of ``x`` toward covariate mean ``target``
    (balanceHD ``approx.balance``): argmin zeta*||g||^2 +
    (1-zeta)*||X^T g - target||_inf^2 over the (capped) simplex, solved in
    float64 and returned as float32."""
    return approx_balance_sol(x, target, zeta=zeta, ub=ub, max_iters=max_iters)[0]


def approx_balance_sol(x, target, zeta=0.5, ub=math.inf, max_iters=4000):
    """(gamma_f32, worst_resid, iters) from the float64 balance QP;
    ``worst_resid`` is max(primal, dual), the quantity the stopping rule
    tests."""
    qp = balance_qp_x64(x, target, zeta=zeta, ub=float(ub), max_iters=max_iters)
    worst = torch.maximum(qp.primal_resid, qp.dual_resid)
    return qp.gamma.to(torch.float32), worst, qp.iters


def _arm_mu_var(x_arm, y_arm, target, key, gamma):
    """One arm's counterfactual mean and variance contribution, given its
    balancing weights: the elastic-net outcome regression (α = 0.9, λ at
    CV's minimum) predicted at ``target``, plus the weighted residuals."""
    cv = cv_glmnet(x_arm, y_arm, family="gaussian", alpha=0.9, key=key)
    idx = cv.index_min
    eta = predict_path(cv.path, x_arm, idx)
    beta = cv.path.coefs[idx]
    mu_reg = cv.path.intercepts[idx] + torch.dot(target, beta)
    resid = y_arm - eta
    mu = mu_reg + torch.dot(gamma, resid)
    df = torch.sum(torch.abs(beta) > 0) + 1.0
    sigma2 = torch.sum(resid**2) / torch.clamp(x_arm.shape[0] - df, min=1.0)
    var = sigma2 * torch.sum(gamma**2)
    return mu, var


def residual_balance_ate(
    frame: CausalFrame,
    zeta: float = 0.5,
    max_iters: int = 4000,
    key: torch.Tensor | None = None,
    method: str = "residual_balancing",
    estimate_se: bool = True,
) -> EstimatorResult:
    """ATE by approximate residual balancing, the reference row
    ``Method = "residual_balancing"`` (``ate_functions.R:400-403``):
    treated on the second half of ``split(key)``, control on the first."""
    if key is None:
        key = rnd.key(0, device=frame.device)
    k0, k1 = rnd.split(key).unbind(dim=-2)
    x, y = frame.x, frame.y
    target = torch.mean(x, dim=0)

    treated = np.asarray(frame.w.cpu()) > 0.5
    rows1 = torch.as_tensor(np.flatnonzero(treated), device=x.device)
    rows0 = torch.as_tensor(np.flatnonzero(~treated), device=x.device)
    g1, rp1, it1 = approx_balance_sol(x[rows1], target, zeta=zeta, max_iters=max_iters)
    g0, rp0, it0 = approx_balance_sol(x[rows0], target, zeta=zeta, max_iters=max_iters)
    mu1, var1 = _arm_mu_var(x[rows1], y[rows1], target, k1, g1.to(x.dtype))
    mu0, var0 = _arm_mu_var(x[rows0], y[rows0], target, k0, g0.to(x.dtype))
    for arm, rp, it in (("treated", rp1, it1), ("control", rp0, it0)):
        if it >= max_iters and float(rp) > 1e-5:
            warnings.warn(
                f"balance QP ({arm} arm) hit max_iters={max_iters} with "
                f"worst residual {float(rp):.2e}; weights may be inexact — "
                "raise max_iters for wide covariate sets",
                RuntimeWarning,
                stacklevel=2,
            )
    tau = float(mu1 - mu0)
    if not estimate_se:
        return EstimatorResult.point_only(method, tau)
    return EstimatorResult.from_point_se(method, tau, float(torch.sqrt(var1 + var0)))
