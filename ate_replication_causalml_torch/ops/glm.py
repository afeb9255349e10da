"""Binomial-logit GLM via IRLS — replacement for R ``glm.fit``.

Port of ``ate_replication_causalml_tpu/ops/glm.py``. R's ``glm.fit``
runs iteratively reweighted least squares with a deviance-based
stopping rule (``epsilon = 1e-8``, ``maxit = 25``); the rule is
reproduced exactly. The loop runs on the host (one scalar read per
iteration decides whether to stop); each iteration is one weighted
normal-equation build and a Cholesky solve on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ate_replication_causalml_torch.ops.linalg import _chol_solve, _spd_inverse


class GlmResult(NamedTuple):
    coef: torch.Tensor      # (p,)
    se: torch.Tensor        # (p,)
    fitted: torch.Tensor    # (n,) response-scale fitted probabilities
    deviance: torch.Tensor  # scalar
    n_iter: int
    converged: bool


def _binomial_deviance(y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """-2 log-likelihood of Bernoulli observations (R's binomial deviance)."""
    eps = torch.finfo(mu.dtype).tiny
    ll = y * torch.log(torch.clamp(mu, min=eps)) + (1.0 - y) * torch.log(
        torch.clamp(1.0 - mu, min=eps)
    )
    return -2.0 * torch.sum(ll)


def logistic_glm(
    x: torch.Tensor,
    y: torch.Tensor,
    epsilon: float = 1e-8,
    max_iter: int = 25,
) -> GlmResult:
    """Fit ``y ~ x`` by binomial-logit IRLS with R ``glm.fit`` semantics.

    ``x`` must already include the intercept column. Convergence is R's
    relative-deviance test ``|dev - dev_old| / (|dev| + 0.1) < epsilon``.
    Standard errors are ``sqrt(diag((X' W X)^-1))`` at the converged
    weights — identical to ``summary.glm``.
    """
    p = x.shape[1]

    # R's binomial initialization: mustart = (y + 1/2) / 2, eta = logit(mu).
    mu0 = (y + 0.5) / 2.0
    eta = torch.log(mu0 / (1.0 - mu0))
    dev = _binomial_deviance(y, mu0)
    coef = torch.zeros(p, dtype=x.dtype, device=x.device)

    n_iter, converged = 0, False
    while not converged and n_iter < max_iter:
        mu = torch.sigmoid(eta)
        w = torch.clamp(mu * (1.0 - mu), min=1e-10)
        z = eta + (y - mu) / w
        xw = x * w[:, None]
        coef = _chol_solve(xw.T @ x, xw.T @ z)
        eta = x @ coef
        dev_new = _binomial_deviance(y, torch.sigmoid(eta))
        converged = bool(torch.abs(dev_new - dev) / (torch.abs(dev_new) + 0.1) < epsilon)
        dev = dev_new
        n_iter += 1

    mu = torch.sigmoid(eta)
    w = torch.clamp(mu * (1.0 - mu), min=1e-10)
    xtwx = (x * w[:, None]).T @ x
    se = torch.sqrt(torch.clamp(torch.diagonal(_spd_inverse(xtwx)), min=0.0))
    return GlmResult(coef=coef, se=se, fitted=mu, deviance=dev, n_iter=n_iter,
                     converged=converged)


def predict_proba(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Response-scale prediction ``sigmoid(x @ coef)`` (R ``predict(type="response")``)."""
    return torch.sigmoid(x @ coef)
