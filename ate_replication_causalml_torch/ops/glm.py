"""Binomial-logit GLM via IRLS — replacement for R ``glm.fit``.

Port of ``ate_replication_causalml_tpu/ops/glm.py``. R's ``glm.fit``
runs iteratively reweighted least squares with a deviance-based
stopping rule (``epsilon = 1e-8``, ``maxit = 25``); the rule is
reproduced exactly. The loop runs on the host (one scalar read per
iteration decides whether to stop); each iteration is one weighted
normal-equation build and a Cholesky solve on the device.
:func:`logistic_glm_sharded` runs the same loop over rows sharded on a
mesh's ``data`` axis, with the partial sums ``all_reduce``d.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ate_replication_causalml_torch.ops.linalg import (
    _chol_solve,
    _chol_solve_nan,
    _spd_inverse,
    _spd_inverse_nan,
    over_lanes,
)


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
    solve: Callable = _chol_solve,
    inverse: Callable = _spd_inverse,
) -> GlmResult:
    """Fit ``y ~ x`` by binomial-logit IRLS with R ``glm.fit`` semantics.

    ``x`` must already include the intercept column. Convergence is R's
    relative-deviance test ``|dev - dev_old| / (|dev| + 0.1) < epsilon``.
    Standard errors are ``sqrt(diag((X' W X)^-1))`` at the converged
    weights — identical to ``summary.glm``.

    A batch of designs x (B, n, p), y (B, n) fits each lane on its own
    (:func:`~.linalg.over_lanes`), the semantics of the JAX package's
    ``vmap(lax.while_loop)``: each lane stops on its own test and takes
    exactly its scalar fit's iterations (``n_iter`` and ``converged``
    become (B,) tensors). A lane whose normal equations are not positive
    definite turns NaN and runs to ``max_iter``, as under ``vmap``.
    """
    if x.ndim == 3:
        return over_lanes(logistic_glm, x, y, epsilon=epsilon, max_iter=max_iter,
                          solve=_chol_solve_nan, inverse=_spd_inverse_nan)
    return _irls(x, y, epsilon, max_iter, solve, inverse)


def _irls(x, y, epsilon, max_iter, solve, inverse, total=None) -> GlmResult:
    """The IRLS loop of :func:`logistic_glm`. ``total`` sums a rank's
    partial (deviance, X'WX, X'Wz) over the rows of every rank (None: the
    rows are all here)."""
    total = (lambda t: t) if total is None else total
    p = x.shape[1]

    # R's binomial initialization: mustart = (y + 1/2) / 2, eta = logit(mu).
    mu0 = (y + 0.5) / 2.0
    eta = torch.log(mu0 / (1.0 - mu0))
    dev = total(_binomial_deviance(y, mu0))
    coef = torch.zeros(p, dtype=x.dtype, device=x.device)

    n_iter, converged = 0, False
    while not converged and n_iter < max_iter:
        mu = torch.sigmoid(eta)
        w = torch.clamp(mu * (1.0 - mu), min=1e-10)
        z = eta + (y - mu) / w
        xw = x * w[:, None]
        coef = solve(total(xw.T @ x), total(xw.T @ z))
        eta = x @ coef
        dev_new = total(_binomial_deviance(y, torch.sigmoid(eta)))
        converged = bool(torch.abs(dev_new - dev) / (torch.abs(dev_new) + 0.1) < epsilon)
        dev = dev_new
        n_iter += 1

    mu = torch.sigmoid(eta)
    w = torch.clamp(mu * (1.0 - mu), min=1e-10)
    xtwx = total((x * w[:, None]).T @ x)
    se = torch.sqrt(torch.clamp(torch.diagonal(inverse(xtwx)), min=0.0))
    return GlmResult(coef=coef, se=se, fitted=mu, deviance=dev, n_iter=n_iter,
                     converged=converged)


def logistic_glm_sharded(x: torch.Tensor, y: torch.Tensor, mesh, axis_name: str = "data",
                         epsilon: float = 1e-8, max_iter: int = 25) -> GlmResult:
    """:func:`logistic_glm` over rows sharded on ``axis_name`` of ``mesh``:
    ``x`` and ``y`` are this rank's rows. Each iteration's deviance,
    X'WX and X'Wz are this rank's partial sums, ``all_reduce``d over the
    axis before the solve (the JAX package's row-sharded IRLS, where XLA
    inserts the same psums); ``fitted`` holds this rank's rows and every
    rank holds the same coefficients. The summation order differs from
    the one-rank fit, so the fits agree to rounding, and in float32 the
    bit-equal-deviance stop can move by whole iterations."""
    from ate_replication_causalml_torch.parallel.mesh import all_reduce_sum

    return _irls(x, y, epsilon, max_iter, _chol_solve, _spd_inverse,
                 total=lambda t: all_reduce_sum(t, mesh, axis_name))


def predict_proba(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Response-scale prediction ``sigmoid(x @ coef)`` (R ``predict(type="response")``);
    a batch of fits, coef (B, p) with x (B, n, p), gives (B, n)."""
    return torch.sigmoid(x @ coef if coef.ndim == 1 else (x @ coef[..., None])[..., 0])
