"""Least-squares core: OLS / WLS with coefficient standard errors.

Port of ``ate_replication_causalml_tpu/ops/linalg.py``, the replacement
for R's ``stats::lm`` + ``summary.lm`` (``ate_functions.R:28, 53, 74,
320, 363``). The normal equations are solved by Cholesky in the input's
own precision: float32 stays full float32 on the card (TF32 is off for
the whole package, see ``__init__``). ``alias_filter`` is host-side
float64 numpy selection logic, copied as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LstsqResult(NamedTuple):
    """Fit result mirroring what ``summary.lm`` exposes to the estimators:
    coefficients, their standard errors, residuals, and the unscaled
    inverse Gram matrix (for sandwich-style reuse)."""

    coef: torch.Tensor        # (p,)
    se: torch.Tensor          # (p,)
    residuals: torch.Tensor   # (n,)
    xtx_inv: torch.Tensor     # (p, p)
    sigma2: torch.Tensor      # scalar: RSS / (n - p)


def _chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system ``a x = b`` via Cholesky (``b`` may be 1-D)."""
    chol = torch.linalg.cholesky(a)
    vec = b.ndim == 1
    x = torch.cholesky_solve(b[:, None] if vec else b, chol)
    return x[:, 0] if vec else x


def _spd_inverse(a: torch.Tensor) -> torch.Tensor:
    chol = torch.linalg.cholesky(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye, chol)


def ols(x: torch.Tensor, y: torch.Tensor, ridge: float = 0.0) -> LstsqResult:
    """OLS with classical (homoskedastic) standard errors, as R ``lm`` +
    ``summary.lm``: ``se_j = sqrt(sigma2 * (X'X)^-1_jj)`` with
    ``sigma2 = RSS / (n - p)``. ``ridge`` adds a tiny diagonal for
    rank-deficient designs (R drops aliased columns instead; callers
    that need R's aliasing pre-filter columns with :func:`alias_filter`)."""
    n, p = x.shape
    xtx = x.T @ x
    if ridge:
        xtx = xtx + ridge * torch.eye(p, dtype=x.dtype, device=x.device)
    xty = x.T @ y
    xtx_inv = _spd_inverse(xtx)
    coef = xtx_inv @ xty
    resid = y - x @ coef
    sigma2 = torch.sum(resid * resid) / (n - p)
    se = torch.sqrt(torch.clamp(torch.diagonal(xtx_inv) * sigma2, min=0.0))
    return LstsqResult(coef=coef, se=se, residuals=resid, xtx_inv=xtx_inv, sigma2=sigma2)


def wls(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor) -> LstsqResult:
    """Weighted least squares with R ``lm(..., weights=)`` semantics: R
    minimizes ``sum(w_i e_i^2)`` and ``summary.lm`` reports
    ``se = sqrt(sigma2 * (X'WX)^-1_jj)`` with
    ``sigma2 = sum(w e^2) / (n - p)`` (``ate_functions.R:71-75``)."""
    n, p = x.shape
    xw = x * weights[:, None]
    xtwx = xw.T @ x
    xtwy = xw.T @ y
    xtwx_inv = _spd_inverse(xtwx)
    coef = xtwx_inv @ xtwy
    resid = y - x @ coef
    sigma2 = torch.sum(weights * resid * resid) / (n - p)
    se = torch.sqrt(torch.clamp(torch.diagonal(xtwx_inv) * sigma2, min=0.0))
    return LstsqResult(coef=coef, se=se, residuals=resid, xtx_inv=xtwx_inv, sigma2=sigma2)


def ols_no_intercept_1d(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``lm(y ~ 0 + x)`` for a single regressor, the DML
    residual-on-residual regression (``ate_functions.R:363``): (coef, se)."""
    sxx = torch.sum(x * x)
    coef = torch.sum(x * y) / sxx
    resid = y - coef * x
    n = x.shape[0]
    sigma2 = torch.sum(resid * resid) / (n - 1)
    se = torch.sqrt(sigma2 / sxx)
    return coef, se


def add_intercept(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(x[:, :1]), x], dim=1)


def alias_filter(cols, *, with_intercept: bool = True, tol: float = 1e-7) -> np.ndarray:
    """Indices of the columns R's ``lm`` would keep (pivoted-QR aliasing).

    R's ``lm.fit`` runs LINPACK ``dqrdc2``, which walks columns left to
    right and aliases any column whose R-diagonal falls below ``tol``
    relative to the column's own norm: a column numerically dependent on
    kept earlier columns, with left-to-right preference. Reproduced with
    sequential modified Gram–Schmidt in float64 on the host (selection
    logic, not device compute). ``with_intercept=True`` seeds the basis
    with the constant column, so constant columns alias away as in
    ``lm``. ``cols`` may be a tensor on any device or an array."""
    if isinstance(cols, torch.Tensor):
        cols = cols.detach().cpu().numpy()
    a = np.asarray(cols, dtype=np.float64)
    n = a.shape[0]
    basis: list[np.ndarray] = []
    if with_intercept:
        basis.append(np.full(n, 1.0 / np.sqrt(n)))
    keep: list[int] = []
    for j in range(a.shape[1]):
        v = a[:, j]
        norm0 = np.linalg.norm(v)
        if norm0 == 0.0:
            continue
        r = v.copy()
        for q in basis:
            r -= (q @ r) * q
        # Twice-is-enough re-orthogonalization keeps the test sharp when
        # columns are nearly dependent.
        for q in basis:
            r -= (q @ r) * q
        rnorm = np.linalg.norm(r)
        if rnorm > tol * norm0:
            keep.append(j)
            basis.append(r / rnorm)
    return np.asarray(keep, dtype=np.int64)
