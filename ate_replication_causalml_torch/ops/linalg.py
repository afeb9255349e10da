"""Least-squares core: OLS / WLS with coefficient standard errors.

Port of ``ate_replication_causalml_tpu/ops/linalg.py``, the replacement
for R's ``stats::lm`` + ``summary.lm`` (``ate_functions.R:28, 53, 74,
320, 363``). The normal equations are solved by Cholesky in the input's
own precision: float32 stays full float32 on the card (TF32 is off for
the whole package, see ``__init__``). ``alias_filter`` is host-side
float64 numpy selection logic, copied as it is.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


def fixed_sum(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in one fixed pairwise order: the axis padded with
    zeros to a power of two, then halved, every step one elementwise add.
    A lane's sum is the same bits whatever the other lanes, their count
    and the device: PyTorch's reductions pick their order by shape and
    device (the CPU's vectorized sums, the card's launch configuration)."""
    t = torch.movedim(t, dim, -1)
    n = t.shape[-1]
    if n == 0:
        return torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    size = 1 << (n - 1).bit_length()
    if size != n:
        t = torch.nn.functional.pad(t, (0, size - n))
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """``a``'s Cholesky factor, NaN where ``a`` is not positive definite
    (what ``jnp.linalg``'s Cholesky gives) instead of an exception."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.nan)


def _chol_solve_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_chol_solve`'s bits (1-D ``b``), NaN where ``a`` is not
    positive definite."""
    return torch.cholesky_solve(b[:, None], _cholesky_nan(a))[:, 0]


def _spd_inverse_nan(a: torch.Tensor) -> torch.Tensor:
    """:func:`_spd_inverse`'s bits, NaN where not positive definite."""
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye, _cholesky_nan(a))


def over_lanes(fit: Callable, x: torch.Tensor, y: torch.Tensor, **kw):
    """``fit`` of each lane of a batch of designs x (B, n, p), y (B, n):
    every field of the results stacked on a leading lane axis. Each lane
    is a fresh (n, p) tensor, as a lone fit's own, so a lane is that fit
    bit for bit and takes its iterations (PyTorch's batched products
    reassociate against the scalar ones, and the CPU's vectorized kernels
    follow the data's alignment)."""
    fits = [fit(x[i].clone(), y[i].clone(), **kw) for i in range(x.shape[0])]
    return type(fits[0])(*(torch.stack([torch.as_tensor(v, device=x.device) for v in field])
                           for field in zip(*fits)))


def ols(x: torch.Tensor, y: torch.Tensor, ridge: float = 0.0,
        inverse: Callable = _spd_inverse) -> LstsqResult:
    """OLS with classical (homoskedastic) standard errors, as R ``lm`` +
    ``summary.lm``: ``se_j = sqrt(sigma2 * (X'X)^-1_jj)`` with
    ``sigma2 = RSS / (n - p)``. ``ridge`` adds a tiny diagonal for
    rank-deficient designs (R drops aliased columns instead; callers
    that need R's aliasing pre-filter columns with :func:`alias_filter`).

    A batch of designs x (B, n, p), y (B, n) fits each lane
    (:func:`over_lanes`), and a lane whose design is not of full rank
    gives NaN instead of an exception, as ``vmap`` of the JAX package's
    fit does."""
    if x.ndim == 3:
        return over_lanes(ols, x, y, ridge=ridge, inverse=_spd_inverse_nan)
    n, p = x.shape
    xtx = x.T @ x
    if ridge:
        xtx = xtx + ridge * torch.eye(p, dtype=x.dtype, device=x.device)
    xty = x.T @ y
    xtx_inv = inverse(xtx)
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
    """[1, x] for a design (n, p) or a batch of designs (B, n, p)."""
    return torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)


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
