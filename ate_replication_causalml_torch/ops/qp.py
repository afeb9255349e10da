"""Graph-form ADMM for the approximate-balancing QP.

Port of ``ate_replication_causalml_tpu/ops/qp.py``, the solver behind
``balanceHD::residualBalance.ate`` (``ate_functions.R:393-398``):

    minimize   zeta * ||gamma||_2^2  +  (1 - zeta) * || X^T gamma - m ||_inf^2
    subject to sum(gamma) = 1,   0 <= gamma_i <= ub

posed in graph form (f(z) = (1-zeta)||z - m||_inf^2, g(gamma) =
zeta||gamma||^2 + I_C(gamma), z = X^T gamma): the two prox operators are
elementwise clips plus a scalar root found by 64 bisection steps, the
graph projection one k × k Cholesky factor of I + XᵀX (Woodbury) and
four matrix-vector products an iteration.

The same iteration as the JAX package's ``lax.while_loop``, written as
PyTorch ops on the input's device: the bisections keep their fixed 64
steps and brackets, the ρ adaptation its freeze point and clip, and the
loop stops at the first iteration whose residuals are within ``tol``.
That stop is the only value the host reads, once an iteration (one
device sync on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_BISECT_ITERS = 64
# Iterations during which ρ may adapt; frozen afterwards so the fixed-ρ
# convergence guarantee applies to the tail (Boyd §3.4.1).
_ADAPT_ITERS = 500


def project_capped_simplex(v: torch.Tensor, ub: float = math.inf) -> torch.Tensor:
    """Euclidean projection onto {g : sum(g) = 1, 0 <= g_i <= ub}: the dual
    ``nu`` of g_i(nu) = clip(v_i - nu, 0, ub), sum g_i(nu) = 1, found by
    64 bisection steps from [min(v) - min(ub, 1) - 1, max(v)]."""
    v = torch.as_tensor(v)
    ub = float(ub)
    lo = torch.min(v) - min(ub, 1.0) - 1.0
    hi = torch.max(v)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        too_big = torch.sum(torch.clamp(v - mid, 0.0, ub)) > 1.0
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    nu = 0.5 * (lo + hi)
    return torch.clamp(v - nu, 0.0, ub)


def prox_sq_inf_norm(d: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """prox of q -> scale * ||q||_inf^2 at ``d``: ``d`` clipped to [-t, t],
    t >= 0 the root of 2*scale*t = sum_i (|d_i| - t)_+, by 64 bisection
    steps from [0, max|d|]."""
    a = torch.abs(d)
    hi = torch.max(a)
    lo = torch.zeros_like(hi)
    two_scale = 2.0 * scale     # (2·scale)·t, as the reference's 2.0 * scale * t
    for _ in range(_BISECT_ITERS):
        t = 0.5 * (lo + hi)
        low = two_scale * t - torch.sum(torch.clamp(a - t, min=0.0)) < 0
        lo, hi = torch.where(low, t, lo), torch.where(low, hi, t)
    t = 0.5 * (lo + hi)
    return torch.clamp(d, -t, t)


class QpSolution(NamedTuple):
    gamma: torch.Tensor         # (n,) balancing weights
    z: torch.Tensor             # (k,) = X^T gamma at the solution
    primal_resid: torch.Tensor
    dual_resid: torch.Tensor
    iters: int


def balance_qp(
    x: torch.Tensor,
    target: torch.Tensor,
    zeta: float = 0.5,
    ub: float = math.inf,
    rho: float = 1.0,
    max_iters: int = 4000,
    tol: float = 1e-7,
) -> QpSolution:
    """Solve the balancing QP (module docstring) by graph-form ADMM in the
    dtype and on the device of ``x`` (n, k); ``target`` (k,) is the
    covariate mean to balance toward. Returns weights on the rows of
    ``x`` summing to 1."""
    x = torch.as_tensor(x)
    n, k = x.shape
    dt, dev = x.dtype, x.device
    m = torch.as_tensor(target).to(dev, dt)
    zeta = torch.tensor(zeta, dtype=dt, device=dev)
    eta = 1.0 - zeta
    ub = float(ub)

    # Woodbury: (I_n + X X^T)^{-1} c = c - X (I_k + X^T X)^{-1} X^T c.
    chol = torch.linalg.cholesky(torch.eye(k, dtype=dt, device=dev) + x.T @ x)

    def graph_project(c, d):
        rhs = c + x @ d
        t = torch.cholesky_solve((x.T @ rhs)[:, None], chol)[:, 0]
        gamma = rhs - x @ t
        return gamma, x.T @ gamma

    def prox_g(v, rho_c):
        return project_capped_simplex(rho_c * v / (2.0 * zeta + rho_c), ub)

    def prox_f(v, rho_c):
        return m + prox_sq_inf_norm(v - m, eta / rho_c)

    # Never later than half the budget, so a short budget still gets a
    # fixed-ρ tail.
    adapt_iters = min(_ADAPT_ITERS, max_iters // 2)

    g = torch.full((n,), 1.0 / n, dtype=dt, device=dev)
    z = x.T @ g
    tg, tz = torch.zeros_like(g), torch.zeros_like(z)
    rho_c = torch.tensor(rho, dtype=dt, device=dev)
    rp = rd = torch.tensor(math.inf, dtype=dt, device=dev)
    two, half, one = (torch.tensor(v, dtype=dt, device=dev) for v in (2.0, 0.5, 1.0))
    i = 0
    while i < max_iters and bool(torch.maximum(rp, rd) > tol):
        g_half = prox_g(g - tg, rho_c)
        z_half = prox_f(z - tz, rho_c)
        g_new, z_new = graph_project(g_half + tg, z_half + tz)
        tg = tg + g_half - g_new
        tz = tz + z_half - z_new
        rp = torch.sqrt(torch.sum((g_half - g_new) ** 2) + torch.sum((z_half - z_new) ** 2))
        # The dual residual carries ρ (scaled duals).
        rd = rho_c * torch.sqrt(torch.sum((g_new - g) ** 2) + torch.sum((z_new - z) ** 2))
        # Residual balancing (Boyd §3.4.1): double or halve ρ toward
        # balanced residuals until adapt_iters, the scaled duals rescaled
        # by ρ_old/ρ_new.
        if i < adapt_iters:
            scale = torch.where(rp > 10.0 * rd, two, torch.where(rd > 10.0 * rp, half, one))
            rho_new = torch.clamp(rho_c * scale, 1e-4, 1e6)
        else:   # frozen: the reference's scale of 1, and ρ·1 is ρ
            rho_new = torch.clamp(rho_c, 1e-4, 1e6)
        ratio = rho_c / rho_new
        g, z, tg, tz, rho_c = g_new, z_new, tg * ratio, tz * ratio, rho_new
        i += 1
    # Report the feasible iterate, so downstream sums are exact.
    g = project_capped_simplex(g, ub)
    return QpSolution(gamma=g, z=x.T @ g, primal_resid=rp, dual_resid=rd, iters=i)


def balance_qp_x64(
    x,
    target,
    zeta: float = 0.5,
    ub: float = float("inf"),
    rho: float = 1.0,
    max_iters: int = 4000,
    tol: float = 1e-7,
) -> QpSolution:
    """:func:`balance_qp` in float64 whatever the input dtype, on the
    device of ``x``: the weights feed a plug-in estimator and need the
    1e-7 stationarity of the reference's exact solver, where float32 ADMM
    floors near 1e-3 residuals. The card runs float64 natively."""
    x = torch.as_tensor(x)
    # graftlint: disable=TGL004 — the balancing QP is float64 ADMM: the plug-in weights need the reference solver's 1e-7 stationarity (docstring above)
    return balance_qp(x.to(torch.float64), torch.as_tensor(target).to(x.device, torch.float64),
                      zeta=zeta, ub=ub, rho=rho, max_iters=int(max_iters), tol=tol)


def balance_objective(x, target, gamma, zeta=0.5):
    """The balancing objective at ``gamma`` (for tests and diagnostics)."""
    imbalance = x.T @ gamma - torch.as_tensor(target).to(gamma)
    return zeta * torch.sum(gamma**2) + (1.0 - zeta) * torch.max(torch.abs(imbalance)) ** 2
