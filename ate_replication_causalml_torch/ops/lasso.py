"""Elastic-net / LASSO coordinate descent with glmnet-compatible semantics.

Port of ``ate_replication_causalml_tpu/ops/lasso.py``, the replacement
for the ``glmnet`` Fortran core (``elnet``/``lognet``) that the reference
calls at ``ate_functions.R:101, 123, 139, 304-305``. The rules are the
JAX package's, unchanged: internal weighted 1/n standardization,
penalty factors rescaled to sum to p (zero allowed), the log-linear λ
path from ``λ_max`` down to ``λ_max·lambda.min.ratio``, sweeps until
``max_j G_jj·Δβ_j² < thresh``, K-fold CV with per-fold refits over the
full-data λ path, ``lambda.min``/``lambda.1se`` selection and R's fold
assignment.

Batches. The JAX package ``vmap``s the fold fits; here a fit is a row
of a batch: weights (B, n), each row with its own standardization, Gram
system and λ scale. :func:`cv_glmnet` fits the full data and the K folds
as one batch of K + 1 (the full fit's λ path is known before any sweep).
A batched loop keeps ``vmap``'s semantics: a fit whose loop condition
has failed is frozen while the others iterate.

Device split. The O(n·p²) work (Gram matrices, ``X'Wr``, the fold
losses) is ``torch.matmul``. The coordinate descent over the whole λ
path is :func:`cd_path`: on the card one launch of ``csrc/lasso.cu``
(one block per fit, the counterpart of the JAX package's
``lax.scan``/``while_loop``/``fori_loop`` program), on the CPU its plain
version :func:`cd_path_plain` (``_cd_sweeps`` looped over the λs). The
binomial family's IRLS loop stays on the host, batched over fits: one
launch per iteration for a path of one λ, then one host read to decide
whether any fit goes on.

Fold sharding. ``cv_glmnet(fold_axis=...)`` (the JAX package's
fold-sharded CV over a mesh axis) splits each ``cd_path`` batch over the
axis's ranks (:func:`cd_path_sharded`); the Gram systems are built on
every rank, so only the coordinate descent is divided, and the result
equals the unsharded CV bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ate_replication_causalml_torch.kernels import build
from ate_replication_causalml_torch.ops import random as rnd

DEFAULT_NLAMBDA = 100
DEFAULT_THRESH = 1e-7
MAX_SWEEPS = 2000
MAX_IRLS = 25


class ElnetPath(NamedTuple):
    """A fitted regularization path on the original data scale."""

    lambdas: torch.Tensor      # (L,)
    intercepts: torch.Tensor   # (L,)
    coefs: torch.Tensor        # (L, p)


class CvGlmnetResult(NamedTuple):
    path: ElnetPath            # full-data fit
    cvm: torch.Tensor          # (L,) mean CV loss
    cvsd: torch.Tensor         # (L,) SE of CV loss across folds
    lambda_min: torch.Tensor   # scalar
    lambda_1se: torch.Tensor   # scalar
    index_min: torch.Tensor    # scalar int
    index_1se: torch.Tensor    # scalar int

    def coef_at(self, which: str = "1se") -> tuple[torch.Tensor, torch.Tensor]:
        """(intercept, coefs) at lambda.1se (R ``coef(cvfit)`` default) or
        lambda.min."""
        idx = self.index_1se if which == "1se" else self.index_min
        return self.path.intercepts[idx], self.path.coefs[idx]


def _normalize_pf(penalty_factor: torch.Tensor, p: int) -> torch.Tensor:
    """glmnet rescales penalty factors to sum to nvars."""
    return penalty_factor * p / torch.sum(penalty_factor)


def _weighted_standardize(x: torch.Tensor, weights: torch.Tensor):
    """glmnet-internal standardization: weighted mean 0, weighted 1/n
    variance 1. ``weights`` (n,) or a batch (B, n) → (x_std (…, n, p),
    means (…, p), scales (…, p)). ``x`` (n, p), or one design a fit
    (B, n, p) beside weights (B, n)."""
    if x.ndim == 3:
        xm = (weights[:, None, :] @ x)[:, 0]
        xv = (weights[:, None, :] @ (x * x))[:, 0] - xm * xm
    else:
        xm = weights @ x
        xv = weights @ (x * x) - xm * xm
    xs = torch.sqrt(torch.clamp(xv, min=1e-30))
    return (x - xm[..., None, :]) / xs[..., None, :], xm, xs


def lambda_sequence(lambda_max: torch.Tensor, n: int, p: int,
                    nlambda: int = DEFAULT_NLAMBDA) -> torch.Tensor:
    """glmnet's log-linear path; ratio 1e-4 if n > p else 1e-2.

    The exponents are the JAX package's ``jnp.linspace(0, stop, L)`` as
    XLA evaluates it on the CPU, ``i · (stop / (L − 1))`` with ``stop``
    last (its ``start·(1 − step)`` term is an exact 0): equal bits. ``exp``
    is the device's."""
    ratio = 1e-4 if n > p else 1e-2
    dt, dev = lambda_max.dtype, lambda_max.device
    stop = torch.tensor(float(np.log(ratio)), dtype=dt, device=dev)
    if nlambda > 1:
        delta = stop / torch.tensor(float(nlambda - 1), dtype=dt, device=dev)
        expo = torch.cat([torch.arange(nlambda - 1, dtype=dt, device=dev) * delta, stop[None]])
    else:
        expo = torch.zeros(nlambda, dtype=dt, device=dev)
    return lambda_max[..., None] * torch.exp(expo)


def _cd_sweeps(gram, xty, beta0, lam, alpha, pf, thresh, max_sweeps: int = MAX_SWEEPS):
    """Coordinate descent to convergence on a batch of standardized Gram
    systems, gram (B, p, p), xty (B, p), beta0 (B, p), lam (B,), pf (B, p):

        min 1/2 β'Gβ − c'β + λ Σ_j pf_j (α|β_j| + (1−α)/2 β_j²)

    sweeping j = 0..p−1 per sweep, ``gj = c_j − G_j·β + G_jj β_j``, soft
    threshold, divide by ``G_jj + λ(1−α)pf_j``, until ``max_j G_jj Δβ_j²
    < thresh`` or ``max_sweeps`` (at least one sweep). A fit that has
    stopped is frozen while the others sweep. Returns (β (B, p), sweeps
    (B,) int32)."""
    n_fits, p = xty.shape
    dt, dev = xty.dtype, xty.device
    diag = torch.diagonal(gram, dim1=-2, dim2=-1)
    denom = diag + (lam * (1.0 - alpha))[:, None] * pf
    thr_lam = (lam * alpha)[:, None] * pf
    thresh_t = torch.tensor(thresh, dtype=dt, device=dev)
    # Row j of every fit's Gram (B, p) and the (B,) values of coordinate j,
    # as views made once.
    rows = gram.transpose(0, 1).contiguous().unbind(0)
    c_j, g_jj, thr_j, den_j = (t.T.contiguous().unbind(0) for t in (xty, diag, thr_lam, denom))
    beta = beta0.clone()
    sweeps = torch.zeros(n_fits, dtype=torch.int32, device=dev)
    active = torch.ones(n_fits, dtype=torch.bool, device=dev)
    while True:
        new = beta.clone()
        b_j = new.unbind(1)
        for j in range(p):
            gj = c_j[j] - torch.linalg.vecdot(rows[j], new) + g_jj[j] * b_j[j]
            # jnp.sign(g)·m is copysign(m, g) for m ≥ 0 or NaN, signed zeros included.
            b_j[j].copy_(torch.copysign(torch.clamp(gj.abs() - thr_j[j], min=0.0), gj) / den_j[j])
        # Coordinate j moves once a sweep, from its value at the sweep's start:
        # the reference's running max of G_jj·Δβ_j², taken after the sweep.
        d = new - beta
        dlx = torch.amax(diag * (d * d), dim=1)
        beta = torch.where(active[:, None], new, beta)
        sweeps = sweeps + active.to(torch.int32)
        active = active & (dlx >= thresh_t) & (sweeps < max_sweeps)
        if not bool(active.any()):
            return beta, sweeps


def _check_cd_inputs(gram, xty, pf, lambdas, beta0, max_sweeps) -> None:
    if gram.ndim != 3 or gram.shape[1] != gram.shape[2]:
        raise TypeError(f"gram must be (B, p, p), got {tuple(gram.shape)}")
    n_fits, p, _ = gram.shape
    if gram.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gram must be float32 or float64, got {gram.dtype}")
    for name, t, shape in (("xty", xty, (n_fits, p)), ("pf", pf, (n_fits, p)),
                           ("beta0", beta0, (n_fits, p))):
        if t is not None and (t.dtype != gram.dtype or tuple(t.shape) != shape):
            raise TypeError(f"{name} must be {shape} {gram.dtype}, got {t.dtype} {tuple(t.shape)}")
    if lambdas.dtype != gram.dtype or lambdas.ndim != 2 or lambdas.shape[0] != n_fits:
        raise TypeError(f"lambdas must be (B, L) {gram.dtype}, got {lambdas.dtype} "
                        f"{tuple(lambdas.shape)}")
    if max_sweeps < 1:
        raise ValueError(f"max_sweeps must be at least 1, got {max_sweeps}")


def cd_path_plain(gram, xty, pf, lambdas, beta0=None, alpha: float = 1.0,
                  thresh: float = DEFAULT_THRESH, max_sweeps: int = MAX_SWEEPS):
    """The plain version of :func:`cd_path`: :func:`_cd_sweeps` down the λ
    path, warm-started."""
    _check_cd_inputs(gram, xty, pf, lambdas, beta0, max_sweeps)
    beta = torch.zeros_like(xty) if beta0 is None else beta0
    betas, sweeps = [], []
    for lam in lambdas.unbind(dim=1):
        beta, it = _cd_sweeps(gram, xty, beta, lam, alpha, pf, thresh, max_sweeps)
        betas.append(beta)
        sweeps.append(it)
    return torch.stack(betas, dim=1), torch.stack(sweeps, dim=1)


def cd_path(gram, xty, pf, lambdas, beta0=None, alpha: float = 1.0,
            thresh: float = DEFAULT_THRESH, max_sweeps: int = MAX_SWEEPS):
    """Coordinate descent down a warm-started λ path for a batch of fits.

    gram (B, p, p), xty (B, p), pf (B, p) the normalized penalty
    factors, lambdas (B, L) each fit's standardized λ path, beta0 (B, p)
    the start (zeros if None), all float32 or float64 → (betas (B, L, p)
    the coefficients after each λ, sweeps (B, L) int32 the sweeps each
    took). Each λ is :func:`_cd_sweeps`' contract.

    CPU tensors run :func:`cd_path_plain`; CUDA tensors launch
    ``csrc/lasso.cu``'s ``cd_path_kernel`` (one block per fit), counted
    in ``cd_path.launches``. The kernel takes each G_j·β in another
    order than the plain version: the terms of the :func:`cd_delay`
    coordinates updated last are added one by one, oldest first, to the
    sum of the others, which is taken that many updates ahead. It takes
    p up to :func:`cd_max_p` and raises past it."""
    _check_cd_inputs(gram, xty, pf, lambdas, beta0, max_sweeps)
    dev = gram.device
    if dev.type == "cpu":
        return cd_path_plain(gram, xty, pf, lambdas, beta0, alpha, thresh, max_sweeps)
    if dev.type != "cuda":
        raise ValueError(f"no cd_path kernel for device {dev}")
    inputs = (gram, xty, pf, lambdas) + (() if beta0 is None else (beta0,))
    if any(t.device != dev or not t.is_contiguous() for t in inputs):
        raise TypeError("cd_path inputs must be contiguous, on one device")
    n_fits, p, _ = gram.shape
    n_lam = lambdas.shape[1]
    betas = torch.empty((n_fits, n_lam, p), dtype=gram.dtype, device=dev)
    sweeps = torch.empty((n_fits, n_lam), dtype=torch.int32, device=dev)
    if n_fits == 0 or n_lam == 0:
        return betas, sweeps
    if n_fits > 2**31 - 1:
        raise ValueError("cd_path takes at most 2**31 - 1 fits a launch")
    if p > cd_max_p(gram.dtype):
        raise ValueError(f"cd_path takes p up to {cd_max_p(gram.dtype)} in {gram.dtype} "
                         f"(its shared memory), got {p}")
    k = build.kernel("cd_path")
    build.check(k, k.fn(
        gram.data_ptr(), xty.data_ptr(), pf.data_ptr(), lambdas.data_ptr(),
        None if beta0 is None else beta0.data_ptr(), n_fits, p, n_lam,
        float(alpha), float(1.0 - alpha), float(thresh), int(max_sweeps),
        int(gram.dtype == torch.float64), betas.data_ptr(), sweeps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    build.count_launch(cd_path)
    return betas, sweeps


cd_path.launches = 0


def cd_path_sharded(gram, xty, pf, lambdas, beta0=None, alpha: float = 1.0,
                    thresh: float = DEFAULT_THRESH, max_sweeps: int = MAX_SWEEPS, *, mesh,
                    axis: str):
    """:func:`cd_path` with the batch's fits split over the ranks of
    ``axis``: every rank holds the whole batch, launches ``cd_path`` on
    its block of ``ceil(B / A)`` fits (the last block padded with copies
    of the last fit), and the results are all-gathered in fit order. A
    fit's result does not depend on the batch it runs in (one block a
    fit on the card, one row a fit in the plain version), so this
    equals :func:`cd_path` on the whole batch bit for bit."""
    from ate_replication_causalml_torch.parallel.mesh import all_gather_cat

    a = mesh.shape[axis]
    if a == 1:
        return cd_path(gram, xty, pf, lambdas, beta0, alpha, thresh, max_sweeps)
    n_fits = gram.shape[0]
    per = -(-n_fits // a)
    r = mesh.coord(axis)
    mine = torch.clamp(torch.arange(r * per, (r + 1) * per, device=gram.device), max=n_fits - 1)
    pick = lambda t: None if t is None else t[mine].contiguous()
    betas, sweeps = cd_path(pick(gram), pick(xty), pick(pf), pick(lambdas), pick(beta0), alpha,
                            thresh, max_sweeps)
    return all_gather_cat(betas, mesh, axis)[:n_fits], all_gather_cat(sweeps, mesh, axis)[:n_fits]


@functools.cache
def cd_delay() -> int:
    """The card kernel's delay d: coordinate j's sum takes the terms of
    the d coordinates updated just before it last (p − 1 of them for
    p ≤ d). Builds the kernels on first use."""
    return int(build.kernel("cd_delay").fn())


@functools.cache
def cd_max_p(dtype: torch.dtype) -> int:
    """The largest p the card kernel takes in ``dtype`` (float32 or
    float64): its shared memory holds the coordinates' records and
    divisors, β, the tail's band and a ring of Gram rows."""
    return int(build.kernel("cd_max_p").fn(int(dtype == torch.float64)))


def _penalty(penalty_factor, p: int, x: torch.Tensor) -> torch.Tensor:
    if penalty_factor is None:
        return torch.ones(p, dtype=x.dtype, device=x.device)
    return _normalize_pf(torch.as_tensor(penalty_factor).to(x), p)


def _lambda_max(g: torch.Tensor, pf: torch.Tensor, alpha: float) -> torch.Tensor:
    """max_j |g_j| / pf_j over penalized j, over max(α, 1e-3)."""
    inf = torch.tensor(float("inf"), dtype=g.dtype, device=g.device)
    return torch.max(torch.abs(g) / torch.where(pf > 0, pf, inf), dim=-1).values / max(alpha, 1e-3)


def _normalized(weights: torch.Tensor) -> torch.Tensor:
    return weights / torch.sum(weights, dim=-1, keepdim=True)


def _gaussian_batch(x, y, w, pf, alpha, thresh, lambdas=None, nlambda=DEFAULT_NLAMBDA,
                    lead=None, cd=None):
    """Gaussian fits of a batch: x (n, p) or one design a fit (B, n, p),
    y (n,) or one target a fit (B, n), w (B, n) normalized weights, pf (p,). Without ``lambdas`` each fit ``b`` with
    ``lead[b] == b`` (default: the first fit leads all) takes its own λ
    path, and every other fit its lead's path on its own scale (``lambdas
    / ys``: the folds of :func:`cv_glmnet` on the full fit's
    ``path.lambdas``); with ``lambdas`` (L,) every fit takes them.
    Returns a batched :class:`ElnetPath`: (B, L), (B, L), (B, L, p)."""
    n, p = x.shape[-2:]
    n_fits = w.shape[0]
    xs_std, xm, xs = _weighted_standardize(x, w)
    ym = torch.linalg.vecdot(w, y)
    yv = torch.linalg.vecdot(w, y * y) - ym * ym
    ys = torch.sqrt(torch.clamp(yv, min=1e-30))
    v = (y - ym[:, None]) / ys[:, None]
    # The Gram systems on the standardized scale: the only O(n p²) work.
    xw = (xs_std * w[:, :, None]).transpose(1, 2)
    gram = xw @ xs_std
    xty = (xw @ v[:, :, None])[:, :, 0]
    if lambdas is None:
        if lead is None:
            lead = torch.zeros(n_fits, dtype=torch.int64, device=x.device)
        lams_own = lambda_sequence(_lambda_max(xty, pf, alpha), n, p, nlambda)
        heads = lead == torch.arange(n_fits, device=x.device)
        lams_std = torch.where(heads[:, None], lams_own,
                               (lams_own * ys[:, None])[lead] / ys[:, None])
    else:
        lams_std = torch.as_tensor(lambdas).to(x)[None, :] / ys[:, None]
    cd = cd_path if cd is None else cd     # looked up at the call: a caller may wrap it
    betas, _ = cd(gram, xty, pf.expand(n_fits, p).contiguous(), lams_std, None, alpha, thresh)
    coefs = betas * ys[:, None, None] / xs[:, None, :]
    intercepts = ym[:, None] - (coefs @ xm[:, :, None])[:, :, 0]
    return ElnetPath(lambdas=lams_std * ys[:, None], intercepts=intercepts, coefs=coefs)


def elnet_gaussian(
    x: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None = None,
    penalty_factor: torch.Tensor | None = None,
    alpha: float = 1.0,
    nlambda: int = DEFAULT_NLAMBDA,
    lambdas: torch.Tensor | None = None,
    thresh: float = DEFAULT_THRESH,
) -> ElnetPath:
    """Gaussian elastic net over a λ path (glmnet ``family="gaussian"``),
    on the device of ``x``. A row of weight 0 is held out: the fit
    standardizes on the other rows, as glmnet's per-fold refit does."""
    n, p = x.shape
    w = torch.ones(n, dtype=x.dtype, device=x.device) if weights is None else (
        torch.as_tensor(weights).to(x))
    path = _gaussian_batch(x, y, _normalized(w)[None], _penalty(penalty_factor, p, x), alpha,
                           thresh, lambdas, nlambda)
    return ElnetPath(*(t[0] for t in path))


def _binomial_batch(x, y, w_obs, pf, alpha, thresh, lambdas=None, nlambda=DEFAULT_NLAMBDA,
                    lead=None, cd=None):
    """Binomial-logit fits of a batch: y (n,) or (B, n), w_obs (B, n)
    normalized weights; every fit on its lead's λ path without
    ``lambdas`` (as :func:`_gaussian_batch`; the binomial path is not
    rescaled), else on ``lambdas`` (L,). Outer
    IRLS quadratic approximation, inner penalized weighted coordinate
    descent, warm-started down the path. The IRLS loop runs on the host,
    batched: each iteration builds every fit's system, runs one
    :func:`cd_path` of one λ and reads once whether any fit goes on; a
    fit that has stopped is frozen."""
    n, p = x.shape
    n_fits = w_obs.shape[0]
    xs_std, xm, xs = _weighted_standardize(x, w_obs)
    ybar = torch.linalg.vecdot(w_obs, y)
    if lambdas is None:
        if lead is None:
            lead = torch.zeros(n_fits, dtype=torch.int64, device=x.device)
        r0 = w_obs * (y - ybar[:, None])
        g = (xs_std.transpose(1, 2) @ r0[:, :, None])[:, :, 0]
        lams = lambda_sequence(_lambda_max(g, pf, alpha), n, p, nlambda)[lead]
    else:
        lams = torch.as_tensor(lambdas).to(x).expand(n_fits, -1)
    pf_b = pf.expand(n_fits, p).contiguous()
    cd = cd_path if cd is None else cd     # looked up at the call: a caller may wrap it
    beta = torch.zeros((n_fits, p), dtype=x.dtype, device=x.device)
    b0 = torch.log(ybar / (1.0 - ybar))
    thresh10 = torch.tensor(thresh * 10.0, dtype=x.dtype, device=x.device)
    betas, b0s = [], []
    for lam_b in lams.unbind(dim=1):
        lam_b = lam_b[:, None].contiguous()
        active = torch.ones(n_fits, dtype=torch.bool, device=x.device)
        it = 0
        while True:
            eta = b0[:, None] + (xs_std @ beta[:, :, None])[:, :, 0]
            mu = torch.sigmoid(eta)
            wq = torch.clamp(mu * (1.0 - mu), min=1e-9) * w_obs
            z_resid = w_obs * (y - mu)
            sw = torch.sum(wq, dim=1)
            xwq = (xs_std * wq[:, :, None]).transpose(1, 2)
            xwq1 = torch.sum(xwq, dim=2)
            xbar_w = xwq1 / sw[:, None]
            gram = xwq @ xs_std - sw[:, None, None] * (xbar_w[:, :, None] * xbar_w[:, None, :])
            weta = torch.sum(wq * eta, dim=1)
            zsum = torch.sum(z_resid, dim=1)
            cvec = ((xwq @ eta[:, :, None])[:, :, 0]
                    - sw[:, None] * xbar_w * (weta / sw)[:, None]
                    + (xs_std.transpose(1, 2) @ z_resid[:, :, None])[:, :, 0]
                    - xbar_w * zsum[:, None])
            beta_new = cd(gram, cvec, pf_b, lam_b, beta.contiguous(), alpha, thresh)[0][:, 0]
            # Profiled intercept update.
            b0_new = (weta + zsum - torch.sum(xwq1 * beta_new, dim=1)) / sw
            delta = torch.maximum(torch.amax((beta_new - beta) ** 2, dim=1), (b0_new - b0) ** 2)
            beta = torch.where(active[:, None], beta_new, beta)
            b0 = torch.where(active, b0_new, b0)
            it += 1
            active = active & (delta >= thresh10)
            if it >= MAX_IRLS or not bool(active.any()):
                break
        betas.append(beta)
        b0s.append(b0)
    coefs = torch.stack(betas, dim=1) / xs[:, None, :]
    intercepts = torch.stack(b0s, dim=1) - (coefs @ xm[:, :, None])[:, :, 0]
    return ElnetPath(lambdas=lams, intercepts=intercepts, coefs=coefs)


def lognet_binomial(
    x: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None = None,
    penalty_factor: torch.Tensor | None = None,
    alpha: float = 1.0,
    nlambda: int = DEFAULT_NLAMBDA,
    lambdas: torch.Tensor | None = None,
    thresh: float = DEFAULT_THRESH,
) -> ElnetPath:
    """Binomial-logit elastic net (glmnet ``family="binomial"``), on the
    device of ``x``."""
    n, p = x.shape
    w = torch.ones(n, dtype=x.dtype, device=x.device) if weights is None else (
        torch.as_tensor(weights).to(x))
    path = _binomial_batch(x, y, _normalized(w)[None], _penalty(penalty_factor, p, x), alpha,
                           thresh, lambdas, nlambda)
    return ElnetPath(*(t[0] for t in path))


def default_foldid(key: torch.Tensor, n: int, nfolds: int = 10) -> torch.Tensor:
    """The fold assignment :func:`cv_glmnet` derives from ``key`` when no
    ``foldid`` is given: ``jax.random.permutation`` of 1..K repeated to n
    (int64; the JAX package's int32 without x64, the same values). A batch
    of keys (B, 2) gives each lane its own assignment, (B, n)."""
    base = torch.arange(1, nfolds + 1, device=key.device).repeat(-(-n // nfolds))[:n]
    return rnd.permutation(key, base)


def r_compat_foldid(n: int, nfolds: int, rng) -> np.ndarray:
    """cv.glmnet's fold assignment: ``sample(rep(seq(nfolds), length=N))``
    under R's RNG (``utils/rrandom.py::RCompatRNG``; host-side)."""
    base = np.resize(np.arange(1, nfolds + 1), n)
    perm = rng.sample_int(n, n)
    return base[perm]


def _binomial_deviance_loss(y, eta, w):
    """Binomial deviance of ``eta`` (…, n) on the rows weighted by ``w``."""
    mu = torch.sigmoid(eta)
    eps = 1e-10
    ll = y * torch.log(torch.clamp(mu, min=eps)) + (1.0 - y) * torch.log(
        torch.clamp(1.0 - mu, min=eps))
    return -2.0 * torch.sum(w * ll, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=eps)


def cv_glmnet(
    x: torch.Tensor,
    y: torch.Tensor,
    family: str = "gaussian",
    alpha: float = 1.0,
    penalty_factor: torch.Tensor | None = None,
    nfolds: int = 10,
    foldid=None,
    key: torch.Tensor | None = None,
    nlambda: int = DEFAULT_NLAMBDA,
    fold_axis: str | None = None,
) -> CvGlmnetResult:
    """K-fold cross-validated elastic net (R ``cv.glmnet``), on the device
    of ``x``. ``fold_axis`` names the axis of the active mesh
    (``parallel.mesh.get_mesh``, resolved here) that the fold fits shard
    over (:func:`cd_path_sharded`); the result equals the unsharded CV
    bit for bit."""
    mesh = None
    if fold_axis is not None:
        from ate_replication_causalml_torch.parallel.mesh import get_mesh

        mesh = get_mesh()
    return _cv_glmnet_impl(x, y, family, alpha, penalty_factor, nfolds, foldid, key, nlambda,
                           fold_axis, mesh)


def _cv_glmnet_impl(
    x: torch.Tensor,
    y: torch.Tensor,
    family: str = "gaussian",
    alpha: float = 1.0,
    penalty_factor: torch.Tensor | None = None,
    nfolds: int = 10,
    foldid=None,
    key: torch.Tensor | None = None,
    nlambda: int = DEFAULT_NLAMBDA,
    fold_axis: str | None = None,
    mesh=None,
) -> CvGlmnetResult:
    """The body of :func:`cv_glmnet`. ``foldid`` (1-based, as in R) may
    come from :func:`r_compat_foldid`; otherwise folds are drawn from
    ``key`` (``key(0)`` if None). With ``fold_axis`` and ``mesh`` the fits
    shard over that axis of the mesh."""
    if (fold_axis is None) != (mesh is None):
        raise ValueError("fold_axis and mesh are given together")
    return cv_glmnet_many(x, [y], family, alpha, penalty_factor, nfolds, [foldid], [key],
                          nlambda, fold_axis=fold_axis, mesh=mesh)[0]


def cv_glmnet_many(x, ys, family: str = "gaussian", alpha: float = 1.0, penalty_factor=None,
                   nfolds: int = 10, foldids=None, keys=None,
                   nlambda: int = DEFAULT_NLAMBDA, *, fold_axis: str | None = None,
                   mesh=None) -> list[CvGlmnetResult]:
    """:func:`cv_glmnet` of several targets ``ys`` on one design, each with
    its own ``foldids[i]`` or ``keys[i]``: the same fits as one call per
    target, every target's full fit and K fold fits in one batch of
    m·(K + 1) (on the card one launch for the gaussian family). With a
    ``mesh`` the batch's coordinate descent shards over ``fold_axis``
    (:func:`cd_path_sharded`)."""
    if family not in ("gaussian", "binomial"):
        raise ValueError(f"family must be 'gaussian' or 'binomial', got {family!r}")
    n, p = x.shape
    m = len(ys)
    foldids = [None] * m if foldids is None else list(foldids)
    keys = [None] * m if keys is None else list(keys)
    folds = []
    for foldid, key in zip(foldids, keys):
        if foldid is None:
            foldid = default_foldid(rnd.key(0, device=x.device) if key is None else key, n, nfolds)
        elif not isinstance(foldid, torch.Tensor):
            foldid = torch.as_tensor(np.asarray(foldid))
        folds.append(foldid.to(x.device))
    fold_ids = torch.arange(1, nfolds + 1, device=x.device)
    train_w = (torch.stack(folds)[:, None, :] != fold_ids[None, :, None]).to(x.dtype)  # (m, K, n)
    ones = torch.ones((m, 1, n), dtype=x.dtype, device=x.device)
    w = _normalized(torch.cat([ones, train_w], dim=1).reshape(m * (nfolds + 1), n))
    y_fit = torch.stack([torch.as_tensor(t).to(x) for t in ys]).repeat_interleave(nfolds + 1, dim=0)
    lead = torch.arange(m, device=x.device).repeat_interleave(nfolds + 1) * (nfolds + 1)
    if mesh is not None and fold_axis not in mesh.shape:
        raise ValueError(f"fold_axis {fold_axis!r} is not an axis of the active mesh "
                         f"{tuple(mesh.shape)}")
    fit = _gaussian_batch if family == "gaussian" else _binomial_batch
    cd = cd_path if mesh is None else functools.partial(cd_path_sharded, mesh=mesh,
                                                        axis=fold_axis)
    paths = fit(x, y_fit, w, _penalty(penalty_factor, p, x), alpha, DEFAULT_THRESH, None, nlambda,
                lead, cd)
    paths = ElnetPath(*(t.reshape(m, nfolds + 1, *t.shape[1:]) for t in paths))
    eta = paths.intercepts[:, 1:, :, None] + paths.coefs[:, 1:] @ x.T        # (m, K, L, n)
    test_w = 1.0 - train_w
    targets = y_fit.reshape(m, nfolds + 1, n)[:, :1, None, :]                 # (m, 1, 1, n)
    if family == "gaussian":
        losses = (torch.sum(test_w[:, :, None, :] * (targets - eta) ** 2, dim=3)
                  / torch.sum(test_w, dim=2)[:, :, None])
    else:
        losses = _binomial_deviance_loss(targets, eta, test_w[:, :, None, :])
    out = []
    for i in range(m):
        full = ElnetPath(*(t[i, 0] for t in paths))
        cvm, cvsd, idx_min, idx_1se = cv_select(losses[i], torch.sum(test_w[i], dim=1), nfolds)
        out.append(CvGlmnetResult(path=full, cvm=cvm, cvsd=cvsd, lambda_min=full.lambdas[idx_min],
                                  lambda_1se=full.lambdas[idx_1se], index_min=idx_min,
                                  index_1se=idx_1se))
    return out


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 if none), as
    ``jnp.argmax`` of a bool vector."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def cv_select(losses: torch.Tensor, fold_n: torch.Tensor, nfolds: int):
    """cv.glmnet's λ-selection rules (``cvstats``/``getOptcv``): cvm the
    fold-size-weighted mean of the per-fold losses, cvsd =
    sqrt(weighted.mean((cvraw − cvm)², w)/(K−1)); lambda.min the largest
    λ with cvm ≤ min(cvm), lambda.1se the largest with cvm ≤ cvm[min] +
    cvsd[min]: the first indices along the decreasing path.

    losses (K, L), fold_n (K,) → (cvm (L,), cvsd (L,), idx_min, idx_1se);
    with a leading batch axis, (B, K, L) and (B, K) → (B, L), (B, L),
    (B,), (B,), each lane its own selection."""
    wts = (fold_n / torch.sum(fold_n, dim=-1, keepdim=True))[..., None]
    cvm = torch.sum(wts * losses, dim=-2)
    cvsd = torch.sqrt(torch.sum(wts * (losses - cvm[..., None, :]) ** 2, dim=-2)
                      / torch.tensor(nfolds - 1, dtype=losses.dtype, device=losses.device))
    idx_min = _first_true(cvm == torch.amin(cvm, dim=-1, keepdim=True))
    at_min = lambda t: torch.gather(t, -1, idx_min[..., None])
    idx_1se = _first_true(cvm <= at_min(cvm) + at_min(cvsd))
    return cvm, cvsd, idx_min, idx_1se


def cv_glmnet_lanes(x: torch.Tensor, y: torch.Tensor, penalty_factor=None, foldids=None,
                    nfolds: int = 10, nlambda: int = DEFAULT_NLAMBDA,
                    alpha: float = 1.0) -> CvGlmnetResult:
    """Gaussian :func:`cv_glmnet` of B lanes, each with its own design and
    folds: x (B, n, p), y (B, n), foldids (B, n) 1-based. Every lane's
    full fit and K fold fits go to one batch of B·(K + 1) (on the card one
    :func:`cd_path` launch). Returns the result with a leading lane axis
    on every field (``path`` (B, L, …), ``cvm`` (B, L), the indices
    (B,)): ``vmap(cv_glmnet)``, which :func:`cv_glmnet_many` (one shared
    design) is not."""
    n_lanes, n, p = x.shape
    foldids = torch.as_tensor(foldids).to(x.device)
    fold_ids = torch.arange(1, nfolds + 1, device=x.device)
    train_w = (foldids[:, None, :] != fold_ids[None, :, None]).to(x.dtype)     # (B, K, n)
    ones = torch.ones((n_lanes, 1, n), dtype=x.dtype, device=x.device)
    w = _normalized(torch.cat([ones, train_w], dim=1).reshape(n_lanes * (nfolds + 1), n))
    lead = torch.arange(n_lanes, device=x.device).repeat_interleave(nfolds + 1) * (nfolds + 1)
    paths = _gaussian_batch(x.repeat_interleave(nfolds + 1, dim=0),
                            y.repeat_interleave(nfolds + 1, dim=0), w,
                            _penalty(penalty_factor, p, x[0]), alpha, DEFAULT_THRESH, None,
                            nlambda, lead)
    paths = ElnetPath(*(t.reshape(n_lanes, nfolds + 1, *t.shape[1:]) for t in paths))
    eta = paths.intercepts[:, 1:, :, None] + paths.coefs[:, 1:] @ x.transpose(1, 2)[:, None]
    test_w = 1.0 - train_w
    fold_n = torch.sum(test_w, dim=2)
    losses = (torch.sum(test_w[:, :, None, :] * (y[:, None, None, :] - eta) ** 2, dim=3)
              / fold_n[:, :, None])
    cvm, cvsd, idx_min, idx_1se = cv_select(losses, fold_n, nfolds)
    full = ElnetPath(*(t[:, 0] for t in paths))
    at = lambda idx: torch.gather(full.lambdas, -1, idx[:, None])[:, 0]
    return CvGlmnetResult(path=full, cvm=cvm, cvsd=cvsd, lambda_min=at(idx_min),
                          lambda_1se=at(idx_1se), index_min=idx_min, index_1se=idx_1se)


def predict_path(path: ElnetPath, x: torch.Tensor, index) -> torch.Tensor:
    """Linear predictor at one path index."""
    return path.intercepts[index] + x @ path.coefs[index]
