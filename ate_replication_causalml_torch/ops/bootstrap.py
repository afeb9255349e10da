"""Bootstrap resampling engine for the AIPW standard error.

Port of ``ate_replication_causalml_tpu/ops/bootstrap.py``
(:func:`aipw_bootstrap_se_sharded`: the replicates sharded over a mesh's
``boot`` axis, one rank a card). The reference's SE is
a serial R loop of B=1000 replicates (``ate_functions.R:188-195``), each
a with-replacement resample of five precomputed vectors followed by two
means (``ate_functions.R:267-283`` — nuisances are not refit). Here the
replicates run as a batch:

  * R-compat: ``indices`` precomputed on the host (``utils.rrandom``);
  * exact multinomial: threefry ``randint`` index draws + gather (the
    default up to 100k rows);
  * Poisson bootstrap: per-(replicate, row) Poisson(1) counts and a
    count-weighted mean (the large-n default; Chamandy et al. 2012).

The random draws are the JAX package's threefry streams bit for bit
(``ops/random.py``), so the same key resamples the same rows.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ate_replication_causalml_torch.ops import random as rnd


def bootstrap_indices(key: torch.Tensor, n: int, n_boot: int) -> torch.Tensor:
    """(B, n) with-replacement row indices from the threefry stream."""
    return rnd.randint(key, (n_boot, n), 0, n)


def _est1(w, y, p, mu0, mu1, control_sign):
    return w * (y - mu1) / p + control_sign * (1.0 - w) * (y - mu0) / (1.0 - p)


def _aipw_tau(w, y, p, mu0, mu1, control_sign=1.0):
    """The reference's AIPW combination (``ate_functions.R:183-185``):
    ``mean(w(y-mu1)/p + (1-w)(y-mu0)/(1-p)) + mean(mu1 - mu0)`` with
    R's ``na.rm=TRUE`` on the first mean.

    ``control_sign`` +1.0 reproduces the reference's sign quirk (it ADDS
    the control augmentation; ``compat="r"``), −1.0 is textbook AIPW
    (``compat="fixed"``). See the JAX package's ``_aipw_tau``."""
    est1 = _est1(w, y, p, mu0, mu1, control_sign)
    return torch.nanmean(est1, dim=-1) + torch.mean(mu1 - mu0, dim=-1)


def aipw_bootstrap_taus(indices, w, y, p, mu0, mu1, control_sign=1.0):
    """All replicates at once over a (B, n) index matrix."""
    idx = torch.as_tensor(indices, device=w.device).long()
    return _aipw_tau(w[idx], y[idx], p[idx], mu0[idx], mu1[idx], control_sign)


def sd(x: torch.Tensor) -> torch.Tensor:
    """R ``sd()``: n-1 denominator (``ate_functions.R:195``)."""
    return torch.std(x, correction=1)


# Above this row count the exact-gather path switches to Poisson weights.
POISSON_AUTO_THRESHOLD = 100_000


def aipw_bootstrap_se(
    w, y, p, mu0, mu1,
    *,
    key: torch.Tensor | None = None,
    n_boot: int = 1000,
    indices=None,
    style: str = "auto",
    chunk: int | None = None,
    control_sign: float = 1.0,
) -> torch.Tensor:
    """Bootstrap SE of the AIPW estimator.

    Pass ``indices`` (B, n) for the R-compat stream, or ``key`` for the
    threefry path. ``style``: 'auto' (multinomial up to
    ``POISSON_AUTO_THRESHOLD`` rows, Poisson above), 'multinomial', or
    'poisson'. ``chunk`` replicates draw from one key (the JAX
    package's chunk rule, so the same key gives the same replicates).
    """
    if indices is not None:
        return sd(aipw_bootstrap_taus(indices, w, y, p, mu0, mu1, control_sign))
    if key is None:
        raise ValueError("provide either key= or indices=")
    n = w.shape[0]
    if style == "auto":
        style = "poisson" if n > POISSON_AUTO_THRESHOLD else "multinomial"
    if chunk is None:
        chunk = n_boot if n * n_boot <= 2**27 else max(1, 2**27 // n)
        while n_boot % chunk:
            chunk -= 1
    if style == "poisson":
        fn = aipw_bootstrap_taus_poisson
    elif style == "multinomial":
        fn = aipw_bootstrap_taus_chunked
    else:
        raise ValueError(f"unknown bootstrap style {style!r}")
    taus = fn(w, y, p, mu0, mu1, key=key, n_boot=n_boot, chunk=chunk,
              control_sign=control_sign)
    return sd(taus)


# Poisson(1) CDF through count 11 — P(X > 11) < 3e-9, far below any
# bootstrap resolution; counts are generated by compares against these
# thresholds on the raw uint32 lattice (the JAX package's table, copied).
_POIS1_CDF = tuple(
    float(s)
    for s in itertools.accumulate(
        2.718281828459045**-1 / math.factorial(j) for j in range(12)
    )
)
_POIS1_CDF_U32 = tuple(
    int(np.uint32(min(t, 1.0 - 2.0**-32) * 2.0**32)) for t in _POIS1_CDF
)


def _poisson1_counts(key: torch.Tensor, shape) -> torch.Tensor:
    """Poisson(1) counts as float32, from ``bits(key, shape)``; a batch
    of keys (..., 2) draws a batch of count vectors (..., *shape)."""
    b = rnd.bits(key, shape)
    c = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    for t in _POIS1_CDF_U32:
        c += (b > t).to(torch.float32)
    return c


def aipw_bootstrap_taus_poisson(
    w, y, p, mu0, mu1, *, key: torch.Tensor, n_boot: int, chunk: int = 25,
    control_sign: float = 1.0,
) -> torch.Tensor:
    """Poisson-bootstrap replicate taus (the large-n path), with R's
    ``na.rm=TRUE`` semantics on the est1 term: NaN entries are left out
    of both the numerator and the count, ±Inf propagate."""
    if n_boot % chunk:
        raise ValueError(f"n_boot={n_boot} must be a multiple of chunk={chunk}")
    est1 = _est1(w, y, p, mu0, mu1, control_sign)
    notnan = ~torch.isnan(est1)
    e1 = torch.where(notnan, est1, torch.zeros_like(est1))
    fin = notnan.to(e1.dtype)
    est2 = mu1 - mu0
    taus = []
    for k in rnd.split(key, n_boot // chunk):
        c = _poisson1_counts(k, (chunk, e1.shape[0])).to(e1.dtype)
        taus.append((c @ e1) / (c @ fin) + (c @ est2) / c.sum(dim=1))
    return torch.cat(taus)


def aipw_bootstrap_taus_chunked(
    w, y, p, mu0, mu1, *, key: torch.Tensor, n_boot: int, chunk: int = 32,
    control_sign: float = 1.0,
) -> torch.Tensor:
    """Multinomial replicate taus with bounded memory: each chunk of
    replicates draws its own (chunk, n) index block from its own key."""
    if n_boot % chunk:
        raise ValueError(f"n_boot={n_boot} must be a multiple of chunk={chunk}")
    n = w.shape[0]
    est1 = _est1(w, y, p, mu0, mu1, control_sign)
    est2 = mu1 - mu0
    taus = []
    for k in rnd.split(key, n_boot // chunk):
        idx = rnd.randint(k, (chunk, n), 0, n).long()
        taus.append(torch.nanmean(est1[idx], dim=1) + torch.mean(est2[idx], dim=1))
    return torch.cat(taus)


def aipw_bootstrap_se_sharded(
    w, y, p, mu0, mu1,
    *,
    key: torch.Tensor,
    n_boot: int = 10_000,
    axis_name: str = "boot",
    chunk: int | None = None,
    style: str = "auto",
    control_sign: float = 1.0,
    return_taus: bool = False,
):
    """Mesh-parallel bootstrap SE: replicates shard over ``axis_name`` of
    the active mesh (``parallel.mesh.get_mesh``).

    Rank r of the axis draws ``n_boot / A`` replicates from
    ``fold_in(key, r)`` against the whole (replicated) data vectors, the
    taus are all-gathered in rank order and the SD is taken over them:
    the JAX package's sharded bootstrap, whose only collective is that
    gather of B scalars. ``n_boot`` must divide evenly over the axis.
    ``return_taus`` also returns the gathered taus."""
    from ate_replication_causalml_torch.parallel.mesh import all_gather_cat, get_mesh

    mesh = get_mesh()
    n_dev = mesh.shape[axis_name]
    if n_boot % n_dev:
        raise ValueError(f"n_boot={n_boot} must divide evenly over {n_dev} devices")
    per_dev = n_boot // n_dev
    n = w.shape[0]
    if style == "auto":
        style = "poisson" if n > POISSON_AUTO_THRESHOLD else "multinomial"
    if chunk is None:
        chunk = per_dev if n * per_dev <= 2**27 else max(1, 2**27 // n)
        while per_dev % chunk:
            chunk -= 1
    if style == "poisson":
        fn = aipw_bootstrap_taus_poisson
    elif style == "multinomial":
        fn = aipw_bootstrap_taus_chunked
    else:
        raise ValueError(f"unknown bootstrap style {style!r}")
    my_key = rnd.fold_in(key.to(w.device), mesh.coord(axis_name))
    taus = fn(w, y, p, mu0, mu1, key=my_key, n_boot=per_dev, chunk=chunk,
              control_sign=control_sign)
    taus = all_gather_cat(taus, mesh, axis_name)
    return (sd(taus), taus) if return_taus else sd(taus)
