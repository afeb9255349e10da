"""ops/linalg.py against the JAX package: ``ols``, ``wls`` and
``ols_no_intercept_1d`` on the same numpy inputs, and ``alias_filter``.

Bounds. Both packages form the same normal equations and Cholesky
solves; they differ only by summation order in the Gram matrices and the
solve. Per output: float32 |Δ| ≤ 2e-6 + 2e-5·|ref| (largest seen: 7.7e-7
on a coefficient, 2.4e-6 on a residual), float64 |Δ| ≤ 1e-13 +
1e-11·|ref| (largest seen: 3.6e-15 on a residual, 8.9e-16 on a
coefficient). The index
arrays of ``alias_filter`` (host-side float64 numpy in both) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import linalg as tl
from ate_replication_causalml_tpu.ops import linalg as jl

TOL = {np.float32: (2e-6, 2e-5), np.float64: (1e-13, 1e-11)}


def _close(got, ref, dt, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    a, r = TOL[dt]
    assert got.shape == ref.shape, what
    assert np.all(np.abs(got - ref) <= a + r * np.abs(ref)), (
        what, float(np.max(np.abs(got - ref))))


def _design(seed, n=600, p=8):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    x[:, 3] = (x[:, 3] > 0.2)  # a binary column
    beta = rng.normal(size=p)
    y = x @ beta + 0.5 * rng.normal(size=n)
    wts = rng.uniform(0.2, 5.0, size=n)
    return x, y, wts


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ols_wls_equal_jax(dt):
    x, y, wts = (a.astype(dt) for a in _design(1))
    with jax.enable_x64(dt == np.float64):
        jo = jl.ols(jnp.asarray(x), jnp.asarray(y))
        jr = jl.ols(jnp.asarray(x), jnp.asarray(y), ridge=1e-3)
        jw = jl.wls(jnp.asarray(x), jnp.asarray(y), jnp.asarray(wts))
        ref = {name: {k: np.asarray(getattr(r, k)) for k in jl.LstsqResult._fields}
               for name, r in (("ols", jo), ("ridge", jr), ("wls", jw))}
    tx, ty, tw = (torch.as_tensor(a) for a in (x, y, wts))
    got = {"ols": tl.ols(tx, ty), "ridge": tl.ols(tx, ty, ridge=1e-3), "wls": tl.wls(tx, ty, tw)}
    assert tl.LstsqResult._fields == jl.LstsqResult._fields
    for name, r in got.items():
        for k in tl.LstsqResult._fields:
            v = getattr(r, k)
            assert v.dtype == tx.dtype, (name, k)
            _close(v.numpy(), ref[name][k], dt, f"{name}.{k}")


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ols_no_intercept_1d_equal_jax(dt):
    rng = np.random.default_rng(2)
    x = (rng.random(5000) - 0.4).astype(dt)
    y = (0.3 * x + 0.2 * rng.normal(size=5000)).astype(dt)
    with jax.enable_x64(dt == np.float64):
        jc, js = (float(v) for v in jl.ols_no_intercept_1d(jnp.asarray(x), jnp.asarray(y)))
    tc, ts = tl.ols_no_intercept_1d(torch.as_tensor(x), torch.as_tensor(y))
    _close(float(tc), jc, dt, "coef")
    _close(float(ts), js, dt, "se")


def test_alias_filter_equal_jax():
    """A constant column, an exact collinear combination, a near-copy
    below the tolerance and a zero column alias away as in R's ``lm``;
    the kept indices equal the JAX package's, with and without the
    intercept, for numpy and tensor input."""
    rng = np.random.default_rng(3)
    n = 200
    a = rng.normal(size=(n, 4))
    cols = np.column_stack([
        a[:, 0], np.full(n, 3.0), a[:, 1], a[:, 0] + 2 * a[:, 1], a[:, 2],
        a[:, 2] * (1 + 1e-12), np.zeros(n), a[:, 3],
    ])
    for with_intercept in (True, False):
        ref = jl.alias_filter(cols, with_intercept=with_intercept)
        for arg in (cols, torch.as_tensor(cols, dtype=torch.float32), torch.as_tensor(cols)):
            got = tl.alias_filter(arg, with_intercept=with_intercept)
            assert got.dtype == np.int64 and np.array_equal(got, ref)
    assert np.array_equal(tl.alias_filter(cols), [0, 2, 4, 7])
    assert np.array_equal(tl.alias_filter(cols, with_intercept=False), [0, 1, 2, 4, 7])
