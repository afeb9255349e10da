"""The balancing QP (``ops/qp.py``) against the JAX package on the CPU,
and the JAX package's scipy-oracle checks (``tests/test_qp_balance.py``)
applied to the port.

Bounds, each with its reason:

* the two bisections: float64 |Δ| ≤ 1e-13, float32 |Δ| ≤ 1e-6 (values
  of order 1). Both packages take the same 64 steps from the same
  brackets; their sums of up to 9,000 terms round in another order, so a
  step whose sum lies within rounding of its target may go the other
  way, and the roots then differ by that rounding over the number of
  active terms (largest seen: 1.8e-15 in float64, 0 in float32);
* ``balance_qp`` and ``balance_qp_x64``: ``iters`` equal, γ |Δ| ≤ 1e-11
  and z |Δ| ≤ 1e-9.
  The iterations agree to rounding (the same ops in float64, matrix
  products and sums in another order) and the ρ decisions and the stop
  are taken at the same iterations, so the iterates differ by rounding
  carried through a few hundred contracting steps (largest seen: γ
  7.2e-14, z 1.4e-11 at n = 2,000, k = 21). Were a stop decided an
  iteration apart, ``iters`` would differ and the test would say so.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import qp as tqp
from ate_replication_causalml_tpu.ops import qp as jqp

BISECT = {np.float64: 1e-13, np.float32: 1e-6}
GAMMA_BOUND, Z_BOUND = 1e-11, 1e-9
TDT = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file: the ADMM's small float64
    matrix-vector products, multithreaded on a CPU the suite's parallel
    workers keep busy, wait on their threads (one n = 4,000 solve on an
    8-core CPU beside five busy processes: 5.3 s on one thread, 59.5 s on
    eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [5, 50, 2000, 9000])
def test_bisections_equal_jax(n, dt):
    """project_capped_simplex without a cap and with two caps, and
    prox_sq_inf_norm at three scales, in both dtypes."""
    rng = np.random.default_rng(n)
    with jax.enable_x64(dt == np.float64):
        for ub in (math.inf, 0.05, 3.0 / n):
            v = (rng.normal(size=n) * 2).astype(dt)
            ref = np.asarray(jqp.project_capped_simplex(jnp.asarray(v), ub))
            got = tqp.project_capped_simplex(torch.as_tensor(v), ub)
            assert got.dtype == TDT[dt]
            assert np.max(np.abs(got.numpy() - ref)) <= BISECT[dt], (ub, np.abs(got.numpy() - ref).max())
        for scale in (0.01, 0.7, 30.0):
            d = (rng.normal(size=n) * 3).astype(dt)
            ref = np.asarray(jqp.prox_sq_inf_norm(jnp.asarray(d), jnp.asarray(scale, dt)))
            got = tqp.prox_sq_inf_norm(torch.as_tensor(d), torch.tensor(scale, dtype=TDT[dt]))
            assert got.dtype == TDT[dt]
            assert np.max(np.abs(got.numpy() - ref)) <= BISECT[dt], scale


def _arm(n, k, seed, shift):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)) + shift
    target = x.mean(axis=0) + rng.normal(size=k) * (0.3 if shift else 0.03)
    return x, target


@pytest.mark.parametrize("n,k,seed,shift,max_iters", [
    (40, 4, 0, 0.0, 4000),
    (300, 6, 1, 0.0, 4000),
    (2000, 21, 2, 0.2, 4000),     # a shifted arm at the notebook's width
    (300, 6, 4, 0.0, 600),        # the sweep's MICRO budget: ρ frozen at 300
])
def test_balance_qp_equals_jax(n, k, seed, shift, max_iters):
    """balance_qp on float64 arms in both packages."""
    x, target = _arm(n, k, seed, shift)
    ref = jqp.balance_qp(jnp.asarray(x), jnp.asarray(target), max_iters=max_iters)
    got = tqp.balance_qp(torch.as_tensor(x), torch.as_tensor(target), max_iters=max_iters)
    assert got.iters == int(ref.iters) < max_iters
    assert np.max(np.abs(got.gamma.numpy() - np.asarray(ref.gamma))) <= GAMMA_BOUND
    assert np.max(np.abs(got.z.numpy() - np.asarray(ref.z))) <= Z_BOUND
    for mine, theirs in ((got.primal_resid, ref.primal_resid), (got.dual_resid, ref.dual_resid)):
        assert float(mine) <= 1e-7 and float(theirs) <= 1e-7
    if max_iters == 600:      # the run goes past the freeze point
        assert got.iters > 300


def test_balance_qp_x64_returns_float64_for_float32_input():
    x, target = _arm(300, 6, 3, 0.4)
    got = tqp.balance_qp_x64(torch.as_tensor(x, dtype=torch.float32),
                             torch.as_tensor(target, dtype=torch.float32))
    assert got.gamma.dtype == got.z.dtype == got.primal_resid.dtype == torch.float64
    ref = jqp.balance_qp_x64(x.astype(np.float32), target.astype(np.float32))
    assert got.iters == int(ref.iters)
    assert np.max(np.abs(got.gamma.numpy() - np.asarray(ref.gamma))) <= GAMMA_BOUND


@pytest.mark.parametrize("max_iters", [1, 2, 7, 40])
def test_short_budget_freezes_rho_at_half(max_iters):
    """adapt_iters = min(500, max_iters // 2): a budget the run exhausts,
    in both packages, with the same last residuals (ρ frozen at 0, 1, 3
    and 20)."""
    x, target = _arm(200, 5, 6, 0.5)
    ref = jqp.balance_qp_x64(x, target, max_iters=max_iters)
    got = tqp.balance_qp_x64(torch.as_tensor(x), torch.as_tensor(target), max_iters=max_iters)
    assert got.iters == int(ref.iters) == max_iters
    for mine, theirs in ((got.primal_resid, ref.primal_resid), (got.dual_resid, ref.dual_resid)):
        assert abs(float(mine) - float(theirs)) <= 1e-12 * (1 + abs(float(theirs)))
    assert np.max(np.abs(got.gamma.numpy() - np.asarray(ref.gamma))) <= GAMMA_BOUND


# The JAX package's scipy-oracle checks, on the port.

def test_simplex_projection_matches_bruteforce():
    from scipy.optimize import minimize

    rng = np.random.default_rng(0)
    for _ in range(5):
        v = rng.normal(size=50)
        g = tqp.project_capped_simplex(torch.as_tensor(v)).numpy()
        assert abs(g.sum() - 1.0) < 1e-8
        assert (g >= -1e-12).all()
        ref = minimize(lambda z: 0.5 * np.sum((z - v) ** 2), np.full(50, 1 / 50),
                       constraints=[{"type": "eq", "fun": lambda z: z.sum() - 1.0}],
                       bounds=[(0, None)] * 50, method="SLSQP")
        assert np.allclose(g, ref.x, atol=1e-6)


def test_simplex_projection_with_cap():
    v = torch.tensor([10.0, 0.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    g = tqp.project_capped_simplex(v, ub=0.4).numpy()
    assert abs(g.sum() - 1.0) < 1e-8
    assert g.max() <= 0.4 + 1e-8
    assert g[0] == pytest.approx(0.4, abs=1e-8)


def test_prox_sq_inf_norm_stationarity():
    rng = np.random.default_rng(1)
    d = rng.normal(size=30) * 3
    scale = 0.7
    q = tqp.prox_sq_inf_norm(torch.as_tensor(d), torch.tensor(scale, dtype=torch.float64)).numpy()
    t = np.abs(q).max()
    assert 2 * scale * t == pytest.approx(np.maximum(np.abs(d) - t, 0).sum(), rel=1e-5, abs=1e-7)
    obj = lambda z: scale * np.max(np.abs(z)) ** 2 + 0.5 * np.sum((z - d) ** 2)
    assert obj(q) <= obj(d) + 1e-9
    assert obj(q) <= obj(0.5 * d) + 1e-9


def test_balance_qp_matches_scipy_reference():
    """The ADMM optimum against scipy SLSQP on the epigraph form of the
    same QP (the value is unique, the argmin may not be)."""
    from scipy.optimize import minimize

    rng = np.random.default_rng(2)
    n, k, zeta = 40, 4, 0.5
    x = rng.normal(size=(n, k))
    target = rng.normal(size=k) * 0.3
    xt, mt = torch.as_tensor(x), torch.as_tensor(target)
    sol = tqp.balance_qp(xt, mt, zeta=zeta, max_iters=20000, tol=1e-10)
    ours = float(tqp.balance_objective(xt, mt, sol.gamma, zeta))

    def obj(z):
        return zeta * np.sum(z[:n] ** 2) + (1 - zeta) * z[n] ** 2

    cons = [{"type": "eq", "fun": lambda z: z[:n].sum() - 1.0},
            {"type": "ineq", "fun": lambda z: z[n] - (x.T @ z[:n] - target)},
            {"type": "ineq", "fun": lambda z: z[n] + (x.T @ z[:n] - target)}]
    ref = minimize(obj, np.concatenate([np.full(n, 1 / n), [1.0]]), constraints=cons,
                   bounds=[(0, None)] * (n + 1), method="SLSQP",
                   options={"maxiter": 500, "ftol": 1e-12})
    assert ref.success
    assert ours == pytest.approx(float(ref.fun), rel=2e-3, abs=1e-6)
    assert abs(float(torch.sum(sol.gamma)) - 1.0) < 1e-6


def test_approx_balance_balances_covariates():
    from ate_replication_causalml_torch.estimators.balance import approx_balance

    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 6)) + 0.8
    target = np.zeros(6)
    gamma = approx_balance(torch.as_tensor(x), torch.as_tensor(target))
    assert gamma.dtype == torch.float32
    gamma = gamma.numpy().astype(np.float64)
    assert np.abs(x.T @ gamma - target).max() < 0.5 * np.abs(x.mean(axis=0) - target).max()
    assert gamma.min() >= -1e-10


def test_balance_qp_x64_converges_at_notebook_scale():
    """4,000 rows × 21 shifted covariates in float32: the float64 solve
    with ρ adaptation reaches the 1e-7 tolerance in well under 2,000
    iterations."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4000, 21)).astype(np.float32) + 0.4
    sol = tqp.balance_qp_x64(torch.as_tensor(x), torch.zeros(21), zeta=0.5, max_iters=4000)
    assert sol.iters < 2000, sol.iters
    assert float(torch.maximum(sol.primal_resid, sol.dual_resid)) <= 1e-7
    assert sol.gamma.dtype == torch.float64
    assert abs(float(torch.sum(sol.gamma)) - 1.0) < 1e-9
