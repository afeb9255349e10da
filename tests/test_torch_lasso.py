"""The LASSO core (``ops/lasso.py``) and ``ops/random.py::permutation``
against the JAX package on the CPU: the same numpy inputs go through
``ate_replication_causalml_tpu.ops.lasso`` and its port (the plain
coordinate descent; the card kernel is held to it in
``tests/test_torch_kernels.py``).

Exact contracts (``array_equal``): the permutation (jax's sort-based
``_shuffle``: rounds, keys and the stable tie order), the fold ids, the
``lambda_sequence`` exponents, ``cv_select``'s indices on identical
losses, and every ``cv_glmnet``'s selected indices.

Bounds, each with its reason:

* λ path from one λ_max: ≤ 2 ulps (the exponents are jnp.linspace's
  exactly; ``exp`` is the library's, XLA's or PyTorch's);
* path coefficients and intercepts: float64 |Δ| ≤ 1e-10·(1 + |ref|);
  float32 |Δ| ≤ 5e-4·(1 + |ref|). The two packages reduce the Gram
  products and the dot products G_j·β in other orders. In float64 that
  stays at rounding level (seen: 2e-15). In float32 the sweeps stop once
  max_j G_jj·Δβ_j² < 1e-7, and two runs whose rounding differs can stop
  a sweep apart, which moves a standardized coefficient by up to
  sqrt(1e-7) ≈ 3.2e-4 (seen: 7e-7 here, 2.6e-4 on Belloni's 462-column
  path at the notebook's size, ``scripts/torch_parity.py``);
* cvm, cvsd: float64 1e-10 relative, float32 1e-4 relative (the fold
  losses of those paths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import lasso as tl
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.utils.rrandom import RCompatRNG as TRCompat
from ate_replication_causalml_tpu.ops import lasso as jl
from ate_replication_causalml_tpu.utils.rrandom import RCompatRNG as JRCompat
from test_lasso import _oracle_cvstats, _oracle_getoptcv

DTYPES = {np.float32: torch.float32, np.float64: torch.float64}
PATH_TOL = {np.float32: 5e-4, np.float64: 1e-10}
CV_TOL = {np.float32: 1e-4, np.float64: 1e-10}


def _x64(dt):
    return jax.enable_x64(dt == np.float64)


def _keys(seed):
    """(jax key, port key) for one seed."""
    return jax.random.key(seed), rnd.key(seed, device="cpu")


# ---- permutation ---------------------------------------------------------


@pytest.mark.parametrize("n,rounds", [(1, 0), (2, 1), (1000, 1), (11016, 2), (50000, 2)])
def test_permutation_equals_jax(n, rounds):
    """``permutation(key, n)`` and of an array, over many keys; 11,016 and
    50,000 take two sort rounds."""
    assert rnd.shuffle_rounds(n) == rounds
    base = np.resize(np.arange(1, 11), n)
    for seed in (0, 1, 7, 12325, 1991, 2**32 + 3, 2**40 + 12345):
        jk, tk = _keys(seed)
        assert np.array_equal(rnd.permutation(tk, n).numpy(),
                              np.asarray(jax.random.permutation(jk, n))), seed
        assert np.array_equal(rnd.permutation(tk, torch.as_tensor(base)).numpy(),
                              np.asarray(jax.random.permutation(jk, jnp.asarray(base)))), seed


def _first_tie_seed(n, round_):
    """The first seed whose sort keys tie in the given round at length n."""
    for seed in range(1000):
        k = rnd.key(seed, device="cpu")
        for r in range(round_ + 1):
            k, sub = rnd.split(k).unbind(dim=-2)
        draws = rnd.bits(sub, (n,))
        if torch.unique(draws).numel() < n:
            return seed
    raise AssertionError("no tie found")


@pytest.mark.parametrize("round_,seed", [(0, 38), (1, 104)])
def test_permutation_ties_keep_jax_order(round_, seed):
    """32-bit sort keys tie (about 1.4% of draws at 11,016): the first
    seeds whose draw ties, in the first sort round (key(38)) and in the
    second (key(104)), give jax's permutation, which a stable sort keeps."""
    n = 11016
    assert _first_tie_seed(n, round_) == seed
    jk, tk = _keys(seed)
    assert np.array_equal(rnd.permutation(tk, n).numpy(), np.asarray(jax.random.permutation(jk, n)))


# ---- fold ids ------------------------------------------------------------


@pytest.mark.parametrize("n,nfolds", [(11016, 10), (500, 10), (103, 3), (7, 5)])
def test_default_foldid_equals_jax(n, nfolds):
    for seed in (0, 3, 12325):
        jk, tk = _keys(seed)
        got = tl.default_foldid(tk, n, nfolds).numpy()
        assert np.array_equal(got, np.asarray(jl.default_foldid(jk, n, nfolds)))
        assert np.array_equal(np.bincount(got, minlength=nfolds + 1)[1:],
                              np.bincount(np.resize(np.arange(1, nfolds + 1), n))[1:])


@pytest.mark.parametrize("n,nfolds", [(400, 10), (97, 3)])
def test_r_compat_foldid_equals_jax(n, nfolds):
    for seed in (1991, 42):
        assert np.array_equal(tl.r_compat_foldid(n, nfolds, TRCompat(seed)),
                              jl.r_compat_foldid(n, nfolds, JRCompat(seed)))


# ---- λ path --------------------------------------------------------------


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("n,p", [(400, 10), (10, 40)])
def test_lambda_sequence_within_two_ulps(dt, n, p):
    for lam_max in (0.3172, 1.0, 17.5):
        with _x64(dt):
            ref = np.asarray(jl.lambda_sequence(jnp.asarray(lam_max, dt), n, p))
        got = tl.lambda_sequence(torch.tensor(lam_max, dtype=DTYPES[dt]), n, p).numpy()
        assert got.dtype == ref.dtype and got.shape == (tl.DEFAULT_NLAMBDA,)
        assert got[0] == ref[0]
        assert np.all(np.abs(got - ref) <= 2 * np.spacing(np.abs(ref))), np.max(
            np.abs(got - ref) / np.spacing(np.abs(ref)))


# ---- paths ---------------------------------------------------------------


def _problem(seed, n=300, p=8, dt=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, p) + rng.normal(size=p)
    beta = np.zeros(p)
    beta[:4] = [2.0, -1.5, 1.0, 0.5]
    y = x @ beta + rng.normal(size=n)
    w = (rng.random(n) < 1 / (1 + np.exp(-(x[:, 0] - x[:, 0].mean()) / x[:, 0].std()))).astype(float)
    folds = np.resize(np.arange(1, 6), n)[rng.permutation(n)]
    return x.astype(dt), y.astype(dt), w.astype(dt), folds


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.all(np.abs(got - ref) <= tol * (1 + np.abs(ref))), (
        what, float(np.max(np.abs(got - ref))))


def _same_path(got, ref, dt, what):
    _close(got.lambdas.numpy(), ref.lambdas, 4 * np.finfo(dt).eps if dt == np.float64 else 1e-5,
           f"{what} lambdas")
    _close(got.intercepts.numpy(), ref.intercepts, PATH_TOL[dt], f"{what} intercepts")
    _close(got.coefs.numpy(), ref.coefs, PATH_TOL[dt], f"{what} coefs")


CASES = {  # name -> (weights, penalty factor)
    "plain": (None, None),
    "weighted_zero_pf": ("fold", "zero"),
}


def _case(name, x, folds):
    wkind, pkind = CASES[name]
    weights = (folds != 2).astype(x.dtype) if wkind else None
    pf = None
    if pkind:
        pf = np.ones(x.shape[1], x.dtype)
        pf[[0, -1]] = 0.0
    return weights, pf


# Each family unweighted with free penalties and with fold weights and
# zero penalty factors, in the other dtype each time.
PATH_CASES = [("gaussian", "plain", np.float64), ("gaussian", "weighted_zero_pf", np.float32),
              ("binomial", "plain", np.float32), ("binomial", "weighted_zero_pf", np.float64)]


@pytest.mark.parametrize("family,case,dt", PATH_CASES)
def test_paths_equal_jax(family, case, dt):
    """``elnet_gaussian`` / ``lognet_binomial`` with and without fold
    weights and zero penalty factors, and on the other's λs."""
    x, y, w, folds = _problem(11, dt=dt)
    target = y if family == "gaussian" else w
    weights, pf = _case(case, x, folds)
    jfit = jl.elnet_gaussian if family == "gaussian" else jl.lognet_binomial
    tfit = tl.elnet_gaussian if family == "gaussian" else tl.lognet_binomial
    as_j = lambda a: None if a is None else jnp.asarray(a)
    as_t = lambda a: None if a is None else torch.as_tensor(a)
    with _x64(dt):
        ref = jfit(jnp.asarray(x), jnp.asarray(target), as_j(weights), as_j(pf))
        ref = jl.ElnetPath(*(np.asarray(a) for a in ref))
        given = jfit(jnp.asarray(x), jnp.asarray(target), None, as_j(pf), 1.0, 100,
                     jnp.asarray(ref.lambdas[::7].copy()))
        given = jl.ElnetPath(*(np.asarray(a) for a in given))
    got = tfit(torch.as_tensor(x), torch.as_tensor(target), as_t(weights), as_t(pf))
    assert got.coefs.dtype == DTYPES[dt]
    _same_path(got, ref, dt, case)
    got = tfit(torch.as_tensor(x), torch.as_tensor(target), None, as_t(pf), 1.0, 100,
               torch.as_tensor(ref.lambdas[::7].copy()))
    _same_path(got, given, dt, f"{case} on given lambdas")
    if pf is not None:  # a zero penalty factor is never shrunk
        assert np.all(got.coefs.numpy()[:, [0, -1]] != 0)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_cd_path_plain_equals_jax_cd_sweeps(dt):
    """The plain coordinate descent against the JAX package's
    ``_cd_sweeps`` scanned down one λ path, on one Gram system, with a
    zero penalty factor and an elastic-net α."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(200, 6))
    a = (a - a.mean(0)) / a.std(0)
    gram = (a.T @ a / 200).astype(dt)
    xty = (a.T @ (a[:, 0] - a[:, 3] + rng.normal(size=200)) / 200).astype(dt)
    pf = np.array([1.2, 1.2, 1.2, 1.2, 1.2, 0.0], dt)
    lams = (np.abs(xty).max() * np.exp(np.linspace(0, np.log(1e-3), 30))).astype(dt)
    for alpha in (1.0, 0.5):
        with _x64(dt):
            def step(beta, lam):
                beta = jl._cd_sweeps(jnp.asarray(gram), jnp.asarray(xty), beta, lam, alpha,
                                     jnp.asarray(pf), jl.DEFAULT_THRESH)
                return beta, beta

            _, ref = jax.lax.scan(step, jnp.zeros(6, dt), jnp.asarray(lams))
            ref = np.asarray(ref)
        t = lambda v: torch.as_tensor(v)[None]
        got, sweeps = tl.cd_path(t(gram), t(xty), t(pf), t(lams), None, alpha)
        assert got.shape == (1, 30, 6) and sweeps.dtype == torch.int32
        _close(got[0].numpy(), ref, PATH_TOL[dt], f"alpha {alpha}")


def test_cd_path_batch_freezes_stopped_fits():
    """A batch keeps vmap's semantics: each fit of a batch gives the bits
    and the sweep counts of its run alone, however long the others run."""
    rng = np.random.default_rng(9)
    grams, xtys = [], []
    for r in (0.2, 0.9, 0.995):  # ever more correlated pairs: ever more sweeps
        g = np.eye(4)
        g[0, 1] = g[1, 0] = r
        grams.append(g)
        xtys.append(rng.normal(size=4))
    gram, xty = torch.tensor(np.array(grams)), torch.tensor(np.array(xtys))
    pf = torch.ones(3, 4, dtype=torch.float64)
    lams = torch.tensor([[0.5, 0.1, 0.01]], dtype=torch.float64).expand(3, 3).contiguous()
    batch, sweeps = tl.cd_path(gram, xty, pf, lams)
    assert len(set(sweeps[:, -1].tolist())) == 3
    for b in range(3):
        alone, s = tl.cd_path(gram[b:b + 1], xty[b:b + 1], pf[b:b + 1], lams[b:b + 1])
        assert torch.equal(alone[0], batch[b]) and torch.equal(s[0], sweeps[b])


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_cd_path_max_sweeps_equals_jax(dt):
    """A near-collinear pair at a small λ needs every one of MAX_SWEEPS in
    both packages (bound scaled by the conditioning, κ ≈ 4,000)."""
    gram = np.array([[1.0, 0.9995], [0.9995, 1.0]], dt)
    xty = np.array([1.0, -1.0], dt)
    with _x64(dt):
        ref = np.asarray(jl._cd_sweeps(jnp.asarray(gram), jnp.asarray(xty), jnp.zeros(2, dt),
                                       jnp.asarray(1e-6, dt), 1.0, jnp.ones(2, dt),
                                       jl.DEFAULT_THRESH))
    t = lambda v: torch.as_tensor(v)[None]
    got, sweeps = tl.cd_path(t(gram), t(xty), t(np.ones(2, dt)), t(np.array([1e-6], dt)))
    assert int(sweeps[0, 0]) == tl.MAX_SWEEPS
    _close(got[0, 0].numpy(), ref, 4000 * PATH_TOL[dt], "max sweeps")


# ---- CV ------------------------------------------------------------------


def test_cv_select_matches_glmnet_transcription():
    """The transcription fixtures of ``tests/test_lasso.py``: random
    losses with injected exact ties, glmnet's ``cvstats``/``getOptcv``
    transcribed; the JAX package's ``cv_select`` gives the same indices."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        k = int(rng.integers(3, 11))
        n_lam = int(rng.integers(5, 40))
        losses = rng.uniform(0.5, 2.0, (k, n_lam))
        if trial % 3 == 0:
            losses[:, n_lam // 2] = losses[:, n_lam // 3]
        fold_n = rng.integers(5, 50, k).astype(float)
        lambdas = np.sort(rng.uniform(0.01, 1.0, n_lam))[::-1].copy()
        cvm, cvsd, i_min, i_1se = tl.cv_select(torch.as_tensor(losses), torch.as_tensor(fold_n), k)
        o_cvm, o_cvsd = _oracle_cvstats(losses, fold_n, k)
        np.testing.assert_allclose(cvm.numpy(), o_cvm, rtol=1e-12)
        np.testing.assert_allclose(cvsd.numpy(), o_cvsd, rtol=1e-12)
        assert (int(i_min), int(i_1se)) == _oracle_getoptcv(lambdas, cvm.numpy(), cvsd.numpy())
        if trial in (0, 9):  # one JAX compile a shape: two trials, both with ties
            with _x64(np.float64):
                j = jl.cv_select(jnp.asarray(losses), jnp.asarray(fold_n), k)
            assert (int(i_min), int(i_1se)) == (int(j[2]), int(j[3])), trial


def test_cv_select_fold_weighting_hand_fixture():
    losses = np.array([[1.0, 0.9], [2.0, 0.8], [0.5, 0.9]])
    cvm, cvsd, i_min, _ = tl.cv_select(torch.as_tensor(losses),
                                       torch.tensor([10.0, 20.0, 70.0], dtype=torch.float64), 3)
    np.testing.assert_allclose(cvm.numpy(), [0.85, 0.88], rtol=1e-12)
    assert int(i_min) == 0
    np.testing.assert_allclose(float(cvsd[0]), np.sqrt(0.17625), rtol=1e-12)


@pytest.mark.parametrize("family,dt", [("gaussian", np.float32), ("binomial", np.float64)])
def test_cv_glmnet_equals_jax(family, dt):
    """Folds from a key, and R-compatible folds with a zero penalty
    factor: the same selected indices, the path, cvm and cvsd within
    bounds, and ``predict_path`` at lambda.1se."""
    x, y, w, _ = _problem(3, n=400, p=10, dt=dt)
    target = y if family == "gaussian" else w
    pf = np.ones(10, dt)
    pf[-1] = 0.0
    foldid = tl.r_compat_foldid(400, 5, TRCompat(1991))
    jk, tk = _keys(4)
    calls = ((dict(key=jk), dict(key=tk)),
             (dict(penalty_factor=jnp.asarray(pf), nfolds=5, foldid=jnp.asarray(foldid)),
              dict(penalty_factor=torch.as_tensor(pf), nfolds=5, foldid=foldid)))
    for jkw, tkw in calls:
        with _x64(dt):
            ref = jl.cv_glmnet(jnp.asarray(x), jnp.asarray(target), family, **jkw)
            ref_eta = np.asarray(jl.predict_path(ref.path, jnp.asarray(x), ref.index_1se))
        got = tl.cv_glmnet(torch.as_tensor(x), torch.as_tensor(target), family, **tkw)
        assert (int(got.index_min), int(got.index_1se)) == (int(ref.index_min),
                                                            int(ref.index_1se))
        assert float(got.lambda_min) == float(got.path.lambdas[got.index_min])
        _same_path(got.path, jl.ElnetPath(*(np.asarray(a) for a in ref.path)), dt, family)
        _close(got.cvm.numpy(), ref.cvm, CV_TOL[dt], "cvm")
        _close(got.cvsd.numpy(), ref.cvsd, CV_TOL[dt], "cvsd")
        eta = tl.predict_path(got.path, torch.as_tensor(x), got.index_1se)
        _close(eta.numpy(), ref_eta, 10 * PATH_TOL[dt], "predict_path")
        b0, coefs = got.coef_at("min")
        assert torch.equal(coefs, got.path.coefs[got.index_min]) and b0.ndim == 0


def test_fold_axis_raises():
    x = torch.zeros((20, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="fold_axis"):
        tl.cv_glmnet(x, x[:, 0], "gaussian", 1.0, None, 10, None, None, 100, "fold")
    with pytest.raises(ValueError, match="family"):
        tl.cv_glmnet(x, x[:, 0], "poisson")


def test_cv_glmnet_many_equals_one_call_each():
    """Several targets on one design in one batch: each result as its own
    cv_glmnet call (the fits are independent rows of a batch)."""
    x, y, w, _ = _problem(6, n=200, p=5)
    xt = torch.as_tensor(x)
    keys = [rnd.key(1, device="cpu"), rnd.key(2, device="cpu")]
    many = tl.cv_glmnet_many(xt, [torch.as_tensor(y), torch.as_tensor(w)], "gaussian", keys=keys)
    for got, target, key in zip(many, (y, w), keys):
        one = tl.cv_glmnet(xt, torch.as_tensor(target), key=key)
        assert (int(got.index_min), int(got.index_1se)) == (int(one.index_min), int(one.index_1se))
        for a, b in zip(got.path, one.path):
            assert torch.allclose(a, b, rtol=1e-12, atol=1e-14)
        assert torch.allclose(got.cvm, one.cvm, rtol=1e-12)
