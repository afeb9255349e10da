"""The four LASSO rows against the JAX package on the ``prep_small``
frame (``tests/conftest.py``: 20,000-row pool, 8,000-row sample, bias
injection to 1,741 rows, 21 covariates): Propensity_Weighting_LASSOPS,
Single-equation LASSO, Usual LASSO and Belloni et.al under both
``compat`` values; and Belloni's pieces.

Exact: every ``cv_glmnet``'s selected indices, ``interaction_expand``,
and Belloni's selected support.

Everything runs in float32, the sweep's dtype (the float64 formulas are
held at 1e-10 in ``tests/test_torch_lasso.py``). Bounds, each with its
reason:

* Single-equation and Usual LASSO τ (W's path coefficient at
  lambda.1se): |Δ| ≤ 5e-5: the sweeps stop once max_j G_jj·Δβ_j² < 1e-7,
  so two runs that round differently can stop a sweep apart (the
  notebook's size: 3.6e-6, ``scripts/torch_parity.py``);
* the LASSO propensity: |Δ| ≤ 1e-4 (the binomial path, as above);
  LASSOPS τ and SE: 2e-4 (that propensity through 1/(p(1−p)));
* Belloni τ and SE: an OLS on the selected support, held equal: |Δ| ≤
  1e-5 (the float32 normal equations).

Belloni runs once per package; both
``compat`` values select from the same two CV fits (computed once and
replayed), which the second call would recompute identically.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame as TFrame
from ate_replication_causalml_torch.estimators import ipw as tipw
from ate_replication_causalml_torch.estimators import lasso_est as tle
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu.data.frame import CausalFrame as JFrame

# Both packages' estimators/__init__.py export functions under the
# module names; import the modules themselves.
jb = importlib.import_module("ate_replication_causalml_tpu.estimators.belloni")
tb = importlib.import_module("ate_replication_causalml_torch.estimators.belloni")
jipw = importlib.import_module("ate_replication_causalml_tpu.estimators.ipw")
jle = importlib.import_module("ate_replication_causalml_tpu.estimators.lasso_est")

TOL = {"tau": 5e-5, "p": 1e-4, "ipw": 2e-4, "belloni": 1e-5}  # |Δ|; see the docstring


def _frames(prep_small):
    """prep_small's biased frame in float32, as both packages' frames."""
    _, fm, _ = prep_small
    arrs = [np.array(a, np.float32) for a in (fm.x, fm.w, fm.y)]
    return JFrame(*(jnp.asarray(a) for a in arrs)), TFrame(*(torch.as_tensor(a) for a in arrs))


def _capture(mp, mod, name="cv_glmnet"):
    """Record every cv_glmnet result an estimator module computes (through
    ``cv_glmnet``, or ``cv_glmnet_many``: a list of results a call)."""
    seen = []
    fit = getattr(mod, name)

    def rec(*a, **k):
        out = fit(*a, **k)
        seen.extend(out if isinstance(out, list) else [out])
        return out

    mp.setattr(mod, name, rec)
    return seen


def _indices(cvs):
    return [(int(c.index_min), int(c.index_1se)) for c in cvs]


def test_lasso_rows_equal_jax(prep_small, monkeypatch):
    """Single-equation LASSO, Usual LASSO and the LASSO propensity into
    Propensity_Weighting_LASSOPS, with keys (the rows' default folds) and
    positional calls as the sweep makes them."""
    jframe, tframe = _frames(prep_small)
    with jax.enable_x64(False):
        with pytest.MonkeyPatch.context() as mp:
            jcv = _capture(mp, jle)
            jp = jle.prop_score_lasso(jframe, None, jax.random.key(2))
            ref = [jipw.prop_score_weight(jframe, jp, method="Propensity_Weighting_LASSOPS"),
                   jle.ate_condmean_lasso(jframe, None, jax.random.key(1)),
                   jle.ate_lasso(jframe, None, jax.random.key(1))]
            jidx = _indices(jcv)
        jp = np.asarray(jp)
    tcv = _capture(monkeypatch, tle)
    tp = tle.prop_score_lasso(tframe, None, rnd.key(2, device="cpu"))
    got = [tipw.prop_score_weight(tframe, tp, method="Propensity_Weighting_LASSOPS"),
           tle.ate_condmean_lasso(tframe, None, rnd.key(1, device="cpu")),
           tle.ate_lasso(tframe, None, rnd.key(1, device="cpu"))]
    assert _indices(tcv) == jidx
    assert tp.dtype == torch.float32 and np.all(np.abs(tp.numpy() - jp) <= TOL["p"])
    for g, r, kind in zip(got, ref, ("ipw", "tau", "tau")):
        assert g.method == r.method
        assert abs(g.ate - r.ate) <= TOL[kind], (g.method, g.ate - r.ate)
        if kind == "ipw":
            assert abs(g.se - r.se) <= TOL[kind]
        else:
            assert np.isnan(g.se) and g.lower_ci == g.ate == g.upper_ci


def test_interaction_expand_equals_jax():
    x = np.random.default_rng(0).normal(size=(50, 5)).astype(np.float32)
    got = tb.interaction_expand(torch.as_tensor(x)).numpy()
    with jax.enable_x64(False):
        ref = np.asarray(jb.interaction_expand(jnp.asarray(x)))
    assert got.shape == (50, 30) and np.array_equal(got, ref)
    assert np.array_equal(got[:, 5 + 1 * 5 + 3], x[:, 1] * x[:, 3])


def test_interp_coef_at_equals_jax():
    """On-path, between-path and out-of-range λs (the transcription
    queries of ``tests/test_lasso.py``)."""
    rng = np.random.default_rng(1)
    lambdas = np.sort(rng.uniform(0.01, 2.0, 20))[::-1].copy()
    coefs = rng.normal(size=(20, 4))
    queries = np.concatenate([lambdas[[0, 7, 19]], (lambdas[:-1] + lambdas[1:]) / 2,
                              [lambdas[0] * 1.5, lambdas[-1] * 0.5]])
    with jax.enable_x64(True):
        for s in queries:
            ref = np.asarray(jb._interp_coef_at(jnp.asarray(lambdas), jnp.asarray(coefs),
                                                jnp.asarray(s)))
            got = tb._interp_coef_at(torch.as_tensor(lambdas), torch.as_tensor(coefs), s)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-15)


@pytest.fixture(scope="module")
def belloni_pair(prep_small):
    """Both packages' Belloni rows on prep_small in float32, both compat
    values, each package's two CV fits computed once and shared by the two
    compat values; with every cv_glmnet result."""
    jframe, tframe = _frames(prep_small)
    out = {}
    # The port fits both CV-LASSOs in one cv_glmnet_many call.
    for name, mod, fit, frame, key in (
            ("jax", jb, "cv_glmnet", jframe, jax.random.key(3)),
            ("torch", tb, "cv_glmnet_many", tframe, rnd.key(3, device="cpu"))):
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
            seen = _capture(mp, mod, fit)
            rows = {"r": mod.belloni(frame, key=key)}
            replies = iter([seen[:]] if fit == "cv_glmnet_many" else seen[:])
            mp.setattr(mod, fit, lambda *a, **k: next(replies))
            rows["fixed"] = mod.belloni(frame, None, None, key, None, "fixed")
        out[name] = (rows, seen)
    return out


@pytest.mark.parametrize("compat", ["r", "fixed"])
def test_belloni_equals_jax(belloni_pair, compat):
    (jrows, jcv), (trows, tcv) = belloni_pair["jax"], belloni_pair["torch"]
    assert _indices(tcv) == _indices(jcv) and len(tcv) == 2
    r, g = jrows[compat], trows[compat]
    assert g.method == r.method == "Belloni et.al"
    assert np.isfinite(g.ate) and g.se > 0
    assert abs(g.ate - r.ate) <= TOL["belloni"], g.ate - r.ate
    assert abs(g.se - r.se) <= TOL["belloni"], g.se - r.se


def test_belloni_support_equals_jax(belloni_pair):
    """The support both compat values select (``> 0`` and ``!= 0`` at
    model_xw's lambda.min, the reference's wrong-λ read of model_xy) is
    the same set in both packages."""
    (_, jcv), (_, tcv) = belloni_pair["jax"], belloni_pair["torch"]
    lam_j, lam_t = jcv[0].lambda_min, tcv[0].lambda_min
    cj = [np.asarray(jb._interp_coef_at(c.path.lambdas, c.path.coefs, lam_j)) for c in jcv]
    ct = [tb._interp_coef_at(c.path.lambdas, c.path.coefs, lam_t).numpy() for c in tcv]
    for sel in (lambda c: c > 0, lambda c: c != 0):
        assert np.array_equal(sel(ct[0]) | sel(ct[1]), sel(cj[0]) | sel(cj[1]))
    assert 0 < int(((ct[0] > 0) | (ct[1] > 0)).sum()) < ct[0].shape[0]


def test_belloni_bad_compat_raises():
    frame = TFrame(*(torch.zeros(8, 2), torch.zeros(8), torch.zeros(8)))
    with pytest.raises(ValueError, match="compat"):
        tb.belloni(frame, compat="R")
