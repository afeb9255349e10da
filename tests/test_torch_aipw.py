"""The AIPW slice against the JAX package: IRLS GLM, outcome model,
AIPW combination (both compats), sandwich SE, propensity clipping,
bootstrap SE (R-compat indices, multinomial and Poisson keys), the
graft entry's ``aipw_forward``, naive/oracle rows, and the doubly-robust
random-forest row end to end.

Bounds. Both packages evaluate the same formulas on the same rows
(bootstrap replicates draw the same rows: bit-exact threefry), so they
differ only by summation order, amplified in the GLM by the IRLS solve.
Each bound is a few times the largest difference these tests measured:

* GLM outputs (coefficients, SEs, fitted values, deviance, μ0/μ1):
  float32 |Δ| ≤ 4e-6 + 1e-5·|ref| (largest seen: 1.2e-6 on μ0, 1.1e-6 on
  a coefficient); float64 |Δ| ≤ 1e-13 + 1e-12·|ref| (largest seen:
  2.5e-15 on a coefficient, 2.3e-13 on a deviance of ~1.4e3).
* τ and its SEs: float32 |Δ| ≤ 1e-6 (largest seen: 2.2e-7, the DR-RF
  τ); float64 |Δ| ≤ 1e-15 (largest seen: 8.3e-17).

A solve at lower precision fails these bounds:
``test_f32_bound_rejects_a_reduced_precision_solve`` reruns the GLM with
TF32- and bf16-rounded matmul operands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ate_replication_causalml_torch.data import pipeline as tp
from ate_replication_causalml_torch.estimators import aipw as ta
from ate_replication_causalml_torch.estimators import naive as tn
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import bootstrap as tb
from ate_replication_causalml_torch.ops import glm as tg
from ate_replication_causalml_torch.ops import linalg as tl
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu.data import pipeline as jp
from ate_replication_causalml_tpu.data.synthetic import make_ggl_like
from ate_replication_causalml_tpu.estimators import aipw as ja
from ate_replication_causalml_tpu.estimators import naive as jn
from ate_replication_causalml_tpu.models import forest as jf
from ate_replication_causalml_tpu.ops import bootstrap as jb
from ate_replication_causalml_tpu.ops import glm as jg
from ate_replication_causalml_tpu.ops import linalg as jl
from ate_replication_causalml_tpu.utils.rrandom import RCompatRNG

TOL = {  # (dtype, kind) -> bound; see the module docstring
    (np.float32, "fit"): dict(abs=4e-6, rel=1e-5),
    (np.float32, "est"): dict(abs=1e-6, rel=0.0),
    (np.float64, "fit"): dict(abs=1e-13, rel=1e-12),
    (np.float64, "est"): dict(abs=1e-15, rel=0.0),
}
TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _within(got, ref, dtype, kind):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = TOL[dtype, kind]
    return bool(np.all(np.abs(got - ref) <= tol["abs"] + tol["rel"] * np.abs(ref)))


def _close(got, ref, dtype, what="", kind="est"):
    assert _within(got, ref, dtype, kind), (
        what, np.max(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))))


def build_frames(pool_rows=20_000, pool_seed=7, n_obs=8_000, dtypes=(np.float32, np.float64)):
    """Both packages' unbiased and biased frames from one synthetic pool:
    {dtype: (jax frame, jax biased, port frame, port biased)}. Also used
    at the notebook's size by ``scripts/torch_parity.py``."""
    raw = make_ggl_like(pool_rows, seed=pool_seed, true_ate=0.095)
    out = {}
    for dt in dtypes:
        cfg = jp.PrepConfig(n_obs=n_obs, seed=1991)
        jframe = jp.prepare_dataset(raw, cfg, rng=RCompatRNG(1991), dtype=dt)
        jmod, _ = jp.inject_bias(jframe, cfg)
        tcfg = tp.PrepConfig(n_obs=n_obs, seed=1991)
        tframe = tp.prepare_dataset(raw, tcfg, dtype=TDT[dt], device="cpu")
        tmod, _ = tp.inject_bias(tframe, tcfg)
        out[dt] = (jframe, jmod, tframe, tmod)
    return out


@pytest.fixture(scope="module")
def frames():
    return build_frames()


def _x64(dt):
    return jax.enable_x64(dt == np.float64)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_glm_and_outcome_model(frames, dt):
    _, jmod, _, tmod = frames[dt]
    with _x64(dt):
        jfit = jg.logistic_glm(jl.add_intercept(jnp.asarray(jmod.x)), jnp.asarray(jmod.w))
        jmu0, jmu1 = ja.outcome_model_mu(jmod)
        jfit = {k: np.asarray(getattr(jfit, k)) for k in ("coef", "se", "fitted", "deviance")}
        jmu0, jmu1 = np.asarray(jmu0), np.asarray(jmu1)
    tfit = tg.logistic_glm(tl.add_intercept(tmod.x), tmod.w)
    assert tfit.converged and tfit.coef.dtype == TDT[dt]
    for k in ("coef", "se", "fitted", "deviance"):
        _close(getattr(tfit, k).numpy(), jfit[k], dt, k, kind="fit")
    tmu0, tmu1 = ta.outcome_model_mu(tmod)
    _close(tmu0.numpy(), jmu0, dt, "mu0", kind="fit")
    _close(tmu1.numpy(), jmu1, dt, "mu1", kind="fit")


def _round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``t`` rounded to ``bits`` mantissa bits, to nearest (ties
    away from zero), as a TF32 (10 bits) or bf16 (7 bits) matmul takes
    its operands."""
    drop = 23 - bits
    i = t.contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


@pytest.mark.parametrize("bits", [10, 7], ids=["tf32", "bf16"])
def test_f32_bound_rejects_a_reduced_precision_solve(frames, bits, monkeypatch):
    """The float32 GLM bound is tight enough to tell a full-precision
    solve from one whose matmuls round their operands as TF32 or bf16
    tensor-core matmuls do: the same fit with such matmuls fails it."""
    _, jmod, _, tmod = frames[np.float32]
    with _x64(np.float32):
        jcoef = np.asarray(jg.logistic_glm(jl.add_intercept(jnp.asarray(jmod.x)),
                                           jnp.asarray(jmod.w)).coef)
        jmu0, jmu1 = (np.asarray(a) for a in ja.outcome_model_mu(jmod))
    full = tg.logistic_glm(tl.add_intercept(tmod.x), tmod.w).coef.numpy()
    assert _within(full, jcoef, np.float32, "fit")
    matmul = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: matmul(
        _round_mantissa(a, bits), _round_mantissa(b, bits)))
    low = tg.logistic_glm(tl.add_intercept(tmod.x), tmod.w).coef.numpy()
    lmu0, lmu1 = (a.numpy() for a in ta.outcome_model_mu(tmod))
    assert not _within(low, jcoef, np.float32, "fit")
    assert not (_within(lmu0, jmu0, np.float32, "fit") and _within(lmu1, jmu1, np.float32, "fit"))


def _nuisances(frames, dt):
    _, jmod, _, tmod = frames[dt]
    rng = np.random.default_rng(1)
    p = rng.uniform(0.05, 0.95, tmod.n).astype(dt)
    p[:3] = [0.0, 1.0, 0.5]  # exercise clipping
    with _x64(dt):
        mu0, mu1 = (np.array(a) for a in ja.outcome_model_mu(jmod))
    w, y = np.array(jmod.w), np.array(jmod.y)
    return w, y, p, mu0, mu1


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_aipw_tau_sandwich_clip(frames, dt):
    w, y, p, mu0, mu1 = _nuisances(frames, dt)
    t = lambda a: torch.as_tensor(a)
    with _x64(dt):
        jp_clip = np.asarray(ja.clip_propensity(jnp.asarray(p)))
        ref = {}
        for compat in ("r", "fixed"):
            tau = ja.aipw_tau(*(jnp.asarray(a) for a in (w, y, jp_clip, mu0, mu1)), compat=compat)
            se = ja.aipw_sandwich_se(*(jnp.asarray(a) for a in (w, y, jp_clip, mu0, mu1)), tau)
            ref[compat] = (float(tau), float(se))
    tp_clip = ta.clip_propensity(t(p))
    assert np.array_equal(tp_clip.numpy(), jp_clip)
    for compat in ("r", "fixed"):
        tau = ta.aipw_tau(t(w), t(y), tp_clip, t(mu0), t(mu1), compat=compat)
        se = ta.aipw_sandwich_se(t(w), t(y), tp_clip, t(mu0), t(mu1), tau)
        _close(float(tau), ref[compat][0], dt, f"tau {compat}")
        _close(float(se), ref[compat][1], dt, f"se {compat}")
    with pytest.raises(ValueError):
        ta.aipw_tau(t(w), t(y), tp_clip, t(mu0), t(mu1), compat="R")


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("style", ["indices", "multinomial", "poisson"])
def test_bootstrap_se(frames, dt, style):
    w, y, p, mu0, mu1 = _nuisances(frames, dt)
    p = np.clip(p, 0.05, 0.95).astype(dt)
    args = (w, y, p, mu0, mu1)
    n_boot = 200
    with _x64(dt):
        jargs = tuple(jnp.asarray(a) for a in args)
        if style == "indices":
            idx = RCompatRNG(42).sample_int(len(w), n_boot * len(w), replace=True).reshape(n_boot, -1)
            ref = float(jb.aipw_bootstrap_se(*jargs, indices=jnp.asarray(idx)))
            key_data = None
        else:
            k = jax.random.key(5)
            key_data = np.asarray(jax.random.key_data(k))
            ref = float(jb.aipw_bootstrap_se(*jargs, key=k, n_boot=n_boot, style=style, chunk=50))
    targs = tuple(torch.as_tensor(a) for a in args)
    if style == "indices":
        got = tb.aipw_bootstrap_se(*targs, indices=idx)
    else:
        got = tb.aipw_bootstrap_se(*targs, key=rnd.key_from_jax(key_data, device="cpu"),
                                   n_boot=n_boot, style=style, chunk=50)
    _close(float(got), ref, dt, style)


def test_bootstrap_draws_the_same_rows():
    k = jax.random.key(11)
    ref = np.asarray(jb.bootstrap_indices(k, 997, 13))
    got = tb.bootstrap_indices(rnd.key_from_jax(np.asarray(jax.random.key_data(k)), device="cpu"),
                               997, 13)
    assert np.array_equal(got.numpy(), ref)
    with jax.enable_x64(False):
        ref_c = np.asarray(jb._poisson1_counts(k, (4, 300)))
    got_c = tb._poisson1_counts(rnd.key_from_jax(np.asarray(jax.random.key_data(k)), device="cpu"),
                                (4, 300))
    assert np.array_equal(got_c.numpy(), ref_c)
    assert tb._POIS1_CDF_U32 == tuple(int(v) for v in jb._POIS1_CDF_U32)


def test_graft_entry_aipw_forward():
    """__graft_entry__.entry()'s flagship forward step, reproduced with
    the port's functions on the same numpy inputs (float32)."""
    fn, _ = __graft_entry__.entry()
    rng = np.random.default_rng(0)
    n = 1024
    x = rng.normal(size=(n, 21)).astype(np.float32)
    w = (rng.random(n) < 0.3).astype(np.float32)
    y = (rng.random(n) < 0.4 + 0.1 * w).astype(np.float32)
    with jax.enable_x64(False):
        jtau, jse = (float(v) for v in jax.jit(fn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)))

    def aipw_forward(x, w, y):
        mu0, mu1 = ta._outcome_model_mu(x, w, y)
        p = tg.logistic_glm(tl.add_intercept(x), w).fitted
        tau = ta.aipw_tau(w, y, p, mu0, mu1)
        return tau, ta.aipw_sandwich_se(w, y, p, mu0, mu1, tau)

    ttau, tse = (float(v) for v in aipw_forward(*(torch.as_tensor(a) for a in (x, w, y))))
    _close(ttau, jtau, np.float32, "tau")
    _close(tse, jse, np.float32, "se")


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_naive_and_oracle_rows(frames, dt):
    jframe, jmod, tframe, tmod = frames[dt]
    with _x64(dt):
        ref = [jn.naive_ate(jframe, method="oracle"), jn.naive_ate(jmod)]
    got = [tn.naive_ate(tframe, method="oracle"), tn.naive_ate(tmod)]
    for g, r in zip(got, ref):
        assert g.method == r.method
        _close(g.ate, r.ate, dt, "ate")
        _close(g.se, r.se, dt, "se")


def dr_pair(jmod, tmod, jvote, tvote, *, n_boot):
    """The DR row in both packages (float32) from each package's own
    propensity vector: {"jax"/"torch": (sandwich result, bootstrap
    result), "mu": (jax μ0, μ1), (port μ0, μ1)}. Also used at the
    notebook's size by ``scripts/torch_parity.py``."""
    with jax.enable_x64(False):
        jmu = ja.outcome_model_mu(jmod)
        ref_s = ja.doubly_robust(jmod, lambda f: jnp.asarray(jvote), mu=jmu)
        ref_b = ja.doubly_robust(jmod, lambda f: jnp.asarray(jvote), mu=jmu, bootstrap_se=True,
                                 n_boot=n_boot, key=jax.random.key(0))
        jmu = tuple(np.asarray(a) for a in jmu)
    tmu = ta.outcome_model_mu(tmod)
    got_s = ta.doubly_robust(tmod, lambda f: tvote, mu=tmu)
    got_b = ta.doubly_robust(tmod, lambda f: tvote, mu=tmu, bootstrap_se=True, n_boot=n_boot,
                             key=rnd.key(0, device="cpu"))
    return {"jax": (ref_s, ref_b), "torch": (got_s, got_b),
            "mu": (jmu, tuple(a.numpy() for a in tmu))}


def test_doubly_robust_rf_end_to_end(frames):
    """The DR-RF row at small size: forest OOB votes bit-exact, the AIPW
    estimate and both SEs within the float32 bound."""
    _, jmod, _, tmod = frames[np.float32]
    kw = dict(n_trees=8, depth=4)
    with jax.enable_x64(False):
        k = jax.random.key(12325)
        jvote = np.asarray(jf.rf_oob_propensity(jmod, key=k, hist_backend="pallas_interpret",
                                                hist_mode="dense", **kw))
        key_data = np.asarray(jax.random.key_data(k))
    tk = rnd.key_from_jax(key_data, device="cpu")
    tvote = tf.rf_oob_propensity(tmod, key=tk, **kw)
    assert np.array_equal(tvote.numpy(), jvote)
    out = dr_pair(jmod, tmod, jvote, tvote, n_boot=100)
    (ref_s, ref_b), (got_s, got_b) = out["jax"], out["torch"]
    assert got_s.method == ref_s.method == "Doubly Robust with Random Forest PS"
    for g, r in ((got_s, ref_s), (got_b, ref_b)):
        _close(g.ate, r.ate, np.float32, "ate")
        _close(g.se, r.se, np.float32, "se")
    for g, r in zip(*out["mu"][::-1]):
        _close(g, r, np.float32, "mu", kind="fit")
    # The propensity function is what doubly_robust calls, not a stand-in.
    direct = ta.doubly_robust(tmod, lambda f: tf.rf_oob_propensity(f, key=tk, **kw))
    assert (direct.ate, direct.se) == (got_s.ate, got_s.se)


def test_doubly_robust_glm_row(frames):
    _, jmod, _, tmod = frames[np.float64]
    with jax.enable_x64(True):
        ref = ja.doubly_robust_glm(jmod)
    got = ta.doubly_robust_glm(tmod)
    _close(got.ate, ref.ate, np.float64, "ate")
    _close(got.se, ref.se, np.float64, "se")

