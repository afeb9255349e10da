"""The Direct Method, Propensity_Weighting and Propensity_Regression rows
against the JAX package on a small biased frame (the notebook's data
path: synthetic pool → ``prepare_dataset`` → ``inject_bias``).

Bounds. Both packages evaluate the same formulas on the same rows; they
differ by summation order, amplified by the IRLS and normal-equation
solves and, in the weighting rows, by 1/(p(1−p)).

* the logistic propensity: float32 |Δ| ≤ 4e-6 + 1e-5·|ref| (the GLM bound
  of ``tests/test_torch_aipw.py``), float64 1e-13 + 1e-12·|ref|;
* τ and SE of each row: float32 |Δ| ≤ 2e-6 + 2e-5·|ref|, float64
  |Δ| ≤ 1e-13 + 1e-11·|ref|. Largest seen (1,094 biased rows): float32
  propensity 3.0e-7, τ 1.3e-7 (Propensity_Regression), SE 5.6e-9;
  float64 propensity 8.9e-16, τ 3.1e-16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.estimators import ipw as ti
from ate_replication_causalml_torch.estimators import ols as to
from ate_replication_causalml_tpu.estimators import ipw as ji
from ate_replication_causalml_tpu.estimators import ols as jo
from test_torch_aipw import build_frames

TOL = {  # (dtype, kind) -> (abs, rel)
    (np.float32, "fit"): (4e-6, 1e-5), (np.float64, "fit"): (1e-13, 1e-12),
    (np.float32, "est"): (2e-6, 2e-5), (np.float64, "est"): (1e-13, 1e-11),
}


def _close(got, ref, dt, kind, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    a, r = TOL[dt, kind]
    assert np.all(np.abs(got - ref) <= a + r * np.abs(ref)), (
        what, float(np.max(np.abs(got - ref))))


@pytest.fixture(scope="module")
def frames():
    return build_frames(pool_rows=12_000, pool_seed=3, n_obs=5_000)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ipw_rows_equal_jax(frames, dt):
    _, jmod, _, tmod = frames[dt]
    with jax.enable_x64(dt == np.float64):
        jp = ji.logistic_propensity(jmod.x, jmod.w)
        ref = [jo.ate_condmean_ols(jmod), ji.prop_score_weight(jmod, jp), ji.prop_score_ols(jmod, jp)]
        jp = np.asarray(jp)
    tp = ti.logistic_propensity(tmod.x, tmod.w)
    assert tp.dtype == tmod.x.dtype
    _close(tp.numpy(), jp, dt, "fit", "propensity")
    got = [to.ate_condmean_ols(tmod), ti.prop_score_weight(tmod, tp), ti.prop_score_ols(tmod, tp)]
    for g, r in zip(got, ref):
        assert g.method == r.method
        assert np.isfinite(g.ate) and g.se > 0
        _close(g.ate, r.ate, dt, "est", f"{g.method} ate")
        _close(g.se, r.se, dt, "est", f"{g.method} se")
        assert (g.lower_ci, g.upper_ci) == (g.ate - 1.96 * g.se, g.ate + 1.96 * g.se)
    assert [g.method for g in got] == ["Direct Method", "Propensity_Weighting",
                                      "Propensity_Regression"]


def test_ipw_rows_on_a_shared_propensity(frames):
    """Both weighting rows from one common propensity vector (numpy):
    isolates the rows' own arithmetic from the GLM."""
    _, jmod, _, tmod = frames[np.float32]
    p = np.random.default_rng(4).uniform(0.1, 0.9, tmod.n).astype(np.float32)
    with jax.enable_x64(False):
        ref = [ji.prop_score_weight(jmod, jnp.asarray(p)), ji.prop_score_ols(jmod, jnp.asarray(p))]
    got = [ti.prop_score_weight(tmod, torch.as_tensor(p)), ti.prop_score_ols(tmod, p)]
    for g, r in zip(got, ref):
        _close(g.ate, r.ate, np.float32, "est", f"{g.method} ate")
        _close(g.se, r.se, np.float32, "est", f"{g.method} se")
