"""The port's reticulate bridge (``ate_replication_causalml_torch/rbridge.py``)
row by row against the JAX package's bridge on the CPU, on one dataset
in the notebook's layout (covariates..., W, Y) made by numpy from a
seed. The JAX bridge runs without x64 (the suite enables it), as an R
session runs it.

Bounds, one a row, each the bound of the test file that holds that
estimator to the JAX package (the reason is there):

* naive, Direct Method, Propensity_Weighting, Propensity_Regression:
  |Δ| ≤ 2e-6 + 2e-5·|ref| (``test_torch_ipw.py``); the logistic
  propensity 4e-6 + 1e-5·|ref|;
* the LASSO rows: τ 5e-5 (the CD stopping rule), the LASSO propensity
  1e-4 (``test_torch_lasso_est.py``); Belloni τ and SE 1e-5, so its CI
  1e-5·(1 + 1.96);
* both doubly-robust rows and DML: τ and SE within 1e-6
  (``test_torch_aipw.py``, ``test_torch_dml.py``: the forests of binary
  targets are exact), so the CI within 1e-6·(1 + 1.96);
* residual_balancing: 5e-5 (``test_torch_balance.py``), CI the same
  scaled by (1 + 1.96);
* the causal forest: the port's bridge row (its kernel grower's plain
  versions) against JAX ``causal_forest_report(...,
  hist_backend="pallas_interpret")`` (the same streaming grower), and
  the port's ``causal_forest_report(..., hist_backend="onehot")`` against
  the JAX bridge's own CPU row (its CPU "auto" is "onehot"): 2e-2 on the
  ATE and SE (``test_torch_causal_forest.py``'s report bound: a tie flip
  moves whole rows between leaves), CI scaled by (1 + 1.96).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import rbridge as tb
from ate_replication_causalml_torch.estimators import causal_forest_est as tce
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu import rbridge as jb
from ate_replication_causalml_tpu.estimators import causal_forest_est as jce

N = 600
EST = (2e-6, 2e-5)
Z = 1.959963984540054


@pytest.fixture(scope="module")
def dataset():
    """Columns in notebook layout: covariates..., then W, Y (float lists,
    as reticulate sends them)."""
    rng = np.random.default_rng(3)
    x1, x2, x3 = rng.normal(size=N), rng.normal(size=N), np.round(rng.normal(size=N))
    e = 1 / (1 + np.exp(-0.8 * x1))
    w = (rng.random(N) < e).astype(float)
    y = (rng.random(N) < 1 / (1 + np.exp(-(0.5 * x1 + 0.3 * x3 + 0.4 * w)))).astype(float)
    return {k: [float(v) for v in a] for k, a in
            (("x1", x1), ("x2", x2), ("x3", x3), ("W", w), ("Y", y))}


def _jax(fn, *args, **kw):
    with jax.enable_x64(False):
        return fn(*args, **kw)


def _close_row(got, ref, abs_tol, rel_tol=0.0, ci_scale=1.0 + Z):
    assert got["Method"] == ref["Method"]
    for k, scale in (("ATE", 1.0), ("lower_ci", ci_scale), ("upper_ci", ci_scale)):
        a, b = got[k], ref[k]
        assert isinstance(a, float)
        if math.isnan(b):
            assert math.isnan(a), k
            continue
        assert abs(a - b) <= scale * (abs_tol + rel_tol * abs(b)), (k, a, b)


def test_frame_from_columns_roles(dataset):
    frame = tb.frame_from_columns(dataset, device="cpu")
    ref = _jax(jb.frame_from_columns, dataset)
    assert frame.p == 3 and frame.n == N and frame.x.dtype == torch.float32
    assert frame.schema.covariates == ref.schema.covariates == ("x1", "x2", "x3")
    for a, b in ((frame.x, ref.x), (frame.w, ref.w), (frame.y, ref.y)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tb.frame_from_columns(dataset, covariates=["x2"], device="cpu").p == 1
    with pytest.raises(ValueError):
        tb.frame_from_columns({"a": [1.0]}, "W", "Y", device="cpu")
    with pytest.raises(ValueError):
        tb.frame_from_columns(dataset, covariates=["nope"], device="cpu")


def test_simple_rows(dataset):
    _close_row(tb.naive_ate(dataset, device="cpu"), _jax(jb.naive_ate, dataset), *EST)
    _close_row(tb.ate_condmean_ols(dataset, device="cpu"), _jax(jb.ate_condmean_ols, dataset),
               *EST)
    p_ref = _jax(jb.logistic_propensity, dataset)
    p = tb.logistic_propensity(dataset, device="cpu")
    assert p.dtype == np.float64 and p.shape == (N,)
    assert np.all(np.abs(p - p_ref) <= 4e-6 + 1e-5 * np.abs(p_ref))
    p_list = [float(v) for v in p_ref]
    _close_row(tb.prop_score_weight(dataset, p_list, device="cpu"),
               _jax(jb.prop_score_weight, dataset, p_list), *EST)
    _close_row(tb.prop_score_ols(dataset, p_list, device="cpu"),
               _jax(jb.prop_score_ols, dataset, p_list), *EST)


def test_lasso_rows(dataset):
    _close_row(tb.ate_condmean_lasso(dataset, device="cpu"),
               _jax(jb.ate_condmean_lasso, dataset), 5e-5)
    _close_row(tb.ate_lasso(dataset, device="cpu"), _jax(jb.ate_lasso, dataset), 5e-5)
    p, p_ref = tb.prop_score_lasso(dataset, device="cpu"), _jax(jb.prop_score_lasso, dataset)
    assert p.shape == (N,) and np.all(np.abs(p - p_ref) <= 1e-4)
    _close_row(tb.belloni(dataset, device="cpu"), _jax(jb.belloni, dataset), 1e-5)


@pytest.mark.parametrize("compat", ["r", "fixed"])
def test_doubly_robust_rows(dataset, compat):
    _close_row(tb.doubly_robust(dataset, num_trees=8, compat=compat, device="cpu"),
               _jax(jb.doubly_robust, dataset, num_trees=8, compat=compat), 1e-6)
    _close_row(tb.doubly_robust_glm(dataset, compat=compat, device="cpu"),
               _jax(jb.doubly_robust_glm, dataset, compat=compat), 1e-6)


def test_dml_and_balance_rows(dataset):
    _close_row(tb.double_ml(dataset, num_trees=8, device="cpu"),
               _jax(jb.double_ml, dataset, num_trees=8), 1e-6)
    _close_row(tb.residual_balance_ATE(dataset, device="cpu"),
               _jax(jb.residual_balance_ATE, dataset), 5e-5)


def test_causal_forest_rows(dataset, monkeypatch):
    """The bridge row on the kernel grower's plain versions against the
    JAX package's streaming grower, and the port's "onehot" report against
    the JAX bridge's CPU row. Both bridges' reports are cut to causal
    trees of depth 4 and 16 nuisance trees of depth 4 (their defaults,
    depth 8 and 500 of depth 9, cost minutes in the JAX package's
    interpret mode); the bridges' own arguments are unchanged."""
    import functools

    import ate_replication_causalml_tpu.estimators as jest

    trees, seed = 16, 12345
    cut = dict(nuisance_trees=16, nuisance_depth=4, depth=4)
    monkeypatch.setattr(tb, "causal_forest_report",
                        functools.partial(tce.causal_forest_report, **cut))
    monkeypatch.setattr(jest, "causal_forest_report",
                        functools.partial(jce.causal_forest_report, **cut))
    got = tb.causal_forest(dataset, num_trees=trees, seed=seed, device="cpu")
    jframe = _jax(jb.frame_from_columns, dataset)
    with jax.enable_x64(False):
        rep = jce.causal_forest_report(jframe, key=jax.random.key(seed), n_trees=trees,
                                       hist_backend="pallas_interpret", **cut)
        streaming = jb._row(rep.result)
    _close_row(got, streaming, 2e-2)
    assert abs(got["incorrect_ate"] - float(rep.incorrect_ate)) <= 2e-2
    bridge_row = _jax(jb.causal_forest, dataset, num_trees=trees, seed=seed)
    frame = tb.frame_from_columns(dataset, device="cpu")
    mine = tce.causal_forest_report(frame, key=rnd.key(seed, device="cpu"), n_trees=trees,
                                    hist_backend="onehot", **cut)
    row = tb._row(mine.result)
    _close_row(row, bridge_row, 2e-2)
    assert abs(mine.incorrect_ate - bridge_row["incorrect_ate"]) <= 2e-2
    assert abs(mine.incorrect_se - bridge_row["incorrect_se"]) <= 2e-2


def test_run_notebook_sweep_config_and_device(monkeypatch):
    """``run_notebook_sweep`` runs ``run_sweep`` on the JAX bridge's
    configuration (the ``quick`` pool rule, R's float overrides coerced
    to ints) and on the caller's device, and returns the oracle row then
    the table's rows; an unknown override raises."""
    from ate_replication_causalml_torch import pipeline as tpipe
    from ate_replication_causalml_tpu import pipeline as jpipe

    seen = {}

    class _Rows:
        rows = []

    def fake(tag):
        def run(cfg, **kw):
            seen[tag] = (cfg, kw)
            from ate_replication_causalml_torch.estimators.base import EstimatorResult

            return type("R", (), {"oracle": EstimatorResult.from_point_se("oracle", 0.1, 0.01),
                                  "results": _Rows})()
        return run

    monkeypatch.setattr(tpipe, "run_sweep", fake("torch"))
    monkeypatch.setattr(jpipe, "run_sweep", fake("jax"))
    overrides = dict(synthetic_pool=3000.0, dr_trees=16.0, balance_iters=600.0, cf_trees=16)
    rows = tb.run_notebook_sweep(n_obs=1200, seed=1991, quick=True, overrides=overrides,
                                 device="cpu")
    jb.run_notebook_sweep(n_obs=1200, seed=1991, quick=True, overrides=overrides)
    assert len(rows) == 1 and rows[0]["Method"] == "oracle" and rows[0]["ATE"] == 0.1
    (cfg, kw), (jcfg, _) = seen["torch"], seen["jax"]
    assert kw["device"] == "cpu" and kw["outdir"] is None and kw["plots"] is False
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.dr_trees == 16 and isinstance(cfg.dr_trees, int)
    plain = tb.run_notebook_sweep(n_obs=500, quick=True, device="cpu")
    assert plain[0]["Method"] == "oracle"
    assert seen["torch"][0].synthetic_pool == 20_000 and seen["torch"][0].prep.n_obs == 500
    tb.run_notebook_sweep(n_obs=10_000, quick=True, device="cpu")
    assert seen["torch"][0].synthetic_pool == 30_000
    with pytest.raises(ValueError, match="unknown SweepConfig override"):
        tb.run_notebook_sweep(overrides={"nope": 1}, device="cpu")
