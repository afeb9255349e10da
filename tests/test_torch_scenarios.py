"""The scenario matrix's draws and columns (``scenarios/dgp.py``,
``scenarios/batched.py``, the batched estimator cores and
``ops/random.py::normal``) against the JAX package on the CPU.

Exact contracts: ``normal`` is ``jax.random.normal``'s bits (XLA:CPU's
float32 ``log1p``, its Cephes ``log`` and the fused Horner steps are
reproduced, ``xla_log1p_f32``); the cell ids, salts, cache keys, plans
and fingerprints (``==``); x, ``w`` and ``y`` of every draw (``array_equal``, 0 flips: a flip
needs a uniform within an ulp of the propensity or of the outcome
probability, and none lands there at these seeds); a batched draw equals
the one-key draw lane for lane (``torch.equal``); the ``naive`` column
equals its scalar replay, and every IRLS lane of a batched fit takes the
iterations its scalar fit takes.

Bounds, each with its reason:

* ``tau_true``: ≤ 8 ulps (XLA's and PyTorch's sigmoid and their
  summation orders; seen ≤ 2);
* per-cell ate/se against the JAX package's cell function: |Δ| ≤
  ``CELL_TOL[est]·(1 + |ref|)`` (float32 GLM normal equations in another
  summation order; seen ≤ 2e-7 for the GLM columns, exact-to-1e-8 for
  naive; the forest column's AIPW combination over votes that are equal
  element for element: seen 2e-8);
* batched against scalar replay: 0 ulps for ``naive``, at most
  ``MAX_VMAP_COLLAPSE_ULP`` (512) for the columns that reassociate
  (seen ≤ 25 here).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import scenarios as sc
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.glm import logistic_glm
from ate_replication_causalml_torch.ops.linalg import add_intercept
from ate_replication_causalml_torch.scenarios import dgp as tdgp
from ate_replication_causalml_torch.scenarios.batched import ScenarioEstimator
from ate_replication_causalml_tpu import scenarios as jsc
from ate_replication_causalml_tpu.scenarios import dgp as jdgp

CPU = "cpu"
N = 96
#: the test shapes of the stock designs: n = 96, p ≤ 24.
SHAPES = {name: dict(n=N, p=min(d.p, 20)) for name, d in jsc.STOCK_DGPS.items()}
CELL_TOL = {"naive": 1e-6, "ols": 5e-6, "ipw_logit": 5e-6, "aipw_logit": 5e-6, "lasso": 5e-5,
            "aipw_rf": 5e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file: its small ops, multithreaded on
    a CPU the suite's parallel workers keep busy, wait on their threads
    (``tests/test_torch_qp.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(name: str):
    j = dataclasses.replace(jsc.STOCK_DGPS[name], **SHAPES[name])
    return j, sc.DGPSpec(*j.fields())


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


# ── normal ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_normal_equals_jax(seed):
    """jax.random.normal's bits: measured 0 of 10,000,000 draws differ
    (seeds 0-9, at XLA's default flags and at this suite's)."""
    for shape in ((50_000, 4), (96, 20), (7,)):
        with jax.enable_x64(False):
            a = np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32))
        b = rnd.normal(rnd.key(seed, device=CPU), shape).numpy()
        assert b.dtype == np.float32 and b.shape == shape
        assert np.array_equal(a, b)


def test_xla_log1p_bit_for_bit():
    """The log1p that erf_inv takes equals jnp.log1p on both of its
    branches (|v| < √2 − 1: the rational; else log(1 + v))."""
    u = np.random.default_rng(0).uniform(-1, 1, 100_000).astype(np.float32)
    v = -(u * u)
    want = np.asarray(jax.jit(jnp.log1p)(v))
    got = rnd.xla_log1p_f32(torch.from_numpy(v)).numpy()
    assert np.array_equal(want, got)
    assert (np.abs(v) >= 0.4142).sum() > 10_000  # both branches ran


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = rnd.erf_inv(x)
    assert out[0] == -math.inf and out[1] == math.inf and out[2] == 0.0
    with pytest.raises(TypeError):
        rnd.erf_inv(x.double())


# ── DGP ───────────────────────────────────────────────────────────────


def test_ids_salts_and_fields_equal_jax():
    for name in jsc.STOCK_DGPS:
        for rep in (0, 1, 63):
            assert sc.data_cell_id(name, rep) == jsc.data_cell_id(name, rep)
        assert sc.STOCK_DGPS[name].fields() == jsc.STOCK_DGPS[name].fields()
    for est in sc.SCENARIO_ESTIMATORS:
        assert sc.estimator_salt(est) == jsc.estimator_salt(est)
    assert set(sc.SCENARIO_ESTIMATORS) == set(jsc.SCENARIO_ESTIMATORS)
    for name, e in sc.SCENARIO_ESTIMATORS.items():
        je = jsc.SCENARIO_ESTIMATORS[name]
        assert (e.vmapped, e.has_se, e.needs_tall, e.vmap_collapse_exact) == (
            je.vmapped, je.has_se, je.needs_tall, je.vmap_collapse_exact)
    assert sc.MAX_VMAP_COLLAPSE_ULP == jsc.MAX_VMAP_COLLAPSE_ULP


def test_dgp_spec_validation():
    with pytest.raises(ValueError, match="tau"):
        sc.DGPSpec(name="x", tau="wiggly")
    with pytest.raises(ValueError, match="overlap"):
        sc.DGPSpec(name="x", overlap=0.0)
    with pytest.raises(ValueError, match="sparsity"):
        sc.DGPSpec(name="x", p=4, sparsity=9)
    with pytest.raises(ValueError, match="dtype"):
        sc.generate(sc.DGPSpec(name="x", dtype="float16"), rnd.key(0, device=CPU))


@pytest.mark.parametrize("name", list(jsc.STOCK_DGPS))
def test_generate_against_jax(name):
    jspec, tspec = _specs(name)
    for rep in range(4):
        cid = jsc.data_cell_id(name, rep)
        with jax.enable_x64(False):
            xj, wj, yj, tj = (np.asarray(a) for a in jdgp.generate(
                jspec, jax.random.fold_in(jax.random.key(0), cid)))
        xt, wt, yt, tt = (a.numpy() for a in tdgp.generate(
            tspec, rnd.fold_in(rnd.key(0, device=CPU), cid)))
        assert xt.dtype == np.float32 and xt.shape == (N, tspec.p)
        assert np.array_equal(xj, xt)
        assert np.array_equal(wj, wt) and np.array_equal(yj, yt)
        assert _ulps(tj, tt).max() <= 8.0
    e = tdgp.propensity(tspec, torch.from_numpy(xt)).numpy()
    je = np.asarray(jdgp.propensity(jspec, jnp.asarray(xt)))
    assert _ulps(e, je).max() <= 8.0


def test_batched_draw_equals_one_key_draws():
    spec = tdgp.DGPSpec(name="h", n=N, p=6, tau="hetero", confounding=1.0, overlap=0.1)
    ids = torch.tensor([sc.data_cell_id("h", r) for r in range(5)])
    root = rnd.key(3, device=CPU)
    xb, wb, yb, tb = tdgp.generate(spec, rnd.fold_in(root, ids))
    for i in range(5):
        one = tdgp.generate(spec, rnd.fold_in(root, int(ids[i])))
        for got, want in zip((xb[i], wb[i], yb[i], tb[i]), one):
            assert torch.equal(got, want)


def test_sparse_design_and_propensity_knobs():
    spec = sc.STOCK_DGPS["sparse_highdim"]
    beta = tdgp._beta(spec, torch.float32, CPU)
    assert int(torch.count_nonzero(beta)) == spec.sparsity
    x, _, _, _ = tdgp.generate(sc.STOCK_DGPS["calibration"], rnd.key(0, device=CPU))
    assert torch.all(tdgp.propensity(sc.STOCK_DGPS["calibration"], x) == 0.5)
    viol = sc.STOCK_DGPS["overlap_violation"]
    ev = tdgp.propensity(viol, x)
    assert float(ev.min()) >= viol.overlap - 1e-6 and float(ev.max()) <= 1 - viol.overlap + 1e-6


# ── cells against the JAX package ─────────────────────────────────────


def _jax_cell(jspec, est_name, rep, seed=0):
    """The JAX package's cell, in float32 as its matrix runs it outside
    this suite (the suite enables x64, under which the forest's internal
    draws default to float64)."""
    with jax.enable_x64(False):
        fn = jsc.cell_fn(jspec, jsc.SCENARIO_ESTIMATORS[est_name])
        if jsc.SCENARIO_ESTIMATORS[est_name].vmapped:
            fn = jax.jit(fn)
        out = fn(jax.random.key(seed), jnp.uint32(jsc.data_cell_id(jspec.name, rep)))
        return tuple(float(v) for v in out)


CELL_CASES = [("calibration", "naive"), ("hetero_confounded", "ols"),
              ("overlap_violation", "ipw_logit"), ("hetero_confounded", "aipw_logit"),
              ("sparse_highdim", "lasso"), ("calibration", "aipw_rf")]


@pytest.mark.parametrize("dgp_name,est_name", CELL_CASES)
def test_cell_fn_against_jax(dgp_name, est_name):
    jspec, tspec = _specs(dgp_name)
    run = sc.cell_fn(tspec, sc.SCENARIO_ESTIMATORS[est_name])
    tol = CELL_TOL[est_name]
    for rep in range(2):
        want = _jax_cell(jspec, est_name, rep)
        got = tuple(float(v) for v in run(rnd.key(0, device=CPU),
                                          sc.data_cell_id(dgp_name, rep)))
        for g, w in zip(got, want):
            if math.isnan(w):
                assert math.isnan(g)
            else:
                assert abs(g - w) <= tol * (1 + abs(w)), (rep, got, want)


@pytest.mark.parametrize("dgp_name,est_name", [c for c in CELL_CASES if c[1] != "aipw_rf"])
def test_batched_column_against_scalar_replay(dgp_name, est_name):
    """The column over 6 lanes (the last 2 padded) against the scalar
    replay of each cell: exact where the estimator declares it, else
    within MAX_VMAP_COLLAPSE_ULP."""
    _, tspec = _specs(dgp_name)
    est = sc.SCENARIO_ESTIMATORS[est_name]
    sc.clear_executables()
    exe = sc.column_executable(tspec, est, 6)
    assert sc.column_executable(tspec, est, 6) is exe
    root = rnd.key(0, device=CPU)
    batch = (0, 1, 2, 3)
    ate, se, tt = exe(root, sc.pad_ids(dgp_name, batch, 6))
    scalar = sc.scalar_executable(tspec, est)
    for i, rep in enumerate(batch):
        want = scalar(root, sc.data_cell_id(dgp_name, rep))
        for g, w in zip((ate[i], se[i], tt[i]), want):
            if torch.isnan(w):
                assert torch.isnan(g)
                continue
            ulp = float(_ulps(g.numpy(), w.numpy()))
            assert ulp == 0.0 if est.vmap_collapse_exact else ulp <= sc.MAX_VMAP_COLLAPSE_ULP
    # a padded lane repeats lane 0's cell
    assert torch.equal(tt[4], tt[0]) and torch.equal(tt[5], tt[0])


@pytest.mark.parametrize("name", ["calibration", "hetero_confounded", "overlap_violation"])
def test_irls_lanes_take_their_scalar_iterations(name):
    _, tspec = _specs(name)
    ids = torch.tensor([sc.data_cell_id(name, r) for r in range(8)])
    x, w, y, _ = tdgp.generate(tspec, rnd.fold_in(rnd.key(0, device=CPU), ids))
    for design, target in ((add_intercept(x), w),
                           (torch.cat([add_intercept(x), w[..., None]], -1), y)):
        fit = logistic_glm(design, target)
        assert fit.n_iter.shape == fit.converged.shape == (8,)
        for i in range(8):
            one = logistic_glm(design[i], target[i])
            assert int(fit.n_iter[i]) == one.n_iter
            assert bool(fit.converged[i]) == one.converged
            np.testing.assert_allclose(fit.coef[i].numpy(), one.coef.numpy(), rtol=1e-5,
                                       atol=1e-6)
    assert torch.equal(add_intercept(x)[0], add_intercept(x[0]))


def test_batched_glm_lane_not_positive_definite_turns_nan():
    x = torch.ones((2, 8, 2), dtype=torch.float32)   # rank-1 design in both columns
    x[1, :, 1] = torch.linspace(-1, 1, 8)
    y = torch.tensor([[0, 1] * 4, [0, 0, 1, 0, 1, 1, 0, 1]], dtype=torch.float32)
    fit = logistic_glm(x, y)
    assert torch.isnan(fit.coef[0]).all() and int(fit.n_iter[0]) == 25
    assert torch.isfinite(fit.coef[1]).all()


# ── planner, cache keys, fingerprints ─────────────────────────────────


def test_cache_keys_plans_and_fingerprints_equal_jax():
    tspec = sc.MatrixSpec(dgps=(sc.STOCK_DGPS["calibration"], sc.STOCK_DGPS["sparse_highdim"]),
                          estimators=("naive", "ols", "lasso", "aipw_rf"), n_reps=10,
                          batch_width=4)
    jspec = jsc.MatrixSpec(dgps=(jsc.STOCK_DGPS["calibration"], jsc.STOCK_DGPS["sparse_highdim"]),
                           estimators=("naive", "ols", "lasso", "aipw_rf"), n_reps=10,
                           batch_width=4)
    for rows in (True, False):
        assert (dataclasses.replace(tspec, rows=rows).fingerprint()
                == dataclasses.replace(jspec, rows=rows).fingerprint())
    done = {sc.cell_row_id("calibration", "naive", r) for r in (0, 1, 5)}
    for shard in (None, True):
        tp, ts = sc.plan_columns(dataclasses.replace(tspec, shard=shard),
                                 done=lambda c: c in done)
        jp, js = jsc.plan_columns(dataclasses.replace(jspec, shard=shard),
                                  done=lambda c: c in done, devices=1)
        assert ts == js == ["sparse_highdim:ols", "sparse_highdim:aipw_rf"]
        assert [(p.name, p.width, p.mode, p.remaining, p.batches) for p in tp] == [
            (p.name, p.width, p.mode, p.remaining, p.batches) for p in jp]
    d = sc.STOCK_DGPS["calibration"]
    for width in (32, None):
        assert sc.column_cache_key(d, "naive", width) == jsc.column_cache_key(
            jsc.STOCK_DGPS["calibration"], "naive", width)
    assert sc.micro_matrix_spec(8, 8).fingerprint() == jsc.micro_matrix_spec(8, 8).fingerprint()
    np.testing.assert_array_equal(sc.pad_ids("calibration", (3, 4), 4),
                                  jsc.pad_ids("calibration", (3, 4), 4))
    np.testing.assert_array_equal(sc.batch_mask((3, 4), 4), jsc.batch_mask((3, 4), 4))


def test_matrix_spec_validation_and_env_knobs(monkeypatch):
    from ate_replication_causalml_torch.scenarios import matrix as mx

    with pytest.raises(ValueError, match="unknown scenario estimator"):
        sc.MatrixSpec(dgps=(sc.STOCK_DGPS["calibration"],), estimators=("nope",))
    with pytest.raises(ValueError, match="fail_policy"):
        sc.MatrixSpec(dgps=(sc.STOCK_DGPS["calibration"],), estimators=("naive",),
                      fail_policy="explode")
    with pytest.raises(ValueError, match="duplicate estimator"):
        sc.MatrixSpec(dgps=(sc.STOCK_DGPS["calibration"],), estimators=("naive", "naive"))
    monkeypatch.setenv("ATE_TPU_SCENARIO_BATCH", "zero")
    with pytest.raises(ValueError, match="ATE_TPU_SCENARIO_BATCH"):
        sc.micro_matrix_spec()
    monkeypatch.setenv("ATE_TPU_SCENARIO_BATCH", "16")
    monkeypatch.setenv("ATE_TPU_SCENARIO_REPS", "0")
    with pytest.raises(ValueError, match="ATE_TPU_SCENARIO_REPS"):
        sc.micro_matrix_spec()
    monkeypatch.setenv("ATE_TPU_SCENARIO_REPS", "24")
    assert (sc.micro_matrix_spec().batch_width, sc.micro_matrix_spec().n_reps) == (16, 24)
    monkeypatch.setenv("ATE_TPU_SCENARIO_ROWS", "1")
    assert sc.micro_matrix_spec().resolved_rows()
    # A world of one rank: the shard knob changes nothing; over several
    # ranks it shards (tests/test_torch_multigpu_estimators.py runs it).
    from ate_replication_causalml_torch.parallel import mesh as pm

    monkeypatch.setenv("ATE_TPU_SCENARIO_SHARD", "1")
    assert mx._resolve_shard(sc.micro_matrix_spec()) == 1
    monkeypatch.setattr(pm, "world_size", lambda: 2)
    assert mx._resolve_shard(sc.micro_matrix_spec()) == 2
    assert mx._resolve_shard(dataclasses.replace(sc.micro_matrix_spec(), shard=False)) == 1


def test_column_aggregates_and_compare_cells_equal_jax():
    nan = float("nan")

    def row(ate, se, tau, status="ok", method="c:e:0"):
        return {"ate": ate, "se": se, "tau_true": tau, "method": method, "column": "c:e",
                "lower_ci": ate - 1.96 * se if math.isfinite(se) else ate,
                "upper_ci": ate + 1.96 * se if math.isfinite(se) else ate, "status": status}

    rows = [row(0.5, 0.1, 0.5), row(0.5, 0.1, 0.8, method="c:e:1"),
            row(0.05, 0.1, 0.1, method="c:e:2"), row(nan, nan, 0.5, "failed", "c:e:3"),
            row(0.4, nan, 0.5, method="c:e:4")]
    for part in (rows, rows[:1], [], rows[4:]):
        assert sc.column_aggregates(part) == jsc.column_aggregates(part)
    other = [dict(r) for r in rows]
    other[0]["ate"] = float(np.nextafter(np.float32(0.5), np.float32(1.0)))
    assert sc.compare_cells(rows, other) == jsc.compare_cells(rows, other)
    assert sc.compare_cells(rows, other[:2])["missing"] == ["c:e:2", "c:e:3", "c:e:4"]


# ── degrade ───────────────────────────────────────────────────────────


def test_degrade_per_cell_and_failed_rows_retry(tmp_path, monkeypatch):
    calls = {"n": 0}

    def boom(spec, x, w, y, key):
        calls["n"] += 1
        raise ValueError("synthetic estimator failure")

    def nanest(spec, x, w, y, key):
        return torch.full((), torch.nan), torch.full((), torch.nan)

    monkeypatch.setitem(sc.SCENARIO_ESTIMATORS, "boom",
                        ScenarioEstimator("boom", boom, vmapped=False, needs_tall=False))
    monkeypatch.setitem(sc.SCENARIO_ESTIMATORS, "nanest",
                        ScenarioEstimator("nanest", nanest, needs_tall=False))
    spec = sc.MatrixSpec(dgps=(dataclasses.replace(sc.STOCK_DGPS["calibration"], n=N),),
                         estimators=("naive", "boom", "nanest"), n_reps=4, batch_width=8,
                         rows=True)
    out = str(tmp_path / "degrade")
    rep = sc.run_matrix(spec, outdir=out, scheduler="sequential", log=lambda s: None,
                        device=CPU)
    by_col: dict = {}
    for r in rep.cells:
        by_col.setdefault(r["column"], []).append(r)
    assert all(r["status"] == "ok" for r in by_col["calibration:naive"])
    assert all(r["status"] == "failed" for r in by_col["calibration:boom"])
    assert "synthetic estimator failure" in by_col["calibration:boom"][0]["error"]
    assert all(r["status"] == "failed" and "NonFinite" in r["error"]
               for r in by_col["calibration:nanest"])
    assert rep.n_failed == 8 and rep.n_computed == 4
    rep2 = sc.run_matrix(spec, outdir=out, scheduler="sequential", log=lambda s: None,
                         device=CPU)
    assert rep2.n_resumed == 4 and rep2.n_failed == 8 and calls["n"] == 8
    with pytest.raises(ValueError, match="synthetic estimator failure"):
        sc.run_matrix(dataclasses.replace(spec, fail_policy="raise", estimators=("boom",)),
                      scheduler="sequential", log=lambda s: None, device=CPU)


def test_sequential_path_matches_vmapped(monkeypatch):
    """The width-1 sequential (forest-class) path: for a row-reduction
    estimator its cells equal the vmapped column's on the same data."""
    from ate_replication_causalml_torch.scenarios.batched import _est_naive

    monkeypatch.setitem(sc.SCENARIO_ESTIMATORS, "naive_seq",
                        ScenarioEstimator("naive_seq", _est_naive, vmapped=False,
                                          needs_tall=False))
    dgp = dataclasses.replace(sc.STOCK_DGPS["calibration"], n=N)
    spec = sc.MatrixSpec(dgps=(dgp,), estimators=("naive", "naive_seq"), n_reps=4,
                         batch_width=4, rows=True)
    rep = sc.run_matrix(spec, scheduler="sequential", log=lambda s: None, device=CPU)
    assert rep.n_computed == 8 and rep.n_failed == 0
    by: dict = {}
    for r in rep.cells:
        by.setdefault(r["estimator"], {})[r["rep"]] = r
    for i in range(4):
        for f in ("ate", "se", "tau_true"):
            assert by["naive_seq"][i][f] == by["naive"][i][f], (i, f)


def test_run_matrix_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.run_matrix(sc.micro_matrix_spec(2, 2), log=lambda s: None)
