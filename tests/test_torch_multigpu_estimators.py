"""The boot-, fold- and data-sharded estimators and the sharded scenario
matrix on two gloo ranks, against the JAX package's mesh on two of its
CPU devices and the port's own unsharded runs.

Contracts:

* ``aipw_bootstrap_se_sharded``: rank r draws from ``fold_in(key, r)``:
  its replicate rows are the JAX package's device r's bit for bit (exact
  threefry), the gathered taus are the port's one-process draws from
  those keys concatenated bit for bit, and the JAX package's taus and
  SE within ``tests/test_torch_aipw.py``'s float32 bound (|Δ| ≤ 1e-6:
  the same rows, means summed in another order);
* ``cv_glmnet(fold_axis="fold")``: the JAX package's fold-sharded
  ``index_min`` and ``index_1se``, and the port's unsharded CV bit for
  bit (cvm, cvsd, the path's λs and coefficients);
* the data-axis nuisance step in float64 (the JAX dry run's row-sharded
  ``nuisance_step``): p, μ0, μ1 within 1e-13 + 1e-12·|ref| and τ within
  1e-15 of the JAX package's and of the port's one-device fits (the
  float64 bounds of ``tests/test_torch_aipw.py``; only the summation
  order differs);
* the sharded matrix (``shard=True``): every cell equal to the unsharded
  column's (``compare_cells`` max_ulp 0), the cell-id upload metered
  (``host_upload``, 4 bytes an id over the ranks), as
  ``tests/test_scenarios.py::test_sharded_dispatch_matches_unsharded``
  asserts for the JAX package.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_rank_bodies as bodies
from ate_replication_causalml_torch import scenarios as sc
from ate_replication_causalml_torch.estimators import aipw as ta
from ate_replication_causalml_torch.ops import glm as tglm
from ate_replication_causalml_torch.ops import lasso as tl
from ate_replication_causalml_torch.ops.linalg import add_intercept as t_add_intercept
from ate_replication_causalml_torch.parallel.spawn import run_ranks
from ate_replication_causalml_tpu.estimators import aipw as ja
from ate_replication_causalml_tpu.ops import bootstrap as jb
from ate_replication_causalml_tpu.ops import glm as jglm
from ate_replication_causalml_tpu.ops import lasso as jl
from ate_replication_causalml_tpu.ops.linalg import add_intercept as j_add_intercept
from ate_replication_causalml_tpu.parallel.mesh import make_mesh, use_mesh

A = 2
N_BOOT = 64


def _boot_inputs():
    rng = np.random.default_rng(7)
    n = 257
    f = lambda a: a.astype(np.float32)
    return dict(w=f(rng.random(n) < 0.4), y=f(rng.normal(size=n)),
                p=f(np.clip(rng.random(n), 0.05, 0.95)), mu0=f(rng.normal(size=n) * 0.2),
                mu1=f(0.3 + rng.normal(size=n) * 0.2))


def _cv_cases():
    cases = []
    for family, n, p, seed in (("gaussian", 300, 8, 4), ("binomial", 300, 6, 5)):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, p))
        beta = np.zeros(p)
        beta[:3] = (1.5, -2.0, 1.0)
        eta = x @ beta
        y = (eta + 0.3 * rng.normal(size=n) if family == "gaussian"
             else (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float64))
        foldid = rng.permutation(np.resize(np.arange(1, 11), n))
        cases.append(dict(family=family, x=x, y=y, foldid=foldid, nfolds=10))
    return cases


def _glm_inputs():
    rng = np.random.default_rng(9)
    n = 256
    x = rng.normal(size=(n, 5))
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float64)
    y = (rng.random(n) < 1 / (1 + np.exp(-(0.5 * w + x[:, 1])))).astype(np.float64)
    return dict(x=x, w=w, y=y)


def _matrix_spec(shard: bool):
    dgp = dataclasses.replace(sc.STOCK_DGPS["calibration"], n=64, name="shardcal")
    return sc.MatrixSpec(dgps=(dgp,), estimators=("naive",), n_reps=8, batch_width=8,
                         shard=shard, rows=True)


@pytest.fixture(scope="module")
def ran():
    boot = _boot_inputs()
    cv_cases = _cv_cases()
    glm = _glm_inputs()
    devs = jax.devices()[:A]
    ref: dict = {}
    with jax.enable_x64(False):
        k = jax.random.key(5)
        boot["key"] = np.asarray(jax.random.key_data(k))
        jargs = [jnp.asarray(boot[n]) for n in ("w", "y", "p", "mu0", "mu1")]
        with use_mesh(make_mesh(("boot",), devices=devs)):
            ref["se"] = float(jb.aipw_bootstrap_se_sharded(*jargs, key=k, n_boot=N_BOOT,
                                                           axis_name="boot"))
        per = N_BOOT // A
        ref["taus"] = np.concatenate([np.asarray(jb.aipw_bootstrap_taus_chunked(
            *jargs, key=jax.random.fold_in(k, r), n_boot=per, chunk=per)) for r in range(A)])
    boot["n_boot"] = N_BOOT
    with jax.enable_x64(True):
        ref["cv"] = []
        with use_mesh(make_mesh(("fold",), devices=devs)):
            for c in cv_cases:
                cv = jl.cv_glmnet(jnp.asarray(c["x"]), jnp.asarray(c["y"]), c["family"],
                                  foldid=jnp.asarray(c["foldid"]), fold_axis="fold")
                ref["cv"].append((int(cv.index_min), int(cv.index_1se)))
        jmesh = make_mesh(("data",), devices=devs)
        rows = NamedSharding(jmesh, P("data"))
        xj = jax.device_put(jnp.asarray(glm["x"]), NamedSharding(jmesh, P("data", None)))
        wj, yj = (jax.device_put(jnp.asarray(glm[k]), rows) for k in ("w", "y"))

        @jax.jit
        def nuisance_step(x, w, y):
            mu0, mu1 = ja._outcome_model_mu(x, w, y)
            p = jglm.logistic_glm(j_add_intercept(x), w).fitted
            return ja.aipw_tau(w, y, p, mu0, mu1), p, mu0, mu1

        ref["glm"] = [np.asarray(v) for v in nuisance_step(xj, wj, yj)]
    ranks = run_ranks(bodies.estimators_body, A,
                      args=(boot, cv_cases, glm, _matrix_spec(True)), timeout=120)
    return dict(boot=boot, cv_cases=cv_cases, glm=glm, ref=ref, ranks=ranks)


def test_bootstrap_taus_bit_equal_and_se_within_bound(ran):
    from ate_replication_causalml_torch.ops import bootstrap as tb
    from ate_replication_causalml_torch.ops import random as rnd

    boot = ran["boot"]
    n, per = len(boot["w"]), N_BOOT // A
    key = rnd.key_from_jax(boot["key"], device="cpu")
    targs = [torch.as_tensor(boot[k]) for k in ("w", "y", "p", "mu0", "mu1")]
    one = torch.cat([tb.aipw_bootstrap_taus_chunked(*targs, key=rnd.fold_in(key, r), n_boot=per,
                                                    chunk=per) for r in range(A)]).numpy()
    with jax.enable_x64(False):
        jk = jax.random.wrap_key_data(jnp.asarray(boot["key"]))
        for r in range(A):   # the replicate rows: one chunk a rank
            want = jax.random.randint(jax.random.split(jax.random.fold_in(jk, r), 1)[0],
                                      (per, n), 0, n, dtype=jnp.int32)
            got = rnd.randint(rnd.split(rnd.fold_in(key, r), 1)[0], (per, n), 0, n)
            assert np.array_equal(got.numpy(), np.asarray(want))
    for r in ran["ranks"]:
        assert r["boot"]["taus"].dtype == np.float32
        assert np.array_equal(r["boot"]["taus"], one)
        assert float(np.abs(r["boot"]["taus"] - ran["ref"]["taus"]).max()) <= 1e-6
        assert abs(r["boot"]["se"] - ran["ref"]["se"]) <= 1e-6


@pytest.mark.parametrize("case", [0, 1], ids=["gaussian", "binomial"])
def test_fold_sharded_cv_equals_jax_indices_and_unsharded_bits(ran, case):
    c = ran["cv_cases"][case]
    plain = tl.cv_glmnet(torch.as_tensor(c["x"]), torch.as_tensor(c["y"]), c["family"],
                         foldid=c["foldid"], nfolds=c["nfolds"])
    for r in ran["ranks"]:
        got = r["cv"][case]
        assert (got["index_min"], got["index_1se"]) == ran["ref"]["cv"][case]
        assert (got["index_min"], got["index_1se"]) == (int(plain.index_min),
                                                        int(plain.index_1se))
        for name, want in (("cvm", plain.cvm), ("cvsd", plain.cvsd),
                           ("coefs", plain.path.coefs), ("lambdas", plain.path.lambdas)):
            assert np.array_equal(got[name], want.numpy()), name


def _within(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - (1e-13 + 1e-12 * np.abs(want))
    assert float(err.max()) <= 0.0, (what, float(np.abs(got - want).max()))


def test_data_sharded_nuisance_step_float64(ran):
    g = ran["glm"]
    t = lambda k: torch.as_tensor(g[k])
    mu0, mu1 = ta._outcome_model_mu(t("x"), t("w"), t("y"))
    p = tglm.logistic_glm(t_add_intercept(t("x")), t("w")).fitted
    one = [float(ta.aipw_tau(t("w"), t("y"), p, mu0, mu1)), p.numpy(), mu0.numpy(), mu1.numpy()]
    jtau, jp, jmu0, jmu1 = ran["ref"]["glm"]
    for r in ran["ranks"]:
        got = r["glm"]
        assert abs(got["tau"] - float(jtau)) <= 1e-15 and abs(got["tau"] - one[0]) <= 1e-15
        for name, want_j, want_one in (("p", jp, one[1]), ("mu0", jmu0, one[2]),
                                       ("mu1", jmu1, one[3])):
            _within(got[name], want_j, f"{name} vs JAX")
            _within(got[name], want_one, f"{name} vs one device")


def test_sharded_matrix_equals_unsharded(ran):
    plain = sc.run_matrix(_matrix_spec(False), scheduler="sequential", log=lambda s: None,
                          device="cpu")
    for r in ran["ranks"]:
        cmp = sc.compare_cells(plain.cells, r["matrix"]["cells"])
        assert not cmp["missing"] and cmp["max_ulp"] == 0.0, cmp["columns"]
    key = "artifact=shardcal:naive,path=host_upload"
    assert sum(r["matrix"]["moved"].get(key, 0) for r in ran["ranks"]) == 8 * 4
