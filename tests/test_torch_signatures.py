"""The port's entry points bind positional arguments as the JAX package's
do: each takes the JAX package's parameters, in its order, ahead of its
own; a small call made positionally gives the same results in both
packages; and every value of those parameters that the port does not
support raises.

Bounds (the same as the files that hold each entry point to the JAX
package): forests of integer-weight classifiers and leaf indices exact;
``predict_cate`` on one forest |Δ| ≤ 1e-6·(1 + |·|)
(``test_torch_causal_forest.py``); DML τ and SE |Δ| ≤ 1e-6
(``test_torch_dml.py``); the causal fit's nuisances within 1e-6 (OOB
means of exact forests, summed over trees in another order), its
half-samples exact and at least 90% of its split table equal (a float
tie may flip a split); the balancing QP's iterations equal and γ within
1e-11 (``test_torch_qp.py``), the residual_balancing row's τ and SE
within 5e-5 (``test_torch_balance.py``).
"""

import importlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import pipeline as tpipe
from ate_replication_causalml_torch.data.frame import CausalFrame as TFrame
from ate_replication_causalml_torch.estimators import balance as tbal
from ate_replication_causalml_torch.estimators import dml as td
from ate_replication_causalml_torch.estimators import lasso_est as tle
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import lasso as tla
from ate_replication_causalml_torch.ops import qp as tqp
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu import pipeline as jpipe
from ate_replication_causalml_tpu.data.frame import CausalFrame as JFrame
from ate_replication_causalml_tpu.estimators import dml as jd
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.models import forest as jf
from ate_replication_causalml_tpu.ops import lasso as jla
from ate_replication_causalml_tpu.ops import qp as jqp

# Both packages' estimators/__init__.py bind these module names to
# functions; import the modules themselves.
jbe = importlib.import_module("ate_replication_causalml_tpu.estimators.belloni")
tbe = importlib.import_module("ate_replication_causalml_torch.estimators.belloni")
jle = importlib.import_module("ate_replication_causalml_tpu.estimators.lasso_est")
jbal = importlib.import_module("ate_replication_causalml_tpu.estimators.balance")

ENTRY_POINTS = {
    "predict_cate": (jcf.predict_cate, tcf.predict_cate),
    "compute_leaf_index": (jcf.compute_leaf_index, tcf.compute_leaf_index),
    "fit_causal_forest": (jcf.fit_causal_forest, tcf.fit_causal_forest),
    "fit_forest_classifier": (jf.fit_forest_classifier, tf.fit_forest_classifier),
    "double_ml": (jd.double_ml, td.double_ml),
    "cv_glmnet": (jla.cv_glmnet, tla.cv_glmnet),
    "elnet_gaussian": (jla.elnet_gaussian, tla.elnet_gaussian),
    "lognet_binomial": (jla.lognet_binomial, tla.lognet_binomial),
    "default_foldid": (jla.default_foldid, tla.default_foldid),
    "predict_path": (jla.predict_path, tla.predict_path),
    "ate_condmean_lasso": (jle.ate_condmean_lasso, tle.ate_condmean_lasso),
    "ate_lasso": (jle.ate_lasso, tle.ate_lasso),
    "prop_score_lasso": (jle.prop_score_lasso, tle.prop_score_lasso),
    "belloni": (jbe.belloni, tbe.belloni),
    "balance_qp": (jqp.balance_qp, tqp.balance_qp),
    "balance_qp_x64": (jqp.balance_qp_x64, tqp.balance_qp_x64),
    "approx_balance": (jbal.approx_balance, tbal.approx_balance),
    "residual_balance_ate": (jbal.residual_balance_ate, tbal.residual_balance_ate),
    "run_sweep": (jpipe.run_sweep, tpipe.run_sweep),
}
CF_FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")


def _positional(fn):
    return [name for name, prm in inspect.signature(fn).parameters.items()
            if prm.kind in (prm.POSITIONAL_ONLY, prm.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_jax_parameters_are_a_prefix_in_order(name):
    """Every positional parameter of the JAX entry point, in its order,
    opens the port's positional list; the port's own extras come after
    them as keywords."""
    jax_fn, port_fn = ENTRY_POINTS[name]
    ref, mine = _positional(jax_fn), _positional(port_fn)
    assert mine[: len(ref)] == ref, (name, ref, mine)
    assert mine == ref, f"{name}: the port's extras must be keyword-only ({mine[len(ref):]})"


def _jax_key_pair(seed):
    with jax.enable_x64(False):
        k = jax.random.key(seed)
        data = np.asarray(jax.random.key_data(k))
    return k, rnd.key_from_jax(data, device="cpu")


@pytest.fixture(scope="module")
def carried():
    """A small causal forest made up from a seed (split tables with frozen
    nodes, leaf statistics with empty leaves, in-sample rows), as both
    packages' containers, and its query rows: 300 rows, 8 trees in
    groups of 2, depth 5."""
    rng = np.random.default_rng(21)
    t, depth, n, p, n_bins = 8, 5, 300, 4, 16
    x = rng.normal(size=(n, p)).astype(np.float32)
    edges = np.sort(rng.normal(size=(p, n_bins - 1)), axis=1).astype(np.float32)
    width = 1 << (depth - 1)
    feat = rng.integers(0, p, size=(t, depth, width)).astype(np.int32)
    thr = rng.integers(0, n_bins, size=(t, depth, width)).astype(np.int32)
    cnt = rng.poisson(3.0, size=(t, 1 << depth)).astype(np.float32)
    wt = rng.normal(scale=0.3, size=(t, 1 << depth)).astype(np.float32)
    yt = (wt + rng.normal(scale=0.5, size=(t, 1 << depth))).astype(np.float32)
    stats = np.stack([cnt, cnt * wt, cnt * yt, cnt * (wt * wt + 0.1), cnt * (wt * yt + 0.05)],
                     axis=2).astype(np.float32)
    in_sample = rng.random((t, n)) < 0.5
    fields = dict(split_feat=feat, split_bin=thr, leaf_stats=stats, in_sample=in_sample,
                  bin_edges=edges)
    jfo = jcf.CausalForest(**{f: jnp.asarray(a) for f, a in fields.items()})
    return x, jfo, tcf.causal_forest_from_jax(fields, device="cpu")


def test_compute_leaf_index_positional_row_chunk(carried):
    """(forest, x, tree_chunk, row_chunk): blocks of 3 trees, and 128
    rows (blocks in the JAX package, taken and validated by the port),
    give the JAX package's index, dtype included."""
    x, jfo, mine = carried
    with jax.enable_x64(False):
        ref = np.asarray(jcf.compute_leaf_index(jfo, jnp.asarray(x), 3, 128))
    got = tcf.compute_leaf_index(mine, torch.as_tensor(x), 3, 128)
    assert got.numpy().dtype == ref.dtype and np.array_equal(got.numpy(), ref)
    assert torch.equal(got, tcf.compute_leaf_index(mine, torch.as_tensor(x)))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(np.abs(a - b) <= 1e-6 * (1 + np.abs(b))))


@pytest.mark.parametrize("with_leaf_index", [False, True])
def test_predict_cate_positional_row_chunk_and_leaf_index(carried, with_leaf_index):
    """(forest, x, oob, tree_chunk, row_chunk, leaf_index, row_backend,
    variance_compat): row_chunk 128 (three blocks in the JAX package),
    with and without the leaf index, "grf" df. Within the bound of the
    JAX package's, and on the port the same bits as the call without
    them (the index is the same routing)."""
    x, jfo, mine = carried
    xt = torch.as_tensor(x)
    with jax.enable_x64(False):
        li = jcf.compute_leaf_index(jfo, jnp.asarray(x), 4, 128) if with_leaf_index else None
        ref = jcf.predict_cate(jfo, jnp.asarray(x), True, 4, 128, li, None, "grf")
    tli = tcf.compute_leaf_index(mine, xt, 4, 128) if with_leaf_index else None
    got = tcf.predict_cate(mine, xt, True, 4, 128, tli, None, "grf")
    assert _close(got.cate, ref.cate) and _close(got.variance, ref.variance)
    whole = tcf.predict_cate(mine, xt, True, 4, variance_compat="grf")
    assert torch.equal(got.cate, whole.cate) and torch.equal(got.variance, whole.variance)
    # "pallas" names the port's kernels as it names the JAX package's.
    same = tcf.predict_cate(mine, xt, True, 4, 128, tli, "pallas", "grf")
    assert torch.equal(same.cate, got.cate)


def _frames(seed, n, p):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x[:, 1] + (0.5 + x[:, 2]) * w)))).astype(np.float32)
    return x, w, y


def test_fit_forest_classifier_positional():
    """(x, y, key, n_trees, depth, mtry, n_bins, tree_chunk, hist_backend,
    hist_mode): integer weights, so the same forest field for field (the
    JAX package's "auto" backend on the CPU grows the same forest as its
    kernels)."""
    x, w, _ = _frames(2, 400, 5)
    jk, tk = _jax_key_pair(3)
    with jax.enable_x64(False):
        ref = jf.fit_forest_classifier(jnp.asarray(x), jnp.asarray(w), jk, 8, 4, 2, 16, 4,
                                       "auto", "dense")
    got = tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), tk, 8, 4, 2, 16, 4,
                                   "auto", "dense")
    for f in ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), f


def test_fit_causal_forest_positional():
    """(frame, key, n_trees, depth, nuisance_trees, nuisance_depth,
    hist_backend, hist_mode, mesh, axis_name)."""
    x, w, y = _frames(5, 300, 4)
    jk, tk = _jax_key_pair(7)
    with jax.enable_x64(False):
        ref = jcf.fit_causal_forest(JFrame(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)),
                                    jk, 8, 3, 8, 3, "auto", "dense", None, "tree")
    got = tcf.fit_causal_forest(TFrame(*(torch.as_tensor(a) for a in (x, w, y))),
                                tk, 8, 3, 8, 3, "auto", "dense", None, "tree")
    assert got.forest.split_feat.shape == tuple(ref.forest.split_feat.shape) == (8, 3, 4)
    assert np.array_equal(got.forest.in_sample.numpy(), np.asarray(ref.forest.in_sample))
    assert _close(got.y_hat, ref.y_hat) and _close(got.w_hat, ref.w_hat)
    same = ((got.forest.split_feat.numpy() == np.asarray(ref.forest.split_feat))
            & (got.forest.split_bin.numpy() == np.asarray(ref.forest.split_bin)))
    live = np.zeros(same.shape, bool)
    for lv in range(3):
        live[:, lv, : 1 << lv] = True
    assert same[live].mean() >= 0.9


def test_double_ml_positional():
    """(frame, n_trees, depth, key, se_mode, crossfit, mesh)."""
    x, w, y = _frames(9, 600, 5)
    jk, tk = _jax_key_pair(5)
    with jax.enable_x64(False):
        ref = jd.double_ml(JFrame(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)), 8, 4, jk,
                           "pooled", "r", None)
    got = td.double_ml(TFrame(*(torch.as_tensor(a) for a in (x, w, y))), 8, 4, tk, "pooled",
                       "r", None, device="cpu")
    assert got.method == ref.method
    assert abs(got.ate - ref.ate) <= 1e-6 and abs(got.se - ref.se) <= 1e-6


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "xla", "onehot", "pallas_bf16",
                                     "gather"])
def test_unported_hist_backend_raises(backend):
    """``hist_backend`` in its position: a name the JAX package does not
    take ("gather") raises. Its names are taken there and grow on the
    kernels (on the CPU their plain versions): "xla" and "onehot" (the
    matmul backends), "pallas", "pallas_interpret" and "pallas_bf16" (its
    bf16 form: integer weights stay exact) give an integer-weight forest
    equal to the kernel grower's, and each takes a causal fit ("xla" and
    "onehot" through the direct-ρ grower)."""
    x, w, y = _frames(1, 60, 3)
    _, tk = _jax_key_pair(1)
    if backend != "gather":
        got, ref = (tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), tk, 2, 2,
                                             None, 16, None, b) for b in (backend, "auto"))
        for f in ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        fit = tcf.fit_causal_forest(TFrame(*(torch.as_tensor(a) for a in (x, w, y))), tk, 2, 2,
                                    2, 2, backend)
        assert fit.forest.n_trees == 2 and torch.isfinite(fit.forest.leaf_stats).all()
        return
    with pytest.raises(ValueError, match="hist_backend"):
        tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), tk, 2, 2, None, 16,
                                 None, backend)
    with pytest.raises(ValueError, match="hist_backend"):
        tcf.fit_causal_forest(TFrame(*(torch.as_tensor(a) for a in (x, w, y))), tk, 2, 2, 2, 2,
                              backend)


def test_a_mesh_raises():
    """``mesh`` binds in the JAX package's position: a value that is not
    the port's ``Mesh``, or a mesh without the tree axis, raises; a
    one-rank tree mesh fits (the multi-rank fits:
    ``tests/test_torch_multigpu_*.py``)."""
    from ate_replication_causalml_torch.parallel.mesh import make_mesh

    x, w, y = _frames(1, 60, 3)
    frame = TFrame(*(torch.as_tensor(a) for a in (x, w, y)))
    _, tk = _jax_key_pair(1)
    for mesh in (object(), make_mesh(("fold",))):
        with pytest.raises(ValueError, match="mesh"):
            tcf.fit_causal_forest(frame, tk, 2, 2, 2, 2, "auto", None, mesh)
        with pytest.raises(ValueError, match="mesh"):
            td.double_ml(frame, 2, 2, tk, "r", "r", mesh, device="cpu")
    fit = tcf.fit_causal_forest(frame, tk, 2, 2, 2, 2, "auto", None, make_mesh(("tree",)))
    assert fit.forest.n_trees == 2


@pytest.mark.parametrize("row_backend", ["matmul", "pallas_interpret", "gather"])
def test_unported_row_backend_raises(carried, row_backend):
    """``row_backend`` in its position: "gather" raises; "matmul", the JAX
    package's one-hot route, is taken as a name of the kernels' route and
    "pallas_interpret", its CPU test mode, as the plain versions' (CPU
    tensors only): both give the default route's bits."""
    x, _, mine = carried
    if row_backend in ("matmul", "pallas_interpret"):
        got = tcf.predict_cate(mine, torch.as_tensor(x), True, 4, 128, None, row_backend)
        ref = tcf.predict_cate(mine, torch.as_tensor(x), True, 4, 128, None, None)
        assert torch.equal(got.cate, ref.cate) and torch.equal(got.variance, ref.variance)
        return
    with pytest.raises(ValueError, match="row_backend"):
        tcf.predict_cate(mine, torch.as_tensor(x), True, 4, 128, None, row_backend)


def test_bad_row_chunk_and_leaf_index_raise(carried):
    x, _, mine = carried
    xt = torch.as_tensor(x)
    with pytest.raises(ValueError, match="row_chunk"):
        tcf.predict_cate(mine, xt, True, 4, 0)
    with pytest.raises(ValueError, match="row_chunk"):
        tcf.compute_leaf_index(mine, xt, 4, 0)
    with pytest.raises(ValueError, match="leaf_index"):
        tcf.predict_cate(mine, xt, True, 4, 128, torch.zeros((8, 10), dtype=torch.uint8))


def _lasso_frames(seed, n, p):
    x, w, _ = _frames(seed, n, p)
    rng = np.random.default_rng(seed + 1)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.2 * w + rng.normal(size=n)).astype(np.float32)
    return (JFrame(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)),
            TFrame(*(torch.as_tensor(a) for a in (x, w, y))))


def test_cv_glmnet_and_paths_positional():
    """cv_glmnet(x, y, family, alpha, penalty_factor, nfolds, foldid, key,
    nlambda, fold_axis), elnet_gaussian / lognet_binomial(x, y, weights,
    penalty_factor, alpha, nlambda, lambdas, thresh), default_foldid(key,
    n, nfolds), predict_path(path, x, index): the same selected indices,
    paths within the float32 bound of ``tests/test_torch_lasso.py``."""
    jframe, tframe = _lasso_frames(3, 300, 4)
    pf = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    jk, tk = _jax_key_pair(6)
    with jax.enable_x64(False):
        jfold = jla.default_foldid(jk, 300, 5)
        ref = jla.cv_glmnet(jframe.x, jframe.y, "gaussian", 1.0, jnp.asarray(pf), 5, None, jk, 20,
                            None)
        eta = np.asarray(jla.predict_path(ref.path, jframe.x, ref.index_min))
        jpath = jla.lognet_binomial(jframe.x, jframe.w, None, jnp.asarray(pf), 1.0, 20, None, 1e-7)
    assert np.array_equal(tla.default_foldid(tk, 300, 5).numpy(), np.asarray(jfold))
    got = tla.cv_glmnet(tframe.x, tframe.y, "gaussian", 1.0, torch.as_tensor(pf), 5, None, tk, 20,
                        None)
    assert got.path.coefs.shape == (20, 4)
    assert (int(got.index_min), int(got.index_1se)) == (int(ref.index_min), int(ref.index_1se))
    rc = np.asarray(ref.path.coefs)
    assert np.all(np.abs(got.path.coefs.numpy() - rc) <= 5e-4 * (1 + np.abs(rc)))
    got_eta = tla.predict_path(got.path, tframe.x, got.index_min).numpy()
    assert np.all(np.abs(got_eta - eta) <= 5e-3)
    path = tla.lognet_binomial(tframe.x, tframe.w, None, torch.as_tensor(pf), 1.0, 20, None, 1e-7)
    assert path.coefs.shape == (20, 4)
    assert np.all(np.abs(path.coefs.numpy() - np.asarray(jpath.coefs)) <= 5e-4 * (
        1 + np.abs(np.asarray(jpath.coefs))))
    with pytest.raises(ValueError, match="fold_axis"):
        tla.cv_glmnet(tframe.x, tframe.y, "gaussian", 1.0, None, 5, None, tk, 20, "fold")


def test_lasso_estimators_positional():
    """ate_condmean_lasso / ate_lasso(frame, foldid, key, fold_axis, method),
    prop_score_lasso(frame, foldid, key, fold_axis), belloni(frame,
    foldid_xw, foldid_xy, key, fold_axis, compat, method): the same rows
    (float32 bounds of ``tests/test_torch_lasso_est.py``); a fold_axis
    raises."""
    jframe, tframe = _lasso_frames(4, 300, 3)
    fold = np.resize(np.arange(1, 11), 300)[np.random.default_rng(0).permutation(300)]
    fold2 = np.roll(fold, 7)
    jk, tk = _jax_key_pair(9)
    with jax.enable_x64(False):
        ref = [jle.ate_condmean_lasso(jframe, jnp.asarray(fold), None, None, "seq"),
               jle.ate_lasso(jframe, None, jk, None, "usual"),
               jbe.belloni(jframe, jnp.asarray(fold), jnp.asarray(fold2), None, None, "fixed", "b")]
        jp = np.asarray(jle.prop_score_lasso(jframe, None, jk, None))
    got = [tle.ate_condmean_lasso(tframe, fold, None, None, "seq"),
           tle.ate_lasso(tframe, None, tk, None, "usual"),
           tbe.belloni(tframe, fold, fold2, None, None, "fixed", "b")]
    for g, r, tol in zip(got, ref, (5e-5, 5e-5, 1e-5)):
        assert g.method == r.method and abs(g.ate - r.ate) <= tol
    assert abs(got[2].se - ref[2].se) <= 1e-5
    assert np.all(np.abs(tle.prop_score_lasso(tframe, None, tk, None).numpy() - jp) <= 1e-4)
    for call in (lambda: tle.ate_lasso(tframe, None, tk, "fold"),
                 lambda: tle.prop_score_lasso(tframe, None, tk, "fold"),
                 lambda: tbe.belloni(tframe, None, None, tk, "fold")):
        with pytest.raises(ValueError, match="fold_axis"):
            call()


def test_balance_qp_and_approx_balance_positional():
    """balance_qp / balance_qp_x64(x, target, zeta, ub, rho, max_iters,
    tol), approx_balance(x, target, zeta, ub, max_iters): a capped
    problem with another zeta, rho and tol gives the same iterations and
    weights."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(120, 5)) + 0.3
    target = x.mean(axis=0) * 0.5
    for jfn, tfn in ((jqp.balance_qp, tqp.balance_qp), (jqp.balance_qp_x64, tqp.balance_qp_x64)):
        ref = jfn(jnp.asarray(x), jnp.asarray(target), 0.3, 0.05, 2.0, 3000, 1e-8)
        got = tfn(torch.as_tensor(x), torch.as_tensor(target), 0.3, 0.05, 2.0, 3000, 1e-8)
        assert got.iters == int(ref.iters) < 3000
        assert np.max(np.abs(got.gamma.numpy() - np.asarray(ref.gamma))) <= 1e-11
        assert float(got.gamma.max()) <= 0.05 + 1e-12
    ref = np.asarray(jbal.approx_balance(jnp.asarray(x), jnp.asarray(target), 0.3, 0.05, 3000))
    got = tbal.approx_balance(torch.as_tensor(x), torch.as_tensor(target), 0.3, 0.05, 3000)
    assert got.dtype == torch.float32 and np.max(np.abs(got.numpy() - ref)) <= 1e-7


def test_residual_balance_ate_positional():
    """(frame, zeta, max_iters, key, method, estimate_se)."""
    jframe, tframe = _lasso_frames(12, 400, 4)
    jk, tk = _jax_key_pair(13)
    with jax.enable_x64(False):
        ref = jbal.residual_balance_ate(jframe, 0.4, 3000, jk, "rb", True)
    got = tbal.residual_balance_ate(tframe, 0.4, 3000, tk, "rb", True)
    assert got.method == ref.method == "rb"
    assert abs(got.ate - ref.ate) <= 5e-5 and abs(got.se - ref.se) <= 5e-5
    point = tbal.residual_balance_ate(tframe, 0.4, 3000, tk, "rb", False)
    assert point.ate == got.ate and np.isnan(point.se)


class _Reached(Exception):
    pass


def test_run_sweep_positional(tmp_path, monkeypatch):
    """(config, csv_path, outdir, plots, log, scheduler, workers,
    prefetch): both packages bind the same call the same way, up to the
    point where the sweep reads its data, in either scheduler mode; the
    port's own ``device`` is a keyword, and an unknown scheduler raises
    in both."""
    seen = {}

    def reached(pkg):
        def fn(config, csv_path=None, **kw):
            seen[pkg] = (config, csv_path)
            raise _Reached
        return fn

    monkeypatch.setattr(jpipe, "build_frames", reached("jax"))
    monkeypatch.setattr(tpipe, "build_frames", reached("torch"))
    logs = []
    for pkg, mod, extra in (("jax", jpipe, {}), ("torch", tpipe, {"device": "cpu"})):
        config = mod.SweepConfig(seed=3, use_mesh=False)
        for mode in (("sequential", None, None), ("concurrent", 2, False)):
            seen.pop(pkg, None)
            with pytest.raises(_Reached):
                mod.run_sweep(config, "data.csv", str(tmp_path / pkg), False, logs.append,
                              *mode, **extra)
            assert seen[pkg] == (config, "data.csv")
        assert os.path.isfile(os.path.join(tmp_path, pkg, "results.jsonl"))
        with pytest.raises(ValueError, match="scheduler"):
            mod.run_sweep(config, None, None, False, logs.append, "threads", None, None, **extra)

@pytest.mark.parametrize("entry", ["dryrun_multigpu", "run_ranks"])
def test_multi_gpu_entry_points_default_to_the_card(entry, monkeypatch):
    """``dryrun_multigpu`` (the counterpart of ``__graft_entry__.py``'s
    ``dryrun_multichip``) and ``run_ranks`` run on the card unless the
    caller names the CPU: ``device=None`` and ``backend=None`` by default,
    resolved through ``resolve_device`` (which raises without a card) and
    to ``nccl`` there; a CPU caller passes ``device="cpu",
    backend="gloo"``."""
    from ate_replication_causalml_torch.parallel import dryrun, spawn

    fn = {"dryrun_multigpu": dryrun.dryrun_multigpu, "run_ranks": spawn.run_ranks}[entry]
    params = inspect.signature(fn).parameters
    assert params["device"].default is None and params["backend"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        if entry == "run_ranks":
            fn(abs, 1)
        else:
            fn(1)
