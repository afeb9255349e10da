"""Parity report: the torch port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_parity.py [--trees 32] [--cf-trees 2000] \
        [--dml-trees 2000] > parity.json

The tests hold the port to the JAX package at small sizes; this script
runs the same comparisons, through the tests' own helpers
(``tests/test_torch_forest.py::classifier_pair``,
``tests/test_torch_aipw.py::build_frames`` and ``dr_pair``,
``tests/test_torch_causal_forest.py::causal_pair``, ``split_comparison``
and ``_frames``, ``tests/test_torch_dml.py::_capture``), and prints one
JSON object:

* ``dr_rf`` — the "Doubly Robust with Random Forest PS" row at the
  notebook's configuration: 120k-row synthetic pool → 50k-row sample →
  11,016 biased rows, ``--trees`` trees of depth 9 (the JAX side on its
  one-hot backend, which grows the same forest as its Pallas kernels in
  interpret mode), a 1,000-replicate bootstrap; max |Δ| per component;
* ``causal_forest.notebook`` — the "Causal Forest(GRF)" row on the same
  frame with the sweep's key, ``--cf-trees`` causal trees of depth 8 and
  ``--cf-nuisance-trees`` nuisance trees of depth 9. The JAX package's
  CPU default grows the causal forest with its direct-ρ ``xla``
  formulation, not the ρ-decomposed streaming one the port follows, so
  this comparison is statistical, not bitwise;
* ``causal_forest.small`` — the streaming grower against the JAX
  package's ``pallas_interpret`` at the tests' sizes: split agreement,
  float ties, τ̂ on a carried-across forest, and the report end to end;
* ``dml`` — the "Double Machine Learning" row on the same frame with the
  sweep's key (``fold_in(key(0), crc32("dml"))``), ``--dml-trees`` trees
  of depth 9 per nuisance forest, ``crossfit="r"``, ``se_mode="r"``: the
  four forests compared field for field, |Δτ| and |ΔSE|;
* ``lasso`` — the four LASSO rows (Propensity_Weighting_LASSOPS,
  Single-equation LASSO, Usual LASSO, Belloni et.al under ``compat="r"``)
  on the same frame with the sweep's fold ids (``default_foldid`` of
  ``fold_in(key(0), crc32(name))``) and Belloni's key: each
  ``cv_glmnet``'s selected indices in both packages, the cvm gap at them
  against cvsd, the λ path and the coefficients in ulps, the fold ids'
  digests, τ and SE.

* ``balance`` — the residual_balancing row on the same frame with the
  sweep's key (``fold_in(key(0), crc32("balance"))``) and budget (12,000
  ADMM iterations): per arm its rows, ADMM iterations and worst residual
  in both packages, γ's max |Δ|, the fold ids' digests and ``index_min``
  (the values ``chip_smoke.py`` pins as ``BALANCE_FOLDS`` and
  ``BALANCE_INDEX``), the float32 covariate mean (the QP's target) in
  ulps, τ and SE (``BALANCE_JAX``);
* ``sweep`` — both packages' ``run_sweep`` on the CPU (the JAX package
  sequential, on one device, float32) at ``--sweep micro`` (the MICRO
  configuration of ``tests/test_pipeline_driver.py``) or ``quick``
  (``SweepConfig().quick()``, minutes): every row's τ and SE, and each
  package's row walls.

Every float comparison reports its max |Δ| and, under ``max_ulp_diff``,
its max |Δ| in float32 ulps of the JAX package's value
(``np.spacing``). ``--rows`` picks sections (default: all).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import hashlib
import importlib
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_aipw as aipw_tests  # noqa: E402
import test_torch_causal_forest as cf_tests  # noqa: E402
import test_torch_dml as dml_tests  # noqa: E402
import test_torch_forest as forest_tests  # noqa: E402
from ate_replication_causalml_torch.estimators import causal_forest_est as tce  # noqa: E402
from ate_replication_causalml_torch.estimators import dml as tdml  # noqa: E402
from ate_replication_causalml_torch.models import causal_forest as tcf  # noqa: E402
from ate_replication_causalml_torch.models import forest as tf  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402
from ate_replication_causalml_tpu.estimators import causal_forest_est as jce  # noqa: E402
from ate_replication_causalml_tpu.estimators import dml as jdml  # noqa: E402
from ate_replication_causalml_tpu.models import causal_forest as jcf  # noqa: E402


def maxdiff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def maxulp(a, b) -> float:
    """max |a − b| in float32 ulps of ``b`` (the JAX package's value)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)))


def dr_rf(jmod, tmod, trees: int) -> dict:
    x, w = np.asarray(jmod.x), np.asarray(jmod.w)
    ref, ref_pred, mine = forest_tests.classifier_pair(x, w, n_trees=trees, depth=9,
                                                       backend="onehot", new_rows=False)
    tvote = tf.predict_forest(mine, tmod.x, oob=True).vote
    out = aipw_tests.dr_pair(jmod, tmod, ref_pred["oob_vote"], tvote, n_boot=1000)
    (js, jb), (ts, tb) = out["jax"], out["torch"]
    (jmu0, jmu1), (tmu0, tmu1) = out["mu"]
    return {
        "trees": trees,
        "jax": [js.ate, js.se, jb.se], "torch": [ts.ate, ts.se, tb.se],
        "max_abs_diff": {
            "frame x, w, y (exact)": max(maxdiff(tmod.x.numpy(), x), maxdiff(tmod.w.numpy(), w),
                                         maxdiff(tmod.y.numpy(), np.asarray(jmod.y))),
            "forest fields (exact)": {f: maxdiff(getattr(mine, f).numpy(), ref[f])
                                      for f in forest_tests.FIELDS},
            "OOB votes (exact)": maxdiff(tvote.numpy(), ref_pred["oob_vote"]),
            "outcome GLM mu0, mu1 (f32)": max(maxdiff(tmu0, jmu0), maxdiff(tmu1, jmu1)),
            "DR-RF tau (f32)": abs(ts.ate - js.ate),
            "DR-RF sandwich SE (f32)": abs(ts.se - js.se),
            "DR-RF bootstrap SE, 1000 replicates (f32)": abs(tb.se - jb.se),
        },
        "max_ulp_diff": {
            "outcome GLM mu0, mu1 (f32)": max(maxulp(tmu0, jmu0), maxulp(tmu1, jmu1)),
            "DR-RF tau (f32)": maxulp(ts.ate, js.ate),
            "DR-RF sandwich SE (f32)": maxulp(ts.se, js.se),
            "DR-RF bootstrap SE, 1000 replicates (f32)": maxulp(tb.se, jb.se),
        },
    }


def cf_notebook(jmod, tmod, trees: int, nuisance_trees: int) -> dict:
    """The row at the notebook's size, each package on its own CPU path."""
    tag = zlib.crc32(b"causal_forest")
    kw = dict(n_trees=trees, nuisance_trees=nuisance_trees)
    t0 = time.perf_counter()
    with jax.enable_x64(False):
        ref = jce.causal_forest_report(jmod, key=jax.random.fold_in(jax.random.key(0), tag), **kw)
    t1 = time.perf_counter()
    got = tce.causal_forest_report(tmod, key=rnd.fold_in(rnd.key(0, device="cpu"), tag), **kw)
    t2 = time.perf_counter()
    row = lambda r: {"ate": r.result.ate, "se": r.result.se, "incorrect_ate": r.incorrect_ate,
                     "incorrect_se": r.incorrect_se}
    a, b = row(ref), row(got)
    return {
        "comparison": "statistical: the JAX package's CPU default grows the causal forest with "
                      "its direct-rho 'xla' formulation, the port with the rho-decomposed "
                      "streaming grower; same keys, not the same float sums",
        "trees": trees, "nuisance_trees": nuisance_trees,
        "jax": a, "torch": b, "abs_diff": {k: abs(a[k] - b[k]) for k in a},
        "seconds": {"jax": t1 - t0, "torch": t2 - t1},
    }


def cf_small() -> dict:
    """The streaming grower against ``pallas_interpret`` at the tests' sizes."""
    out = {}
    for name, cfg0 in cf_tests.CONFIGS.items():
        cfg = dict(cfg0)
        n, p = cfg.pop("n"), cfg.pop("p")
        x, wt, yt = cf_tests.residuals(5, n, p)
        ref, jfo, mine, key_data = cf_tests.causal_pair(x, wt, yt, **cfg)
        _, grow, _ = cf_tests.honest_masks(mine, key_data, n)
        agreement, ties, _ = cf_tests.split_comparison(x, wt, yt, ref, mine, grow)
        with jax.enable_x64(False):
            jp = jcf.predict_cate(jfo, jnp.asarray(x), oob=True)
        tp = tcf.predict_cate(tcf.causal_forest_from_jax(ref, device="cpu"), torch.as_tensor(x))
        out[name] = {
            "config": cfg0, "split_agreement": agreement,
            "differing_splits_on_agreeing_paths": len(ties),
            "tie_score_max_rel_diff": max((abs(a - b) / max(abs(a), abs(b)) for *_, a, b in ties),
                                          default=0.0),
            "in_sample (exact)": maxdiff(mine.in_sample.numpy(), ref["in_sample"]),
            "carried forest tau max |diff|": maxdiff(tp.cate.numpy(), np.asarray(jp.cate)),
            "carried forest variance max |diff|": maxdiff(tp.variance.numpy(),
                                                          np.asarray(jp.variance)),
            "max_ulp_diff": {"carried forest tau": maxulp(tp.cate.numpy(), np.asarray(jp.cate)),
                             "carried forest variance": maxulp(tp.variance.numpy(),
                                                               np.asarray(jp.variance))},
        }
    jframe, tframe = cf_tests._frames(5, 400, 5)
    kw = dict(n_trees=8, depth=4, nuisance_trees=8, nuisance_depth=4, n_bins=16, hist_mode="dense")
    with jax.enable_x64(False):
        k = jax.random.key(7)
        ref = jce.causal_forest_report(jframe, key=k, hist_backend="pallas_interpret", **kw)
        key_data = np.asarray(jax.random.key_data(k))
    got = tce.causal_forest_report(tframe, key=rnd.key_from_jax(key_data, device="cpu"), **kw)
    out["report"] = {"jax": [ref.result.ate, ref.result.se], "torch": [got.result.ate, got.result.se],
                     "abs_diff": [abs(got.result.ate - ref.result.ate),
                                  abs(got.result.se - ref.result.se)]}
    return out


def dml_row(jmod, tmod, trees: int) -> dict:
    """The DML row in both packages (float32), each on its own CPU path;
    the nuisance forests are integer-weight forests, equal field for field."""
    import pytest

    tag = zlib.crc32(b"dml")
    t0 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        jforests = dml_tests._capture(mp, jdml)
        ref = jdml.double_ml(jmod, n_trees=trees, depth=9,
                             key=jax.random.fold_in(jax.random.key(0), tag))
    t1 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        tforests = dml_tests._capture(mp, tdml)
        got = tdml.double_ml(tmod, n_trees=trees, depth=9,
                             key=rnd.fold_in(rnd.key(0, device="cpu"), tag), device="cpu")
    t2 = time.perf_counter()
    return {
        "trees": trees, "jax": [ref.ate, ref.se], "torch": [got.ate, got.se],
        "forest fields max |diff| (exact)": max(
            maxdiff(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
            for a, b in zip(tforests, jforests) for f in dml_tests.FIELDS),
        "abs_dtau": abs(got.ate - ref.ate), "abs_dse": abs(got.se - ref.se),
        "max_ulp_diff": {"tau": maxulp(got.ate, ref.ate), "se": maxulp(got.se, ref.se)},
        "seconds": {"jax": t1 - t0, "torch": t2 - t1},
    }


def fold_digest(foldid) -> str:
    """sha256 of the fold ids as little-endian int64, first 16 hex digits."""
    return hashlib.sha256(np.asarray(foldid, "<i8").tobytes()).hexdigest()[:16]


def _cv_capture(mp, *targets) -> list:
    """Record every cv_glmnet result computed through the (module, name)
    targets (``cv_glmnet``, or the port's ``cv_glmnet_many``: a list)."""
    seen = []
    for mod, name in targets:
        fit = getattr(mod, name)

        def rec(*a, _fit=fit, **k):
            out = _fit(*a, **k)
            seen.extend(out if isinstance(out, list) else [out])
            return out

        mp.setattr(mod, name, rec)
    return seen


def _cv_compare(got, ref) -> dict:
    """One cv_glmnet in both packages: the selected indices, the cvm gap
    at each package's index against cvsd, and the path in ulps."""
    cvm, cvsd = np.asarray(ref.cvm, np.float64), np.asarray(ref.cvsd, np.float64)
    out = {"index_min": [int(ref.index_min), int(got.index_min)],
           "index_1se": [int(ref.index_1se), int(got.index_1se)]}
    for name in ("index_min", "index_1se"):
        i, j = out[name]
        out[f"{name}_cvm_gap_over_cvsd"] = float(abs(cvm[i] - cvm[j]) / cvsd[i]) if i != j else 0.0
    j1 = int(ref.index_1se)
    out["max_ulp_diff"] = {
        "lambdas": maxulp(got.path.lambdas.numpy(), np.asarray(ref.path.lambdas)),
        "cvm": maxulp(got.cvm.numpy(), cvm),
        "coefs at index_1se": maxulp(got.path.coefs[j1].numpy(), np.asarray(ref.path.coefs[j1])),
    }
    out["max_abs_diff"] = {
        "coefs (whole path)": maxdiff(got.path.coefs.numpy(), np.asarray(ref.path.coefs)),
        "intercepts (whole path)": maxdiff(got.path.intercepts.numpy(),
                                           np.asarray(ref.path.intercepts)),
        "cvm": maxdiff(got.cvm.numpy(), cvm),
    }
    return out


def lasso_rows(jmod, tmod) -> dict:
    """The four LASSO rows in both packages (float32), each on its own CPU
    path, with the sweep's fold ids and keys."""
    import pytest

    jle = importlib.import_module("ate_replication_causalml_tpu.estimators.lasso_est")
    jbe = importlib.import_module("ate_replication_causalml_tpu.estimators.belloni")
    jipw = importlib.import_module("ate_replication_causalml_tpu.estimators.ipw")
    jlasso = importlib.import_module("ate_replication_causalml_tpu.ops.lasso")
    from ate_replication_causalml_torch.estimators import belloni as tbe
    from ate_replication_causalml_torch.estimators import ipw as tipw
    from ate_replication_causalml_torch.estimators import lasso_est as tle
    from ate_replication_causalml_torch.ops import lasso as tlasso

    def jkey(name):
        return jax.random.fold_in(jax.random.key(0), zlib.crc32(name.encode()))

    def tkey(name):
        return rnd.fold_in(rnd.key(0, device="cpu"), zlib.crc32(name.encode()))

    def run_jax():
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
            seen = _cv_capture(mp, (jle, "cv_glmnet"), (jbe, "cv_glmnet"))
            folds = {k: jlasso.default_foldid(jkey(k), jmod.n)
                     for k in ("ps_lasso", "seq_lasso", "usual_lasso")}
            p = jle.prop_score_lasso(jmod, foldid=folds["ps_lasso"])
            rows = [jipw.prop_score_weight(jmod, p, method="Propensity_Weighting_LASSOPS"),
                    jle.ate_condmean_lasso(jmod, foldid=folds["seq_lasso"]),
                    jle.ate_lasso(jmod, foldid=folds["usual_lasso"]),
                    jbe.belloni(jmod, key=jkey("belloni"))]
            kxw, kxy = jax.random.split(jkey("belloni"))
            folds["belloni_xw"] = jlasso.default_foldid(kxw, jmod.n)
            folds["belloni_xy"] = jlasso.default_foldid(kxy, jmod.n)
            return rows, list(seen), {k: np.asarray(v) for k, v in folds.items()}, np.asarray(p)

    def run_torch():
        with pytest.MonkeyPatch.context() as mp:
            seen = _cv_capture(mp, (tle, "cv_glmnet"), (tbe, "cv_glmnet_many"))
            folds = {k: tlasso.default_foldid(tkey(k), tmod.n)
                     for k in ("ps_lasso", "seq_lasso", "usual_lasso")}
            p = tle.prop_score_lasso(tmod, folds["ps_lasso"])
            rows = [tipw.prop_score_weight(tmod, p, method="Propensity_Weighting_LASSOPS"),
                    tle.ate_condmean_lasso(tmod, folds["seq_lasso"]),
                    tle.ate_lasso(tmod, folds["usual_lasso"]),
                    tbe.belloni(tmod, key=tkey("belloni"))]
            kxw, kxy = rnd.split(tkey("belloni")).unbind(dim=-2)
            folds["belloni_xw"] = tlasso.default_foldid(kxw, tmod.n)
            folds["belloni_xy"] = tlasso.default_foldid(kxy, tmod.n)
            return rows, list(seen), {k: v.numpy() for k, v in folds.items()}, p.numpy()

    t0 = time.perf_counter()
    jrows, jcv, jfolds, jp = run_jax()
    t1 = time.perf_counter()
    trows, tcv, tfolds, tp = run_torch()
    t2 = time.perf_counter()
    names = ["ps_lasso", "seq_lasso", "usual_lasso", "belloni_xw", "belloni_xy"]
    return {
        "fold_digests": {k: [fold_digest(jfolds[k]), fold_digest(tfolds[k])] for k in names},
        "folds_equal": all(np.array_equal(jfolds[k], tfolds[k]) for k in names),
        "cv_glmnet": {k: _cv_compare(g, r) for k, g, r in zip(names, tcv, jcv)},
        "lasso_propensity": {"max_abs_diff": maxdiff(tp, jp), "max_ulp_diff": maxulp(tp, jp)},
        "rows": {r.method: {"jax": [r.ate, r.se], "torch": [g.ate, g.se],
                            "abs_diff": [abs(g.ate - r.ate), abs(g.se - r.se)
                                         if np.isfinite(r.se) else None],
                            "max_ulp_diff": maxulp(g.ate, r.ate)}
                 for g, r in zip(trows, jrows)},
        "seconds": {"jax": t1 - t0, "torch": t2 - t1},
    }


def _tkey(name):
    return rnd.fold_in(rnd.key(0, device="cpu"), zlib.crc32(name.encode()))


def _jkey(name):
    return jax.random.fold_in(jax.random.key(0), zlib.crc32(name.encode()))


def balance_row(jmod, tmod, max_iters: int = 12_000) -> dict:
    """The residual_balancing row in both packages (float32 frames, the
    float64 ADMM), each on its own CPU path, with the sweep's key."""
    import pytest

    jb = importlib.import_module("ate_replication_causalml_tpu.estimators.balance")
    jlasso = importlib.import_module("ate_replication_causalml_tpu.ops.lasso")
    from ate_replication_causalml_torch.estimators import balance as tb
    from ate_replication_causalml_torch.ops import lasso as tlasso

    def timed_capture(mp, mod, name, sink):
        fn = getattr(mod, name)

        def rec(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sink.append((out, time.perf_counter() - t0))
            return out

        mp.setattr(mod, name, rec)

    treated = np.asarray(jmod.w) > 0.5
    masks = {"treated": treated, "control": ~treated}
    jqp, tqp, tcv = [], [], []
    t0 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        timed_capture(mp, jb, "approx_balance_sol", jqp)
        ref = jb.residual_balance_ate(jmod, key=_jkey("balance"), max_iters=max_iters)
        jtarget = np.asarray(jnp.mean(jmod.x, axis=0))
        k0, k1 = jax.random.split(_jkey("balance"))
        jarm = {}
        for arm, k in (("treated", k1), ("control", k0)):
            m = masks[arm]
            cv = jlasso.cv_glmnet(jmod.x[m], jmod.y[m], family="gaussian", alpha=0.9, key=k)
            jarm[arm] = (fold_digest(np.asarray(jlasso.default_foldid(k, int(m.sum())))),
                         int(cv.index_min))
    t1 = time.perf_counter()
    with pytest.MonkeyPatch.context() as mp:
        timed_capture(mp, tb, "approx_balance_sol", tqp)
        timed_capture(mp, tb, "cv_glmnet", tcv)
        got = tb.residual_balance_ate(tmod, key=_tkey("balance"), max_iters=max_iters)
    t2 = time.perf_counter()
    tk0, tk1 = rnd.split(_tkey("balance")).unbind(dim=-2)
    ttarget = torch.mean(tmod.x, dim=0).numpy()
    arms = {}
    for i, (arm, k) in enumerate((("treated", tk1), ("control", tk0))):
        (jg, jw, ji), jsec = jqp[i]
        (tg, tw, ti), tsec = tqp[i]
        n_arm = int(masks[arm].sum())
        arms[arm] = {
            "rows": n_arm,
            "admm_iters": [int(ji), int(ti)],
            "worst_resid": [float(jw), float(tw)],
            "qp_seconds": [jsec, tsec],
            "gamma f32 max |diff|": maxdiff(tg.numpy(), np.asarray(jg)),
            "fold_digest": [jarm[arm][0],
                            fold_digest(tlasso.default_foldid(k, n_arm).numpy())],
            "index_min": [jarm[arm][1], int(tcv[i][0].index_min)],
            "cv_seconds_torch": tcv[i][1],
        }
    return {
        "max_iters": max_iters, "arms": arms,
        "jax": [ref.ate, ref.se], "torch": [got.ate, got.se],
        "abs_diff": [abs(got.ate - ref.ate), abs(got.se - ref.se)],
        "max_abs_diff": {"target = mean(x, 0) (f32)": maxdiff(ttarget, jtarget)},
        "max_ulp_diff": {"target = mean(x, 0) (f32)": maxulp(ttarget, jtarget),
                         "tau": maxulp(got.ate, ref.ate), "se": maxulp(got.se, ref.se)},
        "seconds": {"jax": t1 - t0, "torch": t2 - t1},
    }


def sweep_rows(size: str) -> dict:
    """Both packages' run_sweep on the CPU at ``size`` ("micro" or
    "quick"), matched row by row."""
    import dataclasses

    from ate_replication_causalml_torch import pipeline as tpipe
    from ate_replication_causalml_torch.data.pipeline import PrepConfig as TPrep
    from ate_replication_causalml_tpu import pipeline as jpipe
    from ate_replication_causalml_tpu.data.pipeline import PrepConfig as JPrep

    def config(mod, prep):
        c = dataclasses.replace(mod.SweepConfig().quick(), use_mesh=False)
        if size == "micro":
            c = dataclasses.replace(c, prep=prep(n_obs=1200), synthetic_pool=3000, dr_trees=16,
                                    dml_trees=16, cf_trees=16, cf_nuisance_trees=16,
                                    forest_depth=4, balance_iters=600)
        return c

    quiet = lambda s: None
    t0 = time.perf_counter()
    with jax.enable_x64(False):
        ref = jpipe.run_sweep(config(jpipe, JPrep), plots=False, log=quiet, scheduler="sequential")
    t1 = time.perf_counter()
    got = tpipe.run_sweep(config(tpipe, TPrep), plots=False, log=quiet, device="cpu")
    t2 = time.perf_counter()
    jrows = {"oracle": ref.oracle, **{r.method: r for r in ref.results}}
    trows = {"oracle": got.oracle, **{r.method: r for r in got.results}}
    rows = {}
    for m, r in jrows.items():
        g = trows[m]
        rows[m] = {"jax": [r.ate, r.se], "torch": [g.ate, g.se],
                   "abs_diff": [abs(g.ate - r.ate), abs(g.se - r.se) if np.isfinite(r.se) else None],
                   "max_ulp_diff": maxulp(g.ate, r.ate),
                   "seconds": [ref.timings_s.get(m), got.timings_s.get(m)]}
    return {"size": size, "rows_biased": [ref.n_biased, got.n_biased],
            "same_methods_in_order": ref.results.methods() == got.results.methods(),
            "rows": rows, "torch_nuisance_seconds": {k: v for k, v in got.timings_s.items()
                                                     if k.startswith("artifact:")},
            "seconds": {"jax": t1 - t0, "torch": t2 - t1}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=32, help="DR-RF forest trees")
    ap.add_argument("--cf-trees", type=int, default=2000, help="causal forest trees")
    ap.add_argument("--cf-nuisance-trees", type=int, default=500)
    ap.add_argument("--dml-trees", type=int, default=2000, help="trees per DML nuisance forest")
    ap.add_argument("--rows", default="dr_rf,causal_forest,dml,lasso,balance,sweep",
                    help="comma-separated sections to run")
    ap.add_argument("--sweep", default="micro", choices=("micro", "quick"),
                    help="configuration of the sweep section")
    args = ap.parse_args()
    rows = set(args.rows.split(","))
    t0 = time.perf_counter()
    _, jmod, _, tmod = aipw_tests.build_frames(120_000, 0, 50_000, dtypes=(np.float32,))[np.float32]
    sections = {
        "dr_rf": lambda: dr_rf(jmod, tmod, args.trees),
        "causal_forest": lambda: {
            "notebook": cf_notebook(jmod, tmod, args.cf_trees, args.cf_nuisance_trees),
            "small": cf_small()},
        "dml": lambda: dml_row(jmod, tmod, args.dml_trees),
        "lasso": lambda: lasso_rows(jmod, tmod),
        "balance": lambda: balance_row(jmod, tmod),
        "sweep": lambda: sweep_rows(args.sweep),
    }
    unknown = rows - set(sections)
    if unknown:
        ap.error(f"unknown --rows {sorted(unknown)}")
    out = {"script": "scripts/torch_parity.py", "device": "cpu", "rows_biased": tmod.n}
    out.update({name: run() for name, run in sections.items() if name in rows})
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
