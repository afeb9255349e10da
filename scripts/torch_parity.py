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
  four forests compared field for field, |Δτ| and |ΔSE|.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
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
        "seconds": {"jax": t1 - t0, "torch": t2 - t1},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=32, help="DR-RF forest trees")
    ap.add_argument("--cf-trees", type=int, default=2000, help="causal forest trees")
    ap.add_argument("--cf-nuisance-trees", type=int, default=500)
    ap.add_argument("--dml-trees", type=int, default=2000, help="trees per DML nuisance forest")
    args = ap.parse_args()
    t0 = time.perf_counter()
    _, jmod, _, tmod = aipw_tests.build_frames(120_000, 0, 50_000, dtypes=(np.float32,))[np.float32]
    print(json.dumps({
        "script": "scripts/torch_parity.py", "device": "cpu", "rows_biased": tmod.n,
        "dr_rf": dr_rf(jmod, tmod, args.trees),
        "causal_forest": {"notebook": cf_notebook(jmod, tmod, args.cf_trees, args.cf_nuisance_trees),
                          "small": cf_small()},
        "dml": dml_row(jmod, tmod, args.dml_trees),
        "seconds": time.perf_counter() - t0,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
