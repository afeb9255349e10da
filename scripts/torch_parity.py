"""Parity report at the notebook's size: the torch port against the JAX
package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_parity.py [--trees 32] > parity.json

The tests hold the port to the JAX package at small sizes; this script
runs the same comparisons, through the tests' own helpers
(``tests/test_torch_forest.py::classifier_pair``,
``tests/test_torch_aipw.py::build_frames`` and ``dr_pair``), at the
notebook's configuration: 120k-row synthetic pool → 50k-row sample →
11,016 biased rows, ``--trees`` trees of depth 9 (the JAX side on its
one-hot backend, which grows the same forest as its Pallas kernels in
interpret mode), a 1,000-replicate bootstrap. It prints one JSON object
with the measured max |Δ| of each component and both packages' DR-RF
numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402

import test_torch_aipw as aipw_tests  # noqa: E402
import test_torch_forest as forest_tests  # noqa: E402
from ate_replication_causalml_torch.models import forest as tf  # noqa: E402


def maxdiff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=32)
    args = ap.parse_args()
    t0 = time.perf_counter()
    _, jmod, _, tmod = aipw_tests.build_frames(120_000, 0, 50_000, dtypes=(np.float32,))[np.float32]
    x, w = np.asarray(jmod.x), np.asarray(jmod.w)
    ref, ref_pred, mine = forest_tests.classifier_pair(x, w, n_trees=args.trees, depth=9,
                                                       backend="onehot", new_rows=False)
    tvote = tf.predict_forest(mine, tmod.x, oob=True).vote
    out = aipw_tests.dr_pair(jmod, tmod, ref_pred["oob_vote"], tvote, n_boot=1000)
    (js, jb), (ts, tb) = out["jax"], out["torch"]
    (jmu0, jmu1), (tmu0, tmu1) = out["mu"]
    parity = {
        "frame x, w, y (exact)": max(maxdiff(tmod.x.numpy(), x), maxdiff(tmod.w.numpy(), w),
                                     maxdiff(tmod.y.numpy(), np.asarray(jmod.y))),
        "forest fields (exact)": {f: maxdiff(getattr(mine, f).numpy(), ref[f])
                                  for f in forest_tests.FIELDS},
        "OOB votes (exact)": maxdiff(tvote.numpy(), ref_pred["oob_vote"]),
        "outcome GLM mu0, mu1 (f32)": max(maxdiff(tmu0, jmu0), maxdiff(tmu1, jmu1)),
        "DR-RF tau (f32)": abs(ts.ate - js.ate),
        "DR-RF sandwich SE (f32)": abs(ts.se - js.se),
        "DR-RF bootstrap SE, 1000 replicates (f32)": abs(tb.se - jb.se),
    }
    print(json.dumps({
        "script": "scripts/torch_parity.py", "device": "cpu", "rows_biased": tmod.n,
        "trees": args.trees, "seconds": time.perf_counter() - t0,
        "dr_rf": {"jax": [js.ate, js.se, jb.se], "torch": [ts.ate, ts.se, tb.se]},
        "max_abs_diff": parity,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
