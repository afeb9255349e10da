"""Double machine learning (Chernozhukov et al.) with forest nuisances.

Port of ``ate_replication_causalml_tpu/estimators/dml.py``:

* ``chernozhukov`` (``ate_functions.R:332-369``): one cross-fit, an RF
  classifier of W on X (trained on fold 1) and an RF classifier of the
  binary outcome Y on X (trained on fold 2; the reference treats Y as
  classification, ``:336, 345-348``), both predicted on the FULL sample
  (vote fractions, in-sample for the fold each was trained on: the
  reference's partial cross-fitting, reproduced); residualize
  ``W~ = W - E[W|X]``, ``Y~ = Y - E[Y|X]``; the no-intercept OLS of Y~
  on W~ gives (tau, se);
* ``double_ml`` (``ate_functions.R:372-389``): the deterministic
  first-half/second-half split, the cross-fit run both ways, the taus
  AND the SEs averaged (the reference's anti-conservative SE, reproduced;
  a pooled SE via ``se_mode="pooled"``), or textbook cross-fitting with
  ``crossfit="full"``.

The four nuisance forests are the ported classifier forest
(``models/forest.py``): their histograms, routes and leaf lookups run on
the hand-written kernels, and under the packed policy
(``ATE_TPU_PREDICT_PACK=1``) their partition levels take the packed
pass. With integer weights every histogram sum is exact, so each forest
equals the JAX package's from the same key.
"""

from __future__ import annotations

import numpy as np
import torch

from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.models.causal_forest import check_no_mesh, stage
from ate_replication_causalml_torch.models.forest import fit_forest_classifier, predict_forest
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.linalg import ols_no_intercept_1d


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)


def _fit_nuisance_forest(frame: CausalFrame, train_idx, target: torch.Tensor, key,
                         n_trees, depth):
    """Classification forest of ``target`` on X over the ``train_idx``
    rows: the one nuisance fit both cross-fitting modes share."""
    sub = frame.take(train_idx)
    return fit_forest_classifier(sub.x, target[_index(train_idx, frame.device)], key,
                                 n_trees=n_trees, depth=depth)


def _rf_vote(frame, train_idx, target, key, n_trees, depth, x_pred, stage_times, label):
    """Fit on ``train_idx``, vote fractions on ``x_pred``; stage walls
    ``fit_<label>`` and ``predict_<label>`` into ``stage_times``."""
    with stage(stage_times, f"fit_{label}", frame.device):
        forest = _fit_nuisance_forest(frame, train_idx, target, key, n_trees, depth)
    with stage(stage_times, f"predict_{label}", frame.device):
        return predict_forest(forest, x_pred).vote


def _rf_prob_on_full(frame: CausalFrame, train_idx, target: torch.Tensor, key, n_trees, depth,
                     stage_times=None, label="nuisance"):
    """Vote fractions on the FULL sample (``ate_functions.R:352-357``:
    in-sample for the training fold, the reference's partial
    cross-fitting)."""
    return _rf_vote(frame, train_idx, target, key, n_trees, depth, frame.x, stage_times, label)


def chernozhukov(
    frame: CausalFrame,
    idx1,
    idx2,
    n_trees: int = 100,
    depth: int = 9,
    key: torch.Tensor | None = None,
    stage_times: dict | None = None,
    folds: tuple[str, str] = ("1", "2"),
) -> tuple[torch.Tensor, torch.Tensor]:
    """One DML cross-fit; returns (tau_hat, se_hat). ``folds`` name the
    two folds in the stage labels (``w<fold of idx1>``, ``y<fold of idx2>``)."""
    if key is None:
        key = rnd.key(123, device=frame.device)  # the seed the reference meant to set
    k1, k2 = rnd.split(key.to(frame.device)).unbind(dim=0)
    ew = _rf_prob_on_full(frame, idx1, frame.w, k1, n_trees, depth, stage_times, f"w{folds[0]}")
    ey = _rf_prob_on_full(frame, idx2, frame.y, k2, n_trees, depth, stage_times, f"y{folds[1]}")
    return ols_no_intercept_1d(frame.w - ew, frame.y - ey)


def _rf_prob_oof(frame: CausalFrame, train_idx, pred_idx, target, key, n_trees, depth,
                 stage_times=None, label="nuisance"):
    """Train on ``train_idx``, vote fractions ONLY on ``pred_idx`` (the
    held-out fold): the proper cross-fitting primitive."""
    return _rf_vote(frame, train_idx, target, key, n_trees, depth,
                    frame.x[_index(pred_idx, frame.device)], stage_times, label)


def double_ml(
    frame: CausalFrame,
    n_trees: int = 100,
    depth: int = 9,
    key: torch.Tensor | None = None,
    se_mode: str = "r",
    crossfit: str = "r",
    mesh=None,
    method: str = "Double Machine Learning",
    *,
    device=None,
    stage_times: dict | None = None,
) -> EstimatorResult:
    """2-fold DML with the reference's deterministic split.

    ``crossfit="r"`` (default) reproduces the reference's PARTIAL
    cross-fitting: each nuisance forest predicts on the full sample,
    in-sample for the fold it was trained on, and the two fold estimates
    are averaged with ``se_mode`` ("r" = averaged SEs, the reference's
    choice; "pooled" = sqrt(se1² + se2²)/2).

    ``crossfit="full"`` is textbook DML: both nuisances of each fold are
    trained on the other fold only, the out-of-fold predictions stitched
    into full-sample residuals, and one no-intercept OLS gives (tau, se);
    ``se_mode`` is ignored there.

    The JAX package's parameters in its order; ``mesh`` takes only None
    (the sharded forests are not ported). Runs on ``device`` (default ``cuda``; the frame moves there).
    ``stage_times``, when given, receives the wall seconds of each
    forest fit and prediction: ``fit_w1``, ``predict_w1``, … where the
    letter is the target and the digit the fold the forest was trained on.
    """
    check_no_mesh(mesh)
    if se_mode not in ("r", "pooled"):
        raise ValueError(f"se_mode must be 'r' or 'pooled', got {se_mode!r}")
    if crossfit not in ("r", "full"):
        raise ValueError(f"crossfit must be 'r' or 'full', got {crossfit!r}")
    dev = resolve_device(device)
    frame = frame.to(dev)
    key = rnd.key(123, device=dev) if key is None else key.to(dev)
    n = frame.n
    half = n // 2
    idx1 = np.arange(half)
    idx2 = np.arange(half, n)
    ka, kb = rnd.split(key).unbind(dim=0)
    if crossfit == "full":
        kw1, ky1 = rnd.split(ka).unbind(dim=0)
        kw2, ky2 = rnd.split(kb).unbind(dim=0)
        # The frame's precision, never below float32 (the votes are fractions).
        ew = torch.zeros(n, dtype=torch.promote_types(frame.w.dtype, torch.float32), device=dev)
        ey = torch.zeros(n, dtype=torch.promote_types(frame.y.dtype, torch.float32), device=dev)
        i1, i2 = _index(idx1, dev), _index(idx2, dev)
        args = (n_trees, depth, stage_times)
        # Fold k's nuisances come from the OTHER fold's rows only.
        ew[i1] = _rf_prob_oof(frame, idx2, idx1, frame.w, kw1, *args, label="w2").to(ew.dtype)
        ew[i2] = _rf_prob_oof(frame, idx1, idx2, frame.w, kw2, *args, label="w1").to(ew.dtype)
        ey[i1] = _rf_prob_oof(frame, idx2, idx1, frame.y, ky1, *args, label="y2").to(ey.dtype)
        ey[i2] = _rf_prob_oof(frame, idx1, idx2, frame.y, ky2, *args, label="y1").to(ey.dtype)
        tau, se = ols_no_intercept_1d(frame.w - ew, frame.y - ey)
        return EstimatorResult.from_point_se(method, tau, se)
    tau1, se1 = chernozhukov(frame, idx1, idx2, n_trees, depth, ka, stage_times, ("1", "2"))
    tau2, se2 = chernozhukov(frame, idx2, idx1, n_trees, depth, kb, stage_times, ("2", "1"))
    tau = (tau1 + tau2) / 2.0
    if se_mode == "r":
        se = (se1 + se2) / 2.0  # the reference averages the fold SEs (ate_functions.R:383)
    else:
        se = torch.sqrt(se1**2 + se2**2) / 2.0
    return EstimatorResult.from_point_se(method, tau, se)
