"""AIPW / doubly-robust estimators with sandwich and bootstrap SEs.

Port of ``ate_replication_causalml_tpu/estimators/aipw.py``:
``doubly_robust`` (``ate_functions.R:149-207``, random-forest
propensity) and ``doubly_robust_glm`` (``ate_functions.R:211-264``,
logistic propensity). Both share the same skeleton:

  1. outcome model: binomial-logit GLM of Y on [X, W] fit on the full
     sample; mu1/mu0 predicted with W forced to 1/0;
  2. a propensity model (RF OOB votes or in-sample GLM);
  3. the AIPW combination
     ``tau = mean(W(Y-mu1)/p + (1-W)(Y-mu0)/(1-p)) + mean(mu1-mu0)``;
  4. SE: either B=1000 nonparametric bootstrap of the combination step
     only (``ate_functions.R:267-283``) or the closed-form
     influence-function ("sandwich") SE ``sqrt(sum(I_i^2)/n^2)``.

The RF path clips p away from {0,1} to the smallest/largest interior
value observed (``ate_functions.R:181-182``); the GLM path does not.
"""

from __future__ import annotations

from typing import Callable

import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.ops import bootstrap as bt
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.glm import logistic_glm, predict_proba
from ate_replication_causalml_torch.ops.linalg import add_intercept


def _control_sign(compat: str) -> float:
    if compat == "r":
        return 1.0
    if compat == "fixed":
        return -1.0
    raise ValueError(f"compat must be 'r' or 'fixed', got {compat!r}")


def aipw_tau(w, y, p, mu0, mu1, compat: str = "r") -> torch.Tensor:
    """The AIPW combination (``ate_functions.R:183-185``). ``compat="r"``
    reproduces the reference's sign quirk (it ADDS the control
    augmentation, so the estimator is not doubly robust);
    ``compat="fixed"`` is textbook AIPW."""
    return bt._aipw_tau(w, y, p, mu0, mu1, _control_sign(compat))


def aipw_sandwich_se(w, y, p, mu0, mu1, tau) -> torch.Tensor:
    """Influence-function SE (``ate_functions.R:198-199``)."""
    ii = (
        (w * y) / p
        - mu1 * (w - p) / p
        - (((1.0 - w) * y / (1.0 - p)) + (mu0 * (w - p) / (1.0 - p)))
        - tau
    )
    n = ii.shape[0]
    return torch.sqrt(torch.sum(ii * ii) / (n * n))


def clip_propensity(p: torch.Tensor) -> torch.Tensor:
    """Replace exact 0/1 propensities with the nearest interior value
    observed (``ate_functions.R:181-182``)."""
    inf = torch.full_like(p, float("inf"))
    pmin = torch.min(torch.where(p > 0.0, p, inf))
    pmax = torch.max(torch.where(p < 1.0, p, -inf))
    p = torch.where(p == 0.0, pmin, p)
    return torch.where(p == 1.0, pmax, p)


def _outcome_model_mu(x, w, y):
    """Logit outcome model on [1, X, W]; mu1/mu0 via W := 1/0
    (``ate_functions.R:156-166``)."""
    base = add_intercept(x)
    with_w = lambda col: torch.cat([base, col[:, None]], dim=1)
    fit = logistic_glm(with_w(w), y)
    return (
        predict_proba(fit.coef, with_w(torch.zeros_like(w))),
        predict_proba(fit.coef, with_w(torch.ones_like(w))),
    )


def outcome_model_mu(frame: CausalFrame) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared AIPW nuisance ``(mu0, mu1)`` from the full-sample logit
    outcome model; pass it back through ``mu=`` to share one fit."""
    return _outcome_model_mu(frame.x, frame.w, frame.y)


def _aipw_result(frame, p, method, bootstrap_se, n_boot, key, boot_indices,
                 compat, mu) -> EstimatorResult:
    w, y = frame.w, frame.y
    cs = _control_sign(compat)
    mu0, mu1 = mu if mu is not None else _outcome_model_mu(frame.x, w, y)
    tau = aipw_tau(w, y, p, mu0, mu1, compat=compat)
    if bootstrap_se:
        se = bt.aipw_bootstrap_se(
            w, y, p, mu0, mu1, key=key, n_boot=n_boot, indices=boot_indices,
            control_sign=cs,
        )
    else:
        # The sandwich influence function is the STANDARD (minus-sign)
        # one in the reference too — under compat="r" the pairing of the
        # "+" point estimate with the "-" IF is part of the published
        # behavior being reproduced.
        se = aipw_sandwich_se(w, y, p, mu0, mu1, tau)
    return EstimatorResult.from_point_se(method, tau, se)


def doubly_robust_glm(
    frame: CausalFrame,
    bootstrap_se: bool = False,
    n_boot: int = 1000,
    key: torch.Tensor | None = None,
    boot_indices=None,
    method: str = "Doubly Robust with logistic regression PS",
    compat: str = "r",
    p: torch.Tensor | None = None,
    mu: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> EstimatorResult:
    """AIPW with in-sample GLM propensity, no clipping
    (``ate_functions.R:211-264``). ``p``/``mu`` accept precomputed
    nuisances; omitted, both are fit here."""
    _control_sign(compat)  # reject typos before the nuisance fit
    if p is None:
        p = logistic_glm(add_intercept(frame.x), frame.w).fitted
    if bootstrap_se and key is None and boot_indices is None:
        key = rnd.key(0, device=frame.device)
    return _aipw_result(frame, p, method, bootstrap_se, n_boot, key,
                        boot_indices, compat, mu)


def doubly_robust(
    frame: CausalFrame,
    propensity_fn: Callable[[CausalFrame], torch.Tensor],
    bootstrap_se: bool = False,
    n_boot: int = 1000,
    key: torch.Tensor | None = None,
    boot_indices=None,
    method: str = "Doubly Robust with Random Forest PS",
    compat: str = "r",
    mu: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> EstimatorResult:
    """AIPW with a pluggable propensity model and the reference's
    clip-to-interior rule (``ate_functions.R:149-207``). The canonical
    ``propensity_fn`` is ``models.forest.rf_oob_propensity``."""
    _control_sign(compat)  # reject typos before the forest fit
    p = clip_propensity(torch.as_tensor(propensity_fn(frame)).to(frame.w))
    if bootstrap_se and key is None and boot_indices is None:
        key = rnd.key(0, device=frame.device)
    return _aipw_result(frame, p, method, bootstrap_se, n_boot, key,
                        boot_indices, compat, mu)
