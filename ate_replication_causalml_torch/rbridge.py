"""reticulate bridge — the R-facing API surface of the port.

Port of ``ate_replication_causalml_tpu/rbridge.py``: an R session loads
this module through ``reticulate`` and calls functions with the
reference's signatures (``f(dataset, treatment_var, outcome_var, ...)``
returning a one-row ``data.frame(Method, ATE, lower_ci, upper_ci)``),
while every fit runs on the port (``cuda`` unless the caller passes
``device="cpu"``).

Marshalling contract (kept reticulate-trivial on purpose):

* ``dataset`` arrives as a named list / dict of numeric column vectors
  (R side: ``as.list(df)``). Everything that is neither the treatment
  nor the outcome column is a covariate, in dict order, mirroring the
  notebook's ``df_mod`` whose columns are exactly [covariates, W, Y].
  An explicit ``covariates=`` list overrides that default.
* Results return as plain dicts of scalars (reticulate → one-row
  data.frame). NaN CIs (the no-SE LASSO estimators,
  ``ate_functions.R:107, 129``) pass through as NA.

Each function takes the JAX bridge's parameters in its order, plus a
trailing ``device``. Frames are float32 on that device, and every key is
``ops/random.key(seed)`` where the JAX bridge writes
``jax.random.key(seed)``, so a row equals the direct port call with the
same seed. The JAX bridge's persistent compile cache has no counterpart.

The R wrappers live in ``r/ate_functions_torch.R`` beside this package's
notebook driver ``r/ate_replication_torch.Rmd``.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.data.schema import DatasetSchema
from ate_replication_causalml_torch.estimators import aipw, balance, belloni as bel, dml
from ate_replication_causalml_torch.estimators import ipw, lasso_est, naive, ols
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.estimators.causal_forest_est import causal_forest_report
from ate_replication_causalml_torch.models.forest import rf_oob_propensity
from ate_replication_causalml_torch.ops import random as rnd


def frame_from_columns(
    dataset,
    treatment_var: str = "W",
    outcome_var: str = "Y",
    covariates=None,
    dtype=torch.float32,
    device=None,
) -> CausalFrame:
    """Named columns → :class:`CausalFrame` on ``device`` (the bridge's
    only ingest)."""
    cols = {k: np.asarray(v, dtype=np.float64).ravel() for k, v in dict(dataset).items()}
    if treatment_var not in cols or outcome_var not in cols:
        raise ValueError(
            f"dataset must contain treatment {treatment_var!r} and outcome {outcome_var!r}; "
            f"has {sorted(cols)}"
        )
    if covariates is None:
        covariates = [k for k in cols if k not in (treatment_var, outcome_var)]
    else:
        covariates = [str(c) for c in covariates]
        missing = [c for c in covariates if c not in cols]
        if missing:
            raise ValueError(f"covariates not in dataset: {missing}")
    x = np.stack([cols[c] for c in covariates], axis=1) if covariates else np.zeros(
        (len(cols[treatment_var]), 0)
    )
    schema = DatasetSchema(
        continuous=tuple(covariates), binary=(),
        outcome=outcome_var, treatment=treatment_var,
    )
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
    return CausalFrame(x=as_t(x), w=as_t(cols[treatment_var]), y=as_t(cols[outcome_var]),
                       schema=schema)


def _row(res: EstimatorResult) -> dict:
    return {
        "Method": res.method,
        "ATE": float(res.ate),
        "lower_ci": float(res.lower_ci),
        "upper_ci": float(res.upper_ci),
    }


def _key(seed, frame: CausalFrame) -> torch.Tensor:
    return rnd.key(int(seed), device=frame.device)


def _host_vector(p) -> np.ndarray:
    return np.asarray(p.cpu().numpy() if isinstance(p, torch.Tensor) else p, np.float64)


# --- the reference's public API (ate_functions.R), on the port ----------

def naive_ate(dataset, treatment_var="W", outcome_var="Y", method="naive", device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    return _row(naive.naive_ate(frame, method=method))


def ate_condmean_ols(dataset, treatment_var="W", outcome_var="Y", device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    return _row(ols.ate_condmean_ols(frame))


def prop_score_weight(dataset, p, treatment_var="W", outcome_var="Y",
                      covariates=None, method="Propensity_Weighting", device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, covariates, device=device)
    return _row(ipw.prop_score_weight(frame, torch.as_tensor(_host_vector(p)), method=method))


def prop_score_ols(dataset, p, treatment_var="W", outcome_var="Y", device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    return _row(ipw.prop_score_ols(frame, torch.as_tensor(_host_vector(p))))


def logistic_propensity(dataset, treatment_var="W", outcome_var="Y", device=None):
    """The notebook's inline ``glm(W ~ ., binomial)`` propensity
    (``ate_replication.Rmd:164-168``): returns the fitted vector (host
    float64)."""
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    return _host_vector(ipw.logistic_propensity(frame.x, frame.w))


def ate_condmean_lasso(dataset, treatment_var="W", outcome_var="Y", covariates=None,
                       device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, covariates, device=device)
    return _row(lasso_est.ate_condmean_lasso(frame))


def ate_lasso(dataset, treatment_var="W", outcome_var="Y", covariates=None, device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, covariates, device=device)
    return _row(lasso_est.ate_lasso(frame))


def prop_score_lasso(dataset, treatment_var="W", outcome_var="Y", covariates=None, device=None):
    """Returns the LASSO-logit propensity vector, like the reference
    (``ate_functions.R:133-146`` returns predictions, not a row)."""
    frame = frame_from_columns(dataset, treatment_var, outcome_var, covariates, device=device)
    return _host_vector(lasso_est.prop_score_lasso(frame))


def doubly_robust(dataset, treatment_var="W", outcome_var="Y", num_trees=100,
                  bootstrap_se=False, seed=12325, compat="r", device=None):
    """``compat="r"`` (default) reproduces the reference's published
    sign-quirked AIPW combination (``ate_functions.R:183`` adds the
    control augmentation); ``"fixed"`` is textbook doubly-robust AIPW
    (``estimators/aipw.py::aipw_tau``). The propensity forest grows from
    ``key(seed)``, the bootstrap from ``key(seed + 1)``."""
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    res = aipw.doubly_robust(
        frame,
        propensity_fn=lambda f: rf_oob_propensity(f, _key(seed, f), n_trees=int(num_trees)),
        bootstrap_se=bool(bootstrap_se),
        key=_key(int(seed) + 1, frame),
        compat=compat,
    )
    return _row(res)


def doubly_robust_glm(dataset, treatment_var="W", outcome_var="Y",
                      bootstrap_se=False, seed=0, compat="r", device=None):
    """``compat``: see :func:`doubly_robust`."""
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    res = aipw.doubly_robust_glm(frame, bootstrap_se=bool(bootstrap_se), key=_key(seed, frame),
                                 compat=compat)
    return _row(res)


def belloni(dataset, treatment_var="W", outcome_var="Y", covariates=None,
            compat="r", device=None):
    frame = frame_from_columns(dataset, treatment_var, outcome_var, covariates, device=device)
    return _row(bel.belloni(frame, compat=compat))


def double_ml(dataset, treatment_var="W", outcome_var="Y", num_trees=100, seed=123,
              se_mode="r", crossfit="r", device=None):
    """``se_mode="r"`` reproduces the reference's averaged-SE quirk
    (``ate_functions.R:383``); ``"pooled"`` treats the folds as
    independent. ``crossfit="r"`` reproduces its partial cross-fitting
    (predict-on-full); ``"full"`` is textbook out-of-fold DML
    (``estimators/dml.py::double_ml``)."""
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    return _row(dml.double_ml(frame, n_trees=int(num_trees), key=_key(seed, frame),
                              se_mode=se_mode, crossfit=crossfit, device=frame.device))


def residual_balance_ATE(dataset, treatment_var="W", outcome_var="Y",
                         optimizer="admm", seed=0, device=None):
    # The reference's `optimizer=` selects quadprog vs pogs; both map to
    # the same graph-form ADMM solver here (SURVEY.md §2.3).
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    return _row(balance.residual_balance_ate(frame, key=_key(seed, frame)))


def causal_forest(dataset, treatment_var="W", outcome_var="Y", num_trees=2000,
                  seed=12345, variance_compat="unbiased", device=None):
    """The notebook's grf block (``ate_replication.Rmd:249-272``):
    returns the AIPW result row plus the deliberately 'incorrect'
    mean-CATE ATE/SE demo. ``variance_compat="grf"`` reproduces grf's
    num_groups between-group df (default: unbiased gn−1)."""
    frame = frame_from_columns(dataset, treatment_var, outcome_var, device=device)
    rep = causal_forest_report(frame, key=_key(seed, frame), n_trees=int(num_trees),
                               variance_compat=variance_compat)
    out = _row(rep.result)
    out["incorrect_ate"] = float(rep.incorrect_ate)
    out["incorrect_se"] = float(rep.incorrect_se)
    return out


def _sweep_config(n_obs=50_000, seed=1991, quick=False, overrides=None):
    """The :class:`~..pipeline.SweepConfig` that :func:`run_notebook_sweep`
    runs: the notebook's defaults at ``n_obs`` and ``seed``; ``quick``
    shrinks tree counts and the synthetic pool, and the pool is restored
    to at least 3 × ``n_obs`` so that the caller's ``n_obs`` is sampled;
    ``overrides`` (a dict of SweepConfig fields, e.g. ``list(dr_trees =
    500L)`` from R) are applied last, int fields coerced from R's floats."""
    from ate_replication_causalml_torch.data.pipeline import PrepConfig
    from ate_replication_causalml_torch.pipeline import SweepConfig

    cfg = SweepConfig(prep=PrepConfig(n_obs=int(n_obs), seed=int(seed)))
    if quick:
        q = cfg.quick()
        cfg = dataclasses.replace(
            q,
            prep=PrepConfig(n_obs=int(n_obs), seed=int(seed)),
            synthetic_pool=max(q.synthetic_pool, 3 * int(n_obs)),
        )
    if overrides:
        hints = typing.get_type_hints(SweepConfig)
        coerced = {}
        for k, v in dict(overrides).items():
            if k not in hints:
                raise ValueError(
                    f"unknown SweepConfig override {k!r}; valid: {sorted(hints)}"
                )
            coerced[k] = int(v) if hints[k] is int else v
        cfg = dataclasses.replace(cfg, **coerced)
    return cfg


def run_notebook_sweep(n_obs=50_000, seed=1991, outdir=None, quick=False,
                       overrides=None, device=None):
    """One-call driver for the R notebook: the full estimator sweep on
    the synthetic GGL panel at :func:`_sweep_config`'s configuration,
    through ``pipeline.run_sweep`` on ``device``. Returns the rows (the
    oracle first) as a list of dicts for rbind."""
    from ate_replication_causalml_torch.pipeline import run_sweep

    cfg = _sweep_config(n_obs, seed, quick, overrides)
    report = run_sweep(cfg, outdir=outdir, plots=outdir is not None, log=lambda s: None,
                       device=device)
    return [_row(report.oracle)] + [_row(r) for r in report.results.rows]
