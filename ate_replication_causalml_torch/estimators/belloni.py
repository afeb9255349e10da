"""Belloni–Chernozhukov–Hansen (2013) post-double-selection.

Port of ``ate_replication_causalml_tpu/estimators/belloni.py``, the
reference's ``belloni`` (``ate_functions.R:286-328``):

  1. expand X to all pairwise products, both orders and self-squares,
     k + k² columns (``ate_functions.R:289-296``; duplicated
     interactions enter the design twice, as published);
  2. two gaussian CV-LASSOs: X→W and X→Y (``:304-305``), fitted here as
     one batch (``cv_glmnet_many``: the same fits);
  3. coefficients with the reference's **wrong-λ bug**: both models at
     ``model_xw$lambda.min`` (``:308-309``), which for model_xy is an
     off-path value that R's ``coef`` serves by linear interpolation in
     λ (glmnet ``lambda.interp``): reproduced;
  4. support union with the reference's **sign bug**: ``> 0`` keeps only
     positive coefficients (``:312-313``), reproduced under ``compat="r"``
     (default); ``compat="fixed"`` uses ``!= 0``;
  5. OLS of Y on [X_selected, W] after R's aliasing rule; ATE and SE
     from W's coefficient.

Runs on the device of the frame; the support selection and the aliasing
rule are host-side logic, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.lasso import cv_glmnet_many
from ate_replication_causalml_torch.ops.linalg import add_intercept, alias_filter, ols


def interaction_expand(x: torch.Tensor) -> torch.Tensor:
    """[X, all pairwise products x_i*x_j in the reference's double-loop
    order] — (n, k + k^2)."""
    n, k = x.shape
    prods = (x[:, :, None] * x[:, None, :]).reshape(n, k * k)
    return torch.cat([x, prods], dim=1)


def _interp_coef_at(path_lambdas, coefs, s):
    """R glmnet ``coef(fit, s=)`` off-path behavior: linear interpolation
    between the two bracketing path λs (``lambda.interp``), constant
    extrapolation outside the path."""
    lams = path_lambdas
    n_lam = lams.shape[0]
    s = torch.clamp(torch.as_tensor(s).to(lams), lams[-1], lams[0])
    # The path is decreasing: the right bracket of -s in -lams.
    right = torch.clamp(torch.searchsorted(-lams, -s.reshape(1)), 1, n_lam - 1)[0]
    left = right - 1
    frac = (s - lams[right]) / (lams[left] - lams[right])
    return frac * coefs[left] + (1.0 - frac) * coefs[right]


def belloni(
    frame: CausalFrame,
    foldid_xw=None,
    foldid_xy=None,
    key: torch.Tensor | None = None,
    fold_axis: str | None = None,
    compat: str = "r",
    method: str = "Belloni et.al",
) -> EstimatorResult:
    if compat not in ("r", "fixed"):
        raise ValueError(f"compat must be 'r' or 'fixed', got {compat!r}")
    if key is None:
        key = rnd.key(0, device=frame.device)
    mesh = None
    if fold_axis is not None:
        from ate_replication_causalml_torch.parallel.mesh import get_mesh

        mesh = get_mesh()
    kxw, kxy = rnd.split(key).unbind(dim=-2)
    x_big = interaction_expand(frame.x)

    # The two CV-LASSOs (X→W, X→Y) share the design: one batch of 22 fits,
    # its coordinate descent sharded over ``fold_axis`` of the active mesh
    # when one is named.
    cv_xw, cv_xy = cv_glmnet_many(x_big, [frame.w, frame.y], "gaussian",
                                  foldids=[foldid_xw, foldid_xy], keys=[kxw, kxy],
                                  fold_axis=fold_axis, mesh=mesh)

    lam = cv_xw.lambda_min
    c_xw = _interp_coef_at(cv_xw.path.lambdas, cv_xw.path.coefs, lam).cpu().numpy()
    # The wrong-λ bug: model_xy evaluated at model_xw's lambda.min.
    c_xy = _interp_coef_at(cv_xy.path.lambdas, cv_xy.path.coefs, lam).cpu().numpy()

    if compat == "r":
        sel = (c_xw > 0) | (c_xy > 0)
    else:
        sel = (c_xw != 0) | (c_xy != 0)
    sel_idx = torch.as_tensor(np.nonzero(sel)[0], device=frame.device)

    # The expansion holds aliased columns (c1*c2 and c2*c1; squares of
    # binary flags equal the flag; further linear dependencies). R's lm()
    # drops them in its pivoted QR, left to right (``ate_functions.R:
    # 317-320``); alias_filter applies the same rule so the normal
    # equations see a full-rank design. W's coefficient is the same.
    cols = x_big[:, sel_idx]
    keep = torch.as_tensor(alias_filter(cols, with_intercept=True), device=frame.device)
    x_restricted = torch.cat([cols[:, keep], frame.w[:, None]], dim=1)
    fit = ols(add_intercept(x_restricted), frame.y)
    return EstimatorResult.from_point_se(method, fit.coef[-1], fit.se[-1])
