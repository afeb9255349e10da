"""Difference-in-means ATE (the reference's ``naive_ate``).

Port of ``ate_replication_causalml_tpu/estimators/naive.py``
(``ate_functions.R:3-21``):

    tau = E[Y|W=1] - E[Y|W=0]
    se  = sqrt( var_1/(n_1 - 1) + var_0/(n_0 - 1) )

The SE divides R's sample variance by n-1 again (``ate_functions.R:9``),
reproduced as-is since it is part of the published oracle CI. Run on
the unbiased RCT frame this is the oracle; on the biased frame it is
the known-bad baseline.
"""

from __future__ import annotations

import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators.base import EstimatorResult


def _naive_core(w: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    t = w == 1.0
    zero = torch.zeros_like(y)
    n1 = torch.sum(t).to(y.dtype)
    n0 = w.shape[0] - n1
    mean1 = torch.sum(torch.where(t, y, zero)) / n1
    mean0 = torch.sum(torch.where(t, zero, y)) / n0
    # R var(): n-1 denominator.
    var1 = torch.sum(torch.where(t, (y - mean1) ** 2, zero)) / (n1 - 1)
    var0 = torch.sum(torch.where(t, zero, (y - mean0) ** 2)) / (n0 - 1)
    tau = mean1 - mean0
    se = torch.sqrt(var1 / (n1 - 1) + var0 / (n0 - 1))
    return tau, se


def naive_ate(frame: CausalFrame, method: str = "naive") -> EstimatorResult:
    tau, se = _naive_core(frame.w, frame.y)
    return EstimatorResult.from_point_se(method, tau, se)
