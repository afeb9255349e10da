"""Estimator library of the port: the counterpart of ``ate_functions.R``.

Every estimator takes a :class:`~ate_replication_causalml_torch.data.frame.CausalFrame`
and returns the uniform :class:`EstimatorResult` record
(``data.frame(Method, ATE, lower_ci, upper_ci)``). The names and
``__all__`` are the JAX package's ``estimators`` package's. The function
``belloni`` takes the name of its module here, as there: reach the
module as ``importlib.import_module("ate_replication_causalml_torch.estimators.belloni")``.
"""

from ate_replication_causalml_torch.estimators.aipw import (
    doubly_robust,
    doubly_robust_glm,
    outcome_model_mu,
)
from ate_replication_causalml_torch.estimators.balance import (
    approx_balance,
    residual_balance_ate,
)
from ate_replication_causalml_torch.estimators.base import (
    EstimatorResult,
    ResultTable,
    Z_95,
)
from ate_replication_causalml_torch.estimators.belloni import belloni
from ate_replication_causalml_torch.estimators.causal_forest_est import (
    causal_forest_ate,
    causal_forest_report,
)
from ate_replication_causalml_torch.estimators.dml import chernozhukov, double_ml
from ate_replication_causalml_torch.estimators.ipw import (
    logistic_propensity,
    prop_score_ols,
    prop_score_weight,
)
from ate_replication_causalml_torch.estimators.lasso_est import (
    ate_condmean_lasso,
    ate_lasso,
    prop_score_lasso,
)
from ate_replication_causalml_torch.estimators.naive import naive_ate
from ate_replication_causalml_torch.estimators.ols import ate_condmean_ols

__all__ = [
    "EstimatorResult",
    "ResultTable",
    "Z_95",
    "approx_balance",
    "ate_condmean_lasso",
    "ate_condmean_ols",
    "ate_lasso",
    "belloni",
    "causal_forest_ate",
    "causal_forest_report",
    "chernozhukov",
    "double_ml",
    "doubly_robust",
    "doubly_robust_glm",
    "logistic_propensity",
    "naive_ate",
    "outcome_model_mu",
    "prop_score_lasso",
    "prop_score_ols",
    "prop_score_weight",
    "residual_balance_ate",
]
