# PyTorch/CUDA-backed estimator library for R — the reticulate shim.
#
# Drop-in replacements for the reference's estimator API
# (ate_functions.R): same function names, same
# `f(dataset, treatment_var, outcome_var, ...)` signatures, same one-row
# `data.frame(Method, ATE, lower_ci, upper_ci)` return, with every fit
# running on the PyTorch port through
# ate_replication_causalml_torch.rbridge (reticulate marshals the
# data.frame as a named list of columns; see rbridge.py's contract).
# Fits run on the CUDA card unless torch_init(device = "cpu").
#
# Usage:
#   source("ate_functions_torch.R")
#   torch_init()                    # once per session
#   result <- naive_ate(df, "W", "Y")

library(reticulate)

.torch <- new.env()

torch_init <- function(python = NULL, device = NULL) {
  if (!is.null(python)) reticulate::use_python(python, required = TRUE)
  .torch$bridge <- reticulate::import("ate_replication_causalml_torch.rbridge")
  .torch$device <- device
  invisible(.torch$bridge)
}

.bridge <- function() {
  if (is.null(.torch$bridge)) torch_init()
  .torch$bridge
}

# A dataset crosses the boundary as a named list of numeric columns.
.cols <- function(dataset) lapply(as.list(dataset), as.numeric)

.as_row <- function(res) {
  data.frame(
    Method = res$Method,
    ATE = res$ATE,
    lower_ci = ifelse(is.nan(res$lower_ci), NA, res$lower_ci),
    upper_ci = ifelse(is.nan(res$upper_ci), NA, res$upper_ci),
    stringsAsFactors = FALSE
  )
}

naive_ate <- function(dataset, treatment_var = "W", outcome_var = "Y") {
  .as_row(.bridge()$naive_ate(.cols(dataset), treatment_var, outcome_var,
                              device = .torch$device))
}

ate_condmean_ols <- function(dataset, treatment_var = "W", outcome_var = "Y") {
  .as_row(.bridge()$ate_condmean_ols(.cols(dataset), treatment_var, outcome_var,
                                     device = .torch$device))
}

logistic_propensity <- function(dataset, treatment_var = "W", outcome_var = "Y") {
  as.numeric(.bridge()$logistic_propensity(.cols(dataset), treatment_var, outcome_var,
                                           device = .torch$device))
}

prop_score_weight <- function(dataset, p, treatment_var = "W", outcome_var = "Y",
                              covariates = NULL) {
  .as_row(.bridge()$prop_score_weight(.cols(dataset), as.numeric(p),
                                      treatment_var, outcome_var, covariates,
                                      device = .torch$device))
}

prop_score_ols <- function(dataset, p, treatment_var = "W", outcome_var = "Y") {
  .as_row(.bridge()$prop_score_ols(.cols(dataset), as.numeric(p),
                                   treatment_var, outcome_var, device = .torch$device))
}

ate_condmean_lasso <- function(dataset, treatment_var = "W", outcome_var = "Y",
                               covariates = NULL) {
  .as_row(.bridge()$ate_condmean_lasso(.cols(dataset), treatment_var, outcome_var,
                                       covariates, device = .torch$device))
}

ate_lasso <- function(dataset, treatment_var = "W", outcome_var = "Y",
                      covariates = NULL) {
  .as_row(.bridge()$ate_lasso(.cols(dataset), treatment_var, outcome_var, covariates,
                              device = .torch$device))
}

prop_score_lasso <- function(dataset, treatment_var = "W", outcome_var = "Y",
                             covariates = NULL) {
  as.numeric(.bridge()$prop_score_lasso(.cols(dataset), treatment_var, outcome_var,
                                        covariates, device = .torch$device))
}

# compat = "r" reproduces the reference's sign-quirked AIPW combination
# (ate_functions.R:183 adds the control augmentation); "fixed" is the
# textbook doubly-robust correction.
doubly_robust <- function(dataset, treatment_var = "W", outcome_var = "Y",
                          num_trees = 100, bootstrap_se = FALSE,
                          seed = 12325, compat = "r") {
  .as_row(.bridge()$doubly_robust(.cols(dataset), treatment_var, outcome_var,
                                  as.integer(num_trees), bootstrap_se,
                                  as.integer(seed), compat, device = .torch$device))
}

doubly_robust_glm <- function(dataset, treatment_var = "W", outcome_var = "Y",
                              bootstrap_se = FALSE, seed = 0, compat = "r") {
  .as_row(.bridge()$doubly_robust_glm(.cols(dataset), treatment_var, outcome_var,
                                      bootstrap_se, as.integer(seed), compat,
                                      device = .torch$device))
}

belloni <- function(dataset, treatment_var = "W", outcome_var = "Y",
                    covariates = NULL, compat = "r") {
  .as_row(.bridge()$belloni(.cols(dataset), treatment_var, outcome_var,
                            covariates, compat, device = .torch$device))
}

# se_mode = "r" reproduces the reference's averaged-SE quirk
# (ate_functions.R:383; "pooled" treats folds as independent);
# crossfit = "r" its partial cross-fitting ("full" = textbook
# out-of-fold DML).
double_ml <- function(dataset, treatment_var = "W", outcome_var = "Y",
                      num_trees = 100, seed = 123, se_mode = "r",
                      crossfit = "r") {
  .as_row(.bridge()$double_ml(.cols(dataset), treatment_var, outcome_var,
                              as.integer(num_trees), as.integer(seed),
                              se_mode, crossfit, device = .torch$device))
}

residual_balance_ATE <- function(dataset, treatment_var = "W", outcome_var = "Y",
                                 optimizer = "admm") {
  .as_row(.bridge()$residual_balance_ATE(.cols(dataset), treatment_var, outcome_var,
                                         optimizer, device = .torch$device))
}

# variance_compat = "grf" reproduces grf's num_groups between-group df
# in the little-bags variance (default "unbiased" uses gn - 1).
causal_forest_torch <- function(dataset, treatment_var = "W", outcome_var = "Y",
                                num_trees = 2000, seed = 12345,
                                variance_compat = "unbiased") {
  res <- .bridge()$causal_forest(.cols(dataset), treatment_var, outcome_var,
                                 as.integer(num_trees), as.integer(seed),
                                 variance_compat, device = .torch$device)
  row <- .as_row(res)
  attr(row, "incorrect_ate") <- res$incorrect_ate
  attr(row, "incorrect_se") <- res$incorrect_se
  row
}
