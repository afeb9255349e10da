"""Monte-Carlo scenario matrix of the port: the seeded synthetic DGP
library, the batched estimator columns, the matrix runner on the
SweepEngine (streaming aggregates by default, per-cell rows opt-in) and
the failure-frontier search. Port of
``ate_replication_causalml_tpu/scenarios``; see ``scenarios/matrix.py``
and ``scenarios/frontier.py`` for the contracts."""

from ate_replication_causalml_torch.scenarios.aggregate import (
    AGG_SCHEMA_TAG,
    N_STATS,
    STAT_FIELDS,
    AggState,
    aggregate_executable,
    batch_stats,
    fold_executable,
    fold_rows,
)
from ate_replication_causalml_torch.scenarios.batched import (
    MAX_VMAP_COLLAPSE_ULP,
    SCENARIO_ESTIMATORS,
    ScenarioEstimator,
    batch_mask,
    cell_fn,
    clear_executables,
    column_cache_key,
    column_executable,
    pad_ids,
    scalar_executable,
)
from ate_replication_causalml_torch.scenarios.dgp import (
    STOCK_DGPS,
    DGPSpec,
    data_cell_id,
    estimator_salt,
    generate,
)
from ate_replication_causalml_torch.scenarios.matrix import (
    ColumnPlan,
    MatrixReport,
    MatrixSpec,
    block_row_id,
    cell_row_id,
    column_aggregates,
    column_name,
    compare_cells,
    micro_matrix_spec,
    plan_columns,
    run_matrix,
    run_scalar_replay,
)

__all__ = [
    "AGG_SCHEMA_TAG", "MAX_VMAP_COLLAPSE_ULP", "N_STATS",
    "SCENARIO_ESTIMATORS", "STAT_FIELDS", "STOCK_DGPS",
    "AggState", "ColumnPlan", "DGPSpec", "MatrixReport", "MatrixSpec",
    "ScenarioEstimator",
    "aggregate_executable", "batch_mask", "batch_stats", "block_row_id",
    "cell_fn", "cell_row_id", "clear_executables", "column_aggregates",
    "column_cache_key", "column_executable", "column_name",
    "compare_cells", "data_cell_id", "estimator_salt", "fold_executable",
    "fold_rows", "generate", "micro_matrix_spec", "pad_ids",
    "plan_columns", "run_matrix", "run_scalar_replay",
    "scalar_executable",
]
