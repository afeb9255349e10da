"""graftrace for the port: the whole-program concurrency analyzer
(JGL015–JGL019, and TGL022, the cross-stream hand-off).

Stdlib-only like the rest of the linter — importing this package never
imports torch. Importing it registers the program rules; the model
builder backs the committed ``analysis/concurrency_model.json`` artifact.
"""

from ate_replication_causalml_torch.analysis.concurrency.extract import (
    LOCK_FACTORIES,
    LockDef,
    ModuleConc,
    extract,
)
from ate_replication_causalml_torch.analysis.concurrency.flow import (
    Analysis,
    analyze,
    is_lane_lock,
)
from ate_replication_causalml_torch.analysis.concurrency.model import (
    MODEL_SCHEMA_VERSION,
    build_model,
    render_markdown,
    to_json,
)
from ate_replication_causalml_torch.analysis.concurrency import rules as _rules  # noqa: F401  (registers JGL015–JGL019, TGL022)

__all__ = [
    "Analysis",
    "LOCK_FACTORIES",
    "LockDef",
    "MODEL_SCHEMA_VERSION",
    "ModuleConc",
    "analyze",
    "build_model",
    "extract",
    "is_lane_lock",
    "render_markdown",
    "to_json",
]
