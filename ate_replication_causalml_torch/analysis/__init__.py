"""graftlint for the PyTorch port: static analysis of the port's own code.

The JAX package's analyzer (``ate_replication_causalml_tpu/analysis``),
copied: its rules where they carry over (JGL005–JGL010, JGL012–JGL021,
the concurrency rules JGL015–JGL019), and a torch counterpart, prefixed
``TGL`` and numbered as the JAX rule it stands for, where the JAX rule
keys on JAX: captured or memoized bodies reading ambient state
(TGL001), PRNG keys of ``ops/random.py`` spent twice (TGL002), host
syncs on the hot path (TGL003), float64 drift and TF32 creep (TGL004),
row gathers on the predict path (TGL011), and tensors crossing CUDA
streams without a wait (TGL022). Run ``python scripts/torch_graftlint.py
<paths>`` or call :func:`lint_paths` / :func:`lint_source` directly. The
committed concurrency model is built by ``scripts/torch_graftrace.py``.

The analysis modules import neither torch nor the JAX package (stdlib
``ast`` + ``tokenize`` only). A plain ``import
ate_replication_causalml_torch.analysis`` still executes the parent
package's ``__init__``, which imports torch; the
``scripts/torch_graftlint.py`` CLI pre-registers a namespace stub for
the parent so the linter runs without torch.
"""

from ate_replication_causalml_torch.analysis.core import (
    PARSE_ERROR_ID,
    PROGRAM_RULES,
    RULES,
    Finding,
    LintResult,
    ProgramRule,
    Rule,
    all_rules,
    lint_paths,
    lint_source,
    lint_sources,
    register,
    register_program,
)
from ate_replication_causalml_torch.analysis import rules as _rules  # noqa: F401 — registers the per-module rules
from ate_replication_causalml_torch.analysis import concurrency as _concurrency  # noqa: F401 — registers JGL015-019, TGL022
from ate_replication_causalml_torch.analysis.cache import ResultCache
from ate_replication_causalml_torch.analysis.reporters import (
    render_human,
    render_json,
    render_rule_table,
    render_sarif,
)

__all__ = [
    "Finding",
    "LintResult",
    "PARSE_ERROR_ID",
    "PROGRAM_RULES",
    "RULES",
    "ProgramRule",
    "ResultCache",
    "Rule",
    "all_rules",
    "lint_paths",
    "lint_source",
    "lint_sources",
    "register",
    "register_program",
    "render_human",
    "render_json",
    "render_rule_table",
    "render_sarif",
]
