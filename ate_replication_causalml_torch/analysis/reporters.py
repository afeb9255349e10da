"""Finding reporters of the port's linter: human text, machine JSON, and
SARIF 2.1.0 (a copy of the JAX package's, with the port's tool name)."""

from __future__ import annotations

import json

from ate_replication_causalml_torch.analysis.core import (
    Finding,
    LintResult,
    all_rules,
)

#: The linter's name in reports: the port's linter, beside the JAX
#: package's ``graftlint``.
TOOL_NAME = "torch-graftlint"

#: Schema version of the JSON report (mirrors the observability
#: artifact convention: breaking layout changes bump it).
REPORT_SCHEMA_VERSION = 1

#: SARIF pins its own version; emitted verbatim in the log.
SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def render_human(result: LintResult, show_suppressed: bool = False) -> str:
    lines = [f.render() for f in result.findings]
    if show_suppressed:
        lines += [f"{f.render()} [suppressed]" for f in result.suppressed]
    by_rule: dict[str, int] = {}
    for f in result.findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    breakdown = (
        " (" + ", ".join(f"{r}×{n}" for r, n in sorted(by_rule.items())) + ")"
        if by_rule
        else ""
    )
    lines.append(
        f"{TOOL_NAME}: {len(result.findings)} finding(s){breakdown}, "
        f"{len(result.suppressed)} suppressed, {result.files} file(s) checked"
    )
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    payload = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "files": result.files,
        "findings": [f.as_dict() for f in result.findings],
        "suppressed": [f.as_dict() for f in result.suppressed],
        "rules": {
            rule_id: {"name": cls.name, "description": cls.description}
            for rule_id, cls in all_rules().items()
        },
    }
    return json.dumps(payload, indent=1) + "\n"


def _sarif_result(f: Finding, suppressed: bool) -> dict:
    out = {
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f.message},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line, "startColumn": f.col},
                }
            }
        ],
    }
    if suppressed:
        # SARIF's native representation of `# graftlint: disable=` —
        # viewers show these greyed out instead of dropping them.
        out["suppressions"] = [{"kind": "inSource"}]
    return out


def render_sarif(result: LintResult) -> str:
    """SARIF 2.1.0 log — one run, the full rule table as driver rules,
    suppressed findings carried with ``suppressions: inSource``."""
    rules = [
        {
            "id": rule_id,
            "name": cls.name,
            "shortDescription": {"text": cls.name},
            "fullDescription": {"text": cls.description},
        }
        for rule_id, cls in all_rules().items()
    ]
    log = {
        "$schema": _SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        "rules": rules,
                    }
                },
                "results": (
                    [_sarif_result(f, False) for f in result.findings]
                    + [_sarif_result(f, True) for f in result.suppressed]
                ),
            }
        ],
    }
    return json.dumps(log, indent=1) + "\n"


def render_rule_table() -> str:
    lines = []
    for rule_id, cls in all_rules().items():
        lines.append(f"{rule_id}  {cls.name:<24} {cls.description}")
    return "\n".join(lines)
