#!/usr/bin/env python
"""Validate the port's concurrency model against its schema (the JAX
package's schema and ``MODEL_SCHEMA_VERSION``).

Usage::

    python scripts/torch_check_concurrency_model.py [MODEL.json]

Default: ``ate_replication_causalml_torch/analysis/concurrency_model.json``.

Checks, in the style of ``check_metrics_schema.py``:

* schema version matches the analyzer's ``MODEL_SCHEMA_VERSION``;
* required top-level sections present with the right shapes;
* every lock id well-formed (``relpath::name``), unique, and pointing
  at a real committed file;
* every ``lock_order`` endpoint and every ``entry_locksets`` lock id
  resolving into the lock registry;
* the acquisition-order graph acyclic (a cycle here is JGL015 — it
  must never be *committed*);
* canonical serialization — the committed bytes equal
  ``json.dumps(model, indent=2, sort_keys=True)`` of themselves, so
  hand edits that survive a byte-compare are impossible.

Exits 0 when valid, 1 on violations (each printed), 2 on usage errors.
Stdlib-only: no torch (same package stub as torch_graftlint).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import types

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)
if "ate_replication_causalml_torch" not in sys.modules:
    _pkg = types.ModuleType("ate_replication_causalml_torch")
    _pkg.__path__ = [os.path.join(_REPO_ROOT, "ate_replication_causalml_torch")]
    sys.modules["ate_replication_causalml_torch"] = _pkg

from ate_replication_causalml_torch.analysis.concurrency import (  # noqa: E402
    MODEL_SCHEMA_VERSION,
)

MODEL_PATH = os.path.join(_REPO_ROOT, "ate_replication_causalml_torch", "analysis",
                          "concurrency_model.json")

_LOCK_ID_RE = re.compile(r"^[\w./-]+\.py::[\w.]+(\(\))?$")
_ENTRY_KINDS = {"thread", "pool", "http-handler"}


def _order_cycle(edges: list[dict]) -> list[str] | None:
    """Any cycle in the order graph (DFS three-color), or None."""
    graph: dict[str, list[str]] = {}
    for e in edges:
        graph.setdefault(e["from"], []).append(e["to"])
        graph.setdefault(e["to"], [])
    color: dict[str, int] = {}
    stack_path: list[str] = []

    def visit(v: str) -> list[str] | None:
        color[v] = 1
        stack_path.append(v)
        for w in sorted(graph[v]):
            if color.get(w, 0) == 1:
                return stack_path[stack_path.index(w):] + [w]
            if color.get(w, 0) == 0:
                got = visit(w)
                if got is not None:
                    return got
        stack_path.pop()
        color[v] = 2
        return None

    for v in sorted(graph):
        if color.get(v, 0) == 0:
            got = visit(v)
            if got is not None:
                return got
    return None


def validate_model(raw: str, root: str = _REPO_ROOT) -> list[str]:
    """All violations in the committed model text (empty == valid)."""
    errors: list[str] = []
    try:
        model = json.loads(raw)
    except ValueError as e:
        return [f"not valid JSON: {e}"]
    if not isinstance(model, dict):
        return ["top level must be an object"]

    if model.get("schema_version") != MODEL_SCHEMA_VERSION:
        errors.append(
            f"schema_version {model.get('schema_version')!r} != "
            f"analyzer's {MODEL_SCHEMA_VERSION}"
        )
    for section, ty in (
        ("locks", list), ("lock_order", list),
        ("thread_entries", list), ("entry_locksets", dict),
    ):
        if not isinstance(model.get(section), ty):
            errors.append(f"section {section!r} missing or not {ty.__name__}")
    if errors:
        return errors

    lock_ids: set[str] = set()
    for row in model["locks"]:
        lid = row.get("id", "")
        if not _LOCK_ID_RE.match(lid):
            errors.append(f"malformed lock id {lid!r}")
        if lid in lock_ids:
            errors.append(f"duplicate lock id {lid!r}")
        lock_ids.add(lid)
        rel = row.get("file", "")
        if not os.path.isfile(os.path.join(root, rel)):
            errors.append(f"lock {lid!r} points at missing file {rel!r}")
        if not (isinstance(row.get("line"), int) and row["line"] >= 1):
            errors.append(f"lock {lid!r} has bad line {row.get('line')!r}")

    for e in model["lock_order"]:
        for end in ("from", "to"):
            if e.get(end) not in lock_ids:
                errors.append(
                    f"lock_order endpoint {e.get(end)!r} not in the registry"
                )
        if not (isinstance(e.get("sites"), list) and e["sites"]):
            errors.append(
                f"lock_order edge {e.get('from')!r}->{e.get('to')!r} "
                f"has no witness sites"
            )

    cycle = _order_cycle(model["lock_order"])
    if cycle is not None:
        errors.append(
            "acquisition-order graph has a cycle (committed JGL015!): "
            + " -> ".join(cycle)
        )

    entry_ids: set[str] = set()
    for row in model["thread_entries"]:
        eid = row.get("id", "")
        entry_ids.add(eid)
        if row.get("kind") not in _ENTRY_KINDS:
            errors.append(f"entry {eid!r} has unknown kind {row.get('kind')!r}")
        rel = row.get("file", "")
        if not os.path.isfile(os.path.join(root, rel)):
            errors.append(f"entry {eid!r} points at missing file {rel!r}")

    for eid, locks in model["entry_locksets"].items():
        if eid not in entry_ids:
            errors.append(f"entry_locksets key {eid!r} not a thread entry")
        for lid in locks:
            if lid not in lock_ids:
                errors.append(
                    f"entry {eid!r} lockset references unknown lock {lid!r}"
                )

    canonical = json.dumps(model, indent=2, sort_keys=True) + "\n"
    if raw != canonical:
        errors.append(
            "file is not in canonical serialization "
            "(json.dumps indent=2 sort_keys=True + newline) — regenerate "
            "with scripts/torch_graftrace.py instead of editing by hand"
        )
    return errors


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_check_concurrency_model", description=__doc__.split("\n")[1]
    )
    ap.add_argument(
        "path",
        nargs="?",
        default=MODEL_PATH,
        help="model file (default: the port's committed model)",
    )
    args = ap.parse_args(argv)
    try:
        with open(args.path, encoding="utf-8") as f:
            raw = f.read()
    except OSError as e:
        print(f"torch_check_concurrency_model: {e}", file=sys.stderr)
        return 2
    errors = validate_model(raw)
    for err in errors:
        print(f"torch_check_concurrency_model: {err}", file=sys.stderr)
    if errors:
        print(f"torch_check_concurrency_model: FAILED ({len(errors)} violation(s))")
        return 1
    print("torch_check_concurrency_model: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
