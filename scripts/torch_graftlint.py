#!/usr/bin/env python
"""torch-graftlint CLI — the PyTorch port's static analysis.

Usage:
    python scripts/torch_graftlint.py [paths...] [--json | --format FORMAT]
                                      [--select TGL003,...] [--cache DIR]
                                      [--show-suppressed] [--list-rules]

Default path: ``ate_replication_causalml_torch/``. Exits 0 on a clean
tree, 1 when findings remain (including files that do not parse), 2 on
usage errors. ``--format sarif`` emits a SARIF 2.1.0 log for code
scanners; ``--cache DIR`` keeps a content-hash result cache so warm
runs only re-lint changed files. Suppress individual findings with
``# graftlint: disable=TGL003`` (the JAX package's syntax; see README,
"The port's static analysis").
"""

from __future__ import annotations

import argparse
import os
import sys
import types

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

# Import ONLY the analysis subpackage: executing the port's __init__
# would import torch (and pin its TF32 switches) — slow, and wrong for a
# linter that must run in images with no accelerator stack at all. A
# namespace stub satisfies the package machinery; the analysis modules
# themselves are stdlib-only.
if "ate_replication_causalml_torch" not in sys.modules:
    _pkg = types.ModuleType("ate_replication_causalml_torch")
    _pkg.__path__ = [os.path.join(_REPO_ROOT, "ate_replication_causalml_torch")]
    sys.modules["ate_replication_causalml_torch"] = _pkg

from ate_replication_causalml_torch import analysis  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_graftlint", description=__doc__.split("\n")[1]
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=None,
        help="files/directories to lint (default: the package)",
    )
    ap.add_argument("--json", action="store_true", help="JSON report on stdout")
    ap.add_argument(
        "--format",
        choices=("human", "json", "sarif"),
        default=None,
        help="report format (default: human; --json is shorthand for json)",
    )
    ap.add_argument(
        "--select",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--cache",
        default=None,
        metavar="DIR",
        help="directory for the incremental result cache",
    )
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print findings silenced by graftlint comments",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule table and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        print(analysis.render_rule_table())
        return 0

    fmt = args.format or ("json" if args.json else "human")
    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
    paths = args.paths or [
        os.path.join(_REPO_ROOT, "ate_replication_causalml_torch")
    ]
    cache = analysis.ResultCache(args.cache, select=select) if args.cache else None
    try:
        result = analysis.lint_paths(
            paths, select=select, root=_REPO_ROOT, cache=cache
        )
    except ValueError as e:
        print(f"torch_graftlint: {e}", file=sys.stderr)
        return 2

    if fmt == "json":
        sys.stdout.write(analysis.render_json(result))
    elif fmt == "sarif":
        sys.stdout.write(analysis.render_sarif(result))
    else:
        print(analysis.render_human(result, show_suppressed=args.show_suppressed))
    return 1 if result.findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
