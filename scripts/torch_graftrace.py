#!/usr/bin/env python
"""torch-graftrace CLI — build/check the port's committed concurrency model.

Usage::

    python scripts/torch_graftrace.py             # (re)write the model
    python scripts/torch_graftrace.py --check     # regenerate and byte-compare
    python scripts/torch_graftrace.py --markdown  # refresh the model's
                                                  # markdown section in place

The model is ``ate_replication_causalml_torch/analysis/concurrency_model.json``
(the JAX package's is ``CONCURRENCY_MODEL.json`` at the repository root),
its markdown ``concurrency_model.md`` beside it.

The model (lock registry, acquisition-order DAG, thread-entry →
lock-set table) is a deterministic projection of the graftrace
analysis over the concurrency-scoped planes (scheduler/, serving/,
parallel/, observability/, resilience/, pipeline.py). ``--check`` is
what the static gate runs: a byte difference means the tree's
concurrency shape changed without the committed model being
regenerated. Exits 0 on success/match, 1 on mismatch, 2 on usage
errors. Stdlib-only: no torch (same package stub as torch_graftlint).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import types

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)
if "ate_replication_causalml_torch" not in sys.modules:
    _pkg = types.ModuleType("ate_replication_causalml_torch")
    _pkg.__path__ = [os.path.join(_REPO_ROOT, "ate_replication_causalml_torch")]
    sys.modules["ate_replication_causalml_torch"] = _pkg

from ate_replication_causalml_torch.analysis.core import (  # noqa: E402
    ModuleInfo,
    Program,
    iter_py_files,
)
from ate_replication_causalml_torch.analysis import concurrency  # noqa: E402

PKG = "ate_replication_causalml_torch"
MODEL_PATH = os.path.join(_REPO_ROOT, PKG, "analysis", "concurrency_model.json")
DOC_PATH = os.path.join(_REPO_ROOT, PKG, "analysis", "concurrency_model.md")
_GEN_BEGIN = "<!-- graftrace:begin -->"
_GEN_END = "<!-- graftrace:end -->"


def build_program(pkg_name: str = PKG) -> Program:
    """The modules of ``pkg_name`` (the port by default; the JAX
    package's name builds its model with the port's analyzer)."""
    pkg = os.path.join(_REPO_ROOT, pkg_name)
    modules = []
    for path in iter_py_files([pkg]):
        rel = os.path.relpath(path, _REPO_ROOT).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            modules.append(ModuleInfo(path, rel, source))
        except SyntaxError:
            pass  # torch_graftlint reports JGL000; the model skips the file
    return Program(modules)


def _atomic_write(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    # Same load-bearing suppression as the linter's result cache: this
    # script must stay importable without torch, so it cannot use
    # observability.export's atomic helpers — the tmp + os.replace pair
    # here IS the atomic-write recipe those helpers implement.
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:  # graftlint: disable=JGL005 — tmp half of a tmp+os.replace atomic write; export helpers would pull torch into the linter toolchain
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def refresh_markdown(model: dict) -> int:
    generated = concurrency.render_markdown(model)
    try:
        with open(DOC_PATH, encoding="utf-8") as f:
            doc = f.read()
    except OSError:
        print(f"torch_graftrace: {DOC_PATH} not found", file=sys.stderr)
        return 2
    begin = doc.find(_GEN_BEGIN)
    end = doc.find(_GEN_END)
    if begin < 0 or end < 0 or end < begin:
        print(
            f"torch_graftrace: {_GEN_BEGIN}/{_GEN_END} markers missing in "
            f"{DOC_PATH}", file=sys.stderr
        )
        return 2
    updated = (
        doc[: begin + len(_GEN_BEGIN)] + "\n" + generated + doc[end:]
    )
    if updated != doc:
        _atomic_write(DOC_PATH, updated)
        print(f"torch_graftrace: refreshed generated section of {DOC_PATH}")
    else:
        print(f"torch_graftrace: {DOC_PATH} already current")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_graftrace", description=__doc__.split("\n")[1]
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="regenerate and byte-compare against the committed model",
    )
    ap.add_argument(
        "--markdown",
        action="store_true",
        help="refresh the model markdown's generated section",
    )
    args = ap.parse_args(argv)

    model = concurrency.build_model(build_program())
    text = concurrency.to_json(model)

    if args.markdown:
        return refresh_markdown(model)

    if args.check:
        try:
            with open(MODEL_PATH, encoding="utf-8") as f:
                committed = f.read()
        except OSError:
            print(
                "torch_graftrace: the model is missing — run "
                "`python scripts/torch_graftrace.py` and commit it",
                file=sys.stderr,
            )
            return 1
        if committed != text:
            print(
                "torch_graftrace: the model is stale — the port's "
                "concurrency shape changed; regenerate with "
                "`python scripts/torch_graftrace.py` and review the diff",
                file=sys.stderr,
            )
            return 1
        print(
            f"torch_graftrace: model current ({len(model['locks'])} locks, "
            f"{len(model['lock_order'])} order edges, "
            f"{len(model['thread_entries'])} thread entries)"
        )
        return 0

    _atomic_write(MODEL_PATH, text)
    print(
        f"torch_graftrace: wrote {os.path.relpath(MODEL_PATH, _REPO_ROOT)} "
        f"({len(model['locks'])} locks, {len(model['lock_order'])} order "
        f"edges, {len(model['thread_entries'])} thread entries)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
