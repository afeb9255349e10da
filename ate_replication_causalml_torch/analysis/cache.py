"""graftlint incremental result cache (``--cache <dir>``).

The gate re-lints the whole tree on every run; almost none of it
changed. Results are pure functions of (file content, rule set), so a
content-hash cache is exact, not heuristic:

* per-file key — sha256 of the relpath + source; stores that file's
  per-module findings and suppressed findings;
* program key — sha256 over every file's (relpath, content hash);
  stores the whole-program pass (JGL015+) wholesale, so a fully warm
  run parses nothing at all;
* salt — sha256 of the port analyzer's own sources plus the
  ``--select`` list. Editing any rule, or changing the selection,
  invalidates everything (cold/warm parity is asserted in tests).

Only keys touched by the current run are written back, so entries for
deleted or renamed files age out instead of accumulating.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

from ate_replication_causalml_torch.analysis.core import Finding

#: Bump on any change to the cache file layout.
CACHE_SCHEMA_VERSION = 1

_CACHE_BASENAME = "torch-graftlint-cache.json"


def _sha(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode("utf-8"))
        h.update(b"\0")
    return h.hexdigest()


def ruleset_salt(select=None) -> str:
    """Content hash of the analysis package itself — any rule edit must
    read as a different rule set."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    h.update(f"schema={CACHE_SCHEMA_VERSION}".encode())
    h.update(repr(sorted(select) if select is not None else None).encode())
    for root, dirs, files in os.walk(pkg_dir):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, pkg_dir).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _dump(findings: list[Finding]) -> list[dict]:
    return [f.as_dict() for f in findings]


def _load(rows: list[dict]) -> list[Finding]:
    return [Finding(**row) for row in rows]


class ResultCache:
    """Pass to :func:`core.lint_paths` (``cache=``); see the CLI's
    ``--cache`` flag."""

    def __init__(self, cache_dir: str, select=None):
        self.path = os.path.join(cache_dir, _CACHE_BASENAME)
        self.salt = ruleset_salt(select)
        self._entries: dict[str, dict] = {}
        self._live: dict[str, dict] = {}
        try:
            with open(self.path, encoding="utf-8") as f:
                payload = json.load(f)
            if payload.get("salt") == self.salt:
                self._entries = payload.get("entries", {})
        except (OSError, ValueError):
            pass  # cold start: corrupt/absent cache is just empty

    # ── keys ─────────────────────────────────────────────────────────

    @staticmethod
    def _module_key(relpath: str, source: str) -> str:
        return "m:" + _sha(relpath, source)

    @staticmethod
    def _program_key(entries) -> str:
        return "p:" + _sha(*(f"{rel}:{_sha(src or '')}" for _, rel, src in entries))

    # ── lookup / store ───────────────────────────────────────────────

    def _get(self, key: str):
        row = self._entries.get(key)
        if row is None:
            return None
        self._live[key] = row
        return _load(row["findings"]), _load(row["suppressed"])

    def _put(self, key: str, findings, suppressed) -> None:
        row = {"findings": _dump(findings), "suppressed": _dump(suppressed)}
        self._entries[key] = row
        self._live[key] = row

    def get_module(self, relpath: str, source: str):
        return self._get(self._module_key(relpath, source))

    def put_module(self, relpath: str, source: str, findings, suppressed):
        self._put(self._module_key(relpath, source), findings, suppressed)

    def get_program(self, entries):
        return self._get(self._program_key(entries))

    def put_program(self, entries, findings, suppressed):
        self._put(self._program_key(entries), findings, suppressed)

    # ── persistence ──────────────────────────────────────────────────

    def save(self) -> None:
        """Write back only the keys this run touched (atomic: a killed
        lint run never leaves a torn cache, just a stale one)."""
        payload = {
            "schema_version": CACHE_SCHEMA_VERSION,
            "salt": self.salt,
            "entries": dict(sorted(self._live.items())),
        }
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".tmp"
        )
        # The write IS atomic (tmp + os.replace) but must not import
        # observability.export — that would drag the runtime package
        # (and torch) into the stdlib-only linter, so the two suppressions below are
        # load-bearing, not a shortcut.
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:  # graftlint: disable=JGL005 — tmp half of a tmp+os.replace atomic write; export helpers are off-limits in the stdlib-only linter
                json.dump(payload, f)  # graftlint: disable=JGL005 — writes the tmp file above; os.replace publishes it atomically
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
