"""graftlint core for the PyTorch port: findings, suppressions, module
model, rule registry (a copy of the JAX package's ``analysis/core.py``).

An AST-based lint framework for the failure classes that cost card runs
silently instead of loudly: graph replays and cached builds keyed on
ambient state, PRNG keys spent twice, host syncs on the hot path, dtype
drift and TF32 creep against the float32 policy, torn file writes,
unlocked shared state, tensors crossing CUDA streams. Rules live in
:mod:`ate_replication_causalml_torch.analysis.rules`; the CLI is
``scripts/torch_graftlint.py``.

Deliberately stdlib-only (``ast`` + ``tokenize``): the linter must run
in CI images and pre-commit hooks without importing torch — importing the
package under analysis could itself initialize a backend.

Suppression syntax (the JAX package's; checked by tests/test_torch_analysis.py):

* ``code  # graftlint: disable=JGL001`` — suppress on this line
  (comma-separated rule ids, or ``all``);
* a comment-only line ``# graftlint: disable=JGL001`` suppresses the
  next line;
* ``# graftlint: disable-file=JGL004`` anywhere — suppress the rule for
  the whole file.

Suppressed findings are retained (``LintResult.suppressed``) so the
reporters can show what the comments are holding back.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Iterator

#: Rule id for files the parser itself rejects — always active, never
#: suppressible (a file that does not parse cannot carry comments we
#: trust).
PARSE_ERROR_ID = "JGL000"

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class Suppressions:
    """Per-file suppression state parsed from ``# graftlint:`` comments.

    Comments are found with :mod:`tokenize` (not a substring scan) so a
    ``#`` inside a string literal can never disable a rule.
    """

    def __init__(self, source: str):
        self.file_rules: set[str] = set()
        self.line_rules: dict[int, set[str]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                kind = m.group(1)
                rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
                if kind == "disable-file":
                    self.file_rules |= rules
                    continue
                line = tok.start[0]
                self.line_rules.setdefault(line, set()).update(rules)
                # A comment-only line shields the line below it.
                if tok.line[: tok.start[1]].strip() == "":
                    self.line_rules.setdefault(line + 1, set()).update(rules)
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # unparsable files are reported as JGL000 elsewhere

    def covers(self, rule: str, line: int) -> bool:
        if rule == PARSE_ERROR_ID:
            return False
        for rules in (self.file_rules, self.line_rules.get(line, ())):
            if rule in rules or "all" in rules:
                return True
        return False


class ModuleInfo:
    """Parsed module plus the name-resolution context rules share."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppressions = Suppressions(source)
        # alias -> canonical dotted prefix, e.g. np -> numpy,
        # dist -> torch.distributed, environ -> os.environ, partial ->
        # functools.partial. Collected from every import in the module
        # (function-local imports included: resolution is name-based,
        # not scope-exact, which is the right precision for linting).
        self.aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, with the
        leading alias expanded (``np.float64`` -> ``numpy.float64``),
        or None for non-name expressions."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])


class Rule:
    """Base class: subclasses set ``id``/``name``/``description`` and
    implement :meth:`check`."""

    id: str = ""
    name: str = ""
    description: str = ""

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, module: ModuleInfo, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=module.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
        )


class Program:
    """All modules of one lint run — the unit the whole-program rules
    (JGL015+) analyze. Interprocedural passes memoize their derived
    state on the instance (``_graftrace_*`` attributes)."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules = list(modules)
        self.by_relpath: dict[str, ModuleInfo] = {
            m.relpath: m for m in self.modules
        }


class ProgramRule(Rule):
    """A rule over the whole :class:`Program` instead of one module.

    ``check`` receives the program; findings still carry a module
    relpath (``self.finding(module, node, msg)``) so per-line
    suppression comments keep working."""

    def check(self, program: Program) -> Iterable[Finding]:  # type: ignore[override]
        raise NotImplementedError


#: Registered per-module rule classes keyed by id (populated by
#: @register).
RULES: dict[str, type[Rule]] = {}

#: Registered whole-program rule classes keyed by id (populated by
#: @register_program). Disjoint from RULES — one id, one registry.
PROGRAM_RULES: dict[str, type[ProgramRule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    if not cls.id or cls.id in RULES or cls.id in PROGRAM_RULES:
        raise ValueError(f"rule id {cls.id!r} missing or already registered")
    RULES[cls.id] = cls
    return cls


def register_program(cls: type[ProgramRule]) -> type[ProgramRule]:
    if not cls.id or cls.id in RULES or cls.id in PROGRAM_RULES:
        raise ValueError(f"rule id {cls.id!r} missing or already registered")
    PROGRAM_RULES[cls.id] = cls
    return cls


def all_rules() -> dict[str, type[Rule]]:
    """Per-module and program rules in one id-sorted map (reporters and
    ``--list-rules`` present a single table)."""
    merged: dict[str, type[Rule]] = {}
    merged.update(RULES)
    merged.update(PROGRAM_RULES)
    return dict(sorted(merged.items()))


@dataclasses.dataclass
class LintResult:
    """Aggregate outcome of a lint run."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    suppressed: list[Finding] = dataclasses.field(default_factory=list)
    files: int = 0

    def extend(self, other: "LintResult") -> None:
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        self.files += other.files

    def sort(self) -> None:
        key = lambda f: (f.path, f.line, f.col, f.rule)
        self.findings.sort(key=key)
        self.suppressed.sort(key=key)


def _split_rules(
    select: Iterable[str] | None,
) -> tuple[list[Rule], list[ProgramRule]]:
    if select is None:
        ids = list(RULES) + list(PROGRAM_RULES)
    else:
        ids = list(select)
        unknown = [i for i in ids if i not in RULES and i not in PROGRAM_RULES]
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(unknown)}")
    return (
        [RULES[i]() for i in ids if i in RULES],
        [PROGRAM_RULES[i]() for i in ids if i in PROGRAM_RULES],
    )


def _active_rules(select: Iterable[str] | None) -> list[Rule]:
    return _split_rules(select)[0]


def _route(module: ModuleInfo | None, f: Finding, result: LintResult) -> None:
    if module is not None and module.suppressions.covers(f.rule, f.line):
        result.suppressed.append(f)
    else:
        result.findings.append(f)


def _run_module_rules(
    module: ModuleInfo, rules: list[Rule], result: LintResult
) -> None:
    for rule in rules:
        for f in rule.check(module):
            _route(module, f, result)


def _run_program_rules(
    modules: list[ModuleInfo], rules: list[ProgramRule], result: LintResult
) -> None:
    if not rules:
        return
    program = Program(modules)
    for rule in rules:
        for f in rule.check(program):
            _route(program.by_relpath.get(f.path), f, result)


def _parse_error(path: str, e: Exception) -> Finding:
    return Finding(
        rule=PARSE_ERROR_ID,
        path=path,
        line=getattr(e, "lineno", None) or 1,
        col=(getattr(e, "offset", None) or 1),
        message=f"file does not parse: {e.msg if isinstance(e, SyntaxError) else e}",
    )


def lint_source(
    source: str,
    path: str = "<string>",
    relpath: str | None = None,
    select: Iterable[str] | None = None,
) -> LintResult:
    """Lint one source string. ``relpath`` is what path-scoped rules
    (JGL004/005/006) match against; defaults to ``path``. Program rules
    (JGL015+) run over the single-module program — known-bad fixtures
    exercise them exactly like the per-module rules."""
    result = LintResult(files=1)
    mod_rules, prog_rules = _split_rules(select)
    try:
        module = ModuleInfo(path, relpath if relpath is not None else path, source)
    except (SyntaxError, ValueError) as e:
        result.findings.append(_parse_error(relpath if relpath is not None else path, e))
        return result
    _run_module_rules(module, mod_rules, result)
    _run_program_rules([module], prog_rules, result)
    result.sort()
    return result


def lint_sources(
    sources: Iterable[tuple[str, str]],
    select: Iterable[str] | None = None,
) -> LintResult:
    """Lint ``(relpath, source)`` pairs as ONE program — the multi-module
    fixture entry point for the interprocedural rules."""
    result = LintResult()
    mod_rules, prog_rules = _split_rules(select)
    modules: list[ModuleInfo] = []
    for relpath, source in sources:
        result.files += 1
        try:
            module = ModuleInfo(relpath, relpath, source)
        except (SyntaxError, ValueError) as e:
            result.findings.append(_parse_error(relpath, e))
            continue
        modules.append(module)
        _run_module_rules(module, mod_rules, result)
    _run_program_rules(modules, prog_rules, result)
    result.sort()
    return result


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into .py files, sorted, skipping
    __pycache__ and hidden directories."""
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs if d != "__pycache__" and not d.startswith(".")
            )
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_paths(
    paths: Iterable[str],
    select: Iterable[str] | None = None,
    root: str | None = None,
    cache=None,
) -> LintResult:
    """Lint files/directories. ``root`` anchors the relative paths used
    both for reporting and for the path-scoped rules (default: CWD).

    Per-module rules run file by file; the program rules (JGL015+) run
    once over every module that parsed. ``cache`` is an optional
    :class:`ate_replication_causalml_torch.analysis.cache.ResultCache`:
    per-file results are keyed on content hashes and the program pass
    on the whole tree's hash, so a warm run re-lints only what changed
    (and a fully warm run parses nothing at all)."""
    root = os.path.abspath(root or os.getcwd())
    result = LintResult()
    mod_rules, prog_rules = _split_rules(select)
    paths = list(paths)
    for p in paths:
        if not os.path.exists(p):
            # A vanished path must FAIL the gate, not pass it vacuously
            # (a package rename would otherwise lint zero files and
            # report a clean tree forever).
            result.findings.append(
                Finding(PARSE_ERROR_ID, p, 1, 1, "path does not exist")
            )
    entries: list[tuple[str, str, str | None]] = []  # (abspath, rel, source)
    for path in iter_py_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, root) if ap.startswith(root + os.sep) else path
        try:
            with open(path, encoding="utf-8") as f:
                entries.append((path, rel, f.read()))
        except OSError as e:
            result.findings.append(
                Finding(PARSE_ERROR_ID, rel, 1, 1, f"unreadable file: {e}")
            )
            result.files += 1
            continue
    program_cached = (
        cache.get_program(entries) if cache is not None and prog_rules else None
    )
    need_parse_all = bool(prog_rules) and program_cached is None
    modules: list[ModuleInfo] = []
    for path, rel, source in entries:
        result.files += 1
        cached = cache.get_module(rel, source) if cache is not None else None
        if cached is not None and not need_parse_all:
            result.findings.extend(cached[0])
            result.suppressed.extend(cached[1])
            continue
        try:
            module = ModuleInfo(path, rel, source)
        except (SyntaxError, ValueError) as e:
            result.findings.append(_parse_error(rel, e))
            continue
        modules.append(module)
        if cached is not None:
            result.findings.extend(cached[0])
            result.suppressed.extend(cached[1])
            continue
        per_file = LintResult()
        _run_module_rules(module, mod_rules, per_file)
        result.findings.extend(per_file.findings)
        result.suppressed.extend(per_file.suppressed)
        if cache is not None:
            cache.put_module(rel, source, per_file.findings, per_file.suppressed)
    if prog_rules:
        if program_cached is not None:
            result.findings.extend(program_cached[0])
            result.suppressed.extend(program_cached[1])
        else:
            prog_result = LintResult()
            _run_program_rules(modules, prog_rules, prog_result)
            result.findings.extend(prog_result.findings)
            result.suppressed.extend(prog_result.suppressed)
            if cache is not None:
                cache.put_program(
                    entries, prog_result.findings, prog_result.suppressed
                )
    if cache is not None:
        cache.save()
    result.sort()
    return result
