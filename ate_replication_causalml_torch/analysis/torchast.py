"""Shared AST machinery for the torch rules: the port's roots, the
per-module reachability graph, and mutable-global discovery.

The counterpart of the JAX package's ``analysis/jaxast.py``. Its jit
roots (``jax.jit``/``pjit``) become the port's three kinds of root:

* **captured** — what a CUDA graph records: a function handed to
  ``torch.cuda.make_graphed_callables`` (the call form, like
  ``jax.jit(fn)``), the body of ``with torch.cuda.graph(...)``, and the
  statements between ``g.capture_begin()`` and ``g.capture_end()``. A
  replay re-runs the recorded kernels and none of the Python, so what the
  Python read at capture is frozen into the graph;
* **memoized** — a builder under ``functools.lru_cache`` /
  ``functools.cache``: its result is keyed on the arguments only;
* **hot** — the functions of :data:`HOT_PATH`, the declared table of the
  port's per-level, per-chunk and per-batch code, where a host sync
  stalls the card's queue.

A function is *reached* when it is a root or is referenced (called,
passed, captured…) — transitively — from a root's own statements or a
captured region, as the JAX package reaches traced functions from jit
roots. Reference-based edges over-approximate calls on purpose: a false
edge costs at most one suppressible finding, while a missed edge
silently waives the rule.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from ate_replication_causalml_torch.analysis.core import ModuleInfo
from ate_replication_causalml_torch.analysis.scopes import _segments, _tail_matches

#: ``functools`` memoizers: a decorated builder is a memoized root.
MEMO_NAMES = {"functools.lru_cache", "functools.cache"}

#: Call-form capture: the first argument (a function, or a tuple of
#: them) is recorded into CUDA graphs.
GRAPHED_CALLABLES = {
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
}

#: ``with torch.cuda.graph(g):`` — the body is captured.
GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

#: The hot path: ``(file, qualname)`` with the file matched on its tail
#: segments. Each entry runs once a grow level, a tree chunk or a served
#: batch, so a host sync in it (or in what it reaches) stalls the card's
#: queue once per level, chunk or batch. The forests' grow and predict
#: loops, the serving dispatcher and the warmed predict's call, the
#: kernel wrappers they launch through, and the per-level split draw
#: (``uniform``). It is also the map the launch work of the forests (ROADMAP,
#: Queue B item 5) starts from.
HOT_PATH: tuple[tuple[str, str], ...] = (
    ("models/forest.py", "streaming_level_loop"),
    ("models/forest.py", "select_split"),
    ("models/forest.py", "_split_tables"),
    ("models/forest.py", "forest_apply"),
    ("models/causal_forest.py", "_tables"),
    ("models/causal_forest.py", "_grow_groups_direct"),
    ("models/causal_forest.py", "grow_causal_forest"),
    ("models/causal_forest.py", "compute_leaf_index"),
    ("models/causal_forest.py", "predict_cate"),
    ("serving/daemon.py", "CateServer._dispatch_loop"),
    ("ops/hist.py", "bin_histogram_batched"),
    ("ops/hist.py", "bin_histogram_shared"),
    ("ops/hist.py", "bin_histogram"),
    ("ops/hist.py", "node_sums"),
    ("ops/hist.py", "node_sums_shared"),
    ("ops/hist.py", "partition_sort"),
    ("ops/tree.py", "route_bits"),
    ("ops/tree.py", "table_lookup"),
    ("ops/tree.py", "route_advance"),
    ("ops/tree.py", "traverse"),
    ("ops/tree.py", "leaf_record"),
    ("ops/pack.py", "pack_codes"),
    ("ops/random.py", "uniform"),
    ("models/causal_forest.py", "WarmPredict.__call__"),
    ("models/forest.py", "WarmForestPredict.__call__"),
    ("models/forest.py", "WarmGraph._host"),
)

#: In-place container mutators — shared by the mutable-global discovery
#: here and JGL006's unlocked-mutation detection (one list, no drift).
MUTATOR_METHODS = {
    "append", "extend", "insert", "pop", "popleft", "remove", "clear",
    "update", "setdefault", "add", "discard", "appendleft", "popitem",
}

FunctionNode = ast.FunctionDef | ast.AsyncFunctionDef


@dataclasses.dataclass
class FunctionRecord:
    node: FunctionNode
    qualname: str
    parent: str | None  # enclosing function qualname, if nested
    #: "memoized" for a decorated builder, else None (call-form and
    #: table roots are found by :func:`root_functions`).
    root: str | None = None
    #: bare names referenced (Load context) in this function's own
    #: statements, nested defs excluded — the call-graph edge source.
    refs: set[str] = dataclasses.field(default_factory=set)

    @property
    def name(self) -> str:
        return self.node.name

    def param_names(self) -> list[str]:
        a = self.node.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


@dataclasses.dataclass
class Region:
    """A captured span inside one function: a ``with torch.cuda.graph``
    body, or the statements between ``capture_begin`` and
    ``capture_end``."""

    qual: str  # enclosing function qualname
    stmts: list[ast.stmt]
    line: int
    refs: set[str] = dataclasses.field(default_factory=set)

    def nodes(self) -> Iterator[ast.AST]:
        """Every node of the span, nested function/class bodies excluded."""
        stack: list[ast.AST] = list(self.stmts)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                    stack.append(child)


def memo_decorator(module: ModuleInfo, deco: ast.expr) -> bool:
    """Whether ``deco`` is ``functools.lru_cache`` / ``functools.cache``
    (bare or called)."""
    target = deco.func if isinstance(deco, ast.Call) else deco
    return module.resolve(target) in MEMO_NAMES


def own_statements(fn: FunctionNode) -> Iterator[ast.AST]:
    """Every node lexically in ``fn`` excluding nested function/class
    bodies (those are analyzed as their own scopes) — but including
    nested lambdas, which stay part of the enclosing scope."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            stack.append(child)


def body_nodes(fn: FunctionNode) -> Iterator[ast.AST]:
    """Every node of ``fn``'s body, nested function and class bodies
    excluded at every depth (a nested def is its own scope: its params
    shadow the outer tensors, as JGL003's scan has it)."""
    stack: list[ast.AST] = [n for n in fn.body
                            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                  ast.ClassDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                stack.append(child)


def collect_functions(module: ModuleInfo) -> dict[str, FunctionRecord]:
    """All function defs (any nesting), keyed by dotted qualname.

    Memoized per ModuleInfo: several rules need the table, and the
    records are never mutated after collection (reachability verdicts
    are returned separately), so sharing is safe.
    """
    cached = getattr(module, "_graftlint_functions", None)
    if cached is not None:
        return cached
    records: dict[str, FunctionRecord] = {}

    def visit(node: ast.AST, prefix: str, parent: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                rec = FunctionRecord(node=child, qualname=qual, parent=parent)
                if any(memo_decorator(module, d) for d in child.decorator_list):
                    rec.root = "memoized"
                for sub in own_statements(child):
                    if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                        rec.refs.add(sub.id)
                records[qual] = rec
                visit(child, qual + ".", qual)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", parent)
            else:
                visit(child, prefix, parent)

    visit(module.tree, "", None)
    module._graftlint_functions = records
    return records


def _by_name(records: dict[str, FunctionRecord]) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for qual, rec in records.items():
        out.setdefault(rec.name, []).append(qual)
    return out


def in_hot_table(relpath: str, qual: str) -> bool:
    parts = _segments(relpath)
    return any(q == qual and _tail_matches(parts, f) for f, q in HOT_PATH)


def graphed_callable_roots(
    module: ModuleInfo, records: dict[str, FunctionRecord]
) -> set[str]:
    """Functions handed to ``torch.cuda.make_graphed_callables`` anywhere
    in the module (the call form, as ``jax.jit(fn)`` is the JAX one)."""
    if "make_graphed_callables" not in module.source:
        return set()
    by_name = _by_name(records)
    roots: set[str] = set()
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Call)
                and module.resolve(node.func) in GRAPHED_CALLABLES):
            continue
        for arg in node.args[:1]:
            elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
            for el in elts:
                if isinstance(el, ast.Name):
                    roots.update(by_name.get(el.id, ()))
    return roots


def root_functions(
    module: ModuleInfo, records: dict[str, FunctionRecord], kinds: tuple[str, ...]
) -> dict[str, str]:
    """``qualname -> kind`` for the module's roots of the given kinds
    ("captured", "memoized", "hot")."""
    roots: dict[str, str] = {}
    if "hot" in kinds:
        for qual in records:
            if in_hot_table(module.relpath, qual):
                roots[qual] = "hot"
    if "memoized" in kinds:
        for qual, rec in records.items():
            if rec.root == "memoized":
                roots.setdefault(qual, "memoized")
    if "captured" in kinds:
        for qual in graphed_callable_roots(module, records):
            roots.setdefault(qual, "captured")
    return roots


def _is_capture_call(stmt: ast.stmt, attr: str) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == attr)


def captured_regions(
    module: ModuleInfo, records: dict[str, FunctionRecord]
) -> list[Region]:
    """Every captured span of the module's functions (memoized per
    ModuleInfo)."""
    cached = getattr(module, "_graftlint_regions", None)
    if cached is not None:
        return cached
    regions: list[Region] = []
    if "graph" not in module.source and "capture_begin" not in module.source:
        module._graftlint_regions = regions
        return regions

    def scan_block(qual: str, body: list[ast.stmt]) -> None:
        begin: int | None = None
        for i, stmt in enumerate(body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and module.resolve(it.context_expr.func) in GRAPH_CONTEXTS
                for it in stmt.items
            ):
                regions.append(Region(qual, list(stmt.body), stmt.lineno))
                continue
            if _is_capture_call(stmt, "capture_begin"):
                begin = i
            elif _is_capture_call(stmt, "capture_end") and begin is not None:
                regions.append(Region(qual, body[begin + 1:i], body[begin].lineno))
                begin = None
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub:
                    scan_block(qual, sub)
            for h in getattr(stmt, "handlers", ()):
                scan_block(qual, h.body)

    for qual, rec in records.items():
        scan_block(qual, rec.node.body)
    for region in regions:
        for node in region.nodes():
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                region.refs.add(node.id)
    module._graftlint_regions = regions
    return regions


def reached_functions(
    module: ModuleInfo, records: dict[str, FunctionRecord], kinds: tuple[str, ...]
) -> dict[str, str]:
    """Reachability verdicts: ``qualname -> description`` of how it is
    reached ("memoized 'f'", "hot 'f'", "captured 'f'", "reached via
    memoized 'f'", "reached via a graph capture in 'f'"). Pure —
    ``records`` is never mutated."""
    by_name = _by_name(records)
    roots = root_functions(module, records, kinds)
    out: dict[str, str] = {}
    frontier: list[tuple[str, str]] = []
    for qual in sorted(roots):
        out[qual] = f"{roots[qual]} '{records[qual].name}'"
        frontier.append((qual, f"{roots[qual]} '{records[qual].name}'"))
    if "captured" in kinds:
        for region in captured_regions(module, records):
            via = f"a graph capture in '{records[region.qual].name}'"
            for name in sorted(region.refs):
                for callee in by_name.get(name, ()):
                    frontier.append((callee, via))
    while frontier:
        qual, via = frontier.pop()
        for name in records[qual].refs:
            for callee in by_name.get(name, ()):
                if callee not in out and callee != qual:
                    out[callee] = f"reached via {via}"
                    frontier.append((callee, via))
        out.setdefault(qual, f"reached via {via}")
    return out


def mutable_globals(module: ModuleInfo) -> set[str]:
    """Module-level names that behave like ambient mutable state:
    rebound more than once at module scope, rebound through ``global``,
    or module-level containers that some code mutates in place."""
    assign_counts: dict[str, int] = {}
    container_names: set[str] = set()
    for node in module.tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets, value = [node.target], getattr(node, "value", None)
        for t in targets:
            if isinstance(t, ast.Name):
                assign_counts[t.id] = assign_counts.get(t.id, 0) + 1
                if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                                      ast.DictComp, ast.SetComp)):
                    container_names.add(t.id)
                elif isinstance(value, ast.Call) and (
                    module.resolve(value.func)
                    in {
                        "dict", "list", "set", "collections.deque",
                        "collections.defaultdict", "collections.OrderedDict",
                    }
                ):
                    container_names.add(t.id)

    mutable = {n for n, c in assign_counts.items() if c > 1}
    mutated_containers: set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Global):
            mutable.update(node.names)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, ast.AugAssign) else node.targets
            )
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                    mutated_containers.add(t.value.id)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            base = node.func.value
            if isinstance(base, ast.Name) and node.func.attr in MUTATOR_METHODS:
                mutated_containers.add(base.id)
    mutable |= container_names & mutated_containers
    return mutable
