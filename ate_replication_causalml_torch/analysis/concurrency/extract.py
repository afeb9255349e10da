"""Per-module extraction for the port's graftrace concurrency analyzer
(a copy of the JAX package's ``concurrency/extract.py``: thread entry
points, lock factories and ``submit`` receivers are stdlib).

This pass is purely lexical-per-module: it finds every lock *object*
(module-global ``threading.Lock()``s, ``self._lock``-style instance
locks, and lock *families* — methods that mint or fetch per-key locks
out of a dict, like ``NuisanceCache._entry_lock``), every thread
*entrypoint* (``threading.Thread(target=...)``, ``do_*`` HTTP handler
methods, worker-pool ``submit`` bodies), and the class structure
(attribute types from ``self.x = Cls(...)`` assignments) that the
interprocedural pass in :mod:`.flow` needs to resolve receivers.

Lock identity convention (stable across runs — the committed
concurrency model keys on it):

* module global — ``<relpath>::<NAME>``
* instance attribute — ``<relpath>::<Class>.<attr>``
* lock family (lock-returning method) — ``<relpath>::<Class>.<method>()``
"""

from __future__ import annotations

import ast
import dataclasses

from ate_replication_causalml_torch.analysis.core import ModuleInfo
from ate_replication_causalml_torch.analysis.torchast import collect_functions, own_statements

#: threading factory → lock kind.
LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
}

#: Attribute types that are synchronization-adjacent but NOT locks —
#: extraction records them so the rules can exempt them (an Event is a
#: one-way memory barrier; thread-locals are unshared by construction).
NONLOCK_SYNC_FACTORIES = {
    "threading.Event": "event",
    "threading.local": "thread-local",
    "threading.Thread": "thread",
    "threading.Barrier": "barrier",
}

_HTTP_HANDLER_BASES = {
    "http.server.BaseHTTPRequestHandler",
    "http.server.SimpleHTTPRequestHandler",
}


@dataclasses.dataclass(frozen=True)
class LockDef:
    id: str
    kind: str  # lock | rlock | condition | semaphore | family-<kind>
    file: str
    line: int


@dataclasses.dataclass
class ThreadRef:
    """One ``threading.Thread(target=...)`` / ``pool.submit(fn)`` site,
    unresolved — :mod:`.flow` maps ``target`` onto a function."""

    kind: str  # thread | pool
    target: ast.expr
    file: str
    line: int
    enclosing: str | None  # qualname of the function containing the call
    thread_name: str | None  # the name= constant, when literal


@dataclasses.dataclass
class ClassInfo:
    qualname: str
    node: ast.ClassDef
    file: str
    attr_locks: dict[str, LockDef] = dataclasses.field(default_factory=dict)
    #: self.attr -> resolved dotted type from ``self.attr = Cls(...)``
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    #: method name -> qualname for every def in the class body
    methods: dict[str, str] = dataclasses.field(default_factory=dict)
    is_http_handler: bool = False

    def owns_concurrency(self) -> bool:
        """Whether instances are plausibly shared across threads: the
        class holds a lock or spawns/holds a thread."""
        return bool(self.attr_locks) or any(
            t in ("threading.Thread",) for t in self.attr_types.values()
        )


@dataclasses.dataclass
class ModuleConc:
    module: ModuleInfo
    global_locks: dict[str, LockDef] = dataclasses.field(default_factory=dict)
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    #: function qualname -> LockDef it returns (family or alias)
    lock_returners: dict[str, LockDef] = dataclasses.field(default_factory=dict)
    thread_refs: list[ThreadRef] = dataclasses.field(default_factory=list)
    #: qualnames that are thread entrypoints by construction (do_* HTTP
    #: handler methods).
    handler_entries: list[str] = dataclasses.field(default_factory=list)

    @property
    def relpath(self) -> str:
        return self.module.relpath


def _factory_kind(module: ModuleInfo, value: ast.expr) -> str | None:
    if isinstance(value, ast.Call):
        return LOCK_FACTORIES.get(module.resolve(value.func) or "")
    return None


def _first_param(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> str | None:
    args = fn.args.posonlyargs + fn.args.args
    return args[0].arg if args else None


def _self_attr_target(t: ast.expr, self_name: str | None) -> str | None:
    if (
        self_name is not None
        and isinstance(t, ast.Attribute)
        and isinstance(t.value, ast.Name)
        and t.value.id == self_name
    ):
        return t.attr
    return None


def _scan_class_attrs(
    conc: ModuleConc, info: ClassInfo, fn: ast.FunctionDef | ast.AsyncFunctionDef
) -> None:
    module = conc.module
    self_name = _first_param(fn)
    for node in own_statements(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            attr = _self_attr_target(t, self_name)
            if attr is None:
                continue
            kind = _factory_kind(module, node.value)
            if kind is not None:
                info.attr_locks.setdefault(
                    attr,
                    LockDef(
                        id=f"{module.relpath}::{info.qualname}.{attr}",
                        kind=kind,
                        file=module.relpath,
                        line=node.lineno,
                    ),
                )
                continue
            if isinstance(node.value, ast.Call):
                ctor = module.resolve(node.value.func)
                if ctor:
                    info.attr_types.setdefault(attr, ctor)


def _returned_lock(
    conc: ModuleConc, qual: str, fn: ast.FunctionDef | ast.AsyncFunctionDef
) -> tuple[str, int] | None:
    """``(kind, line)`` when ``fn`` returns a threading-factory product
    (directly, via a local assigned from one, or via ``.setdefault``) —
    the lock-family shape (``_entry_lock``/``lane_lock``)."""
    module = conc.module
    factory_locals: dict[str, str] = {}
    for node in own_statements(fn):
        if isinstance(node, ast.Assign):
            kind = None
            if isinstance(node.value, ast.Call):
                resolved = module.resolve(node.value.func) or ""
                kind = LOCK_FACTORIES.get(resolved)
                if kind is None and (
                    isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "setdefault"
                    and len(node.value.args) == 2
                ):
                    kind = _factory_kind(module, node.value.args[1])
            if kind is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        factory_locals[t.id] = kind
    for node in own_statements(fn):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        kind = _factory_kind(module, v)
        if kind is None and isinstance(v, ast.Call):
            if (
                isinstance(v.func, ast.Attribute)
                and v.func.attr == "setdefault"
                and len(v.args) == 2
            ):
                kind = _factory_kind(module, v.args[1])
        if kind is None and isinstance(v, ast.Name):
            kind = factory_locals.get(v.id)
        if kind is not None:
            return kind, fn.lineno
    return None


def _forwarded_lock(
    conc: ModuleConc, info: ClassInfo | None, fn: ast.FunctionDef | ast.AsyncFunctionDef
) -> LockDef | None:
    """A function whose return forwards another lock source:
    ``return self._lock`` (accessor) or ``return self.lane_lock(x)``
    (maybe-guard like ``_lane_guard``) resolves to THAT lock's id."""
    self_name = _first_param(fn)
    for node in own_statements(fn):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        attr = _self_attr_target(v, self_name)
        if attr is not None and info is not None and attr in info.attr_locks:
            return info.attr_locks[attr]
        if isinstance(v, ast.Call):
            cattr = _self_attr_target(v.func, self_name)
            if cattr is not None and info is not None:
                target_qual = info.methods.get(cattr)
                if target_qual is not None and target_qual in conc.lock_returners:
                    return conc.lock_returners[target_qual]
            if isinstance(v.func, ast.Name):
                target = v.func.id
                if target in conc.lock_returners:
                    return conc.lock_returners[target]
    return None


def extract(module: ModuleInfo) -> ModuleConc:
    """Extract the module's concurrency surface (see module docstring)."""
    conc = ModuleConc(module=module)
    rel = module.relpath

    # Module-global locks.
    for node in module.tree.body:
        if isinstance(node, ast.Assign):
            kind = _factory_kind(module, node.value)
            if kind is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    conc.global_locks[t.id] = LockDef(
                        id=f"{rel}::{t.id}", kind=kind, file=rel, line=node.lineno
                    )

    # Classes: attr locks/types, methods, HTTP-handler detection.
    def visit_classes(parent: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(parent):
            if isinstance(child, ast.ClassDef):
                qual = f"{prefix}{child.name}"
                info = ClassInfo(qualname=qual, node=child, file=rel)
                for base in child.bases:
                    resolved = module.resolve(base) or ""
                    if (
                        resolved in _HTTP_HANDLER_BASES
                        or resolved.endswith("RequestHandler")
                    ):
                        info.is_http_handler = True
                for item in child.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info.methods[item.name] = f"{qual}.{item.name}"
                        _scan_class_attrs(conc, info, item)
                conc.classes[qual] = info
                if info.is_http_handler:
                    conc.handler_entries.extend(
                        q for m, q in sorted(info.methods.items())
                        if m.startswith("do_")
                    )
                visit_classes(child, qual + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit_classes(child, prefix)

    visit_classes(module.tree, "")

    # Lock-returning functions: direct factories first, then forwarding
    # accessors/maybe-guards (which may chain onto the former).
    records = collect_functions(module)
    for qual, rec in sorted(records.items()):
        got = _returned_lock(conc, qual, rec.node)
        if got is not None:
            kind, line = got
            conc.lock_returners[qual] = LockDef(
                id=f"{rel}::{qual}()", kind=f"family-{kind}", file=rel, line=line
            )
    for _ in range(2):  # forwarding can chain one level (guard -> family)
        for qual, rec in sorted(records.items()):
            if qual in conc.lock_returners:
                continue
            cls_qual = qual.rsplit(".", 1)[0] if "." in qual else None
            info = conc.classes.get(cls_qual) if cls_qual else None
            fwd = _forwarded_lock(conc, info, rec.node)
            if fwd is not None:
                conc.lock_returners[qual] = fwd

    # Thread spawn / pool submit sites.
    for qual, rec in sorted(records.items()):
        for node in own_statements(rec.node):
            _collect_thread_refs(conc, node, qual)
    for node in module.tree.body:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
        else:
            _collect_thread_refs(conc, node, None, deep=True)
    return conc


def _is_executor_receiver(recv: ast.expr) -> bool:
    """Whether ``<recv>.submit(fn)`` plausibly targets a worker pool.
    The serving plane has domain ``submit`` methods (the coalescer, the
    daemon's request API) whose first argument is data, not a callable
    — only executor-shaped receivers count as thread entrypoints."""
    try:
        text = ast.unparse(recv).lower()
    except Exception:
        return False
    return "pool" in text or "executor" in text


def _collect_thread_refs(
    conc: ModuleConc, node: ast.AST, enclosing: str | None, deep: bool = False
) -> None:
    module = conc.module
    nodes = ast.walk(node) if deep else (node,)
    for sub in nodes:
        if not isinstance(sub, ast.Call):
            continue
        resolved = module.resolve(sub.func) or ""
        if resolved == "threading.Thread":
            target = None
            name = None
            for kw in sub.keywords:
                if kw.arg == "target":
                    target = kw.value
                elif kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    name = str(kw.value.value)
            if target is None and sub.args:
                target = sub.args[0]
            if target is not None:
                conc.thread_refs.append(
                    ThreadRef(
                        kind="thread",
                        target=target,
                        file=module.relpath,
                        line=sub.lineno,
                        enclosing=enclosing,
                        thread_name=name,
                    )
                )
        elif (
            isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "submit"
            and sub.args
            and isinstance(sub.args[0], (ast.Name, ast.Attribute))
            and _is_executor_receiver(sub.func.value)
        ):
            conc.thread_refs.append(
                ThreadRef(
                    kind="pool",
                    target=sub.args[0],
                    file=module.relpath,
                    line=sub.lineno,
                    enclosing=enclosing,
                    thread_name=None,
                )
            )
