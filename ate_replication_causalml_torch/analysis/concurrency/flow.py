"""Interprocedural lock-set analysis for the port's graftrace
(stdlib-only): a copy of the JAX package's ``concurrency/flow.py`` with
torch's device syncs and collectives.

Layered on the per-module extraction (:mod:`.extract`) and graftlint's
function table (:mod:`..torchast`), this builds one :class:`Analysis`
over the whole program:

* a call graph with receiver-type resolution (``self.m()``,
  ``self.attr.m()`` via ``__init__`` constructor types, cross-module
  dotted calls via import aliases, and a unique-bare-name fallback
  gated by a generic-name blocklist);
* per-function lock-set summaries from a lexical walk of ``with``
  blocks (held sets, acquisition sites, blocking calls, ``self.attr``
  writes, ``Condition.wait`` sites, collective-launcher sites);
* the fixpoints the rules consume — transitive acquisitions,
  may-block, thread-entry reachability, guaranteed-held-lock sets, and
  the lock acquisition-order graph.

Precision stance: edges and lock resolutions are *dropped* when a
receiver cannot be typed — a missed edge can miss a finding (bounded
by the fixture suite), while an invented edge would manufacture
deadlock cycles out of thin air and bury the report.
"""

from __future__ import annotations

import ast
import dataclasses

from ate_replication_causalml_torch.analysis.core import ModuleInfo, Program
from ate_replication_causalml_torch.analysis.torchast import collect_functions
from ate_replication_causalml_torch.analysis import scopes
from ate_replication_causalml_torch.analysis.concurrency.extract import (
    ClassInfo,
    LockDef,
    ModuleConc,
    extract,
)

#: Method names far too common to resolve by bare-name uniqueness — a
#: one-definition coincidence must not create an interprocedural edge.
GENERIC_NAMES = frozenset({
    "get", "put", "set", "pop", "add", "update", "append", "extend",
    "remove", "clear", "close", "start", "stop", "run", "wait", "notify",
    "notify_all", "acquire", "release", "join", "submit", "send", "recv",
    "read", "write", "open", "items", "keys", "values", "copy", "emit",
    "inc", "observe", "register", "install", "describe", "snapshot",
    "evaluate", "tick", "fail", "resolve", "reset", "result", "fit",
    "exec", "beat", "ages", "active", "enabled", "state", "main", "next",
    "flush", "reload", "retry", "check", "build", "load", "dump", "step",
})

#: Collective launchers (dotted-suffix match): the artifact plane's
#: device-dispatching entry points, shard_map itself, and the port's
#: mesh collectives (``parallel/mesh.py``).
COLLECTIVE_SUFFIXES = (
    "shardio.commit", "shardio.reshard", "shardio.gather_host",
    "shardio.host_bounce", ".shard_map", "shard_map.shard_map",
    "mesh.all_gather_cat", "mesh.all_reduce_sum",
)

#: ``torch.distributed`` collectives (full dotted names: the JAX
#: package's ``lax`` collectives of the same names stay out).
TORCH_COLLECTIVES = frozenset(
    f"torch.distributed.{n}" for n in (
        "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
        "reduce_scatter_tensor", "barrier",
    )
)

#: Attribute names whose zero-arg call blocks the calling thread.
_BLOCKING_ZERO_ARG = {"join", "get", "wait", "acquire"}
_BLOCKING_ALWAYS = {"accept", "recv", "recvfrom", "serve_forever"}
_DEVICE_BLOCKING = {"block_until_ready", "device_get", "synchronize"}
_DEVICE_BLOCKING_DOTTED = ("jax.block_until_ready", "jax.device_get",
                           "torch.cuda.synchronize")


def is_lane_lock(lock_id: str) -> bool:
    """Locks that satisfy the collective-launch discipline (JGL018) and
    are exempt from blocking-under-lock (JGL016): the mesh-lane family
    exists precisely to serialize device dispatch."""
    return "lane" in lock_id.lower() or lock_id.endswith("_DEFAULT_MESH_LOCK")


@dataclasses.dataclass(frozen=True)
class FuncKey:
    rel: str
    qual: str

    @property
    def id(self) -> str:
        return f"{self.rel}::{self.qual}"


@dataclasses.dataclass
class CallSite:
    held: frozenset
    callee: FuncKey | None
    dotted: str | None
    name: str  # bare callable name (attr or id) for messages
    line: int


@dataclasses.dataclass
class BlockSite:
    held: frozenset
    what: str
    line: int


@dataclasses.dataclass
class WriteSite:
    cls: str  # class qualname
    attr: str
    held: frozenset
    line: int
    qual: str  # containing function qualname


@dataclasses.dataclass
class WaitSite:
    lock_id: str
    has_timeout: bool
    in_while: bool
    held_other: frozenset  # held locks minus the condition itself
    line: int


@dataclasses.dataclass
class Summary:
    key: FuncKey
    acquisitions: list = dataclasses.field(default_factory=list)  # (held, lock_id, line)
    calls: list = dataclasses.field(default_factory=list)  # CallSite
    blocking: list = dataclasses.field(default_factory=list)  # BlockSite
    writes: list = dataclasses.field(default_factory=list)  # WriteSite
    waits: list = dataclasses.field(default_factory=list)  # WaitSite
    collectives: list = dataclasses.field(default_factory=list)  # (held, name, line)


@dataclasses.dataclass
class Entry:
    id: str
    kind: str  # thread | pool | http-handler | public-api
    key: FuncKey | None
    file: str
    line: int
    target: str  # display form of the target


class Analysis:
    """Whole-program concurrency model + derived fixpoints."""

    def __init__(self, program: Program):
        self.modules: list[ModuleInfo] = [
            m for m in program.modules if scopes.CONCURRENCY.contains(m.relpath)
        ]
        self.conc: dict[str, ModuleConc] = {
            m.relpath: extract(m) for m in self.modules
        }
        self.locks: dict[str, LockDef] = {}
        self.funcs: dict[FuncKey, object] = {}
        self.summaries: dict[FuncKey, Summary] = {}
        self.entries: list[Entry] = []
        self._index()
        self._summarize()
        self._entries()
        self._fixpoints()

    # ── indexing ─────────────────────────────────────────────────────

    def _index(self) -> None:
        self._mod_dotted: dict[str, str] = {}  # dotted module -> relpath
        self._class_by_dotted: dict[str, tuple[str, str]] = {}
        self._by_bare: dict[str, list[FuncKey]] = {}
        for m in self.modules:
            dotted = m.relpath[:-3].replace("/", ".") if m.relpath.endswith(".py") else None
            if dotted:
                self._mod_dotted[dotted] = m.relpath
            conc = self.conc[m.relpath]
            for ld in conc.global_locks.values():
                self.locks[ld.id] = ld
            for info in conc.classes.values():
                for ld in info.attr_locks.values():
                    self.locks[ld.id] = ld
                if dotted:
                    self._class_by_dotted[f"{dotted}.{info.qualname}"] = (
                        m.relpath, info.qualname
                    )
                self._class_by_dotted.setdefault(
                    info.qualname, (m.relpath, info.qualname)
                )
            for ld in conc.lock_returners.values():
                self.locks.setdefault(ld.id, ld)
            for qual, rec in collect_functions(m).items():
                key = FuncKey(m.relpath, qual)
                self.funcs[key] = rec
                self._by_bare.setdefault(rec.name, []).append(key)

    def class_of(self, key: FuncKey) -> ClassInfo | None:
        if "." not in key.qual:
            return None
        cls_qual = key.qual.rsplit(".", 1)[0]
        return self.conc[key.rel].classes.get(cls_qual)

    def _class_info(self, dotted: str | None) -> tuple[str, ClassInfo] | None:
        if not dotted:
            return None
        hit = self._class_by_dotted.get(dotted)
        if hit is None:
            return None
        rel, qual = hit
        return rel, self.conc[rel].classes[qual]

    def _module_func(self, dotted: str) -> FuncKey | None:
        """``pkg.mod.fn`` / ``pkg.mod.Class.method`` -> FuncKey."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            rel = self._mod_dotted.get(".".join(parts[:cut]))
            if rel is None:
                continue
            qual = ".".join(parts[cut:])
            key = FuncKey(rel, qual)
            return key if key in self.funcs else None
        return None

    def resolve_target(
        self, conc: ModuleConc, enclosing: str | None, target: ast.expr
    ) -> FuncKey | None:
        """Resolve a Thread/submit target expression to a function."""
        m = conc.module
        if isinstance(target, ast.Name):
            if enclosing:  # nested def inside the spawning function
                key = FuncKey(m.relpath, f"{enclosing}.{target.id}")
                if key in self.funcs:
                    return key
            key = FuncKey(m.relpath, target.id)
            if key in self.funcs:
                return key
            return self._module_func(m.resolve(target) or "")
        if isinstance(target, ast.Attribute):
            base = target.value
            if isinstance(base, ast.Name) and enclosing:
                # self._run from inside a method of the same class
                cls_qual = enclosing.rsplit(".", 1)[0] if "." in enclosing else None
                info = conc.classes.get(cls_qual) if cls_qual else None
                if info is not None and base.id == "self":
                    qual = info.methods.get(target.attr)
                    if qual:
                        return FuncKey(m.relpath, qual)
            return self._module_func(m.resolve(target) or "")
        return None

    # ── per-function summaries ───────────────────────────────────────

    def _summarize(self) -> None:
        for m in self.modules:
            conc = self.conc[m.relpath]
            for qual, rec in sorted(collect_functions(m).items()):
                key = FuncKey(m.relpath, qual)
                self.summaries[key] = _FunctionWalker(self, conc, key, rec).walk()

    # ── entrypoints ──────────────────────────────────────────────────

    def _entries(self) -> None:
        seen: set[str] = set()

        def add(e: Entry) -> None:
            if e.id not in seen:
                seen.add(e.id)
                self.entries.append(e)

        for rel in sorted(self.conc):
            conc = self.conc[rel]
            for ref in conc.thread_refs:
                key = self.resolve_target(conc, ref.enclosing, ref.target)
                target = ast.unparse(ref.target)
                eid = (
                    key.id if key is not None
                    else f"{rel}::<{ref.kind}@{ref.line}:{target}>"
                )
                add(Entry(eid, ref.kind, key, rel, ref.line, target))
            for qual in conc.handler_entries:
                key = FuncKey(rel, qual)
                if key in self.funcs:
                    add(Entry(key.id, "http-handler", key, rel,
                              self.funcs[key].node.lineno, qual))
            # Public methods of lock/thread-owning classes: the surface
            # external threads call into (start/stop/submit/drain...).
            for cq in sorted(conc.classes):
                info = conc.classes[cq]
                if not info.owns_concurrency():
                    continue
                for name in sorted(info.methods):
                    if name.startswith("_"):
                        continue
                    key = FuncKey(rel, info.methods[name])
                    if key in self.funcs:
                        add(Entry(key.id, "public-api", key, rel,
                                  self.funcs[key].node.lineno, key.qual))

    # ── fixpoints ────────────────────────────────────────────────────

    def _fixpoints(self) -> None:
        # Call-graph edges (resolved callees only).
        self.edges: dict[FuncKey, list[CallSite]] = {
            k: [c for c in s.calls if c.callee is not None]
            for k, s in self.summaries.items()
        }
        callees: dict[FuncKey, set[FuncKey]] = {
            k: {c.callee for c in cs} for k, cs in self.edges.items()
        }
        callers: dict[FuncKey, set[FuncKey]] = {k: set() for k in self.summaries}
        for k, outs in callees.items():
            for o in outs:
                if o in callers:
                    callers[o].add(k)

        # Transitive lock acquisitions.
        acq: dict[FuncKey, set[str]] = {
            k: {lock for _, lock, _ in s.acquisitions}
            for k, s in self.summaries.items()
        }
        changed = True
        while changed:
            changed = False
            for k in self.summaries:
                for o in callees.get(k, ()):
                    extra = acq.get(o, set()) - acq[k]
                    if extra:
                        acq[k] |= extra
                        changed = True
        self.trans_acquires = acq

        # May-block (what + witness line for messages).
        blk: dict[FuncKey, str | None] = {}
        for k, s in self.summaries.items():
            direct = s.blocking + [
                BlockSite(w.held_other, "Condition.wait() without timeout", w.line)
                for w in s.waits if not w.has_timeout
            ]
            blk[k] = (
                f"{direct[0].what} at {k.rel}:{direct[0].line}" if direct else None
            )
        changed = True
        while changed:
            changed = False
            for k in self.summaries:
                if blk[k] is not None:
                    continue
                for c in self.edges.get(k, ()):
                    w = blk.get(c.callee)
                    if w is not None:
                        blk[k] = f"{c.name} -> {w}"
                        changed = True
                        break
        self.may_block = blk

        # Thread-entry reachability: func -> sorted entry ids.
        reach: dict[FuncKey, set[str]] = {k: set() for k in self.summaries}
        for e in self.entries:
            if e.key is None or e.key not in self.summaries:
                continue
            stack = [e.key]
            seen = set()
            while stack:
                k = stack.pop()
                if k in seen:
                    continue
                seen.add(k)
                reach[k].add(e.id)
                stack.extend(callees.get(k, ()))
        self.entry_reach = reach

        # Guaranteed-held: meet (intersection) over all call paths from
        # roots. Roots: entrypoints and functions with no in-scope
        # callers (called from outside the analyzed planes).
        guaranteed: dict[FuncKey, set[str]] = {}
        roots = {e.key for e in self.entries if e.key is not None}
        roots |= {k for k, cs in callers.items() if not cs}
        work = []
        for r in sorted(roots, key=lambda k: k.id):
            if r in self.summaries:
                guaranteed[r] = set()
                work.append(r)
        while work:
            k = work.pop()
            for c in self.edges.get(k, ()):
                ctx = guaranteed[k] | set(c.held)
                cur = guaranteed.get(c.callee)
                new = ctx if cur is None else (cur & ctx)
                if cur is None or new != cur:
                    guaranteed[c.callee] = set(new)
                    work.append(c.callee)
        self.guaranteed = guaranteed

        # Lock acquisition-order edges: held -> newly-acquired, both
        # directly and through calls that transitively acquire.
        order: dict[tuple[str, str], list[str]] = {}

        def edge(a: str, b: str, site: str) -> None:
            if a != b:
                order.setdefault((a, b), []).append(site)

        for k in sorted(self.summaries, key=lambda k: k.id):
            s = self.summaries[k]
            for held, lock, line in s.acquisitions:
                for h in sorted(held):
                    edge(h, lock, f"{k.rel}:{line}")
            for c in self.edges.get(k, ()):
                if not c.held:
                    continue
                for a in sorted(self.trans_acquires.get(c.callee, ())):
                    for h in sorted(c.held):
                        edge(h, a, f"{k.rel}:{c.line} (via {c.name})")
        self.order_edges = order

    # ── cycle detection (JGL015) ─────────────────────────────────────

    def lock_cycles(self) -> list[tuple[list[str], list[str]]]:
        """Strongly-connected components of ≥2 locks in the order
        graph: ``(sorted lock ids, witness sites)`` per cycle."""
        graph: dict[str, set[str]] = {}
        for a, b in self.order_edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            # Iterative Tarjan: analysis may run on deep lock graphs.
            call_stack = [(v, iter(sorted(graph[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while call_stack:
                node, it = call_stack[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        call_stack.append((w, iter(sorted(graph[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                call_stack.pop()
                if call_stack:
                    parent = call_stack[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)

        out = []
        for comp in sorted(sccs):
            members = set(comp)
            sites: list[str] = []
            for (a, b), where in sorted(self.order_edges.items()):
                if a in members and b in members:
                    sites.append(f"{a} -> {b} at {where[0]}")
            out.append((comp, sites))
        return out


class _FunctionWalker:
    """Lexical walk of one function body tracking the held lock set."""

    def __init__(self, analysis: Analysis, conc: ModuleConc, key: FuncKey, rec):
        self.an = analysis
        self.conc = conc
        self.key = key
        self.rec = rec
        self.module = conc.module
        self.summary = Summary(key=key)
        cls = analysis.class_of(key)
        self.cls: ClassInfo | None = cls
        args = rec.node.args.posonlyargs + rec.node.args.args
        self.self_name = args[0].arg if (cls is not None and args) else None
        self.local_locks: dict[str, str] = {}
        self.local_types: dict[str, str] = {}
        self._prescan()

    # -- local environment --------------------------------------------

    def _prescan(self) -> None:
        from ate_replication_causalml_torch.analysis.torchast import own_statements

        for node in own_statements(self.rec.node):
            if not isinstance(node, ast.Assign):
                continue
            lock = self._lock_of(node.value, allow_local=False)
            ctor = None
            if isinstance(node.value, ast.Call):
                ctor = self.module.resolve(node.value.func)
            attr_src = self._self_attr(node.value)
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if lock is not None:
                    self.local_locks[t.id] = lock
                elif attr_src is not None and self.cls is not None:
                    ty = self.cls.attr_types.get(attr_src)
                    if ty:
                        self.local_types[t.id] = ty
                elif ctor:
                    self._note_local_type(t.id, ctor)

    def _note_local_type(self, name: str, ctor: str) -> None:
        if ctor in ("threading.Thread", "threading.Event"):
            self.local_types[name] = ctor
        elif self.an._class_info(ctor) is not None:
            self.local_types[name] = ctor

    def _self_attr(self, node: ast.expr) -> str | None:
        if (
            self.self_name is not None
            and isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self.self_name
        ):
            return node.attr
        return None

    # -- lock expression resolution -----------------------------------

    def _lock_of(self, expr: ast.expr, allow_local: bool = True) -> str | None:
        """Lock id acquired by ``with expr`` (None when unresolvable)."""
        if isinstance(expr, ast.Name):
            if allow_local and expr.id in self.local_locks:
                return self.local_locks[expr.id]
            ld = self.conc.global_locks.get(expr.id)
            return ld.id if ld else None
        attr = self._self_attr(expr)
        if attr is not None and self.cls is not None:
            ld = self.cls.attr_locks.get(attr)
            return ld.id if ld else None
        if isinstance(expr, ast.Call):
            return self._lock_of_call(expr)
        if isinstance(expr, ast.Attribute):
            dotted = self.module.resolve(expr)
            if dotted:
                parts = dotted.split(".")
                for cut in range(len(parts) - 1, 0, -1):
                    rel = self.an._mod_dotted.get(".".join(parts[:cut]))
                    if rel is None:
                        continue
                    rest = ".".join(parts[cut:])
                    ld = self.an.conc[rel].global_locks.get(rest)
                    return ld.id if ld else None
        return None

    def _lock_of_call(self, call: ast.Call) -> str | None:
        """``self._entry_lock(k)`` / ``self.cache.lane_lock(l)`` /
        ``module.fn(...)`` resolving to a lock-returning function."""
        func = call.func
        attr = self._self_attr(func)
        if attr is not None and self.cls is not None:
            qual = self.cls.methods.get(attr)
            if qual:
                ld = self.conc.lock_returners.get(qual)
                return ld.id if ld else None
        if isinstance(func, ast.Name):
            ld = self.conc.lock_returners.get(func.id)
            return ld.id if ld else None
        if isinstance(func, ast.Attribute):
            hit = self._receiver_class(func.value)
            if hit is not None:
                rel, info = hit
                qual = info.methods.get(func.attr)
                if qual:
                    ld = self.an.conc[rel].lock_returners.get(qual)
                    return ld.id if ld else None
        return None

    def _receiver_class(self, base: ast.expr) -> tuple[str, ClassInfo] | None:
        """Type the receiver expression of a method call."""
        attr = self._self_attr(base)
        if attr is not None and self.cls is not None:
            return self.an._class_info(self.cls.attr_types.get(attr))
        if isinstance(base, ast.Name):
            return self.an._class_info(self.local_types.get(base.id))
        return None

    def _receiver_type_name(self, base: ast.expr) -> str | None:
        attr = self._self_attr(base)
        if attr is not None and self.cls is not None:
            return self.cls.attr_types.get(attr)
        if isinstance(base, ast.Name):
            return self.local_types.get(base.id)
        return None

    # -- callee resolution --------------------------------------------

    def _resolve_call(self, call: ast.Call) -> tuple[FuncKey | None, str | None, str]:
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            for qual in self._enclosing_chain(name):
                key = FuncKey(self.key.rel, qual)
                if key in self.an.funcs:
                    return key, None, name
            dotted = self.module.resolve(func)
            if dotted and dotted != name:
                key = self.an._module_func(dotted)
                if key is not None:
                    return key, dotted, name
            return self._unique_fallback(name), dotted, name
        if isinstance(func, ast.Attribute):
            name = func.attr
            base = func.value
            if (
                isinstance(base, ast.Name)
                and base.id == self.self_name
                and self.cls is not None
            ):
                # self.method() — same class, maybe inherited (skip).
                qual = self.cls.methods.get(name)
                if qual:
                    return FuncKey(self.key.rel, qual), None, name
            attr = self._self_attr(base)  # self.attr.method(): typed receiver
            hit = self._receiver_class(func.value)
            if hit is not None:
                rel, info = hit
                qual = info.methods.get(name)
                if qual:
                    return FuncKey(rel, qual), None, name
                return None, None, name  # typed receiver, unknown method
            dotted = self.module.resolve(func)
            if dotted:
                key = self.an._module_func(dotted)
                if key is not None:
                    return key, dotted, name
            if attr is None and not isinstance(func.value, ast.Name):
                return None, dotted, name
            return self._unique_fallback(name), dotted, name
        return None, None, "<expr>"

    def _enclosing_chain(self, name: str):
        """Candidate qualnames for a bare call: nested def in this
        function, sibling nested def, then module function."""
        if self.rec.parent or "." in self.key.qual:
            yield f"{self.key.qual}.{name}"
        if self.rec.parent:
            yield f"{self.rec.parent}.{name}"
        yield name

    def _unique_fallback(self, name: str) -> FuncKey | None:
        if name in GENERIC_NAMES or name.startswith("__"):
            return None
        hits = self.an._by_bare.get(name, ())
        return hits[0] if len(hits) == 1 else None

    # -- the walk ------------------------------------------------------

    def walk(self) -> Summary:
        self._stmts(self.rec.node.body, frozenset(), in_while=False)
        return self.summary

    def _stmts(self, body, held: frozenset, in_while: bool) -> None:
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(st, ast.With) or isinstance(st, ast.AsyncWith):
                new_held = set(held)
                for item in st.items:
                    self._expr(item.context_expr, frozenset(new_held), in_while)
                    lock = self._lock_of(item.context_expr)
                    if lock is not None:
                        self.summary.acquisitions.append(
                            (frozenset(new_held), lock, item.context_expr.lineno)
                        )
                        new_held.add(lock)
                self._stmts(st.body, frozenset(new_held), in_while)
            elif isinstance(st, ast.While):
                self._expr(st.test, held, in_while)
                self._stmts(st.body, held, in_while=True)
                self._stmts(st.orelse, held, in_while)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._expr(st.iter, held, in_while)
                self._stmts(st.body, held, in_while=True)
                self._stmts(st.orelse, held, in_while)
            elif isinstance(st, ast.If):
                self._expr(st.test, held, in_while)
                self._stmts(st.body, held, in_while)
                self._stmts(st.orelse, held, in_while)
            elif isinstance(st, ast.Try):
                self._stmts(st.body, held, in_while)
                for h in st.handlers:
                    self._stmts(h.body, held, in_while)
                self._stmts(st.orelse, held, in_while)
                self._stmts(st.finalbody, held, in_while)
            else:
                if isinstance(st, ast.Assign):
                    self._record_write_targets(st.targets, held)
                elif isinstance(st, ast.AugAssign):
                    self._record_write_targets([st.target], held)
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        self._expr(child, held, in_while)

    def _record_write_targets(self, targets, held: frozenset) -> None:
        if self.cls is None:
            return
        for t in targets:
            node = t
            if isinstance(node, ast.Subscript):
                node = node.value
            attr = self._self_attr(node)
            if attr is not None:
                self.summary.writes.append(
                    WriteSite(self.cls.qualname, attr, held, t.lineno, self.key.qual)
                )

    def _expr(self, expr: ast.expr, held: frozenset, in_while: bool) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._call(node, held, in_while)

    def _call(self, call: ast.Call, held: frozenset, in_while: bool) -> None:
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        dotted = self.module.resolve(func) if name else None

        # Collective launchers (dotted suffix, or a launcher attr on a
        # shardio-shaped receiver like `_shardio().commit(...)`).
        display = dotted or (name or "<call>")
        if self._is_collective(call, name, dotted):
            self.summary.collectives.append((held, display, call.lineno))
            self.summary.blocking.append(
                BlockSite(held, f"device dispatch via {display}", call.lineno)
            )
            return

        # Condition.wait — classified against the resolved receiver.
        if name == "wait" and isinstance(func, ast.Attribute):
            recv_lock = self._lock_of(func.value)
            has_timeout = bool(call.args) or any(
                kw.arg == "timeout" for kw in call.keywords
            )
            if recv_lock is not None and (
                "condition" in self.an.locks.get(
                    recv_lock, LockDef(recv_lock, "", "", 0)
                ).kind
            ):
                self.summary.waits.append(
                    WaitSite(
                        recv_lock, has_timeout, in_while,
                        frozenset(h for h in held if h != recv_lock),
                        call.lineno,
                    )
                )
                return
            recv_ty = self._receiver_type_name(func.value)
            if recv_ty == "threading.Event":
                return  # Event.wait: a barrier, not a lock-holding wait
            if not has_timeout and recv_lock is None and recv_ty is None:
                self.summary.blocking.append(
                    BlockSite(held, "wait() without timeout", call.lineno)
                )
                return

        # Other direct blocking shapes.
        if name in _BLOCKING_ALWAYS:
            self.summary.blocking.append(
                BlockSite(held, f"{name}()", call.lineno)
            )
        elif name in _DEVICE_BLOCKING or dotted in _DEVICE_BLOCKING_DOTTED:
            self.summary.blocking.append(
                BlockSite(held, f"device sync {name}()", call.lineno)
            )
        elif name in _BLOCKING_ZERO_ARG and not call.args and not call.keywords:
            if name == "join" or name == "get" or name == "acquire":
                self.summary.blocking.append(
                    BlockSite(held, f"{name}() without timeout", call.lineno)
                )
        elif name == "join" and isinstance(func, ast.Attribute):
            recv_ty = self._receiver_type_name(func.value)
            if recv_ty == "threading.Thread":
                self.summary.blocking.append(
                    BlockSite(held, "Thread.join()", call.lineno)
                )

        callee, cdotted, cname = self._resolve_call(call)
        self.summary.calls.append(
            CallSite(held, callee, cdotted, cname, call.lineno)
        )

    def _is_collective(self, call: ast.Call, name, dotted) -> bool:
        if self.key.rel.endswith("parallel/shardio.py"):
            return False  # the plane's own implementation is the baseline
        if dotted and (dotted in TORCH_COLLECTIVES
                       or any(dotted.endswith(sfx) for sfx in COLLECTIVE_SUFFIXES)):
            return True
        if (
            name in ("commit", "reshard", "gather_host", "host_bounce")
            and isinstance(call.func, ast.Attribute)
        ):
            try:
                recv = ast.unparse(call.func.value)
            except Exception:
                return False
            return "shardio" in recv.lower()
        return False


def analyze(program: Program) -> Analysis:
    """Build (and memoize on the program) the concurrency analysis."""
    cached = getattr(program, "_graftrace_analysis", None)
    if cached is None:
        cached = Analysis(program)
        program._graftrace_analysis = cached
    return cached
