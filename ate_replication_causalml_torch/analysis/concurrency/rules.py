"""The port's graftrace rules: JGL015–JGL019 (copies of the JAX
package's whole-program concurrency findings) and TGL022, their device
half: tensors crossing CUDA streams without a wait.

These are :class:`~..core.ProgramRule` subclasses — they see every
module of the run at once and share one memoized :class:`~.flow.Analysis`
per program. Findings anchor to real file:line sites so the ordinary
``# graftlint: disable=`` machinery applies; a suppression here is a
design statement ("this dispatch deliberately happens under the entry
lock") and the gate requires each one to carry a justification.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from ate_replication_causalml_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Program,
    ProgramRule,
    register_program,
)
from ate_replication_causalml_torch.analysis.torchast import (
    MUTATOR_METHODS,
    body_nodes,
    collect_functions,
)
from ate_replication_causalml_torch.analysis.concurrency.flow import (
    Analysis,
    analyze,
    is_lane_lock,
)

#: Attribute types JGL019 never treats as guarded shared data: Events
#: are one-way flags with their own memory semantics, thread-locals are
#: unshared by construction.
_JGL019_EXEMPT_TYPES = {"threading.Event", "threading.local"}


def _site_finding(rule_id: str, rel: str, line: int, message: str) -> Finding:
    return Finding(rule=rule_id, path=rel, line=line, col=1, message=message)


@register_program
class LockOrderInversion(ProgramRule):
    id = "JGL015"
    name = "lock-order-inversion"
    description = (
        "Two or more locks are acquired in conflicting orders on "
        "different call paths (ABBA): a cycle in the acquisition-order "
        "graph is a latent deadlock between the threads that run those "
        "paths."
    )

    def check(self, program: Program) -> Iterable[Finding]:
        an = analyze(program)
        for locks, sites in an.lock_cycles():
            # Anchor on the first witness edge's source line.
            rel, line = _parse_site(sites[0]) if sites else ("<program>", 1)
            yield _site_finding(
                self.id, rel, line,
                "lock-order inversion across {%s}; conflicting edges: %s"
                % (", ".join(locks), "; ".join(sites[:4])),
            )


@register_program
class BlockingUnderLock(ProgramRule):
    id = "JGL016"
    name = "blocking-under-lock"
    description = (
        "A blocking operation (join/recv/accept, untimed queue.get or "
        "Condition.wait, device dispatch) runs while a non-lane lock is "
        "held — every other thread needing that lock stalls for the "
        "full blocking duration."
    )

    def check(self, program: Program) -> Iterable[Finding]:
        an = analyze(program)
        seen: set[tuple[str, int]] = set()
        for key in sorted(an.summaries, key=lambda k: k.id):
            s = an.summaries[key]
            for b in s.blocking:
                held = _non_exempt(b.held)
                if held and (key.rel, b.line) not in seen:
                    seen.add((key.rel, b.line))
                    yield _site_finding(
                        self.id, key.rel, b.line,
                        f"blocking operation ({b.what}) while holding "
                        f"{_fmt_locks(held)} in {key.qual}",
                    )
            for w in s.waits:
                held = _non_exempt(w.held_other)
                if not w.has_timeout and held and (key.rel, w.line) not in seen:
                    seen.add((key.rel, w.line))
                    yield _site_finding(
                        self.id, key.rel, w.line,
                        f"untimed Condition.wait on {w.lock_id} while also "
                        f"holding {_fmt_locks(held)} in {key.qual}",
                    )
            for c in an.edges.get(key, ()):
                held = _non_exempt(c.held)
                if not held or (key.rel, c.line) in seen:
                    continue
                witness = an.may_block.get(c.callee)
                if witness is not None:
                    seen.add((key.rel, c.line))
                    yield _site_finding(
                        self.id, key.rel, c.line,
                        f"call to {c.name} may block ({witness}) while "
                        f"holding {_fmt_locks(held)} in {key.qual}",
                    )


@register_program
class CondWaitOutsidePredicateLoop(ProgramRule):
    id = "JGL017"
    name = "cond-wait-outside-loop"
    description = (
        "Condition.wait outside a predicate re-check loop: spurious "
        "wakeups and notify_all races make a bare wait() return with "
        "the predicate still false."
    )

    def check(self, program: Program) -> Iterable[Finding]:
        an = analyze(program)
        for key in sorted(an.summaries, key=lambda k: k.id):
            for w in an.summaries[key].waits:
                if not w.in_while:
                    yield _site_finding(
                        self.id, key.rel, w.line,
                        f"Condition.wait on {w.lock_id} outside a while-"
                        f"predicate loop in {key.qual}",
                    )


@register_program
class CollectiveWithoutLaneLock(ProgramRule):
    id = "JGL018"
    name = "collective-without-lane-lock"
    description = (
        "A collective launcher (shard_map / shardio commit/reshard/"
        "gather) is reachable without the mesh lane lock: two threads "
        "enqueueing collectives concurrently deadlock the device mesh."
    )

    def check(self, program: Program) -> Iterable[Finding]:
        an = analyze(program)
        for key in sorted(an.summaries, key=lambda k: k.id):
            ctx = an.guaranteed.get(key, set())
            for held, name, line in an.summaries[key].collectives:
                effective = set(held) | ctx
                if not any(is_lane_lock(l) for l in effective):
                    yield _site_finding(
                        self.id, key.rel, line,
                        f"collective launch via {name} in {key.qual} is "
                        f"reachable without the mesh lane lock "
                        f"(locks guaranteed here: {_fmt_locks(effective)})",
                    )


@register_program
class UnguardedCrossThreadWrite(ProgramRule):
    id = "JGL019"
    name = "unguarded-cross-thread-write"
    description = (
        "An instance attribute is written from two or more thread "
        "entrypoints with no lock common to all write sites — the "
        "thread-reachability extension of JGL006/JGL008."
    )

    def check(self, program: Program) -> Iterable[Finding]:
        an = analyze(program)
        groups = _write_groups(an)
        for (rel, cls, attr) in sorted(groups):
            sites = groups[(rel, cls, attr)]
            entries: set[str] = set()
            for w, func in sites:
                entries |= an.entry_reach.get(func, set())
            if len(entries) < 2:
                continue
            common = None
            for w, func in sites:
                eff = set(w.held) | an.guaranteed.get(func, set())
                common = eff if common is None else (common & eff)
            if common:
                continue
            lines = sorted({w.line for w, _ in sites})
            shown = ", ".join(str(l) for l in lines[:4])
            yield _site_finding(
                self.id, rel, lines[0],
                f"{cls}.{attr} is written from {len(entries)} thread "
                f"entrypoints ({_fmt_entries(entries)}) with no common "
                f"lock across its write sites (lines {shown})",
            )


# ---------------------------------------------------------------- TGL022

_STREAM_CTORS = {"torch.cuda.Stream", "torch.cuda.streams.Stream"}
_STREAM_CONTEXTS = {"torch.cuda.stream", "torch.cuda.streams.stream"}
_EVENT_CTORS = {"torch.cuda.Event", "torch.cuda.streams.Event"}

#: Calls that make a consumer wait for a producer's device work.
_WAITS = {"wait_event", "wait_stream", "synchronize", "wait"}


def _calls(nodes) -> Iterator[tuple[ast.Call, str | None]]:
    for n in nodes:
        if isinstance(n, ast.Call):
            yield n, n.func.attr if isinstance(n.func, ast.Attribute) else None


def _name_arg(call: ast.Call, name: str) -> bool:
    return any(isinstance(a, ast.Name) and a.id == name for a in call.args)


def _stream_items(module: ModuleInfo, stmt: ast.stmt) -> list[ast.expr]:
    """The stream expressions a ``with`` enters through ``torch.cuda.stream(s)``."""
    out = []
    for item in getattr(stmt, "items", ()):
        e = item.context_expr
        if isinstance(e, ast.Call) and module.resolve(e.func) in _STREAM_CONTEXTS and e.args:
            out.append(e.args[0])
    return out


def _is_stream_cm(module: ModuleInfo, fn: ast.AST) -> bool:
    """A generator context manager that runs its body on a stream of its
    own (``with torch.cuda.stream(s): yield``)."""
    nodes = list(body_nodes(fn))
    return any(isinstance(n, (ast.Yield, ast.YieldFrom)) for n in nodes) and any(
        isinstance(n, (ast.With, ast.AsyncWith)) and _stream_items(module, n) for n in nodes)


def _class_of(qual: str, classes: set[str]) -> str | None:
    parts = qual.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        if ".".join(parts[:cut]) in classes:
            return ".".join(parts[:cut])
    return None


def _class_quals(module: ModuleInfo) -> dict[str, ast.ClassDef]:
    out: dict[str, ast.ClassDef] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                out[prefix + child.name] = child
                visit(child, prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, prefix + child.name + ".")

    visit(module.tree, "")
    return out


@register_program
class CrossStreamHandoff(ProgramRule):
    """The device half of JGL019. XLA orders one device's work for every
    thread; the port gives each sweep worker, the retrain fit and the
    daemon's index build a CUDA stream of their own, and the card then
    runs two streams' kernels in any order. Three hand-offs race:

    * a side stream's work handed back with no join: a function enters
      ``torch.cuda.stream(s)`` on a stream it made and neither
      ``current_stream().wait_stream(s)``, ``s.synchronize()``, an event
      recorded on ``s`` nor ``torch.cuda.synchronize()`` follows;
    * a tensor made on a side stream (inside ``torch.cuda.stream(s)`` or
      a stream context manager of the class) returned to a caller on
      another stream without ``record_stream``: the caching allocator
      may hand its blocks to the side stream again while the reader's
      kernels still read them;
    * a stream-owning class that records CUDA events into its state for
      the values it stores: a method that reads that state without a
      ``wait_event`` / ``wait_stream`` / ``synchronize`` lets the
      consumer's stream read the value before the producer wrote it."""

    id = "TGL022"
    name = "cross-stream-handoff"
    description = (
        "a tensor or a side stream's work reaches another stream or "
        "thread with no wait_event/wait_stream/synchronize (or is "
        "released without record_stream) — the card orders two streams' "
        "kernels in any order"
    )

    def check(self, program: Program) -> Iterable[Finding]:
        for module in program.modules:
            if "torch.cuda" in module.source:
                yield from self._module(module)

    def _module(self, module: ModuleInfo) -> Iterator[Finding]:
        records = collect_functions(module)
        classes = _class_quals(module)
        stream_cms = {q for q, r in records.items() if _is_stream_cm(module, r.node)}
        found: list[Finding] = []
        for qual, rec in sorted(records.items()):
            if qual in stream_cms:
                continue
            found += self._side_stream_join(module, rec)
            found += self._record_stream(module, rec, classes, stream_cms)
        for cq, cls in sorted(classes.items()):
            found += self._event_store(module, cq, cls, records)
        # One finding a site: an enclosing function's own statements take
        # in a nested def's, and one block can break two hand-offs.
        seen: set[int] = set()
        for f in found:
            if f.line not in seen:
                seen.add(f.line)
                yield f

    def _side_stream_join(self, module, rec) -> Iterator[Finding]:
        nodes = list(body_nodes(rec.node))
        streams = {
            t.id
            for n in nodes if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
            and module.resolve(n.value.func) in _STREAM_CTORS
            for t in n.targets if isinstance(t, ast.Name)
        }
        for stmt in nodes:
            if not isinstance(stmt, (ast.With, ast.AsyncWith)):
                continue
            for s in _stream_items(module, stmt):
                if not (isinstance(s, ast.Name) and s.id in streams):
                    continue
                body = [n for b in stmt.body for n in ast.walk(b)]
                joined = any(
                    (attr == "wait_stream" and _name_arg(c, s.id))
                    or (attr == "synchronize" and isinstance(c.func.value, ast.Name)
                        and c.func.value.id == s.id)
                    or (attr == "record" and _name_arg(c, s.id))
                    or module.resolve(c.func) == "torch.cuda.synchronize"
                    for c, attr in _calls(nodes)
                ) or any(attr == "record" and not c.args for c, attr in _calls(body))
                if not joined:
                    yield self.finding(
                        module, stmt,
                        f"side stream '{s.id}' in {rec.qualname}: its work is "
                        "handed back with no join — add "
                        f"current_stream().wait_stream({s.id}) (or record an "
                        "event the consumer waits on) after the block",
                    )

    def _record_stream(self, module, rec, classes, stream_cms) -> Iterator[Finding]:
        nodes = list(body_nodes(rec.node))
        cls = _class_of(rec.qualname, set(classes))
        if any(attr == "record_stream" for _, attr in _calls(nodes)):
            return
        for stmt in nodes:
            if not isinstance(stmt, (ast.With, ast.AsyncWith)):
                continue
            side = bool(_stream_items(module, stmt))
            for item in stmt.items:
                e = item.context_expr
                if not (isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute)
                        and isinstance(e.func.value, ast.Name)
                        and e.func.value.id == "self" and cls is not None):
                    continue
                side |= f"{cls}.{e.func.attr}" in stream_cms
            if not side:
                continue
            made = {n.id for b in stmt.body for n in ast.walk(b)
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
            inner_returns = [n for b in stmt.body for n in ast.walk(b)
                             if isinstance(n, ast.Return) and n.value is not None]
            escapes = bool(inner_returns) or any(
                isinstance(n, ast.Return) and n.value is not None
                and any(isinstance(v, ast.Name) and v.id in made for v in ast.walk(n.value))
                for n in nodes
            )
            if escapes:
                yield self.finding(
                    module, stmt,
                    f"{rec.qualname} returns tensors made on a side stream "
                    "without record_stream — the caching allocator may "
                    "reuse their blocks for the side stream while the "
                    "reader's stream still reads them; call "
                    "t.record_stream(reader) for each",
                )

    def _event_store(self, module, cq, cls, records) -> Iterator[Finding]:
        methods = {q: r for q, r in records.items() if q.rsplit(".", 1)[0] == cq}
        stores: set[str] = set()
        for r in methods.values():
            nodes = list(body_nodes(r.node))
            events = {
                t.id for n in nodes if isinstance(n, ast.Assign)
                and isinstance(n.value, ast.Call) and module.resolve(n.value.func) in _EVENT_CTORS
                for t in n.targets if isinstance(t, ast.Name)
            }
            for n in nodes:
                if isinstance(n, ast.Assign):
                    direct = isinstance(n.value, ast.Call) and \
                        module.resolve(n.value.func) in _EVENT_CTORS
                    if direct or (isinstance(n.value, ast.Name) and n.value.id in events):
                        for t in n.targets:
                            base = t.value if isinstance(t, ast.Subscript) else t
                            if (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
                                    and base.value.id == "self"):
                                stores.add(base.attr)
                elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                      and n.func.attr in ("append", "add") and _self_attr(n.func.value)
                      and any(isinstance(a, ast.Name) and a.id in events for a in n.args)):
                    stores.add(_self_attr(n.func.value))
        if not stores:
            return
        for q, r in sorted(methods.items()):
            nodes = list(body_nodes(r.node))
            produced = {_self_attr(c.func.value) for c, attr in _calls(nodes)
                        if attr in {"record"} | MUTATOR_METHODS and _self_attr(c.func.value)}
            stored = set()
            for n in nodes:
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        base = t.value if isinstance(t, ast.Subscript) else t
                        if _self_attr(base):
                            stored.add(id(base))
            reads = [n for n in nodes if isinstance(n, ast.Attribute)
                     and _self_attr(n) in stores and isinstance(n.ctx, ast.Load)
                     and id(n) not in stored and _self_attr(n) not in produced]
            if not reads or any(attr in _WAITS for _, attr in _calls(nodes)):
                continue
            first = min(reads, key=lambda n: (n.lineno, n.col_offset))
            yield self.finding(
                module, first,
                f"{q} reads the CUDA events {cq}.{first.attr} without a "
                "wait — the consumer's stream can read the value before "
                "the producer's kernels wrote it; make it "
                "current_stream().wait_event(event)",
            )


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _write_groups(an: Analysis):
    """(rel, class, attr) -> [(WriteSite, FuncKey)] for attributes that
    are real shared data on concurrency-owning classes."""
    groups: dict = {}
    for key in sorted(an.summaries, key=lambda k: k.id):
        for w in an.summaries[key].writes:
            func_name = w.qual.rsplit(".", 1)[-1]
            if func_name in ("__init__", "__new__"):
                continue
            info = an.conc[key.rel].classes.get(w.cls)
            if info is None or not info.owns_concurrency():
                continue
            if w.attr in info.attr_locks:
                continue
            if info.attr_types.get(w.attr) in _JGL019_EXEMPT_TYPES:
                continue
            groups.setdefault((key.rel, w.cls, w.attr), []).append((w, key))
    return groups


def _non_exempt(held) -> set:
    return {l for l in held if not is_lane_lock(l)}


def _fmt_locks(locks) -> str:
    return "{" + ", ".join(sorted(locks)) + "}" if locks else "{}"


def _fmt_entries(entries) -> str:
    shown = sorted(entries)[:3]
    extra = len(entries) - len(shown)
    return ", ".join(shown) + (f", +{extra} more" if extra > 0 else "")


def _parse_site(site: str) -> tuple[str, int]:
    """Witness strings look like ``lockA -> lockB at rel:line``."""
    at = site.rsplit(" at ", 1)[-1]
    rel, _, line = at.partition(":")
    try:
        return rel, int(line.split()[0])
    except ValueError:
        return rel, 1
