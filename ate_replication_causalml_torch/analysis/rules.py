"""The port's per-module rule set: the JAX package's rules where they
carry over (JGL005–JGL010, JGL012–JGL014, JGL020, JGL021) and the torch
counterparts of its JAX-only rules (TGL001–TGL004, TGL011).

(JGL015–JGL019 and TGL022 are the whole-program concurrency rules in
``analysis/concurrency/rules.py``.)

A shared rule keeps the JAX rule's id, semantics and messages, so on the
constructs both packages have the two analyzers report the same
findings. A ``TGL`` rule takes the number of the JAX rule it stands for,
and its docstring names it. Rules are registered on import;
``core.lint_source`` runs them all unless a ``select`` list narrows the
set.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Iterator

from ate_replication_causalml_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    register,
)
from ate_replication_causalml_torch.analysis import scopes
from ate_replication_causalml_torch.analysis.torchast import (
    MUTATOR_METHODS,
    FunctionNode,
    FunctionRecord,
    captured_regions,
    collect_functions,
    mutable_globals,
    own_statements,
    body_nodes,
    reached_functions,
)

# ---------------------------------------------------------------- TGL001

#: Calls whose result depends on ambient process or backend state. In a
#: captured body they run once, at capture, and the replay re-runs the
#: recorded kernels only; in a memoized builder the cache is keyed on
#: the arguments only. Either way a later change of the state silently
#: reuses the stale graph or build.
_AMBIENT_CALLS = {
    "os.getenv",
    "torch.cuda.current_device",
    "torch.cuda.is_available",
    "torch.cuda.device_count",
    "torch.get_default_dtype",
    "torch.get_float32_matmul_precision",
    "torch.are_deterministic_algorithms_enabled",
}

_AMBIENT_READ_PREFIXES = ("os.environ", "torch.backends.")


def _where(records, qual: str, how: str) -> str:
    """``memoized function 'f'`` for a root, ``'g' (reached via hot 'f')``
    for what a root reaches (:func:`~.torchast.reached_functions`)."""
    rec = records[qual]
    if how.startswith("reached via "):
        return f"'{rec.name}' ({how})"
    return f"{how.split(' ', 1)[0]} function '{rec.name}'"


@register
class CapturedAmbientState(Rule):
    """The torch counterpart of JGL001 (``jit-ambient-state``). A CUDA
    graph records kernels, not Python: a captured body (or what it
    reaches) that branches on ``os.environ``, ``torch.cuda.is_available()``,
    ``torch.backends.*``, ``torch.get_default_dtype()`` or a mutable module
    global bakes the value read at capture into every replay. A memoized
    builder (``functools.lru_cache``/``cache``) is the port's other
    cache keyed on arguments only: the same read there is served stale
    from the cache. Read the state outside and pass it in."""

    id = "TGL001"
    name = "captured-ambient-state"
    description = (
        "captured (CUDA graph) or memoized function reads ambient state "
        "(environ, CUDA availability, torch.backends, default dtype, "
        "mutable module global) that the replay or the cache is not "
        "keyed on"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        records = collect_functions(module)
        reached = reached_functions(module, records, ("captured", "memoized"))
        regions = captured_regions(module, records)
        if not reached and not regions:
            return
        globals_ = mutable_globals(module)
        seen: set[tuple[int, int]] = set()
        scans: list[tuple[str, set[str], Iterable[ast.AST]]] = []
        for qual, how in sorted(reached.items()):
            rec = records[qual]
            scans.append((_where(records, qual, how),
                          self._local_binds(rec.node, rec.param_names()),
                          list(own_statements(rec.node))))
        for region in regions:
            rec = records[region.qual]
            scans.append((f"the graph capture in '{rec.name}'",
                          self._local_binds(rec.node, rec.param_names()),
                          list(region.nodes())))
        for where, local_binds, nodes in scans:
            yield from self._scan(module, where, local_binds, nodes, globals_, seen)

    @staticmethod
    def _local_binds(fn: ast.AST, params: list[str]) -> set[str]:
        # Python scoping, as in JGL001: a name assigned anywhere in the
        # function (or a parameter) is local throughout it.
        local_binds = set(params)
        global_decls: set[str] = set()
        for n in own_statements(fn):
            if isinstance(n, ast.Global):
                global_decls.update(n.names)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
                local_binds.add(n.id)
        return local_binds - global_decls

    def _scan(self, module, where, local_binds, nodes, globals_, seen):
        skip: set[int] = set()
        for node in nodes:
            if id(node) in skip:
                continue
            site = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
            if isinstance(node, ast.Call):
                fr = module.resolve(node.func)
                if fr in _AMBIENT_CALLS or (fr and fr.startswith("os.environ.")):
                    skip.update(id(d) for d in ast.walk(node.func))
                    if site in seen:
                        continue
                    seen.add(site)
                    yield self.finding(
                        module, node,
                        f"{where} calls {fr}() when it is captured or built; "
                        "the replay and the cache are not keyed on it — read "
                        "it outside and pass the value in",
                    )
            elif isinstance(node, (ast.Attribute, ast.Name)):
                if not isinstance(getattr(node, "ctx", None), ast.Load):
                    continue
                fr = module.resolve(node)
                if fr and (fr == "os.environ"
                           or any(fr.startswith(p) for p in _AMBIENT_READ_PREFIXES)):
                    skip.update(id(d) for d in ast.walk(node))
                    if site in seen:
                        continue
                    seen.add(site)
                    yield self.finding(
                        module, node,
                        f"{where} reads ambient state '{fr}' when it is "
                        "captured or built; the replay and the cache are not "
                        "keyed on it",
                    )
                elif (isinstance(node, ast.Name) and node.id in globals_
                      and node.id not in local_binds and site not in seen):
                    seen.add(site)
                    yield self.finding(
                        module, node,
                        f"{where} reads mutable module global '{node.id}' "
                        "when it is captured or built; the replay and the "
                        "cache are not keyed on it",
                    )


# ---------------------------------------------------------------- TGL002

_KEY_PARAM_RE = re.compile(r"^(key|rng|prng\w*|\w*_key|\w*_rng)$")

#: replicate-axis key ARRAYS (the scenario matrix's batched key stacks)
#: — tracked like scalar keys inside scenarios/: feeding the whole axis
#: to two draws draws the same stream per replicate twice.
_KEY_ARRAY_PARAM_RE = re.compile(r"^(keys|\w*_keys)$")

#: The port's counter-based PRNG (``ops/random.py``, threefry as
#: ``jax.random``): the functions that mint a key from a key or a seed.
_KEY_ORIGINS = {"key", "key_from_jax", "fold_in", "split"}

#: Calls that take a key without spending it: ``fold_in`` derives
#: (its contract is minting many keys from one live parent), ``key_data``
#: reads the words, ``key`` / ``key_from_jax`` take a seed.
_NON_CONSUMING = {"fold_in", "key_data", "key", "key_from_jax", "shuffle_rounds"}


def _in_scenarios_scope(relpath: str) -> bool:
    return scopes.SCENARIOS.contains(relpath)


def _branches_compatible(a: tuple, b: tuple) -> bool:
    """Whether two If-arm paths can co-execute: incompatible iff they
    take DIFFERENT arms of the same ``if`` statement."""
    arms = dict(a)
    return all(arms.get(if_id, arm) == arm for if_id, arm in b)


def _random_fn(module: ModuleInfo, func: ast.expr) -> str | None:
    """The ``ops/random.py`` function a call names (``rnd.split`` ->
    ``"split"``), or None."""
    fr = module.resolve(func)
    if not fr or "." not in fr:
        return None
    mod, _, fn = fr.rpartition(".")
    if mod == "ops.random" or mod.endswith(".ops.random"):
        return fn
    return None


def _is_split_call(module: ModuleInfo, node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _random_fn(module, node.func) == "split"


@register
class PrngKeyReuse(Rule):
    """The torch counterpart of JGL002 (``prng-key-reuse``) on the
    port's PRNG, ``ops/random.py`` (``key``, ``split``, ``fold_in``,
    ``bits``, ``uniform``, ``normal``, ``bernoulli``, ``randint``,
    ``permutation``: threefry as ``jax.random``, bit for bit). A key
    consumed by two draws yields correlated draws (identical, for the
    same distribution and shape). Also flags split results that are
    partially discarded (``_`` targets, never-read names,
    ``split(k)[1:]``).

    Sanctioned idioms stay quiet: ``key, sub = split(key)`` (rebind in
    the consuming statement) and ``fold_in(key, i)`` (derivation — only
    ``split`` retires its input).

    Inside ``scenarios/``, where the Monte-Carlo discipline is
    ``fold_in(root, cell_id)``, two extra checks arm: two ``fold_in``
    call SITES with identical (key, data) operands mint the same derived
    key twice, and replicate-axis key ARRAYS (params named
    ``keys``/``*_keys``) are tracked like scalar keys."""

    id = "TGL002"
    name = "prng-key-reuse"
    description = (
        "ops/random.py key consumed by >=2 draws, consumed in a loop, "
        "split output partially discarded; in scenarios/: duplicate "
        "fold_in operands or replicate-axis key-array reuse"
    )


    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if "random" not in module.source:
            return  # no ops/random.py import: no call can resolve to it
        for rec in collect_functions(module).values():
            yield from self._check_function(module, rec)

    def _check_function(
        self, module: ModuleInfo, rec: FunctionRecord
    ) -> Iterator[Finding]:
        fn = rec.node
        # All names read anywhere in the function (nested defs included:
        # closures legitimately consume enclosing keys).
        loads = {
            n.id
            for n in ast.walk(fn)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
        }
        in_scenarios = _in_scenarios_scope(module.relpath)
        # name -> (bound_loop_depth, consumed_count, first_use_line)
        state: dict[str, list] = {
            p: [0, 0, 0]
            for p in rec.param_names()
            if _KEY_PARAM_RE.match(p)
            or (in_scenarios and _KEY_ARRAY_PARAM_RE.match(p))
        }
        # (key operand dump, data operand dump) -> [(site, branch path)]
        # — the scenarios/ duplicate-derivation check. Operand dumps are
        # TEXTUAL, so two guards keep the check sound: skip operands
        # naming anything reassigned in the function (`key =
        # fold_in(key, 7)` twice folds a DIFFERENT key each time — the
        # rethreading idiom this rule recommends), and never pair sites
        # from mutually exclusive If arms (only one executes).
        fold_sites: dict[tuple, list] = {}
        # Names with >= 2 binding sites: their value can differ
        # between two textually identical operand dumps, so they are
        # excluded from the duplicate-derivation check (a single
        # binding site yields one value per execution — a derived
        # key like `data_key = fold_in(root, cid)` stays checkable).
        # A parameter IS a binding site: `key = fold_in(key, 7)` then
        # folding `key` again folds the rebound value.
        assign_counts: dict[str, int] = {p: 1 for p in rec.param_names()}
        for n in ast.walk(fn):
            if isinstance(n, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
                targets = (n.target,)
            elif isinstance(n, ast.Assign):
                targets = tuple(n.targets)
            else:
                continue
            for t in targets:
                for el in ast.walk(t):
                    if isinstance(el, ast.Name):
                        assign_counts[el.id] = assign_counts.get(el.id, 0) + 1
        multiply_assigned = {k for k, c in assign_counts.items() if c >= 2}
        findings: list[Finding] = []

        def bind(name: str, depth: int) -> None:
            state[name] = [depth, 0, 0]

        def unbind(name: str) -> None:
            state.pop(name, None)

        def consume(name: str, node: ast.AST, depth: int) -> None:
            st = state.get(name)
            if st is None:
                return
            st[1] += 1
            if st[1] == 1:
                st[2] = node.lineno
                if depth > st[0]:
                    findings.append(
                        self.finding(
                            module,
                            node,
                            f"PRNG key '{name}' is consumed inside a loop "
                            "but bound outside it — every iteration reuses "
                            "the same key; split or fold_in per iteration",
                        )
                    )
            elif st[1] == 2:
                findings.append(
                    self.finding(
                        module,
                        node,
                        f"PRNG key '{name}' is consumed by a second "
                        f"draw (first use at line {st[2]}) — "
                        "split it and give each consumer its own key",
                    )
                )

        def handle_assign(node: ast.Assign | ast.AnnAssign, depth: int) -> None:
            value = node.value
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            origin = (
                isinstance(value, ast.Call)
                and _random_fn(module, value.func) in _KEY_ORIGINS
            )
            sub_of_split = isinstance(value, ast.Subscript) and _is_split_call(
                module, value.value
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    if origin or sub_of_split:
                        bind(t.id, depth)
                    else:
                        unbind(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)) and origin:
                    split = _random_fn(module, value.func) == "split"
                    for el in t.elts:
                        if not isinstance(el, ast.Name):
                            continue
                        if split and el.id == "_":
                            findings.append(
                                self.finding(
                                    module,
                                    el,
                                    "split output bound to '_' discards key "
                                    "material — size the split to the "
                                    "consumers",
                                )
                            )
                        elif split and el.id not in loads:
                            findings.append(
                                self.finding(
                                    module,
                                    el,
                                    f"split output '{el.id}' is never used — "
                                    "dead key material usually means a "
                                    "dropped consumer",
                                )
                            )
                        else:
                            bind(el.id, depth)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for el in t.elts:
                        if isinstance(el, ast.Name):
                            unbind(el.id)

        def scan_expr(
            node: ast.AST, depth: int, rebound: set[str] = frozenset(),
            branch: tuple = (),
        ) -> None:
            if isinstance(
                node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
            ):
                # Comprehensions ARE loops: a key consumed in the body
                # while bound outside is the same n-identical-draws bug
                # as the `for` form.
                for gen in node.generators:
                    scan_expr(gen.iter, depth, rebound, branch)
                    for cond in gen.ifs:
                        scan_expr(cond, depth + 1, rebound, branch)
                parts = (
                    (node.key, node.value)
                    if isinstance(node, ast.DictComp)
                    else (node.elt,)
                )
                for part in parts:
                    scan_expr(part, depth + 1, rebound, branch)
                return
            if (
                isinstance(node, ast.Subscript)
                and _is_split_call(module, node.value)
                and isinstance(node.slice, ast.Slice)
            ):
                # Anywhere a split output is sliced — assignment,
                # return, call argument — sibling keys vanish.
                findings.append(
                    self.finding(
                        module,
                        node,
                        "slice of split output discards sibling "
                        "keys — size the split to the consumers",
                    )
                )
            if isinstance(node, ast.Call):
                rfn = _random_fn(module, node.func)
                if (
                    in_scenarios
                    and rfn == "fold_in"
                    and len(node.args) >= 2
                ):
                    # Duplicate derivation: two distinct call SITES
                    # folding the same (key, data) pair mint the SAME
                    # key twice — in the cell-id discipline that means
                    # two consumers silently share a stream. One site
                    # reached many times (a loop over cell ids) is the
                    # sanctioned idiom and has one signature per
                    # distinct data expression. Excluded: operands
                    # naming a multiply-assigned variable (textual
                    # equality no longer means value equality), and
                    # site pairs in mutually exclusive If arms.
                    operand_names = {
                        el.id
                        for arg in node.args[:2]
                        for el in ast.walk(arg)
                        if isinstance(el, ast.Name)
                    }
                    if not (operand_names & multiply_assigned):
                        sig = (ast.dump(node.args[0]),
                               ast.dump(node.args[1]))
                        site = (node.lineno, node.col_offset)
                        entries = fold_sites.setdefault(sig, [])
                        if all(s != site for s, _ in entries):
                            clash = next(
                                (s for s, b in entries
                                 if _branches_compatible(b, branch)),
                                None,
                            )
                            if clash is not None:
                                findings.append(
                                    self.finding(
                                        module,
                                        node,
                                        "fold_in duplicates the derivation "
                                        f"at line {clash[0]} — identical "
                                        "(key, data) operands mint the same "
                                        "key twice; give each consumer its "
                                        "own fold constant",
                                    )
                                )
                            entries.append((site, branch))
                # fold_in is derivation, not consumption: it exists to
                # mint many independent keys from one live parent
                # (per-iteration fold_in is what this rule's own
                # message recommends). split, by contrast, retires
                # its input.
                if rfn is not None and rfn not in _NON_CONSUMING:
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        if isinstance(arg, ast.Name) and arg.id not in rebound:
                            consume(arg.id, node, depth)
            for child in ast.iter_child_nodes(node):
                scan_expr(child, depth, rebound, branch)

        def rebound_targets(node: ast.Assign | ast.AnnAssign) -> set[str]:
            """Target names of a key-origin assignment whose value also
            consumes them: ``key, sub = split(key)`` / ``key =
            fold_in(key, i)`` is the canonical per-iteration rethreading
            this rule RECOMMENDS — the self-consume is a rebind, not a
            spend."""
            value = node.value
            is_origin = (
                isinstance(value, ast.Call)
                and _random_fn(module, value.func) in _KEY_ORIGINS
            ) or (
                isinstance(value, ast.Subscript)
                and _is_split_call(module, value.value)
            )
            if not is_origin:
                return set()
            out: set[str] = set()
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                out |= {el.id for el in elts if isinstance(el, ast.Name)}
            return out

        def walk(body: Iterable[ast.stmt], depth: int,
                 branch: tuple = ()) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # separate scope, checked on its own
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    if stmt.value is not None:
                        scan_expr(stmt.value, depth, rebound_targets(stmt),
                                  branch)
                    handle_assign(stmt, depth)
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    scan_expr(stmt.iter, depth, branch=branch)
                    # Any tracked name in the (possibly tuple) loop
                    # target is rebound per iteration — `for i, key in
                    # enumerate(split(key, n))` is hygienic.
                    for el in ast.walk(stmt.target):
                        if isinstance(el, ast.Name) and el.id in state:
                            bind(el.id, depth + 1)
                    walk(stmt.body, depth + 1, branch)
                    walk(stmt.orelse, depth, branch)
                    continue
                if isinstance(stmt, ast.While):
                    scan_expr(stmt.test, depth, branch=branch)
                    walk(stmt.body, depth + 1, branch)
                    walk(stmt.orelse, depth, branch)
                    continue
                if isinstance(stmt, (ast.If,)):
                    scan_expr(stmt.test, depth, branch=branch)
                    # The two arms are mutually exclusive: a duplicate
                    # fold_in pair split across them never co-executes.
                    walk(stmt.body, depth, branch + ((id(stmt), 0),))
                    walk(stmt.orelse, depth, branch + ((id(stmt), 1),))
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        scan_expr(item.context_expr, depth, branch=branch)
                    walk(stmt.body, depth, branch)
                    continue
                if isinstance(stmt, ast.Try):
                    walk(stmt.body, depth, branch)
                    for h in stmt.handlers:
                        walk(h.body, depth, branch)
                    walk(stmt.orelse, depth, branch)
                    walk(stmt.finalbody, depth, branch)
                    continue
                scan_expr(stmt, depth, branch=branch)

        walk(fn.body, 0)
        yield from findings


# ---------------------------------------------------------------- TGL003

#: Attributes decided on the host without touching the device: shape,
#: dtype, device and layout tests are exempt, as JGL003 exempts them.
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "itemsize", "nbytes", "device",
    "is_cuda", "layout", "requires_grad", "is_sparse", "names",
}

#: Tensor methods whose value is a Python number, a host object or
#: metadata: not a device value.
_HOST_VALUE_METHODS = {
    "item", "tolist", "numpy", "size", "dim", "numel", "nelement", "stride",
    "data_ptr", "element_size", "is_contiguous", "storage_offset",
    "get_device", "is_floating_point", "is_complex", "untyped_storage",
    "record_stream",
}

#: ``torch.*`` names that are not tensor-valued functions.
_TORCH_NON_TENSOR = (
    "torch.cuda", "torch.backends", "torch.distributed", "torch.device",
    "torch.dtype", "torch.Size", "torch.is_tensor", "torch.get_default_dtype",
    "torch.no_grad", "torch.inference_mode", "torch.manual_seed",
    "torch.finfo", "torch.iinfo", "torch.profiler", "torch.autograd",
    "torch.utils", "torch.set_grad_enabled", "torch.is_floating_point",
    "torch.numel", "torch.get_float32_matmul_precision",
    "torch.set_float32_matmul_precision", "torch.version", "torch.library",
    "torch.ops", "torch.Generator",
)

#: Methods that read a device value back to the host.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: Calls whose output size depends on the data: the host waits for the
#: device to learn it.
_DATA_SIZED_CALLS = {
    "torch.nonzero", "torch.argwhere", "torch.unique",
    "torch.unique_consecutive", "torch.masked_select", "torch.bincount",
}
_DATA_SIZED_METHODS = {
    "nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
    "bincount",
}

#: Tensor factories that copy host data: with a ``device=`` they copy it
#: to the card, and a pageable host-to-device copy waits for the queue.
_HOST_FACTORIES = {"torch.tensor", "torch.as_tensor"}

#: Bool-valued tensor functions and methods: their output indexes by mask.
_MASK_CALLS = {
    "torch.isfinite", "torch.isnan", "torch.isinf", "torch.logical_and",
    "torch.logical_or", "torch.logical_not", "torch.logical_xor",
    "torch.eq", "torch.ne", "torch.lt", "torch.le", "torch.gt", "torch.ge",
}
_MASK_METHODS = {
    "bool", "isfinite", "isnan", "isinf", "logical_and", "logical_or",
    "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt", "ge",
}


def _torch_tensor_call(name: str | None) -> bool:
    return bool(name) and name.startswith("torch.") and not any(
        name == p or name.startswith(p + ".") for p in _TORCH_NON_TENSOR
    )


class _TensorNames:
    """Which names of one function hold device tensors, by provenance:
    parameters annotated ``torch.Tensor``, and names assigned from a
    ``torch.*`` call or from arithmetic, indexing or a tensor method on a
    tensor. The inference is syntactic and one-pass, in source order."""

    def __init__(self, module: ModuleInfo, fn: FunctionNode):
        self.module = module
        self.tensors: set[str] = set()
        self.masks: set[str] = set()
        #: names of tensors known to lie in host memory (made without a
        #: device, or read back with ``.cpu()``).
        self.host: set[str] = set()
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = a.annotation
            if ann is not None and (module.resolve(ann) or "").endswith("Tensor"):
                self.tensors.add(a.arg)
        for node in sorted(
            (n for n in body_nodes(fn)
             if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))),
            key=lambda n: (n.lineno, n.col_offset),
        ):
            value = node.value
            if value is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            tensor, mask = self.is_tensor(value), self.is_mask(value)
            host = self.is_host(value)
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                multi = len(elts) > 1
                for el in elts:
                    if not isinstance(el, ast.Name):
                        continue
                    # ``a, b = torch.sort(x)``: every part is a tensor.
                    if tensor and (not multi or isinstance(value, ast.Call)):
                        self.tensors.add(el.id)
                    elif not isinstance(node, ast.AugAssign):
                        self.tensors.discard(el.id)
                    if mask and not multi:
                        self.masks.add(el.id)
                    elif not isinstance(node, ast.AugAssign):
                        self.masks.discard(el.id)
                    if host and not multi:
                        self.host.add(el.id)
                    elif not isinstance(node, ast.AugAssign):
                        self.host.discard(el.id)

    def is_tensor(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tensors
        if isinstance(e, ast.Call):
            if _torch_tensor_call(self.module.resolve(e.func)):
                return True
            f = e.func
            return (isinstance(f, ast.Attribute) and f.attr not in _HOST_VALUE_METHODS
                    and f.attr not in _STATIC_ATTRS and self.is_tensor(f.value))
        if isinstance(e, ast.Attribute):
            return e.attr not in _STATIC_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return False
            return any(self.is_tensor(v) for v in [e.left, *e.comparators])
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False

    def is_host(self, e: ast.expr) -> bool:
        """A tensor in host memory: ``torch.from_numpy``, ``torch.tensor``
        / ``torch.as_tensor`` without a device, ``.cpu()``."""
        if isinstance(e, ast.Name):
            return e.id in self.host
        if not isinstance(e, ast.Call):
            return False
        fr = self.module.resolve(e.func)
        if fr == "torch.from_numpy":
            return True
        if fr in _HOST_FACTORIES:
            return not any(kw.arg == "device" for kw in e.keywords)
        return isinstance(e.func, ast.Attribute) and e.func.attr == "cpu" and not e.args

    def is_mask(self, e: ast.expr) -> bool:
        """A boolean tensor: a comparison or logical op of tensors, a
        bool-valued torch function or method, or a name bound to one."""
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            return self.is_tensor(e)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(e.left) or self.is_mask(e.right)
        if isinstance(e, ast.Call):
            if self.module.resolve(e.func) in _MASK_CALLS:
                return True
            f = e.func
            return (isinstance(f, ast.Attribute) and f.attr in _MASK_METHODS
                    and self.is_tensor(f.value))
        return False


def _is_dtype(module: ModuleInfo, e: ast.expr) -> bool:
    fr = module.resolve(e) or ""
    return fr.startswith("torch.") and fr.split(".")[-1] in (
        "float", "float32", "float64", "double", "half", "float16", "bfloat16",
        "int", "int32", "int64", "long", "int16", "int8", "uint8", "bool", "uint32")


def _index_parts(idx: ast.expr) -> list[ast.expr]:
    return list(idx.elts) if isinstance(idx, ast.Tuple) else [idx]


@register
class HostSyncOnHotPath(Rule):
    """The torch counterpart of JGL003 (``traced-python-branch``). Where
    JAX raises on a Python ``if`` over a tracer, PyTorch answers it — by
    waiting for the device: the host blocks until the card has drained
    its queue, and the next launch starts from an idle card. On the hot
    path (:data:`~.torchast.HOT_PATH`, once a grow level, tree chunk or
    served batch) and in captured bodies (where a sync breaks the
    capture), every such wait is flagged:

    * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
    * ``float()``, ``int()`` or ``bool()`` of a tensor, and a Python
      ``if``/``while`` whose test is a tensor;
    * ``torch.cuda.synchronize()`` and ``Event``/``Stream``
      ``.synchronize()``;
    * ``nonzero``, ``unique``, ``masked_select``, ``bincount`` (output
      sized by the data) and boolean-mask indexing ``x[mask]``.

    Shape, dtype, device and ``is None`` tests are exempt, as in JGL003.
    A tensor is known by provenance (an annotation, a ``torch.*`` call,
    arithmetic on a tensor). A sync the path needs carries a suppression
    with its reason; ``chip_smoke.py``'s ``path_static`` holds the rule
    to the card's own sync report on the hot sections."""

    id = "TGL003"
    name = "host-sync-on-hot-path"
    description = (
        "host sync (.item/.tolist/.cpu/.numpy, float/int/bool or if/while "
        "on a tensor, synchronize(), nonzero/unique, mask indexing) in a "
        "hot-path or captured function"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        records = collect_functions(module)
        reached = reached_functions(module, records, ("hot", "captured"))
        regions = captured_regions(module, records)
        seen: set[int] = set()
        for qual, how in sorted(reached.items()):
            rec = records[qual]
            yield from self._scan(module, rec.node, body_nodes(rec.node),
                                  _where(records, qual, how), seen)
        for region in regions:
            rec = records[region.qual]
            yield from self._scan(module, rec.node, region.nodes(),
                                  f"the graph capture in '{rec.name}'", seen)

    def _scan(self, module, fn, nodes, where, seen) -> Iterator[Finding]:
        names = _TensorNames(module, fn)
        for node in sorted(nodes, key=lambda n: (getattr(n, "lineno", 0),
                                                 getattr(n, "col_offset", 0))):
            what = self._sync(module, names, node)
            line = getattr(node, "lineno", 0)
            if what is None or line in seen:
                continue
            seen.add(line)
            yield self.finding(
                module, node,
                f"host sync: {what} in {where} — the host waits for the "
                "card's queue to drain on the hot path; keep the value on "
                "the device, or suppress with the reason this read is needed",
            )

    def _sync(self, module, names: _TensorNames, node: ast.AST) -> str | None:
        if isinstance(node, (ast.If, ast.While)) and names.is_tensor(node.test):
            kind = "if" if isinstance(node, ast.If) else "while"
            return f"Python `{kind}` on a tensor"
        if isinstance(node, ast.Call):
            fr = module.resolve(node.func)
            f = node.func
            if fr == "torch.cuda.synchronize":
                return "torch.cuda.synchronize()"
            if isinstance(f, ast.Attribute):
                if f.attr in _SYNC_METHODS and not node.args:
                    return f".{f.attr}()"
                if f.attr == "synchronize":
                    return ".synchronize()"
                if f.attr in _DATA_SIZED_METHODS and names.is_tensor(f.value):
                    return f".{f.attr}() (output sized by the data)"
            if fr in _HOST_FACTORIES and any(
                    kw.arg == "device" and not (isinstance(kw.value, ast.Constant)
                                                and kw.value.value == "cpu")
                    for kw in node.keywords):
                return f"{fr}(..., device=) (a host-to-device copy)"
            if isinstance(f, ast.Attribute):
                if f.attr == "cuda" and not node.args:
                    return ".cuda() (a host-to-device copy)"
                if f.attr == "copy_" and node.args and names.is_host(node.args[0]):
                    return ".copy_() of a host tensor (a host-to-device copy)"
                if (f.attr == "to" and names.is_host(f.value)
                        and (node.args or any(kw.arg == "device" for kw in node.keywords))
                        and not all(_is_dtype(module, a) for a in node.args)):
                    return ".to() of a host tensor (a host-to-device copy)"
            if fr in _DATA_SIZED_CALLS:
                return f"{fr}() (output sized by the data)"
            if fr == "torch.where" and len(node.args) == 1 and not node.keywords:
                return "torch.where(cond) (output sized by the data)"
            if (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                    and len(node.args) == 1 and names.is_tensor(node.args[0])):
                return f"{f.id}() of a tensor"
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            if any(names.is_mask(p) for p in _index_parts(node.slice)):
                return "boolean-mask indexing"
        return None


def classify_sync_sites(root: str, sites: dict[str, int]) -> dict:
    """Hold the card's own sync report to TGL003. ``sites`` maps the
    nearest frame inside the package of each synchronizing call
    (``file:line``, relative to ``root``, as ``chip_smoke.py`` records it
    under ``torch.cuda.set_sync_debug_mode("warn")``) to its count. A site
    whose line lies in a function TGL003 covers (a hot-path table entry,
    a function it reaches, or a captured span) is ``hot``, and must be a
    TGL003 finding (suppressed in the tree, with its reason); one that is
    not lands in ``missed``. Every other site is ``other``, for the
    record."""
    out: dict = {"hot": {}, "other": {}, "missed": []}
    modules: dict[str, ModuleInfo] = {}
    flagged: dict[str, set[int]] = {}
    for site in sorted(sites):
        rel, _, line_s = site.rpartition(":")
        line = int(line_s) if line_s.isdigit() else 0
        if rel not in modules:
            try:
                with open(os.path.join(root, rel), encoding="utf-8") as f:
                    modules[rel] = ModuleInfo(os.path.join(root, rel), rel, f.read())
            except (OSError, SyntaxError, ValueError):
                modules[rel] = None
            if modules[rel] is not None:
                rule = HostSyncOnHotPath()
                flagged[rel] = {f.line for f in rule.check(modules[rel])}
        module = modules[rel]
        fn = _hot_function_at(module, line) if module is not None else None
        row = {"count": sites[site], "function": fn}
        if fn is None:
            out["other"][site] = row
        else:
            row["flagged"] = line in flagged[rel]
            out["hot"][site] = row
            if not row["flagged"]:
                out["missed"].append(site)
    return out


def _hot_function_at(module: ModuleInfo, line: int) -> str | None:
    """The innermost function TGL003 covers whose body holds ``line``
    (a captured span counts as its function), else None."""
    records = collect_functions(module)
    covered = reached_functions(module, records, ("hot", "captured"))
    best: tuple[int, str] | None = None
    for qual, rec in records.items():
        node = rec.node
        if not node.lineno <= line <= (node.end_lineno or node.lineno):
            continue
        if best is None or node.lineno > best[0]:
            best = (node.lineno, qual)
    if best is None:
        return None
    qual = best[1]
    if qual in covered:
        return qual
    for region in captured_regions(module, records):
        if region.qual == qual and any(
                s.lineno <= line <= (s.end_lineno or s.lineno) for s in region.stmts):
            return qual
    return None


# ---------------------------------------------------------------- TGL004

_F64_NAMES = {"torch.float64", "torch.double", "numpy.float64", "numpy.double"}
_F64_STRINGS = {"float64", "double", "f8", ">f8", "<f8"}

#: The float32 pin: ``ate_replication_causalml_torch/__init__.py`` sets
#: both TF32 switches False for the process; any other write creeps.
_TF32_ATTRS = {"allow_tf32"}
_REDUCED_PRECISION_ATTRS = {
    "allow_fp16_reduced_precision_reduction",
    "allow_bf16_reduced_precision_reduction",
}
_AUTOCAST_NAMES = {"torch.autocast", "torch.amp.autocast", "torch.cuda.amp.autocast",
                   "torch.cpu.amp.autocast"}


def _in_dtype_scope(relpath: str) -> bool:
    return scopes.DTYPE.contains(relpath)


def _is_false(e: ast.expr) -> bool:
    return isinstance(e, ast.Constant) and e.value is False


@register
class DtypeDrift(Rule):
    """The torch counterpart of JGL004 (``dtype-drift``). The port's
    numerics contract is float32 (the JAX package's session policy):
    a literal ``torch.float64``/``torch.double``/``.double()`` (or
    ``np.float64``) in ``ops/``/``estimators/`` silently promotes. The
    port's float64 islands — exact cross-device paths that take
    ``sqrt``, ``sigmoid`` and division in float64, the balancing QP —
    carry suppressions with their reasons.

    Anywhere in the package, TF32 creep against the pin at
    ``__init__.py`` (both ``allow_tf32`` switches False): any other
    write of ``allow_tf32``, ``torch.set_float32_matmul_precision`` other
    than ``"highest"``, ``torch.autocast`` / ``torch.cuda.amp``, and the
    reduced-precision reduction switches set to anything but False."""

    id = "TGL004"
    name = "dtype-drift"
    description = (
        "literal float64 in ops/ or estimators/ drifts against the "
        "float32 policy; anywhere: TF32 / autocast / reduced-precision "
        "reductions creep against the float32 pin"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        yield from self._precision(module)
        if not _in_dtype_scope(module.relpath):
            return
        flagged: set[int] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Compare):
                # A dtype test (``x.dtype == torch.float64``) reads the
                # dtype; it pins nothing.
                for v in [node.left, *node.comparators]:
                    elts = v.elts if isinstance(v, (ast.Tuple, ast.List, ast.Set)) else [v]
                    flagged.update(id(c) for e in elts
                                   if isinstance(e, (ast.Attribute, ast.Name))
                                   for c in ast.walk(e))
            elif isinstance(node, (ast.Attribute, ast.Name)):
                fr = module.resolve(node)
                if fr in _F64_NAMES and id(node) not in flagged:
                    yield self.finding(
                        module, node,
                        f"literal {fr} pins float64 against the float32 "
                        "policy — derive the dtype from the operand, or "
                        "suppress with the reason this path needs float64",
                    )
                    if isinstance(node, ast.Attribute):
                        flagged.update(id(c) for c in ast.walk(node))
            elif isinstance(node, ast.keyword) and node.arg == "dtype":
                v = node.value
                if isinstance(v, ast.Constant) and v.value in _F64_STRINGS:
                    yield self.finding(
                        module, v,
                        f"dtype={v.value!r} pins float64 against the float32 "
                        "policy — derive the dtype from the operand",
                    )
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "double" and not node.args):
                yield self.finding(
                    module, node,
                    ".double() pins float64 against the float32 policy — "
                    "derive the dtype from the operand, or suppress with "
                    "the reason this path needs float64",
                )

    def _precision(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if node.value is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    attr = t.attr if isinstance(t, ast.Attribute) else (
                        t.id if isinstance(t, ast.Name) else None)
                    if attr in _TF32_ATTRS and not _is_false(node.value):
                        yield self.finding(
                            module, node,
                            f"write of {attr} other than the float32 pin "
                            "(False, ate_replication_causalml_torch/"
                            "__init__.py) — TF32 keeps ~3 decimal digits "
                            "and moves every float32 contract",
                        )
                    elif attr in _REDUCED_PRECISION_ATTRS and not _is_false(node.value):
                        yield self.finding(
                            module, node,
                            f"{attr} set other than False — reduced-"
                            "precision reductions move the float32 contracts",
                        )
            elif isinstance(node, ast.Call):
                fr = module.resolve(node.func) or ""
                if fr == "torch.set_float32_matmul_precision":
                    arg = node.args[0] if node.args else None
                    if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                        yield self.finding(
                            module, node,
                            "torch.set_float32_matmul_precision other than "
                            "'highest' lets float32 matmuls run in TF32 or "
                            "bf16 against the float32 pin",
                        )
                elif fr in _AUTOCAST_NAMES or fr.startswith("torch.cuda.amp."):
                    yield self.finding(
                        module, node,
                        f"{fr} runs float32 ops in reduced precision "
                        "against the float32 pin",
                    )


# ---------------------------------------------------------------- JGL005


@register
class NonAtomicWrite(Rule):
    """A kill mid-write leaves a truncated artifact beside valid ones —
    the failure mode PR 1 closed by routing every persisted artifact
    through ``observability.export.atomic_write_text`` (tmp file +
    fsync + ``os.replace``). Everything outside that module must use the
    blessed helpers, not ``open(..., 'w')``/``json.dump``."""

    id = "JGL005"
    name = "non-atomic-write"
    description = (
        "open(..., 'w')/json.dump outside observability/export.py — use "
        "atomic_write_text/atomic_write_json"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if scopes.EXPORT_MODULE.contains(module.relpath):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fr = module.resolve(node.func)
            if fr == "json.dump":
                yield self.finding(
                    module,
                    node,
                    "json.dump writes through a live handle — use "
                    "observability.export.atomic_write_json",
                )
                continue
            if fr not in ("open", "os.fdopen", "io.open"):
                continue
            mode = None
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if isinstance(mode, str) and ("w" in mode or "x" in mode):
                yield self.finding(
                    module,
                    node,
                    f"non-atomic {fr}(..., {mode!r}) — a kill mid-write "
                    "leaves a truncated file; use observability.export."
                    "atomic_write_text/atomic_write_json (append-mode "
                    "journals are exempt by design)",
                )


# ---------------------------------------------------------------- JGL006

_LOCK_ATTR_NAMES = {"_lock", "lock"}
_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
}
_EXEMPT_FACTORIES = {"threading.local", "itertools.count"}
_CONTAINER_FACTORIES = {
    "dict", "list", "set", "collections.deque", "collections.defaultdict",
    "collections.OrderedDict",
}


def _self_attr(node: ast.expr, self_name: str) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == self_name
    ):
        return node.attr
    return None


@register
class UnlockedSharedState(Rule):
    """The observability registry/event log are mutated from the sweep
    driver, the shard-retry loop, and compile-cache listener threads at
    once; every mutation of a lock-guarded container must hold the
    instance lock or snapshots can tear (and dict/deque invariants can
    corrupt under free-threading)."""

    id = "JGL006"
    name = "unlocked-shared-state"
    description = (
        "observability/ class mutates lock-guarded shared state outside "
        "`with self._lock`"
    )
    #: what the finding message calls the guarded state (subclasses
    #: rescope the rule — JGL008 covers the sweep scheduler/checkpoint).
    _context = "registry/event-log shared state"

    def _in_scope(self, relpath: str) -> bool:
        # observability/slo.py belongs to the SERVING plane's shared-
        # state rule (JGL008) — one rule per file, or every finding
        # there would be reported twice.
        return scopes.OBSERVABILITY_STATE.contains(relpath)

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not self._in_scope(module.relpath):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(module, node)

    def _check_class(
        self, module: ModuleInfo, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        init = next(
            (
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        if init is None or not init.args.args:
            return
        self_name = init.args.args[0].arg
        locks: set[str] = set()
        shared: set[str] = set()
        for stmt in ast.walk(init):
            # Annotated assignments (`self.done: dict = {}`) declare
            # shared containers just as often as plain ones do.
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
            else:
                continue
            value = stmt.value
            for t in targets:
                attr = _self_attr(t, self_name)
                if attr is None:
                    continue
                resolved = (
                    module.resolve(value.func)
                    if isinstance(value, ast.Call)
                    else None
                )
                if attr in _LOCK_ATTR_NAMES or resolved in _LOCK_FACTORIES:
                    locks.add(attr)
                elif resolved in _EXEMPT_FACTORIES:
                    continue
                elif isinstance(
                    value, (ast.Dict, ast.List, ast.Set)
                ) or resolved in _CONTAINER_FACTORIES:
                    shared.add(attr)
                elif isinstance(value, ast.Constant) and isinstance(
                    value.value, (int, float)
                ):
                    # Mutable scalars (counters): plain rebinding is
                    # atomic-enough, but += is a read-modify-write race.
                    shared.add(attr)
        if not locks or not shared:
            return

        for method in cls.body:
            if not isinstance(method, ast.FunctionDef) or method.name == "__init__":
                continue
            if not method.args.args:
                continue
            m_self = method.args.args[0].arg
            yield from self._scan(
                module, cls, method.body, m_self, locks, shared, locked=False
            )

    def _scan(
        self,
        module: ModuleInfo,
        cls: ast.ClassDef,
        body: Iterable[ast.stmt],
        self_name: str,
        locks: set[str],
        shared: set[str],
        locked: bool,
    ) -> Iterator[Finding]:
        def flag(node: ast.AST, attr: str) -> Finding:
            return self.finding(
                module,
                node,
                f"{cls.name}.{attr} is mutated outside `with self."
                f"{sorted(locks)[0]}` — {self._context} "
                "must be mutated under the instance lock",
            )

        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            now_locked = locked
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    attr = _self_attr(item.context_expr, self_name)
                    if attr in locks:
                        now_locked = True
            if not now_locked:
                mutations = self._mutations_in(stmt, self_name, shared)
                for node, attr in mutations:
                    yield flag(node, attr)
            for attr_name in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr_name, None)
                if sub:
                    yield from self._scan(
                        module, cls, sub, self_name, locks, shared, now_locked
                    )
            for h in getattr(stmt, "handlers", ()):
                yield from self._scan(
                    module, cls, h.body, self_name, locks, shared, now_locked
                )

    def _mutations_in(
        self, stmt: ast.stmt, self_name: str, shared: set[str]
    ) -> list[tuple[ast.AST, str]]:
        out: list[tuple[ast.AST, str]] = []
        # Only this statement's own expression layer — child statements
        # are visited by _scan with their own locked context. Compound
        # statements contribute their header expressions.
        if not hasattr(stmt, "body"):
            nodes: list[ast.AST | None] = [stmt]
        elif isinstance(stmt, (ast.If, ast.While)):
            nodes = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            nodes = [stmt.iter, stmt.target]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            nodes = [i.context_expr for i in stmt.items]
        else:
            nodes = []
        for root in nodes:
            if root is None:
                continue
            for node in ast.walk(root):
                if isinstance(
                    node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Delete)
                ):
                    if isinstance(node, ast.AnnAssign) and node.value is None:
                        continue  # bare annotation: no mutation
                    targets = (
                        node.targets
                        if isinstance(node, (ast.Assign, ast.Delete))
                        else [node.target]
                    )
                    for t in targets:
                        attr = _self_attr(t, self_name)
                        if attr in shared:
                            out.append((node, attr))
                        elif isinstance(t, ast.Subscript):
                            attr = _self_attr(t.value, self_name)
                            if attr in shared:
                                out.append((node, attr))
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    if node.func.attr in MUTATOR_METHODS:
                        attr = _self_attr(node.func.value, self_name)
                        if attr in shared:
                            out.append((node, attr))
        return out


# ---------------------------------------------------------------- JGL008


@register
class UnlockedSchedulerState(UnlockedSharedState):
    """ISSUE 4's failure class: the sweep scheduler's ready queue /
    outcome buffer / nuisance-cache entries and the checkpoint
    journal's in-memory row map are mutated from a worker pool; any
    mutation outside the sanctioned instance lock can tear the ordered
    commit sequence or interleave journal appends. Same engine as
    JGL006, rescoped to ``scheduler/``, ``serving/`` and the pipeline
    drivers (the ``_Checkpoint`` class lives in ``pipeline.py``).
    ``serving/`` joined with ISSUE 6: the daemon is the most
    thread-shared code in the tree — per-connection reader threads, the
    coalescer's dispatcher, and the degraded-mode reload thread all
    touch the same model/executable/queue state. ISSUE 7 added the
    observability plane: ``observability/slo.py`` (the SLO engine's
    snapshot history is ticked from the dispatcher and read from admin
    probe threads) and the ``serving/admin.py`` endpoint — both serve
    concurrent readers over state the daemon mutates. ISSUE 11's fleet
    layer (``serving/fleet.py``, ``serving/retrain.py``) is squarely in
    scope: the model registry is swapped by rotation threads while the
    dispatcher binds it, and the shedder's burn cache is written from
    the dispatcher and read from every producer."""

    id = "JGL008"
    name = "unlocked-scheduler-state"
    description = (
        "scheduler/, serving/, observability/slo.py or pipeline "
        "checkpoint class mutates lock-guarded shared state outside "
        "the sanctioned instance lock"
    )
    _context = "scheduler/serving/checkpoint shared state"

    def _in_scope(self, relpath: str) -> bool:
        # Only the top-level driver (<pkg>/pipeline.py) hosts
        # _Checkpoint — scopes.SCHEDULER_STATE's top_files matching
        # keeps data/pipeline.py and any nested pipeline.py out (the
        # PR 4 endswith bug this module used to carry).
        return scopes.SCHEDULER_STATE.contains(relpath)


# ---------------------------------------------------------------- JGL007

_BROAD_EXC = {"Exception", "BaseException"}


def _in_resilience_scope(relpath: str) -> bool:
    # Paths allowed to make blanket exception decisions: the resilience
    # layer's whole job is classified handling, and the shard runner's
    # probe/retry loops are the sanctioned swallow sites.
    return scopes.RESILIENCE_EXEMPT.contains(relpath)


@register
class SilentExceptionSwallow(Rule):
    """ISSUE 3's failure class: a bare ``except Exception: pass`` (or a
    ``retriable=(Exception,)`` shard-retry tuple) swallows programming
    errors — the ``TypeError`` that should have killed the run on
    attempt 1 instead burns the retry budget and surfaces, if at all,
    as a mysterious "shard failure". Error-class decisions belong to
    ``resilience.errors.classify``; everywhere else must either narrow
    the type, record the failure, or carry an explicit suppression."""

    id = "JGL007"
    name = "silent-exception-swallow"
    description = (
        "bare `except Exception: pass` or overly-broad retriable= tuple "
        "outside resilience/ and parallel/retry.py"
    )

    def _is_broad(self, module: ModuleInfo, type_node: ast.expr | None) -> bool:
        if type_node is None:  # bare `except:` — broader than broad
            return True
        nodes = (
            type_node.elts
            if isinstance(type_node, ast.Tuple)
            else [type_node]
        )
        return any(module.resolve(n) in _BROAD_EXC for n in nodes)

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if _in_resilience_scope(module.relpath):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ExceptHandler):
                silent = all(
                    isinstance(s, (ast.Pass, ast.Continue)) for s in node.body
                )
                if silent and self._is_broad(module, node.type):
                    label = (
                        "bare `except:`" if node.type is None
                        else "`except Exception`"
                    )
                    yield self.finding(
                        module,
                        node,
                        f"{label} with a pass/continue body swallows "
                        "programming errors silently — narrow the type, "
                        "record the failure, or classify via "
                        "resilience.errors",
                    )
            elif isinstance(node, ast.keyword) and node.arg == "retriable":
                broad = next(
                    (
                        n
                        for n in ast.walk(node.value)
                        if isinstance(n, (ast.Name, ast.Attribute))
                        and module.resolve(n) in _BROAD_EXC
                    ),
                    None,
                )
                if broad is not None:
                    yield self.finding(
                        module,
                        broad,
                        "retriable tuple includes Exception/BaseException — "
                        "this retries programming errors; use the "
                        "classified default (retriable=None) or list the "
                        "transient types",
                    )


# ---------------------------------------------------------------- JGL009

_WALLCLOCK_CALL = "time.time"


@register
class WallClockDuration(Rule):
    """ISSUE 5's timeline contract: every duration in the trace /
    overlap analysis comes from the monotonic clock, because
    ``time.time()`` can step (NTP slew, manual clock set) and a stepped
    difference silently corrupts span durations, backoff budgets and
    bench numbers. Outside ``observability/`` (which records both
    clocks on purpose, keeping the wall-clock anchor in ONE place),
    any ``time.time()`` difference must be ``time.monotonic()`` /
    ``time.perf_counter()`` instead."""

    id = "JGL009"
    name = "wallclock-duration"
    description = (
        "time.time() used in duration arithmetic outside observability/ "
        "— use time.monotonic()/time.perf_counter()"
    )

    def _is_walltime_call(self, module: ModuleInfo, node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Call)
            and module.resolve(node.func) == _WALLCLOCK_CALL
        )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        # The telemetry layer records BOTH clocks deliberately (span
        # records carry ``start_unix`` next to ``start_mono_s``).
        if scopes.WALLCLOCK_EXEMPT.contains(module.relpath):
            return
        # Names bound from time.time() anywhere in the module
        # (name-based, not scope-exact — the linter's stated precision).
        tainted: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and getattr(
                node, "value", None
            ) is not None and self._is_walltime_call(module, node.value):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)

        def is_wall(operand: ast.expr) -> bool:
            if self._is_walltime_call(module, operand):
                return True
            return isinstance(operand, ast.Name) and operand.id in tainted

        for node in ast.walk(module.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                if is_wall(node.left) or is_wall(node.right):
                    yield self.finding(
                        module,
                        node,
                        "duration computed from time.time() — the wall "
                        "clock can step (NTP), silently corrupting the "
                        "difference; use time.monotonic()/"
                        "time.perf_counter() (observability/ owns the "
                        "wall-clock anchor)",
                    )


# ---------------------------------------------------------------- JGL010

#: the host-materialization calls the artifact plane owns: a bare
#: ``np.asarray`` on a jax array is a device_get (a per-shard fetch and
#: host assemble), and both escape the transfer metering.
_HOST_MATERIALIZE_CALLS = {"numpy.asarray", "jax.device_get"}

#: ... and the port's: a device tensor read back to the host (the JAX
#: rule's names kept, so the shared findings stay the same).
_HOST_MATERIALIZE_METHODS = ("cpu", "numpy", "tolist")


@register
class UnmeteredHostMaterialization(Rule):
    """ISSUE 8's boundary contract: every byte a nuisance artifact
    moves between host and device goes through ``parallel/shardio.py``,
    which meters it into ``artifact_transfer_bytes_total`` and applies
    the mesh-lane discipline to the collective paths. A bare
    ``np.asarray``/``jax.device_get`` in the scheduler or the sweep
    driver is exactly the PR-4 ``materialized()`` host bounce this PR
    removed — unmetered host bandwidth, invisible to the mesh-scaling
    byte accounting, and (for sharded inputs) a device sync outside the
    sanctioned gather path."""

    id = "JGL010"
    name = "unmetered-host-materialization"
    description = (
        "np.asarray/jax.device_get (port: .cpu()/.numpy()/.tolist()) in "
        "scheduler/ or pipeline.py outside the metered "
        "parallel/shardio.py artifact plane"
    )

    def _in_scope(self, relpath: str) -> bool:
        # Same scope shape as JGL008: the scheduler package plus the
        # top-level driver only — data/pipeline.py and any nested
        # pipeline.py do host I/O legitimately.
        return scopes.HOST_TRANSFER.contains(relpath)

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not self._in_scope(module.relpath):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = module.resolve(node.func)
            if (isinstance(node.func, ast.Attribute) and not node.args
                    and node.func.attr in _HOST_MATERIALIZE_METHODS):
                # The torch names: a device tensor's host copy.
                name = f".{node.func.attr}()"
            if name in _HOST_MATERIALIZE_CALLS or name in (
                    f".{m}()" for m in _HOST_MATERIALIZE_METHODS):
                yield self.finding(
                    module,
                    node,
                    f"{name} host-materializes outside the metered "
                    "artifact plane — route the transfer through "
                    "parallel/shardio.py (gather_host/commit) so the "
                    "bytes are counted and the mesh-lane discipline "
                    "holds",
                )


# ---------------------------------------------------------------- TGL011

#: Function names that ARE the predict path in models/: routing, leaf
#: indexing and CATE scoring (JGL011's list). Grow-time code is out of
#: scope.
_PREDICT_FN_RE = re.compile(
    r"(predict|route|leaf_index|forest_apply|apply_trees|per_tree)"
)

#: Subscript index names that look like a per-row id vector (JGL011's).
_ROW_ID_NAME_RE = re.compile(
    r"^(node|nodes|ids|idx|node_of_row|leaf_index|li|train_leaf)$"
    r"|(^|_)(node|leaf)_(ids?|idx)(_|$)"
    r"|_ids?$|_idx$"
)

_GATHER_CALLS = {"torch.gather", "torch.index_select", "torch.take",
                 "torch.take_along_dim"}
_GATHER_METHODS = {"gather", "index_select", "take", "take_along_dim"}


@register
class PredictPathRowGather(Rule):
    """The torch counterpart of JGL011 (``predict-row-gather``): a
    per-row dynamic gather (``torch.gather``, ``index_select``, ``take``,
    ``codes[node_ids]``) in a ``models/`` predict, route, leaf-index or
    apply function. On the card those rows go through the fused row
    kernels (``ops/tree.py``: ``traverse``, ``table_lookup``,
    ``leaf_record``), which replaced a route-and-gather sequence 3.6–6.5×
    slower (PERF.md, kernel table rows 6–7); a gather creeping back is a
    silent regression the bit-identity tests cannot catch (the VALUES are
    right), so the lint catches the form."""

    id = "TGL011"
    name = "predict-row-gather"
    description = (
        "torch.gather/index_select/take or [...] per-row gather in a "
        "models/ predict-path function — route through the row kernels "
        "(ops/tree.py traverse/table_lookup)"
    )

    def _in_scope(self, relpath: str) -> bool:
        return scopes.MODELS.contains(relpath)

    def _is_row_id_index(self, idx: ast.expr) -> bool:
        if isinstance(idx, ast.Name):
            return bool(_ROW_ID_NAME_RE.search(idx.id))
        if isinstance(idx, ast.Tuple):
            return any(self._is_row_id_index(e) for e in idx.elts)
        return False

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not self._in_scope(module.relpath):
            return
        seen: set[int] = set()
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _PREDICT_FN_RE.search(fn.name):
                continue
            for node in ast.walk(fn):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                if isinstance(node, ast.Call):
                    name = module.resolve(node.func)
                    if name not in _GATHER_CALLS:
                        if not (isinstance(node.func, ast.Attribute)
                                and node.func.attr in _GATHER_METHODS):
                            continue
                        name = f".{node.func.attr}()"
                    yield self.finding(
                        module, node,
                        f"{name} is a per-row dynamic gather in "
                        f"predict-path function {fn.name!r} — route the "
                        "rows through the row kernels "
                        "(ops/tree.py::traverse/table_lookup)",
                    )
                elif isinstance(node, ast.Subscript) and self._is_row_id_index(
                    node.slice
                ):
                    yield self.finding(
                        module, node,
                        f"[...] indexing by a row-id vector in "
                        f"predict-path function {fn.name!r} is a per-row "
                        "dynamic gather — route the rows through the row "
                        "kernels (ops/tree.py::traverse/table_lookup)",
                    )


# ---------------------------------------------------------------- JGL012

#: Method names whose zero-argument call form blocks FOREVER on the
#: stdlib's synchronization/queue/thread types. `.get()` is included
#: because `queue.Queue().get()` is the classic unbounded consumer;
#: `dict.get()` always takes arguments, so the zero-arg restriction
#: keeps it out of scope.
_BLOCKING_ATTRS = ("acquire", "wait", "join", "get")


@register
class UnboundedBlockingCall(Rule):
    """ISSUE 14's liveness contract: the watchdog can only see a lane
    that keeps stamping heartbeats, and a lane blocked forever in
    ``Lock.acquire()`` / ``Condition.wait()`` / ``Queue.get()`` /
    ``Thread.join()`` *between* its stamped sites is exactly the silent
    wedge the watchdog exists to kill — PR 4's collective-rendezvous
    deadlock sat behind one of these. Every blocking call in the
    long-lived lanes (``serving/``, ``scheduler/``, and the watchdog
    itself) must carry a timeout so the enclosing loop re-checks state
    and re-stamps its heartbeat.

    Precision is deliberate and syntactic (the ISSUE's wording: "no
    timeout argument"): only ZERO-argument calls of the four names are
    flagged — ``cond.wait(w)`` passes even if ``w`` can be None, and
    ``lock.acquire(True)`` passes; the rule catches the idiomatic
    unbounded form, not every reachable one."""

    id = "JGL012"
    name = "unbounded-blocking-call"
    description = (
        "zero-argument Lock.acquire()/Condition.wait()/Queue.get()/"
        "Thread.join() in serving/, scheduler/ or resilience/watchdog.py "
        "— blocks forever outside the watchdog's stamped sites; pass a "
        "timeout and loop"
    )

    def _in_scope(self, relpath: str) -> bool:
        return scopes.UNBOUNDED_JOIN.contains(relpath)

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not self._in_scope(module.relpath):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in _BLOCKING_ATTRS:
                continue
            if node.args or node.keywords:
                # Any argument form passes: a timeout bounds the block,
                # and blocking=False / block=False forms never block at
                # all — the rule targets the idiomatic ZERO-argument
                # wait-forever call only (per its docstring).
                continue
            yield self.finding(
                module,
                node,
                f".{func.attr}() with no timeout blocks forever — the "
                "heartbeat watchdog cannot see a lane wedged here; pass "
                "a timeout and re-check in a loop "
                "(resilience/watchdog.py is the liveness contract)",
            )


# ---------------------------------------------------------------- JGL013

#: chaos-injection entry points and WHICH of their arguments is a site
#: id: {method attr: ((positional index, keyword name), ...)}. The
#: indexes are post-self (call-site view). ``attempt`` counters passed
#: as non-site args (shard_should_fail's third parameter) are the
#: CONSUMER of per-attempt state, not a site — only the listed args
#: must be stable.
_CHAOS_SITE_ARGS: dict[str, tuple[tuple[int, str], ...]] = {
    "shard_should_fail": ((0, "pool"), (1, "shard")),
    "take_serve_fault": ((0, "request_id"),),
    "take_stage_fault": ((0, "method"),),
    "maybe_fail_stage": ((0, "method"),),
    "hang_delay_s": ((1, "site"),),
    "take_rotate_fault": ((1, "site"),),
    "record_daemon_kill": ((0, "name"),),
    "rotate_verify_delay_s": ((0, "site"),),
    "torn_line": ((1, "site"),),
    "truncate_npz": ((1, "site"),),
    "tamper_line": ((1, "site"),),
}

#: calls whose value differs every invocation — a site id derived from
#: one can never reproduce, so planned == observed breaks silently.
_UNSTABLE_SITE_CALLS = {
    "id",
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "uuid.uuid4", "uuid.uuid1",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}

#: names that smell like per-attempt / per-call counters. Deliberately
#: narrow — ``request_id`` / ``node_id`` style SITE names must never
#: match.
_ATTEMPTISH_NAME_RE = re.compile(
    r"^(attempt|attempts|attempt_no|n_attempts|counter|counters|"
    r"tries|n_tries|retry_count|retries|seq|seqno|seq_no|nonce)$"
    r"|_(attempt|attempts|counter|seqno|nonce)$"
)


@register
class UnstableChaosSite(Rule):
    """ISSUE 15's composability contract (the PR 14 gotcha as code, not
    prose): chaos selection is the pure hash ``(seed, scope, site)``,
    so *planned == observed* — the property every chaos test and the
    whole campaign engine (``resilience/campaign.py``) asserts — holds
    ONLY while site ids are stable across runs and retries. A site id
    derived from the wall clock, an object identity (``id(batch)``), or
    a per-attempt counter gives every invocation a fresh hash: the
    ``times`` budget never converges, a retrying client never gets
    served, and the campaign's fault accounting silently diverges from
    the plan. The injector methods' site arguments must be
    client-stable names (request ids, node names, model ids, paths)."""

    id = "JGL013"
    name = "unstable-chaos-site"
    description = (
        "chaos-injection site id derived from wall clock, object id or "
        "a per-attempt counter — selection hashes the site, so "
        "planned == observed breaks"
    )

    def _site_args(self, node: ast.Call,
                   spec: tuple[tuple[int, str], ...]) -> list[ast.expr]:
        out = []
        for pos, kw in spec:
            if len(node.args) > pos:
                out.append(node.args[pos])
            for k in node.keywords:
                if k.arg == kw:
                    out.append(k.value)
        return out

    def _unstable_part(self, module: ModuleInfo,
                       expr: ast.expr) -> str | None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                name = module.resolve(sub.func)
                if name in _UNSTABLE_SITE_CALLS:
                    return f"{name}()"
            elif isinstance(sub, ast.Name):
                if _ATTEMPTISH_NAME_RE.search(sub.id):
                    return sub.id
            elif isinstance(sub, ast.Attribute):
                if _ATTEMPTISH_NAME_RE.search(sub.attr):
                    return sub.attr
        return None

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            spec = _CHAOS_SITE_ARGS.get(func.attr)
            if spec is None:
                continue
            for arg in self._site_args(node, spec):
                culprit = self._unstable_part(module, arg)
                if culprit is not None:
                    yield self.finding(
                        module,
                        node,
                        f"chaos site id for .{func.attr}() derives from "
                        f"{culprit} — selection is a pure hash of the "
                        "site, so an unstable id breaks planned == "
                        "observed and the times-budget convergence; use "
                        "a client-stable id (request id, node name, "
                        "model id, path)",
                    )


# ---------------------------------------------------------------- JGL014

#: metric mutator method names (registry.py's Counter.inc /
#: Histogram.observe / Gauge.set) whose KEYWORD arguments are label
#: values — the per-label-key time series the registry materializes.
_METRIC_MUTATOR_ATTRS = ("inc", "observe", "set")

#: names that smell like a per-request / per-connection identifier —
#: unbounded over a daemon's lifetime, so one of these as a label value
#: mints a fresh time series per request. Terminal-word match only:
#: ``model_id`` / ``node_id`` style BOUNDED identifiers must not match.
_REQUEST_SCOPED_NAME_RE = re.compile(
    r"(^|_)(request_id|req_id|rid|trace_id|span_id|session_id|"
    r"client_id|conn_id|uuid|nonce|token|remote_addr|peer|addr)$"
)

#: the sanctioned escape hatch: a label value passed through a
#: fold/sanitize call (``registry.sanitize_label``, the daemon's
#: unknown-model fold) is bounded by construction.
_LABEL_FOLD_CALL_RE = re.compile(r"(sanitize|fold)", re.IGNORECASE)


@register
class UnboundedMetricLabelCardinality(Rule):
    """ISSUE 16's observability-budget contract: the metrics registry
    keeps one monotonic time series per distinct label key, forever —
    ``peek()`` snapshots, ``/varz``, the Prometheus exposition and the
    schema validator all walk every series. A per-request identifier
    (request id, trace id, peer address, nonce) — or any
    fresh-every-call value (``uuid4()``, ``time.time()``) — used as a
    label VALUE turns a bounded family into an unbounded one: memory
    grows with traffic, scrapes slow down linearly, and the statistical
    SLO engine's ``peek`` per tick degrades with it. Label values in
    the serving and observability tiers must come from closed sets
    (model ids, buckets, phases, typed statuses); per-request detail
    belongs in the trace, not the registry. Folding through a
    ``sanitize``/``fold`` helper (``registry.sanitize_label``, the
    dispatcher's unknown-model fold) is the sanctioned escape hatch."""

    id = "JGL014"
    name = "unbounded-metric-label-cardinality"
    description = (
        "per-request identifier or fresh-every-call value used as a "
        "metric label value in serving/ or observability/ — one time "
        "series per request; fold to a closed set (sanitize_label) or "
        "put it in the trace"
    )

    def _in_scope(self, relpath: str) -> bool:
        return scopes.LABEL_CARDINALITY.contains(relpath)

    def _culprit(self, module: ModuleInfo, expr: ast.expr) -> str | None:
        # Sanctioned-fold scan first: a sanitize/fold call ANYWHERE in
        # the value expression bounds it, whatever fed the fold.
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                name = module.resolve(sub.func) or ""
                attr = (sub.func.attr if isinstance(sub.func, ast.Attribute)
                        else name)
                if attr and _LABEL_FOLD_CALL_RE.search(attr):
                    return None
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                name = module.resolve(sub.func)
                if name in _UNSTABLE_SITE_CALLS:
                    return f"{name}()"
            elif isinstance(sub, ast.Name):
                if _REQUEST_SCOPED_NAME_RE.search(sub.id):
                    return sub.id
            elif isinstance(sub, ast.Attribute):
                if _REQUEST_SCOPED_NAME_RE.search(sub.attr):
                    return sub.attr
        return None

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not self._in_scope(module.relpath):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in _METRIC_MUTATOR_ATTRS:
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue  # **labels: the caller's names, not ours
                culprit = self._culprit(module, kw.value)
                if culprit is not None:
                    yield self.finding(
                        module,
                        node,
                        f"label {kw.arg}={culprit} on .{func.attr}() mints "
                        "one time series per request — the registry keeps "
                        "every label key forever; fold to a closed set "
                        "(registry.sanitize_label) or record it in the "
                        "trace instead",
                    )


# ---------------------------------------------------------------- JGL020

#: container-mutator method names that GROW the receiver by one entry
#: per call — the per-iteration accumulation JGL020 is about. ``pop``/
#: ``clear`` shrink; assignment rebinding is a fresh object.
_ACCUMULATOR_METHODS = ("append", "extend", "appendleft", "add")

#: module-scope constructors whose result is a growable container.
_CONTAINER_CTORS = {
    "dict", "list", "set", "collections.deque",
    "collections.defaultdict", "collections.OrderedDict",
}


def _module_container_names(module: ModuleInfo) -> set[str]:
    """Module-level names bound to a growable container at module scope
    (literal or constructor call) — the cross-call persistent state a
    per-cell accumulation leaks into."""
    names: set[str] = set()
    for node in module.tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if isinstance(value, (ast.Dict, ast.List, ast.Set)) or (
                isinstance(value, ast.Call)
                and module.resolve(value.func) in _CONTAINER_CTORS
            ):
                names.add(t.id)
    return names


@register
class UnboundedCellAccumulation(Rule):
    """ISSUE 19's streaming contract, enforced at the AST: in
    ``scenarios/`` the loop axis IS the replicate grid — a million-cell
    run iterates a million times — so appending one host object per
    iteration into state that outlives the call (a module-level
    container, or an attribute of a long-lived ``self``) grows host
    memory O(cells) and silently reintroduces the materialized-rows
    regime the streaming aggregate runner exists to retire. Per-call
    locals are fine (they die with the call and rows mode is an
    explicit opt-in); persistent accumulators must either journal an
    O(1) block record or fold into mergeable sufficient statistics
    (``aggregate.AggState``). The sanctioned escape hatch for a
    deliberately bounded accumulator is the standard suppression
    comment with a rationale."""

    id = "JGL020"
    name = "unbounded-cell-accumulation"
    description = (
        "per-iteration append/extend into a module-level container or "
        "self attribute inside a scenarios/ loop — grows O(cells) "
        "across the run; journal a block record or fold into AggState "
        "sums instead"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not scopes.SCENARIOS.contains(module.relpath):
            return
        containers = _module_container_names(module)
        seen: set[int] = set()
        for func in ast.walk(module.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # Python scoping, as in JGL001: a name bound anywhere in
            # the function shadows the like-named module container.
            local_binds = {a.arg for a in (
                func.args.args + func.args.posonlyargs
                + func.args.kwonlyargs
            )}
            global_decls: set[str] = set()
            for n in ast.walk(func):
                if isinstance(n, ast.Global):
                    global_decls.update(n.names)
                elif isinstance(n, ast.Name) and isinstance(
                    n.ctx, (ast.Store, ast.Del)
                ):
                    local_binds.add(n.id)
            local_binds -= global_decls
            for loop in ast.walk(func):
                if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                    continue
                for node in ast.walk(loop):
                    if (
                        not isinstance(node, ast.Call)
                        or id(node) in seen
                        or not isinstance(node.func, ast.Attribute)
                        or node.func.attr not in _ACCUMULATOR_METHODS
                    ):
                        continue
                    # Unwind attribute chains AND pass through calls:
                    # `_BY_COL.setdefault(k, []).append(x)` mutates the
                    # container _BY_COL holds, so the receiver's root
                    # is _BY_COL, not the setdefault result.
                    root = node.func.value
                    while isinstance(root, (ast.Attribute, ast.Call)):
                        root = (root.func if isinstance(root, ast.Call)
                                else root.value)
                    if not isinstance(root, ast.Name):
                        continue
                    if root.id == "self":
                        if not isinstance(node.func.value, ast.Attribute):
                            continue  # self.append: not attribute state
                        culprit = (
                            "self attribute "
                            f"'self.{node.func.value.attr}'"
                        )
                    elif (
                        root.id in containers
                        and root.id not in local_binds
                    ):
                        culprit = f"module-level container '{root.id}'"
                    else:
                        continue
                    seen.add(id(node))
                    yield self.finding(
                        module,
                        node,
                        f".{node.func.attr}() onto {culprit} "
                        "inside a loop accumulates one host "
                        "object per replicate — O(cells) growth across "
                        "the run; journal an O(1) block record or fold "
                        "into AggState sums (scenarios/aggregate.py), or "
                        "keep the accumulator local to the call",
                    )


# ---------------------------------------------------------------- JGL021

#: registry creator functions whose first positional argument is the
#: family name. ``gauge`` is deliberately exempt: gauges are
#: snapshot-time samples with open-ended names (per-entry-point
#: cost_analysis, per-device memory) and no "present at zero on every
#: run" contract.
_FAMILY_CREATOR_ATTRS = ("counter", "histogram", "bucket_histogram")

#: the sanctioned pre-creation site: the port's ``install_monitoring``
#: or, in the JAX package's tree, ``install_jax_monitoring``.
_PRECREATION_FUNCS = ("install_monitoring", "install_jax_monitoring")

#: ``device.py`` path -> (pre-creation function name, families).
_precreated_cache: dict[str, tuple[str, frozenset[str]]] = {}

#: An explicit ``observability/device.py`` for every module of the run
#: (:func:`set_device_py`); None reads the analyzed tree's own.
_device_py_override: str | None = None


def _device_py_path() -> str:
    """The port's own ``observability/device.py`` (beside this package)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "observability",
        "device.py",
    )


def set_device_py(path: str | None) -> None:
    """Check JGL021 against ``path`` for every module (None: each module
    against its own tree's ``observability/device.py``)."""
    global _device_py_override
    _device_py_override = path


def device_py_for(module: ModuleInfo) -> str:
    """The ``observability/device.py`` of the tree ``module`` lies in:
    the nearest one up from its file, else the port's own. The JAX
    package's rule reads only its own package's; the port's linter reads
    the analyzed tree's, so it checks the port against
    ``install_monitoring`` and the JAX tree against
    ``install_jax_monitoring``."""
    if _device_py_override is not None:
        return _device_py_override
    d = os.path.dirname(os.path.abspath(module.path))
    while True:
        cand = os.path.join(d, "observability", "device.py")
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return _device_py_path()
        d = parent


def _module_string_constants(tree: ast.Module) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` bindings — the indirection
    shardio.py uses (``BYTES_FAMILY = "artifact_transfer_bytes_total"``)
    and the only non-literal family-name form this rule resolves."""
    out: dict[str, str] = {}
    for node in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        if not (isinstance(value, ast.Constant) and isinstance(value.value, str)):
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out[t.id] = value.value
    return out


def _module_string_dicts(tree: ast.Module) -> dict[str, set[str]]:
    """Module-level dicts with literal string VALUES, by constant name —
    device.py's ``_CACHE_EVENT_COUNTERS`` event->family maps, whose
    ``.values()`` feed pre-creation loops."""
    out: dict[str, set[str]] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)):
            continue
        vals = {
            v.value
            for v in node.value.values
            if isinstance(v, ast.Constant) and isinstance(v.value, str)
        }
        for t in node.targets:
            if isinstance(t, ast.Name) and vals:
                out[t.id] = vals
    return out


def _literal_strings(expr: ast.expr) -> set[str]:
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return {
            e.value
            for e in expr.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        }
    return set()


def _module_string_tuples(tree: ast.Module) -> dict[str, set[str]]:
    """Module-level tuples/lists of literal strings, by constant name —
    the port's ``REQUIRED_COUNTERS``, which its pre-creation loop
    iterates (``for name in REQUIRED_COUNTERS + SWEEP_COUNTERS``)."""
    out: dict[str, set[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            vals = _literal_strings(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name) and vals:
                    out[t.id] = vals
    return out


def _iterated_strings(it: ast.expr, tuples: dict[str, set[str]]) -> set[str]:
    """The strings a ``for`` iterates: a literal, a module constant, or
    a concatenation of those."""
    if isinstance(it, ast.Name):
        return tuples.get(it.id, set())
    if isinstance(it, ast.BinOp) and isinstance(it.op, ast.Add):
        return _iterated_strings(it.left, tuples) | _iterated_strings(it.right, tuples)
    return _literal_strings(it)


def _read_precreation(path: str) -> tuple[str, frozenset[str]]:
    if path in _precreated_cache:
        return _precreated_cache[path]
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError, ValueError):
        _precreated_cache[path] = (_PRECREATION_FUNCS[0], frozenset())
        return _precreated_cache[path]
    dicts = _module_string_dicts(tree)
    tuples = _module_string_tuples(tree)
    names: set[str] = set()
    func = _PRECREATION_FUNCS[0]
    for node in tree.body:
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name in _PRECREATION_FUNCS
        ):
            continue
        func = node.name
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = sub.func
                attr = (
                    fn.attr
                    if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None
                )
                if attr in _FAMILY_CREATOR_ATTRS and sub.args:
                    arg = sub.args[0]
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                        names.add(arg.value)
            elif isinstance(sub, (ast.For, ast.AsyncFor)):
                names |= _iterated_strings(sub.iter, tuples)
                it = sub.iter
                if (
                    isinstance(it, ast.Call)
                    and isinstance(it.func, ast.Attribute)
                    and it.func.attr == "values"
                    and isinstance(it.func.value, ast.Name)
                ):
                    names |= dicts.get(it.func.value.id, set())
    _precreated_cache[path] = (func, frozenset(names))
    return _precreated_cache[path]


def precreated_families(path: str | None = None) -> frozenset[str]:
    """The family names the pre-creation function of ``device.py`` at
    ``path`` (default: the override, else the port's own) pre-creates,
    read by AST: literal first args of creator calls, plus the strings
    any ``for``-loop in the function iterates — a literal tuple/list, a
    module-level tuple constant or a sum of them, or ``CONST.values()``
    of a module-level string-valued dict. Cached a path; an unreadable or
    unparsable device.py yields the empty set (the rule then stays
    silent rather than failing the whole lint on a broken neighbor —
    the parse error surfaces on device.py itself)."""
    if path is None:
        path = _device_py_override or _device_py_path()
    return _read_precreation(path)[1]


def _family_creator_kind(module: ModuleInfo, node: ast.Call) -> str | None:
    """``'counter'`` / ``'histogram'`` / ``'bucket_histogram'`` when
    this call mints (or fetches) a registry family, else None. Matched
    on the resolved dotted name so every spelling in the tree counts:
    ``obs.counter``, ``_registry.counter``, bare ``counter`` imported
    from the registry, ``REGISTRY.bucket_histogram``. ``self.``-rooted
    chains are skipped — an injected registry double is the test's
    business, not the shipped contract's."""
    name = module.resolve(node.func)
    if name is None:
        return None
    parts = name.split(".")
    if parts[-1] not in _FAMILY_CREATOR_ATTRS or parts[0] == "self":
        return None
    if "observability" in parts or "registry" in parts or "REGISTRY" in parts:
        return parts[-1]
    return None


@register
class MetricFamilyNotPrecreated(Rule):
    """The JAX package's JGL021, against the analyzed tree's pre-creation
    list: ``install_monitoring`` (the JAX package's
    ``install_jax_monitoring``) pre-creates every counter/histogram
    family at zero so "it never happened" is a recorded 0 in
    metrics.json, not a missing key — ``scripts/check_metrics_schema.py``
    and every downstream consumer key on that. A family first created at
    its emit site exists only on runs that take that code path: the
    export schema then depends on traffic, and a zero regresses to an
    absence. The fix is one pre-creation line in device.py (with an
    identical bucket ladder for bucket histograms — the registry rejects
    a mismatched re-creation). Dynamic family names can't be
    cross-checked statically and are skipped."""

    id = "JGL021"
    name = "metric-family-not-precreated"
    description = (
        "counter/histogram family created outside "
        "install_jax_monitoring and missing from its pre-creation "
        "list — the family exists only on runs that take this code "
        "path, so the metrics.json schema depends on traffic; add the "
        "pre-creation line in observability/device.py"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if scopes.METRIC_FAMILY_ORIGIN.contains(module.relpath):
            return
        func, precreated = _read_precreation(device_py_for(module))
        if not precreated:
            return  # device.py unreadable here: nothing to check against
        consts = _module_string_constants(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _family_creator_kind(module, node)
            if kind is None or not node.args:
                continue
            arg = node.args[0]
            family: str | None = None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                family = arg.value
            elif isinstance(arg, ast.Name):
                family = consts.get(arg.id)
            if family is None or family in precreated:
                continue
            yield self.finding(
                module,
                node,
                f"metric family '{family}' ({kind}) is not pre-created "
                f"in {func} — it will be missing from "
                "metrics.json on any run that never reaches this line; "
                "add the pre-creation in observability/device.py (same "
                "bucket ladder for bucket histograms)",
            )
