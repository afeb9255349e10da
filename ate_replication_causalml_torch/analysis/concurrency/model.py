"""The port's concurrency-model builder (a copy of the JAX package's
``concurrency/model.py``, same schema and ``MODEL_SCHEMA_VERSION``): the
committed ``ate_replication_causalml_torch/analysis/concurrency_model.json``.

The model is a deterministic projection of :class:`~.flow.Analysis`:
the lock registry, the acquisition-order DAG, the thread entrypoints,
and each resolved entrypoint's transitive lock-set. It is committed
beside this package and the port's gate regenerates it and
byte-compares (``scripts/torch_graftrace.py --check``), so any concurrency-shape change —
a new lock, a new thread, a changed acquisition order — shows up as a
reviewable diff instead of an invisible drift.

Determinism contract: everything is sorted, sites are capped, and the
serializer pins ``sort_keys``/``indent`` — byte-identical across runs
on the same tree (asserted in tier-1 tests).
"""

from __future__ import annotations

import json

from ate_replication_causalml_torch.analysis.core import Program
from ate_replication_causalml_torch.analysis.concurrency.flow import analyze

#: Bump when the model layout changes (validated by
#: ``scripts/check_concurrency_model.py``).
MODEL_SCHEMA_VERSION = 1

#: Entry kinds that are structural (spawn sites / handler classes) and
#: therefore stable enough to commit. ``public-api`` entries are an
#: analysis-side over-approximation and stay out of the artifact.
_COMMITTED_ENTRY_KINDS = ("http-handler", "pool", "thread")


def build_model(program: Program) -> dict:
    an = analyze(program)
    locks = [
        {"id": ld.id, "kind": ld.kind, "file": ld.file, "line": ld.line}
        for ld in sorted(an.locks.values(), key=lambda l: l.id)
    ]
    order = [
        {
            "from": a,
            "to": b,
            "sites": sorted(set(sites))[:3],
        }
        for (a, b), sites in sorted(an.order_edges.items())
    ]
    entries = []
    locksets = {}
    for e in sorted(an.entries, key=lambda e: e.id):
        if e.kind not in _COMMITTED_ENTRY_KINDS:
            continue
        entries.append(
            {
                "id": e.id,
                "kind": e.kind,
                "file": e.file,
                "line": e.line,
                "target": e.target,
            }
        )
        if e.key is not None:
            locksets[e.id] = sorted(an.trans_acquires.get(e.key, ()))
    return {
        "schema_version": MODEL_SCHEMA_VERSION,
        "locks": locks,
        "lock_order": order,
        "thread_entries": entries,
        "entry_locksets": locksets,
    }


def to_json(model: dict) -> str:
    """The one serialization the byte-identity contract is defined on."""
    return json.dumps(model, indent=2, sort_keys=True) + "\n"


def render_markdown(model: dict) -> str:
    """The generated section of the model's markdown (between the
    markers): ``concurrency_model.md`` beside the port's model, and the
    JAX package's ``CONCURRENCY.md``, from the same function."""
    lines = ["## Concurrency model (generated)", ""]
    lines.append(f"Locks: **{len(model['locks'])}** · "
                 f"order edges: **{len(model['lock_order'])}** · "
                 f"thread entrypoints: **{len(model['thread_entries'])}**")
    lines.append("")
    lines.append("### Lock registry")
    lines.append("")
    lines.append("| Lock | Kind | Defined at |")
    lines.append("| --- | --- | --- |")
    for l in model["locks"]:
        lines.append(f"| `{l['id']}` | {l['kind']} | `{l['file']}:{l['line']}` |")
    lines.append("")
    lines.append("### Thread entrypoints")
    lines.append("")
    lines.append("| Entry | Kind | Spawned at | Transitive lock-set |")
    lines.append("| --- | --- | --- | --- |")
    for e in model["thread_entries"]:
        locks = model["entry_locksets"].get(e["id"])
        shown = (
            "<br>".join(f"`{l}`" for l in locks) if locks
            else ("—" if locks is not None else "(unresolved)")
        )
        lines.append(
            f"| `{e['target']}` | {e['kind']} | "
            f"`{e['file']}:{e['line']}` | {shown} |"
        )
    lines.append("")
    lines.append("### Acquisition order")
    lines.append("")
    lines.append("Edges read \"left is held while right is acquired\"; the "
                 "gate fails on any cycle (JGL015).")
    lines.append("")
    lines.append("| Held | Then acquired | Witness |")
    lines.append("| --- | --- | --- |")
    for edge in model["lock_order"]:
        lines.append(
            f"| `{edge['from']}` | `{edge['to']}` | `{edge['sites'][0]}` |"
        )
    lines.append("")
    return "\n".join(lines)
