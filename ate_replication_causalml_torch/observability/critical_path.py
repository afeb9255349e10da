"""Critical-path / overlap analysis of an exported sweep trace.

Port of ``ate_replication_causalml_tpu/observability/critical_path.py``,
the same pure functions (equal outputs on equal inputs).

Input is the catapult ``trace.json`` written by
:mod:`observability.trace` — specifically its ``cat="node"`` slices
(the scheduler's per-node execution intervals, carrying ``kind``,
``lane``, ``needs`` and ``stage_idx`` attribution) plus the ``commit``
and ``prefetch`` slices. From those, this module answers what a sweep's
wall-clock record cannot:

* **critical path** — the longest chain of node intervals through the
  union of the declared dependency edges (artifact → consuming stage,
  from each slice's ``needs``) and the per-track execution order (a
  node's implicit predecessor is whatever its worker ran before it).
  Computed as a longest-path DP over that DAG, so the result is a pure
  function of the trace: a sequential run's path is the full execution
  sequence in declared order, and any run's path duration is ≥ its
  longest single node (a one-node chain is always a candidate).
* **per-lane busy/wait** — for every worker track and exclusive lane:
  busy seconds (Σ node durations), wait seconds (wall − busy), nodes.
* **overlap efficiency** — Σ worker busy / (wall × workers): 1.0 means
  every worker computed for the whole run, 1/workers means the run was
  effectively sequential.
* **serialization blame** — mesh-lane occupancy (time the exclusive
  lane was held, the ceiling on collective overlap), committer busy
  time (ordered-commit stall budget), and prefetch outcomes.

Pure stdlib: it reads any saved ``trace.json`` without a device.
"""

from __future__ import annotations

import dataclasses

#: overlap_report.json layout version.
OVERLAP_SCHEMA_VERSION = 1

#: slack for "predecessor ended before this node started": commit and
#: scheduling bookkeeping can put a dependent's span start a hair
#: before its dependency's recorded end on coarse clocks.
_EPS_S = 1e-3


@dataclasses.dataclass(frozen=True)
class NodeInterval:
    """One scheduler-node execution slice parsed back from the trace."""

    name: str
    kind: str              # "artifact" | "stage"
    lane: str              # "" when unlaned
    track: str             # worker-track name the slice rendered on
    start_s: float
    dur_s: float
    needs: tuple[str, ...]
    stage_idx: int

    @property
    def end_s(self) -> float:
        return self.start_s + self.dur_s


def _track_names(trace: dict) -> dict[int, str]:
    out: dict[int, str] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            out[ev["tid"]] = str(ev.get("args", {}).get("name", ev["tid"]))
    return out


def _slices(trace: dict, cat: str) -> list[dict]:
    return [
        ev for ev in trace.get("traceEvents", ())
        if ev.get("ph") == "X" and ev.get("cat") == cat
    ]


def nodes_from_trace(trace: dict) -> list[NodeInterval]:
    """The scheduler-node intervals, sorted by (start, name). Lane
    duplicates (``cat="lane"``) are deliberately excluded — counting
    them too would double every laned node's busy time."""
    names = _track_names(trace)
    nodes = []
    for ev in _slices(trace, "node"):
        args = ev.get("args", {})
        needs = tuple(
            n for n in str(args.get("needs", "")).split(",") if n
        )
        nodes.append(NodeInterval(
            name=str(args.get("node", ev.get("name", "?"))),
            kind=str(args.get("kind", "stage")),
            lane=str(args.get("lane", "") or ""),
            track=names.get(ev["tid"], str(ev["tid"])),
            start_s=ev["ts"] / 1e6,
            dur_s=ev["dur"] / 1e6,
            needs=needs,
            stage_idx=int(args.get("stage_idx", -1)),
        ))
    nodes.sort(key=lambda n: (n.start_s, n.name))
    return nodes


def critical_path(nodes: list[NodeInterval]) -> tuple[list[dict], float]:
    """Longest chain through dependency + same-track-order edges.

    Returns ``(path, total_seconds)`` where ``path`` lists the chain's
    nodes start-to-finish, each with its execution seconds and the wait
    gap behind its chosen predecessor. Duplicate node names (a refit)
    resolve to the earliest interval — the engine schedules each node
    once, so duplicates only appear in hand-built traces.
    """
    if not nodes:
        return [], 0.0
    by_name: dict[str, NodeInterval] = {}
    for n in nodes:
        by_name.setdefault(n.name, n)
    prev_on_track: dict[NodeInterval, NodeInterval] = {}
    last: dict[str, NodeInterval] = {}
    for n in nodes:  # already start-sorted
        if n.track in last:
            prev_on_track[n] = last[n.track]
        last[n.track] = n

    cp: dict[NodeInterval, float] = {}
    choice: dict[NodeInterval, NodeInterval | None] = {}
    for n in nodes:
        best, best_cp = None, 0.0
        cands = [by_name.get(d) for d in n.needs]
        cands.append(prev_on_track.get(n))
        for c in cands:
            if c is None or c is n or c not in cp:
                continue
            if c.end_s > n.start_s + _EPS_S:
                continue  # not actually a predecessor in this timeline
            # Deterministic tie-break: earlier-declared, then name.
            if best is None or cp[c] > best_cp or (
                cp[c] == best_cp
                and (c.stage_idx, c.name) < (best.stage_idx, best.name)
            ):
                best, best_cp = c, cp[c]
        cp[n] = n.dur_s + best_cp
        choice[n] = best

    tail = max(nodes, key=lambda n: (cp[n], -n.stage_idx, n.name))
    chain: list[NodeInterval] = []
    cur: NodeInterval | None = tail
    while cur is not None and len(chain) <= len(nodes):
        chain.append(cur)
        cur = choice[cur]
    chain.reverse()
    path = []
    for i, n in enumerate(chain):
        wait = 0.0 if i == 0 else max(0.0, n.start_s - chain[i - 1].end_s)
        path.append({
            "name": n.name, "kind": n.kind, "lane": n.lane,
            "track": n.track, "start_s": round(n.start_s, 6),
            "dur_s": round(n.dur_s, 6), "wait_s": round(wait, 6),
        })
    return path, cp[tail]


def track_stats(nodes: list[NodeInterval], wall_s: float) -> dict:
    out: dict[str, dict] = {}
    for n in nodes:
        t = out.setdefault(n.track, {"busy_s": 0.0, "nodes": 0})
        t["busy_s"] += n.dur_s
        t["nodes"] += 1
    for t in out.values():
        t["busy_s"] = round(t["busy_s"], 6)
        t["wait_s"] = round(max(0.0, wall_s - t["busy_s"]), 6)
        t["utilization"] = round(t["busy_s"] / wall_s, 4) if wall_s > 0 else 0.0
    return out


def _run_wall(trace: dict, nodes: list[NodeInterval]) -> float:
    other = trace.get("otherData", {})
    wall = other.get("wall_s")
    if isinstance(wall, (int, float)) and wall > 0:
        return float(wall)
    for ev in _slices(trace, "span"):
        if ev.get("name") == "run_sweep":
            return ev["dur"] / 1e6
    if nodes:
        return max(n.end_s for n in nodes) - min(n.start_s for n in nodes)
    return 0.0


def overlap_report(trace: dict) -> dict:
    """The ``overlap_report.json`` payload for one exported trace."""
    nodes = nodes_from_trace(trace)
    wall_s = _run_wall(trace, nodes)
    other = trace.get("otherData", {})
    workers = other.get("workers")
    if not isinstance(workers, int) or workers < 1:
        workers = max(1, len({n.track for n in nodes}))
    path, cp_s = critical_path(nodes)
    tracks = track_stats(nodes, wall_s)
    busy_total = sum(t["busy_s"] for t in tracks.values())
    denom = wall_s * workers
    lanes: dict[str, dict] = {}
    for n in nodes:
        if not n.lane:
            continue
        lane = lanes.setdefault(n.lane, {"busy_s": 0.0, "nodes": 0})
        lane["busy_s"] += n.dur_s
        lane["nodes"] += 1
    for lane in lanes.values():
        lane["busy_s"] = round(lane["busy_s"], 6)
        lane["occupancy"] = (
            round(lane["busy_s"] / wall_s, 4) if wall_s > 0 else 0.0
        )
    commits = _slices(trace, "commit")
    prefetch = _slices(trace, "prefetch")
    pf_status: dict[str, int] = {}
    for ev in prefetch:
        # Span status "ok" means the warm hook compiled; anything else
        # (the error path re-raises out of the span) keeps its label.
        st = str(ev.get("args", {}).get("status", "ok"))
        st = "compiled" if st == "ok" else st
        pf_status[st] = pf_status.get(st, 0) + 1
    longest = max((n.dur_s for n in nodes), default=0.0)
    return {
        "schema_version": OVERLAP_SCHEMA_VERSION,
        "wall_s": round(wall_s, 6),
        "workers": workers,
        "nodes": len(nodes),
        "tracks": tracks,
        "busy_total_s": round(busy_total, 6),
        "overlap_efficiency": round(busy_total / denom, 4) if denom > 0 else 0.0,
        "critical_path": path,
        "critical_path_s": round(cp_s, 6),
        "critical_path_share": round(cp_s / wall_s, 4) if wall_s > 0 else 0.0,
        "longest_node_s": round(longest, 6),
        "serialization": {
            "lanes": lanes,
            "committer": {
                "busy_s": round(sum(ev["dur"] for ev in commits) / 1e6, 6),
                "commits": len(commits),
            },
            "prefetch": pf_status,
        },
    }
