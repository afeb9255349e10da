"""Merged fleet observability artifacts.

Port of ``ate_replication_causalml_tpu/observability/fleet_report.py``:
the same pure functions of a ``RouterServer.dump_fleet`` output
directory, so the router's live dump and the offline entry point
(``python -m ate_replication_causalml_torch.observability.fleet_report
<dump> [--check]``) both end in :func:`write_fleet_artifacts` and agree
byte for byte, with each other and with the JAX package's. Three
artifacts land beside ``fleet_manifest.json``:

* ``fleet_trace.json``: the router's ``router/trace.json`` and each
  dumped daemon's ``daemon-<name>/trace.json`` re-based onto one
  wall-clock axis through each trace's ``otherData.wall_anchor_unix``,
  one pid a process, and ``fleet_req`` flow arrows from each
  ``router_request`` span to the daemon ``serving_request`` span that
  served the same request id;
* ``fleet_report.json``: the request reconciliation: matched
  router/daemon span pairs, orphans on either side, the per-backend
  residual gap (router ``wait_s`` minus the daemon's end to end: the
  wire and framing between the tiers), and the router manifest's ok
  counts against each daemon's own ``serving_requests_total``;
* ``fleet_stat_health.json``: every daemon's statistical-health total
  sketches folded per model and channel into fleet distributions, and
  fleet ``stat_drift:*`` / ``stat_calibration:*`` figures from the
  sealed-window statuses.

Counter totals reconcile with ``<=``: the registry is process-global, so
an in-process fleet shows combined counters in every daemon's
``metrics.json``; a router can never have more acknowledged forwards
than its daemons served. Stdlib and numpy only: no torch, like
everything the router imports.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ate_replication_causalml_torch.observability.registry import parse_label_key
from ate_replication_causalml_torch.observability.serving_report import index_quantile
from ate_replication_causalml_torch.observability.sketch import CalibrationSketch, FixedBinSketch

__all__ = [
    "FLEET_REPORT_BASENAME", "FLEET_REPORT_SCHEMA_VERSION", "FLEET_STAT_HEALTH_BASENAME",
    "FLEET_TRACE_BASENAME", "build_fleet_report", "build_fleet_stat_health",
    "build_fleet_trace", "load_fleet_dump", "main", "write_fleet_artifacts",
]

FLEET_TRACE_BASENAME = "fleet_trace.json"
FLEET_REPORT_BASENAME = "fleet_report.json"
FLEET_STAT_HEALTH_BASENAME = "fleet_stat_health.json"
FLEET_REPORT_SCHEMA_VERSION = 1

#: How many orphan request ids each orphan section lists (the counts are
#: always exact).
MAX_ORPHAN_IDS = 20


def _read_json(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def load_fleet_dump(outdir: str) -> dict:
    """Everything the merged artifacts derive from. Raises ``ValueError``
    when ``fleet_manifest.json`` is missing or unreadable; every other
    input is optional (a daemon that never dumped) and simply absent."""
    manifest = _read_json(os.path.join(outdir, "fleet_manifest.json"))
    if not isinstance(manifest, dict):
        raise ValueError(f"{outdir}: no readable fleet_manifest.json — not a fleet dump")
    router_dir = str(manifest.get("router_dir") or "router")
    router_trace = _read_json(os.path.join(outdir, router_dir, "trace.json"))
    daemons: dict[str, dict] = {}
    backends = manifest.get("backends")
    backends = backends if isinstance(backends, dict) else {}
    for name in sorted(backends):
        entry = backends[name]
        if not (isinstance(entry, dict) and entry.get("dumped") and entry.get("dir")):
            continue
        ddir = os.path.join(outdir, str(entry["dir"]))
        daemons[name] = {
            "trace": _read_json(os.path.join(ddir, "trace.json")),
            "metrics": _read_json(os.path.join(ddir, "metrics.json")),
            "stat_health": _read_json(os.path.join(ddir, "stat_health.json")),
        }
    return {"manifest": manifest, "router_trace": router_trace, "daemons": daemons}


# ── fleet_trace.json: one wall-clock axis, flow-stitched ────────────────


def _anchor(trace: dict | None) -> float | None:
    if not isinstance(trace, dict):
        return None
    a = (trace.get("otherData") or {}).get("wall_anchor_unix")
    return float(a) if isinstance(a, (int, float)) else None


def _spans(trace: dict | None, name: str) -> list[dict]:
    """Complete (ph X) spans named ``name`` carrying a request id."""
    if not isinstance(trace, dict):
        return []
    return [ev for ev in trace.get("traceEvents") or []
            if isinstance(ev, dict) and ev.get("ph") == "X" and ev.get("name") == name
            and (ev.get("args") or {}).get("request_id")]


def build_fleet_trace(dump: dict) -> dict:
    """The per-process traces on one wall-clock axis: each keeps its own
    ``ts`` values shifted by ``(wall_anchor_unix − min anchor) · 1e6``.
    Pids are reassigned (router first, then the daemons sorted) and each
    ``process_name`` reads ``router`` / ``daemon-<name>``."""
    procs: list[tuple[str, dict]] = []
    if isinstance(dump.get("router_trace"), dict):
        procs.append(("router", dump["router_trace"]))
    for name in sorted(dump.get("daemons") or {}):
        trace = dump["daemons"][name].get("trace")
        if isinstance(trace, dict):
            procs.append((f"daemon-{name}", trace))
    anchors = {pname: _anchor(trace) for pname, trace in procs}
    known = [a for a in anchors.values() if a is not None]
    origin = min(known) if known else 0.0

    def shift_of(anchor: float | None) -> float:
        return 0.0 if anchor is None else (anchor - origin) * 1e6

    events: list[dict] = []
    processes: dict[str, dict] = {}
    pid_of: dict[str, int] = {}
    for pid, (pname, trace) in enumerate(procs, start=1):
        pid_of[pname] = pid
        shift_us = shift_of(anchors[pname])
        saw_process_name = False
        for ev in trace.get("traceEvents") or []:
            if not isinstance(ev, dict):
                continue
            ev2 = dict(ev)
            ev2["pid"] = pid
            if isinstance(ev2.get("ts"), (int, float)):
                ev2["ts"] = round(float(ev2["ts"]) + shift_us, 3)
            if ev2.get("ph") == "M" and ev2.get("name") == "process_name":
                ev2["args"] = {"name": pname}
                saw_process_name = True
            events.append(ev2)
        if not saw_process_name:
            events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                           "args": {"name": pname}})
        processes[pname] = {
            "pid": pid,
            "wall_anchor_unix": anchors[pname],
            "events": sum(1 for e in trace.get("traceEvents") or [] if isinstance(e, dict)),
        }

    # Flow arrows router_request → serving_request on request id: one
    # s/f pair a router × daemon match, each under its own flow id, so an
    # id a failover took to two daemons stays unambiguous.
    router_trace = dump.get("router_trace")
    router_shift = shift_of(_anchor(router_trace))
    daemon_spans: dict[str, list[tuple[str, dict, float]]] = {}
    for pname, trace in procs:
        if pname == "router":
            continue
        for ev in _spans(trace, "serving_request"):
            rid = str(ev["args"]["request_id"])
            daemon_spans.setdefault(rid, []).append((pname, ev, shift_of(anchors[pname])))
    for ev in _spans(router_trace, "router_request"):
        rid = str(ev["args"]["request_id"])
        for k, (pname, dev, shift_us) in enumerate(daemon_spans.get(rid, ())):
            flow_id = f"fleet:{rid}" if k == 0 else f"fleet:{rid}/{k}"
            events.append({"ph": "s", "cat": "fleet_req", "id": flow_id,
                           "name": "fleet_request", "pid": pid_of["router"],
                           "tid": ev.get("tid", 0),
                           "ts": round(float(ev.get("ts", 0.0)) + router_shift, 3)})
            events.append({"ph": "f", "bp": "e", "cat": "fleet_req", "id": flow_id,
                           "name": "fleet_request", "pid": pid_of[pname],
                           "tid": dev.get("tid", 0),
                           "ts": round(float(dev.get("ts", 0.0)) + shift_us, 3)})

    return {
        "traceEvents": events,
        "otherData": {
            "trace_schema_version": 1,
            "kind": "fleet_trace",
            "clock": "wall-rebased",
            "time_unit": "us",
            "wall_anchor_unix": origin if known else None,
            "processes": processes,
        },
    }


# ── fleet_report.json: request reconciliation ───────────────────────────


def _round9(v: float) -> float:
    return round(float(v), 9)


def _round9_or_none(v):
    return None if v is None else round(float(v), 9)


def _gap_stats(vals: list[float]) -> dict:
    s = sorted(vals)
    return {"count": len(s), "min_s": _round9(s[0]),
            "p50_s": _round9(index_quantile(s, 0.50)),
            "p99_s": _round9(index_quantile(s, 0.99)), "max_s": _round9(s[-1])}


def _daemon_ok_count(metrics: dict | None) -> int | None:
    """``serving_requests_total{status=ok}`` summed over every other
    label."""
    if not isinstance(metrics, dict):
        return None
    fam = (metrics.get("counters") or {}).get("serving_requests_total")
    if not isinstance(fam, dict):
        return 0
    return sum(int(v) for key, v in fam.items()
               if parse_label_key(str(key)).get("status") == "ok")


def build_fleet_report(dump: dict) -> dict:
    """Cross-process request reconciliation, pure from the dump."""
    manifest = dump["manifest"]
    daemons = dump.get("daemons") or {}
    router_spans = _spans(dump.get("router_trace"), "router_request")

    daemon_span_ids: dict[str, set[str]] = {}
    daemon_spans_by_rid: dict[str, list[tuple[str, dict]]] = {}
    for name in sorted(daemons):
        ids = set()
        for ev in _spans(daemons[name].get("trace"), "serving_request"):
            rid = str(ev["args"]["request_id"])
            ids.add(rid)
            daemon_spans_by_rid.setdefault(rid, []).append((name, ev))
        daemon_span_ids[name] = ids

    matched = 0
    routed_to_undumped = 0
    orphan_router: list[str] = []
    matched_router_rids: set[str] = set()
    gaps: dict[str, list[float]] = {}
    for ev in router_spans:
        args = ev.get("args") or {}
        backend = str(args.get("backend", "-"))
        rid = str(args.get("request_id"))
        if backend == "-" or str(args.get("outcome")) not in ("ok", "reject", "error"):
            continue  # never reached a daemon: nothing to match
        if backend not in daemon_span_ids:
            routed_to_undumped += 1
            continue
        if rid in daemon_span_ids[backend]:
            matched += 1
            matched_router_rids.add(rid)
            wait_s = args.get("wait_s")
            dev = next(e for n, e in daemon_spans_by_rid[rid] if n == backend)
            if isinstance(wait_s, (int, float)):
                gaps.setdefault(backend, []).append(
                    float(wait_s) - float(dev.get("dur", 0.0)) / 1e6)
        else:
            orphan_router.append(rid)
    router_rids = {str((e.get("args") or {}).get("request_id")) for e in router_spans}
    orphan_daemon = sorted(rid for rid in daemon_spans_by_rid
                           if rid not in matched_router_rids and rid not in router_rids)

    # Counter reconciliation, with <= (module docstring).
    router_req = (manifest.get("router") or {}).get("requests") or {}
    router_ok = {b: int((router_req.get(b) or {}).get("ok", 0)) for b in sorted(daemons)}
    daemon_ok = {b: _daemon_ok_count(daemons[b].get("metrics")) for b in sorted(daemons)}
    router_ok_total = sum(router_ok.values())
    daemon_ok_known = [v for v in daemon_ok.values() if v is not None]
    daemon_ok_total = sum(daemon_ok_known) if daemon_ok_known else None
    trace_router_ok: dict[str, int] = {}
    for ev in router_spans:
        args = ev.get("args") or {}
        if str(args.get("outcome")) == "ok":
            b = str(args.get("backend", "-"))
            trace_router_ok[b] = trace_router_ok.get(b, 0) + 1
    manifest_ok_all = {b: int((router_req.get(b) or {}).get("ok", 0)) for b in router_req}
    # The trace is born-filtered per router; the counters are cumulative.
    trace_consistent = all(n <= manifest_ok_all.get(b, 0) for b, n in trace_router_ok.items())
    consistent = (daemon_ok_total is None or router_ok_total <= daemon_ok_total) \
        and trace_consistent

    return {
        "schema_version": FLEET_REPORT_SCHEMA_VERSION,
        "kind": "fleet_report",
        "processes": {
            "router": {"present": dump.get("router_trace") is not None,
                       "wall_anchor_unix": _anchor(dump.get("router_trace")),
                       "spans": len(router_spans)},
            "daemons": {name: {"wall_anchor_unix": _anchor(daemons[name].get("trace")),
                               "spans": len(daemon_span_ids[name])}
                        for name in sorted(daemons)},
        },
        "requests": {
            "router_spans": len(router_spans),
            "daemon_spans": sum(len(v) for v in daemon_span_ids.values()),
            "matched": matched,
            "routed_to_undumped": routed_to_undumped,
            "orphan_router": len(orphan_router),
            "orphan_router_ids": sorted(orphan_router)[:MAX_ORPHAN_IDS],
            "orphan_daemon": len(orphan_daemon),
            "orphan_daemon_ids": orphan_daemon[:MAX_ORPHAN_IDS],
        },
        "residual_gap": {b: _gap_stats(vals) for b, vals in sorted(gaps.items())},
        "reconciliation": {
            "router_ok": router_ok,
            "daemon_ok": daemon_ok,
            "router_ok_total": router_ok_total,
            "daemon_ok_total": daemon_ok_total,
            "trace_router_ok": {b: trace_router_ok[b] for b in sorted(trace_router_ok)},
            "consistent": bool(consistent),
        },
    }


# ── fleet_stat_health.json: folded sketches and fleet drift figures ─────


def _merge_sketches(dicts: list[dict], cls):
    merged = None
    for d in dicts:
        sk = cls.from_dict(d)
        merged = sk if merged is None else merged.merge(sk)
    return merged


def _fold_statuses(states: list[dict], model: str, channel: str) -> dict:
    """Sealed-window statuses of one model and channel summed over the
    daemons: the fleet figures' numerators and denominators."""
    counts = {"ok": 0, "drift": 0, "sparse": 0, "miscal": 0}
    for st in states:
        ms = (st.get("models") or {}).get(model) or {}
        if channel == "calibration":
            series = (ms.get("calibration") or {}).get("series") or []
        else:
            series = ((ms.get("channels") or {}).get(channel) or {}).get("series") or []
        for e in series:
            s = str(e.get("status"))
            if s in counts:
                counts[s] += 1
    return counts


def _slo_figure(good: int, total: int, objective: float) -> dict:
    return {"objective": objective, "good": good, "total": total,
            "ratio": None if total == 0 else _round9(good / total),
            "burning": bool(total and good / total < objective)}


def build_fleet_stat_health(dump: dict, objective: float = 0.9) -> dict:
    """Every dumped daemon's stat-health state folded into fleet
    distributions (exact integer merges) and fleet ``stat_drift:*`` /
    ``stat_calibration:*`` figures; ``objective`` is
    ``slo.stat_health_slos``'s default."""
    daemons = dump.get("daemons") or {}
    states: dict[str, dict] = {}
    for name in sorted(daemons):
        rep = daemons[name].get("stat_health")
        if isinstance(rep, dict) and isinstance(rep.get("state"), dict):
            states[name] = rep["state"]
    models_all = sorted({m for st in states.values() for m in (st.get("models") or {})})

    models_out: dict[str, dict] = {}
    slo_out: dict[str, dict] = {}
    for m in models_all:
        per_model = [st for st in states.values() if m in (st.get("models") or {})]
        chans: dict[str, dict] = {}
        channel_names = sorted({ch for st in per_model
                                for ch in (st["models"][m].get("channels") or {})})
        for ch in channel_names:
            totals = [st["models"][m]["channels"][ch]["total"] for st in per_model
                      if ch in (st["models"][m].get("channels") or {})]
            try:
                merged = _merge_sketches(totals, FixedBinSketch)
            except ValueError:
                chans[ch] = {"error": "incompatible_sketches"}
                continue
            folded = _fold_statuses(per_model, m, ch)
            chans[ch] = {
                "count": merged.total() if merged else 0,
                "underflow": merged.underflow if merged else 0,
                "overflow": merged.overflow if merged else 0,
                "nan": merged.nan if merged else 0,
                "p50": None if merged is None else _round9_or_none(merged.quantile(0.5)),
                "p90": None if merged is None else _round9_or_none(merged.quantile(0.9)),
                "windows_ok": folded["ok"],
                "windows_drift": folded["drift"],
                "windows_sparse": folded["sparse"],
            }
        cal_totals = [st["models"][m]["calibration"]["total"] for st in per_model
                      if isinstance(st["models"][m].get("calibration"), dict)]
        try:
            cal_merged = _merge_sketches(cal_totals, CalibrationSketch)
        except ValueError:
            cal_merged = None
        cal_folded = _fold_statuses(per_model, m, "calibration")
        cal = {
            "enabled": any(bool((st["models"][m].get("calibration") or {}).get("enabled"))
                           for st in per_model),
            "count": cal_merged.total() if cal_merged else 0,
            "error": (None if cal_merged is None
                      else _round9_or_none(cal_merged.calibration_error())),
            "windows_ok": cal_folded["ok"],
            "windows_miscal": cal_folded["miscal"],
            "windows_sparse": cal_folded["sparse"],
        }
        models_out[m] = {"rows": sum(int(st["models"][m].get("rows", 0)) for st in per_model),
                         "channels": chans, "calibration": cal}
        # Sparse windows count toward neither side (stat_health_slos).
        drift_good = sum(chans[ch].get("windows_ok", 0) for ch in chans)
        drift_total = drift_good + sum(chans[ch].get("windows_drift", 0) for ch in chans)
        slo_out[f"stat_drift:{m}"] = _slo_figure(drift_good, drift_total, objective)
        slo_out[f"stat_calibration:{m}"] = _slo_figure(
            cal["windows_ok"], cal["windows_ok"] + cal["windows_miscal"], objective)

    return {
        "schema_version": FLEET_REPORT_SCHEMA_VERSION,
        "kind": "fleet_stat_health",
        "daemons": sorted(states),
        "models": models_out,
        "slo": slo_out,
    }


# ── the one write recipe (live dump == offline recomputation) ───────────


def write_fleet_artifacts(outdir: str) -> list[str]:
    """Build and atomically write the merged triple from the on-disk dump;
    returns the paths written. The router's live ``dump_fleet`` and the
    offline entry point both end here, so recomputing over a dump
    reproduces its artifacts byte for byte."""
    from ate_replication_causalml_torch.observability.export import (
        atomic_write_json,
        atomic_write_text,
    )

    dump = load_fleet_dump(outdir)
    tpath = os.path.join(outdir, FLEET_TRACE_BASENAME)
    # Compact, like the per-process traces: machines read it.
    atomic_write_text(tpath, json.dumps(build_fleet_trace(dump), separators=(",", ":")) + "\n")
    rpath = os.path.join(outdir, FLEET_REPORT_BASENAME)
    atomic_write_json(rpath, build_fleet_report(dump))
    spath = os.path.join(outdir, FLEET_STAT_HEALTH_BASENAME)
    atomic_write_json(spath, build_fleet_stat_health(dump))
    return [tpath, rpath, spath]


def _read_bytes(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def main(argv: list[str] | None = None) -> int:
    """Recompute the merged fleet artifacts of a dump; with ``--check``,
    exit 1 if any byte of the three files changed (2: not a fleet dump)."""
    ap = argparse.ArgumentParser(description="Recompute the merged fleet artifacts "
                                             "from a fleet dump.")
    ap.add_argument("dump_dir", help="a RouterServer.dump_fleet output directory "
                                     "(contains fleet_manifest.json)")
    ap.add_argument("--check", action="store_true",
                    help="byte-compare the recomputed artifacts against the ones on disk; "
                         "exit 1 on any difference")
    args = ap.parse_args(argv)
    names = (FLEET_TRACE_BASENAME, FLEET_REPORT_BASENAME, FLEET_STAT_HEALTH_BASENAME)
    before = {name: _read_bytes(os.path.join(args.dump_dir, name)) for name in names}
    try:
        paths = write_fleet_artifacts(args.dump_dir)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for p in paths:
        print(f"wrote {p}")
    if args.check:
        changed = [name for name in names
                   if before[name] != _read_bytes(os.path.join(args.dump_dir, name))]
        if changed:
            print("check FAILED — recomputation changed: " + ", ".join(changed),
                  file=sys.stderr)
            return 1
        print("check ok — recomputation is byte-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
