"""Serving-session analysis of an exported trace.

Port of ``ate_replication_causalml_tpu/observability/serving_report.py``:
the same sections and bytes. The overlap report answers "where did the
sweep's wall clock go"; this module answers the serving twin, "where did
a request's latency go, and what did the coalescer do about it", as a
**pure function of the exported ``trace.json``**: :func:`serving_report`
reads only the trace's ``cat="request"`` / ``cat="batch"`` slices (the
daemon's ``serving_request`` / ``serving_batch`` spans) and the
``serving_reject`` instants, so a reader recomputes the daemon's own
``serving_report.json`` bit for bit from the saved trace.

Sections:

* **requests**: terminal-status counts and, for every request slice
  that carries the lifecycle attrs, per-phase duration stats
  (count / sum / p50 / p99 / max for ``coalesce_wait`` / ``queue_wait``
  / ``dispatch`` / ``device`` / ``reply``);
* **batches**: count, per-bucket mix, fill efficiency, mean pad
  fraction, and the close-reason split;
* **rejects**: the admission / chaos reject timeline (bounded; the
  counters carry exact totals);
* **reconciliation** (present when a ``metrics.json`` snapshot is
  supplied): ``requests_in_metrics`` (the dispatch-side phase
  histogram's count: every request that completed the lifecycle,
  raw ``submit()`` callers included) against ``requests_in_trace`` (the
  ``serve_one`` request slices the phase section is built from); the
  difference is ``silent_drops``.

Pure stdlib; a pure function of its inputs (trace, metrics snapshot).
"""

from __future__ import annotations

import os

#: serving_report.json layout version.
SERVING_SCHEMA_VERSION = 1

SERVING_REPORT_BASENAME = "serving_report.json"
SLO_REPORT_BASENAME = "slo_report.json"

#: request-slice attr suffix -> report phase name, in lifecycle order.
PHASE_KEYS = ("coalesce_wait", "queue_wait", "dispatch", "device", "reply")

#: reject-timeline entries kept verbatim; the counts are always exact.
MAX_REJECT_TIMELINE = 500


def _events(trace: dict) -> list[dict]:
    evs = trace.get("traceEvents")
    return evs if isinstance(evs, list) else []


def has_serving_slices(trace: dict) -> bool:
    """Whether this trace carries a serving session."""
    return any(
        ev.get("cat") in ("request", "batch") and ev.get("ph") == "X"
        for ev in _events(trace)
    )


def index_quantile(sorted_vals: list[float], q: float) -> float:
    """THE conservative index quantile every serving consumer shares
    (this report, the loadgen records): deterministic on ties, no
    interpolation."""
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def phase_count_from_metrics(metrics: dict | None) -> int | None:
    """Requests the METRICS side decomposed: the ``serving_phase_seconds``
    bucket histogram's count for the ``device`` phase (every phase of a
    decomposed request is recorded exactly once, so any phase's count
    works; ``device`` is the least ambiguous). None only when no
    snapshot was supplied at all; a snapshot without the family means
    zero requests were decomposed — a reported 0, not a missing
    section."""
    if metrics is None:
        return None
    fam = metrics.get("bucket_histograms", {}).get(
        "serving_phase_seconds"
    )
    if not isinstance(fam, dict):
        return 0
    return sum(
        int(s.get("count", 0))
        for key, s in fam.items()
        if "phase=device" in key.split(",") and isinstance(s, dict)
    )


def phase_mark_from_trace(trace: dict) -> int:
    """The daemon's startup phase-count baseline, stamped into the
    trace's ``otherData``: the quantity that windows the process-global
    metrics count to THIS serving session."""
    try:
        return int(
            (trace.get("otherData") or {}).get("serving_phase_mark", 0)
        )
    except (TypeError, ValueError):
        return 0


def serving_report(trace: dict, metrics: dict | None = None) -> dict:
    """The ``serving_report.json`` payload for one exported trace,
    optionally reconciled against the run's ``metrics.json`` snapshot
    (the silent-drop accounting for raw ``submit()`` traffic)."""
    requests: list[dict] = []
    batches: list[dict] = []
    rejects: list[dict] = []
    for ev in _events(trace):
        if ev.get("ph") == "X" and ev.get("cat") == "request":
            requests.append(ev)
        elif ev.get("ph") == "X" and ev.get("cat") == "batch":
            batches.append(ev)
        elif ev.get("name") == "serving_reject":
            rejects.append(ev)

    # ── window envelope (µs -> s, trace-origin-relative) ─────────────
    # Reject instants count on BOTH edges: a reject burst after the
    # last served slice must not land "outside" the report's window.
    starts = [ev["ts"] for ev in requests + batches + rejects]
    ends = [
        ev["ts"] + ev.get("dur", 0.0) for ev in requests + batches
    ] + [ev["ts"] for ev in rejects]
    window_s = (max(ends) - min(starts)) / 1e6 if starts else 0.0

    # ── requests: status counts + phase decomposition ────────────────
    status: dict[str, int] = {}
    phase_vals: dict[str, list[float]] = {k: [] for k in PHASE_KEYS}
    e2e_vals: list[float] = []
    for ev in requests:
        args = ev.get("args", {})
        st = str(args.get("status", "ok"))
        status[st] = status.get(st, 0) + 1
        if all(f"{k}_s" in args for k in PHASE_KEYS):
            for k in PHASE_KEYS:
                phase_vals[k].append(float(args[f"{k}_s"]))
            e2e_vals.append(float(args.get("e2e_s", ev.get("dur", 0.0) / 1e6)))

    def _stats(vals: list[float]) -> dict:
        if not vals:
            return {"count": 0, "sum_s": 0.0, "p50_s": 0.0, "p99_s": 0.0,
                    "max_s": 0.0}
        s = sorted(vals)
        return {
            "count": len(s),
            "sum_s": round(sum(s), 9),
            "p50_s": round(index_quantile(s, 0.50), 9),
            "p99_s": round(index_quantile(s, 0.99), 9),
            "max_s": round(s[-1], 9),
        }

    # ── batches: bucket mix, fill, close reasons ─────────────────────
    by_bucket: dict[str, int] = {}
    close_reasons: dict[str, int] = {}
    fills: list[float] = []
    rows_total = 0
    for ev in batches:
        args = ev.get("args", {})
        bucket = str(args.get("bucket", "?"))
        by_bucket[bucket] = by_bucket.get(bucket, 0) + 1
        reason = str(args.get("close_reason", "?"))
        close_reasons[reason] = close_reasons.get(reason, 0) + 1
        fills.append(float(args.get("fill", 0.0)))
        rows_total += int(args.get("rows", 0))

    # ── rejects: bounded timeline, exact counts ──────────────────────
    by_reason: dict[str, int] = {}
    timeline: list[dict] = []
    for ev in rejects:
        reason = str(ev.get("args", {}).get("reason", "?"))
        by_reason[reason] = by_reason.get(reason, 0) + 1
        if len(timeline) < MAX_REJECT_TIMELINE:
            timeline.append({
                "ts_s": round(ev["ts"] / 1e6, 6),
                "reason": reason,
                "request_id": str(ev.get("args", {}).get("request_id", "")),
            })

    out: dict = {
        "schema_version": SERVING_SCHEMA_VERSION,
        "window_s": round(window_s, 6),
        "requests": {
            "count": len(requests),
            "status": {k: status[k] for k in sorted(status)},
            "with_phases": len(e2e_vals),
            "e2e": _stats(e2e_vals),
            "phases": {k: _stats(phase_vals[k]) for k in PHASE_KEYS},
        },
        "batches": {
            "count": len(batches),
            "rows": rows_total,
            "by_bucket": {k: by_bucket[k] for k in sorted(by_bucket)},
            "fill_mean": round(sum(fills) / len(fills), 6) if fills else 0.0,
            "pad_fraction_mean": (
                round(1.0 - sum(fills) / len(fills), 6) if fills else 0.0
            ),
            "close_reasons": {
                k: close_reasons[k] for k in sorted(close_reasons)
            },
        },
        "rejects": {
            "count": len(rejects),
            "by_reason": {k: by_reason[k] for k in sorted(by_reason)},
            "timeline": timeline,
            "timeline_truncated": max(0, len(rejects) - len(timeline)),
        },
    }
    in_metrics = phase_count_from_metrics(metrics)
    if in_metrics is not None:
        # The phase histogram is process-global; the daemon stamped its
        # startup baseline into the trace's otherData so an earlier
        # serving session in the same process is not misreported as
        # this window's silent drops. The metrics snapshot is taken
        # AFTER the trace is built (the daemon's dump order pins
        # this), so the windowed metrics side can only see MORE
        # decomposed requests, never fewer — silent_drops is the
        # raw-submit() traffic the trace-derived phase section cannot
        # see.
        in_window = max(0, in_metrics - phase_mark_from_trace(trace))
        out["reconciliation"] = {
            "requests_in_metrics": in_window,
            "requests_in_trace": len(e2e_vals),
            "silent_drops": in_window - len(e2e_vals),
        }
    return out


def write_serving_artifacts(outdir: str, trace: dict,
                            metrics: dict | None = None) -> list[str]:
    """Write the ``trace.json`` + ``serving_report.json`` pair for a
    serving session: the one write recipe :meth:`CateServer.stop` and
    the ``dump`` op share, so their bytes can only agree. ``metrics`` (the run's metrics.json payload) enables the
    silent-drop reconciliation section. Returns the paths written
    ([] when tracing is disabled)."""
    from ate_replication_causalml_torch.observability.export import atomic_write_json
    from ate_replication_causalml_torch.observability.trace import (
        TRACE_BASENAME,
        trace_enabled,
        write_trace_json,
    )

    if not trace_enabled():
        return []
    tpath = os.path.join(outdir, TRACE_BASENAME)
    write_trace_json(tpath, trace)
    spath = os.path.join(outdir, SERVING_REPORT_BASENAME)
    atomic_write_json(spath, serving_report(trace, metrics=metrics))
    return [tpath, spath]


def render_summary(report: dict) -> str:
    """Human summary of a report."""
    req = report["requests"]
    bat = report["batches"]
    rej = report["rejects"]
    lines = [
        f"serving window {report['window_s']:.3f}s: {req['count']} request "
        f"slice(s), {bat['count']} batch(es), {rej['count']} reject(s)",
    ]
    if req["with_phases"]:
        lines.append(
            f"e2e p50 {req['e2e']['p50_s'] * 1e3:.2f}ms  "
            f"p99 {req['e2e']['p99_s'] * 1e3:.2f}ms "
            f"({req['with_phases']} decomposed)"
        )
        lines.append("phases (p50 / p99 / max ms):")
        for k in PHASE_KEYS:
            st = req["phases"][k]
            lines.append(
                f"  {k:<14s} {st['p50_s'] * 1e3:8.3f} "
                f"{st['p99_s'] * 1e3:8.3f} {st['max_s'] * 1e3:8.3f}"
            )
    if bat["count"]:
        lines.append(
            f"batches: fill {bat['fill_mean']:.2%}, pad "
            f"{bat['pad_fraction_mean']:.2%}, buckets {bat['by_bucket']}, "
            f"close {bat['close_reasons']}"
        )
    if rej["count"]:
        lines.append(f"rejects by reason: {rej['by_reason']}")
    rec = report.get("reconciliation")
    if rec is not None:
        lines.append(
            f"reconciliation: {rec['requests_in_metrics']} in metrics, "
            f"{rec['requests_in_trace']} in trace "
            f"({rec['silent_drops']} silent raw-submit drop(s))"
        )
    return "\n".join(lines)
