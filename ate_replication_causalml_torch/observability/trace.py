"""Chrome/Perfetto trace export of the span EventLog.

Port of ``ate_replication_causalml_tpu/observability/trace.py``:
:func:`build_trace` is the same pure function of the record list (equal
output on equal input), so a reader of the JAX package's sweep trace
reads the port's.

The event log already records every span with both clocks, the owning
thread, and parentage; this module renders those records in the
catapult trace-event format (the JSON ``chrome://tracing`` / Perfetto's
legacy importer read), so a sweep's schedule becomes a picture instead
of a JSONL scroll:

* one timeline track per thread that emitted spans (the scheduler's
  ``sweep-worker-N`` threads, the main thread) plus dedicated tracks
  for each exclusive lane (``lane:mesh``), the compile-prefetch lane
  and the ordered committer — records carry the routing in their attrs
  (``track=`` for a hard override, ``lane=`` for the additional lane-
  occupancy slice);
* flow arrows from each nuisance-artifact fit to the stages that
  declared it in ``needs`` (the attribution the scheduler stamps on its
  ``scheduler_node`` spans), so Perfetto draws the DAG on the timeline;
* counter tracks from ``metric_sample`` point events (see
  :class:`MetricSampler`) — nuisance-cache traffic, backoff seconds,
  device memory — sampled out of the metrics registry while the run is
  in flight;
* point events (chaos injections, retries, prefetch errors) as instant
  markers on the track of their *enclosing span* — a chaos fault shows
  up on the worker/lane that was running the faulted stage.

All timestamps are the records' monotonic clock, shifted so the trace
starts at zero; the wall-clock anchor for the origin rides in the
header (``otherData.wall_anchor_unix``), so absolute times are
recoverable without ever mixing the two clocks inside the timeline.

``observability/critical_path.py`` computes the run's critical path and
overlap report from the trace.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry

TRACE_BASENAME = "trace.json"
OVERLAP_BASENAME = "overlap_report.json"

#: trace.json layout version (otherData.trace_schema_version).
TRACE_SCHEMA_VERSION = 1

_TRACE_ENV = "ATE_TPU_TRACE"

#: record name -> trace category. Categories are the analyzer's parse
#: contract: ``node`` slices are the scheduler's execution intervals,
#: ``lane`` slices are their duplicated lane-occupancy view (never
#: counted as busy time twice), ``commit`` and ``prefetch`` feed the
#: serialization-blame section; ``request``/``batch`` are the serving
#: daemon's lifecycle slices (the serving report's parse contract).
_CATEGORIES = {
    "scheduler_node": "node",
    "commit": "commit",
    "prefetch_compile": "prefetch",
    "serving_request": "request",
    "serving_batch": "batch",
    # The fleet router's forward spans, stitched to the daemons'
    # ``request`` slices on request id across process boundaries.
    "router_request": "router",
}

_PID = 1

#: track-category sort order in the Perfetto UI: serving connections
#: first (one track per connection thread), then the dispatcher/device
#: track, workers, lanes, the prefetch lane, the committer, counters
#: last.
_SORT = {"conn": 0, "dispatch": 50, "worker": 60, "lane": 100,
         "prefetch": 200, "committer": 300, "counter": 400}


def trace_enabled() -> bool:
    """Host-trace switch: on unless ``ATE_TPU_TRACE=0``. Tracing is a
    read of the already-collected event log; it never touches estimator
    numerics."""
    return os.environ.get(_TRACE_ENV, "1") != "0"


def _track_of(rec: dict) -> tuple[str, str]:
    """(category, name) of the PRIMARY track a record renders on."""
    attrs = rec.get("attrs") or {}
    track = attrs.get("track")
    if track == "committer":
        return ("committer", "committer")
    if track == "prefetch":
        return ("prefetch", "prefetch")
    if track:
        return ("worker", str(track))
    name = rec.get("thread_name") or f"thread-{rec.get('thread', '?')}"
    # Serving track semantics: request spans render one track
    # per connection (producer) thread; batch spans render on the
    # dispatcher/device track — the thread that owns the device.
    if rec.get("name") == "serving_request":
        return ("conn", str(name))
    if rec.get("name") == "serving_batch":
        return ("dispatch", str(name))
    # Router forward spans render one track per router
    # connection thread, beside the daemons' conn tracks — the fleet
    # merge then shows request → forward → serve as adjacent rows.
    if rec.get("name") == "router_request":
        return ("conn", str(name))
    return ("worker", str(name))


def _is_instant(rec: dict) -> bool:
    # emit() records start == end; treat sub-microsecond spans the same
    # (they would render as zero-width slices anyway).
    return (rec["end_mono_s"] - rec["start_mono_s"]) * 1e6 < 1.0


def build_trace(records: list[dict] | None = None,
                meta: dict | None = None) -> dict:
    """Render ``records`` (default: the global event log) as a catapult
    trace object. ``meta`` merges into ``otherData`` — the sweep driver
    passes run identity, worker count and wall seconds so the analyzer
    and the Perfetto header agree on the run's envelope."""
    if records is None:
        records = _events.EVENTS.records()
    records = [r for r in records if "start_mono_s" in r]
    events: list[dict] = []
    if records:
        origin_rec = min(records, key=lambda r: r["start_mono_s"])
        origin = origin_rec["start_mono_s"]
        wall_anchor = origin_rec["start_unix"]
    else:
        origin, wall_anchor = 0.0, None
    ts = lambda mono_s: (mono_s - origin) * 1e6  # µs from trace origin

    # ── track registry: deterministic tids from (category, name) ─────
    tracks: dict[tuple[str, str], int] = {}

    def tid(cat: str, name: str) -> int:
        key = (cat, name)
        if key not in tracks:
            tracks[key] = len(tracks) + 1
        return tracks[key]

    # Primary track per span id — instants resolve to their *enclosing
    # span's* track so a chaos injection lands on the worker/lane that
    # was running the faulted stage, not on a synthetic thread row.
    by_id = {r["span_id"]: r for r in records}
    track_cache: dict[str, tuple[str, str]] = {}

    def resolve_track(rec: dict, hops: int = 0) -> tuple[str, str]:
        sid = rec["span_id"]
        if sid in track_cache:
            return track_cache[sid]
        out = _track_of(rec)
        if _is_instant(rec) and "track" not in (rec.get("attrs") or {}):
            parent = by_id.get(rec.get("parent_id") or "")
            if parent is not None and hops < 16:
                out = resolve_track(parent, hops + 1)
        track_cache[sid] = out
        return out

    flow_id = 0
    artifact_slices: dict[str, dict] = {}
    stage_slices: list[dict] = []
    request_slices: list[dict] = []
    batch_by_seq: dict[int, dict] = {}
    counter_series: set[str] = set()

    for rec in sorted(records, key=lambda r: (r["start_mono_s"], r["span_id"])):
        attrs = rec.get("attrs") or {}
        if rec["name"] == "metric_sample":
            # Counter track: one series per metric name.
            metric = str(attrs.get("metric", "metric"))
            counter_series.add(metric)
            events.append({
                "name": metric, "cat": "counter", "ph": "C", "pid": _PID,
                "tid": tid("counter", "counters"),
                "ts": ts(rec["start_mono_s"]),
                "args": {"value": attrs.get("value", 0.0)},
            })
            continue
        cat = _CATEGORIES.get(rec["name"], "span")
        tcat, tname = resolve_track(rec)
        args = {"status": rec.get("status"), "span_id": rec["span_id"]}
        args.update({
            k: v for k, v in attrs.items()
            if isinstance(v, (str, int, float, bool)) and k != "track"
        })
        label = str(
            attrs.get("node") or attrs.get("method") or attrs.get("stage")
            or attrs.get("artifact") or rec["name"]
        )
        if _is_instant(rec):
            events.append({
                "name": label, "cat": cat, "ph": "i", "s": "t", "pid": _PID,
                "tid": tid(tcat, tname), "ts": ts(rec["start_mono_s"]),
                "args": args,
            })
            continue
        slice_ev = {
            "name": label, "cat": cat, "ph": "X", "pid": _PID,
            "tid": tid(tcat, tname), "ts": ts(rec["start_mono_s"]),
            "dur": (rec["end_mono_s"] - rec["start_mono_s"]) * 1e6,
            "args": args,
        }
        events.append(slice_ev)
        lane = attrs.get("lane")
        if lane:
            # Duplicate slice on the lane-occupancy track: the worker
            # tracks show who ran what; the lane track shows WHY two
            # collective launches never overlapped.
            events.append(dict(slice_ev, cat="lane",
                               tid=tid("lane", f"lane:{lane}")))
        if cat == "node":
            if attrs.get("kind") == "artifact":
                artifact_slices[str(attrs.get("node"))] = slice_ev
            elif attrs.get("needs"):
                stage_slices.append(slice_ev)
        elif cat == "request" and attrs.get("batch_seq") is not None:
            request_slices.append(slice_ev)
        elif cat == "batch" and attrs.get("seq") is not None:
            batch_by_seq[int(attrs["seq"])] = slice_ev

    # ── flow arrows: artifact fit -> each consuming stage ─────────────
    for stage_ev in stage_slices:
        needs = [n for n in str(stage_ev["args"].get("needs", "")).split(",") if n]
        for need in needs:
            src = artifact_slices.get(need)
            if src is None:
                continue  # resumed/never-scheduled artifact: no slice
            flow_id += 1
            common = {"cat": "dep", "name": need, "id": flow_id, "pid": _PID}
            events.append(dict(common, ph="s", tid=src["tid"],
                               ts=src["ts"] + src["dur"]))
            events.append(dict(common, ph="f", bp="e", tid=stage_ev["tid"],
                               ts=stage_ev["ts"]))

    # ── serving flow arrows: request → batch → reply ────────
    # One three-point chain per coalesced request: start at the request
    # slice's enqueue, step through the micro-batch it rode on the
    # dispatcher track, finish back on the connection track at reply —
    # Perfetto draws the coalescer's fan-in/fan-out on the timeline.
    for req_ev in request_slices:
        batch_ev = batch_by_seq.get(int(req_ev["args"]["batch_seq"]))
        if batch_ev is None:
            continue  # batch span missing (ring-evicted): no arrow
        flow_id += 1
        common = {"cat": "req", "name": "request",
                  "id": flow_id, "pid": _PID}
        events.append(dict(common, ph="s", tid=req_ev["tid"],
                           ts=req_ev["ts"]))
        events.append(dict(common, ph="t", tid=batch_ev["tid"],
                           ts=batch_ev["ts"]))
        events.append(dict(common, ph="f", bp="e", tid=req_ev["tid"],
                           ts=req_ev["ts"] + req_ev["dur"]))

    # ── metadata: names + deterministic sort order ────────────────────
    meta_events = [{
        "name": "process_name", "ph": "M", "pid": _PID,
        "args": {"name": "ate-sweep"},
    }]
    for (tcat, tname), t in sorted(tracks.items(), key=lambda kv: kv[1]):
        meta_events.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": t,
            "args": {"name": tname},
        })
        meta_events.append({
            "name": "thread_sort_index", "ph": "M", "pid": _PID, "tid": t,
            "args": {"sort_index": _SORT.get(tcat, 0) + t},
        })
    other = {
        "trace_schema_version": TRACE_SCHEMA_VERSION,
        "clock": "monotonic",
        "time_unit": "us",
        "mono_origin_s": origin,
        "wall_anchor_unix": wall_anchor,
        "counter_series": sorted(counter_series),
    }
    if meta:
        other.update(meta)
    return {
        "traceEvents": meta_events + events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_trace_json(path: str, trace: dict, force: bool = False) -> str | None:
    """Atomically write ``trace`` to ``path`` (compact separators and a
    trailing newline: machines read it); None when tracing is off, unless
    ``force``: the fleet router's dump always writes its trace, whose wall
    anchor places every daemon's trace on the fleet timeline."""
    if not (force or trace_enabled()):
        return None
    from ate_replication_causalml_torch.observability.export import atomic_write_text

    atomic_write_text(path, json.dumps(trace, separators=(",", ":")) + "\n")
    return path


def write_trace_artifacts(outdir: str, trace: dict) -> list[str]:
    """Write ``trace`` as ``trace.json`` (compact: machines read it) and
    its ``overlap_report.json`` into ``outdir``, atomically; a fully
    resumed run's empty report is itself the answer. Returns the paths
    written ([] when tracing is off)."""
    if not trace_enabled():
        return []
    from ate_replication_causalml_torch.observability import critical_path as _cpath
    from ate_replication_causalml_torch.observability.export import atomic_write_json

    tpath = write_trace_json(os.path.join(outdir, TRACE_BASENAME), trace)
    opath = os.path.join(outdir, OVERLAP_BASENAME)
    atomic_write_json(opath, _cpath.overlap_report(trace))
    return [tpath, opath]


class MetricSampler:
    """Sampler turning registry metrics into counter tracks.

    Every ``interval_s`` the sampler reads the configured metric
    families (``registry.peek``: a dict copy under the registry lock)
    and emits one ``metric_sample`` point event per family with the
    summed value; the exporter renders those as Perfetto counter tracks.
    ``device_memory_bytes`` is read live, as ``torch.cuda.memory_allocated``
    summed over the CUDA devices in use (none on the CPU).

    The default 0.5 s interval keeps the samples from evicting the
    scheduler spans the critical-path analysis needs from the event
    log's 100k-record ring: four families cost ~29k records an hour.

    The sweep driver starts the sampler's thread only for a multi-worker
    run: the sequential sweep promises no thread of its own, and on the
    card every extra host thread slows the launches of the others. A
    sequential run takes one :meth:`sample_once` at the end instead.
    ``ticks`` counts the samples taken.
    """

    DEFAULT_METRICS = (
        "nuisance_cache_requests_total",
        "shard_backoff_seconds_total",
        "device_memory_bytes",
        "scheduler_prefetch_total",
    )

    #: The families the serving daemon samples instead: the live queue
    #: depth and the request, reject and batch counters become counter
    #: tracks over the serving window.
    SERVING_METRICS = (
        "serving_requests_total",
        "serving_rejected_total",
        "serving_queue_depth",
        "serving_batches_total",
    )

    def __init__(self, metrics: tuple[str, ...] | None = None, interval_s: float = 0.5):
        self.metrics = tuple(metrics) if metrics is not None else self.DEFAULT_METRICS
        self.interval_s = interval_s
        self.ticks = 0
        self._stop = threading.Event()
        # Guards the handle: a double start must not leak a second thread.
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _peek(name: str) -> float | None:
        if name == "device_memory_bytes":
            import torch

            if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
                return None
            return float(sum(torch.cuda.memory_allocated(i)
                             for i in range(torch.cuda.device_count())))
        samples = _registry.REGISTRY.peek(name)
        return float(sum(samples.values())) if samples else None

    def sample_once(self) -> None:
        self.ticks += 1
        for name in self.metrics:
            value = self._peek(name)
            if value is not None:
                _events.emit("metric_sample", status="sample", metric=name, value=value)

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._run, name="trace-sampler", daemon=True)
            self._thread.start()

    def stop(self, timeout: float | None = 5.0) -> None:
        """Stop the loop and take one final sample, so the counter tracks
        end at the run's closing values."""
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:  # join outside the lock: never block start()
            thread.join(timeout)
        self.sample_once()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()


def run_meta(workers: int | None = None, wall_s: float | None = None,
             **extra) -> dict:
    """The ``otherData`` payload the sweep driver attaches: worker-pool
    width and the run's wall seconds (the analyzer's denominator), plus
    free-form identity fields (the serving daemon's ``tool``,
    ``checkpoint``, ``buckets`` and ``serving_phase_mark``, the
    reconciliation baseline :mod:`.serving_report` reads)."""
    out: dict = {"exported_unix": time.time()}
    if workers is not None:
        out["workers"] = int(workers)
    if wall_s is not None:
        out["wall_s"] = float(wall_s)
    out.update(extra)
    return out
