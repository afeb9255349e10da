"""Telemetry of the port, the JAX package's ``observability`` surface
for the sweep and the serving daemon:

* the metrics registry (``counter``, ``gauge``, ``histogram``,
  ``bucket_histogram``; ``REGISTRY``) and the event log (``span``,
  ``emit``; ``EVENTS``);
* the serving daemon's SLO engine (:mod:`.slo`), its statistical-health
  plane (:mod:`.sketch`, :mod:`.stathealth`) and its session report
  (:mod:`.serving_report`);
* the exporters: ``metrics.json``, ``events.jsonl`` and the Prometheus
  textfile (:mod:`.export`, :mod:`.promtext`), all written atomically;
* device and build capture (:mod:`.device`: device memory, the kernel
  build cache's directory, a built library's ptxas resources);
* the trace timeline and its critical-path / overlap analysis
  (:mod:`.trace`, :mod:`.critical_path`).

All of it is host-side: it never touches an estimator's tensors, so the
rows are the same bits with or without an output directory.
"""

from __future__ import annotations

import time
from typing import Callable

from ate_replication_causalml_torch.observability.device import (
    install_monitoring,
    record_compiled_cost,
    record_device_memory,
    watch_cache_dir,
)
from ate_replication_causalml_torch.observability.events import EVENTS, EventLog, emit, span
from ate_replication_causalml_torch.observability.export import (
    atomic_file,
    atomic_write_json,
    atomic_write_text,
    write_events_jsonl,
    write_metrics_json,
    write_run_artifacts,
)
from ate_replication_causalml_torch.observability.registry import (
    DEFAULT_LATENCY_BUCKETS,
    PAD_FRACTION_BOUNDS,
    REGISTRY,
    SCHEMA_VERSION,
    BucketHistogram,
    MetricsRegistry,
    bucket_histogram,
    counter,
    enabled,
    gauge,
    histogram,
    parse_label_key,
    peek_labeled,
    sanitize_label,
    set_enabled,
)
from ate_replication_causalml_torch.observability.trace import (
    MetricSampler,
    build_trace,
    trace_enabled,
    write_trace_artifacts,
    write_trace_json,
)

__all__ = ["BucketHistogram", "DEFAULT_LATENCY_BUCKETS", "EVENTS", "EventLog", "MetricSampler",
           "MetricsRegistry", "PAD_FRACTION_BOUNDS", "REGISTRY", "SCHEMA_VERSION", "atomic_file",
           "atomic_write_json", "atomic_write_text", "bucket_histogram", "build_trace", "counter",
           "emit", "enabled", "gauge", "histogram", "install_monitoring", "instrument_dispatch",
           "parse_label_key", "peek_labeled", "record_compiled_cost", "record_device_memory",
           "sanitize_label", "set_enabled", "span", "trace_enabled", "watch_cache_dir",
           "write_events_jsonl", "write_metrics_json", "write_run_artifacts",
           "write_trace_artifacts", "write_trace_json"]


def instrument_dispatch(kind: str, fn: Callable[[int], object]):
    """Wrap a shard thunk (``fn(i) -> result``) with the
    ``tree_dispatch_total`` counter and the ``tree_dispatch_seconds``
    histogram, labeled ``fit=kind``. The duration is the host's: the
    thunk's enqueue, and its execution where it synchronizes. No sync is
    added: results come back exactly as produced."""
    c = counter("tree_dispatch_total", "forest tree-chunk dispatches")
    # graftlint: disable=JGL021 — created at first use: pre-creating it would change the counter/histogram families of the port's metrics.json, which tests/test_torch_pipeline.py holds to the JAX package's sweep
    h = histogram("tree_dispatch_seconds", "per-dispatch host wall-clock")
    c.inc(0, fit=kind)

    def wrapped(i: int):
        t0 = time.perf_counter()
        out = fn(i)
        h.observe(time.perf_counter() - t0, fit=kind)
        c.inc(1, fit=kind)
        return out

    return wrapped
