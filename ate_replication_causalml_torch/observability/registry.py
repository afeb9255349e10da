"""Process-global metrics registry.

Port of ``ate_replication_causalml_tpu/observability/registry.py``:
counters, gauges and summary histograms with labels, thread-safe, read
back as a plain dict (:meth:`MetricsRegistry.snapshot`, the
``metrics.json`` payload, in the JAX package's layout and schema
version). The sweep driver, the engine, the nuisance cache, the prefetch
lane, the shard runner and the kernel build write here. The serving
plane's bucketed histograms and the snapshot-time collectors are not
ported (the ``bucket_histograms`` section stays empty). Telemetry is
host-side only: it never touches an estimator's tensors.
"""

from __future__ import annotations

import re
import threading
import time

#: metrics.json / events.jsonl schema version (the JAX package's;
#: ``scripts/check_metrics_schema.py`` validates against it).
SCHEMA_VERSION = 1

_LABEL_SAFE = re.compile(r"[^A-Za-z0-9_-]")


def sanitize_label(label: str) -> str:
    """Map any character outside ``[A-Za-z0-9_-]`` to ``_``: sweep method
    names (``Causal Forest(GRF)``, ``Belloni et.al``) become file names
    and profiler labels."""
    return _LABEL_SAFE.sub("_", label)


def _label_key(labels: dict) -> str:
    """Canonical string form of a label set (sorted ``k=v`` pairs, ``,``
    and ``=`` inside values mapped to ``_``); "" for no labels."""
    if not labels:
        return ""
    clean = lambda v: str(v).replace(",", "_").replace("=", "_")
    return ",".join(f"{k}={clean(labels[k])}" for k in sorted(labels))


class Counter:
    """Monotonically increasing per-label-set float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self.samples: dict[str, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        """Add ``value`` (>= 0); ``inc(0, **labels)`` makes a sample that
        is present but zero."""
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment {value}")
        key = _label_key(labels)
        with self._lock:
            self.samples[key] = self.samples.get(key, 0.0) + value


class Gauge:
    """Last-write-wins per-label-set value."""

    kind = "gauge"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self.samples: dict[str, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self.samples[_label_key(labels)] = float(value)


class Histogram:
    """Summary histogram: count, sum, min, max and last per label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self.samples: dict[str, dict] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self.samples.get(key)
            if s is None:
                self.samples[key] = {"count": 1, "sum": value, "min": value, "max": value,
                                     "last": value}
            else:
                s["count"] += 1
                s["sum"] += value
                s["min"] = min(s["min"], value)
                s["max"] = max(s["max"], value)
                s["last"] = value


class MetricsRegistry:
    """Thread-safe named-metric store."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self._lock)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def peek(self, name: str) -> dict[str, float] | None:
        """One family's samples as ``{label_key: value}`` (a histogram's
        ``sum``), or None when it was never created: the trace sampler's
        cheap read."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return None
            if m.kind == "histogram":
                return {k: float(v["sum"]) for k, v in m.samples.items()}
            return dict(m.samples)

    def snapshot(self) -> dict:
        """Versioned plain-dict snapshot (the metrics.json payload);
        families never sampled are left out."""
        out = {"schema_version": SCHEMA_VERSION, "created_unix": time.time(),
               "counters": {}, "gauges": {}, "histograms": {}, "bucket_histograms": {}}
        with self._lock:
            for m in self._metrics.values():
                if m.samples:
                    out[m.kind + "s"][m.name] = {
                        k: dict(v) if isinstance(v, dict) else v for k, v in m.samples.items()}
        return out

    def reset(self) -> None:
        """Drop every metric (tests, and a caller reading one run)."""
        with self._lock:
            self._metrics.clear()


#: The process-global default registry every in-tree emitter writes to.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return REGISTRY.histogram(name, help)
