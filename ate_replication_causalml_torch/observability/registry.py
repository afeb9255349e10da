"""Process-global metrics registry.

Port of ``ate_replication_causalml_tpu/observability/registry.py``:
counters, gauges and summary histograms with labels, thread-safe, read
back as a plain dict (:meth:`MetricsRegistry.snapshot`, the
``metrics.json`` payload, in the JAX package's layout and schema
version). The sweep driver, the engine, the nuisance cache, the prefetch
lane, the shard runner and the kernel build write here; the serving
daemon adds the bucketed histograms (:class:`BucketHistogram`, the
``bucket_histograms`` section: fixed log-spaced bounds, p50/p95/p99 in
the snapshot) that its latency, phase, fill and pad families ride.
Snapshot-time collectors (:meth:`MetricsRegistry.add_collector`) refresh
gauges that read outside state, such as
:func:`~.device.watch_cache_dir`'s. Telemetry is host-side only: it
never touches an estimator's tensors.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
import time
from typing import Callable, Sequence

#: metrics.json / events.jsonl schema version (the JAX package's;
#: ``scripts/check_metrics_schema.py`` validates against it).
SCHEMA_VERSION = 1

_LABEL_SAFE = re.compile(r"[^A-Za-z0-9_-]")

_ENV = "ATE_TPU_TELEMETRY"
_enabled_cache: bool | None = None


def enabled() -> bool:
    """Telemetry master switch: on unless ``ATE_TPU_TELEMETRY=0``. The
    variable is read once and cached; :func:`set_enabled` flips it."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = os.environ.get(_ENV, "1") != "0"
    return _enabled_cache


def set_enabled(value: bool | None) -> None:
    """Override the master switch (``None`` re-reads the variable)."""
    global _enabled_cache
    _enabled_cache = value if value is None else bool(value)


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


def parse_label_key(key: str) -> dict[str, str]:
    """Inverse of :func:`_label_key` for keys the registry built:
    ``"backend=b0,outcome=ok"`` → ``{"backend": "b0", "outcome": "ok"}``
    (the empty key → ``{}``). Values were sanitized at write time, so a
    ``split("=", 1)`` a pair is exact: the one parser every reader of
    canonical label keys shares."""
    if not key:
        return {}
    return dict(pair.split("=", 1) for pair in key.split(",") if "=" in pair)


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
        if not enabled():
            return
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
        if not enabled():
            return
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
        if not enabled():
            return
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


#: Default bucket bounds for :class:`BucketHistogram`: log-spaced (factor
#: 2) from 100 µs to ~52 s, the JAX package's ladder, so a sub-millisecond
#: request and a multi-second startup phase share comparable buckets.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = tuple(1e-4 * 2.0**k for k in range(20))

#: Bounds of the serving daemon's fill, pad and masked fraction families.
PAD_FRACTION_BOUNDS: tuple[float, ...] = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


class BucketHistogram:
    """Bucketed histogram: fixed ascending upper bounds plus an overflow
    bucket, with count, sum, min and max per label set.

    Quantiles are estimated at snapshot time as the upper bound of the
    bucket where the cumulative count crosses the quantile
    (Prometheus-style, conservative), clamped to the observed max. The
    bounds are fixed when the family is created: re-registering with
    other bounds raises, since samples over mismatched ladders cannot be
    merged."""

    kind = "bucket_histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket histogram {name}: bounds must be non-empty and "
                             f"strictly ascending, got {bounds!r}")
        self.name = name
        self.help = help
        self.bounds = bounds
        self._lock = lock
        self.samples: dict[str, dict] = {}

    def observe(self, value: float, **labels) -> None:
        if not enabled():
            return
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)  # le semantics
        key = _label_key(labels)
        with self._lock:
            s = self.samples.get(key)
            if s is None:
                s = self.samples[key] = {"count": 0, "sum": 0.0, "min": value, "max": value,
                                         "buckets": [0] * (len(self.bounds) + 1)}
            s["count"] += 1
            s["sum"] += value
            s["min"] = min(s["min"], value)
            s["max"] = max(s["max"], value)
            s["buckets"][idx] += 1

    def _quantile(self, s: dict, q: float) -> float:
        target = q * s["count"]
        cum = 0
        for i, c in enumerate(s["buckets"]):
            cum += c
            if cum >= target and c:
                return s["max"] if i >= len(self.bounds) else min(self.bounds[i], s["max"])
        return s["max"]

    def snapshot_sample(self, s: dict) -> dict:
        """One label set's ``metrics.json`` payload: the raw buckets, the
        bounds (so a saved snapshot describes itself) and p50/p95/p99."""
        out = dict(s, buckets=list(s["buckets"]), bounds=list(self.bounds))
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[key] = self._quantile(s, q)
        return out

    def peek_counts(self) -> dict[str, dict]:
        """Lock-held copy of the raw samples, the cheap read the SLO
        engine and the daemon's ``stats`` op take."""
        with self._lock:
            return {k: dict(s, buckets=list(s["buckets"])) for k, s in self.samples.items()}

    def good_total_le(self, threshold: float) -> tuple[int, int]:
        """``(good, total)`` observation counts over every label set,
        *good* being an observation in a bucket whose upper bound is <=
        ``threshold`` (the latency SLOs' conservative reading)."""
        k = bisect.bisect_right(self.bounds, float(threshold))
        good = total = 0
        with self._lock:
            for s in self.samples.values():
                total += s["count"]
                good += sum(s["buckets"][:k])
        return good, total


class MetricsRegistry:
    """Thread-safe named-metric store."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, Counter | Gauge | Histogram | BucketHistogram] = {}
        self._collectors: list[Callable[[], None]] = []

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

    def bucket_histogram(self, name: str, help: str = "",
                         bounds: Sequence[float] | None = None) -> BucketHistogram:
        """Bucketed (quantile-capable) histogram family. ``bounds`` fixes
        the ladder on first creation (default
        :data:`DEFAULT_LATENCY_BUCKETS`); other bounds for an existing
        family raise."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = BucketHistogram(
                    name, help, self._lock,
                    bounds=DEFAULT_LATENCY_BUCKETS if bounds is None else bounds)
            elif not isinstance(m, BucketHistogram):
                raise TypeError(f"metric {name!r} already registered as {m.kind}")
            elif bounds is not None and tuple(float(b) for b in bounds) != m.bounds:
                raise ValueError(f"bucket histogram {name!r} already registered with "
                                 f"bounds {m.bounds!r}")
            return m

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every :meth:`snapshot` (once per function)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def family(self, name: str):
        """The metric registered under ``name``, or None: the read-only
        accessor of the SLO engine and the daemon's ``stats`` op (it
        creates no family)."""
        with self._lock:
            return self._metrics.get(name)

    def peek(self, name: str) -> dict[str, float] | None:
        """One family's samples as ``{label_key: value}`` (a histogram's
        ``sum``), or None when it was never created: the trace sampler's
        cheap read."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return None
            if m.kind in ("histogram", "bucket_histogram"):
                return {k: float(v["sum"]) for k, v in m.samples.items()}
            return dict(m.samples)

    def peek_labeled(self, name: str) -> list[tuple[dict[str, str], float]] | None:
        """:meth:`peek` with every label key parsed back into its label
        dict, sorted: ``[(labels, value), ...]``, or None when the family
        was never created (the admin endpoint's ``/varz``)."""
        samples = self.peek(name)
        if samples is None:
            return None
        return [(parse_label_key(k), v) for k, v in sorted(samples.items())]

    def metrics(self) -> list:
        """Every registered family, in registration order."""
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Versioned plain-dict snapshot (the metrics.json payload);
        families never sampled are left out. The collectors run first."""
        for fn in list(self._collectors):
            try:
                fn()
            # graftlint: disable=JGL007 — a collector is observer code: a failing one must not lose the snapshot it feeds
            except Exception:  # noqa: BLE001
                pass
        out = {"schema_version": SCHEMA_VERSION, "created_unix": time.time(),
               "counters": {}, "gauges": {}, "histograms": {}, "bucket_histograms": {}}
        with self._lock:
            for m in self._metrics.values():
                if m.samples:
                    render = getattr(m, "snapshot_sample", None)
                    out[m.kind + "s"][m.name] = {
                        k: (render(v) if render is not None
                            else dict(v) if isinstance(v, dict) else v)
                        for k, v in m.samples.items()}
        return out

    def reset(self) -> None:
        """Drop every metric and collector (tests, and a caller reading
        one run)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


#: The process-global default registry every in-tree emitter writes to.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return REGISTRY.histogram(name, help)


def bucket_histogram(name: str, help: str = "",
                     bounds: Sequence[float] | None = None) -> BucketHistogram:
    return REGISTRY.bucket_histogram(name, help, bounds=bounds)


def peek_labeled(name: str) -> list[tuple[dict[str, str], float]] | None:
    return REGISTRY.peek_labeled(name)
