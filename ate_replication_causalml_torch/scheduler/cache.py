"""Fit-once nuisance artifact cache.

Port of ``ate_replication_causalml_tpu/scheduler/cache.py``. Every
shared nuisance of the sweep (the logistic propensity, the AIPW outcome
model, the LASSO fold ids, the LASSO propensity, the RF OOB propensity)
is an :class:`~.dag.ArtifactSpec` and is fit at most once per (name,
key); the key carries the data fingerprint and the config knobs the fit
reads, so distinct configs never share an artifact.

Concurrency: the cache is where stages racing for one artifact meet. A
per-entry lock serializes the fit; the losers block, then read the
winner's value (a hit: they never refit). Failures are not memoized:
the next consumer refits, so each consumer stage degrades on its own,
as in a sequential sweep.

On the card (``device`` a CUDA device) a value fitted on one worker's
stream is handed to consumers on others with a CUDA event: the producer
records it on its current stream right after the fit, and :meth:`get`
makes the consumer's current stream wait on it before returning the
value. Without one, a consumer's kernels could read the value before
the producer's kernels have written it. The single-device layouts
(``sharding`` None or "host") store and deliver the value as the fit
returned it.

Hit and miss traffic lands in ``nuisance_cache_requests_total``
(labels ``artifact``, ``status=hit|miss``); each fit is a
``nuisance_fit`` span.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterable

import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.scheduler.dag import ArtifactSpec, DagError


class NuisanceCache:
    """Thread-safe fit-once store over a set of artifact specs. With a
    CUDA ``device`` every value carries the event of its fit."""

    def __init__(self, specs: Iterable[ArtifactSpec] = (), *, device=None):
        dev = None if device is None else torch.device(device)
        self._device = dev if dev is not None and dev.type == "cuda" else None
        self._lock = threading.Lock()
        self._specs: dict[str, ArtifactSpec] = {}
        self._values: dict[tuple, object] = {}
        self._events: dict[tuple, torch.cuda.Event] = {}
        self._entry_locks: dict[tuple, threading.Lock] = {}
        self._lane_locks: dict[str, threading.RLock] = {}
        self._hits: dict[str, int] = {}
        self._misses: dict[str, int] = {}
        for spec in specs:
            self.register(spec)

    def register(self, spec: ArtifactSpec) -> None:
        with self._lock:
            if spec.name in self._specs:
                raise DagError(f"artifact {spec.name!r} registered twice")
            self._specs[spec.name] = spec

    def spec(self, name: str) -> ArtifactSpec:
        with self._lock:
            return self._specs[name]

    def _entry_lock(self, key: tuple) -> threading.Lock:
        with self._lock:
            lk = self._entry_locks.get(key)
            if lk is None:
                lk = self._entry_locks[key] = threading.Lock()
            return lk

    def lane_lock(self, lane: str) -> threading.RLock:
        """Re-entrant lock shared with the engine for one exclusive lane.

        The engine's scheduling skip keeps two laned nodes from
        overlapping, but a failed laned artifact is refit by whichever
        consumer asks next, possibly an unlaned stage on another worker.
        The engine (around a laned node) and :meth:`ensure` (around a
        laned artifact's fit) both hold this lock, so such a refit never
        overlaps a laned node. Re-entrant because the engine's artifact
        node reaches the fit through :meth:`ensure` on the same thread;
        always taken before the per-entry lock, so the two orders cannot
        deadlock."""
        with self._lock:
            lk = self._lane_locks.get(lane)
            if lk is None:
                lk = self._lane_locks[lane] = threading.RLock()
            return lk

    def _lane_guard(self, spec: ArtifactSpec):
        if spec.exclusive is not None:
            return self.lane_lock(spec.exclusive)
        return contextlib.nullcontext()

    def get(self, name: str) -> object:
        """The artifact's value, fitting it on first request; on the card
        the caller's current stream first waits for the fit's work.

        Counted as a hit when the value already exists (including when
        this thread blocked on another thread's fit), a miss when this
        call runs the fit. An exception from the fit propagates to this
        caller and leaves no entry behind."""
        spec = self.spec(name)
        value = self.ensure(name)
        with self._lock:
            event = self._events.get((name, spec.key))
        if event is not None:
            torch.cuda.current_stream(self._device).wait_event(event)
        return value

    def ensure(self, name: str) -> object:
        """Fit if needed and return the stored value, without making the
        caller wait for its device work. The engine's artifact nodes
        call this: they produce the artifact; consumers call :meth:`get`."""
        spec = self.spec(name)
        key = (name, spec.key)
        c = obs.counter("nuisance_cache_requests_total",
                        "nuisance artifact cache requests by artifact and hit/miss")
        with self._lock:
            if key in self._values:
                self._hits[name] = self._hits.get(name, 0) + 1
                c.inc(1, artifact=name, status="hit")
                return self._values[key]
        with self._lane_guard(spec):
            with self._entry_lock(key):
                # Double-check: the thread we waited on may have fit it.
                with self._lock:
                    if key in self._values:
                        self._hits[name] = self._hits.get(name, 0) + 1
                        c.inc(1, artifact=name, status="hit")
                        return self._values[key]
                c.inc(1, artifact=name, status="miss")
                with obs.span("nuisance_fit", artifact=name):
                    value = spec.fit(self)
                event = None
                if self._device is not None:
                    # The fit has enqueued its kernels on this thread's
                    # stream; consumers on other streams wait on this
                    # event. The cache holds the value for the whole run,
                    # so the caching allocator cannot reuse its memory
                    # while a consumer's stream may still read it.
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self._device))
                with self._lock:
                    self._misses[name] = self._misses.get(name, 0) + 1
                    self._values[key] = value
                    if event is not None:
                        self._events[key] = event
                return value

    def stats(self) -> dict[str, dict[str, int]]:
        """``{"hits": {...}, "misses": {...}}`` by artifact name."""
        with self._lock:
            return {"hits": dict(self._hits), "misses": dict(self._misses)}
