"""Structured event log.

Port of ``ate_replication_causalml_tpu/observability/events.py``:
span-shaped records (name, start and end in monotonic and wall time,
status, attributes, parent span) kept in memory and exported as
``events.jsonl`` (:meth:`EventLog.to_jsonl`). The sweep's root and stage
spans, the engine's node, commit and prefetch spans and the resilience
layer's events land here, so a reader can rebuild the run's timeline
(which worker ran what, when, what was retried or injected) without
parsing prints.

Parentage is tracked per thread; ``parent_id`` overrides it for work
handed across threads. The log is a ring (``max_events``): the oldest
records go first and are counted in :attr:`EventLog.dropped`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Iterator

from ate_replication_causalml_torch.observability.registry import SCHEMA_VERSION, enabled


class Span:
    """One open span. Mutate ``attrs`` / call :meth:`set_status` inside
    the ``with`` block; the record is appended on exit. Status defaults
    to ``ok`` (``error`` when an exception leaves the block)."""

    __slots__ = ("name", "span_id", "parent_id", "status", "attrs", "start_unix",
                 "start_mono", "thread", "thread_name")

    def __init__(self, name: str, span_id: str, parent_id: str | None, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.status = "ok"
        self.attrs = attrs
        self.start_unix = time.time()
        self.start_mono = time.monotonic()
        self.thread = threading.get_ident()
        self.thread_name = threading.current_thread().name

    def set_status(self, status: str) -> None:
        self.status = status

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def _record(self, end_mono: float, end_unix: float) -> dict:
        return {
            "name": self.name, "span_id": self.span_id, "parent_id": self.parent_id,
            "status": self.status, "start_unix": self.start_unix, "end_unix": end_unix,
            "start_mono_s": self.start_mono, "end_mono_s": end_mono,
            "dur_s": end_mono - self.start_mono, "thread": self.thread,
            "thread_name": self.thread_name, "attrs": self.attrs,
        }


class EventLog:
    """Thread-safe in-memory span/event collector."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = max_events
        self._lock = threading.Lock()
        self._records: collections.deque[dict] = collections.deque(maxlen=max_events)
        self._dropped = 0
        self._ids = itertools.count(1)
        self._tls = threading.local()

    def _next_id(self) -> str:
        return f"{next(self._ids):08x}"

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, rec: dict) -> None:
        if not enabled():
            return
        with self._lock:
            if len(self._records) == self.max_events:
                self._dropped += 1  # the deque evicts the oldest record
            self._records.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, parent_id: str | None = None, **attrs) -> Iterator[Span]:
        """Open a span; its record lands in the log when the block exits.
        An exception marks it ``error`` (its type in the attrs) and
        propagates."""
        stack = self._stack()
        if parent_id is None:
            parent_id = stack[-1].span_id if stack else None
        sp = Span(name, self._next_id(), parent_id, dict(attrs))
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.status = "error"
            sp.attrs.setdefault("error_type", type(e).__name__)
            raise
        finally:
            stack.pop()
            self._append(sp._record(time.monotonic(), time.time()))

    def emit(self, name: str, status: str = "event", **attrs) -> None:
        """Zero-duration point event (parented like a span)."""
        stack = self._stack()
        sp = Span(name, self._next_id(), stack[-1].span_id if stack else None, dict(attrs))
        sp.status = status
        self._append(sp._record(sp.start_mono, sp.start_unix))

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0

    def to_jsonl(self) -> str:
        """The events.jsonl payload: a versioned header line, then one
        record per line in arrival order."""
        header = {"schema_version": SCHEMA_VERSION, "kind": "events_header",
                  "dropped": self.dropped}
        lines = [json.dumps(header)] + [json.dumps(r) for r in self.records()]
        return "\n".join(lines) + "\n"


#: The process-global default event log.
EVENTS = EventLog()


def span(name: str, parent_id: str | None = None, **attrs):
    return EVENTS.span(name, parent_id=parent_id, **attrs)


def emit(name: str, status: str = "event", **attrs) -> None:
    EVENTS.emit(name, status=status, **attrs)
