"""Heartbeat liveness for the sweep engine's lanes and the serving
daemon's dispatcher.

Port of ``ate_replication_causalml_tpu/resilience/watchdog.py``: the
per-lane staleness bound read from the environment
(``ATE_TPU_WATCHDOG_<LANE>_S``; <= 0 or unset = unwatched), the registry
every lane stamps around each unit of work, and the :class:`Watchdog`
that evaluates the registry's ages against the bounds. The sweep
engine's own monitor thread reads the ages when it reports a stall; the
serving daemon runs a :class:`Watchdog` over its dispatcher lane, whose
stall episode degrades the daemon and whose recovery reloads it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry

#: env prefix for per-lane staleness bounds: ``ATE_TPU_WATCHDOG_<LANE>_S``
#: (lane upper-cased, any other character → ``_``).
ENV_PREFIX = "ATE_TPU_WATCHDOG_"

#: default watchdog poll cadence (seconds); ``ATE_TPU_WATCHDOG_POLL_MS``
#: overrides. The poll bounds detection latency only: the age is
#: measured from the stamp.
DEFAULT_POLL_S = 0.25


def _env_name(lane: str) -> str:
    return ENV_PREFIX + "".join(c if c.isalnum() else "_" for c in lane.upper()) + "_S"


def lane_bound_s(lane: str, default: float = 0.0) -> float:
    """The staleness bound for ``lane``: ``ATE_TPU_WATCHDOG_<LANE>_S`` if
    set, else ``default``. A malformed value raises when read: a watchdog
    that silently watches nothing is worse than none."""
    raw = os.environ.get(_env_name(lane), "").strip()
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError as e:
        raise ValueError(f"{_env_name(lane)}={raw!r} is not a number of seconds") from e


def poll_s_from_env(default: float = DEFAULT_POLL_S) -> float:
    raw = os.environ.get(ENV_PREFIX + "POLL_MS", "").strip()
    if not raw:
        return float(default)
    try:
        return float(raw) / 1e3
    except ValueError as e:
        raise ValueError(f"{ENV_PREFIX}POLL_MS={raw!r} is not a number of ms") from e


class HeartbeatRegistry:
    """Last-heartbeat instants per lane. ``beat`` is one lock and one
    float store, cheap enough to stamp around every node."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._beats: dict[str, float] = {}

    def beat(self, lane: str) -> None:
        now = self._clock()
        with self._lock:
            self._beats[lane] = now

    def clear(self, lane: str) -> None:
        """Retire a lane (clean shutdown): a stopped lane is absent, not
        stalled."""
        with self._lock:
            self._beats.pop(lane, None)

    def lanes(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._beats))

    def age(self, lane: str, now: float | None = None) -> float | None:
        """The lane's heartbeat age, None for a lane that never beat (or
        was cleared)."""
        with self._lock:
            beat = self._beats.get(lane)
        if beat is None:
            return None
        return (self._clock() if now is None else now) - beat

    def ages(self, now: float | None = None) -> dict[str, float]:
        """Per-lane heartbeat ages: the ``/healthz`` body and the stall
        diagnostic's raw material."""
        now = self._clock() if now is None else now
        with self._lock:
            beats = dict(self._beats)
        return {lane: now - beat for lane, beat in sorted(beats.items())}


class Watchdog:
    """Evaluates one :class:`HeartbeatRegistry` against per-lane bounds.

    :meth:`check` is the pure core (call it with an injected ``now`` in
    tests); :meth:`start` runs it on a daemon thread every ``poll_s``. A
    lane whose age crosses its bound starts a stall episode:
    ``watchdog_stalls_total{lane}`` counts it once, a ``watchdog_stall``
    event carries the age and ``on_stall`` runs; the lane's next beat
    ends the episode (``watchdog_recovered``, ``on_recover``). Callbacks
    run outside the internal lock, once an episode."""

    def __init__(self, heartbeats: HeartbeatRegistry, bounds: dict[str, float], *,
                 clock: Callable[[], float] = time.monotonic, poll_s: float | None = None,
                 on_stall: Callable[[str, float], None] | None = None,
                 on_recover: Callable[[str, float], None] | None = None):
        self.heartbeats = heartbeats
        #: lane -> staleness bound (seconds); <= 0 means unwatched.
        self.bounds = {k: float(v) for k, v in bounds.items()}
        self._clock = clock
        self.poll_s = poll_s_from_env() if poll_s is None else float(poll_s)
        self._on_stall = on_stall
        self._on_recover = on_recover
        self._lock = threading.Lock()
        self._stalled: dict[str, float] = {}  # lane -> stall-start mono
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stalls = _registry.counter("watchdog_stalls_total",
                                         "watchdog-detected lane stall episodes")
        self._stalls.inc(0)

    def bound_for(self, lane: str) -> float:
        """The lane's bound, else that of its first ``/``-segment
        (``worker/sweep-worker-3`` → ``worker``), else 0 (unwatched)."""
        if lane in self.bounds:
            return self.bounds[lane]
        return self.bounds.get(lane.split("/", 1)[0], 0.0)

    def check(self, now: float | None = None) -> list[str]:
        """One evaluation pass; returns the lanes that newly stalled, and
        ends the episodes of lanes that have beaten since."""
        now = self._clock() if now is None else now
        ages = self.heartbeats.ages(now)
        newly: list[tuple[str, float]] = []
        recovered: list[tuple[str, float]] = []
        with self._lock:
            for lane, age in ages.items():
                bound = self.bound_for(lane)
                stalled_since = self._stalled.get(lane)
                if bound > 0.0 and age > bound:
                    if stalled_since is None:
                        self._stalled[lane] = now
                        newly.append((lane, age))
                elif stalled_since is not None:
                    del self._stalled[lane]
                    recovered.append((lane, now - stalled_since))
            for lane in list(self._stalled):  # a cleared lane ends silently
                if lane not in ages:
                    del self._stalled[lane]
        for lane, age in newly:
            self._stalls.inc(1, lane=lane)
            _events.emit("watchdog_stall", status="error", lane=lane,
                         age_s=round(age, 6), bound_s=self.bound_for(lane))
            if self._on_stall is not None:
                self._on_stall(lane, age)
        for lane, stalled_s in recovered:
            _events.emit("watchdog_recovered", status="ok", lane=lane,
                         stalled_s=round(stalled_s, 6))
            if self._on_recover is not None:
                self._on_recover(lane, stalled_s)
        return [lane for lane, _ in newly]

    def stalled(self) -> tuple[str, ...]:
        """Lanes currently inside a stall episode."""
        with self._lock:
            return tuple(sorted(self._stalled))

    def is_stalled(self, lane: str) -> bool:
        with self._lock:
            return lane in self._stalled

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            t = self._thread = threading.Thread(target=self._run, name="watchdog",
                                                daemon=True)
        t.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def stop(self, timeout: float | None = 5.0) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
