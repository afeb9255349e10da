"""Heartbeat liveness for the sweep engine's lanes.

Port of the part of ``ate_replication_causalml_tpu/resilience/watchdog.py``
the engine uses: the per-lane staleness bound read from the environment
(``ATE_TPU_WATCHDOG_<LANE>_S``; <= 0 or unset = unwatched) and the
registry every worker stamps around each unit of work. The engine's own
monitor thread reads the registry's ages when it reports a stall. The
standalone ``Watchdog`` class (stall episodes, callbacks, the
``ATE_TPU_WATCHDOG_POLL_MS`` cadence it polls at) is not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

#: env prefix for per-lane staleness bounds: ``ATE_TPU_WATCHDOG_<LANE>_S``
#: (lane upper-cased, any other character → ``_``).
ENV_PREFIX = "ATE_TPU_WATCHDOG_"


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

    def ages(self, now: float | None = None) -> dict[str, float]:
        """Per-lane heartbeat ages, the stall diagnostic's raw material."""
        now = self._clock() if now is None else now
        with self._lock:
            beats = dict(self._beats)
        return {lane: now - beat for lane, beat in sorted(beats.items())}
