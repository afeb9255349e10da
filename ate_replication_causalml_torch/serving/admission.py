"""Admission control and the daemon lifecycle.

Port of ``ate_replication_causalml_tpu/serving/admission.py`` (pure
Python, so its decisions are the JAX package's):

* :class:`AdmissionController`: a bounded in-flight request count. Past
  ``max_depth`` new work is REJECTED with a typed retry-after instead of
  queued, an explicit backpressure signal. Depth is requests, not rows;
  the row budget is the coalescer's bucket plan.
* :class:`ServingLifecycle`: the ``starting → serving ⇄ degraded →
  draining → stopped`` state machine. Transitions are explicit and
  invalid ones raise. ``draining`` is the graceful-shutdown window:
  admission rejects new work typed, in-flight batches complete.
* :class:`ReloadSupervisor`: degraded-mode recovery. Concurrent fault
  reports coalesce into ONE reload (first reporter wins), the reload
  re-verifies the checkpoint before any swap, and a failed reload
  leaves the lifecycle DEGRADED: a corrupt checkpoint never goes back
  into service. The reload callable is injected, so the state machine is
  testable with stubs. The JAX package's zero-downtime ``rotate`` comes
  with rotation, which is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Callable

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry

#: Lifecycle states.
STARTING = "starting"
SERVING = "serving"
DEGRADED = "degraded"
DRAINING = "draining"
STOPPED = "stopped"


class InvalidTransition(RuntimeError):
    """A lifecycle method was called from a state it is not legal in."""


class AdmissionController:
    """Bounded in-flight request count with reject-on-overload."""

    def __init__(self, max_depth: int):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        self._depth = 0
        self._gauge = _registry.gauge(
            "serving_queue_depth", "admitted in-flight serving requests"
        )

    def try_admit(self) -> bool:
        """Admit one request, or refuse (caller rejects typed —
        ``overloaded`` + retry-after). Never blocks."""
        with self._lock:
            if self._depth >= self.max_depth:
                return False
            self._depth += 1
            depth = self._depth
        self._gauge.set(depth)
        return True

    def release(self) -> None:
        with self._lock:
            if self._depth <= 0:
                raise RuntimeError("release() without a matching admit")
            self._depth -= 1
            depth = self._depth
        self._gauge.set(depth)

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth


class ServingLifecycle:
    """The daemon's state machine; every transition is an event."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = STARTING
        self._fault_count = 0
        self._reload_count = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def can_serve(self) -> bool:
        return self.state == SERVING

    def _transition(self, to: str, allowed: tuple[str, ...]) -> None:
        with self._lock:
            if self._state not in allowed:
                raise InvalidTransition(
                    f"cannot move {self._state!r} -> {to!r} "
                    f"(legal from: {', '.join(allowed)})"
                )
            frm, self._state = self._state, to
        _events.emit("serving_state", status="ok", frm=frm, to=to)

    def mark_ready(self) -> None:
        """Startup complete (checkpoint verified, executables compiled,
        warm dispatches done): STARTING → SERVING."""
        self._transition(SERVING, (STARTING,))

    def mark_fault(self, reason: str) -> bool:
        """Report a serving fault. Returns True to exactly one caller —
        the one that moved SERVING → DEGRADED and therefore owns
        recovery; concurrent reporters (and reports while already
        degraded) get False and must only reject-with-retry-after."""
        with self._lock:
            self._fault_count += 1
            if self._state != SERVING:
                return False
            self._state = DEGRADED
        _events.emit("serving_state", status="error", frm=SERVING,
                     to=DEGRADED, reason=reason)
        return True

    def mark_recovered(self) -> None:
        """Recovery verified: DEGRADED → SERVING."""
        self._transition(SERVING, (DEGRADED,))  # raises before counting
        with self._lock:
            self._reload_count += 1

    def mark_draining(self) -> bool:
        """Begin graceful drain: legal from any live state
        (a degraded or still-starting daemon can be told to go away
        too). Returns True to exactly one caller — the one that moved
        the lifecycle into DRAINING and therefore owns the drain;
        concurrent calls (and calls once stopped) get False."""
        with self._lock:
            if self._state in (DRAINING, STOPPED):
                return False
            frm, self._state = self._state, DRAINING
        _events.emit("serving_state", status="ok", frm=frm, to=DRAINING)
        return True

    def mark_stopped(self) -> None:
        """Terminal from any state (idempotent — a double stop is not
        an error worth crashing a shutdown path over)."""
        with self._lock:
            if self._state == STOPPED:
                return
            frm, self._state = self._state, STOPPED
        _events.emit("serving_state", status="ok", frm=frm, to=STOPPED)

    @property
    def fault_count(self) -> int:
        with self._lock:
            return self._fault_count

    @property
    def reload_count(self) -> int:
        with self._lock:
            return self._reload_count


class ReloadSupervisor:
    """Owns degraded-mode recovery: one reload at a time, verified
    before the swap, a failure stays degraded.

    ``reload_fn`` re-loads AND re-verifies the model source (the daemon
    wires the SHA-256-verified ``load_fitted``); ``on_reloaded``
    installs the result. ``inline=True`` runs recovery on the reporting
    thread (deterministic tests); the daemon uses a background thread,
    so the request path only ever sees typed rejects, never a reload's
    latency."""

    def __init__(
        self,
        lifecycle: ServingLifecycle,
        reload_fn: Callable[[], object],
        on_reloaded: Callable[[object], None],
        inline: bool = False,
    ):
        self._lifecycle = lifecycle
        self._reload_fn = reload_fn
        self._on_reloaded = on_reloaded
        self._inline = inline
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        # Single-flight guard: exactly one reload may be in flight. Set
        # under ONE lock acquisition before any spawn (a check-then-act
        # split across acquisitions would let report_fault and retry()
        # race each other into two concurrent reloads, the loser dying
        # on the DEGRADED->SERVING double-transition).
        self._running = False
        self._counter = _registry.counter(
            "serving_reloads_total", "degraded-mode reload attempts by status"
        )

    def _try_begin(self) -> bool:
        with self._lock:
            if self._running:
                return False
            self._running = True
            return True

    def _launch(self, reason: str) -> None:
        """Caller holds the single-flight claim (_try_begin)."""
        if self._inline:
            self._run(reason)
            return
        with self._lock:
            t = threading.Thread(
                target=self._run, args=(reason,),
                name="serving-reload", daemon=True,
            )
            self._thread = t
        t.start()

    def report_fault(self, reason: str) -> bool:
        """Fault entry point for the request path. Returns True when
        this report triggered recovery (it coalesces otherwise)."""
        if not self._lifecycle.mark_fault(reason):
            return False
        if not self._try_begin():
            # A recovery is already in flight (e.g. an operator retry);
            # this fault report coalesces into it.
            return False
        self._launch(reason)
        return True

    def join(self, timeout: float | None = None) -> None:
        """Wait for an in-flight background recovery (tests and
        shutdown; no-op inline or when none ran)."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)

    def _run(self, reason: str) -> None:
        recovered = False
        try:
            with _events.span("serving_reload", reason=reason) as sp:
                try:
                    obj = self._reload_fn()
                    self._on_reloaded(obj)
                except Exception as e:
                    # The typed refusal path: the lifecycle STAYS
                    # degraded (requests keep getting retry-after), the
                    # failure is recorded, and the next retry() may try
                    # again — a corrupt checkpoint must never rotate
                    # into service.
                    sp.set_status("error")
                    self._counter.inc(1, status="failed")
                    _events.emit(
                        "serving_reload_failed", status="error",
                        reason=reason, error=f"{type(e).__name__}: {e}",
                    )
                    return
                self._counter.inc(1, status="reloaded")
                self._lifecycle.mark_recovered()
                recovered = True
        finally:
            with self._lock:
                self._running = False
            # A fault reported between mark_recovered and the claim
            # release found the lifecycle SERVING (it owns recovery)
            # but the claim still held (its launch coalesced into
            # nothing) — pick that orphaned recovery up now. Only
            # after a SUCCESSFUL run: a failed reload staying degraded
            # without relaunching is the deliberate refusal contract.
            if recovered and self._lifecycle.state == DEGRADED:
                self.retry()

    def retry(self) -> bool:
        """Explicitly retry a failed recovery (an operator action or a
        timer): runs a reload if the lifecycle is degraded and no
        recovery is in flight. Returns whether a reload ran."""
        if self._lifecycle.state != DEGRADED:
            return False
        if not self._try_begin():
            return False
        # The lifecycle can only have LEFT degraded through the reload
        # that just released the claim; re-check before spawning so a
        # retry racing a successful recovery is a no-op, not a crash.
        if self._lifecycle.state != DEGRADED:
            with self._lock:
                self._running = False
            return False
        self._launch("retry")
        return True
