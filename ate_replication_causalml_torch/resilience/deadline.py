"""The shared wall-clock budget type.

Port of ``ate_replication_causalml_tpu/resilience/deadline.py``. The
serving daemon turns the predict header's optional ``deadline_ms`` (the
client stamps its REMAINING budget at send time) into a :class:`Budget`
at admission; the request carries it through the coalescer, and it is
checked at every hand-off (admission, batch close, dispatch pickup), so
an expired request is a typed retryable ``deadline_exceeded`` reject
before it reaches the card. The client caps its backoff sleeps by the
same budget.

The clock is injectable, so deadline arithmetic is testable without
sleeping, and monotonic: a wall-clock jump never expires (or revives) a
budget.
"""

from __future__ import annotations

import time
from typing import Callable


class Budget:
    """A monotonic wall-clock budget: "this work is worthless after
    ``expires_mono``". Pure reads; the expiry instant is immutable, so no
    lock is needed."""

    __slots__ = ("expires_mono", "total_s", "_clock")

    def __init__(self, expires_mono: float, total_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.expires_mono = float(expires_mono)
        #: the originally granted span (reporting only; None when built
        #: from a bare expiry instant).
        self.total_s = total_s
        self._clock = clock

    @classmethod
    def after(cls, seconds: float, clock: Callable[[], float] = time.monotonic) -> "Budget":
        """A budget expiring ``seconds`` from now (the drain form)."""
        seconds = float(seconds)
        return cls(clock() + seconds, total_s=seconds, clock=clock)

    @classmethod
    def from_ms(cls, ms: float, clock: Callable[[], float] = time.monotonic) -> "Budget":
        """A budget from a wire ``deadline_ms`` field. Raises
        ``ValueError`` (or ``TypeError``) on non-numeric input, so the
        admission layer can reject it typed."""
        return cls.after(float(ms) / 1e3, clock=clock)

    def remaining_s(self) -> float:
        """Seconds left (negative once expired)."""
        return self.expires_mono - self._clock()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def affords(self, seconds: float) -> bool:
        """Whether ``seconds`` of work or sleep fits strictly inside the
        remaining budget."""
        return self.remaining_s() > float(seconds)

    def __repr__(self) -> str:  # pragma: no cover (debugging aid)
        return f"Budget(remaining={self.remaining_s():.6f}s)"
