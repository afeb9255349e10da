"""Request coalescer: micro-batch within a deadline window, pad to the
nearest declared bucket.

Port of ``ate_replication_causalml_tpu/serving/coalescer.py``, pure
Python, so its decisions are the JAX package's on the same arrivals. The
daemon warms one predict per declared batch size (the
:class:`BucketPlan`; on the card one CUDA graph each). Requests arrive
one at a time; the :class:`Coalescer` accumulates them FIFO and closes a
batch the moment it cannot grow (the next waiter would overflow the
largest bucket) or the moment the OLDEST waiter's window expires, so no
request waits more than ``window_s`` for co-travellers and a burst packs
densely without a timer firing.

The batch rides the smallest bucket that fits (pad rows are zeros; every
per-row aggregation of the predict is row-independent, so pad rows'
outputs are simply never sliced back).

All timing is injectable (``clock=``) and monotonic. Every closed batch
carries its close *reason* (``bucket_full`` / ``next_wont_fit`` /
``window_expired`` / ``drain``), the clock reading at close and a
sequence number; the request accumulates the remaining marks (picked up
by the dispatcher, device entry and exit, resolved) and
:meth:`PendingRequest.phase_seconds` telescopes them into the phase
breakdown whose sum is the end-to-end latency.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import threading
import time
from typing import Callable, NamedTuple

#: The per-request lifecycle phases, in timeline order. Durations are
#: differences of consecutive monotonic marks, so they telescope:
#: their sum equals ``resolved_mono - enqueued_mono`` exactly (up to
#: float rounding — the acceptance tests allow ±1 µs).
PHASES = ("coalesce_wait", "queue_wait", "dispatch", "device", "reply")

#: The batch close reasons the coalescer can report (precedence order:
#: a batch that is both full and expired closed because it was full).
CLOSE_REASONS = ("bucket_full", "next_wont_fit", "window_expired", "drain")


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The declared batch shapes the daemon warmed, ascending."""

    sizes: tuple[int, ...]

    def __post_init__(self):
        if not self.sizes:
            raise ValueError("bucket plan needs at least one batch size")
        sizes = tuple(int(s) for s in self.sizes)
        if any(s < 1 for s in sizes) or any(
            b <= a for a, b in zip(sizes, sizes[1:])
        ):
            raise ValueError(
                f"bucket sizes must be positive and strictly ascending, "
                f"got {self.sizes!r}"
            )
        object.__setattr__(self, "sizes", sizes)

    @classmethod
    def parse(cls, spec: str) -> "BucketPlan":
        """Parse the ``ATE_TPU_SERVE_BUCKETS`` form (``"1,8,64,256"``).
        Order-insensitive and duplicate-tolerant on input; the plan
        itself is canonical (sorted, deduped)."""
        try:
            sizes = sorted({int(s) for s in spec.split(",") if s.strip()})
        except ValueError as e:
            raise ValueError(f"bad bucket spec {spec!r}: {e}") from e
        return cls(tuple(sizes))

    @property
    def max_rows(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, rows: int) -> int | None:
        """Smallest declared size that fits ``rows`` (None when even the
        largest bucket is too small — the caller rejects, typed)."""
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        idx = bisect.bisect_left(self.sizes, rows)
        return None if idx == len(self.sizes) else self.sizes[idx]


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Serve-time bucket fusion: adjacent buckets of a
    :class:`BucketPlan` fuse into GROUPS, and the daemon warms ONE
    masked predict per group, at the group's max width, instead of one
    per bucket: fewer predicts (on the card, fewer CUDA graphs) a model.

    A batch that would have ridden bucket ``b`` rides its group's width
    instead, with a 0/1 row-mask marking real rows: the trailing region
    is exact zeros (masked), never garbage (pad), and the dispatcher
    back-fills it with the next pending requests of the same model
    (``Coalescer.take_fill``).

    ``groups`` partitions ``plan.sizes`` ascending; pairing walks from
    the LARGEST bucket down (``pair_adjacent``), so the big buckets
    always share and an odd count leaves the SMALLEST bucket alone."""

    plan: BucketPlan
    groups: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        flat = [s for g in self.groups for s in g]
        if tuple(flat) != self.plan.sizes:
            raise ValueError(
                f"groups {self.groups!r} must partition the plan's "
                f"sizes {self.plan.sizes!r} in ascending order"
            )

    @classmethod
    def pair_adjacent(cls, plan: BucketPlan) -> "FusionPlan":
        sizes = list(plan.sizes)
        groups: list[tuple[int, ...]] = []
        while sizes:
            take = sizes[-2:] if len(sizes) >= 2 else sizes[-1:]
            groups.insert(0, tuple(take))
            del sizes[-len(take):]
        return cls(plan, tuple(groups))

    @property
    def widths(self) -> tuple[int, ...]:
        """One predict width per group (the group max), ascending."""
        return tuple(g[-1] for g in self.groups)

    def width_for(self, bucket: int) -> int:
        """The fused predict width a ``bucket`` batch dispatches on."""
        for g in self.groups:
            if bucket in g:
                return g[-1]
        raise ValueError(f"bucket {bucket} is not in the plan")


class PendingRequest:
    """One admitted request travelling through the coalescer. The
    producer blocks on :meth:`wait`; the dispatcher fills exactly one of
    ``result`` / ``error`` and fires the event. Timing marks are
    monotonic; the lifecycle marks (batch close, dispatcher pickup,
    device entry/exit) are stamped as the request travels and feed the
    per-phase latency decomposition . All marks are written
    before the done-event publication and only read after it — the
    event is the memory barrier, so the marks need no lock."""

    __slots__ = (
        "request_id", "x", "rows", "enqueued_mono", "resolved_mono",
        "batch_closed_mono", "picked_mono", "device_start_mono",
        "device_end_mono", "batch_seq", "batch_bucket", "batch_fill",
        "model", "model_version", "budget", "result", "error", "_done",
    )

    def __init__(self, request_id: str, x, rows: int, enqueued_mono: float,
                 model: str = "", budget=None):
        self.request_id = request_id
        self.x = x
        self.rows = rows
        self.enqueued_mono = enqueued_mono
        #: the caller's remaining wall-clock budget (a resilience
        #: ``Budget``), or None for deadline-less requests.
        #: Checked at every hand-off: an expired request is a typed
        #: ``deadline_exceeded`` reject, never a device dispatch.
        self.budget = budget
        #: fleet routing: the model id the request bound at
        #: admission, and the model VERSION the dispatcher actually
        #: served it with — the bit-identity partition key across a
        #: hot-swap (old forest before the swap instant, new after).
        self.model = model
        self.model_version: int | None = None
        self.resolved_mono: float | None = None
        self.batch_closed_mono: float | None = None
        self.picked_mono: float | None = None
        self.device_start_mono: float | None = None
        self.device_end_mono: float | None = None
        self.batch_seq: int | None = None
        self.batch_bucket: int | None = None
        self.batch_fill: float | None = None
        self.result = None
        self.error: BaseException | None = None
        self._done = threading.Event()

    def resolve(self, result, now: float, notify: bool = True) -> None:
        """Settle the request; ``notify=False`` leaves the waiter asleep
        until :meth:`notify` (the dispatcher books a batch's phases
        between the two)."""
        self.result = result
        self.resolved_mono = now
        if notify:
            self._done.set()

    def notify(self) -> None:
        self._done.set()

    def fail(self, error: BaseException, now: float) -> None:
        self.error = error
        self.resolved_mono = now
        self._done.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def phase_seconds(self) -> dict[str, float] | None:
        """The lifecycle decomposition for a SERVED request, or None
        while unresolved / failed before full mark coverage. Phases are
        consecutive mark differences (:data:`PHASES` order), so::

            sum(phase_seconds().values()) == resolved_mono - enqueued_mono

        exactly up to float rounding — the property the acceptance
        criteria pin at ±1 µs."""
        marks = (
            self.enqueued_mono, self.batch_closed_mono, self.picked_mono,
            self.device_start_mono, self.device_end_mono,
            self.resolved_mono,
        )
        if any(m is None for m in marks):
            return None
        return {
            phase: marks[i + 1] - marks[i]
            for i, phase in enumerate(PHASES)
        }


class Batch(NamedTuple):
    """A closed batch: the requests, their real row total, the declared
    bucket it rides, the fill ratio the metrics report, plus the close
    bookkeeping (reason, clock reading, sequence number) the lifecycle
    decomposition and the serving trace are built from. ``model`` is
    the fleet routing key — a batch is model-pure by construction (one
    padded matrix dispatches against ONE forest)."""

    requests: tuple[PendingRequest, ...]
    rows: int
    bucket: int
    fill: float
    close_reason: str = "bucket_full"
    closed_mono: float = 0.0
    seq: int = 0
    model: str = ""


class Coalescer:
    """FIFO micro-batcher with a per-oldest-waiter deadline window.

    Thread model: producers call :meth:`submit`; ONE dispatcher thread
    loops on :meth:`next_batch`. All shared state lives under the
    condition's lock."""

    def __init__(
        self,
        plan: BucketPlan,
        window_s: float,
        clock: Callable[[], float] = time.monotonic,
        on_expired: Callable[[tuple[PendingRequest, ...], float], None]
        | None = None,
    ):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        self.plan = plan
        self.window_s = float(window_s)
        self._clock = clock
        #: deadline hand-off: waiters whose Budget expired
        #: are REMOVED before any batch math — an expired waiter must
        #: neither dispatch nor hold a fusing batch open via the
        #: oldest-waiter window — and handed to this callback (the
        #: daemon rejects them typed, phase="queue"). The callback runs
        #: with the condition held and must not re-enter the coalescer.
        self._on_expired = on_expired
        self._cond = threading.Condition()
        self._pending: list[PendingRequest] = []
        self._closed = False
        self._seq = itertools.count(1)

    def submit(self, req: PendingRequest) -> None:
        """Enqueue an admitted request (rows already validated against
        ``plan.max_rows`` by the admission layer; oversize here is a
        programming error and raises)."""
        if req.rows > self.plan.max_rows:
            raise ValueError(
                f"request of {req.rows} rows exceeds the largest bucket "
                f"({self.plan.max_rows}); the daemon must reject it typed"
            )
        with self._cond:
            if self._closed:
                raise RuntimeError("coalescer is closed")
            self._pending.append(req)
            self._cond.notify_all()

    def close(self) -> None:
        """Stop accepting work and wake the dispatcher; queued requests
        still drain (each remaining :meth:`next_batch` call flushes
        immediately instead of waiting out the window)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def pending_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # ── batch math ───────────────────────────────────────────────────

    def _harvest_expired(self, now: float) -> tuple[PendingRequest, ...]:
        """Remove (and report) every waiter whose deadline Budget has
        expired. Called with the condition held, at the top of every
        :meth:`next_batch` pass — BEFORE the batch math and before the
        oldest-waiter window computation, so an expired head-of-line
        waiter can neither ride a batch nor force one closed."""
        with self._cond:  # re-entrant — safe under next_batch's hold
            expired = tuple(
                r for r in self._pending
                if r.budget is not None and r.budget.expired()
            )
            if expired:
                gone = set(map(id, expired))
                self._pending = [
                    r for r in self._pending if id(r) not in gone
                ]
        if expired and self._on_expired is not None:
            self._on_expired(expired, now)
        return expired

    def _pack_due(self, now: float) -> Batch | None:
        """Close a batch if one is due. Batches are MODEL-PURE (fleet
        routing): the candidate is the FIFO prefix *of one
        model's waiters* that fits the largest bucket, with models
        visited in order of their oldest waiter — so a slow tenant's
        window wait never delays another tenant's full bucket. A
        candidate closes when (a) it IS the largest bucket, (b) that
        model's next waiter would not fit (flushing beats head-of-line
        blocking), (c) the model's oldest waiter's window expired, or
        (d) the coalescer is draining. Re-acquires the condition (an
        RLock underneath), so it is safe both from :meth:`next_batch`
        and standalone in tests. The close reason is recorded in
        precedence order (a batch that is both full and expired closed
        because it was full). With a single model this reduces exactly
        to the pre-fleet FIFO behavior."""
        with self._cond:
            visited: list[str] = []
            for head in self._pending:
                if head.model in visited:
                    continue
                visited.append(head.model)
                group = [r for r in self._pending if r.model == head.model]
                take: list[PendingRequest] = []
                total = 0
                for req in group:
                    if total + req.rows > self.plan.max_rows:
                        break
                    take.append(req)
                    total += req.rows
                expired = now - take[0].enqueued_mono >= self.window_s
                if total == self.plan.max_rows:
                    reason = "bucket_full"
                elif len(take) < len(group):
                    reason = "next_wont_fit"
                elif expired:
                    reason = "window_expired"
                elif self._closed:
                    reason = "drain"
                else:
                    continue  # this model's waiters are not due yet
                taken = set(map(id, take))
                self._pending = [
                    r for r in self._pending if id(r) not in taken
                ]
                bucket = self.plan.bucket_for(total)
                batch = Batch(tuple(take), total, bucket, total / bucket,
                              close_reason=reason, closed_mono=now,
                              seq=next(self._seq), model=head.model)
                for req in take:
                    req.batch_closed_mono = now
                    req.batch_seq = batch.seq
                    req.batch_bucket = bucket
                    req.batch_fill = batch.fill
                return batch
            return None

    def take_fill(self, model: str, capacity: int,
                  now: float) -> tuple[PendingRequest, ...]:
        """Back-fill for a FUSED dispatch: remove and return
        the FIFO prefix of ``model``'s pending requests whose rows fit
        ``capacity`` — the rows that would otherwise dispatch as masked
        zeros. Stops at the first waiter that does not fit (FIFO
        fairness: never reorder past a waiter), returns () when nothing
        is queued. The caller stamps batch marks (seq/bucket/fill) once
        the fused batch's final composition is known; only the close
        clock is stamped here."""
        if capacity < 1:
            return ()
        with self._cond:
            take: list[PendingRequest] = []
            total = 0
            for req in self._pending:
                if req.model != model:
                    continue
                if req.budget is not None and req.budget.expired():
                    # Never back-fill an expired waiter onto the device;
                    # it stays queued for the next harvest's typed
                    # reject (skipping it does not reorder live work —
                    # it was never going to dispatch).
                    continue
                if total + req.rows > capacity:
                    break
                take.append(req)
                total += req.rows
            if not take:
                return ()
            taken = set(map(id, take))
            self._pending = [
                r for r in self._pending if id(r) not in taken
            ]
            for req in take:
                req.batch_closed_mono = now
            return tuple(take)

    def next_batch(self, timeout: float | None = None) -> Batch | None:
        """Dispatcher entry: block until a batch closes, the coalescer
        is closed AND drained (returns None forever after), or
        ``timeout`` elapses (returns None; the dispatcher re-loops so a
        stop flag can be observed)."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                now = self._clock()
                self._harvest_expired(now)
                batch = self._pack_due(now)
                if batch is not None:
                    return batch
                if self._closed and not self._pending:
                    return None
                # Sleep until the oldest waiter's window would expire,
                # the caller's timeout, or a submit/close notification.
                wait = None
                if self._pending:
                    wait = self._pending[0].enqueued_mono + self.window_s - now
                    # Wake for the earliest deadline expiry too, so an
                    # expiring waiter's typed reject is not delayed by
                    # a longer coalescing window.
                    for r in self._pending:
                        if r.budget is not None:
                            wait = min(wait, r.budget.expires_mono - now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                if wait is not None and wait <= 0:
                    # The packing condition will see the expiry on the
                    # next loop iteration with a fresh clock read.
                    wait = 1e-4
                self._cond.wait(wait)
