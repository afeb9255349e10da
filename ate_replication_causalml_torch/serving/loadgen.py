"""Deterministic load-replay harness for the CATE daemon.

Port of ``ate_replication_causalml_tpu/serving/loadgen.py``: the same
schedules, payloads and records. Open-loop traffic with a fully seeded
schedule: the arrival process (exponential inter-arrival gaps, a
Poisson process at the offered rate), the bucket mix (weighted row-count
draws) and the query payloads are pure functions of the seed
(``np.random.default_rng``), so the same seed replays the identical
request stream (ids, timing, bytes) in either package, against any
daemon. That buys:

* **regression comparison**: two daemon builds measured under the same
  seed saw the same offered load;
* **chaos coordination**: the ``serve:`` chaos scope selects faults by a
  pure hash of the request id, and the schedule's ids are deterministic
  (``{prefix}{index}``), so a chaos replay faults the same requests
  every run.

Open loop: requests are submitted at their scheduled time, not when the
previous reply lands, so overload shows as queue growth and admission
rejects instead of silently throttled offered load.

:func:`run_inprocess` drives an in-process :class:`~.daemon.CateServer`
(``replies``, when given, receives every resolved request, so a caller
can hold each answer to the model version it names);
:func:`run_wire` drives a TCP or stdio daemon through
:class:`~.client.CateClient` connections.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Sequence

import numpy as np

from ate_replication_causalml_torch.resilience.deadline import Budget

#: default offered rate — fast enough to exercise coalescing at micro
#: scale without turning the bench into a sleep festival.
DEFAULT_RATE_HZ = 2000.0
DEFAULT_MIX = "1:4,8:2,32:1"


@dataclasses.dataclass(frozen=True)
class ScheduledRequest:
    """One planned request: when it is offered, under what id, with how
    many rows, against which fleet model ("" = the daemon's default)."""

    index: int
    request_id: str
    t_s: float
    rows: int
    model: str = ""


def parse_mix(spec: str) -> tuple[tuple[int, float], ...]:
    """Parse a bucket-mix spec: ``"1:4,8:2,32:1"`` (rows:weight) or
    ``"1,8,32"`` (equal weights). Weights need not normalize."""
    out: list[tuple[int, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        rows_s, _, weight_s = part.partition(":")
        try:
            rows = int(rows_s)
            weight = float(weight_s) if weight_s else 1.0
        except ValueError as e:
            raise ValueError(f"bad mix entry {part!r} in {spec!r}") from e
        if rows < 1 or weight <= 0:
            raise ValueError(f"bad mix entry {part!r} in {spec!r}")
        out.append((rows, weight))
    if not out:
        raise ValueError(f"empty mix spec {spec!r}")
    return tuple(out)


def build_schedule(
    seed: int,
    requests: int,
    rate_hz: float = DEFAULT_RATE_HZ,
    mix: str | Sequence[tuple[int, float]] = DEFAULT_MIX,
    id_prefix: str = "r",
    models: Sequence[str] | None = None,
) -> list[ScheduledRequest]:
    """The deterministic open-loop schedule: same seed ⇒ identical
    ``(id, t_s, rows, model)`` tuples (pinned by a tier-1 test). Draw
    order is fixed (all gaps first, then all row counts, then, only
    when ``models`` is given, the model assignment), so adding a new
    randomized field later cannot reshuffle existing ones."""
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    entries = parse_mix(mix) if isinstance(mix, str) else tuple(mix)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=requests)
    arrivals = np.cumsum(gaps)
    weights = np.asarray([w for _, w in entries], dtype=np.float64)
    rows = rng.choice(
        np.asarray([r for r, _ in entries], dtype=np.int64),
        size=requests, p=weights / weights.sum(),
    )
    if models:
        model_ids = list(models)
        picks = rng.integers(0, len(model_ids), size=requests)
        assigned = [model_ids[int(k)] for k in picks]
    else:
        assigned = [""] * requests
    return [
        ScheduledRequest(
            index=i,
            request_id=f"{id_prefix}{i}",
            t_s=float(arrivals[i]),
            rows=int(rows[i]),
            model=assigned[i],
        )
        for i in range(requests)
    ]


def build_queries(
    seed: int, schedule: Sequence[ScheduledRequest], features: int
) -> list[np.ndarray]:
    """Deterministic float32 query payloads matching the schedule's row
    counts. A separate derived seed keeps payload bytes independent of
    schedule-shape draws (changing the mix does not change row
    values row-for-row)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x9E3779B9)))
    return [
        rng.normal(size=(s.rows, features)).astype(np.float32)
        for s in schedule
    ]


#: mid-stream distribution shifts :func:`apply_shift` knows how to
#: stage (the statistical-health plane's drift proof).
SHIFT_KINDS = ("covariate", "checkpoint")


def apply_shift(
    schedule: Sequence[ScheduledRequest],
    queries: Sequence[np.ndarray],
    *,
    shift_at: int,
    shift_kind: str = "covariate",
    shift_model: str | None = None,
    shift_delta: float = 2.5,
) -> tuple[list[ScheduledRequest], list[np.ndarray]]:
    """Stage a deterministic mid-stream distribution shift: a pure
    post-transform of an already-built ``(schedule, queries)`` pair
    that leaves every request BEFORE ``shift_at`` byte-identical to the
    unshifted build of the same seed, so a shifted and an unshifted
    replay share a prefix and the drift detector's flip is attributable
    to the shift alone.

    ``covariate``
        adds ``shift_delta`` to feature column 0 of every query from
        ``shift_at`` on (copies; the inputs are never mutated) — moves
        the covariate-mean AND, through the propensity column, the
        propensity channel.
    ``checkpoint``
        rebinds every request from ``shift_at`` on to ``shift_model``
        (a different served model id) — the served-CATE channel of the
        TARGET model sees a different query population, the
        traffic-shape analogue of a checkpoint swap.
    """
    if shift_kind not in SHIFT_KINDS:
        raise ValueError(
            f"shift_kind must be one of {SHIFT_KINDS}, got {shift_kind!r}"
        )
    if not 0 <= shift_at <= len(schedule):
        raise ValueError(
            f"shift_at must be in [0, {len(schedule)}], got {shift_at}"
        )
    if shift_kind == "checkpoint" and not shift_model:
        raise ValueError("shift_kind='checkpoint' needs shift_model")
    out_sched = list(schedule)
    out_queries = list(queries)
    for i in range(shift_at, len(schedule)):
        if shift_kind == "covariate":
            q = out_queries[i].copy()
            q[:, 0] += np.float32(shift_delta)
            out_queries[i] = q
        else:
            out_sched[i] = dataclasses.replace(
                out_sched[i], model=shift_model
            )
    return out_sched, out_queries


def _percentiles(latencies_s: list[float]) -> dict:
    from ate_replication_causalml_torch.observability.serving_report import (
        index_quantile,
    )

    s = sorted(latencies_s)
    return {
        "p50_s": index_quantile(s, 0.50),
        "p90_s": index_quantile(s, 0.90),
        "p99_s": index_quantile(s, 0.99),
        "max_s": s[-1],
        "mean_s": sum(s) / len(s),
    }


def _record(
    schedule: Sequence[ScheduledRequest],
    latencies_s: list[float],
    duration_s: float,
    retries: dict[str, int],
    rate_hz: float,
) -> dict:
    out = {
        "requests": len(schedule),
        "served": len(latencies_s),
        "rows_offered": int(sum(s.rows for s in schedule)),
        "offered_rate_hz": rate_hz,
        "duration_s": round(duration_s, 6),
        "achieved_rate_hz": (
            round(len(latencies_s) / duration_s, 3) if duration_s > 0 else 0.0
        ),
        "reject_retries": {k: retries[k] for k in sorted(retries)},
    }
    if any(s.model for s in schedule):
        by_model: dict[str, int] = {}
        for s in schedule:
            key = s.model or "default"
            by_model[key] = by_model.get(key, 0) + 1
        out["offered_by_model"] = {k: by_model[k] for k in sorted(by_model)}
    if latencies_s:
        out.update({
            k: round(v, 9) for k, v in _percentiles(latencies_s).items()
        })
    return out


def run_inprocess(
    server,
    schedule: Sequence[ScheduledRequest],
    queries: Sequence[np.ndarray],
    timeout_s: float = 60.0,
    max_attempts: int = 500,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    deadline_ms: float | None = None,
    replies: list | None = None,
) -> dict:
    """Replay ``schedule`` open-loop against an in-process
    :class:`~.daemon.CateServer` via :meth:`submit`: submissions are
    paced by the schedule, never by replies. Typed retryable rejects
    (overload backpressure, chaos faults, degraded windows) are retried
    under the SAME id after the server's hint, exactly like a polite
    production client; ``bad_request`` raises (a schedule that offends
    the daemon's contract is a harness bug, not load). ``deadline_ms``
    stamps every submission with that remaining budget; requests the
    server expires are counted into the record's ``deadline_expired``
    (typed, pre-dispatch: the overload contract under test, never a
    harness failure). ``replies``, when given, receives every served
    request's resolved :class:`~.coalescer.PendingRequest`, in
    submission order."""
    from ate_replication_causalml_torch.serving.daemon import RejectedRequest

    t0 = clock()
    pending = []
    retries: dict[str, int] = {}
    expired = 0
    for sched, q in zip(schedule, queries):
        delay = t0 + sched.t_s - clock()
        if delay > 0:
            sleep(delay)
        # ONE end-to-end budget a request (the wire client's
        # discipline): every retry stamps the REMAINING budget.
        req_budget = (
            None if deadline_ms is None
            else Budget.from_ms(deadline_ms, clock=clock)
        )
        for _ in range(max_attempts):
            if req_budget is not None and req_budget.expired():
                expired += 1
                break
            try:
                pending.append(
                    server.submit(sched.request_id, q,
                                  model=sched.model or None,
                                  deadline_ms=(
                                      None if req_budget is None
                                      else req_budget.remaining_ms()))
                )
                break
            except RejectedRequest as rej:
                if rej.code in ("bad_request", "unknown_model",
                                "retired_model"):
                    # Terminal: a schedule that offends the daemon's
                    # contract (or targets a gone model) is a harness
                    # bug, not load.
                    raise
                if rej.code == "deadline_exceeded":
                    # The caller's budget is gone: count and move on;
                    # the open-loop schedule never blocks on it.
                    expired += 1
                    break
                retries[rej.code] = retries.get(rej.code, 0) + 1
                sleep(rej.retry_after_s or 0.002)
        else:
            raise RuntimeError(
                f"no progress on {sched.request_id} after "
                f"{max_attempts} attempts"
            )
    latencies: list[float] = []
    for req in pending:
        if not req.wait(timeout_s):
            raise TimeoutError(f"request {req.request_id} never served")
        if req.error is not None:
            if (
                isinstance(req.error, RejectedRequest)
                and req.error.code == "deadline_exceeded"
            ):
                expired += 1
                continue
            raise req.error
        latencies.append(req.resolved_mono - req.enqueued_mono)
        if replies is not None:
            replies.append(req)
    duration = clock() - t0
    offered = len(schedule) / schedule[-1].t_s if schedule[-1].t_s > 0 else 0.0
    record = _record(schedule, latencies, duration, retries,
                     round(offered, 3))
    if deadline_ms is not None:
        record["deadline_ms"] = deadline_ms
        record["deadline_expired"] = expired
    return record


def run_wire(
    client_factory: Callable[[], object],
    schedule: Sequence[ScheduledRequest],
    queries: Sequence[np.ndarray],
    concurrency: int = 8,
    max_retries: int = 64,
    close_clients: bool = True,
    deadline_ms: float | None = None,
) -> dict:
    """Replay ``schedule`` against a live daemon over the wire.
    ``concurrency`` connections (one :class:`CateClient` each — the
    client is not thread-safe) pull due requests from the shared
    schedule; each blocks on its own round-trip, so pacing holds as
    long as in-flight requests stay under ``concurrency`` (reported
    offered-vs-achieved rate shows when it did not). Pass
    ``close_clients=False`` when the factory hands out a borrowed
    client the caller still needs (the stdio transport's single
    pipe)."""
    from ate_replication_causalml_torch.serving.client import (
        ServingUnavailable,
    )

    lock = threading.Lock()
    next_idx = [0]
    latencies: list[float] = []
    errors: list[BaseException] = []
    retries: dict[str, int] = {}
    expired = [0]
    t0 = time.monotonic()

    def worker() -> None:
        client = client_factory()
        try:
            while True:
                with lock:
                    i = next_idx[0]
                    if i >= len(schedule):
                        return
                    next_idx[0] = i + 1
                sched = schedule[i]
                delay = t0 + sched.t_s - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                sent = time.monotonic()
                try:
                    client.predict(
                        queries[i], request_id=sched.request_id,
                        max_retries=max_retries,
                        model=sched.model or None,
                        deadline_ms=deadline_ms,
                    )
                except ServingUnavailable as e:
                    if e.code == "deadline_exceeded":
                        # Typed pre-dispatch expiry under a finite
                        # deadline: the contract under test.
                        with lock:
                            expired[0] += 1
                        continue
                    with lock:
                        errors.append(e)
                    return
                except BaseException as e:
                    with lock:
                        errors.append(e)
                    return
                lat = time.monotonic() - sent
                with lock:
                    latencies.append(lat)
        finally:
            # Fold this connection's absorbed retryable rejects into
            # the run record: reject_retries == {} means no backpressure.
            counts = getattr(client, "retry_counts", {})
            with lock:
                for code, n in counts.items():
                    retries[code] = retries.get(code, 0) + n
            if close_clients:
                try:
                    client.close()
                except OSError:
                    pass

    threads = [
        threading.Thread(target=worker, name=f"loadgen-{i}", daemon=True)
        for i in range(max(1, min(concurrency, len(schedule))))
    ]
    for t in threads:
        t.start()
    for t in threads:
        # Bounded joins: a wedged worker shows up as a visible wait
        # loop, never an unbounded block.
        while t.is_alive():
            t.join(1.0)
    if errors:
        raise errors[0]
    duration = time.monotonic() - t0
    offered = len(schedule) / schedule[-1].t_s if schedule[-1].t_s > 0 else 0.0
    record = _record(schedule, latencies, duration, retries,
                     round(offered, 3))
    if deadline_ms is not None:
        record["deadline_ms"] = deadline_ms
        record["deadline_expired"] = expired[0]
    return record
