"""Failure detection and classified retry of independent shards.

Port of the single-device part of ``ate_replication_causalml_tpu/parallel/retry.py``.
Every parallel axis of the port's forests (tree chunks, little-bag
group chunks) is stateless and carries its own keys, so recovery is
re-execution:

* :func:`probe_devices`: run a one-element add on each device, report
  the healthy subset (chaos scope ``device:drop=k`` injects here);
* :func:`run_shards`: run independent shard thunks in order with
  **classified** retry (``resilience/errors.py::classify``): transient
  failures retry after a capped exponential backoff with deterministic
  per-``(pool, shard, attempt)`` jitter; programming errors and CUDA
  errors raise at once. Repeated device-origin failures trigger a
  :func:`probe_devices` re-probe. A retried shard gives the bits the
  failed attempt would have;
* :func:`require_all`: every shard's result, or the pool's failure;
* :func:`inject_failures`: plan-based fault injection
  (``resilience/chaos.py::plan_faults``); probabilistic injection comes
  from the ``ATE_TPU_CHAOS`` shard scope, which :func:`run_shards` arms.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Sequence

import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.backoff import jittered_backoff_delay
from ate_replication_causalml_torch.resilience.errors import ChaosFault, classify

#: Device-origin failures of one pool between two re-probes.
_REPROBE_AFTER = 2


def probe_devices(devices: Sequence | None = None) -> list:
    """The subset of ``devices`` that complete a one-element add (default:
    every CUDA device, or the CPU where there is none). Failures are
    caught: detection, not a crash. Under ``ATE_TPU_CHAOS``
    ``device:drop=k`` the last ``k`` healthy devices are reported dead,
    deterministically, so they stay dead on re-probe."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    healthy = []
    for d in devices:
        try:
            if float(torch.ones((), device=d) + 1.0) == 2.0:
                healthy.append(d)
        except Exception:  # noqa: BLE001 — an unhealthy device, reported by omission
            continue
    inj = chaos.active()
    if inj is not None:
        healthy = inj.drop_devices(healthy)
    return healthy


@dataclasses.dataclass
class ShardOutcome:
    """One shard's execution."""

    index: int
    result: object = None
    attempts: int = 0
    ok: bool = False
    error: str | None = None


def backoff_delay(pool: str, shard: int, attempt: int, base_s: float) -> float:
    """Backoff before retrying ``shard``'s ``attempt``-th failure, jittered
    by a pure function of ``(pool, shard, attempt)``."""
    return jittered_backoff_delay(f"{pool}|{shard}|{attempt}", attempt, base_s)


def run_shards(
    shard_fn: Callable[[int], object],
    n_shards: int,
    max_attempts: int = 3,
    backoff_s: float = 0.25,
    pool: str = "shards",
    probe: Callable[[], list] | None = None,
) -> list[ShardOutcome]:
    """Run ``shard_fn(i)`` for every shard ``i`` in order, with
    classified retry.

    A shard that exhausts ``max_attempts`` is reported failed in its
    :class:`ShardOutcome`; the others still run (:func:`require_all`
    raises on any failure). Errors are classified
    (:func:`~..resilience.errors.classify`): transient ones retry, fatal
    ones (programming errors, CUDA errors) raise at once.
    ``KeyboardInterrupt`` is never caught.

    After every second device-origin failure of the pool (out of device
    memory, or an injected chaos fault standing for a preemption) the
    runner re-probes the devices (``probe``, default
    :func:`probe_devices`, event ``device_reprobe``).

    ``pool`` labels the telemetry: attempts, retries, failures and
    backoff-seconds counters, created at zero up front, and
    ``shard_retry`` / ``shard_failed`` / ``shard_fatal`` events.
    """
    attempts_c = obs.counter("shard_attempts_total", "run_shards attempts")
    retries_c = obs.counter("shard_retries_total", "failed attempts that will retry")
    failures_c = obs.counter("shard_failures_total", "shards that exhausted retries")
    backoff_c = obs.counter("shard_backoff_seconds_total", "backoff sleep time")
    for c in (attempts_c, retries_c, failures_c, backoff_c):
        c.inc(0, pool=pool)

    inj = chaos.active()
    if inj is not None:
        shard_fn = inj.wrap_shard(shard_fn, pool=pool)
    device_failures = 0

    outcomes = [ShardOutcome(index=i) for i in range(n_shards)]
    for out in outcomes:
        while out.attempts < max_attempts and not out.ok:
            out.attempts += 1
            attempts_c.inc(1, pool=pool)
            try:
                out.result = shard_fn(out.index)
                out.ok = True
                out.error = None
            except Exception as e:  # noqa: PERF203 — retry loop
                if classify(e) == "fatal":
                    obs.emit("shard_fatal", status="error", pool=pool, shard=out.index,
                             attempt=out.attempts, error=f"{type(e).__name__}: {e}")
                    raise
                out.error = f"{type(e).__name__}: {e}"
                if isinstance(e, (ChaosFault, torch.OutOfMemoryError)):
                    device_failures += 1
                    if device_failures >= _REPROBE_AFTER:
                        device_failures = 0
                        healthy = (probe or probe_devices)()
                        obs.emit("device_reprobe", status="ok", pool=pool,
                                 healthy=len(healthy), after_shard=out.index)
                if out.attempts < max_attempts:
                    delay = backoff_delay(pool, out.index, out.attempts, backoff_s)
                    retries_c.inc(1, pool=pool)
                    obs.emit("shard_retry", status="retrying", pool=pool, shard=out.index,
                             attempt=out.attempts, error=out.error)
                    backoff_c.inc(delay, pool=pool)
                    time.sleep(delay)
        if not out.ok:
            failures_c.inc(1, pool=pool)
            obs.emit("shard_failed", status="error", pool=pool, shard=out.index,
                     attempt=out.attempts, error=out.error)
    return outcomes


def require_all(outcomes: Iterable[ShardOutcome]) -> list:
    """Every shard's result; ``RuntimeError`` if any shard failed."""
    outcomes = list(outcomes)
    failed = [o for o in outcomes if not o.ok]
    if failed:
        detail = "; ".join(f"shard {o.index}: {o.error}" for o in failed[:5])
        raise RuntimeError(f"{len(failed)}/{len(outcomes)} shards failed: {detail}")
    return [o.result for o in outcomes]


def inject_failures(shard_fn: Callable[[int], object],
                    fail_plan: dict[int, int]) -> Callable[[int], object]:
    """Plan-based fault injection: ``fail_plan[i] = k`` makes shard
    ``i``'s first ``k`` attempts raise (``chaos.plan_faults``)."""
    return chaos.plan_faults(shard_fn, fail_plan)
