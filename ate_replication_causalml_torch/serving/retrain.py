"""Retrain supervisor: fit → publish → rotate (with its verify).

Port of ``ate_replication_causalml_tpu/serving/retrain.py``: the same
state machine, statuses, counters, events and backoff schedule. This
module owns everything around a refit, so the daemon never serves a
corrupt, stale or half-loaded model:

1. **fit**: ``fit_fn()`` produces a fresh fitted forest (injected:
   ``models/causal_forest.fit_causal_forest`` on the card, a micro
   forest in tests; the daemon's :meth:`~.daemon.CateServer.retrain_supervisor`
   runs it on its own CUDA stream). It runs under the classified-retry
   and deadline discipline: transient failures (out of device memory,
   ``OSError``, an injected :class:`~..resilience.errors.ChaosRotateFault`)
   retry with the capped, crc32-jittered exponential backoff of
   ``resilience/backoff.py``; fatal ones raise at once: programming
   errors, and every CUDA error (it poisons the context, so a refit
   would fail again or hide a kernel fault). ``deadline_s`` bounds the
   whole run (a :class:`~..resilience.deadline.Budget`).
2. **publish**: ``utils/checkpoint.save_fitted`` writes the candidate to
   a fresh *versioned* path (``{model}-v{NNNN}.npz``), atomically, with
   its SHA-256 digest. Every attempt takes a NEW version number: a
   refused candidate stays on disk for quarantine, never overwritten.
3. **rotate**: the path goes to the daemon's rotation
   (:meth:`~.daemon.CateServer.rotate` →
   :meth:`~.admission.ReloadSupervisor.rotate`), which re-verifies the
   digest, checks the geometry against the warmed predicts, pre-builds
   the leaf index and hot-swaps. A failed re-verify is a typed
   ``refused`` (terminal; the last good model keeps serving); ``busy``
   (another reload or rotation in flight) retries only the rotation.

Chaos (``rotate:`` scope): ``retrain`` faults the fit (retried),
``corrupt`` truncates the published archive after its digest went in
(the rotation's re-verify must refuse it); ``hang:scope=retrain``
stalls the fit inside the stamped attempt.

Telemetry: ``serving_retrain_total{model,status}`` terminal outcomes,
``serving_retrain_retries_total{model}`` transient retries, a
``retrain_run`` span a run with ``retrain_retry`` / ``retrain_deadline``
events, and the ``retrain/<model>`` heartbeat lane.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.backoff import BACKOFF_CAP_MULT, jittered_backoff_delay
from ate_replication_causalml_torch.resilience.deadline import Budget
from ate_replication_causalml_torch.resilience.errors import ChaosRotateFault, classify
from ate_replication_causalml_torch.resilience.watchdog import HeartbeatRegistry

__all__ = ["BACKOFF_CAP_MULT", "RetrainConfig", "RetrainOutcome",
           "RetrainSupervisor", "retrain_backoff_delay"]


def retrain_backoff_delay(model_id: str, attempt: int, base_s: float) -> float:
    """Backoff before retrying a transient retrain failure: exponential
    in the attempt, crc32-jittered, capped (one formula,
    ``resilience/backoff.py``), a pure function of ``(model_id,
    attempt)`` so tests can assert the exact sleep schedule."""
    return jittered_backoff_delay(f"retrain|{model_id}|{attempt}", attempt, base_s)


@dataclasses.dataclass(frozen=True)
class RetrainConfig:
    """Retry/deadline discipline for one supervisor."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    deadline_s: float | None = None


@dataclasses.dataclass
class RetrainOutcome:
    """One ``run_once`` result. ``status`` is the terminal word:
    ``rotated`` (new model serving), ``refused`` (candidate failed the
    rotation's re-verify — last good kept), ``retired_model`` /
    ``unknown_model`` (the target id is gone — terminal), ``failed``
    (retries exhausted), ``deadline`` (wall clock cut the run),
    ``busy`` (rotation claim contended past the retry budget)."""

    model_id: str
    status: str
    attempts: int = 0
    checkpoint: str | None = None
    error: str | None = None


class RetrainSupervisor:
    """Drives the fit → publish → rotate pipeline for ONE model.

    Everything side-effectful is injected, so the state machine is
    testable with stubs: ``fit_fn`` returns the fresh forest,
    ``publish_fn(path, forest)`` persists it (default: the atomic,
    digest-embedding ``utils.checkpoint.save_fitted``, resolved
    lazily), ``rotate_fn(path)`` performs the verified hot-swap and
    returns the rotation status string (the daemon's
    :meth:`~.daemon.CateServer.rotate` bound to this model)."""

    def __init__(
        self,
        model_id: str,
        fit_fn: Callable[[], object],
        publish_dir: str,
        rotate_fn: Callable[[str], str],
        config: RetrainConfig = RetrainConfig(),
        publish_fn: Callable[[str, object], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        start_version: int = 2,
        heartbeats: HeartbeatRegistry | None = None,
    ):
        self.model_id = model_id
        self._fit_fn = fit_fn
        self._publish_dir = publish_dir
        self._rotate_fn = rotate_fn
        self.config = config
        self._publish_fn = publish_fn
        self._clock = clock
        self._sleep = sleep
        #: the watchdog lane: the supervisor stamps a heartbeat around
        #: every attempt, so a wedged fit is a detected stall. The lane
        #: is model-scoped (``retrain/<model_id>``); the watchdog's
        #: ``bound_for`` prefix match lets one ``retrain`` bound cover
        #: them all. The daemon's retrain_supervisor() wires its own
        #: registry in.
        self._heartbeats = heartbeats
        self._version = itertools.count(start_version)
        self._runs = _registry.counter(
            "serving_retrain_total",
            "retrain supervisor runs by model and terminal status",
        )
        self._retries = _registry.counter(
            "serving_retrain_retries_total",
            "retrain attempts retried after a transient failure",
        )

    def _publish(self, path: str, forest) -> None:
        if self._publish_fn is not None:
            self._publish_fn(path, forest)
            return
        from ate_replication_causalml_torch.utils.checkpoint import save_fitted

        save_fitted(path, forest)

    def _candidate_path(self) -> str:
        """The next FRESH versioned path. Numbers already on disk are
        skipped — a refused candidate stays quarantined forever, and a
        restarted supervisor (seeded from the entry's version, which a
        refusal does not advance) must never overwrite it."""
        while True:
            path = os.path.join(
                self._publish_dir,
                f"{self.model_id}-v{next(self._version):04d}.npz",
            )
            if not os.path.exists(path):
                return path

    def _attempt(self) -> tuple[str, str | None]:
        """One fit → publish → rotate attempt; returns ``(status,
        checkpoint_path)``. Raises on failure (classified upstream)."""
        inj = chaos.active()
        with _events.span("retrain_fit", model=self.model_id):
            if inj is not None:
                # The hang: injection site, inside the stamped unit of
                # work, so the retrain lane's heartbeat age grows.
                delay = inj.hang_delay_s("retrain", self.model_id)
                if delay > 0:
                    time.sleep(delay)
            if inj is not None and inj.take_rotate_fault(
                "retrain", site=f"retrain/{self.model_id}"
            ):
                raise ChaosRotateFault(
                    f"chaos: injected retrain fault ({self.model_id})"
                )
            forest = self._fit_fn()
        path = self._candidate_path()
        with _events.span("retrain_publish", model=self.model_id, path=path):
            self._publish(path, forest)
            if inj is not None and inj.take_rotate_fault(
                "corrupt", site=path
            ):
                # The artifact a torn publish would leave, after the
                # digest went in: only the rotation's re-verify can
                # catch it.
                os.truncate(path, max(1, (os.path.getsize(path) * 3) // 5))
        return self._rotate_fn(path), path

    def run_once(self) -> RetrainOutcome:
        """One retrain run under the full discipline. Never raises for
        transient trouble (the outcome record carries the terminal
        status); fatal errors (programming errors, CUDA errors)
        re-raise at once."""
        cfg = self.config
        budget = (
            None if cfg.deadline_s is None
            else Budget.after(cfg.deadline_s, clock=self._clock)
        )
        out = RetrainOutcome(self.model_id, "failed")
        candidate: str | None = None
        with _events.span("retrain_run", model=self.model_id) as sp:
            while out.attempts < cfg.max_attempts:
                if self._heartbeats is not None:
                    self._heartbeats.beat(f"retrain/{self.model_id}")
                if budget is not None and budget.expired():
                    out.status = "deadline"
                    break
                out.attempts += 1
                try:
                    if candidate is None:
                        status, candidate = self._attempt()
                    else:
                        # A prior attempt already published a candidate
                        # and only the rotation claim was contended
                        # ("busy"): retry ONLY the rotation, not a full
                        # refit.
                        status = self._rotate_fn(candidate)
                except Exception as e:
                    if classify(e) == "fatal":
                        sp.set_status("error")
                        self._runs.inc(1, model=self.model_id,
                                       status="fatal")
                        raise
                    out.error = f"{type(e).__name__}: {e}"
                    status, candidate = "error", None
                if status == "rotated":
                    out.status, out.checkpoint, out.error = (
                        "rotated", candidate, None
                    )
                    break
                if status in ("refused", "retired_model", "unknown_model"):
                    # Typed terminals, not retries: a refused candidate
                    # would be refused again, and a retired/unknown
                    # model id will not come back on backoff. The error
                    # field describes THIS terminal, not a stale
                    # earlier-attempt transient.
                    out.status, out.checkpoint, out.error = (
                        status, candidate, None
                    )
                    break
                if status != "busy":
                    candidate = None  # refit on the next attempt
                # transient ("error" from the fit/publish, or "busy"
                # from a contended rotation claim): back off and retry.
                out.status = "busy" if status == "busy" else "failed"
                if out.attempts >= cfg.max_attempts:
                    break
                delay = retrain_backoff_delay(
                    self.model_id, out.attempts, cfg.backoff_s
                )
                if budget is not None and not budget.affords(delay):
                    out.status = "deadline"
                    break
                self._retries.inc(1, model=self.model_id)
                _events.emit(
                    "retrain_retry", status="retrying",
                    model=self.model_id, attempt=out.attempts,
                    error=out.error or status,
                )
                self._sleep(delay)
            if out.status != "rotated":
                sp.set_status("error")
                if out.status == "deadline":
                    _events.emit(
                        "retrain_deadline", status="error",
                        model=self.model_id, attempts=out.attempts,
                        deadline_s=cfg.deadline_s,
                    )
        if self._heartbeats is not None:
            self._heartbeats.beat(f"retrain/{self.model_id}")
        self._runs.inc(1, model=self.model_id, status=out.status)
        return out
