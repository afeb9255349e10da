"""Client of the CATE serving daemon.

Port of ``ate_replication_causalml_tpu/serving/client.py``, no tensor
math: the same frames, so it drives the port's daemon and the JAX
package's alike. Transports:

* TCP, :meth:`CateClient.connect` (many clients, one daemon,
  micro-batching across connections);
* subprocess stdio, :meth:`CateClient.spawn_stdio` (the client owns the
  daemon's lifetime).

Typed rejects (``overloaded`` / ``serve_fault`` / ``degraded`` /
``model_degraded`` / ``shed`` / ``deadline_exceeded``) are retried under
the SAME request id: ids are the idempotency key (the chaos harness
selects faults by id), so a retrying client converges and a chaos run's
final answers are bit-identical to a fault-free run's.

Backoff takes the server's ``retry_after_s`` hint as its base:
exponential in the attempt, a deterministic crc32 jitter keyed on
``(request_id, code, attempt)``, capped at :data:`BACKOFF_CAP_MULT` ×
hint, at :attr:`CateClient.max_backoff_s` and, with a ``deadline_ms``,
at the :class:`~..resilience.deadline.Budget` left. Absorbed rejects and
backoff seconds are metered (``retry_counts`` / ``backoff_s_total``).
The JAX client's ``dump``, ``rotate`` and ``retire`` ops come with the
daemon's, which are not ported yet.
"""

from __future__ import annotations

import itertools
import subprocess
import socket
import time

import numpy as np

from ate_replication_causalml_torch.resilience.backoff import (
    BACKOFF_CAP_MULT,
    jittered_backoff_delay,
)
from ate_replication_causalml_torch.resilience.deadline import Budget
from ate_replication_causalml_torch.serving import protocol

__all__ = ["BACKOFF_CAP_MULT", "CONNECTION_LOST", "CateClient",
           "ServingError", "ServingUnavailable", "retry_backoff_delay"]


def retry_backoff_delay(request_id: str, code: str, attempt: int,
                        hint_s: float, cap_s: float = 2.0) -> float:
    """Deterministic client backoff before retry ``attempt`` of a typed
    reject: ``hint_s`` grows exponentially per attempt with a crc32
    jitter in [0, 25%), capped at ``BACKOFF_CAP_MULT × hint_s`` and at
    ``cap_s`` absolute. A pure function of its arguments — the same
    retrying request sleeps the same schedule every run. One formula,
    shared with the shard runner and the retrain supervisor
    (``resilience/backoff.py``)."""
    return jittered_backoff_delay(
        f"{request_id}|{code}|{attempt}", attempt, hint_s, cap_s=cap_s
    )


class ServingError(RuntimeError):
    """Terminal (non-retryable) server reply; carries the wire code."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class ServingUnavailable(ServingError):
    """Retry budget exhausted on retryable rejects."""

    def __init__(self, code: str, message: str, attempts: int):
        super().__init__(code, f"{message} (after {attempts} attempts)")
        self.attempts = attempts


#: Reject codes worth retrying after the server's hint. The fleet
#: codes: ``model_degraded`` is one tenant's recovery
#: window, ``shed`` is SLO-burn backpressure — both clear; unknown or
#: retired model ids are terminal and raise. ``deadline_exceeded``
#: is retryable ONLY while the caller still has budget —
#: the retry stamps the smaller remaining deadline and the backoff is
#: capped by it; ``draining`` is terminal on THIS connection (the
#: daemon behind it is going away; in a balanced fleet the caller's
#: next connection lands elsewhere).
RETRYABLE = ("overloaded", "serve_fault", "degraded", "starting",
             "model_degraded", "shed", "deadline_exceeded",
             "backend_unavailable")

#: wire codes that mean the TRANSPORT died, not that the server
#: rejected anything: a TCP client reconnects and resubmits
#: under the SAME request id (ids are the idempotency key — a daemon
#: failover behind a router is invisible to a well-behaved client);
#: over stdio there is nothing to reconnect to, so the loss is
#: terminal and typed.
CONNECTION_LOST = "connection_lost"


class CateClient:
    """One connection to a serving daemon."""

    def __init__(self, rstream, wstream, *, proc=None, sock=None):
        self._r = rstream
        self._w = wstream
        self._proc = proc
        self._sock = sock
        self._seq = itertools.count(1)
        #: retryable rejects absorbed by predict(), by wire code: the
        #: backpressure this connection actually saw.
        self.retry_counts: dict[str, int] = {}
        #: seconds slept in typed-reject backoff (metered, like the
        #: shard runner's backoff counter).
        self.backoff_s_total: float = 0.0
        #: absolute backoff ceiling per sleep.
        self.max_backoff_s: float = 2.0
        #: TCP origin (host, port, timeout) when built by
        #: :meth:`connect` — the reconnect target after a mid-stream
        #: connection loss. None for stdio/socketpair
        #: transports, which cannot reconnect.
        self._addr: tuple[str, int, float] | None = None

    @classmethod
    def connect(cls, host: str, port: int, timeout: float = 10.0
                ) -> "CateClient":
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(timeout)
        rw = sock.makefile("rwb")
        client = cls(rw, rw, sock=sock)
        client._addr = (host, port, timeout)
        return client

    @classmethod
    def spawn_stdio(cls, argv: list[str], **popen_kw) -> "CateClient":
        """Launch ``argv`` (a ``scripts/serve.py --stdio`` command line)
        and speak the protocol over its pipes; stderr passes through."""
        proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, **popen_kw
        )
        return cls(proc.stdout, proc.stdin, proc=proc)

    def close(self) -> None:
        for stream in (self._w, self._r):
            try:
                stream.close()
            except OSError:
                pass
        if self._sock is not None:
            self._sock.close()
        if self._proc is not None:
            self._proc.wait(timeout=10)

    # ── ops ──────────────────────────────────────────────────────────

    def _roundtrip(self, header: dict, arrays=None):
        try:
            protocol.write_frame(self._w, header, arrays)
            frame = protocol.read_frame(self._r)
        except (protocol.ProtocolError, OSError) as e:
            # The transport died mid-frame (a kill -9'd daemon's wire
            # signature) — typed, so predict() can reconnect-and-
            # resubmit and every other op surfaces a classified error.
            raise ServingError(
                CONNECTION_LOST, f"{type(e).__name__}: {e}"
            ) from e
        if frame is None:
            raise ServingError(
                CONNECTION_LOST, "server closed the connection"
            )
        return frame

    def _reconnect(self) -> None:
        """Dial a fresh TCP connection to the original :meth:`connect`
        address. The new streams swap in only on success —
        on dial failure the dead ones stay, and the next roundtrip
        surfaces ``connection_lost`` again (consuming another retry)
        instead of tripping over an already-closed file object."""
        host, port, timeout = self._addr  # type: ignore[misc]
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(timeout)
        rw = sock.makefile("rwb")
        old = (self._r, self._w, self._sock)
        self._r = self._w = rw
        self._sock = sock
        for stale in old:
            if stale is not None:
                try:
                    stale.close()
                except (OSError, ValueError):
                    pass

    def predict_full(
        self,
        x: np.ndarray,
        request_id: str | None = None,
        max_retries: int = 16,
        model: str | None = None,
        deadline_ms: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """``(cate, variance, reply_header)`` for the rows of ``x`` —
        the header carries the ``model`` / ``model_version`` that
        actually served the request (the bit-identity partition key
        across a hot-swap). ``model`` routes to a fleet entry (None =
        the daemon's default model). ``deadline_ms`` arms
        the end-to-end deadline: the client stamps its REMAINING
        budget into every attempt's header (the server checks it at
        admission, batch close and dispatch pickup), backoff sleeps
        are capped by what is left, and an exhausted budget raises
        ``ServingUnavailable("deadline_exceeded", ...)``. Retryable
        rejects back off on the server's retry-after hint with
        deterministic crc32 jitter (:func:`retry_backoff_delay`) under
        the same id; anything else raises :class:`ServingError` typed
        with the wire code."""
        rid = str(request_id) if request_id is not None else f"c{next(self._seq)}"
        x = np.ascontiguousarray(x, dtype=np.float32)
        budget = Budget.from_ms(deadline_ms) if deadline_ms is not None else None
        request: dict = {"op": "predict", "id": rid}
        if model is not None:
            request["model"] = model
        for attempt in range(1, max_retries + 2):
            if budget is not None:
                remaining = budget.remaining_ms()
                if remaining <= 0.0:
                    raise ServingUnavailable(
                        "deadline_exceeded",
                        f"client deadline of {deadline_ms}ms exhausted",
                        attempt - 1,
                    )
                request["deadline_ms"] = round(remaining, 3)
            try:
                header, arrays = self._roundtrip(request, {"x": x})
            except ServingError as e:
                if e.code != CONNECTION_LOST or self._addr is None:
                    # Non-transport errors propagate; a stdio/socketpair
                    # transport has nothing to re-dial, so its loss is
                    # terminal (but still typed).
                    raise
                if attempt > max_retries:
                    raise ServingUnavailable(
                        CONNECTION_LOST,
                        "connection lost and retry budget exhausted",
                        attempt,
                    ) from e
                # Reconnect-and-resubmit under the SAME request id: ids
                # are the idempotency key (the answer is deterministic
                # per model version), so a daemon failover behind a
                # router is invisible here.
                self.retry_counts[CONNECTION_LOST] = (
                    self.retry_counts.get(CONNECTION_LOST, 0) + 1
                )
                cap_s = self.max_backoff_s
                if budget is not None:
                    cap_s = min(cap_s, max(0.0, budget.remaining_s()))
                delay = retry_backoff_delay(
                    rid, CONNECTION_LOST, attempt, 0.05, cap_s=cap_s
                )
                self.backoff_s_total += delay
                time.sleep(delay)
                try:
                    self._reconnect()
                except OSError:
                    # Dial failed — the daemon may still be restarting.
                    # The dead streams stayed in place, so the next
                    # attempt's roundtrip re-raises connection_lost and
                    # consumes another retry.
                    pass
                continue
            if header.get("ok"):
                return arrays["cate"], arrays["variance"], header
            code = header.get("error", "error")
            if code not in RETRYABLE or attempt > max_retries:
                if code in RETRYABLE:
                    raise ServingUnavailable(
                        code, header.get("message", ""), attempt
                    )
                raise ServingError(code, header.get("message", ""))
            self.retry_counts[code] = self.retry_counts.get(code, 0) + 1
            cap_s = self.max_backoff_s
            if budget is not None:
                # Never sleep past the caller's deadline: the remaining
                # budget is the backoff cap ("an unaffordable backoff
                # cuts the work", client-side).
                cap_s = min(cap_s, max(0.0, budget.remaining_s()))
            delay = retry_backoff_delay(
                rid, code, attempt,
                float(header.get("retry_after_s", 0.05)),
                cap_s=cap_s,
            )
            self.backoff_s_total += delay
            time.sleep(delay)
        raise AssertionError("unreachable")

    def predict(
        self,
        x: np.ndarray,
        request_id: str | None = None,
        max_retries: int = 16,
        model: str | None = None,
        deadline_ms: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`predict_full` without the reply header."""
        cate, var, _ = self.predict_full(
            x, request_id=request_id, max_retries=max_retries, model=model,
            deadline_ms=deadline_ms,
        )
        return cate, var

    def ping(self) -> dict:
        header, _ = self._roundtrip({"op": "ping"})
        return header

    def stats(self) -> dict:
        header, _ = self._roundtrip({"op": "stats"})
        if not header.get("ok"):
            raise ServingError(header.get("error", "error"),
                               header.get("message", ""))
        return header["stats"]

    def drain(self, timeout_s: float | None = None) -> str:
        """Ask the daemon for a graceful drain: in-flight
        work completes, artifacts dump, the daemon exits. Blocks until
        the drain finishes; returns the outcome (``"drained"`` = zero
        in-flight requests dropped, ``"timeout"`` = the bound cut
        it). The reply only arrives AFTER the drain, so the socket's
        regular 10 s read timeout is widened to cover the drain bound
        (the server default is 30 s) for this one round-trip."""
        request: dict = {"op": "drain"}
        if timeout_s is not None:
            request["timeout_s"] = float(timeout_s)
        wait_s = (30.0 if timeout_s is None else float(timeout_s)) + 30.0
        prev = None
        if self._sock is not None:
            prev = self._sock.gettimeout()
            if prev is not None and prev < wait_s:
                self._sock.settimeout(wait_s)
        try:
            header, _ = self._roundtrip(request)
        finally:
            if self._sock is not None and prev is not None:
                try:
                    self._sock.settimeout(prev)
                except OSError:
                    pass  # the daemon closed the connection behind us
        if "outcome" not in header:
            raise ServingError(header.get("error", "error"),
                               header.get("message", ""))
        return str(header["outcome"])

    def shutdown(self) -> None:
        """Ask the daemon to exit (acknowledged before it stops)."""
        self._roundtrip({"op": "shutdown"})

    def __enter__(self) -> "CateClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
