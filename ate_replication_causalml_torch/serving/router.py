"""Serving router: one service over N CATE daemons.

Port of ``ate_replication_causalml_tpu/serving/router.py``: a router
that fronts N daemons (``python -m ate_replication_causalml_torch.serving``)
over the daemons' own length-prefixed wire protocol, so the fleet looks
like one daemon to every client:

* **consistent-hash routing**: a request routes on a sha256 ring keyed
  by model id (:class:`ConsistentHashRing`, 64 vnodes a backend), so a
  model's traffic stays on one daemon and its CUDA graphs stay warm;
  the ring is immutable, eviction walks to the next live owner, and a
  readmitted daemon gets its keys back;
* **probe-driven membership**: eviction and readmission come from the
  daemons' admin probes alone, ``/readyz`` (readiness and the model
  bindings it serves) and ``/healthz`` (a wedged dispatcher is dead);
* **circuit breaking and bounded failover**: a :class:`CircuitBreaker`
  a backend (open after N consecutive connection failures, one
  half-open trial after a cooldown); a forward that dies mid-stream is
  resubmitted to the next distinct ring owner at most ``failover_hops``
  times, and an exhausted candidate list is the typed, retryable
  ``backend_unavailable`` reject;
* **rolling rotation**: :meth:`FleetSupervisor.rotate_all` cordons one
  daemon at a time, lets its in-flight forwards finish, rotates it from
  one published checkpoint, waits for the probe to report the advanced
  version and readmits it, checking at every step that a backend stays
  in rotation;
* **merged fleet dump**: :meth:`RouterServer.dump_fleet` has every live
  daemon dump into ``outdir/daemon-<name>/``, writes
  ``fleet_manifest.json`` with the router's own counters and its trace
  and SLO report into ``outdir/router/``, and stitches the merged fleet
  artifacts (``observability/fleet_report.py``).

Counter families (``install_monitoring`` pre-creates them at 0):
``router_requests_total{backend,outcome}`` (one a forward attempt; the
null backend ``-`` with ``unavailable`` for a request no candidate could
take), ``router_failover_total``, ``router_backend_state{backend,state}``
(``admitted`` / ``evicted`` / ``cordoned`` / ``uncordoned``),
``router_request_path_total{path}`` (one a request: ``direct`` /
``failover`` / ``exhausted``) and the ``router_request_seconds{outcome}``
latency ladder the ``router:latency`` SLO reads.

Every forward is a ``router_request`` span with its backend, hops,
outcome and four contiguous phases, ``connect_s`` (candidate scan and
connection), ``send_s``, ``wait_s`` (until the first reply byte) and
``reply_s``, accumulated over failover hops, so they sum to ``e2e_s``
within float rounding. Probe rounds, breaker flips and membership
changes are instants on the ``router-probe`` / ``router-breaker`` /
``router-backend`` tracks. :func:`handle_router_admin_path` serves
``/metrics`` ``/healthz`` ``/readyz`` ``/fleetz`` through the daemon's
HTTP shell (``serving/admin.py``, ``AdminServer(handler=...)``).

The router never touches a tensor: this module and everything it
imports load neither torch nor the JAX package, so it runs on a host
with no accelerator stack (``python -m
ate_replication_causalml_torch.serving.router --backends ...``).
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import hashlib
import http.client
import json
import os
import socket
import sys
import threading
import time
from typing import Callable, Sequence

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.observability import slo as _slo
from ate_replication_causalml_torch.observability.registry import parse_label_key
from ate_replication_causalml_torch.observability.trace import write_trace_json
from ate_replication_causalml_torch.serving import protocol

__all__ = [
    "BACKEND_UNAVAILABLE", "BackendSpec", "CircuitBreaker", "ConsistentHashRing",
    "FleetSupervisor", "HealthProber", "OUTCOMES", "ROUTER_ADMIN_ROUTES", "RouterConfig",
    "RouterServer", "handle_router_admin_path", "handle_router_op", "parse_backend_specs",
    "probe_backend", "serve_socket", "serve_stream",
]

#: vnodes a backend: a 3..8-node ring balances within the tested bound,
#: and the ring costs nothing to build.
DEFAULT_VNODES = 64

#: The typed, retryable reject of a request no in-rotation backend
#: could take: the fleet's ``overloaded``.
BACKEND_UNAVAILABLE = "backend_unavailable"

#: The forward-attempt outcomes ``router_requests_total`` is labeled with.
OUTCOMES = ("ok", "reject", "error", "connection_error", "unavailable")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a number") from None
    if value <= 0:
        raise ValueError(f"{name}={value}: expected > 0")
    return value


def _env_int(name: str, default: int, minimum: int = 1) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer") from None
    if value < minimum:
        raise ValueError(f"{name}={value}: expected >= {minimum}")
    return value


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One daemon the router fronts: wire address and admin port."""

    name: str
    host: str
    port: int
    admin_port: int


def parse_backend_specs(spec: str) -> tuple[BackendSpec, ...]:
    """Parse ``name=host:port@adminport,...``; any malformed entry raises."""
    out: list[BackendSpec] = []
    seen: set[str] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, addr = part.partition("=")
        name = name.strip()
        hostport, at, admin_s = addr.partition("@")
        host, colon, port_s = hostport.rpartition(":")
        if not (eq and at and colon and name and host):
            raise ValueError(f"bad backend entry {part!r} in {spec!r} "
                             "(want name=host:port@adminport)")
        if name in seen:
            raise ValueError(f"duplicate backend name {name!r} in {spec!r}")
        try:
            port, admin_port = int(port_s), int(admin_s)
        except ValueError:
            raise ValueError(f"bad backend ports in {part!r} (want integers)") from None
        if not (0 < port < 65536 and 0 < admin_port < 65536):
            raise ValueError(f"backend ports out of range in {part!r}")
        seen.add(name)
        out.append(BackendSpec(name, host.strip(), port, admin_port))
    if not out:
        raise ValueError(f"empty backend spec {spec!r}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs; :meth:`from_env` reads the ``ATE_TPU_ROUTER_*``
    variables and raises on a malformed one."""

    backends: tuple[BackendSpec, ...]
    vnodes: int = DEFAULT_VNODES
    probe_interval_s: float = 0.25
    probe_timeout_s: float = 2.0
    connect_timeout_s: float = 5.0
    io_timeout_s: float = 30.0
    failure_threshold: int = 3
    cooldown_s: float = 1.0
    failover_hops: int = 2
    retry_after_s: float = 0.05

    @classmethod
    def from_env(cls, backends: "str | tuple[BackendSpec, ...]", **overrides) -> "RouterConfig":
        if isinstance(backends, str):
            backends = parse_backend_specs(backends)
        kw: dict = {
            "vnodes": _env_int("ATE_TPU_ROUTER_VNODES", DEFAULT_VNODES),
            "probe_interval_s": _env_float("ATE_TPU_ROUTER_PROBE_S", 0.25),
            "failure_threshold": _env_int("ATE_TPU_ROUTER_FAILURES", 3),
            "cooldown_s": _env_float("ATE_TPU_ROUTER_COOLDOWN_S", 1.0),
            "failover_hops": _env_int("ATE_TPU_ROUTER_FAILOVER", 2, minimum=0),
            "retry_after_s": _env_float("ATE_TPU_ROUTER_RETRY_AFTER_S", 0.05),
        }
        kw.update(overrides)
        return cls(backends=tuple(backends), **kw)


# ── the consistent-hash ring (pure) ─────────────────────────────────────


def _ring_pos(token: str) -> int:
    """A vnode or key position: the first 8 bytes of sha256 as an int,
    the same in every process."""
    return int.from_bytes(hashlib.sha256(token.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Consistent-hash ring over backend names, pure and immutable.

    Vnode positions are sha256 of ``{salt}{name}#{i}``; a key routes to
    the first vnode clockwise of ``sha256(key)``. The same members give
    the same assignment in every process whatever their order, and
    :meth:`with_backend` / :meth:`without_backend` move only the keys the
    changed backend owns (every other vnode keeps its position)."""

    def __init__(self, backends: Sequence[str], vnodes: int = DEFAULT_VNODES, salt: str = ""):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        names = tuple(sorted(set(backends)))
        if len(names) != len(tuple(backends)):
            raise ValueError(f"duplicate backend names in {backends!r}")
        if not names:
            raise ValueError("a ring needs at least one backend")
        self.backends = names
        self.vnodes = int(vnodes)
        self.salt = salt
        points = sorted((_ring_pos(f"{salt}{name}#{i}"), name)
                        for name in names for i in range(self.vnodes))
        self._points = points
        self._positions = [p for p, _ in points]

    def owner(self, key: str) -> str:
        """The backend owning ``key``: the first vnode clockwise."""
        return self.owners(key, 1)[0]

    def owners(self, key: str, n: int | None = None) -> tuple[str, ...]:
        """The first ``n`` distinct backends clockwise of ``key`` (all by
        default): the failover order, owner first."""
        want = len(self.backends) if n is None else min(n, len(self.backends))
        start = bisect.bisect_right(self._positions, _ring_pos(key))
        out: list[str] = []
        seen: set[str] = set()
        for i in range(len(self._points)):
            _, name = self._points[(start + i) % len(self._points)]
            if name not in seen:
                seen.add(name)
                out.append(name)
                if len(out) == want:
                    break
        return tuple(out)

    def assignment(self, keys: Sequence[str]) -> dict[str, str]:
        return {k: self.owner(k) for k in keys}

    def with_backend(self, name: str) -> "ConsistentHashRing":
        return ConsistentHashRing((*self.backends, name), self.vnodes, self.salt)

    def without_backend(self, name: str) -> "ConsistentHashRing":
        return ConsistentHashRing(tuple(b for b in self.backends if b != name),
                                  self.vnodes, self.salt)


# ── the per-backend circuit breaker ─────────────────────────────────────


class CircuitBreaker:
    """Closed → open after ``threshold`` consecutive connection-level
    failures; after ``cooldown_s`` one half-open trial goes out, whose
    success closes the breaker and whose failure re-opens it (and re-arms
    the cooldown). The clock is injectable."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self._threshold = threshold
        self._cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._trial_out = False

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            return "half_open" if self._trial_out else "open"

    def allow(self) -> bool:
        """May a forward go to this backend now? An open breaker releases
        one trial a cooldown."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._trial_out:
                return False
            if self._clock() - self._opened_at >= self._cooldown_s:
                self._trial_out = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._trial_out = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._trial_out or self._failures >= self._threshold:
                self._opened_at = self._clock()
                self._trial_out = False


# ── health probing (the daemons' admin HTTP) ────────────────────────────


def probe_backend(spec: BackendSpec, timeout_s: float = 2.0) -> tuple[bool, bool, dict]:
    """One probe of a daemon's admin endpoint: ``(ready, alive, models)``:
    ``/readyz`` 200, ``/healthz`` 200, and the readyz body's
    ``{model_id: {"version", "checkpoint"}}`` table the router routes
    by. Any transport failure is ``(False, False, {})``: an unreachable
    daemon is out of rotation, not an error."""
    try:
        conn = http.client.HTTPConnection(spec.host, spec.admin_port, timeout=timeout_s)
        try:
            conn.request("GET", "/readyz")
            resp = conn.getresponse()
            body = resp.read()
            ready = resp.status == 200
            try:
                models = dict(json.loads(body).get("models") or {})
            except (json.JSONDecodeError, UnicodeDecodeError, AttributeError):
                models = {}
            conn.request("GET", "/healthz")
            live = conn.getresponse()
            live.read()
            alive = live.status == 200
        finally:
            conn.close()
        return ready, alive, models
    except OSError:
        return False, False, {}


class HealthProber:
    """One thread probing every backend at a fixed interval and feeding
    :meth:`RouterServer.update_health`; its stop is a bounded join."""

    def __init__(self, router: "RouterServer", interval_s: float, timeout_s: float = 2.0):
        self._router = router
        self._interval_s = float(interval_s)
        self._timeout_s = float(timeout_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def probe_once(self) -> None:
        ready_n = 0
        for spec in self._router.config.backends:
            ready, alive, models = probe_backend(spec, self._timeout_s)
            ready_n += 1 if (ready and alive) else 0
            self._router.update_health(spec.name, ready, alive, models)
        # One instant a round on its own track, and an SLO tick so the
        # burn windows advance while no request arrives.
        obs.emit("router_probe", status="ok", track="router-probe",
                 backends=len(self._router.config.backends), ready=ready_n)
        self._router.slo.tick()

    def start(self) -> None:
        if self._thread is not None:
            return
        t = threading.Thread(target=self._run, name="router-prober", daemon=True)
        self._thread = t
        t.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self._interval_s)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout)


# ── the router ──────────────────────────────────────────────────────────


class _BackendConn:
    """One pooled wire connection to a backend."""

    def __init__(self, spec: BackendSpec, connect_timeout_s: float, io_timeout_s: float):
        self.sock = socket.create_connection((spec.host, spec.port), timeout=connect_timeout_s)
        self.sock.settimeout(io_timeout_s)
        self.rw = self.sock.makefile("rwb")

    def send(self, header: dict, arrays: dict) -> None:
        """The request frame on the wire (the ``send`` phase)."""
        protocol.write_frame(self.rw, header, arrays)

    def wait_reply(self) -> None:
        """Block until the first reply byte is buffered (the ``wait``
        phase). ``peek`` consumes nothing; EOF surfaces as the read's
        ProtocolError."""
        self.rw.peek(1)

    def read_reply(self):
        """The buffered reply frame (the ``reply`` phase); a close before
        the reply is a :class:`protocol.ProtocolError`."""
        frame = protocol.read_frame(self.rw)
        if frame is None:
            raise protocol.ProtocolError("backend closed the connection before replying")
        return frame

    def roundtrip(self, header: dict, arrays: dict):
        self.send(header, arrays)
        self.wait_reply()
        return self.read_reply()

    def close(self) -> None:
        for closer in (self.rw.close, self.sock.close):
            try:
                closer()
            except OSError:
                pass


class _Backend:
    """The router's record of one daemon: probe state, cordon, breaker,
    connection pool and in-flight count. Mutable fields are guarded by
    the router's lock; the breaker locks itself."""

    def __init__(self, spec: BackendSpec, breaker: CircuitBreaker):
        self.spec = spec
        self.breaker = breaker
        self.ready = False
        self.alive = False
        self.models: dict = {}
        self.cordoned = False
        self.in_flight = 0
        self.pool: list[_BackendConn] = []

    def in_rotation(self) -> bool:
        return self.ready and self.alive and not self.cordoned


class RouterServer:
    """The daemon-fronting router: forwards ``predict`` by consistent-hash
    model routing and answers ``ping`` / ``stats`` / ``dump`` /
    ``rotate_all`` / ``shutdown`` itself (:func:`handle_router_op`)."""

    def __init__(self, config: RouterConfig, clock: Callable[[], float] = time.monotonic):
        if not config.backends:
            raise ValueError("router needs at least one backend")
        self.config = config
        self._clock = clock
        self._lock = threading.Lock()
        self._backends = {
            spec.name: _Backend(spec, CircuitBreaker(config.failure_threshold,
                                                     config.cooldown_s, clock))
            for spec in config.backends
        }
        self.ring = ConsistentHashRing(tuple(self._backends), config.vnodes)
        self.prober = HealthProber(self, config.probe_interval_s, config.probe_timeout_s)
        self._stopped = False
        # The event log and the registry are process-global, and an
        # in-process fleet (a test, a driver script) shares them with the
        # daemons and earlier routers: the dump keeps this router's
        # records born after this mark, and the totals it publishes
        # subtract these baselines.
        self._born_mono = time.monotonic()
        self._requests = obs.counter("router_requests_total",
                                     "router forward attempts by backend and outcome")
        self._failovers = obs.counter("router_failover_total",
                                      "forwards retried against the next ring owner")
        self._transitions = obs.counter("router_backend_state",
                                        "backend rotation-membership transitions")
        self._paths = obs.counter("router_request_path_total",
                                  "router forwards by direct/failover/exhausted path")
        self._latency = obs.bucket_histogram("router_request_seconds",
                                             "router-observed forward latency (e2e)")
        self._req_baseline = dict(obs.REGISTRY.peek("router_requests_total") or {})
        self._fo_baseline = dict(obs.REGISTRY.peek("router_failover_total") or {})
        #: last published breaker state a backend; a flip is an instant
        #: on the ``router-breaker`` track.
        self._breaker_seen = {name: "closed" for name in self._backends}
        self.slo = _slo.SLOEngine(_slo.router_slos(), clock=clock)

    # ── membership ───────────────────────────────────────────────────

    def start(self, probe: bool = True) -> None:
        """One probe round (the routing table is filled before the first
        request), then the prober's thread."""
        self.prober.probe_once()
        if probe:
            self.prober.start()

    def _transition(self, name: str, state: str) -> None:
        self._transitions.inc(1, backend=name, state=state)
        obs.emit("router_backend_state", status="ok", backend=name, state=state,
                 track="router-backend")

    def update_health(self, name: str, ready: bool, alive: bool, models: dict) -> None:
        with self._lock:
            b = self._backends[name]
            was = b.in_rotation()
            b.ready, b.alive = bool(ready), bool(alive)
            b.models = dict(models)
            now = b.in_rotation()
        if was != now:
            self._transition(name, "admitted" if now else "evicted")

    def set_cordon(self, name: str, cordoned: bool) -> None:
        """Administrative out-of-rotation (the rolling rotation's drain):
        new forwards skip the backend, in-flight ones complete."""
        with self._lock:
            b = self._backends[name]
            if b.cordoned == bool(cordoned):
                return
            b.cordoned = bool(cordoned)
        self._transition(name, "cordoned" if cordoned else "uncordoned")

    def in_rotation(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(n for n, b in self._backends.items() if b.in_rotation()))

    def in_flight(self, name: str) -> int:
        with self._lock:
            return self._backends[name].in_flight

    def probe_ready(self, name: str) -> bool:
        """The last probe's readiness and liveness, cordon ignored: what
        the rotation confirms while the backend is still cordoned."""
        with self._lock:
            b = self._backends[name]
            return b.ready and b.alive

    def bound_version(self, name: str, model: str):
        """The version backend ``name`` last probed for ``model``, or None."""
        with self._lock:
            entry = self._backends[name].models.get(model)
        if isinstance(entry, dict):
            return entry.get("version")
        return entry

    def candidates(self, model: str) -> list[str]:
        """The ring's owner order for ``model``, filtered to in-rotation
        backends whose breaker admits an attempt, at most
        1 + ``failover_hops`` long."""
        out: list[str] = []
        for name in self.ring.owners(model):
            with self._lock:
                ok = self._backends[name].in_rotation()
            if ok and self._backends[name].breaker.allow():
                # allow() is where open → half_open happens.
                self._note_breaker(name)
                out.append(name)
                if len(out) > self.config.failover_hops:
                    break
        return out

    # ── forwarding ───────────────────────────────────────────────────

    def _note_breaker(self, name: str) -> None:
        """Publish a breaker flip as a ``router-breaker`` instant, once a
        flip: steady traffic emits nothing."""
        state = self._backends[name].breaker.state
        with self._lock:
            if self._breaker_seen.get(name) == state:
                return
            self._breaker_seen[name] = state
        obs.emit("router_breaker", status="ok", backend=name, state=state,
                 track="router-breaker")

    def _attempt_failed(self, name: str, conn: _BackendConn | None) -> None:
        """One connection-level failure: the breaker, the attempt counter,
        and the dead connection's release."""
        self._backends[name].breaker.record_failure()
        self._note_breaker(name)
        self._requests.inc(1, backend=name, outcome="connection_error")
        if conn is not None:
            self._release(name, conn, reusable=False)

    def _acquire(self, name: str) -> _BackendConn:
        with self._lock:
            b = self._backends[name]
            conn = b.pool.pop() if b.pool else None
            b.in_flight += 1
        if conn is None:
            try:
                conn = _BackendConn(b.spec, self.config.connect_timeout_s,
                                    self.config.io_timeout_s)
            except OSError:
                with self._lock:
                    b.in_flight -= 1
                raise
        return conn

    def _release(self, name: str, conn: _BackendConn | None, reusable: bool) -> None:
        with self._lock:
            b = self._backends[name]
            b.in_flight -= 1
            if conn is not None and reusable:
                b.pool.append(conn)
                conn = None
        if conn is not None:
            conn.close()

    def forward_predict(self, header: dict, arrays: dict) -> tuple[dict, dict]:
        """Route one predict frame: each candidate in ring order, failing
        over on connection-level errors (a daemon's typed reject goes back
        to the client, whose retry may land on the same owner). Returns
        the reply ``(header, arrays)``."""
        model = str(header.get("model") or "default")
        rid = str(header.get("id", ""))
        hops = 0
        # Contiguous perf_counter intervals: every moment between t0 and
        # the last mark lands in one phase, over failover hops too, so the
        # phases sum to e2e.
        t0 = time.perf_counter()
        last = t0
        phases = {"connect_s": 0.0, "send_s": 0.0, "wait_s": 0.0, "reply_s": 0.0}

        def mark(phase: str) -> float:
            nonlocal last
            now = time.perf_counter()
            phases[phase] += now - last
            last = now
            return now

        with obs.span("router_request", request_id=rid, model=model) as sp:
            reply: dict | None = None
            out_arrays: dict = {}
            backend, outcome = "-", "unavailable"
            for name in self.candidates(model):
                if hops:
                    self._failovers.inc(1)
                    obs.emit("router_failover", status="ok", request_id=rid, backend=name,
                             hop=hops)
                hops += 1
                try:
                    conn = self._acquire(name)
                except OSError:
                    mark("connect_s")
                    self._attempt_failed(name, None)
                    continue
                mark("connect_s")
                try:
                    conn.send(header, arrays)
                except (protocol.ProtocolError, OSError):
                    mark("send_s")
                    self._attempt_failed(name, conn)
                    continue
                mark("send_s")
                try:
                    conn.wait_reply()
                except (protocol.ProtocolError, OSError):
                    mark("wait_s")
                    self._attempt_failed(name, conn)
                    continue
                mark("wait_s")
                try:
                    reply, out_arrays = conn.read_reply()
                except (protocol.ProtocolError, OSError):
                    # The backend died mid-stream (a SIGKILL's signature).
                    # The request id is the idempotency key: the same
                    # frame goes to the next owner.
                    mark("reply_s")
                    self._attempt_failed(name, conn)
                    continue
                self._backends[name].breaker.record_success()
                self._note_breaker(name)
                self._release(name, conn, reusable=True)
                backend = name
                outcome = ("ok" if reply.get("ok") else "reject" if reply.get("error")
                           else "error")
                self._requests.inc(1, backend=name, outcome=outcome)
                break
            if reply is None:
                # The candidate scan is connect work; building the reject
                # lands in reply_s.
                mark("connect_s")
                self._requests.inc(1, backend="-", outcome="unavailable")
                reply = {"ok": False, "id": rid, "error": BACKEND_UNAVAILABLE,
                         "message": f"no backend in rotation for model {model!r}",
                         "retry_after_s": self.config.retry_after_s}
            end = mark("reply_s")
            e2e = end - t0
            path = "exhausted" if backend == "-" else "failover" if hops > 1 else "direct"
            sp.set_attr("backend", backend)
            sp.set_attr("hops", hops - 1 if hops else 0)
            sp.set_attr("outcome", outcome)
            sp.set_attr("path", path)
            for key, value in phases.items():
                sp.set_attr(key, round(value, 9))
            sp.set_attr("e2e_s", round(e2e, 9))
            sp.set_status("ok" if outcome in ("ok", "reject") else "error")
            self._latency.observe(e2e, outcome=outcome)
            self._paths.inc(1, path=path)
            self.slo.tick()
        return reply, out_arrays

    def call_backend(self, name: str, header: dict,
                     arrays: dict | None = None) -> tuple[dict, dict]:
        """One op against a named backend (the supervisor's rotate, stats
        and dump channel). Connection errors propagate, and count as
        breaker evidence as on the routed path."""
        try:
            conn = self._acquire(name)
        except OSError:
            self._backends[name].breaker.record_failure()
            self._note_breaker(name)
            raise
        try:
            reply, out_arrays = conn.roundtrip(header, arrays or {})
        except (protocol.ProtocolError, OSError):
            self._backends[name].breaker.record_failure()
            self._note_breaker(name)
            self._release(name, conn, reusable=False)
            raise
        self._release(name, conn, reusable=True)
        return reply, out_arrays

    # ── stats and the merged dump ────────────────────────────────────

    def stats(self) -> dict:
        with self._lock:
            backends = {
                name: {"ready": b.ready, "alive": b.alive, "cordoned": b.cordoned,
                       "in_rotation": b.in_rotation(), "breaker": b.breaker.state,
                       "in_flight": b.in_flight, "models": dict(b.models)}
                for name, b in sorted(self._backends.items())
            }
        return {
            "role": "router",
            "backends": backends,
            "ring": {"vnodes": self.ring.vnodes, "backends": list(self.ring.backends)},
            "requests": self._born_counts("router_requests_total", self._req_baseline),
            "failover_total": self.failover_total(),
            "slo": self.slo.health(),
        }

    def _born_counts(self, name: str, baseline: dict) -> dict[str, int]:
        """Per-label-key counter totals since this router was built (zero
        deltas dropped)."""
        out: dict[str, int] = {}
        for key, v in sorted((obs.REGISTRY.peek(name) or {}).items()):
            n = int(v) - int(baseline.get(key, 0))
            if n > 0:
                out[key] = n
        return out

    def failover_total(self) -> int:
        return sum(self._born_counts("router_failover_total", self._fo_baseline).values())

    def request_counts(self) -> dict[str, dict[str, int]]:
        """``{backend: {outcome: n}}``: this router's own forwards to its
        own backends (and the null backend ``-``), the totals the fleet
        manifest publishes."""
        mine = set(self._backends) | {"-"}
        out: dict[str, dict[str, int]] = {}
        for key, v in self._born_counts("router_requests_total", self._req_baseline).items():
            labels = parse_label_key(key)
            backend = labels.get("backend", "?")
            if backend in mine:
                out.setdefault(backend, {})[labels.get("outcome", "?")] = int(v)
        return out

    def _own_records(self) -> list[dict]:
        """The router's records of the process-global event log, born
        after this router: its own families, and ``chaos_`` (a kill
        injected from the router's process belongs on the fleet
        timeline). A daemon span never appears twice in the merge."""
        born = self._born_mono - 1e-6
        return [r for r in obs.EVENTS.records()
                if r.get("start_mono_s", -1.0) >= born
                and str(r.get("name", "")).startswith(("router_", "fleet_", "chaos_"))]

    def dump_fleet(self, outdir: str) -> dict:
        """Merged fleet dump: every in-rotation daemon dumps its artifact
        set into ``outdir/daemon-<name>/`` (its own ``dump`` op), the
        router writes ``fleet_manifest.json`` with its request totals a
        backend, its own trace and SLO report into ``outdir/router/``,
        and then the merged fleet artifacts, a pure function of the
        directory (``observability/fleet_report.py``). Returns the
        manifest."""
        from ate_replication_causalml_torch.observability import fleet_report as _fleet_report

        os.makedirs(outdir, exist_ok=True)
        # The marker keeps the router trace non-empty, so its wall anchor
        # exists for the fleet re-base even with no backend admitted.
        obs.emit("router_dump", status="ok", track="router-backend",
                 dir=os.path.basename(outdir))
        backends: dict[str, dict] = {}
        for name in sorted(self._backends):
            with self._lock:
                up = self._backends[name].in_rotation()
            entry: dict = {"in_rotation": up, "dumped": False}
            if up:
                sub = os.path.join(outdir, f"daemon-{name}")
                try:
                    reply, _ = self.call_backend(name, {"op": "dump", "dir": sub})
                    entry["dumped"] = bool(reply.get("ok"))
                    entry["dir"] = f"daemon-{name}"
                except (protocol.ProtocolError, OSError) as e:
                    entry["error"] = f"{type(e).__name__}: {e}"
            backends[name] = entry
        manifest = {
            "schema_version": 1,
            "kind": "fleet_manifest",
            "backends": backends,
            "router": {"requests": self.request_counts(),
                       "failover_total": self.failover_total()},
            "router_dir": "router",
        }
        obs.atomic_write_json(os.path.join(outdir, "fleet_manifest.json"), manifest)
        # The router's own set, then the merged triple, recomputed from
        # the files alone, so the offline recomputation is byte-identical.
        rdir = os.path.join(outdir, "router")
        os.makedirs(rdir, exist_ok=True)
        trace = obs.build_trace(self._own_records(), meta={"tool": "router"})
        write_trace_json(os.path.join(rdir, "trace.json"), trace, force=True)
        obs.atomic_write_json(os.path.join(rdir, "slo_report.json"), self.slo.evaluate())
        _fleet_report.write_fleet_artifacts(outdir)
        return manifest

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self.prober.stop()
        with self._lock:
            conns = [c for b in self._backends.values() for c in b.pool]
            for b in self._backends.values():
                b.pool.clear()
        for c in conns:
            c.close()

    @property
    def stopped(self) -> bool:
        with self._lock:
            return self._stopped


# ── the router's admin endpoint (the daemon's HTTP shell) ───────────────

#: Routes served; anything else is a 404 with this list in the body.
ROUTER_ADMIN_ROUTES = ("/metrics", "/healthz", "/readyz", "/fleetz")


def handle_router_admin_path(router: RouterServer, path: str) -> tuple[int, str, bytes]:
    """Resolve one GET ``path`` against the router: the resolver
    ``AdminServer(handler=...)`` mounts.

    * ``/metrics``: the registry in Prometheus text format;
    * ``/healthz``: 200 with the breaker states and the router SLO burn
      until :meth:`RouterServer.stop`, 503 after;
    * ``/readyz``: 200 while at least one backend is in rotation;
    * ``/fleetz``: :meth:`RouterServer.stats`.
    """
    from ate_replication_causalml_torch.serving.admin import _json_bytes

    if path == "/metrics":
        from ate_replication_causalml_torch.observability.promtext import render_prom_text

        return 200, "text/plain; version=0.0.4", render_prom_text().encode()
    if path == "/healthz":
        with router._lock:
            items = sorted(router._backends.items())
        # Breaker states are read outside the router's lock: a breaker
        # locks itself.
        payload = {
            "role": "router",
            "state": "stopped" if router.stopped else "routing",
            "breakers": {n: b.breaker.state for n, b in items},
            "in_rotation": list(router.in_rotation()),
            "slo": router.slo.health(),
        }
        return (200 if not router.stopped else 503), "application/json", _json_bytes(payload)
    if path == "/readyz":
        rotation = router.in_rotation()
        ready = bool(rotation) and not router.stopped
        return (200 if ready else 503, "application/json",
                _json_bytes({"ready": ready, "role": "router", "in_rotation": list(rotation)}))
    if path == "/fleetz":
        return 200, "application/json", _json_bytes(router.stats())
    return (404, "application/json",
            _json_bytes({"error": "not found", "routes": list(ROUTER_ADMIN_ROUTES)}))


# ── wire serving (the client side) ──────────────────────────────────────


def handle_router_op(router: RouterServer, supervisor: "FleetSupervisor", header: dict,
                     arrays: dict):
    """One client frame → ``(reply_header, reply_arrays, stop?)``."""
    op = header.get("op")
    rid = str(header.get("id", ""))
    if op == "predict":
        reply, out = router.forward_predict(header, arrays)
        return reply, out, False
    if op == "ping":
        return {"ok": True, "op": "ping", "role": "router",
                "in_rotation": list(router.in_rotation())}, {}, False
    if op == "stats":
        return {"ok": True, "op": "stats", "stats": router.stats()}, {}, False
    if op == "dump":
        outdir = header.get("dir") or os.environ.get("ATE_TPU_METRICS_DIR")
        if not outdir:
            return {"ok": False, "id": rid, "error": "bad_request",
                    "message": "dump needs a 'dir' header field or "
                               "$ATE_TPU_METRICS_DIR"}, {}, False
        try:
            manifest = router.dump_fleet(outdir)
        except OSError as e:
            return {"ok": False, "id": rid, "error": "error",
                    "message": f"{type(e).__name__}: {e}"}, {}, False
        return {"ok": True, "op": "dump", "manifest": manifest}, {}, False
    if op == "rotate_all":
        checkpoint = header.get("checkpoint")
        if not checkpoint:
            return {"ok": False, "id": rid, "error": "bad_request",
                    "message": "rotate_all needs a 'checkpoint' header field"}, {}, False
        result = supervisor.rotate_all(str(checkpoint), model=str(header.get("model") or "default"),
                                       timeout_s=float(header.get("timeout_s") or 120.0))
        ok = all(s == "rotated" for s in result["statuses"].values()) and result["zero_downtime"]
        return {"ok": ok, "op": "rotate_all", **result}, {}, False
    if op == "shutdown":
        return {"ok": True, "op": "shutdown"}, {}, True
    return {"ok": False, "error": "bad_request", "message": f"unknown op {op!r}"}, {}, False


def serve_stream(router: RouterServer, supervisor: "FleetSupervisor", rstream, wstream) -> bool:
    """One client connection's framed loop; True when a ``shutdown`` op
    asked the router to exit."""
    while True:
        try:
            frame = protocol.read_frame(rstream)
        except protocol.ProtocolError as e:
            obs.emit("router_protocol_error", status="error", error=str(e))
            return False
        if frame is None:
            return False
        header, arrays = frame
        reply, out_arrays, stop = handle_router_op(router, supervisor, header, arrays)
        protocol.write_frame(wstream, reply, out_arrays)
        if stop:
            return True


def serve_socket(router: RouterServer, host: str = "127.0.0.1", port: int = 0,
                 on_bound: Callable[[int], None] | None = None) -> None:
    """The client accept loop, the daemon's shape: one reader thread a
    connection, a 0.25 s accept timeout so a stop underneath ends it,
    bounded joins on exit."""
    supervisor = FleetSupervisor(router)
    stop_evt = threading.Event()
    with socket.create_server((host, port)) as srv:
        srv.settimeout(0.25)
        bound = srv.getsockname()[1]
        obs.gauge("router_port", "bound router TCP port").set(bound)
        print(f"# routing on {host}:{bound}", file=sys.stderr, flush=True)
        if on_bound is not None:
            on_bound(bound)

        def _conn(conn: socket.socket) -> None:
            with conn:
                rw = conn.makefile("rwb")
                try:
                    if serve_stream(router, supervisor, rw, rw):
                        stop_evt.set()
                finally:
                    rw.close()

        threads: list[threading.Thread] = []
        conn_seq = 0
        while not stop_evt.is_set() and not router.stopped:
            threads = [t for t in threads if t.is_alive()]
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conn_seq += 1
            t = threading.Thread(target=_conn, args=(conn,), daemon=True,
                                 name=f"router-conn-{conn_seq}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(1.0)
    router.stop()


# ── the fleet-wide rolling rotation ─────────────────────────────────────


class FleetSupervisor:
    """Fleet-wide operations through the router's view: :meth:`rotate_all`
    cordons one daemon at a time (no new forwards, in-flight ones
    finish), rotates it from the one published checkpoint, confirms the
    advanced version by probe and readmits it before the next."""

    def __init__(self, router: RouterServer, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.router = router
        self._clock = clock
        self._sleep = sleep

    def _wait(self, pred: Callable[[], bool], deadline: float) -> bool:
        while not pred():
            if self._clock() >= deadline:
                return False
            self._sleep(0.01)
        return True

    def rotate_all(self, checkpoint: str, model: str = "default", timeout_s: float = 120.0,
                   on_step: Callable[[str, str, float], None] | None = None) -> dict:
        """Roll ``model`` onto ``checkpoint`` over every in-rotation
        daemon. Returns the statuses a backend, the probe-confirmed
        versions, each daemon's builds and captures after its swap
        (``post_swap_compiles``, its ``compile_events_in_window``: 0 by the
        daemon's contract), and ``zero_downtime``: a backend stayed in
        rotation at every step, checked at every transition.
        ``on_step(backend, step, seconds)`` gets each step's seconds
        (``drain``, ``rotate``, ``confirm``) as it ends."""
        statuses: dict[str, str] = {}
        versions: dict[str, object] = {}
        compiles: dict[str, object] = {}
        min_in_rotation = len(self.router.in_rotation())
        zero_downtime = min_in_rotation >= 1

        def note_rotation_floor() -> None:
            nonlocal min_in_rotation, zero_downtime
            n = len(self.router.in_rotation())
            min_in_rotation = min(min_in_rotation, n)
            if n < 1:
                zero_downtime = False

        def step(name: str, kind: str, t0: float) -> None:
            if on_step is not None:
                on_step(name, kind, time.perf_counter() - t0)

        for name in sorted(self.router.ring.backends):
            deadline = self._clock() + timeout_s
            if name not in self.router.in_rotation():
                statuses[name] = "not_in_rotation"
                continue
            if len(self.router.in_rotation()) <= 1:
                # Cordoning the last live backend is downtime: refuse this
                # daemon's turn instead.
                statuses[name] = "refused_no_capacity"
                zero_downtime = False
                continue
            before = self.router.bound_version(name, model)
            self.router.set_cordon(name, True)
            note_rotation_floor()
            try:
                t0 = time.perf_counter()
                drained = self._wait(lambda: self.router.in_flight(name) == 0, deadline)
                step(name, "drain", t0)
                if not drained:
                    statuses[name] = "drain_timeout"
                    continue
                t0 = time.perf_counter()
                try:
                    reply, _ = self.router.call_backend(
                        name, {"op": "rotate", "model": model, "checkpoint": checkpoint})
                except (protocol.ProtocolError, OSError) as e:
                    statuses[name] = f"unreachable:{type(e).__name__}"
                    continue
                step(name, "rotate", t0)
                status = str(reply.get("status", reply.get("error", "error")))
                statuses[name] = status
                if status != "rotated":
                    continue
                # Probe-confirm: ready, at a version past the one served
                # before the swap (never the rotate reply alone).
                t0 = time.perf_counter()
                confirmed = self._wait(
                    lambda: (_probe_ready(self.router, name)
                             and self.router.bound_version(name, model) not in (None, before)),
                    deadline)
                step(name, "confirm", t0)
                if not confirmed:
                    statuses[name] = "verify_timeout"
                    continue
                versions[name] = self.router.bound_version(name, model)
                try:
                    sreply, _ = self.router.call_backend(name, {"op": "stats"})
                    compiles[name] = (sreply.get("stats") or {}).get("compile_events_in_window")
                except (protocol.ProtocolError, OSError):
                    compiles[name] = None
            finally:
                self.router.set_cordon(name, False)
                self.router.prober.probe_once()
                note_rotation_floor()
            obs.emit("fleet_rotation", status="ok", backend=name, model=model,
                     outcome=statuses[name])
        result = {
            "model": model,
            "checkpoint": checkpoint,
            "statuses": statuses,
            "versions": versions,
            "post_swap_compiles": compiles,
            "zero_downtime": zero_downtime,
            "min_in_rotation": min_in_rotation,
        }
        obs.emit("fleet_rotation_all", model=model,
                 status="ok" if all(s == "rotated" for s in statuses.values()) and zero_downtime
                 else "error",
                 rotated=sum(1 for s in statuses.values() if s == "rotated"))
        return result


def _probe_ready(router: RouterServer, name: str) -> bool:
    """One forced probe round, then whether ``name`` probes ready (not
    the in-rotation set: the backend under confirmation is cordoned)."""
    router.prober.probe_once()
    return router.probe_ready(name)


# ── entry point ─────────────────────────────────────────────────────────


def main(argv: list[str] | None = None) -> int:
    """``python -m ate_replication_causalml_torch.serving.router``: the
    router over running daemons, with the JAX package's
    ``scripts/router.py`` flags::

        python -m ate_replication_causalml_torch.serving.router \\
            --backends b0=127.0.0.1:7771@8871,b1=127.0.0.1:7772@8872 --port 7700

    Knobs default from the ``ATE_TPU_ROUTER_*`` variables; flags
    override. SIGTERM stops the router (the daemons drain on their own)."""
    ap = argparse.ArgumentParser(description="Start the serving router over N daemons.")
    ap.add_argument("--backends", required=True,
                    help="comma-separated name=host:port@adminport fleet spec "
                         "(adminport = the daemon's --admin-port)")
    ap.add_argument("--port", type=int, default=0,
                    help="router TCP port (0 = ephemeral; bound port printed to stderr)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--vnodes", type=int, default=None,
                    help="virtual nodes a backend on the hash ring "
                         "(default $ATE_TPU_ROUTER_VNODES or 64)")
    ap.add_argument("--probe-s", type=float, default=None,
                    help="health-probe interval in seconds "
                         "(default $ATE_TPU_ROUTER_PROBE_S or 0.25)")
    ap.add_argument("--failover", type=int, default=None,
                    help="max failover hops past the ring owner "
                         "(default $ATE_TPU_ROUTER_FAILOVER or 2)")
    ap.add_argument("--admin-port", type=int, default=None,
                    help="GET-only admin endpoint (/metrics /healthz /readyz /fleetz; "
                         "0 = ephemeral; default $ATE_TPU_ROUTER_ADMIN_PORT, unset = off)")
    args = ap.parse_args(argv)

    import signal

    from ate_replication_causalml_torch.serving.admin import AdminServer

    overrides: dict = {}
    if args.vnodes is not None:
        overrides["vnodes"] = args.vnodes
    if args.probe_s is not None:
        overrides["probe_interval_s"] = args.probe_s
    if args.failover is not None:
        overrides["failover_hops"] = args.failover
    config = RouterConfig.from_env(parse_backend_specs(args.backends), **overrides)
    router = RouterServer(config)
    router.start()

    admin_port = args.admin_port
    if admin_port is None:
        raw = os.environ.get("ATE_TPU_ROUTER_ADMIN_PORT", "").strip()
        if raw:
            try:
                admin_port = int(raw)
            except ValueError:
                raise SystemExit(f"ATE_TPU_ROUTER_ADMIN_PORT={raw!r}: expected an "
                                 "integer") from None
    admin = None
    if admin_port is not None:
        admin = AdminServer(router, host=args.host, handler=handle_router_admin_path,
                            thread_name="router-admin")
        print(f"# admin endpoint on {args.host}:{admin.start(admin_port)}",
              file=sys.stderr, flush=True)

    def _sigterm(signum, frame):
        threading.Thread(target=router.stop, name="sigterm-stop", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread: embedded use, no signal wiring
    print("# fleet: " + " ".join(f"{s.name}={s.host}:{s.port}@{s.admin_port}"
                                 for s in config.backends)
          + f" in_rotation={list(router.in_rotation())}", file=sys.stderr, flush=True)
    try:
        serve_socket(router, args.host, args.port)
    finally:
        if admin is not None:
            admin.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
