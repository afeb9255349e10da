"""Live admin endpoint of the CATE serving daemon.

Port of ``ate_replication_causalml_tpu/serving/admin.py``: the same
routes, statuses and bodies. A small read-only HTTP surface on its own
thread, so an operator (or a Kubernetes probe) can look inside a
running daemon without speaking the binary serving protocol:

* ``/metrics``: the registry in Prometheus text exposition format
  (``observability/promtext.py``), scrape-ready;
* ``/healthz``: liveness: 200 with a JSON body (lifecycle state, the
  no-build window term, per-lane heartbeat ages, SLO burn rates, the
  statistical health) unless the daemon is stopped OR its dispatcher
  heartbeat has gone stale past the watchdog bound: a process whose one
  card-owning thread is wedged is not alive. A degraded daemon with a
  beating dispatcher is recovering, so healthz stays 200 while the body
  says so;
* ``/readyz``: readiness: 200 only while the lifecycle is ``serving``
  (degraded, starting, draining, stopped: 503), with the model-binding
  table in the body. A rotation never flips it;
* ``/varz``: the registry's cheap ``peek()`` view as JSON.

GET only (anything else gets the stdlib's 501), fixed routes, no query
parameters, responses built from in-memory state. Off by default: the
daemon starts it only when ``ATE_TPU_SERVE_ADMIN_PORT`` (or
``ServeConfig.admin_port``) is set. The handler core is a pure function
(:func:`handle_admin_path`), so tests drive it without binding a port.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ate_replication_causalml_torch.observability import registry as _registry

#: routes served; anything else is a 404 with this list in the body.
ROUTES = ("/metrics", "/healthz", "/readyz", "/varz")


def varz_payload(registry: _registry.MetricsRegistry | None = None) -> dict:
    """Every family's ``peek_labeled()`` view:
    ``{family: [{"labels": {...}, "value": v}, ...]}``, parsed by the
    registry's one label-key parser. Cheap: a dict copy under the
    registry lock."""
    reg = registry if registry is not None else _registry.REGISTRY
    out: dict = {}
    for m in reg.metrics():
        samples = reg.peek_labeled(m.name)
        if samples:
            out[m.name] = [
                {"labels": labels, "value": value}
                for labels, value in samples
            ]
    return out


def handle_admin_path(server, path: str) -> tuple[int, str, bytes]:
    """Resolve one GET ``path`` against the daemon: the transport-free
    core the HTTP handler (and the tests) call. ``server`` is
    duck-typed: ``lifecycle.state``, ``compile_events_in_window()`` and
    ``slo.health()`` are the only required touchpoints, so a stub flips
    the probes without a real daemon."""
    if path == "/metrics":
        from ate_replication_causalml_torch.observability.promtext import render_prom_text

        return 200, "text/plain; version=0.0.4", render_prom_text().encode()
    if path == "/healthz":
        state = server.lifecycle.state
        # Liveness detail: per-lane heartbeat ages and the watchdog's
        # stall verdict, duck-typed with defaults for stubs.
        ages = getattr(server, "heartbeat_ages", dict)()
        stalled = tuple(getattr(server, "stalled_lanes", tuple)())
        # Statistical health, duck-typed like the watchdog fields.
        stat = getattr(server, "stat", None)
        payload = {
            "state": state,
            "compile_events_in_window": server.compile_events_in_window(),
            "heartbeats": {k: round(v, 6) for k, v in ages.items()},
            "stalled_lanes": list(stalled),
            "slo": server.slo.health(),
            "stat_health": stat.health() if stat is not None else {},
        }
        # A wedged dispatcher is a liveness failure even though the
        # process (and this probe thread) are up: restart-worthy, which
        # is what a 503 on healthz tells the orchestrator.
        alive = state != "stopped" and "dispatch" not in stalled
        code = 200 if alive else 503
        return code, "application/json", _json_bytes(payload)
    if path == "/readyz":
        state = server.lifecycle.state
        ready = state == "serving"
        # Model-binding table: a router builds its routing view from
        # this body alone. Duck-typed with a default for stubs.
        models = getattr(server, "model_bindings", dict)()
        return (
            200 if ready else 503,
            "application/json",
            _json_bytes({"ready": ready, "state": state, "models": models}),
        )
    if path == "/varz":
        return 200, "application/json", _json_bytes(varz_payload())
    return (
        404,
        "application/json",
        _json_bytes({"error": "not found", "routes": list(ROUTES)}),
    )


def _json_bytes(payload: dict) -> bytes:
    return (json.dumps(payload, indent=1, sort_keys=True) + "\n").encode()


class AdminRequestHandler(BaseHTTPRequestHandler):
    """GET-only shim over the server's path resolver (by default
    :func:`handle_admin_path`). The owning ``ThreadingHTTPServer`` carries
    the daemon (or the router) as ``cate_server``."""

    server_version = "ate-serve-admin/1"
    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802 — stdlib handler contract
        try:
            hb = getattr(self.server.cate_server, "heartbeats", None)
            if hb is not None:
                # The admin lane's own liveness stamp: a probe that
                # answers is a heartbeat.
                hb.beat("admin")
            handler = getattr(self.server, "path_handler", handle_admin_path)
            code, ctype, body = handler(
                self.server.cate_server, self.path.split("?", 1)[0]
            )
        except Exception as e:  # noqa: BLE001 — a probe must answer
            # with a 500, never kill its connection thread replyless.
            code, ctype = 500, "text/plain"
            body = f"{type(e).__name__}: {e}\n".encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        # Probes arrive every few seconds forever; stderr stays quiet.
        pass


class AdminServer:
    """Owns the admin HTTP listener's lifetime beside a daemon.

    ``handler`` swaps the transport-free path resolver: the daemon keeps
    :func:`handle_admin_path`, the fleet router passes its own
    (``serving/router.py::handle_router_admin_path``), so both admin
    planes share this one HTTP shell (GET-only, a 500 and never a dead
    connection, silent logs)."""

    def __init__(self, cate_server, host: str = "127.0.0.1",
                 handler=handle_admin_path, thread_name: str = "serving-admin"):
        self._cate_server = cate_server
        self._host = host
        self._handler = handler
        self._thread_name = thread_name
        self._lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self, port: int = 0) -> int:
        """Bind (0 = ephemeral) and serve on a daemon thread; returns
        the bound port. Idempotent — a second start returns the
        existing port."""
        with self._lock:
            if self._httpd is not None:
                return self._httpd.server_address[1]
            httpd = ThreadingHTTPServer(
                (self._host, int(port)), AdminRequestHandler
            )
            httpd.daemon_threads = True
            httpd.cate_server = self._cate_server
            httpd.path_handler = self._handler
            self._httpd = httpd
            t = threading.Thread(
                target=httpd.serve_forever, name=self._thread_name,
                daemon=True,
            )
            self._thread = t
        t.start()
        return httpd.server_address[1]

    @property
    def port(self) -> int | None:
        with self._lock:
            return (
                None if self._httpd is None
                else self._httpd.server_address[1]
            )

    def stop(self, timeout: float | None = 5.0) -> None:
        with self._lock:
            httpd, t = self._httpd, self._thread
            self._httpd = None
            self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if t is not None:
            t.join(timeout)
