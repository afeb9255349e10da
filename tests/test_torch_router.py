"""The port's serving router against the JAX package's, on the CPU.

* The ring: ``owner`` / ``owners`` / ``assignment`` equal the JAX ring's
  for 1,000 seeded keys at 3, 5 and 8 backends, and after
  ``with_backend`` / ``without_backend``; ``parse_backend_specs``,
  ``RouterConfig.from_env`` and the vocabularies equal.
* The breaker: its state sequence under a scripted clock equals the JAX
  breaker's.
* Both routers over the same stub fleet (the JAX tests' stub daemons and
  wire, copied here): one scripted sequence of probes, readiness flips,
  mid-stream deaths, cordons and requests gives equal reply headers,
  in-rotation sets, breaker states, deltas of the five counter families,
  admin bodies (time-valued fields masked), wire-op replies, fleet
  manifests and ``rotate_all`` results (``refused_no_capacity`` too).
* Telescoping: the ``router_request`` span's four phases sum to
  ``e2e_s`` within 1 µs on the direct, failover and exhausted paths.
* The ``daemon`` chaos scope, ``router_slos`` and their ``evaluate()``,
  and the watchdog's ``lanes`` / ``age`` / ``is_stalled``: equal.
* An in-process micro fleet: two port daemons on the CPU behind the
  port's router, a seeded replay with ``rotate_all`` halfway: every reply
  bit for bit the port's offline predict of its version, no build and
  no capture after either swap, and a fleet dump the JAX package's
  validator passes and whose merged artifacts both packages write byte
  for byte.
* The import guard: with the parent package stubbed, the router and the
  fleet report load neither torch nor jax.

Registry reads are deltas (the port's registry is process-global). JAX
package code runs with that package's registry and event log swapped for
fresh ones, so its own tests' totals stay theirs.
"""

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import observability as tobs
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.observability import fleet_report as tfr
from ate_replication_causalml_torch.observability import registry as treg
from ate_replication_causalml_torch.observability import slo as tslo
from ate_replication_causalml_torch.resilience import chaos as tchaos
from ate_replication_causalml_torch.resilience import watchdog as twd
from ate_replication_causalml_torch.serving import daemon as tdaemon
from ate_replication_causalml_torch.serving import loadgen as tlg
from ate_replication_causalml_torch.serving import protocol
from ate_replication_causalml_torch.serving import router as trt
from ate_replication_causalml_torch.serving.admin import AdminServer
from ate_replication_causalml_torch.serving.client import CateClient, ServingUnavailable
from ate_replication_causalml_torch.serving.coalescer import BucketPlan
from ate_replication_causalml_torch.utils.checkpoint import save_fitted
from ate_replication_causalml_tpu import observability as jobs
from ate_replication_causalml_tpu.observability import fleet_report as jfr
from ate_replication_causalml_tpu.observability import registry as jreg
from ate_replication_causalml_tpu.observability import slo as jslo
from ate_replication_causalml_tpu.resilience import chaos as jchaos
from ate_replication_causalml_tpu.resilience import watchdog as jwd
from ate_replication_causalml_tpu.serving import router as jrt

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "scripts"))
import check_metrics_schema as cms  # noqa: E402

FAMILIES = ("router_requests_total", "router_failover_total", "router_backend_state",
            "router_request_path_total")
PHASES = ("connect_s", "send_s", "wait_s", "reply_s")


@contextlib.contextmanager
def _jax_telemetry_apart():
    """Swap the JAX package's process-global registry and event log for
    fresh ones while JAX package code runs here, and put them back."""
    from ate_replication_causalml_tpu.observability import device as jdev
    from ate_replication_causalml_tpu.observability import events as jev

    saved = (jreg.REGISTRY, jobs.REGISTRY, jdev.REGISTRY, jev.EVENTS, jobs.EVENTS)
    reg, log = jreg.MetricsRegistry(), jev.EventLog()
    jreg.REGISTRY = jobs.REGISTRY = jdev.REGISTRY = reg
    jev.EVENTS = jobs.EVENTS = log
    try:
        yield reg, log
    finally:
        jreg.REGISTRY, jobs.REGISTRY, jdev.REGISTRY, jev.EVENTS, jobs.EVENTS = saved


@contextlib.contextmanager
def _side(pkg: str):
    """The router module and registry of one package, the JAX package's
    apart from its tests' globals."""
    if pkg == "jax":
        with _jax_telemetry_apart() as (reg, _):
            yield jrt, reg
    else:
        yield trt, treg.REGISTRY


def _snap(reg) -> dict:
    out = {name: dict(reg.peek(name) or {}) for name in FAMILIES}
    hist = reg.family("router_request_seconds")
    out["router_request_seconds"] = ({} if hist is None else
                                     {k: s["count"] for k, s in hist.peek_counts().items()})
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for fam in after:
        d = {k: v - before[fam].get(k, 0) for k, v in after[fam].items()
             if v - before[fam].get(k, 0)}
        if d:
            out[fam] = d
    return out


# ── the ring, the specs and the config ──────────────────────────────────


@pytest.mark.parametrize("n", [3, 5, 8])
def test_ring_assignment_and_owners_equal_jax(n):
    names = [f"b{i}" for i in range(n)]
    rng = np.random.default_rng(n)
    keys = [f"model-{v}" for v in rng.integers(0, 2**40, size=1000)]
    t, j = trt.ConsistentHashRing(names), jrt.ConsistentHashRing(names)
    assert t.backends == j.backends and t.assignment(keys) == j.assignment(keys)
    assert [t.owners(k) for k in keys] == [j.owners(k) for k in keys]
    assert [t.owners(k, 2) for k in keys[:100]] == [j.owners(k, 2) for k in keys[:100]]
    for tt, jj in ((t.with_backend("zz"), j.with_backend("zz")),
                   (t.without_backend("b1"), j.without_backend("b1")),
                   (trt.ConsistentHashRing(names, vnodes=7, salt="s"),
                    jrt.ConsistentHashRing(names, vnodes=7, salt="s"))):
        assert tt.backends == jj.backends and tt.assignment(keys) == jj.assignment(keys)
        assert [tt.owners(k) for k in keys] == [jj.owners(k) for k in keys]


def test_ring_validation_equals_jax():
    for args, kw in ((("a", "a", "b"),), {}), (((),), {}), ((("a",),), {"vnodes": 0}):
        with pytest.raises(ValueError) as te:
            trt.ConsistentHashRing(*args, **kw)
        with pytest.raises(ValueError) as je:
            jrt.ConsistentHashRing(*args, **kw)
        assert str(te.value) == str(je.value)


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("raise", str(e))


def test_backend_specs_config_and_vocabularies_equal_jax(monkeypatch):
    for spec in ("b0=127.0.0.1:7771@8871, b1=10.0.0.2:7772@8872,", "", "b0", "b0=host",
                 "b0=host:1", "b0=host:x@2", "b0=host:1@y", "b0=host:0@2", "b0=host:1@70000",
                 "b0=h:1@2,b0=h:3@4", "a=[::1]:5@6"):
        t, j = _outcome(trt.parse_backend_specs, spec), _outcome(jrt.parse_backend_specs, spec)
        assert t[0] == j[0] and (t[0] == "raise" and t == j
                                 or [vars(s) for s in t[1]] == [vars(s) for s in j[1]])
    spec = "b0=127.0.0.1:7771@8871"
    envs = [{}, {"ATE_TPU_ROUTER_VNODES": "16", "ATE_TPU_ROUTER_PROBE_S": "0.5",
                 "ATE_TPU_ROUTER_FAILURES": "5", "ATE_TPU_ROUTER_COOLDOWN_S": "2.5",
                 "ATE_TPU_ROUTER_FAILOVER": "0", "ATE_TPU_ROUTER_RETRY_AFTER_S": "0.2"},
            {"ATE_TPU_ROUTER_VNODES": "zero"}, {"ATE_TPU_ROUTER_FAILURES": "0"},
            {"ATE_TPU_ROUTER_PROBE_S": "-1"}, {"ATE_TPU_ROUTER_FAILOVER": "-1"}]
    for env in envs:
        for k in envs[1]:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for kw in ({}, {"vnodes": 8}):
            t = _outcome(trt.RouterConfig.from_env, spec, **kw)
            j = _outcome(jrt.RouterConfig.from_env, spec, **kw)
            if t[0] == "ok":
                t = ("ok", {k: v for k, v in vars(t[1]).items() if k != "backends"})
                j = ("ok", {k: v for k, v in vars(j[1]).items() if k != "backends"})
            assert t == j, env
    assert trt.OUTCOMES == jrt.OUTCOMES == tuple(cms._ROUTER_OUTCOMES)
    assert (trt.BACKEND_UNAVAILABLE, trt.DEFAULT_VNODES, trt.ROUTER_ADMIN_ROUTES) == (
        jrt.BACKEND_UNAVAILABLE, jrt.DEFAULT_VNODES, jrt.ROUTER_ADMIN_ROUTES)


# ── the breaker ─────────────────────────────────────────────────────────


def _breaker_trace(mod) -> list:
    clock = [0.0]
    br = mod.CircuitBreaker(threshold=3, cooldown_s=1.0, clock=lambda: clock[0])
    script = ["allow", "fail", "fail", "allow", "fail", "allow", ("t", 0.5), "allow",
              ("t", 1.0), "allow", "allow", "fail", ("t", 1.5), "allow", ("t", 2.0), "allow",
              "ok", "allow", "fail", "fail", "allow", ("t", 9.0), "fail", "allow", ("t", 10.0),
              "allow", "fail", ("t", 11.0), "allow", "ok"]
    out = []
    for step in script:
        if isinstance(step, tuple):
            clock[0] = step[1]
        elif step == "allow":
            out.append(br.allow())
        elif step == "fail":
            br.record_failure()
        else:
            br.record_success()
        out.append(br.state)
    return out


def test_breaker_state_sequence_equals_jax():
    assert _breaker_trace(trt) == _breaker_trace(jrt)
    for mod in (trt, jrt):
        with pytest.raises(ValueError):
            mod.CircuitBreaker(threshold=0)


# ── stub daemons behind a real admin endpoint and wire loop ─────────────


class _StubLifecycle:
    def __init__(self):
        self.state = "serving"


class _StubSLO:
    @staticmethod
    def health():
        return {"burning": [], "worst_burn": 0.0}


class _StubDaemon:
    """What ``handle_admin_path`` and the router's wire ops touch:
    lifecycle.state, compile_events_in_window(), slo.health(),
    model_bindings()."""

    def __init__(self, name: str, fill: float):
        self.name = name
        self.fill = float(fill)
        self.version = 1
        self.lifecycle = _StubLifecycle()
        self.slo = _StubSLO()
        self.served: list[str] = []
        self.rotations: list[tuple[str, str]] = []
        self.die_midstream = False

    def compile_events_in_window(self) -> int:
        return 0

    def model_bindings(self) -> dict:
        return {m: {"version": self.version, "checkpoint": f"/{self.name}.npz"}
                for m in ("default", "m2", "m3")}


class _StubWire:
    """A daemon wire stand-in on the real protocol, answering predict with
    a backend-identifying fill value."""

    def __init__(self, stub: _StubDaemon):
        self.stub = stub
        self._srv = socket.create_server(("127.0.0.1", 0))
        self._srv.settimeout(0.1)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept, daemon=True,
                                        name=f"stubwire-{stub.name}")
        self._thread.start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._stream, args=(conn,), daemon=True).start()

    def _stream(self, conn: socket.socket) -> None:
        with conn:
            rw = conn.makefile("rwb")
            while not self._stop.is_set():
                try:
                    frame = protocol.read_frame(rw)
                except (protocol.ProtocolError, OSError):
                    return
                if frame is None:
                    return
                header, arrays = frame
                rid = str(header.get("id", ""))
                op = header.get("op")
                if op == "predict":
                    if self.stub.die_midstream:
                        return  # close replyless: a SIGKILL's signature
                    self.stub.served.append(rid)
                    n = int(arrays["x"].shape[0])
                    reply = {"ok": True, "id": rid, "model": str(header.get("model") or "default"),
                             "model_version": self.stub.version}
                    out = {"cate": np.full(n, self.stub.fill, np.float32),
                           "variance": np.zeros(n, np.float32)}
                elif op == "rotate":
                    self.stub.version += 1
                    self.stub.rotations.append((str(header.get("model")),
                                                str(header.get("checkpoint"))))
                    reply, out = {"ok": True, "id": rid, "status": "rotated"}, {}
                elif op == "stats":
                    reply, out = {"ok": True, "stats": {"compile_events_in_window": 0}}, {}
                else:
                    reply, out = {"ok": False, "id": rid, "error": "bad_request",
                                  "message": f"stub: unknown op {op!r}"}, {}
                try:
                    protocol.write_frame(rw, reply, out)
                except (OSError, ValueError):
                    return

    def kill(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(2.0)


@pytest.fixture
def stub_fleet():
    """Factory of N-stub fleets fronted by either package's router; tears
    everything down."""
    created: list[tuple] = []

    def make(rt, n: int = 3, **cfg_overrides):
        stubs, wires, admins, specs = {}, {}, [], []
        for i in range(n):
            name = f"s{i}"
            stub = _StubDaemon(name, fill=float(i + 1))
            wire = _StubWire(stub)
            adm = AdminServer(stub)
            stubs[name], wires[name] = stub, wire
            admins.append(adm)
            specs.append(rt.BackendSpec(name, "127.0.0.1", wire.port, adm.start(0)))
        cfg = dict(probe_interval_s=0.05, probe_timeout_s=2.0, connect_timeout_s=2.0,
                   io_timeout_s=5.0, failure_threshold=2, cooldown_s=0.2)
        cfg.update(cfg_overrides)
        router = rt.RouterServer(rt.RouterConfig(backends=tuple(specs), **cfg))
        created.append((router, wires, admins))
        return router, stubs, wires

    yield make
    for router, wires, admins in created:
        router.stop()
        for w in wires.values():
            w.kill()
        for a in admins:
            a.stop()


def _predict(router, rid: str, model: str, n: int = 3):
    return router.forward_predict({"op": "predict", "id": rid, "model": model},
                                  {"x": np.zeros((n, 4), np.float32)})


#: Keys of the admin and stats bodies whose values are clock readings.
_TIME_KEYS = ("burn", "rate", "_s", "age", "unix")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<t>" if any(t in k for t in _TIME_KEYS) and isinstance(v, float)
                    else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _admin_bodies(rt, router) -> dict:
    out = {}
    for path in ("/readyz", "/healthz", "/fleetz", "/nope"):
        code, ctype, body = rt.handle_router_admin_path(router, path)
        out[path] = (code, ctype, _mask(json.loads(body)))
    return out


def _scripted_episode(rt, reg, make, tmp_path) -> dict:
    """One scripted sequence against a fresh 3-stub fleet; everything it
    observes."""
    router, stubs, _ = make(rt, 3, failure_threshold=2, cooldown_s=30.0)
    out: dict = {}
    before = _snap(reg)
    router.start(probe=False)
    out["in_rotation"] = [router.in_rotation()]
    out["versions"] = {n: router.bound_version(n, m) for n in stubs for m in ("default", "m2")}
    replies = []

    def predict(rid, model):
        reply, arrays = _predict(router, rid, model)
        replies.append((reply, float(arrays["cate"][0]) if arrays else None))

    for model in ("default", "m2", "m3"):
        predict(f"rt-{model}", model)
    owner, second = router.ring.owners("default", 2)
    # Readiness flips: degraded is evicted but alive; stopped is neither.
    stubs[owner].lifecycle.state = "degraded"
    router.prober.probe_once()
    out["in_rotation"].append(router.in_rotation())
    predict("ev0", "default")
    stubs[owner].lifecycle.state = "serving"
    stubs[second].lifecycle.state = "stopped"
    router.prober.probe_once()
    out["in_rotation"].append(router.in_rotation())
    predict("ev1", "default")
    stubs[second].lifecycle.state = "serving"
    router.prober.probe_once()
    out["in_rotation"].append(router.in_rotation())
    # Mid-stream deaths: two failovers open the threshold-2 breaker, and
    # then the dead owner is skipped outright.
    predict("fo-warm", "default")
    stubs[owner].die_midstream = True
    for i in range(2):
        predict(f"fo{i}", "default")
    out["breakers"] = {n: router.stats()["backends"][n]["breaker"] for n in stubs}
    predict("fo-open", "default")
    # Every backend cordoned: the typed reject, and /readyz 503.
    for name in stubs:
        router.set_cordon(name, True)
    predict("un0", "default")
    out["admin_cordoned"] = _admin_bodies(rt, router)
    for name in stubs:
        router.set_cordon(name, False)
    stubs[owner].die_midstream = False
    out["admin"] = _admin_bodies(rt, router)
    sup = rt.FleetSupervisor(router)
    out["ops"] = [rt.handle_router_op(router, sup, h, {})[::2] for h in (
        {"op": "ping"}, {"op": "dump"}, {"op": "rotate_all"}, {"op": "wat"},
        {"op": "shutdown"})]
    out["rotate_all"] = sup.rotate_all("/pub/model-v2.npz", model="default", timeout_s=10.0)
    out["rotations"] = {n: s.rotations for n, s in stubs.items()}
    out["in_rotation"].append(router.in_rotation())
    predict("post", "m2")
    out["replies"] = replies
    out["manifest"] = router.dump_fleet(str(tmp_path))
    out["stats"] = _mask(router.stats())
    out["counters"] = _delta(before, _snap(reg))
    return out


def test_routers_over_one_stub_fleet_equal_jax(stub_fleet, tmp_path, monkeypatch):
    monkeypatch.delenv("ATE_TPU_METRICS_DIR", raising=False)
    got = {}
    for pkg in ("jax", "port"):
        with _side(pkg) as (rt, reg):
            got[pkg] = _scripted_episode(rt, reg, stub_fleet, tmp_path / pkg)
    port, jax = got["port"], got["jax"]
    for key in port:
        assert port[key] == jax[key], key
    # What the episode holds, beyond the equality.
    assert port["counters"]["router_failover_total"] == {"": 2.0}
    assert port["counters"]["router_request_path_total"] == {
        "path=direct": 8.0, "path=failover": 2.0, "path=exhausted": 1.0}
    assert port["rotate_all"]["statuses"] == {"s0": "rotated", "s1": "rotated", "s2": "rotated"}
    assert port["rotate_all"]["min_in_rotation"] == 2
    assert port["admin_cordoned"]["/readyz"][0] == 503
    assert cms.validate_fleet_dump(str(tmp_path / "port")) == []


def test_rotate_all_refuses_the_last_backend_equal_jax(stub_fleet):
    got = {}
    for pkg in ("jax", "port"):
        with _side(pkg) as (rt, _):
            router, stubs, _ = stub_fleet(rt, 1)
            router.start(probe=False)
            got[pkg] = (rt.FleetSupervisor(router).rotate_all("/pub/v2.npz", timeout_s=5.0),
                        stubs["s0"].rotations, router.in_rotation())
    assert got["port"] == got["jax"]
    assert got["port"][0]["statuses"] == {"s0": "refused_no_capacity"}


# ── the router's own behaviour: telescoping, wire, admin over HTTP ──────


def _router_spans(since: float) -> list[dict]:
    return [r for r in tobs.EVENTS.records()
            if r["name"] == "router_request" and r["start_mono_s"] >= since]


@pytest.mark.parametrize("path", ["direct", "failover", "exhausted"])
def test_forward_phases_telescope_to_e2e(stub_fleet, path):
    router, stubs, _ = stub_fleet(trt, 3, failure_threshold=2, cooldown_s=30.0)
    router.start(probe=False)
    owner = router.ring.owner("default")
    assert _predict(router, "warm", "default")[0]["ok"]
    if path == "failover":
        stubs[owner].die_midstream = True
    if path == "exhausted":
        for name in stubs:
            router.set_cordon(name, True)
    t0 = time.monotonic()
    for i in range(4):
        _predict(router, f"ph{i}", "default")
    recs = _router_spans(t0)
    assert len(recs) == 4 and {r["attrs"]["path"] for r in recs} >= {path}
    for rec in recs:
        a = rec["attrs"]
        assert abs(sum(a[k] for k in PHASES) - a["e2e_s"]) <= 1e-6, a
    if path == "exhausted":
        assert all(r["status"] == "error" and r["attrs"]["backend"] == "-" for r in recs)


def test_wire_serving_and_client_absorbs_backend_unavailable(stub_fleet):
    router, stubs, _ = stub_fleet(trt, 2)
    router.start(probe=False)
    bound: list[int] = []
    evt = threading.Event()
    t = threading.Thread(target=trt.serve_socket, args=(router,),
                         kwargs=dict(port=0, on_bound=lambda p: (bound.append(p), evt.set())),
                         daemon=True)
    t.start()
    assert evt.wait(10)
    client = CateClient.connect("127.0.0.1", bound[0], timeout=10.0)
    try:
        x = np.zeros((3, 4), np.float32)
        cate, _, header = client.predict_full(x, request_id="wr0", model="m2")
        assert header["model"] == "m2" and float(cate[0]) == stubs[router.ring.owner("m2")].fill
        for name in stubs:
            router.set_cordon(name, True)
        with pytest.raises(ServingUnavailable) as ei:
            client.predict_full(x, request_id="wr1", max_retries=1)
        assert ei.value.code == trt.BACKEND_UNAVAILABLE
        for name in stubs:
            router.set_cordon(name, False)
        cate, _, header = client.predict_full(x, request_id="wr2")
        assert header["ok"] and len(cate) == 3
    finally:
        client.close()
        router.stop()
        t.join(5)
    assert not t.is_alive()


def test_router_admin_over_real_http(stub_fleet):
    import urllib.error
    import urllib.request

    router, _, _ = stub_fleet(trt, 1)
    router.start(probe=False)
    admin = AdminServer(router, handler=trt.handle_router_admin_path, thread_name="router-admin")
    port = admin.start(0)
    try:
        assert admin._thread.name == "router-admin"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=10) as resp:
            assert resp.status == 200 and json.load(resp)["ready"] is True
        router.stop()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert ei.value.code == 503 and json.load(ei.value)["state"] == "stopped"
    finally:
        admin.stop()


# ── chaos, SLOs and the watchdog ────────────────────────────────────────


def test_daemon_kill_plan_and_record_equal_jax():
    for seed in range(64):
        for names in (("b0",), ("b0", "b1"), ("b0", "b1", "b2"), ("a", "b", "c", "d", "e")):
            for kill in (0, 1, 2):
                spec = f"daemon:kill={kill},seed={seed}"
                t = tchaos.ChaosInjector(tchaos.parse_chaos(spec))
                j = jchaos.ChaosInjector(jchaos.parse_chaos(spec))
                plan = t.daemon_kill_plan(names)
                assert plan == j.daemon_kill_plan(names), spec
                assert len(plan) == min(kill, len(names) - 1)
    t = tchaos.ChaosInjector(tchaos.parse_chaos("daemon:kill=1,seed=7"))
    before = dict(tobs.REGISTRY.peek("chaos_injections_total") or {})
    with _jax_telemetry_apart() as (reg, _):
        j = jchaos.ChaosInjector(jchaos.parse_chaos("daemon:kill=1,seed=7"))
        assert [j.record_daemon_kill("b1"), j.record_daemon_kill("b1")] == [True, False]
        jdelta = reg.peek("chaos_injections_total")
    assert [t.record_daemon_kill("b1"), t.record_daemon_kill("b1")] == [True, False]
    after = tobs.REGISTRY.peek("chaos_injections_total")
    assert {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)} == jdelta
    assert t.daemon_kill_plan(()) == () and tchaos.ChaosInjector(
        tchaos.parse_chaos("serve:p=0.1")).daemon_kill_plan(("b0", "b1")) == ()
    for bad in ("daemon:kill=-1", "daemon:nope=1", "daemon:kill=x"):
        with pytest.raises(tchaos.ChaosSpecError) as te:
            tchaos.parse_chaos(bad)
        with pytest.raises(jchaos.ChaosSpecError) as je:
            jchaos.parse_chaos(bad)
        assert str(te.value) == str(je.value)


def _slo_report(slo_mod, reg_mod) -> tuple:
    reg = reg_mod.MetricsRegistry()
    clock = [0.0]
    eng = slo_mod.SLOEngine(slo_mod.router_slos(), registry=reg, clock=lambda: clock[0])
    req = reg.counter("router_requests_total")
    paths = reg.counter("router_request_path_total")
    lat = reg.bucket_histogram("router_request_seconds")
    rng = np.random.default_rng(5)
    outcomes = ("ok", "ok", "ok", "reject", "connection_error", "unavailable")
    health = []
    for step in range(40):
        clock[0] = step * 7.5
        for _ in range(int(rng.integers(1, 6))):
            outcome = outcomes[int(rng.integers(0, len(outcomes)))]
            req.inc(1, backend=f"b{int(rng.integers(0, 3))}", outcome=outcome)
            paths.inc(1, path=("direct", "failover", "exhausted")[int(rng.integers(0, 3))])
            lat.observe(float(rng.choice([0.001, 0.01, 0.2, 0.3, 2.0])), outcome=outcome)
        eng.tick()
        health.append(eng.health())
    return eng.evaluate(), health


def test_router_slos_and_their_evaluation_equal_jax():
    assert [vars(s) for s in tslo.router_slos()] == [vars(s) for s in jslo.router_slos()]
    assert [vars(s) for s in tslo.router_slos(0.1, (5.0, 50.0))] == [
        vars(s) for s in jslo.router_slos(0.1, (5.0, 50.0))]
    assert _slo_report(tslo, treg) == _slo_report(jslo, jreg)


def _watchdog_trace(mod) -> list:
    clock = [0.0]
    hb = mod.HeartbeatRegistry(clock=lambda: clock[0])
    wd = mod.Watchdog(hb, {"dispatch": 1.0, "worker": 2.0}, clock=lambda: clock[0], poll_s=1.0)
    out = [hb.lanes(), hb.age("dispatch")]
    for t, beats in ((0.0, ("dispatch", "worker/a")), (0.5, ("admin",)), (1.2, ()),
                     (1.6, ("worker/a",)), (2.5, ()), (2.6, ("dispatch",)), (4.0, ()),
                     (4.1, ("dispatch",)), (6.5, ())):
        clock[0] = t
        for lane in beats:
            hb.beat(lane)
        wd.check()
        out.append((t, hb.lanes(), [hb.age(lane) for lane in hb.lanes()], hb.age("nope"),
                    hb.age("dispatch", now=t + 1.0),
                    [wd.is_stalled(lane) for lane in ("dispatch", "worker/a", "admin")],
                    wd.stalled()))
    hb.clear("dispatch")
    wd.check()
    out.append((hb.lanes(), hb.age("dispatch"), wd.is_stalled("dispatch")))
    return out


def test_watchdog_lanes_age_and_is_stalled_equal_jax():
    with _jax_telemetry_apart():
        want = _watchdog_trace(jwd)
    assert _watchdog_trace(twd) == want


# ── the import guard ────────────────────────────────────────────────────


def test_router_and_fleet_report_import_without_torch_or_jax():
    code = "\n".join([
        "import os, sys, types",
        f"sys.path.insert(0, {_REPO!r})",
        "pkg = types.ModuleType('ate_replication_causalml_torch')",
        f"pkg.__path__ = [os.path.join({_REPO!r}, 'ate_replication_causalml_torch')]",
        "sys.modules['ate_replication_causalml_torch'] = pkg",
        "from ate_replication_causalml_torch.serving import router",
        "from ate_replication_causalml_torch.observability import fleet_report",
        "router.handle_router_admin_path",
        "bad = [m for m in ('torch', 'jax', 'ate_replication_causalml_tpu') if m in sys.modules]",
        "assert not bad, f'imported: {bad}'",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


# ── the in-process micro fleet: two CPU daemons behind the router ───────

T, D, N, P, NB = 8, 3, 50, 4, 8


def _synthetic_forest_arrays(rng) -> dict:
    """The JAX micro-fleet rig's forest shape (``tests/test_router.py``),
    drawn in its order from one generator."""
    return {
        "split_feat": rng.integers(0, P, size=(T, D, 1 << D)).astype(np.int32),
        "split_bin": rng.integers(0, NB - 1, size=(T, D, 1 << D)).astype(np.int32),
        "leaf_stats": (np.abs(rng.normal(size=(T, 1 << D, 5))) + 0.5).astype(np.float32),
        "in_sample": rng.uniform(size=(T, N)) < 0.5,
        "bin_edges": np.sort(rng.normal(size=(P, NB - 1)), axis=1).astype(np.float32),
    }


def test_micro_fleet_replay_rotation_bit_identity_and_dump(tmp_path, monkeypatch):
    monkeypatch.delenv("ATE_TPU_METRICS_DIR", raising=False)
    monkeypatch.delenv("ATE_TPU_CHAOS", raising=False)
    tchaos.reset()
    rng = np.random.default_rng(18)
    forests = {}
    for key in (("default", 1), ("m2", 1), ("default", 2)):
        a = _synthetic_forest_arrays(rng)
        forests[key] = tcf.CausalForest(**{k: torch.from_numpy(v) for k, v in a.items()},
                                        ci_group_size=2)
    ckpts = {key: str(tmp_path / f"{key[0]}-v{key[1]}.npz") for key in forests}
    for key, forest in forests.items():
        save_fitted(ckpts[key], forest)
    n_requests = 36
    schedule = tlg.build_schedule(9, n_requests, rate_hz=4000.0, mix="1:2,3:1,4:1",
                                  id_prefix="mf", models=("default", "m2"))
    queries = tlg.build_queries(9, schedule, P)
    offs = np.cumsum([0] + [q.shape[0] for q in queries])
    cat = torch.from_numpy(np.concatenate(queries))
    refs = {}
    for key, forest in forests.items():
        out = tcf.predict_cate(forest, cat, oob=False)
        refs[key] = (out.cate.numpy(), out.variance.numpy())

    servers, threads, specs = [], [], []
    router = serve_thread = client = None
    try:
        for name in ("b0", "b1"):
            server = tdaemon.CateServer(tdaemon.ServeConfig(
                checkpoint=ckpts[("default", 1)], fleet=(("m2", ckpts[("m2", 1)]),),
                buckets=BucketPlan.parse("4,16"), window_s=0.002, max_depth=32,
                retry_after_s=0.005, admin_port=0, device="cpu"))
            server.startup()
            servers.append(server)
            bound: list[int] = []
            evt = threading.Event()
            t = threading.Thread(target=tdaemon.serve_socket, args=(server,),
                                 kwargs=dict(port=0, on_bound=lambda p, b=bound, e=evt: (
                                     b.append(p), e.set())),
                                 daemon=True, name=f"fleet-daemon-{name}")
            t.start()
            threads.append(t)
            assert evt.wait(30)
            specs.append(trt.BackendSpec(name, "127.0.0.1", bound[0],
                                         server.stats()["admin_port"]))
        router = trt.RouterServer(trt.RouterConfig(backends=tuple(specs), probe_interval_s=0.05))
        router.start()
        assert router.in_rotation() == ("b0", "b1")
        rbound: list[int] = []
        revt = threading.Event()
        serve_thread = threading.Thread(
            target=trt.serve_socket, args=(router,),
            kwargs=dict(port=0, on_bound=lambda p: (rbound.append(p), revt.set())),
            daemon=True, name="fleet-router")
        serve_thread.start()
        assert revt.wait(10)
        client = CateClient.connect("127.0.0.1", rbound[0], timeout=60.0)
        supervisor = trt.FleetSupervisor(router)
        req_before = dict(tobs.REGISTRY.peek("router_requests_total") or {})
        replies, rotation = [], None
        for i, sched in enumerate(schedule):
            if i == n_requests // 2:
                rotation = supervisor.rotate_all(ckpts[("default", 2)], model="default",
                                                 timeout_s=60.0)
            replies.append(client.predict_full(queries[i], request_id=sched.request_id,
                                               model=sched.model, max_retries=32))
        assert rotation["statuses"] == {"b0": "rotated", "b1": "rotated"}
        assert rotation["versions"] == {"b0": 2, "b1": 2}
        assert rotation["post_swap_compiles"] == {"b0": 0, "b1": 0}
        assert rotation["zero_downtime"] is True and rotation["min_in_rotation"] >= 1
        seen = set()
        for i, (sched, (cate, var, header)) in enumerate(zip(schedule, replies)):
            key = (sched.model or "default", int(header["model_version"]))
            seen.add(key)
            assert header["model"] == key[0]
            assert np.array_equal(cate, refs[key][0][offs[i]:offs[i + 1]]), sched.request_id
            assert np.array_equal(var, refs[key][1][offs[i]:offs[i + 1]]), sched.request_id
        assert {("default", 1), ("default", 2), ("m2", 1)} <= seen and ("m2", 2) not in seen
        after = tobs.REGISTRY.peek("router_requests_total")
        d = {k: v - req_before.get(k, 0) for k, v in after.items() if v - req_before.get(k, 0)}
        assert set(d) <= {"backend=b0,outcome=ok", "backend=b1,outcome=ok"}
        assert sum(d.values()) == n_requests and client.retry_counts == {}

        dump = str(tmp_path / "fleet_dump")
        manifest = router.dump_fleet(dump)
        assert all(e["dumped"] for e in manifest["backends"].values())
        assert cms.validate_fleet_dump(dump) == []
        with open(os.path.join(dump, "fleet_report.json")) as f:
            rep = json.load(f)
        assert rep["requests"]["router_spans"] == rep["requests"]["matched"] == n_requests
        assert rep["requests"]["orphan_router"] == rep["requests"]["orphan_daemon"] == 0
        assert rep["reconciliation"]["consistent"] is True
        names = (tfr.FLEET_TRACE_BASENAME, tfr.FLEET_REPORT_BASENAME,
                 tfr.FLEET_STAT_HEALTH_BASENAME)
        written = {n: open(os.path.join(dump, n), "rb").read() for n in names}
        jcopy = str(tmp_path / "jax_copy")
        shutil.copytree(dump, jcopy)
        jfr.write_fleet_artifacts(jcopy)
        tfr.write_fleet_artifacts(dump)
        for n in names:
            assert open(os.path.join(jcopy, n), "rb").read() == written[n], n
            assert open(os.path.join(dump, n), "rb").read() == written[n], n
        with open(os.path.join(dump, "fleet_trace.json")) as f:
            ftrace = json.load(f)
        rpid = ftrace["otherData"]["processes"]["router"]["pid"]
        spans = [e for e in ftrace["traceEvents"] if e.get("ph") == "X"
                 and e.get("name") == "router_request" and e.get("pid") == rpid]
        assert len(spans) == n_requests
        for ev in spans:
            assert abs(sum(ev["args"][k] for k in PHASES) - ev["args"]["e2e_s"]) <= 1e-6
        for name in ("b0", "b1"):
            # A daemon's stats report its process's row-kernel launches:
            # none on the CPU, where the wrappers run their plain versions.
            stats = router.call_backend(name, {"op": "stats"})[0]["stats"]
            assert stats["kernel_launches"] == dict.fromkeys(tdaemon.ROW_KERNELS, 0)
            assert router.call_backend(name, {"op": "shutdown"})[0]["ok"]
    finally:
        if client is not None:
            client.close()
        if router is not None:
            router.stop()
        if serve_thread is not None:
            serve_thread.join(10)
        for t in threads:
            t.join(10)
        for server in servers:
            if server.lifecycle.state != "stopped":
                server.stop()
    assert not any(t.is_alive() for t in threads)


def test_router_entry_point_help():
    proc = subprocess.run([sys.executable, "-m", "ate_replication_causalml_torch.serving.router",
                           "--help"], capture_output=True, text=True, timeout=120, cwd=_REPO)
    assert proc.returncode == 0
    for flag in ("--backends", "--port", "--host", "--vnodes", "--probe-s", "--failover",
                 "--admin-port"):
        assert flag in proc.stdout
