"""The port's serving-plane model lifecycle against the JAX package's, on
the CPU: the serving report, the admin endpoint, rotation, retirement,
the retrain supervisor, the ``rotate`` chaos scope and the load
generator.

* ``serving_report``: on a ``trace.json`` and ``metrics.json`` a JAX
  package daemon dumped (a micro synthetic forest), the port's report is
  the JAX package's bytes; on the port daemon's own dump, both
  packages' reports equal the dumped ``serving_report.json`` bytes.
* ``retrain_backoff_delay`` and the supervisor's whole schedule (sleeps,
  attempts, outcomes, candidate paths, counters) under scripted faults
  and the ``rotate:`` chaos scope: exactly equal. The retrain outcomes:
  ``refused`` is terminal, ``busy`` retries only the rotation, a fatal
  error is raised at once (and, in the port only, a CUDA error).
* The ``rotate`` chaos decisions and ``hang:scope=retrain``: exactly
  equal.
* ``loadgen``: schedules, queries and shifts ``array_equal``.
* The admin handlers against a stub server, and over HTTP: the JAX
  package's statuses and bodies.
* The wire ``rotate`` / ``retire`` / ``dump`` replies: both packages'
  ``_handle_op`` on one stub server give the same headers; a CPU daemon
  on a micro fitted forest gives the JAX package's header keys and
  statuses.
* A live rotation under in-process load (``loadgen.run_inprocess``):
  every reply bit for bit the offline ``predict_cate`` of the version it
  names, ``leaf_index_rows`` before and after, ``/readyz`` and
  ``/healthz`` 200 throughout, a corrupt candidate refused, a retired
  model's requests refused ``retired_model``, no build and no capture
  in the window, and the dump's seven artifacts, its serving report and
  stat-health report recomputing byte for byte.

Registry reads are deltas taken at a test's own start (the registry is
process-global). JAX package code runs here with that package's registry
and event log swapped for fresh ones (:func:`_jax_telemetry_apart`):
its own tests read those globals' totals.
"""

import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import observability as tobs
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.observability import serving_report as tsr
from ate_replication_causalml_torch.observability import stathealth as tsh
from ate_replication_causalml_torch.resilience import chaos as tchaos
from ate_replication_causalml_torch.resilience.errors import CudaKernelError
from ate_replication_causalml_torch.serving import admin as tadmin
from ate_replication_causalml_torch.serving import daemon as tdaemon
from ate_replication_causalml_torch.serving import loadgen as tlg
from ate_replication_causalml_torch.serving import retrain as tre
from ate_replication_causalml_torch.serving.client import CateClient
from ate_replication_causalml_torch.serving.coalescer import BucketPlan
from ate_replication_causalml_torch.utils.checkpoint import save_fitted
from ate_replication_causalml_tpu import observability as jobs
from ate_replication_causalml_tpu.observability import serving_report as jsr
from ate_replication_causalml_tpu.resilience import chaos as jchaos
from ate_replication_causalml_tpu.serving import admin as jadmin
from ate_replication_causalml_tpu.serving import daemon as jdaemon
from ate_replication_causalml_tpu.serving import loadgen as jlg
from ate_replication_causalml_tpu.serving import retrain as jre

T, D, N, P, NB = 8, 3, 50, 4, 8
FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")
SIZES = (1, 3, 4, 9, 16)


def _forest_arrays(seed: int, leaf_seed: int | None = None) -> dict:
    """The JAX serving rig's synthetic forest (``tests/test_serving.py``);
    ``leaf_seed`` redraws only the leaf statistics (a same-geometry
    retrain)."""
    rng = np.random.default_rng(seed)
    a = {
        "split_feat": rng.integers(0, P, size=(T, D, 1 << D)).astype(np.int32),
        "split_bin": rng.integers(0, NB - 1, size=(T, D, 1 << D)).astype(np.int32),
        "leaf_stats": (np.abs(rng.normal(size=(T, 1 << D, 5))) + 0.5).astype(np.float32),
        "in_sample": rng.uniform(size=(T, N)) < 0.5,
        "bin_edges": np.sort(rng.normal(size=(P, NB - 1)), axis=1).astype(np.float32),
    }
    if leaf_seed is not None:
        lr = np.random.default_rng(leaf_seed)
        a["leaf_stats"] = (np.abs(lr.normal(size=(T, 1 << D, 5))) + 0.5).astype(np.float32)
    return a


def _fitted(seed: int, leaf_seed: int | None = None) -> tcf.FittedCausalForest:
    """A fitted checkpoint's object: the synthetic forest and an N-row
    training panel."""
    a = _forest_arrays(seed, leaf_seed)
    forest = tcf.CausalForest(**{k: torch.from_numpy(a[k]) for k in FIELDS}, ci_group_size=2)
    rng = np.random.default_rng(100 + seed)
    col = lambda: torch.from_numpy(rng.uniform(size=N).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N, P)).astype(np.float32))
    return tcf.FittedCausalForest(forest=forest, y_hat=col(), w_hat=col(), x=x, y=col(), w=col())


@contextlib.contextmanager
def _jax_telemetry_apart():
    """Swap the JAX package's process-global registry and event log for
    fresh ones while JAX package code runs here, and put them back."""
    from ate_replication_causalml_tpu.observability import device as jdev
    from ate_replication_causalml_tpu.observability import events as jev
    from ate_replication_causalml_tpu.observability import registry as jreg

    saved = (jreg.REGISTRY, jobs.REGISTRY, jdev.REGISTRY, jev.EVENTS, jobs.EVENTS)
    reg, log = jreg.MetricsRegistry(), jev.EventLog()
    jreg.REGISTRY = jobs.REGISTRY = jdev.REGISTRY = reg
    jev.EVENTS = jobs.EVENTS = log
    try:
        yield reg, log
    finally:
        jreg.REGISTRY, jobs.REGISTRY, jdev.REGISTRY, jev.EVENTS, jobs.EVENTS = saved


@pytest.fixture
def jax_apart():
    with _jax_telemetry_apart() as pair:
        yield pair


def _dump_bytes(obj) -> bytes:
    return (json.dumps(obj, indent=1) + "\n").encode()


# ── the serving report on a JAX daemon's trace ───────────────────────


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    """A JAX package daemon on the synthetic forest serves a few requests
    (``serve_one`` and raw ``submit``, a typed reject) and dumps."""
    from ate_replication_causalml_tpu.utils.checkpoint import save_fitted as jsave

    root = tmp_path_factory.mktemp("jaxdump")
    a = _forest_arrays(0)
    import jax.numpy as jnp

    from ate_replication_causalml_tpu.models.causal_forest import CausalForest as JCF

    with _jax_telemetry_apart():
        jsave(str(root / "forest.npz"),
              JCF(**{k: jnp.asarray(a[k]) for k in FIELDS}, ci_group_size=2))
        server = jdaemon.CateServer(jdaemon.ServeConfig(
            checkpoint=str(root / "forest.npz"), buckets=BucketPlan.parse("4,16"),
            window_s=0.002, max_depth=16, retry_after_s=0.005))
        server.startup()
        rng = np.random.default_rng(3)
        try:
            for i in range(12):
                server.serve_one(f"j{i}", rng.normal(size=(SIZES[i % 5], P)).astype(np.float32))
            reqs = [server.submit(f"s{i}", rng.normal(size=(2, P)).astype(np.float32))
                    for i in range(3)]
            for r in reqs:
                assert r.wait(30)
            with pytest.raises(jdaemon.RejectedRequest):
                server.serve_one("bad", np.ones((2, 9), np.float32))
            out = str(root / "dump")
            server.dump_artifacts(out)
        finally:
            server.stop()
    return out


def test_serving_report_on_a_jax_daemon_trace_is_the_jax_bytes(jax_dump):
    with open(os.path.join(jax_dump, "trace.json")) as f:
        trace = json.load(f)
    with open(os.path.join(jax_dump, "metrics.json")) as f:
        metrics = json.load(f)
    want = open(os.path.join(jax_dump, "serving_report.json"), "rb").read()
    got = tsr.serving_report(trace, metrics)
    assert _dump_bytes(got) == want
    assert got["reconciliation"]["silent_drops"] == 3
    assert tsr.render_summary(got) == jsr.render_summary(jsr.serving_report(trace, metrics))
    assert tsr.phase_mark_from_trace(trace) == jsr.phase_mark_from_trace(trace)
    assert tsr.has_serving_slices(trace) and not tsr.has_serving_slices({"traceEvents": []})


# ── retrain: backoff, schedule, outcomes ─────────────────────────────


def test_retrain_backoff_delay_equals_jax():
    for model in ("default", "tenant_b", "x" * 40):
        for attempt in range(1, 9):
            for base in (0.0, 0.01, 0.05, 1.5):
                assert (tre.retrain_backoff_delay(model, attempt, base)
                        == jre.retrain_backoff_delay(model, attempt, base))


class _FakeTime:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


# name -> (chaos spec, fit script, rotate script, config kwargs). A fit
# script item is "ok" or an exception name to raise; a rotate item is a
# status the rotation answers.
SCHEDULES = {
    "rotated_first": ("", ["ok"], ["rotated"], {}),
    "refused_terminal": ("", ["ok", "ok"], ["refused", "rotated"], {}),
    "busy_retries_rotation_only": ("", ["ok"], ["busy", "busy", "rotated"],
                                   {"max_attempts": 4}),
    "busy_exhausted": ("", ["ok"], ["busy"] * 5, {"max_attempts": 3}),
    "transient_fit_then_rotated": ("", ["OSError", "ok"], ["rotated"], {}),
    "transient_exhausted": ("", ["OSError"] * 4, [], {"max_attempts": 3}),
    "retired_terminal": ("", ["ok"], ["retired_model"], {}),
    "deadline": ("", ["OSError"] * 9, [], {"max_attempts": 9, "backoff_s": 1.0,
                                           "deadline_s": 5.0}),
    "chaos_retrain_fault": ("rotate:retrain,times=2", ["ok"] * 3, ["rotated"],
                            {"max_attempts": 4}),
}


def _run_schedule(mod, chaos_mod, name, tmp_path):
    spec, fits, rotations, cfg = SCHEDULES[name]
    fits, rotations = list(fits), list(rotations)
    fake = _FakeTime()
    published, rotated = [], []
    reg_before = dict(mod._registry.REGISTRY.peek("serving_retrain_total") or {})

    def fit_fn():
        item = fits.pop(0)
        fake.t += 0.25
        if item != "ok":
            raise {"OSError": OSError, "ValueError": ValueError}[item]("scripted")
        return "forest"

    def publish_fn(path, forest):
        published.append(os.path.basename(path))
        with open(path, "wb") as f:
            f.write(b"x" * 100)

    def rotate_fn(path):
        rotated.append(os.path.basename(path))
        return rotations.pop(0)

    d = tmp_path / mod.__name__.split(".")[0]
    d.mkdir()
    with chaos_mod.override(spec or None):
        sup = mod.RetrainSupervisor("default", fit_fn, str(d), rotate_fn,
                                    config=mod.RetrainConfig(**cfg), publish_fn=publish_fn,
                                    clock=fake.clock, sleep=fake.sleep)
        out = sup.run_once()
    after = mod._registry.REGISTRY.peek("serving_retrain_total") or {}
    delta = {k: v - reg_before.get(k, 0.0) for k, v in after.items() if v != reg_before.get(k)}
    return (out.status, out.attempts, out.checkpoint and os.path.basename(out.checkpoint),
            out.error, fake.sleeps, published, rotated, delta)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_retrain_schedule_equals_jax(name, tmp_path, jax_apart):
    got = _run_schedule(tre, tchaos, name, tmp_path)
    want = _run_schedule(jre, jchaos, name, tmp_path)
    assert got == want
    status, attempts, _, _, sleeps, published, rotated, _ = got
    if name == "refused_terminal":
        assert (status, attempts, len(published)) == ("refused", 1, 1)
    if name == "busy_retries_rotation_only":
        # One fit, one candidate, the rotation retried under backoff.
        assert status == "rotated" and len(published) == 1 and len(rotated) == 3
        assert len(set(rotated)) == 1 and len(sleeps) == 2


@pytest.mark.parametrize("fatal", [ValueError("bug"), CudaKernelError("launch failed")])
def test_retrain_fatal_error_is_raised_at_once(fatal, tmp_path):
    """A programming error is raised on the first attempt, never refit;
    in the port a CUDA error is fatal too (the JAX package retries a
    RuntimeError), so a kernel fault is never refit over."""
    calls = []

    def fit_fn():
        calls.append(1)
        raise fatal

    sup = tre.RetrainSupervisor("default", fit_fn, str(tmp_path), lambda p: "rotated",
                                config=tre.RetrainConfig(max_attempts=5),
                                sleep=lambda s: pytest.fail("slept"))
    with pytest.raises(type(fatal)):
        sup.run_once()
    assert calls == [1]


def test_rotate_chaos_decisions_equal_jax(jax_apart):
    def decisions(mod):
        inj = mod.ChaosInjector(mod.parse_chaos(
            "rotate:retrain,corrupt,mid_swap,verify_ms=7,times=2;"
            "hang:scope=retrain,ms=30,p=0.5,seed=4,times=2"))
        return ([inj.take_rotate_fault(k, f"s{i}") for i in range(4)
                 for k in ("retrain", "corrupt", "mid_swap", "other")]
                + [inj.rotate_verify_delay_s(f"rotate/m{i}") for i in range(4)]
                + [inj.hang_delay_s("retrain", f"m{i}") for i in range(8) for _ in range(3)]
                + [inj.hang_delay_s("dispatch", "m0")])

    tobs.EVENTS.clear()
    jobs.EVENTS.clear()
    got, want = decisions(tchaos), decisions(jchaos)
    assert got == want and any(got)
    sites = lambda o: [(r["attrs"]["scope"], r["attrs"]["site"]) for r in o.EVENTS.records()
                       if r["name"] == "chaos_inject"]
    assert sites(tobs) == sites(jobs)


# ── loadgen ──────────────────────────────────────────────────────────


@pytest.mark.parametrize("kw", [
    dict(seed=0, requests=50),
    dict(seed=7, requests=200, rate_hz=100.0, mix="1,3,8,17,64,100,256"),
    dict(seed=3, requests=64, rate_hz=500.0, mix="1:4,8:2,32:1", id_prefix="q",
         models=("default", "tenant_b")),
])
def test_loadgen_schedule_queries_and_shift_equal_jax(kw):
    ts, js = tlg.build_schedule(**kw), jlg.build_schedule(**kw)
    assert [tuple(vars(s).values()) for s in ts] == [tuple(vars(s).values()) for s in js]
    tq, jq = tlg.build_queries(kw["seed"], ts, 21), jlg.build_queries(kw["seed"], js, 21)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(tq, jq))
    for shift in (dict(shift_kind="covariate", shift_delta=1.5),
                  dict(shift_kind="checkpoint", shift_model="tenant_b")):
        a = tlg.apply_shift(ts, tq, shift_at=len(ts) // 2, **shift)
        b = jlg.apply_shift(js, jq, shift_at=len(js) // 2, **shift)
        assert [vars(s) for s in a[0]] == [vars(s) for s in b[0]]
        assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert tlg.parse_mix(" 1:2, 8 ,32:0.5") == jlg.parse_mix(" 1:2, 8 ,32:0.5")
    for bad in ("", "0:1", "a:1", "4:-1"):
        with pytest.raises(ValueError) as te:
            tlg.parse_mix(bad)
        with pytest.raises(ValueError) as je:
            jlg.parse_mix(bad)
        assert str(te.value) == str(je.value)


# ── admin endpoint ───────────────────────────────────────────────────


class _Stub:
    def __init__(self, state, stalled=(), stat=True):
        self.lifecycle = type("L", (), {"state": state})()
        self._stalled = stalled
        self.slo = type("S", (), {"health": lambda s: {"availability": 1.0}})()
        self.stat = (type("H", (), {"health": lambda s: {"window_s": 5.0, "models": {}}})()
                     if stat else None)

    def compile_events_in_window(self):
        return 0.0

    def heartbeat_ages(self):
        return {"dispatch": 0.0125, "admin": 1.5}

    def stalled_lanes(self):
        return self._stalled

    def model_bindings(self):
        return {"default": {"version": 2, "checkpoint": "/c/default-v0002.npz"}}


STUBS = {"serving": _Stub("serving"), "degraded": _Stub("degraded"),
         "stopped": _Stub("stopped"), "stalled": _Stub("serving", ("dispatch",)),
         "no_stat": _Stub("draining", stat=False)}


@pytest.mark.parametrize("stub", sorted(STUBS))
@pytest.mark.parametrize("path", ["/healthz", "/readyz", "/nope", "/"])
def test_admin_handlers_equal_jax(stub, path):
    got = tadmin.handle_admin_path(STUBS[stub], path)
    assert got == jadmin.handle_admin_path(STUBS[stub], path)


def test_admin_varz_and_http_shell_equal_jax(jax_apart):
    regs = (tobs.MetricsRegistry(), jobs.registry.MetricsRegistry())
    for reg in regs:
        reg.counter("serving_requests_total").inc(3, status="ok")
        reg.counter("serving_requests_total").inc(1, status="rejected_overloaded")
        reg.gauge("serving_port").set(7)
    assert tadmin.varz_payload(regs[0]) == jadmin.varz_payload(regs[1])
    bodies = []
    for mod in (tadmin, jadmin):
        srv = mod.AdminServer(STUBS["degraded"])
        port = srv.start(0)
        try:
            out = []
            for path in ("/healthz", "/readyz", "/nope"):
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                        out.append((r.status, r.read()))
                except urllib.error.HTTPError as e:
                    out.append((e.code, e.read()))
            req = urllib.request.Request(f"http://127.0.0.1:{port}/healthz", data=b"x",
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as post:
                urllib.request.urlopen(req, timeout=10)
            out.append((post.value.code, b""))
            bodies.append(out)
        finally:
            srv.stop()
        assert srv.port is None
    assert bodies[0] == bodies[1]
    assert [c for c, _ in bodies[0]] == [200, 503, 404, 501]


# ── the wire ops ─────────────────────────────────────────────────────


class _OpStub:
    """What ``_handle_op`` calls for rotate, retire and dump."""

    lifecycle = type("L", (), {"state": "serving"})()

    def __init__(self, rotate_status="rotated", dump_error=None):
        self.rotate_status = rotate_status
        self.dump_error = dump_error
        self.calls = []

    def rotate(self, model, checkpoint, reason="rotate"):
        self.calls.append(("rotate", model, checkpoint, reason))
        return self.rotate_status

    def retire(self, model):
        self.calls.append(("retire", model))
        return model == "tenant_b"

    def dump_artifacts(self, outdir):
        self.calls.append(("dump", outdir))
        if self.dump_error:
            raise self.dump_error
        return [os.path.join(outdir, "metrics.json")]


OPS = [
    ({"op": "rotate", "checkpoint": "/c/v2.npz"}, {}),
    ({"op": "rotate", "model": "tenant_b", "checkpoint": "/c/v2.npz", "id": "7"}, {}),
    ({"op": "rotate", "model": "default"}, {}),
    ({"op": "rotate", "checkpoint": "/c/v2.npz"}, {"rotate_status": "refused"}),
    ({"op": "rotate", "checkpoint": "/c/v2.npz"}, {"rotate_status": "busy"}),
    ({"op": "retire", "model": "tenant_b"}, {}),
    ({"op": "retire", "model": "nope"}, {}),
    ({"op": "retire"}, {}),
    ({"op": "dump", "dir": "/tmp/d"}, {}),
    ({"op": "dump"}, {}),
    ({"op": "dump", "dir": "/tmp/d", "id": "3"}, {"dump_error": OSError("disk full")}),
]


@pytest.mark.parametrize("i", range(len(OPS)))
def test_wire_lifecycle_op_replies_equal_jax(i, monkeypatch, jax_apart):
    monkeypatch.delenv("ATE_TPU_METRICS_DIR", raising=False)
    header, kw = OPS[i]
    ts, js = _OpStub(**kw), _OpStub(**kw)
    got = tdaemon._handle_op(ts, dict(header), {})
    assert got == jdaemon._handle_op(js, dict(header), {})
    assert ts.calls == js.calls


# ── a live port daemon: rotation under load, retire, dump ────────────


def _get(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture
def live(tmp_path, monkeypatch):
    monkeypatch.delenv("ATE_TPU_METRICS_DIR", raising=False)
    monkeypatch.delenv("ATE_TPU_CHAOS", raising=False)
    tchaos.reset()
    v1, v2, b = _fitted(0), _fitted(0, leaf_seed=9), _fitted(0, leaf_seed=5)
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("v1", "v2", "b")}
    for k, obj in (("v1", v1), ("v2", v2), ("b", b)):
        save_fitted(paths[k], obj)
    server = tdaemon.CateServer(tdaemon.ServeConfig(
        checkpoint=paths["v1"], buckets=BucketPlan.parse("4,16"), window_s=0.002, max_depth=64,
        retry_after_s=0.005, fleet=(("tenant_b", paths["b"]),), admin_port=0, device="cpu"))
    phases = server.startup()
    yield dict(server=server, phases=phases, paths=paths, tmp=tmp_path,
               forests={1: v1.forest, 2: v2.forest, "b": b.forest})
    server.stop()


def _offline(forest, x):
    out = tcf.predict_cate(forest, torch.from_numpy(x), oob=False)
    return out.cate.numpy(), out.variance.numpy()


def test_live_rotation_under_load_retire_and_dump(live):
    server, forests = live["server"], live["forests"]
    assert set(live["phases"]) == {"load", "aot", "warm", "index"}
    fleet = server.stats()["fleet"]
    assert fleet["default"]["leaf_index_rows"] == N == fleet["tenant_b"]["leaf_index_rows"]
    entry = server.fleet.get("default")
    want_li = tcf.compute_leaf_index(forests[1], server._load_model(live["paths"]["v1"])[1])
    assert torch.equal(entry.leaf_index, want_li)
    admin = server.stats()["admin_port"]
    probes: list[tuple[int, int]] = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            probes.append((_get(admin, "/readyz"), _get(admin, "/healthz")))
            time.sleep(0.01)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    schedule = tlg.build_schedule(11, 160, rate_hz=800.0, mix="1,3,4,9,16")
    queries = tlg.build_queries(11, schedule, P)
    replies: list = []
    record: dict = {}
    load = threading.Thread(target=lambda: record.update(tlg.run_inprocess(
        server, schedule, queries, replies=replies)))
    load.start()
    time.sleep(0.08)
    status = server.rotate("default", live["paths"]["v2"], reason="test")
    load.join(60)
    after = [server.serve_request(f"after{i}", queries[i]) for i in range(6)]
    assert status == "rotated" and record["served"] == len(schedule)
    by_id = {s.request_id: q for s, q in zip(schedule, queries)}
    versions = set()
    for req in replies + after:
        x = by_id.get(req.request_id, queries[int(req.request_id[5:])]
                      if req.request_id.startswith("after") else None)
        versions.add(req.model_version)
        c, v = _offline(forests[req.model_version], x)
        assert np.array_equal(req.result[0], c) and np.array_equal(req.result[1], v), req.request_id
    assert {r.model_version for r in after} == {2} and 1 in versions
    fleet = server.stats()["fleet"]
    assert fleet["default"]["version"] == 2 and fleet["default"]["leaf_index_rows"] == N
    # A corrupt candidate over the wire: refused, the last good model kept.
    bad = str(live["tmp"] / "corrupt.npz")
    raw = open(live["paths"]["v2"], "rb").read()
    with open(bad, "wb") as f:
        f.write(raw[: len(raw) * 3 // 5])
    with CateClient.connect("127.0.0.1", _serve_socket(server)) as client:
        assert client.rotate(bad) == "refused"
        cate, var, header = client.predict_full(queries[0], request_id="post-refusal")
        assert header["model_version"] == 2
        assert np.array_equal(cate, _offline(forests[2], queries[0])[0])
        # Retire tenant_b: its requests are refused retired_model.
        assert server.serve_one("b0", queries[1], model="tenant_b") is not None
        assert client.retire("tenant_b") is True and client.retire("nope") is False
        with pytest.raises(tdaemon.RejectedRequest) as rej:
            server.serve_one("b1", queries[1], model="tenant_b")
        assert rej.value.code == "retired_model"
        assert server.rotate("tenant_b", live["paths"]["b"]) == "retired_model"
        assert "tenant_b" not in server.model_bindings()
        out = str(live["tmp"] / "dump")
        paths = client.dump(out)
    stop.set()
    poller.join(10)
    assert probes and all(p == (200, 200) for p in probes), set(probes)
    names = {os.path.basename(p) for p in paths}
    assert names == {"metrics.json", "events.jsonl", "metrics.prom", "trace.json",
                     "serving_report.json", "slo_report.json", "stat_health.json"}
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    dumped = open(os.path.join(out, "serving_report.json"), "rb").read()
    assert _dump_bytes(tsr.serving_report(trace, metrics)) == dumped
    assert _dump_bytes(jsr.serving_report(trace, metrics)) == dumped
    sh = open(os.path.join(out, "stat_health.json"), "rb").read()
    assert _dump_bytes(tsh.stat_health_report(json.loads(sh)["state"])) == sh
    assert json.loads(sh)["summary"]["default"]["rows"] > 0
    slo_names = {s["name"] for s in json.load(open(os.path.join(out, "slo_report.json")))["slos"]}
    assert {"stat_drift:default", "stat_calibration:tenant_b"} <= slo_names
    assert server.builds_in_window() == {"kernel": 0.0, "graph": 0.0}
    spans = {r["name"] for r in tobs.EVENTS.records()}
    assert {"serving_rotation", "serving_leaf_index_prebuild", "serving_leaf_index"} <= spans


def _serve_socket(server) -> int:
    bound: list[int] = []
    threading.Thread(target=tdaemon.serve_socket, args=(server, "127.0.0.1", 0),
                     kwargs={"on_bound": bound.append}, daemon=True).start()
    t0 = time.monotonic()
    while not bound and time.monotonic() - t0 < 10:
        time.sleep(0.005)
    return bound[0]


def test_retrain_through_the_daemon(live):
    """The daemon's retrain supervisor: a rotated run bumps the version
    and names a fresh candidate; ``rotate:corrupt`` publishes a torn
    candidate that the rotation's re-verify refuses (terminal, kept on
    disk, the last good model serving); a retrain fault is refit."""
    server, tmp = live["server"], live["tmp"]
    pub = tmp / "publish"
    x = np.random.default_rng(4).normal(size=(3, P)).astype(np.float32)
    fits = []

    def fit_fn():
        fits.append(1)
        return _fitted(0, leaf_seed=20 + len(fits))

    before = dict(tobs.REGISTRY.peek("serving_retrain_total") or {})
    with tchaos.override("rotate:retrain"):
        out = server.retrain_supervisor("default", fit_fn, str(pub),
                                        config=tre.RetrainConfig(backoff_s=0.001)).run_once()
    assert (out.status, out.attempts, len(fits)) == ("rotated", 2, 1)
    assert os.path.basename(out.checkpoint) == "default-v0002.npz"
    req = server.serve_request("rt0", x)
    assert req.model_version == 2
    want = _offline(_fitted(0, leaf_seed=21).forest, x)
    assert np.array_equal(req.result[0], want[0]) and np.array_equal(req.result[1], want[1])
    with tchaos.override("rotate:corrupt"):
        out = server.retrain_supervisor("default", fit_fn, str(pub)).run_once()
    assert out.status == "refused" and os.path.basename(out.checkpoint) == "default-v0003.npz"
    assert os.path.exists(out.checkpoint)  # quarantined, never overwritten
    assert server.serve_request("rt1", x).model_version == 2
    assert server.lifecycle.state == "serving"
    after = tobs.REGISTRY.peek("serving_retrain_total")
    delta = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
    assert delta == {"model=default,status=rotated": 1.0, "model=default,status=refused": 1.0}
    assert server.builds_in_window() == {"kernel": 0.0, "graph": 0.0}


def test_rotations_race_dispatch_under_a_short_switch_interval(live):
    """Stress: four producer threads serve while two threads rotate the
    default model, one always to v2's checkpoint and one always back to
    v1's, under a 10 µs interpreter switch interval. Every rotation
    answers ``rotated`` or ``busy`` (one claim at a time), versions
    advance by one a swap, and every reply is bit for bit the offline
    predict of the checkpoint its version was swapped in from (the
    ``serving_model_rotated`` events name both)."""
    import sys

    server, paths = live["server"], live["paths"]
    forests = {paths["v1"]: live["forests"][1], paths["v2"]: live["forests"][2]}
    rng = np.random.default_rng(21)
    xs = [rng.normal(size=(SIZES[i % 5], P)).astype(np.float32) for i in range(160)]
    replies, statuses, errors = [], [], []
    t_start = time.monotonic()

    def producer(k):
        try:
            for i in range(k, len(xs), 4):
                replies.append((i, server.serve_request(f"x{i}", xs[i])))
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append(e)

    def rotator(path):
        for _ in range(8):
            statuses.append(server.rotate("default", path, reason="stress"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=producer, args=(k,)) for k in range(4)]
                   + [threading.Thread(target=rotator, args=(paths[v],)) for v in ("v2", "v1")])
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(replies) == len(xs)
    assert set(statuses) <= {"rotated", "busy"} and "rotated" in statuses
    swaps = sorted((r["attrs"]["version"], r["attrs"]["checkpoint"]) for r in tobs.EVENTS.records()
                   if r["name"] == "serving_model_rotated" and r["start_mono_s"] >= t_start)
    assert [v for v, _ in swaps] == list(range(2, 2 + statuses.count("rotated")))
    source = {1: paths["v1"], **dict(swaps)}
    assert server.fleet.get("default").version == 1 + statuses.count("rotated")
    for i, req in replies:
        c, v = _offline(forests[source[req.model_version]], xs[i])
        assert np.array_equal(req.result[0], c) and np.array_equal(req.result[1], v), i
    assert server.builds_in_window() == {"kernel": 0.0, "graph": 0.0}


def test_loadgen_over_the_wire_in_both_packages(live, jax_apart):
    """``run_wire`` of either package drives the port daemon over TCP with
    its own client: the same schedule, every request served, the same
    record keys and offered rows."""
    from ate_replication_causalml_tpu.serving.client import CateClient as JClient

    port = _serve_socket(live["server"])
    records = []
    for lg, client_cls in ((tlg, CateClient), (jlg, JClient)):
        sched = lg.build_schedule(5, 40, rate_hz=400.0, mix="1,3,4,9,16", id_prefix="w")
        rec = lg.run_wire(lambda: client_cls.connect("127.0.0.1", port), sched,
                          lg.build_queries(5, sched, P), concurrency=4)
        records.append(rec)
    assert records[0]["served"] == records[1]["served"] == 40
    assert sorted(records[0]) == sorted(records[1])
    assert records[0]["rows_offered"] == records[1]["rows_offered"]
