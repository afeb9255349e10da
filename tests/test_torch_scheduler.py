"""The port's scheduler (``ate_replication_causalml_torch/scheduler``)
against the JAX package's: every scenario of ``tests/test_scheduler.py``
(and the engine's stall scenario of
``tests/test_deadline_watchdog.py``) runs through both packages' engines,
parametrised by package, and each asserts the same outcome: the same
commits, results, fit counts and abort truncation, the same ``workers <
1`` clamp, lane exclusivity and prefetcher bookkeeping. Pure-Python
synthetic DAGs on the CPU (no stream, no device work).

The JAX package's sharded-layout scenarios have no counterpart: the port
refuses any layout but None and "host" (multi-GPU is not ported), which
``test_port_refuses_sharded_layouts`` holds. Then the port's own pieces:
the launch counter under thread contention, the prefetch default, the
heartbeat lane bounds.
"""

import importlib
import sys
import threading
import time
import types

import pytest
import torch

PACKAGES = ("ate_replication_causalml_tpu", "ate_replication_causalml_torch")


@pytest.fixture(params=PACKAGES, ids=("jax", "torch"))
def pkg(request) -> types.SimpleNamespace:
    """One package's scheduler, prefetch lane and telemetry modules."""
    name = request.param
    return types.SimpleNamespace(
        sch=importlib.import_module(f"{name}.scheduler"),
        prefetch=importlib.import_module(f"{name}.scheduler.prefetch"),
        obs=importlib.import_module(f"{name}.observability"),
    )


# ── DAG validation ────────────────────────────────────────────────────

def test_validate_rejects_bad_declarations(pkg):
    s = pkg.sch
    a = s.ArtifactSpec("a", fit=lambda c: 1)
    with pytest.raises(s.DagError, match="duplicate artifact"):
        s.validate([a, a], [])
    with pytest.raises(s.DagError, match="unknown artifact"):
        s.validate([a], [s.StageSpec("s", run=lambda c: 1, needs=("nope",))])
    with pytest.raises(s.DagError, match="unknown artifact"):
        s.validate([s.ArtifactSpec("b", fit=lambda c: 1, needs=("nope",))], [])
    with pytest.raises(s.DagError, match="duplicate node name"):
        s.validate([a], [s.StageSpec("a", run=lambda c: 1)])
    loop = [s.ArtifactSpec("x", fit=lambda c: 1, needs=("y",)),
            s.ArtifactSpec("y", fit=lambda c: 1, needs=("x",))]
    with pytest.raises(s.DagError, match="cycle"):
        s.validate(loop, [])


def test_validate_metadata(pkg):
    s = pkg.sch
    arts = [s.ArtifactSpec("base", fit=lambda c: 1),
            s.ArtifactSpec("derived", fit=lambda c: 1, needs=("base",))]
    stages = [s.StageSpec("s0", run=lambda c: 1),
              s.StageSpec("s1", run=lambda c: 1, needs=("derived",))]
    dag = s.validate(arts, stages)
    assert dag.depth == {"base": 0, "derived": 1}
    # s1 (index 1) is the first consumer of both (transitively).
    assert dag.first_consumer == {"base": 1, "derived": 1}


def test_port_refuses_sharded_layouts():
    """Sharded layouts belong to the multi-GPU port: any value but None
    or "host" raises when the spec is made; "host" still has to bind to
    a consumed artifact that declares a layout."""
    from ate_replication_causalml_torch import scheduler as s

    for kw in (dict(sharding=object()), dict(sharding="device"),
               dict(needs=("b",), consumes_sharding={"b": "device"})):
        with pytest.raises(s.DagError, match="Queue A item 6"):
            s.ArtifactSpec("a", fit=lambda c: 1, **kw)
    with pytest.raises(s.DagError, match="Queue A item 6"):
        s.StageSpec("s", run=lambda c: 1, needs=("b",), consumes_sharding={"b": object()})
    host = s.ArtifactSpec("b", fit=lambda c: 1, sharding="host")
    s.validate([host], [s.StageSpec("s", run=lambda c: 1, needs=("b",),
                                    consumes_sharding={"b": "host"})])
    with pytest.raises(s.DagError, match="unsharded"):
        s.validate([s.ArtifactSpec("b", fit=lambda c: 1)],
                   [s.StageSpec("s", run=lambda c: 1, needs=("b",),
                                consumes_sharding={"b": "host"})])


# ── nuisance cache ────────────────────────────────────────────────────

def test_cache_fits_once_under_contention(pkg):
    calls = []

    def fit(c):
        calls.append(threading.get_ident())
        time.sleep(0.02)  # widen the race window
        return object()

    cache = pkg.sch.NuisanceCache([pkg.sch.ArtifactSpec("a", fit=fit, key=("k",))])
    got = []
    threads = [threading.Thread(target=lambda: got.append(cache.get("a"))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1, "artifact fit more than once"
    assert all(v is got[0] for v in got), "consumers saw different objects"
    assert cache.stats() == {"misses": {"a": 1}, "hits": {"a": 7}}


def test_cache_distinct_keys_never_share(pkg):
    # Two caches model two runs whose configs differ: the same artifact
    # name with a different key refits, never aliases.
    vals = iter([11, 22])
    mk = lambda key: pkg.sch.NuisanceCache(
        [pkg.sch.ArtifactSpec("a", fit=lambda c: next(vals), key=key)])
    c1, c2 = mk(("fp1", 250)), mk(("fp1", 251))
    assert c1.get("a") == 11 and c2.get("a") == 22
    assert c1.get("a") == 11


def test_cache_artifact_consumes_artifact_and_failures_not_memoized(pkg):
    tries = {"n": 0}

    def flaky(c):
        tries["n"] += 1
        if tries["n"] == 1:
            raise RuntimeError("first fit dies")
        return 5

    cache = pkg.sch.NuisanceCache([
        pkg.sch.ArtifactSpec("base", fit=flaky, key=()),
        pkg.sch.ArtifactSpec("derived", fit=lambda c: c.get("base") + 1, needs=("base",),
                             key=()),
    ])
    with pytest.raises(RuntimeError):
        cache.get("derived")
    # The failure was not cached: the next consumer retries and wins.
    assert cache.get("derived") == 6
    assert tries["n"] == 2


# ── engine determinism under adversarial interleavings ────────────────

def _build(sch, track, gates=None):
    """One shared artifact, five stages (two consumers), values chosen so
    any cross-talk or double fit shows in the results."""
    fits = []

    def fit(c):
        fits.append("art")
        return 100

    def mk(i, needs):
        def run(c):
            if gates is not None:
                gates[f"s{i}"].wait(timeout=30)
            base = c.get("art") if needs else 0
            track["finished"].append(f"s{i}")
            return base + i

        return sch.StageSpec(f"s{i}", run=run, needs=needs)

    stages = [mk(i, ("art",) if i in (1, 3) else ()) for i in range(5)]
    return [sch.ArtifactSpec("art", fit=fit, key=("k",))], stages, fits


@pytest.mark.parametrize("perm", [[4, 3, 2, 1, 0], [2, 0, 4, 1, 3], [1, 4, 0, 3, 2]])
def test_forced_completion_orders_commit_in_declared_order(pkg, perm):
    track = {"finished": []}
    gates = {f"s{i}": threading.Event() for i in range(5)}
    arts, stages, fits = _build(pkg.sch, track, gates)
    committed = []
    engine = pkg.sch.SweepEngine(arts, stages,
                                 commit=lambda spec, value: committed.append((spec.name, value)),
                                 workers=5, prefetch=False)

    def release():
        # Stages may only finish in the permutation's order.
        for i in perm:
            gates[f"s{i}"].set()
            time.sleep(0.01)

    rel = threading.Thread(target=release)
    rel.start()
    results = engine.run()
    rel.join(30)
    want = [(f"s{i}", (100 if i in (1, 3) else 0) + i) for i in range(5)]
    assert committed == want
    assert results == dict(want)
    assert fits == ["art"]


def test_sequential_inline_matches_concurrent(pkg):
    seq_track, con_track = {"finished": []}, {"finished": []}
    committed_seq, committed_con = [], []
    arts, stages, _ = _build(pkg.sch, seq_track)
    pkg.sch.SweepEngine(arts, stages, commit=lambda s, v: committed_seq.append((s.name, v)),
                        workers=1, prefetch=False).run()
    arts, stages, _ = _build(pkg.sch, con_track)
    pkg.sch.SweepEngine(arts, stages, commit=lambda s, v: committed_con.append((s.name, v)),
                        workers=4, prefetch=False).run()
    assert committed_seq == committed_con
    # workers=1 runs the bodies in declared order, the artifact just
    # before its first consumer.
    assert seq_track["finished"] == [f"s{i}" for i in range(5)]


def test_abort_surfaces_earliest_declared_failure_and_truncates_commits(pkg):
    committed = []

    def mk(i):
        def run(c):
            if i in (2, 4):
                raise ValueError(f"boom {i}")
            return i

        return pkg.sch.StageSpec(f"s{i}", run=run)

    engine = pkg.sch.SweepEngine([], [mk(i) for i in range(5)],
                                 commit=lambda s, v: committed.append(s.name), workers=3,
                                 prefetch=False)
    with pytest.raises(ValueError, match="boom 2"):
        engine.run()
    assert committed == ["s0", "s1"]


def test_abort_drains_earlier_declared_stages_before_raising(pkg):
    # s1 aborts while s0 waits on its artifact's fit: sequentially s0
    # would have finished first, so the committed prefix is ["s0"].
    committed = []
    gate = threading.Event()

    def slow_fit(c):
        assert gate.wait(timeout=30)
        return 7

    arts = [pkg.sch.ArtifactSpec("slow", fit=slow_fit, key=())]
    stages = [pkg.sch.StageSpec("s0", run=lambda c: c.get("slow"), needs=("slow",)),
              pkg.sch.StageSpec("s1", run=lambda c: (_ for _ in ()).throw(ValueError("boom 1")))]
    engine = pkg.sch.SweepEngine(arts, stages, commit=lambda s, v: committed.append(s.name),
                                 workers=2, prefetch=False)

    def release_after_abort():
        deadline = time.time() + 30
        while time.time() < deadline:
            with engine._mu:
                if engine._abort:
                    break
            time.sleep(0.005)
        gate.set()

    rel = threading.Thread(target=release_after_abort)
    rel.start()
    with pytest.raises(ValueError, match="boom 1"):
        engine.run()
    rel.join(30)
    assert committed == ["s0"]


def test_operator_abort_stops_scheduling_and_reraises(pkg):
    ran, committed = [], []
    stages = [pkg.sch.StageSpec(f"s{i}", run=lambda c, i=i: ran.append(i)) for i in range(3)]
    eng = pkg.sch.SweepEngine([], stages, workers=4, prefetch=False,
                              commit=lambda spec, value: committed.append(spec.name))
    eng._operator_abort(KeyboardInterrupt("operator ^C"))
    with pytest.raises(KeyboardInterrupt):
        eng.run()
    assert ran == [] and committed == []


def test_failed_lane_artifact_refit_cannot_overlap_lane_nodes(pkg):
    # A failed laned artifact is refit by its (unlaned) consumer; the
    # refit must still never overlap a laned node.
    active = {"n": 0, "max": 0}
    mu = threading.Lock()
    refit_started = threading.Event()
    tries = {"n": 0}

    def enter():
        with mu:
            active["n"] += 1
            active["max"] = max(active["max"], active["n"])

    def leave():
        with mu:
            active["n"] -= 1

    def flaky_laned_fit(c):
        tries["n"] += 1
        if tries["n"] == 1:
            raise RuntimeError("first fit dies")
        refit_started.set()
        enter()
        time.sleep(0.2)
        leave()
        return 42

    def s1_body(c):
        enter()
        time.sleep(0.05)
        leave()
        return 1

    s = pkg.sch
    arts = [s.ArtifactSpec("a", fit=flaky_laned_fit, key=(), exclusive="mesh"),
            s.ArtifactSpec("b", fit=lambda c: refit_started.wait(timeout=30), key=())]
    stages = [s.StageSpec("s0", run=lambda c: c.get("a"), needs=("a",)),
              s.StageSpec("s1", run=s1_body, needs=("b",), exclusive="mesh")]
    assert s.SweepEngine(arts, stages, workers=2, prefetch=False).run() == {"s0": 42, "s1": 1}
    assert tries["n"] == 2
    assert active["max"] == 1, "refit of a laned artifact overlapped a lane node"


def test_workers_below_one_clamps_to_inline(pkg):
    eng = pkg.sch.SweepEngine([], [pkg.sch.StageSpec("s0", run=lambda c: 5)], workers=-1,
                              prefetch=False)
    assert eng.workers == 1
    assert eng.run() == {"s0": 5}


def test_resumed_stages_schedule_no_artifact_fits(pkg):
    fits = []
    arts = [pkg.sch.ArtifactSpec("a", fit=lambda c: fits.append(1) or 1, key=())]
    stages = [pkg.sch.StageSpec("s0", run=lambda c: 0, needs=())]
    assert pkg.sch.SweepEngine(arts, stages, workers=2, prefetch=False).run() == {"s0": 0}
    assert fits == []


def test_exclusive_lane_serializes(pkg):
    active = {"n": 0, "max": 0}
    lock = threading.Lock()

    def mk(i, lane):
        def run(c):
            with lock:
                active["n"] += 1
                active["max"] = max(active["max"], active["n"])
            time.sleep(0.03)
            with lock:
                active["n"] -= 1
            return i

        return pkg.sch.StageSpec(f"s{i}", run=run, exclusive=lane)

    pkg.sch.SweepEngine([], [mk(i, "mesh") for i in range(4)], workers=4, prefetch=False).run()
    assert active["max"] == 1, "lane nodes overlapped"
    active["max"] = 0
    pkg.sch.SweepEngine([], [mk(i, None) for i in range(4)], workers=4, prefetch=False).run()
    assert active["max"] >= 2, "no concurrency at all without a lane"


# ── stall diagnostic ────────────────────────────────────────

def _gated_stages(sch, track, gates=None, n=5):
    def mk(i):
        def run(c):
            track.append(f"enter s{i}")
            if gates is not None and f"s{i}" in gates:
                gates[f"s{i}"].wait(timeout=30)
            return i

        return sch.StageSpec(f"s{i}", run=run, needs=())

    return [mk(i) for i in range(n)]


def test_engine_stall_diagnostic_is_attributed(pkg):
    track: list[str] = []
    stages = _gated_stages(pkg.sch, track, None, n=3)
    gate_a0 = threading.Event()

    def fit_a0(c):
        gate_a0.wait(timeout=30)
        return 0

    stages[0] = pkg.sch.StageSpec("s0", run=stages[0].run, needs=("a0",))
    engine = pkg.sch.SweepEngine([pkg.sch.ArtifactSpec("a0", fit=fit_a0)], stages, workers=1,
                                 prefetch=False, stall_bound_s=0.05)
    seen = len(pkg.obs.EVENTS.records())
    stalls = lambda: [r for r in pkg.obs.EVENTS.records()[seen:]
                      if r["name"] == "scheduler_stall"]
    out: dict = {}
    runner = threading.Thread(target=lambda: out.update(results=engine.run()))
    runner.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not stalls():
        time.sleep(0.005)
    diag = engine.stall_diagnostic()
    gate_a0.set()
    runner.join(10)
    assert not runner.is_alive()
    assert out["results"] == {"s0": 0, "s1": 1, "s2": 2}
    assert diag["started_unfinished"] == ["a0"]
    assert diag["critical_path"] == ["a0", "s0"]
    assert any(lane.startswith("worker/") for lane in diag["heartbeat_ages"])
    ev = stalls()
    assert len(ev) == 1  # once per episode
    assert ev[0]["attrs"]["critical_path"] == "a0,s0"


# ── prefetch lane ─────────────────────────────────────────────────────

def test_prefetcher_warms_skips_and_swallows_errors(pkg):
    warmed = []
    drained = threading.Event()  # the last hook signals completion

    def boom():
        raise RuntimeError("compile exploded")

    pf = pkg.prefetch.CompilePrefetcher(
        [("cold", lambda: warmed.append("cold")), ("started", lambda: warmed.append("started")),
         ("nohook", None), ("bad", boom), ("last", drained.set)],
        started=lambda name: name == "started")
    pf.start()
    assert drained.wait(10), "prefetch thread never drained its items"
    pf.stop(timeout=10)
    assert warmed == ["cold"]  # started skipped, bad swallowed, nohook dropped


def test_prefetch_default_follows_the_device(monkeypatch):
    """The port's lane builds kernels: on by default for a CUDA device,
    off for the CPU or no device; ATE_TPU_SWEEP_PREFETCH overrides."""
    from ate_replication_causalml_torch.scheduler import SweepEngine, prefetch_default_enabled

    monkeypatch.delenv("ATE_TPU_SWEEP_PREFETCH", raising=False)
    assert prefetch_default_enabled("cuda") and prefetch_default_enabled(torch.device("cuda", 0))
    assert not prefetch_default_enabled("cpu") and not prefetch_default_enabled(None)
    monkeypatch.setenv("ATE_TPU_SWEEP_PREFETCH", "1")
    assert prefetch_default_enabled("cpu")
    monkeypatch.setenv("ATE_TPU_SWEEP_PREFETCH", "0")
    assert not prefetch_default_enabled("cuda")
    # A CPU engine gets no streams and no events.
    eng = SweepEngine([], [], workers=4, device="cpu")
    assert eng.device is None and not eng.prefetch


def test_worker_defaults_and_env(monkeypatch, pkg):
    monkeypatch.setenv("ATE_TPU_SWEEP_WORKERS", "3")
    assert pkg.sch.default_workers() == 3
    monkeypatch.setenv("ATE_TPU_SWEEP_WORKERS", "0")
    assert pkg.sch.default_workers() == 1
    monkeypatch.setenv("ATE_TPU_SWEEP_WORKERS", "many")
    assert pkg.sch.default_workers() == max(1, min(4, __import__("os").cpu_count() or 1))


def test_lane_bound_env_parsing(monkeypatch):
    from ate_replication_causalml_torch.resilience.watchdog import (
        HeartbeatRegistry,
        lane_bound_s,
    )

    monkeypatch.setenv("ATE_TPU_WATCHDOG_SWEEP_S", "2.5")
    assert lane_bound_s("sweep", 30.0) == 2.5
    monkeypatch.delenv("ATE_TPU_WATCHDOG_SWEEP_S")
    assert lane_bound_s("sweep", 30.0) == 30.0
    monkeypatch.setenv("ATE_TPU_WATCHDOG_LANE_MESH_S", "0")
    assert lane_bound_s("lane/mesh", 5.0) == 0.0
    monkeypatch.setenv("ATE_TPU_WATCHDOG_SWEEP_S", "soonish")
    with pytest.raises(ValueError, match="SWEEP"):
        lane_bound_s("sweep", 30.0)
    t = [0.0]
    hb = HeartbeatRegistry(clock=lambda: t[0])
    hb.beat("worker/a")
    hb.beat("lane/mesh")
    t[0] = 1.5
    assert hb.ages() == {"lane/mesh": 1.5, "worker/a": 1.5}
    assert hb.ages(now=2.0) == {"lane/mesh": 2.0, "worker/a": 2.0}


# ── launch counters ───────────────────────────────────────────────────

def test_launch_counter_loses_no_increment():
    """N threads × M increments of one wrapper's count give exactly N·M
    (a bare ``+= 1`` from several threads can lose increments), with a
    short switch interval to force interleaving."""
    from ate_replication_causalml_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.partition_launches = 0
    n_threads, m = 16, 2_000
    start = threading.Barrier(n_threads)

    def bump():
        start.wait(10)
        for _ in range(m):
            build.count_launch(wrapper)
            build.count_launch(wrapper, "partition_launches")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == wrapper.partition_launches == n_threads * m


def test_telemetry_registry_and_events():
    """The port's registry and event log: labelled samples, summary
    histograms, snapshot and reset; spans with explicit parentage across
    threads."""
    from ate_replication_causalml_torch import observability as obs

    reg = obs.MetricsRegistry()
    reg.counter("c").inc(2, node="a")
    reg.counter("c").inc(1, node="a")
    reg.gauge("g").set(4)
    for v in (3.0, 1.0):
        reg.histogram("h").observe(v, kind="stage")
    snap = reg.snapshot()
    assert snap["counters"] == {"c": {"node=a": 3.0}} and snap["gauges"] == {"g": {"": 4.0}}
    assert snap["histograms"]["h"]["kind=stage"] == {"count": 2, "sum": 4.0, "min": 1.0,
                                                    "max": 3.0, "last": 1.0}
    with pytest.raises(TypeError):
        reg.gauge("c")
    reg.reset()
    assert reg.snapshot()["counters"] == {}
    log = obs.EventLog(max_events=3)
    with log.span("root") as root:
        pass
    t = threading.Thread(target=lambda: log.emit("child"))
    with log.span("outer"):
        log.emit("inner")
    with log.span("remote", parent_id=root.span_id):
        pass
    t.start()
    t.join(10)
    recs = log.records()
    assert [r["name"] for r in recs] == ["outer", "remote", "child"] and log.dropped == 2
    assert recs[1]["parent_id"] == root.span_id and recs[2]["parent_id"] is None
