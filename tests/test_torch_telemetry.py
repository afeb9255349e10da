"""The port's telemetry (``observability/``, ``utils/profiling.py``)
against the JAX package's, on the CPU.

Pure functions, the same inputs through both packages, equal outputs
(exact ``==`` on dicts and strings): ``build_trace`` and the critical-path
/ overlap analysis on hand-built traces and on a span set recorded from
the port's engine, the Prometheus rendering of one registry snapshot.
Then the port's own pieces: the exporters' files pass
``scripts/check_metrics_schema.py``, the required counter families exist
at 0, the sampler and the dispatch instrumentation count, the atomic
writer keeps a file's mode, the build-cache watch gauges what the JAX
package's watch gauges, a built library's ptxas resources are recorded,
and ``torch.profiler`` captures write Chrome traces. The sweep-level checks (the five files of a MICRO sweep in both
modes, against the JAX package's) are in ``tests/test_torch_pipeline.py``,
on its module's sweeps.
"""

import json
import os
import stat
import sys
import time

import pytest

from ate_replication_causalml_torch import observability as tobs
from ate_replication_causalml_torch.observability import critical_path as tcp
from ate_replication_causalml_torch.observability import device as tdevice
from ate_replication_causalml_torch.observability import promtext as tprom
from ate_replication_causalml_torch.observability import trace as ttrace
from ate_replication_causalml_torch.scheduler import ArtifactSpec, StageSpec, SweepEngine
from ate_replication_causalml_torch.utils import profiling as tprof
from ate_replication_causalml_tpu.observability import critical_path as jcp
from ate_replication_causalml_tpu.observability import device as jdevice
from ate_replication_causalml_tpu.observability import registry as jregistry
from ate_replication_causalml_tpu.observability import promtext as jprom
from ate_replication_causalml_tpu.observability import trace as jtrace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import check_metrics_schema as cms  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    tobs.REGISTRY.reset()
    tobs.EVENTS.clear()
    yield
    tobs.REGISTRY.reset()
    tobs.EVENTS.clear()


def _mk_trace(nodes, workers=None, wall_s=None):
    """A hand-built catapult trace (``tests/test_trace.py``'s helper):
    ``nodes`` are (name, kind, lane, track, start_s, dur_s, needs)."""
    tracks, events = {}, []
    for i, (name, kind, lane, track, start, dur, needs) in enumerate(nodes):
        tid = tracks.setdefault(track, len(tracks) + 1)
        events.append({"name": name, "cat": "node", "ph": "X", "pid": 1, "tid": tid,
                       "ts": start * 1e6, "dur": dur * 1e6,
                       "args": {"node": name, "kind": kind, "lane": lane,
                                "needs": ",".join(needs), "stage_idx": i}})
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "args": {"name": track}}
            for track, tid in tracks.items()]
    other = {"wall_anchor_unix": 0.0}
    if workers is not None:
        other["workers"] = workers
    if wall_s is not None:
        other["wall_s"] = wall_s
    return {"traceEvents": meta + events, "otherData": other}


HAND_BUILT = {
    "dependency_chain": ([("A", "artifact", "", "w1", 0.0, 5.0, ()),
                          ("S1", "stage", "", "w2", 5.1, 3.9, ("A",)),
                          ("S3", "stage", "", "w3", 0.0, 8.0, ())], 3, 9.0),
    "long_node": ([("A", "artifact", "", "w1", 0.0, 5.0, ()),
                   ("S1", "stage", "", "w1", 5.0, 3.0, ("A",)),
                   ("S2", "stage", "", "w2", 0.0, 10.0, ())], 2, 10.0),
    "sequential": ([("A", "artifact", "", "main", 0.0, 1.0, ()),
                    ("S1", "stage", "", "main", 1.0, 2.0, ("A",)),
                    ("S2", "stage", "mesh", "main", 3.0, 0.5, ()),
                    ("S3", "stage", "", "main", 3.5, 1.5, ())], 1, 5.0),
    "ties_and_no_meta": ([("B", "stage", "", "w1", 0.0, 1.0, ()),
                          ("A", "stage", "", "w2", 0.0, 1.0, ()),
                          ("C", "stage", "", "w1", 1.0, 1.0, ("A", "B"))], None, None),
    "empty": ([], None, None),
}


@pytest.mark.parametrize("case", list(HAND_BUILT))
def test_critical_path_equals_jax_on_hand_built_traces(case):
    nodes, workers, wall = HAND_BUILT[case]
    trace = _mk_trace(nodes, workers=workers, wall_s=wall)
    assert tcp.nodes_from_trace(trace) == [tcp.NodeInterval(**vars(n))
                                           for n in jcp.nodes_from_trace(trace)]
    got = tcp.critical_path(tcp.nodes_from_trace(trace))
    want = jcp.critical_path(jcp.nodes_from_trace(trace))
    assert got == want
    assert tcp.overlap_report(trace) == jcp.overlap_report(trace)
    assert cms.validate_overlap(tcp.overlap_report(trace)) == []
    if case == "sequential":
        # One track: the path is the whole run in execution order.
        assert [e["name"] for e in got[0]] == ["A", "S1", "S2", "S3"]


def _recorded_run(workers: int) -> list[dict]:
    """The span records of a small DAG run by the port's engine: two
    artifacts, four stages, one laned, the committer and the run's root
    span, plus a point event and a counter sample."""
    def art(name, needs=()):
        return ArtifactSpec(name, fit=lambda c: time.sleep(0.004) or name, needs=needs)

    def stg(name, needs=(), lane=None):
        def run(c):
            for n in needs:
                c.get(n)
            time.sleep(0.003)
            tobs.emit("chaos_inject", status="injected", scope="stage", site=name)
            return name
        return StageSpec(name, run, needs=needs, exclusive=lane)

    with tobs.span("run_sweep", out="x") as root:
        SweepEngine([art("a0"), art("a1", needs=("a0",))],
                    [stg("s0"), stg("s1", ("a0",)), stg("s2", ("a1",), lane="mesh"), stg("s3")],
                    commit=lambda spec, v: None, workers=workers, prefetch=False,
                    span_parent=root.span_id).run()
        tobs.emit("metric_sample", status="sample", metric="nuisance_cache_requests_total",
                  value=3.0)
    return tobs.EVENTS.records()


@pytest.mark.parametrize("workers", [1, 3], ids=["sequential", "three_workers"])
def test_build_trace_and_overlap_equal_jax_on_recorded_spans(workers):
    records = _recorded_run(workers)
    meta = {"workers": workers, "wall_s": 1.0, "out": "x"}
    got = tobs.build_trace(records, meta=meta)
    want = jtrace.build_trace(records, meta=meta)
    assert got == want
    assert {e["name"] for e in got["traceEvents"] if e.get("cat") == "node"} == {
        "a0", "a1", "s0", "s1", "s2", "s3"}
    assert any(e.get("cat") == "dep" for e in got["traceEvents"])   # flow arrows
    assert cms.validate_trace(got) == []
    report = tcp.overlap_report(got)
    assert report == jcp.overlap_report(want)
    assert cms.validate_overlap(report) == []
    if workers == 1:
        assert [e["name"] for e in report["critical_path"]] == [
            "s0", "a0", "s1", "a1", "s2", "s3"]


def test_promtext_equals_jax_on_one_snapshot():
    reg = tobs.MetricsRegistry()
    reg.counter("sweep_stage_total", "x").inc(0)
    reg.counter("sweep_stage_total").inc(2, method="Causal Forest(GRF)", status="computed")
    reg.counter("sweep_stage_total").inc(1, method='odd"name\\', status="failed")
    reg.gauge("device_memory_bytes").set(1024, device="cuda:0", stat="allocated_bytes.all.peak")
    reg.histogram("stage_seconds").observe(0.25, stage="naive")
    reg.histogram("stage_seconds").observe(1.5, stage="naive")
    reg.counter("never_sampled")
    snap = reg.snapshot()
    text = tprom.render_prom_from_snapshot(snap)
    assert text == jprom.render_prom_from_snapshot(snap)
    assert "ate_tpu_sweep_stage_total{" in text and "ate_tpu_stage_seconds_count{" in text
    assert "never_sampled" not in text
    assert tprom.render_prom_text(reg) == text


def test_run_artifacts_pass_the_schema(tmp_path):
    """An instrumented run's exports: every required counter family at 0
    or more, the snapshot in the JAX package's layout, events.jsonl with
    its header, the textfile, all accepted by the schema checker."""
    tobs.install_monitoring()
    with tobs.span("run_sweep"):
        tobs.counter("sweep_stage_total").inc(1, method="naive", status="computed")
        tobs.emit("chaos_inject", status="injected", scope="fs", site="x")
    paths = tobs.write_run_artifacts(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["metrics.json", "events.jsonl",
                                                   "metrics.prom"]
    assert cms.validate_pair(paths[0], paths[1], require_stages=["naive"]) == []
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert set(snap) == {"schema_version", "created_unix", "counters", "gauges", "histograms",
                         "bucket_histograms"}
    assert set(cms.REQUIRED_COUNTERS) <= set(snap["counters"])
    assert tdevice.REQUIRED_COUNTERS == cms.REQUIRED_COUNTERS
    assert snap["counters"]["jax_compiles_total"] == {"": 0.0}
    header = json.loads((tmp_path / "events.jsonl").read_text().splitlines()[0])
    assert header == {"schema_version": 1, "kind": "events_header", "dropped": 0}
    assert "# TYPE ate_tpu_sweep_stage_total counter" in (tmp_path / "metrics.prom").read_text()
    # Nothing is recorded for device memory without a card in use.
    assert tobs.record_device_memory() == {}


def test_atomic_write_keeps_an_existing_files_mode(tmp_path):
    path = str(tmp_path / "report.json")
    tobs.atomic_write_text(path, "one")
    os.chmod(path, 0o600)
    tobs.atomic_write_json(path, {"a": 1})
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    assert json.loads(open(path).read()) == {"a": 1}
    assert sorted(os.listdir(tmp_path)) == ["report.json"]      # no temporary left


CACHE_GAUGES = ("compile_cache_entries", "compile_cache_bytes", "compile_cache_entries_written")


def test_watch_cache_dir_gauges_equal_jax(tmp_path, monkeypatch):
    """Both packages' watches of one directory, a file written after the
    watch began: the same three gauges at every snapshot. The JAX side
    watches into a registry of its own, so no collector outlives the
    test."""
    jreg = jregistry.MetricsRegistry()
    monkeypatch.setattr(jdevice, "REGISTRY", jreg)
    monkeypatch.setattr(jdevice, "gauge", jreg.gauge)
    monkeypatch.setattr(jdevice, "_WATCHED_CACHE_DIRS", set())
    monkeypatch.setattr(tdevice, "_WATCHED_CACHE_DIRS", set())
    for name, size in (("a.so", 10), ("b.so", 7)):
        (tmp_path / name).write_bytes(b"x" * size)
    tobs.watch_cache_dir(str(tmp_path))
    jdevice.watch_cache_dir(str(tmp_path))
    (tmp_path / "c.so").write_bytes(b"x" * 5)
    got = tobs.REGISTRY.snapshot()["gauges"]
    want = jreg.snapshot()["gauges"]
    assert {g: got[g] for g in CACHE_GAUGES} == {g: want[g] for g in CACHE_GAUGES}
    assert got["compile_cache_entries"] == {"": 3} and got["compile_cache_entries_written"] == {"": 1}


def test_record_compiled_cost_reads_ptxas():
    """A built library's ptxas report: the most registers and stack bytes
    of its device functions, their spill bytes summed, the nvcc wall."""
    from types import SimpleNamespace

    ptxas = ("ptxas info    : Function properties for hist_dense\n"
             "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
             "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n"
             "ptxas info    : Function properties for traverse_kernel\n"
             "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
             "ptxas info    : Used 56 registers, 380 bytes cmem[0]\n")
    got = tobs.record_compiled_cost("hist", SimpleNamespace(ptxas=ptxas, seconds=2.5))
    assert got == {"registers": 56.0, "stack_bytes": 16.0, "spill_bytes": 12.0,
                   "nvcc_seconds": 2.5}
    snap = tobs.REGISTRY.snapshot()["gauges"]["compiled_cost"]
    assert snap["entry=hist,stat=registers"] == 56.0 and len(snap) == 4


def test_metric_sampler_and_dispatch_instrumentation():
    tobs.install_monitoring()
    tobs.counter("nuisance_cache_requests_total").inc(3, artifact="a", status="miss")
    sampler = tobs.MetricSampler(interval_s=0.01)
    sampler.start()
    time.sleep(0.08)
    sampler.stop()
    samples = [r for r in tobs.EVENTS.records() if r["name"] == "metric_sample"]
    assert sampler.ticks >= 2 and sampler._thread is None
    per_tick = {r["attrs"]["metric"] for r in samples}
    # No card in use: no device-memory track; the counters' tracks exist.
    assert per_tick == {"nuisance_cache_requests_total", "shard_backoff_seconds_total",
                        "scheduler_prefetch_total"}
    assert len(samples) == 3 * sampler.ticks
    assert [r["attrs"]["value"] for r in samples
            if r["attrs"]["metric"] == "nuisance_cache_requests_total"][-1] == 3.0
    fn = tobs.instrument_dispatch("forest_classifier", lambda i: i * 2)
    assert [fn(i) for i in range(3)] == [0, 2, 4]
    snap = tobs.REGISTRY.snapshot()
    assert snap["counters"]["tree_dispatch_total"]["fit=forest_classifier"] == 3.0
    assert snap["histograms"]["tree_dispatch_seconds"]["fit=forest_classifier"]["count"] == 3
    assert ttrace.trace_enabled()


def test_trace_switch(monkeypatch, tmp_path):
    monkeypatch.setenv("ATE_TPU_TRACE", "0")
    assert not tobs.trace_enabled()
    assert tobs.write_trace_artifacts(str(tmp_path), tobs.build_trace([])) == []
    assert os.listdir(tmp_path) == []


def test_profiler_captures_write_chrome_traces(monkeypatch, tmp_path):
    """``xla_trace`` (per stage, ``ATE_TPU_TRACE_DIR``) and ``xprof_run``
    with ``xprof_annotation`` (``ATE_TPU_XPROF``) capture with
    torch.profiler and count; without the knobs they do nothing."""
    import torch

    monkeypatch.delenv("ATE_TPU_TRACE_DIR", raising=False)
    monkeypatch.delenv("ATE_TPU_XPROF", raising=False)
    with tprof.xla_trace("Causal Forest(GRF)"), tprof.xprof_run("run"), \
            tprof.xprof_annotation("x"):
        pass
    assert not tprof.device_profiling_armed() and os.listdir(tmp_path) == []
    monkeypatch.setenv("ATE_TPU_TRACE_DIR", str(tmp_path / "stages"))
    assert tprof.device_profiling_armed()
    with tprof.xla_trace("Causal Forest(GRF)"):
        torch.ones(4).sum()
    path = tmp_path / "stages" / "Causal_Forest_GRF_.trace.json"
    assert "traceEvents" in json.loads(path.read_text())
    monkeypatch.delenv("ATE_TPU_TRACE_DIR")
    monkeypatch.setenv("ATE_TPU_XPROF", str(tmp_path / "run"))
    with tprof.xprof_run("run_sweep"), tprof.xprof_annotation("Belloni et.al"):
        torch.ones(4).sum()
    names = {e.get("name") for e in
             json.loads((tmp_path / "run" / "run_sweep.trace.json").read_text())["traceEvents"]}
    assert "Belloni_et_al" in names
    counters = tobs.REGISTRY.snapshot()["counters"]
    assert counters["xla_trace_total"] == {"label=Causal_Forest_GRF_": 1.0}
    assert counters["xprof_trace_total"] == {"label=run_sweep": 1.0}
    timer = tprof.StageTimer()
    with timer.stage("naive"):
        pass
    assert set(timer.seconds) == {"naive"}
