"""The port's sweep (``pipeline.py``) against the JAX package's:
one MICRO sweep (``tests/test_pipeline_driver.py``'s shapes: 1,200-row
sample → 252 biased rows, 16-tree forests of depth 4, a 600-iteration
balancing budget) through both packages on the CPU (the JAX package
sequential, on one device, float32), matched row by row; the port's
concurrent sweep (4 workers) held to its sequential one bit for bit, row
by row and journal line by journal line, and resumed across modes both
ways; then the journal's mechanics on copies of the port's output
directory: resume, stale set-aside, torn lines, failed rows, degrade
against raise, and the report. The telemetry both packages write beside
``report.json`` (``metrics.json``, ``events.jsonl``, ``metrics.prom``,
``trace.json``, ``overlap_report.json``): the schema checker accepts the
port's in both modes, with the JAX package's span names, stage statuses,
counter totals and sequential critical path; and, on copies of the
port's output with a few rows dropped from the journal, fault injection
(a stage fault and a torn append, then a clean resume; a worker stall
under the engine's watchdog) and the device-profiling knobs.

Each row is held to the bound the port's test of its estimator states
(``BOUNDS``: file, |Δ| on τ and SE). The causal forest differs only at
float ties (its streaming grower against the JAX package's CPU default),
hence that file's wider bound.
"""

import dataclasses
import json
import math
import os
import shutil

import sys

import jax
import pytest
import torch

from ate_replication_causalml_torch import observability as tobs
from ate_replication_causalml_torch import pipeline as tp
from ate_replication_causalml_torch.data.pipeline import PrepConfig as TPrep
from ate_replication_causalml_torch.resilience import chaos as tchaos
from ate_replication_causalml_torch.resilience.errors import ChaosSpecError
from ate_replication_causalml_tpu import observability as jobs
from ate_replication_causalml_tpu import pipeline as jp
from ate_replication_causalml_tpu.data.pipeline import PrepConfig as JPrep

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import check_metrics_schema as cms  # noqa: E402


def _micro(mod, prep):
    """The MICRO configuration of tests/test_pipeline_driver.py, on one
    device."""
    return dataclasses.replace(
        mod.SweepConfig().quick(), prep=prep(n_obs=1200), synthetic_pool=3000,
        dr_trees=16, dml_trees=16, cf_trees=16, cf_nuisance_trees=16, forest_depth=4,
        balance_iters=600, use_mesh=False)


MICRO = _micro(tp, TPrep)
_IPW = ("tests/test_torch_ipw.py", lambda ref: 2e-6 + 2e-5 * abs(ref))
_AIPW = ("tests/test_torch_aipw.py", lambda ref: 1e-6)
_TAU = ("tests/test_torch_lasso_est.py", lambda ref: 5e-5)
BOUNDS = {
    "oracle": _AIPW,
    "naive": _AIPW,
    "Direct Method": _IPW,
    "Propensity_Weighting": _IPW,
    "Propensity_Regression": _IPW,
    "Propensity_Weighting_LASSOPS": ("tests/test_torch_lasso_est.py", lambda ref: 2e-4),
    "Single-equation LASSO": _TAU,
    "Usual LASSO": _TAU,
    "Doubly Robust with Random Forest PS": _AIPW,
    "Doubly Robust with logistic regression PS": _AIPW,
    "Belloni et.al": ("tests/test_torch_lasso_est.py", lambda ref: 1e-5),
    "Double Machine Learning": ("tests/test_torch_dml.py", lambda ref: 1e-6),
    "residual_balancing": ("tests/test_torch_balance.py", lambda ref: 5e-5),
    "Causal Forest(GRF)": ("tests/test_torch_causal_forest.py", lambda ref: 2e-2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file: the ADMM's small float64
    matrix-vector products, multithreaded on a CPU the suite's parallel
    workers keep busy, wait on their threads (one n = 4,000 solve on an
    8-core CPU beside five busy processes: 5.3 s on one thread, 59.5 s on
    eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(report) -> dict:
    return {"oracle": report.oracle, **{r.method: r for r in report.results}}


def _same(a, b) -> bool:
    """Rows equal, NaN equal to NaN (the point-only rows' SE)."""
    return tp._jsonsafe(a.to_dict()) == tp._jsonsafe(b.to_dict())


def _fresh(obs) -> None:
    """Empty a package's process-global registry and event log, so that a
    run's metrics.json and events.jsonl hold that run alone."""
    obs.REGISTRY.reset()
    obs.EVENTS.clear()


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweeps")
    _fresh(jobs)
    with jax.enable_x64(False):
        ref = jp.run_sweep(_micro(jp, JPrep), outdir=str(root / "jax"), plots=False,
                           log=lambda s: None, scheduler="sequential")
    logs, conc_logs = [], []
    _fresh(tobs)
    got = tp.run_sweep(MICRO, outdir=str(root / "port"), plots=True, log=logs.append,
                       scheduler="sequential", device="cpu")
    _fresh(tobs)
    conc = tp.run_sweep(MICRO, outdir=str(root / "concurrent"), plots=False,
                        log=conc_logs.append, workers=4, device="cpu")
    return dict(ref=ref, got=got, conc=conc, root=root, logs=logs, conc_logs=conc_logs)


def _copy(sweeps, tmp_path, name="out") -> str:
    out = str(tmp_path / name)
    shutil.copytree(str(sweeps["root"] / "port"), out)
    return out


def _journal(out) -> list[str]:
    with open(os.path.join(out, "results.jsonl")) as f:
        return f.readlines()


def _stripped(out) -> list[dict]:
    """The journal's records without their wall seconds."""
    return [{k: v for k, v in json.loads(ln).items() if k != "seconds"} for ln in _journal(out)]


def test_methods_in_the_jax_packages_order(sweeps):
    assert tp.SWEEP_METHODS == jp.SWEEP_METHODS
    assert sweeps["got"].results.methods() == list(jp.SWEEP_METHODS)
    assert sweeps["got"].computed == len(tp.SWEEP_METHODS) + 1 and sweeps["got"].resumed == 0
    assert (sweeps["got"].n_dropped, sweeps["got"].n_biased) == (
        sweeps["ref"].n_dropped, sweeps["ref"].n_biased) == (948, 252)


@pytest.mark.parametrize("method", ["oracle", *tp.SWEEP_METHODS])
def test_row_equals_jax(sweeps, method):
    got, ref = _rows(sweeps["got"])[method], _rows(sweeps["ref"])[method]
    source, bound = BOUNDS[method]
    assert got.status == ref.status == "ok"
    assert abs(got.ate - ref.ate) <= bound(ref.ate), (source, got.ate, ref.ate)
    if math.isnan(ref.se):
        assert math.isnan(got.se)
    else:
        assert abs(got.se - ref.se) <= bound(ref.se), (source, got.se, ref.se)


@pytest.mark.parametrize("method", ["oracle", *tp.SWEEP_METHODS])
def test_concurrent_row_equals_sequential(sweeps, method):
    """The 4-worker sweep's row is the sequential sweep's, bit for bit."""
    got, want = _rows(sweeps["conc"])[method], _rows(sweeps["got"])[method]
    assert got.status == "ok" and _same(got, want), (got, want)


@pytest.mark.parametrize("method", ["oracle", *tp.SWEEP_METHODS])
def test_concurrent_row_equals_jax(sweeps, method):
    got, ref = _rows(sweeps["conc"])[method], _rows(sweeps["ref"])[method]
    source, bound = BOUNDS[method]
    assert abs(got.ate - ref.ate) <= bound(ref.ate), (source, got.ate, ref.ate)
    assert math.isnan(got.se) if math.isnan(ref.se) else abs(got.se - ref.se) <= bound(ref.se)


def test_concurrent_journal_equals_sequential(sweeps):
    """The concurrent sweep commits in notebook order: its journal lines,
    seconds aside, are the sequential sweep's, in the same order; so are
    the incorrect aggregate and the counts."""
    conc, seq = sweeps["conc"], sweeps["got"]
    assert _stripped(str(sweeps["root"] / "concurrent")) == _stripped(str(sweeps["root"] / "port"))
    assert (conc.computed, conc.resumed) == (len(tp.SWEEP_METHODS) + 1, 0)
    assert (conc.incorrect_cf_ate, conc.incorrect_cf_se) == (seq.incorrect_cf_ate,
                                                             seq.incorrect_cf_se)
    assert any("concurrent sweep, 4 workers" in ln for ln in sweeps["conc_logs"])
    assert not any("scheduler:" in ln for ln in sweeps["logs"])
    rows = [ln for ln in sweeps["conc_logs"] if ln.startswith("  ") and "ate=" in ln]
    assert [ln.split(":")[0].strip() for ln in rows] == ["oracle", *tp.SWEEP_METHODS]


@pytest.mark.parametrize("source,kw", [("concurrent", dict(scheduler="sequential")),
                                       ("port", dict(workers=4))],
                         ids=["sequential_resumes_concurrent", "concurrent_resumes_sequential"])
def test_resume_across_modes(sweeps, tmp_path, source, kw):
    """The journal's fingerprint is mode-free: either mode resumes the
    other's journal, computing nothing."""
    out = str(tmp_path / "out")
    shutil.copytree(str(sweeps["root"] / source), out)
    again = tp.run_sweep(MICRO, outdir=out, plots=False, log=lambda s: None, device="cpu", **kw)
    assert (again.computed, again.resumed) == (0, len(tp.SWEEP_METHODS) + 1)
    first = _rows(sweeps["got"])
    assert all(_same(r, first[m]) for m, r in _rows(again).items())


def test_incorrect_causal_aggregate_equals_jax(sweeps):
    got, ref = sweeps["got"], sweeps["ref"]
    assert abs(got.incorrect_cf_ate - ref.incorrect_cf_ate) <= 2e-2
    assert abs(got.incorrect_cf_se - ref.incorrect_cf_se) <= 2e-2


def test_report_files(sweeps):
    rep, out = sweeps["got"], str(sweeps["root"] / "port")
    with open(os.path.join(out, "report.json")) as f:
        text = f.read()
    assert "NaN" not in text
    doc = json.loads(text)
    assert [r["method"] for r in doc["results"]] == list(tp.SWEEP_METHODS)
    assert doc["oracle"]["ate"] == rep.oracle.ate and doc["device"] == "cpu"
    assert doc["failures"] == {} and doc["n_dropped"] == rep.n_dropped
    with open(os.path.join(out, "REPORT.md")) as f:
        md = f.read()
    assert f"## [1] {rep.n_dropped}" in md and "Incorrect ATE:" in md
    for m in tp.SWEEP_METHODS:
        assert f"| {m} | {rep.results[m].ate:.4f} |" in md
    assert len(rep.figure_paths) == 3
    for p in rep.figure_paths:
        assert os.path.getsize(p) > 10_000 and os.path.basename(p) in md
    methods = [json.loads(ln)["method"] for ln in _journal(out)]
    assert methods == ["__config__", "oracle", *tp.SWEEP_METHODS]


def test_resume_computes_nothing(sweeps, tmp_path):
    out = _copy(sweeps, tmp_path)
    logs = []
    again = tp.run_sweep(MICRO, outdir=out, plots=False, log=logs.append, device="cpu")
    assert (again.computed, again.resumed) == (0, len(tp.SWEEP_METHODS) + 1)
    assert sum("[resume]" in ln for ln in logs) == len(tp.SWEEP_METHODS) + 1
    first = _rows(sweeps["got"])
    assert all(_same(r, first[m]) for m, r in _rows(again).items())
    assert again.incorrect_cf_ate == sweeps["got"].incorrect_cf_ate


def test_changed_config_and_jax_journal_set_aside(sweeps, tmp_path):
    """Another config's fingerprint sets the journal aside as .stale, a
    second change as .stale.1; the JAX package's journal of the same
    configuration is never resumed as the port's rows."""
    out = _copy(sweeps, tmp_path)
    path = os.path.join(out, "results.jsonl")
    cpu = torch.device("cpu")
    same = tp._Checkpoint(path, tp._fingerprint(MICRO, None, cpu), log=lambda s: None)
    assert len(same.done) == len(tp.SWEEP_METHODS) + 1
    for n, changed in enumerate((dataclasses.replace(MICRO, dr_trees=17),
                                 dataclasses.replace(MICRO, balance_iters=601))):
        ck = tp._Checkpoint(path, tp._fingerprint(changed, None, cpu), log=lambda s: None)
        assert ck.done == {}
        assert os.path.exists(path + (".stale" if n == 0 else ".stale.1"))
    # The device is part of the fingerprint too.
    assert tp._fingerprint(MICRO, None, cpu) != tp._fingerprint(MICRO, None, torch.device("cuda"))
    jpath = str(tmp_path / "jax.jsonl")
    shutil.copy(str(sweeps["root"] / "jax" / "results.jsonl"), jpath)
    ck = tp._Checkpoint(jpath, tp._fingerprint(MICRO, None, cpu), log=lambda s: None)
    assert ck.done == {} and os.path.exists(jpath + ".stale")


def test_torn_last_line_is_skipped(sweeps, tmp_path):
    out = _copy(sweeps, tmp_path)
    lines = _journal(out)
    with open(os.path.join(out, "results.jsonl"), "w") as f:
        f.writelines(lines[:-1] + [lines[-1][: len(lines[-1]) // 2]])
    logs = []
    again = tp.run_sweep(MICRO, outdir=out, plots=False, log=logs.append, device="cpu")
    assert any("skipping unparsable line" in ln for ln in logs)
    assert again.computed == 1 and again.resumed == len(tp.SWEEP_METHODS)
    assert _same(again.results["Causal Forest(GRF)"], sweeps["got"].results["Causal Forest(GRF)"])


def test_failed_row_recomputes(sweeps, tmp_path):
    out = _copy(sweeps, tmp_path)
    nan = float("nan")
    failed = dict(method="Direct Method", ate=nan, lower_ci=nan, upper_ci=nan, se=nan,
                  status="failed", error="RuntimeError: x", attempts=1, seconds=0.0)
    with open(os.path.join(out, "results.jsonl"), "a") as f:
        f.write(json.dumps(tp._jsonsafe(failed)) + "\n")
    logs = []
    again = tp.run_sweep(MICRO, outdir=out, plots=False, log=logs.append, device="cpu")
    assert again.computed == 1
    assert any("[retry] Direct Method" in ln and "status='failed'" in ln for ln in logs)
    assert _same(again.results["Direct Method"], sweeps["got"].results["Direct Method"])
    assert json.loads(_journal(out)[-1])["attempts"] == 2


def test_degrade_and_raise(sweeps, tmp_path, monkeypatch):
    """A row made to raise: "degrade" records it as a failed row (report,
    journal, REPORT.md) and the sweep goes on; "raise" propagates the
    error."""
    out = _copy(sweeps, tmp_path)
    lines = [ln for ln in _journal(out) if json.loads(ln)["method"] != "Direct Method"]
    with open(os.path.join(out, "results.jsonl"), "w") as f:
        f.writelines(lines)

    def boom(frame):
        raise RuntimeError("injected | failure")

    monkeypatch.setattr(tp, "ate_condmean_ols", boom)
    rep = tp.run_sweep(MICRO, outdir=out, plots=False, log=lambda s: None, device="cpu")
    row = rep.results["Direct Method"]
    assert row.status == "failed" and math.isnan(row.ate)
    assert rep.failures["Direct Method"]["error"] == "RuntimeError: injected | failure"
    assert rep.computed == 1 and rep.resumed == len(tp.SWEEP_METHODS)
    assert json.loads(_journal(out)[-1])["status"] == "failed"
    with open(os.path.join(out, "REPORT.md")) as f:
        md = f.read()
    assert "| Direct Method | ✗ failed |" in md and "injected \\| failure" in md
    with pytest.raises(RuntimeError, match="injected"):
        tp.run_sweep(dataclasses.replace(MICRO, fail_policy="raise"), plots=False,
                     log=lambda s: None, device="cpu")


def test_unsupported_arguments_raise_before_any_work(tmp_path, monkeypatch):
    """An unknown scheduler, a malformed ``ATE_TPU_CHAOS`` spec, a sharded
    artifact or stage layout (multi-GPU is not ported), the card without
    one, and figures without matplotlib all raise before any frame is
    built."""
    from ate_replication_causalml_torch.scheduler import ArtifactSpec, DagError, StageSpec

    def no_frames(*a, **k):
        raise AssertionError("the sweep started")

    monkeypatch.setattr(tp, "build_frames", no_frames)
    with pytest.raises(ValueError, match="scheduler"):
        tp.run_sweep(MICRO, plots=False, device="cpu", scheduler="threads")
    monkeypatch.setenv("ATE_TPU_SWEEP_SEQUENTIAL", "1")
    with pytest.raises(ValueError, match="scheduler"):
        tp.run_sweep(MICRO, plots=False, device="cpu", scheduler="parallel")
    monkeypatch.setenv("ATE_TPU_CHAOS", "stage:p=1.0")
    with pytest.raises(ChaosSpecError, match="unknown key 'p' for chaos scope 'stage'"):
        tp.run_sweep(MICRO, plots=False, device="cpu", scheduler="sequential")
    monkeypatch.delenv("ATE_TPU_CHAOS")
    with pytest.raises(DagError, match="multi-GPU"):
        ArtifactSpec("p_logistic", fit=lambda c: None, sharding=object())
    with pytest.raises(DagError, match="multi-GPU"):
        StageSpec("naive", run=lambda c: None, needs=("p_logistic",),
                  consumes_sharding={"p_logistic": "device"})
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.run_sweep(MICRO, plots=False)
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tp.run_sweep(MICRO, outdir=str(tmp_path / "p"), plots=True, device="cpu")


def test_scheduler_resolution(monkeypatch):
    """None is the concurrent default at ``default_workers()``;
    "sequential", ``ATE_TPU_SWEEP_SEQUENTIAL`` or ``workers=1`` run
    inline; ``workers`` below 1 clamps; a device capture
    (``ATE_TPU_TRACE_DIR``, ``ATE_TPU_XPROF``) forces the sequential sweep
    and says so."""
    monkeypatch.delenv("ATE_TPU_SWEEP_SEQUENTIAL", raising=False)
    monkeypatch.setenv("ATE_TPU_SWEEP_WORKERS", "3")
    assert tp._resolve_scheduler(None, None) == 3
    assert tp._resolve_scheduler("concurrent", 2) == 2
    assert tp._resolve_scheduler(None, 0) == 1
    assert tp._resolve_scheduler("sequential", 8) == 1
    monkeypatch.setenv("ATE_TPU_SWEEP_SEQUENTIAL", "yes")
    assert tp._resolve_scheduler(None, 4) == 1
    assert tp._resolve_scheduler("concurrent", 4) == 4
    monkeypatch.delenv("ATE_TPU_SWEEP_SEQUENTIAL")
    for knob in ("ATE_TPU_TRACE_DIR", "ATE_TPU_XPROF"):     # a device capture
        monkeypatch.setenv(knob, "/nonexistent")
        logs = []
        assert tp._resolve_scheduler("concurrent", 4, logs.append) == 1
        assert "forcing the sequential sweep" in logs[0]
        monkeypatch.delenv(knob)


def test_main_arguments(monkeypatch):
    """The CLI's flags reach run_sweep: --workers as the pool width,
    --sequential as the sequential scheduler, neither as the default."""
    seen = {}

    def fake_run_sweep(config, **kw):
        seen.clear()
        seen.update(config=config, **kw)
        return tp.SweepReport(oracle=None, results=tp.ResultTable(), n_dropped=0, n_biased=0)

    monkeypatch.setattr(tp, "run_sweep", fake_run_sweep)
    tp.main(["--out", "o", "--quick", "--no-plots", "--sequential", "--device", "cpu"])
    assert seen["config"] == tp.SweepConfig().quick() and seen["outdir"] == "o"
    assert seen["plots"] is False and seen["device"] == "cpu" and seen["workers"] is None
    assert seen["scheduler"] == "sequential"
    tp.main(["--out", "o", "--workers", "2", "--device", "cpu"])
    assert seen["workers"] == 2 and seen["scheduler"] is None
    assert seen["config"] == tp.SweepConfig() and seen["plots"] is True


# ── telemetry against the JAX package's ────────────────────────────────

TELEMETRY = ("metrics.json", "events.jsonl", "metrics.prom", "trace.json", "overlap_report.json")
MODES = {"sequential": "port", "concurrent": "concurrent"}
ROWS = ["oracle", *tp.SWEEP_METHODS]
#: Counter families whose totals differ from the JAX package's by design.
BY_DESIGN = {
    "jax_compiles_total": "the JAX package counts its XLA traces and compiles; the port "
                          "compiles nothing at run time, a recorded 0",
    "compile_cache_hits_total": "XLA's persistent compile cache against the port's kernel "
                                "libraries (none built on the CPU)",
    "compile_cache_misses_total": "as compile_cache_hits_total",
    "scheduler_prefetch_total": "XLA ahead-of-time compiles a node against the port's one "
                                "kernel-build item (the lane is off on the CPU in both)",
}
#: Families only the JAX package exports.
JAX_ONLY = {
    "compile_cache_requests_total": "XLA's persistent compile cache",
    "compile_cache_tasks_total": "XLA's persistent compile cache",
    "compile_cache_disabled_tasks_total": "XLA's persistent compile cache",
    "router_request_path_total": "the serving plane, not ported",
    "serving_batches_total": "the serving plane, not ported",
    "serving_reloads_total": "the serving plane, not ported",
}


def _metrics(out) -> dict:
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def _events(out) -> list[dict]:
    with open(os.path.join(out, "events.jsonl")) as f:
        return [json.loads(ln) for ln in f.read().splitlines()[1:]]


def _stage_statuses(out) -> dict:
    return {r["attrs"]["method"]: r["status"] for r in _events(out) if r["name"] == "sweep_stage"}


@pytest.mark.parametrize("mode", MODES)
def test_telemetry_files_pass_the_schema(sweeps, mode):
    out = str(sweeps["root"] / MODES[mode])
    assert all(os.path.exists(os.path.join(out, f)) for f in TELEMETRY)
    errors = cms.validate_pair(os.path.join(out, "metrics.json"),
                               os.path.join(out, "events.jsonl"), require_stages=ROWS)
    assert errors + cms.validate_trace_files(out) == []
    with open(os.path.join(out, "trace.json")) as f:
        other = json.load(f)["otherData"]
    assert other["workers"] == (1 if mode == "sequential" else 4)
    assert other["sampler_ticks"] >= 1
    with open(os.path.join(out, "metrics.prom")) as f:
        assert 'ate_tpu_sweep_stage_total{method="oracle",status="computed"} 1.0' in f.read()


@pytest.mark.parametrize("mode", MODES)
def test_span_names_and_stage_statuses_equal_jax(sweeps, mode):
    out, ref = str(sweeps["root"] / MODES[mode]), str(sweeps["root"] / "jax")
    assert {r["name"] for r in _events(out)} == {r["name"] for r in _events(ref)}
    assert _stage_statuses(out) == _stage_statuses(ref) == {m: "computed" for m in ROWS}
    root = next(r for r in _events(out) if r["name"] == "run_sweep")
    assert {r["parent_id"] for r in _events(out)
            if r["name"] in ("sweep_stage", "scheduler_node", "commit")} == {root["span_id"]}


@pytest.mark.parametrize("mode", MODES)
def test_counter_totals_equal_jax(sweeps, mode):
    """Every counter family both packages export has the JAX package's
    samples, but those ``BY_DESIGN`` lists; the JAX package's own
    families are ``JAX_ONLY``."""
    got = _metrics(str(sweeps["root"] / MODES[mode]))["counters"]
    want = _metrics(str(sweeps["root"] / "jax"))["counters"]
    assert set(want) - set(got) == set(JAX_ONLY) and set(got) <= set(want)
    for name in ("sweep_stage_total", "nuisance_cache_requests_total",
                 "checkpoint_torn_lines_total"):
        assert got[name] == want[name], name
    assert {n: got[n] for n in set(got) - set(BY_DESIGN)} == {
        n: want[n] for n in set(got) - set(BY_DESIGN)}
    assert got["jax_compiles_total"] == {"": 0.0}


def test_sequential_critical_path_is_the_execution_order(sweeps):
    """One track: the sequential sweep's critical path is every node in
    the order it ran, the JAX package's order; the concurrent sweep's
    lanes each stay within the wall."""
    out = str(sweeps["root"] / "port")
    with open(os.path.join(out, "overlap_report.json")) as f:
        rep = json.load(f)
    with open(os.path.join(sweeps["root"] / "jax" / "overlap_report.json")) as f:
        ref = json.load(f)
    ran = [r["attrs"]["node"] for r in sorted(_events(out), key=lambda r: r["start_mono_s"])
           if r["name"] == "scheduler_node"]
    path = [e["name"] for e in rep["critical_path"]]
    assert path == ran == [e["name"] for e in ref["critical_path"]]
    assert path[-1] == "Causal Forest(GRF)" and rep["workers"] == 1
    with open(os.path.join(sweeps["root"] / "concurrent" / "overlap_report.json")) as f:
        conc = json.load(f)
    assert conc["workers"] == 4 and conc["nodes"] == len(ran)
    assert all(t["busy_s"] <= conc["wall_s"] for t in conc["tracks"].values())


# ── fault injection and device profiling on copies of the port's sweep ──

def _drop(out, methods) -> None:
    lines = [ln for ln in _journal(out) if json.loads(ln)["method"] not in methods]
    with open(os.path.join(out, "results.jsonl"), "w") as f:
        f.writelines(lines)


def _injected(out) -> list:
    return [(r["attrs"]["scope"], r["attrs"]["site"]) for r in _events(out)
            if r["name"] == "chaos_inject"]


def test_chaos_stage_fault_and_torn_append_then_clean_resume(sweeps, tmp_path, monkeypatch):
    """``stage:fail`` and ``fs:torn_write`` under "degrade" on the
    concurrent sweep: the failed row and the injections are the ones the
    chaos decisions predict, every other row is the fault-free one bit
    for bit; a clean resume recomputes exactly the failed and the torn
    rows, to the fault-free bits."""
    out = _copy(sweeps, tmp_path)
    dropped = ("Single-equation LASSO", "Usual LASSO")
    _drop(out, dropped)
    spec = "stage:fail=Usual LASSO;fs:torn_write"
    predicted = tchaos.ChaosInjector(tchaos.parse_chaos(spec)).plan_stage_faults(list(dropped))
    assert predicted == {"Usual LASSO"}
    monkeypatch.setenv("ATE_TPU_CHAOS", spec)
    _fresh(tobs)
    rep = tp.run_sweep(MICRO, outdir=out, plots=False, log=lambda s: None, workers=4,
                       device="cpu")
    first = _rows(sweeps["got"])
    assert set(rep.failures) == predicted
    assert rep.failures["Usual LASSO"]["error"].startswith("ChaosStageFault: chaos: injected")
    assert (rep.computed, rep.resumed) == (2, len(ROWS) - 2)
    assert all(_same(r, first[m]) for m, r in _rows(rep).items() if m not in predicted)
    path = os.path.join(out, "results.jsonl")
    assert _injected(out) == [("stage", "Usual LASSO"), ("fs", path)]
    torn, failed = _journal(out)[-2:]
    with pytest.raises(json.JSONDecodeError):
        json.loads(torn)
    assert json.loads(failed)["status"] == "failed"
    counters = _metrics(out)["counters"]
    assert counters["chaos_injections_total"] == {"": 0.0, "scope=stage": 1.0, "scope=fs": 1.0}
    assert counters["sweep_stage_total"]["method=Usual LASSO,status=failed"] == 1.0
    assert cms.validate_pair(path.replace("results.jsonl", "metrics.json"),
                             path.replace("results.jsonl", "events.jsonl")) == []

    monkeypatch.delenv("ATE_TPU_CHAOS")
    _fresh(tobs)
    logs = []
    again = tp.run_sweep(MICRO, outdir=out, plots=False, log=logs.append, scheduler="sequential",
                         device="cpu")
    assert (again.computed, again.resumed, again.failures) == (2, len(ROWS) - 2, {})
    assert all(_same(r, first[m]) for m, r in _rows(again).items())
    assert any("skipping unparsable line" in ln for ln in logs)
    assert any("[retry] Usual LASSO" in ln for ln in logs)
    counters = _metrics(out)["counters"]
    assert counters["checkpoint_torn_lines_total"] == {"": 1.0}
    assert {k: v for k, v in counters["sweep_stage_total"].items() if "computed" in k} == {
        f"method={m},status=computed": 1.0 for m in dropped}
    assert _injected(out) == []
    torn_events = [r for r in _events(out) if r["name"] == "checkpoint_torn_lines"]
    assert [r["attrs"]["lines"] for r in torn_events] == [1]


def test_worker_stall_is_reported_and_rows_unchanged(sweeps, tmp_path, monkeypatch):
    """``hang:scope=worker`` stalls one node past the engine's watchdog
    bound (``ATE_TPU_WATCHDOG_SWEEP_S``): one ``scheduler_stall`` event
    naming it, one ``watchdog_stalls_total``, the rows unchanged."""
    out = _copy(sweeps, tmp_path)
    _drop(out, ("Direct Method",))
    seed = next(s for s in range(10_000)
                if {m for m in ROWS if tchaos._unit(s, "hang", "worker", m) < 0.2}
                == {"Direct Method"})
    monkeypatch.setenv("ATE_TPU_CHAOS", f"hang:scope=worker,ms=1000,p=0.2,seed={seed}")
    monkeypatch.setenv("ATE_TPU_WATCHDOG_SWEEP_S", "0.25")
    _fresh(tobs)
    rep = tp.run_sweep(MICRO, outdir=out, plots=False, log=lambda s: None,
                       scheduler="sequential", device="cpu")
    assert (rep.computed, rep.failures) == (1, {})
    first = _rows(sweeps["got"])
    assert all(_same(r, first[m]) for m, r in _rows(rep).items())
    stalls = [r["attrs"] for r in _events(out) if r["name"] == "scheduler_stall"]
    assert len(stalls) == 1 and "Direct Method" in stalls[0]["started_unfinished"]
    assert _metrics(out)["counters"]["watchdog_stalls_total"] == {"": 0.0, "lane=sweep": 1.0}
    assert _injected(out) == [("hang", "worker/Direct Method")]


@pytest.mark.parametrize("knob", ["ATE_TPU_TRACE_DIR", "ATE_TPU_XPROF"])
def test_device_profiling_knob_runs_sequentially_with_a_trace(sweeps, tmp_path, monkeypatch,
                                                              knob):
    """Either device-capture knob forces the sequential sweep on a
    4-worker request and writes a torch.profiler Chrome trace: one per
    computed row under ``ATE_TPU_TRACE_DIR``, one for the run, with a
    ``record_function`` range a row, under ``ATE_TPU_XPROF``."""
    out = _copy(sweeps, tmp_path)
    _drop(out, ("Direct Method",))
    prof = tmp_path / "prof"
    monkeypatch.setenv(knob, str(prof))
    _fresh(tobs)
    logs = []
    rep = tp.run_sweep(MICRO, outdir=out, plots=False, log=logs.append, workers=4,
                       device="cpu")
    assert rep.computed == 1
    assert _same(rep.results["Direct Method"], sweeps["got"].results["Direct Method"])
    assert any("forcing the sequential sweep" in ln for ln in logs)
    assert not any("concurrent sweep" in ln for ln in logs)
    with open(os.path.join(out, "trace.json")) as f:
        assert json.load(f)["otherData"]["workers"] == 1
    counters = _metrics(out)["counters"]
    if knob == "ATE_TPU_TRACE_DIR":
        assert counters["xla_trace_total"] == {"": 0.0, "label=Direct_Method": 1.0}
        assert os.listdir(prof) == ["Direct_Method.trace.json"]
    else:
        assert counters["xprof_trace_total"] == {"": 0.0, "label=run_sweep": 1.0}
        with open(prof / "run_sweep.trace.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "Direct_Method" in names
