"""The notebook-equivalent sweep.

Port of ``ate_replication_causalml_tpu/pipeline.py``: data ingest →
prep → bias injection → RCT oracle → every estimator row of
``ate_replication.Rmd`` in notebook order → one result table, with

* **concurrent scheduling** (the default): the rows and their shared
  nuisances are a DAG run by a pool of worker threads, one CUDA stream a
  worker on the card (``scheduler/``); commits follow the notebook order,
  and every row equals the sequential sweep's bit for bit.
  ``scheduler="sequential"`` (``--sequential``, ``ATE_TPU_SWEEP_SEQUENTIAL=1``
  or ``workers=1``) runs the same graph inline on the calling thread;
* **checkpoint/resume**: each row is appended to ``results.jsonl`` as it
  commits, under a fingerprint of the configuration, the data source,
  the device and this package's name and version (not the scheduler: a
  journal of either mode resumes under the other); a rerun on the same
  output directory resumes the finished rows, and a journal written
  under another fingerprint (another config, device or package, the JAX
  package's included) is set aside as ``*.stale[.N]``;
* **graceful degradation**: under ``fail_policy="degrade"`` a failing row
  becomes a ``status="failed"`` row (error, attempts, seconds), retried
  on resume; ``"raise"`` aborts on the first failure in declared order;
* **shared nuisances**: the logistic propensity, the AIPW outcome model,
  the LASSO fold ids, the LASSO propensity and the RF OOB propensity are
  fitted once, ahead of the first row that needs them, and handed to
  every row that consumes them;
* ``report.json``, ``REPORT.md`` and, with ``plots=True``, the three
  figures.

* **telemetry**: the run is a ``run_sweep`` span, each row a
  ``sweep_stage`` span whose status says computed, resumed or failed;
  with an ``outdir`` the run writes ``metrics.json``, ``events.jsonl``,
  ``metrics.prom``, ``trace.json`` and ``overlap_report.json`` beside
  ``report.json`` (the JAX package's files and schemas; ``ATE_TPU_TRACE=0``
  drops the last two), a failing run included;
* **fault injection**: ``ATE_TPU_CHAOS`` arms the scopes the JAX
  package's sweep honours (``stage:fail=``, ``fs:torn_write``,
  ``tamper:journal``, ``hang:scope=worker``, and ``shard:`` and
  ``device:drop`` in the forests' classified retry); a malformed spec
  raises before any work;
* **device profiling**: ``ATE_TPU_TRACE_DIR`` captures each computed row
  with ``torch.profiler``, ``ATE_TPU_XPROF`` the whole run with a
  ``record_function`` range a row; either runs the sweep sequentially.

Every row runs on one device (``cuda`` unless ``device="cpu"`` is
passed).

CLI::

    python -m ate_replication_causalml_torch.pipeline --out results/ \\
        [--csv socialpresswgeooneperhh_NEIGH.csv] [--quick] [--no-plots] \\
        [--sequential] [--workers N] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import zlib
from typing import Callable, Iterable

import numpy as np
import torch

from ate_replication_causalml_torch import __version__, resolve_device
from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.data.pipeline import (
    PrepConfig,
    inject_bias,
    load_raw_csv,
    prepare_dataset,
)
from ate_replication_causalml_torch.data.synthetic import make_ggl_like
from ate_replication_causalml_torch.estimators.aipw import (
    doubly_robust,
    doubly_robust_glm,
    outcome_model_mu,
)
from ate_replication_causalml_torch.estimators.balance import residual_balance_ate
from ate_replication_causalml_torch.estimators.base import EstimatorResult, ResultTable
from ate_replication_causalml_torch.estimators.belloni import belloni
from ate_replication_causalml_torch.estimators.causal_forest_est import causal_forest_report
from ate_replication_causalml_torch.estimators.dml import double_ml
from ate_replication_causalml_torch.estimators.ipw import (
    logistic_propensity,
    prop_score_ols,
    prop_score_weight,
)
from ate_replication_causalml_torch.estimators.lasso_est import (
    ate_condmean_lasso,
    ate_lasso,
    prop_score_lasso,
)
from ate_replication_causalml_torch.estimators.naive import naive_ate
from ate_replication_causalml_torch.estimators.ols import ate_condmean_ols
from ate_replication_causalml_torch.kernels import build
from ate_replication_causalml_torch.models.forest import rf_oob_propensity
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.observability.trace import run_meta
from ate_replication_causalml_torch.ops.lasso import default_foldid
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.errors import (
    ChaosSpecError,
    ChaosStageFault,
    NonFiniteResult,
)
from ate_replication_causalml_torch.scheduler import (
    ArtifactSpec,
    StageSpec,
    SweepEngine,
    default_workers,
)
from ate_replication_causalml_torch.utils.profiling import (
    StageTimer,
    device_profiling_armed,
    xla_trace,
    xprof_annotation,
    xprof_run,
)
from ate_replication_causalml_torch import viz

PACKAGE = "ate_replication_causalml_torch"

# The sweep's result rows in notebook order (Rmd:128-272); the oracle
# rides separately in ``SweepReport.oracle``.
SWEEP_METHODS = (
    "naive",
    "Direct Method",
    "Propensity_Weighting",
    "Propensity_Regression",
    "Propensity_Weighting_LASSOPS",
    "Single-equation LASSO",
    "Usual LASSO",
    "Doubly Robust with Random Forest PS",
    "Doubly Robust with logistic regression PS",
    "Belloni et.al",
    "Double Machine Learning",
    "residual_balancing",
    "Causal Forest(GRF)",
)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Every constant the notebook hardcodes, in one place (the JAX
    package's fields and defaults). Tree counts are the notebook's
    call-site values (``ate_replication.Rmd:217, 232, 255``); ``quick()``
    scales them down for smoke runs."""

    prep: PrepConfig = PrepConfig()
    synthetic_pool: int = 120_000   # raw rows generated when no CSV is given
    synthetic_seed: int = 0
    true_ate: float = 0.095         # synthetic generator's target (oracle ≈ this)
    dr_trees: int = 2500            # doubly_robust(..., 2500), Rmd:217
    dml_trees: int = 2000           # double_ml(..., num_tree = 2000), Rmd:232
    cf_trees: int = 2000            # grf num.trees, Rmd:255
    cf_nuisance_trees: int = 500
    forest_depth: int = 9
    balance_iters: int = 12_000     # ADMM budget of the balancing QP
    seed: int = 0                   # root of the per-stage keys
    # Taken for the JAX package's sake; the port runs on one device.
    use_mesh: bool = True
    # "degrade" records a failing row as status="failed" and goes on
    # (resume retries it); "raise" aborts on the first failure.
    fail_policy: str = "degrade"

    def quick(self) -> "SweepConfig":
        return dataclasses.replace(
            self,
            prep=dataclasses.replace(self.prep, n_obs=8_000),
            synthetic_pool=20_000,
            dr_trees=250, dml_trees=200, cf_trees=200, cf_nuisance_trees=100,
            forest_depth=7, balance_iters=4_000,
        )


@dataclasses.dataclass
class SweepReport:
    """Everything the notebook run produces."""

    oracle: EstimatorResult
    results: ResultTable
    n_dropped: int
    n_biased: int
    incorrect_cf_ate: float | None = None
    incorrect_cf_se: float | None = None
    timings_s: dict = dataclasses.field(default_factory=dict)
    figure_paths: list = dataclasses.field(default_factory=list)
    #: method -> {"error", "attempts", "seconds"} for degraded rows.
    failures: dict = dataclasses.field(default_factory=dict)
    #: How many rows were computed and how many resumed in this run.
    computed: int = 0
    resumed: int = 0


def _jsonsafe(obj):
    """NaN/Inf → None, recursively: report.json and results.jsonl stay
    valid for strict parsers (the no-SE LASSO rows carry se=NaN)."""
    if isinstance(obj, float):
        return None if not math.isfinite(obj) else obj
    if isinstance(obj, dict):
        return {k: _jsonsafe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonsafe(v) for v in obj]
    return obj


class _Checkpoint:
    """Append-only JSONL of finished result rows, keyed by method name.

    The first record is a config fingerprint; a journal written under
    another fingerprint is set aside (renamed ``*.stale`` / ``*.stale.N``,
    never clobbering an earlier one) instead of being reused. Torn lines
    (a kill mid-append, or chaos ``fs:torn_write``) are skipped, logged
    and counted in ``checkpoint_torn_lines_total``; the row is
    recomputed. The journal stays append-only, so a torn line is counted
    again on every resume of the same directory: the counter reports the
    file's state.
    """

    def __init__(self, path: str | None, fingerprint: str, log=print):
        self.path = path
        self.done: dict[str, dict] = {}
        if path and os.path.exists(path):
            recs = []
            torn = 0
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        recs.append(json.loads(line))
                    except json.JSONDecodeError:
                        torn += 1
                        log(f"checkpoint {path}: skipping unparsable line")
            if torn:
                obs.counter("checkpoint_torn_lines_total",
                            "unparsable results.jsonl lines skipped on resume").inc(torn)
                obs.emit("checkpoint_torn_lines", status="warning", path=path, lines=torn)
            header = next((r for r in recs if r.get("method") == "__config__"), None)
            if header is None or header.get("fingerprint") != fingerprint:
                stale = _unused_stale_path(path)
                os.replace(path, stale)
                log(f"checkpoint {path} was written under a different config; "
                    f"moved to {stale} and starting fresh")
            else:
                self.done = {r["method"]: r for r in recs if r["method"] != "__config__"}
        if path and not self.done and not os.path.exists(path):
            obs.atomic_write_text(path, json.dumps({"method": "__config__",
                                                    "fingerprint": fingerprint}) + "\n")

    def get(self, method: str) -> dict | None:
        return self.done.get(method)

    def put(self, rec: dict) -> None:
        """Append one row (the engine's committer calls this one row at a
        time). Under chaos, ``tamper:journal`` persists a valid line with
        a perturbed ate, or else ``fs:torn_write`` persists the line
        torn, the way a kill mid-append would; the in-memory copy keeps
        this run's rows right either way."""
        rec = _jsonsafe(rec)
        self.done[rec["method"]] = rec
        if self.path:
            line = json.dumps(rec) + "\n"
            inj = chaos.active()
            if inj is not None:
                tampered = inj.tamper_line(line, site=self.path)
                line = inj.torn_line(line, site=self.path) if tampered == line else tampered
            with open(self.path, "a") as f:
                f.write(line)


def _unused_stale_path(path: str) -> str:
    """First free ``path + ".stale"[.N]``: a second config change must not
    clobber the rows set aside by the first."""
    stale = path + ".stale"
    n = 0
    while os.path.exists(stale):
        n += 1
        stale = f"{path}.stale.{n}"
    return stale


#: Keys a checkpoint row must carry to resume.
_REQUIRED_ROW_KEYS = ("method", "ate", "lower_ci", "upper_ci", "se")


def _row_resumable(rec: dict) -> tuple[bool, str]:
    """Whether a checkpoint row can be resumed as it is, else why not
    (missing keys, a non-finite or non-numeric ate, ``status="failed"``):
    such rows are recomputed."""
    for k in _REQUIRED_ROW_KEYS:
        if k not in rec:
            return False, f"missing key {k!r}"
    if rec.get("status", "ok") != "ok":
        return False, f"status={rec.get('status')!r}"
    ate = rec["ate"]
    if isinstance(ate, bool) or not isinstance(ate, (int, float)):
        return False, f"non-numeric ate {ate!r}"
    if not math.isfinite(ate):
        return False, f"non-finite ate {ate!r}"
    return True, ""


def build_frames(
    config: SweepConfig, csv_path: str | None = None, *, device=None
) -> tuple[CausalFrame, CausalFrame, int]:
    """Ingest → prep → bias injection: the notebook's df and df_mod, on
    ``device`` (``cuda`` unless told otherwise)."""
    if csv_path:
        raw = load_raw_csv(csv_path)
    else:
        raw = make_ggl_like(
            config.synthetic_pool, seed=config.synthetic_seed, true_ate=config.true_ate
        )
    df = prepare_dataset(raw, config.prep, device=resolve_device(device))
    df_mod, dropped = inject_bias(df, config.prep)
    return df, df_mod, len(dropped)


def _fingerprint(config: SweepConfig, csv_path: str | None, dev: torch.device) -> str:
    """The journal's header. Resume is valid only for the same config,
    data source, device type and package version: another device gives
    other float bits, and the JAX package's journal is never resumed as
    this package's rows."""
    return (f"{config!r}|csv={csv_path or 'synthetic'}|device={dev.type}"
            f"|package={PACKAGE}|version={__version__}")


def _resolve_scheduler(scheduler: str | None, workers: int | None,
                       log: Callable[[str], None] = print) -> int:
    """Worker-pool width from the scheduler mode and the env knobs
    (``ATE_TPU_SWEEP_SEQUENTIAL``, ``ATE_TPU_SWEEP_WORKERS``). The mode
    is not part of the journal's fingerprint: the concurrent and the
    sequential sweep give the same bits, so either resumes the other's
    journal. A device capture (``ATE_TPU_TRACE_DIR``, ``ATE_TPU_XPROF``)
    forces the sequential sweep: ``torch.profiler`` is process-global,
    and concurrent rows would interleave in one timeline. The host trace
    (``trace.json``) needs no profiler and stays concurrent."""
    mode = scheduler
    if mode is None:
        mode = ("sequential"
                if os.environ.get("ATE_TPU_SWEEP_SEQUENTIAL", "").strip().lower()
                in ("1", "true", "yes", "on") else "concurrent")
    if mode not in ("sequential", "concurrent"):
        raise ValueError(f"scheduler must be 'sequential' or 'concurrent', got {mode!r}")
    if mode == "concurrent" and device_profiling_armed():
        log("device profiling armed (ATE_TPU_TRACE_DIR/ATE_TPU_XPROF): forcing the sequential "
            "sweep; host-span tracing alone does not require this")
        mode = "sequential"
    if mode == "sequential":
        return 1
    # Clamp like default_workers clamps the env var: --workers 0 must not
    # reach the engine as a zero-thread pool.
    return default_workers() if workers is None else max(1, workers)


def _nan_or(v):
    return float("nan") if v is None else v


@dataclasses.dataclass
class _StageOutcome:
    """What a stage body hands the ordered committer: the row plus what
    the commit journals and logs in declared order (bodies may finish in
    any order; side effects are the committer's)."""

    kind: str                   # "resumed" | "computed" | "failed"
    res: EstimatorResult
    record: dict | None = None  # checkpoint row (computed/failed)
    extras: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    retry_why: str = ""         # why a journaled row was not resumable
    error: str = ""
    attempts: int = 0


def run_sweep(
    config: SweepConfig = SweepConfig(),
    csv_path: str | None = None,
    outdir: str | None = None,
    plots: bool = True,
    log: Callable[[str], None] = print,
    scheduler: str | None = None,
    workers: int | None = None,
    prefetch: bool | None = None,
    *,
    device=None,
) -> SweepReport:
    """The full notebook run, checkpointed and timed, on ``device``
    (``cuda`` unless ``device="cpu"``).

    ``scheduler`` is "concurrent" (the default: a pool of worker threads
    over the DAG of stages and shared nuisances, one CUDA stream a worker
    on the card; ``scheduler/engine.py``) or "sequential" (inline on the
    calling thread and its stream); ``ATE_TPU_SWEEP_SEQUENTIAL=1`` picks
    the latter when ``scheduler`` is None, and so does a device capture
    (``ATE_TPU_TRACE_DIR``, ``ATE_TPU_XPROF``). ``workers`` bounds the
    pool (default ``ATE_TPU_SWEEP_WORKERS`` or ``min(4, cpus)``; 1 runs
    inline). ``prefetch`` overrides the kernel-build prefetch lane's
    default (on for the card). Both modes give the same rows bit for bit
    and write the same journal lines in the same order.

    Each stage's key is ``fold_in(key(config.seed), crc32(name))``, so a
    resumed run gives the remaining rows the keys a fresh run would.
    ``report.timings_s`` holds each computed row's wall seconds, and each
    shared nuisance's under ``artifact:<name>`` (fitted ahead of its
    first consumer, outside that row's time).

    Telemetry: the run is a ``run_sweep`` span, each row a
    ``sweep_stage`` span with status computed, resumed or failed. With
    an ``outdir``, ``metrics.json``, ``events.jsonl`` and ``metrics.prom``
    land beside ``report.json``, and (unless ``ATE_TPU_TRACE=0``)
    ``trace.json`` (worker, lane, prefetch and committer tracks,
    artifact-to-stage flow arrows, counter tracks) and
    ``overlap_report.json`` (critical path, per-lane busy and wait,
    overlap). They are written when the run fails too, and an export
    error never replaces the run's own exception."""
    obs.install_monitoring()
    n_workers = _resolve_scheduler(scheduler, workers, log)
    dev = resolve_device(device)
    if plots and outdir:
        viz.require_matplotlib()
    # The event log is process-global: the trace keeps the records from
    # this instant on.
    t_start = time.monotonic()
    sampler = None
    if outdir and n_workers > 1 and obs.trace_enabled():
        # Counter tracks for the trace. A thread only for a concurrent
        # run: the sequential sweep takes one inline sample at the end.
        sampler = obs.MetricSampler()
        sampler.start()
    try:
        with obs.span("run_sweep", out=outdir or "", csv=csv_path or "synthetic") as root_sp:
            return _run_sweep_impl(config, csv_path, outdir, plots, log, dev, n_workers,
                                   prefetch, root_sp.span_id)
    finally:
        if outdir:
            _export_telemetry(outdir, t_start, n_workers, csv_path, sampler, log)
        elif sampler is not None:
            sampler.stop()


def _export_telemetry(outdir: str, t_start: float, workers: int, csv_path: str | None,
                      sampler, log) -> None:
    """The device-memory gauges, the sampler's last sample, then the
    exporters, each step guarded: the sampler must stop whatever an
    earlier step raised, and a failing export is logged, never raised
    over the run's own exception (a full disk, a deleted outdir)."""
    try:
        obs.record_device_memory(context="run_sweep")
    except Exception as e:  # noqa: BLE001 — an observer must not replace the run's error
        log(f"telemetry export failed: {e!r}")
    if sampler is not None:
        sampler.stop()
    elif obs.trace_enabled():
        sampler = obs.MetricSampler()
        sampler.sample_once()
    try:
        written = obs.write_run_artifacts(outdir)
        written += _write_trace_artifacts(outdir, t_start, workers, csv_path, sampler)
        log(f"telemetry: {', '.join(written)}")
    except Exception as e:  # noqa: BLE001 — as above
        log(f"telemetry export failed: {e!r}")


def _write_trace_artifacts(outdir: str, t_start: float, workers: int, csv_path: str | None,
                           sampler) -> list[str]:
    """``trace.json`` and ``overlap_report.json`` of this run's records
    (the event log filtered to its monotonic window); the run's wall
    seconds, worker count and the sampler's ticks and period ride the
    trace header. Nothing when ``ATE_TPU_TRACE=0``."""
    if not obs.trace_enabled():
        return []
    records = [r for r in obs.EVENTS.records() if r.get("start_mono_s", 0.0) >= t_start - 1e-6]
    run_rec = next((r for r in records if r["name"] == "run_sweep"), None)
    tr = obs.build_trace(records, meta=run_meta(
        workers=workers, wall_s=run_rec["dur_s"] if run_rec else None, out=outdir,
        csv=csv_path or "synthetic", events_dropped=obs.EVENTS.dropped,
        sampler_ticks=sampler.ticks,
        sampler_interval_s=sampler.interval_s if workers > 1 else None))
    return obs.write_trace_artifacts(outdir, tr)


def _run_sweep_impl(config: SweepConfig, csv_path: str | None, outdir: str | None, plots: bool,
                    log: Callable[[str], None], dev: torch.device, n_workers: int,
                    prefetch: bool | None, root_span_id: str) -> SweepReport:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    # Arm chaos now, with fresh fault budgets for this run: a malformed
    # ATE_TPU_CHAOS raises ChaosSpecError here, before any work.
    chaos.reset()
    chaos.active()
    fingerprint = _fingerprint(config, csv_path, dev)
    ckpt = _Checkpoint(os.path.join(outdir, "results.jsonl") if outdir else None, fingerprint,
                       log=log)

    df, df_mod, n_dropped = build_frames(config, csv_path, device=dev)
    log(f"prepared df n={df.n}, dropped {n_dropped} -> df_mod n={df_mod.n} on {dev.type}")
    timer = StageTimer()
    report = SweepReport(oracle=None, results=ResultTable(), n_dropped=n_dropped,
                         n_biased=df_mod.n)
    timings = report.timings_s
    root_key = rnd.key(config.seed, device=dev)

    def key_for(name: str) -> torch.Tensor:
        return rnd.fold_in(root_key, zlib.crc32(name.encode()))

    def sync():
        """Wait for this thread's current stream, the stage's own: a
        device-wide sync would also wait for every other worker's work
        and charge it to this row's seconds."""
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    # The kernel build is the prefetch lane's one item (scheduler/prefetch.py),
    # carried by lasso_ps: a kernel node that waits on a need, so the lane
    # reaches it before a worker can take it. Where that row is resumed
    # there is no item, and the first kernel call builds. The CPU runs the
    # plain versions and builds nothing.
    warm = build.build_all if dev.type == "cuda" else None

    def artifact(name, fit, needs=(), warm=None):
        def timed(c):
            t0 = time.perf_counter()
            value = fit(c)
            sync()
            timings[f"artifact:{name}"] = time.perf_counter() - t0
            return value

        return ArtifactSpec(name, fit=timed, needs=needs, key=(fingerprint,),
                            warm=warm)

    artifacts = [
        artifact("p_logistic", lambda c: logistic_propensity(df_mod.x, df_mod.w)),
        artifact("outcome_mu", lambda c: outcome_model_mu(df_mod)),
        artifact("folds:ps_lasso", lambda c: default_foldid(key_for("ps_lasso"), df_mod.n)),
        artifact("folds:seq_lasso", lambda c: default_foldid(key_for("seq_lasso"), df_mod.n)),
        artifact("folds:usual_lasso", lambda c: default_foldid(key_for("usual_lasso"), df_mod.n)),
        artifact("lasso_ps", lambda c: prop_score_lasso(df_mod, foldid=c.get("folds:ps_lasso")),
                 needs=("folds:ps_lasso",), warm=warm),
        artifact("rf_oob_propensity", lambda c: rf_oob_propensity(
            df_mod, key=key_for("dr_rf_prop"), n_trees=config.dr_trees,
            depth=config.forest_depth)),
    ]

    def cf_row(c):
        cf = causal_forest_report(df_mod, key=key_for("causal_forest"), n_trees=config.cf_trees,
                                  nuisance_trees=config.cf_nuisance_trees)
        return cf.result, {"incorrect_ate": cf.incorrect_ate, "incorrect_se": cf.incorrect_se}

    # (method, body, the artifacts it consumes)
    stage_decls: list[tuple[str, Callable[[object], object], tuple[str, ...]]] = [
        ("oracle", lambda c: naive_ate(df, method="oracle"), ()),
        ("naive", lambda c: naive_ate(df_mod), ()),
        ("Direct Method", lambda c: ate_condmean_ols(df_mod), ()),
        ("Propensity_Weighting", lambda c: prop_score_weight(df_mod, c.get("p_logistic")),
         ("p_logistic",)),
        ("Propensity_Regression", lambda c: prop_score_ols(df_mod, c.get("p_logistic")),
         ("p_logistic",)),
        ("Propensity_Weighting_LASSOPS",
         lambda c: prop_score_weight(df_mod, c.get("lasso_ps"),
                                     method="Propensity_Weighting_LASSOPS"),
         ("lasso_ps",)),
        ("Single-equation LASSO",
         lambda c: ate_condmean_lasso(df_mod, foldid=c.get("folds:seq_lasso")),
         ("folds:seq_lasso",)),
        ("Usual LASSO", lambda c: ate_lasso(df_mod, foldid=c.get("folds:usual_lasso")),
         ("folds:usual_lasso",)),
        ("Doubly Robust with Random Forest PS",
         lambda c: doubly_robust(df_mod, lambda f: c.get("rf_oob_propensity"),
                                 key=key_for("dr_rf"), mu=c.get("outcome_mu")),
         ("rf_oob_propensity", "outcome_mu")),
        ("Doubly Robust with logistic regression PS",
         lambda c: doubly_robust_glm(df_mod, key=key_for("dr_glm"), p=c.get("p_logistic"),
                                     mu=c.get("outcome_mu")),
         ("p_logistic", "outcome_mu")),
        ("Belloni et.al", lambda c: belloni(df_mod, key=key_for("belloni")), ()),
        ("Double Machine Learning",
         lambda c: double_ml(df_mod, n_trees=config.dml_trees, depth=config.forest_depth,
                             key=key_for("dml"), device=dev), ()),
        ("residual_balancing",
         lambda c: residual_balance_ate(df_mod, key=key_for("balance"),
                                        max_iters=config.balance_iters), ()),
        # The result row plus the notebook's deliberately "incorrect"
        # aggregate (Rmd:258-262), carried in the checkpoint record.
        ("Causal Forest(GRF)", cf_row, ()),
    ]
    assert [m for m, _, _ in stage_decls[1:]] == list(SWEEP_METHODS)

    stage_c = obs.counter("sweep_stage_total", "sweep stages by resume-vs-computed status")
    # Chaos stage faults are planned in declared order before any worker
    # starts (the ``times`` budget is order-sensitive, and worker
    # completion order must not decide which rows it selects); the
    # injection is recorded when the fault is raised.
    fault_plan: set[str] = set()

    def make_stage(method, fn, needs) -> tuple[StageSpec, bool]:
        """One row as a scheduler stage, and whether it is resumed.
        Resume is decided here, at build time, from the loaded journal: a
        resumed stage declares no needs, so a fully journaled rerun fits
        no nuisance at all. A body returns a :class:`_StageOutcome`; only
        the committer journals and logs. Under "degrade" an exception (or
        a non-finite ATE) becomes a ``status="failed"`` outcome; ^C and a
        malformed chaos spec always propagate."""
        cached = ckpt.get(method)
        ok, why = _row_resumable(cached) if cached is not None else (False, "")
        if ok:
            res = EstimatorResult(method=cached["method"], ate=cached["ate"],
                                  lower_ci=_nan_or(cached["lower_ci"]),
                                  upper_ci=_nan_or(cached["upper_ci"]), se=_nan_or(cached["se"]))
            outcome = _StageOutcome("resumed", res, seconds=cached.get("seconds", 0.0))

            def run_resumed(c):
                with obs.span("sweep_stage", parent_id=root_span_id, method=method) as sp:
                    sp.set_status("resumed")
                    return outcome

            return StageSpec(method, run_resumed), True
        prior = cached.get("attempts") if cached else 0
        attempts = (int(prior) + 1
                    if isinstance(prior, (int, float)) and not isinstance(prior, bool) else 1)

        def run(c):
            with obs.span("sweep_stage", parent_id=root_span_id, method=method) as sp:
                if why:
                    obs.emit("checkpoint_row_rejected", status="retrying", method=method,
                             reason=why)
                sp.set_status("computed")
                try:
                    # The capture opens first, so the row's seconds exclude
                    # the profiler's start and its trace export.
                    with xla_trace(method), xprof_annotation(method), timer.stage(method):
                        if method in fault_plan:
                            chaos.active().record_stage_fault(method)
                            raise ChaosStageFault(f"chaos: injected stage fault on {method!r}")
                        out = fn(c)
                        sync()
                    res, extras = out if isinstance(out, tuple) else (out, {})
                    if not math.isfinite(res.ate):
                        raise NonFiniteResult(f"estimator returned ATE {res.ate!r} from finite "
                                              "inputs; refusing to record it")
                except (KeyboardInterrupt, SystemExit, ChaosSpecError):
                    raise
                except Exception as e:
                    if config.fail_policy != "degrade":
                        raise
                    dt = timer.seconds.get(method, 0.0)
                    err = f"{type(e).__name__}: {e}"
                    sp.set_status("failed")
                    sp.set_attr("error", err)
                    obs.emit("sweep_stage_failed", status="error", method=method, error=err,
                             attempts=attempts)
                    nan = float("nan")
                    res = EstimatorResult(method=method, ate=nan, lower_ci=nan, upper_ci=nan,
                                          se=nan, status="failed")
                    return _StageOutcome("failed", res, seconds=dt, retry_why=why, error=err,
                                         attempts=attempts,
                                         record=dict(res.to_dict(), error=err, attempts=attempts,
                                                     seconds=round(dt, 3)))
                dt = timer.seconds[method]
                sp.set_attr("seconds", round(dt, 3))
                return _StageOutcome("computed", res, extras=extras, seconds=dt, retry_why=why,
                                     attempts=attempts,
                                     record=dict(res.to_dict(), seconds=round(dt, 3),
                                                 attempts=attempts, **extras))

        return StageSpec(method, run, needs=needs), False

    def commit(spec: StageSpec, outcome: _StageOutcome) -> None:
        """Declared-order side effects: the journal append, the report's
        counts and timings, the stage counter, the log lines. The engine
        runs commits in stage order, one at a time, so ``results.jsonl``
        holds the lines a sequential sweep writes, in the same order."""
        method, res = spec.name, outcome.res
        if outcome.retry_why:
            log(f"  [retry] {method}: checkpoint row not resumable ({outcome.retry_why}); "
                "recomputing")
        stage_c.inc(1, method=method, status=outcome.kind)
        if outcome.kind == "resumed":
            report.resumed += 1
            timings[method] = outcome.seconds
            log(f"  [resume] {method}: ate={res.ate:.4f}")
            return
        report.computed += 1
        ckpt.put(outcome.record)
        if outcome.kind == "failed":
            report.failures[method] = {"error": outcome.error, "attempts": outcome.attempts,
                                       "seconds": round(outcome.seconds, 3)}
            log(f"  [FAILED] {method}: {outcome.error} (attempt {outcome.attempts}, "
                f"{outcome.seconds:.1f}s); degrading, sweep continues")
            return
        timings[method] = outcome.seconds
        if "incorrect_ate" in outcome.extras:
            log(f"  Incorrect ATE: {outcome.extras['incorrect_ate']:.3f} "
                f"(SE: {outcome.extras['incorrect_se']:.3f})"
                "  [deliberate negative example, Rmd:262]")
        log(f"  {method}: ate={res.ate:.4f} ci=[{res.lower_ci:.4f},{res.upper_ci:.4f}] "
            f"({outcome.seconds:.1f}s)")

    built = [make_stage(*decl) for decl in stage_decls]
    stages = [spec for spec, _ in built]
    inj = chaos.active()
    if inj is not None:
        fault_plan.update(inj.plan_stage_faults([spec.name for spec, resumed in built
                                                 if not resumed]))
    engine = SweepEngine(artifacts, stages, commit=commit, workers=n_workers, prefetch=prefetch,
                         device=dev, span_parent=root_span_id)
    if n_workers > 1:
        log(f"scheduler: concurrent sweep, {n_workers} workers"
            + (", kernel-build prefetch on" if engine.prefetch else ""))
    # One whole-run device capture under ATE_TPU_XPROF (a no-op without).
    with xprof_run("run_sweep"):
        outcomes = engine.run()

    report.oracle = outcomes["oracle"].res
    for m in SWEEP_METHODS:
        report.results.append(outcomes[m].res)
    cf_rec = ckpt.get("Causal Forest(GRF)") or {}
    report.incorrect_cf_ate = cf_rec.get("incorrect_ate")
    report.incorrect_cf_se = cf_rec.get("incorrect_se")

    if outdir:
        obs.atomic_write_json(os.path.join(outdir, "report.json"), _jsonsafe({
            "oracle": report.oracle.to_dict(),
            "results": [r.to_dict() for r in report.results],
            "n_dropped": report.n_dropped,
            "n_biased": report.n_biased,
            "incorrect_cf": [report.incorrect_cf_ate, report.incorrect_cf_se],
            "timings_s": {k: round(v, 3) for k, v in report.timings_s.items()},
            "failures": report.failures,
            "device": dev.type,
        }))
    if plots and outdir:
        # A degraded oracle cannot anchor the reference band.
        oracle_fig = report.oracle if math.isfinite(report.oracle.ate) else None
        report.figure_paths = viz.notebook_figures(report.results, oracle_fig, outdir)
        log(f"figures: {report.figure_paths}")
    if outdir:
        log(f"report: {write_report_md(report, outdir, csv_path=csv_path)}")
    return report


def write_report_md(report: SweepReport, outdir: str, csv_path: str | None = None) -> str:
    """Render ``REPORT.md``, mirroring ``ate_replication.md`` section by
    section: data prep counts, RCT oracle against naive, the estimator
    comparison, the deliberate 'Incorrect ATE' line
    (``ate_replication.md:294``) and the figures inline."""
    fmt = lambda v: "—" if v is None or (isinstance(v, float) and not np.isfinite(v)) else f"{v:.4f}"
    o = report.oracle
    lines = [
        "# ATE replication — PyTorch/CUDA port run",
        "",
        "Rendered by `ate_replication_causalml_torch.pipeline` (the "
        "`ate_replication.md` equivalent; reference sections cited inline).",
        "",
        "## Data",
        "",
        f"* Source: `{csv_path}`" if csv_path else
        "* Source: synthetic GGL-like generator (real CSV unavailable — "
        "see RESULTS.md 'Real-dataset attempt')",
        f"* Rows after prep (sampled, scaled, na.omit): {report.n_dropped + report.n_biased}",
        "* Bias injection (`ate_replication.Rmd:97-123`) dropped:",
        "",
        "```",
        f"## [1] {report.n_dropped}",
        "```",
        "",
        "  (reference on the real data: `## [1] 41062`, `ate_replication.md:118`)",
        f"* Biased sample `df_mod`: {report.n_biased} rows",
        "",
        "## RCT oracle vs naive on the biased sample",
        "",
        "| Method | ATE | 95% CI |",
        "|---|---|---|",
        f"| RCT (oracle) | {fmt(o.ate)} | [{fmt(o.lower_ci)}, {fmt(o.upper_ci)}] |",
    ]
    naive = next((r for r in report.results if r.method == "naive"), None)
    if naive is not None:
        lines.append(f"| naive (biased) | {fmt(naive.ate)} | "
                     f"[{fmt(naive.lower_ci)}, {fmt(naive.upper_ci)}] |")
    lines += [
        "",
        "The naive estimate on the biased sample is far from the RCT answer — "
        "the injected selection bias every estimator below must remove "
        "(`ate_replication.md:157`).",
        "",
    ]
    figs = [os.path.basename(p) for p in report.figure_paths]
    if len(figs) >= 1:
        lines += [f"![oracle vs naive]({figs[0]})", ""]
    lines += [
        "## Estimator comparison (notebook order, `Rmd:128-272`)",
        "",
        "| Method | ATE | 95% CI | seconds |",
        "|---|---|---|---|",
    ]
    for r in report.results:
        if r.status != "ok":
            lines.append(f"| {r.method} | ✗ failed | — | — |")
            continue
        secs = report.timings_s.get(r.method)
        lines.append(f"| {r.method} | {fmt(r.ate)} | [{fmt(r.lower_ci)}, {fmt(r.upper_ci)}] | "
                     + (f"{secs:.1f} |" if secs is not None else "— |"))
    if report.failures:
        lines += [
            "",
            "### Degraded stages",
            "",
            "The sweep recorded these estimators as failed and carried on; "
            "re-running with the same output directory retries exactly these rows:",
            "",
            "| Method | error | attempts |",
            "|---|---|---|",
        ]
        # Exception text can carry '|' or backticks: escape both.
        esc = lambda s: str(s).replace("|", "\\|").replace("`", "'")
        for m, f in report.failures.items():
            lines.append(f"| {m} | `{esc(f.get('error', '?'))}` | {f.get('attempts', '?')} |")
    if len(figs) >= 2:
        lines += ["", f"![regression methods]({figs[1]})"]
    lines += [
        "",
        "## Causal forest: the deliberate negative example",
        "",
        "The mean of CATE predictions with SE = sqrt(mean per-point variance) is the WRONG "
        "way to aggregate (`ate_replication.Rmd:258-262`; printed as "
        "`Incorrect ATE: 0.083 (SE: 0.198)` on the real data, `ate_replication.md:294`):",
        "",
        "```",
    ]
    if report.incorrect_cf_ate is not None:
        lines.append(f"## Incorrect ATE: {report.incorrect_cf_ate:.3f} "
                     f"(SE: {report.incorrect_cf_se:.3f})")
    lines += [
        "```",
        "",
        "The correct doubly-robust aggregation (`grf::estimate_average_effect` equivalent) "
        "is the `Causal Forest(GRF)` row above.",
        "",
    ]
    if len(figs) >= 3:
        lines += [f"![causal ML methods]({figs[2]})", ""]
    path = os.path.join(outdir, "REPORT.md")
    obs.atomic_write_text(path, "\n".join(lines))
    return path


def main(argv: Iterable[str] | None = None) -> SweepReport:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results", help="output directory")
    ap.add_argument("--csv", default=None,
                    help="path to socialpresswgeooneperhh_NEIGH.csv (else synthetic)")
    ap.add_argument("--quick", action="store_true", help="small smoke-run sizes")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--sequential", action="store_true",
                    help="single-threaded sweep on the current stream (bit-identical to the "
                         "concurrent default)")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker-pool width of the concurrent sweep "
                         "(default: ATE_TPU_SWEEP_WORKERS or min(4, cpus))")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv if argv is None else list(argv))

    config = SweepConfig()
    if args.quick:
        config = config.quick()
    report = run_sweep(config, csv_path=args.csv, outdir=args.out, plots=not args.no_plots,
                       scheduler="sequential" if args.sequential else None, workers=args.workers,
                       device=args.device)
    print(repr(report.results))
    return report


if __name__ == "__main__":
    main()
