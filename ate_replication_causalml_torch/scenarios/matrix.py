"""Monte-Carlo scenario-matrix runner.

Port of ``ate_replication_causalml_tpu/scenarios/matrix.py``. A (DGP ×
estimator × seed) cell grid runs through the port's
:class:`~..scheduler.SweepEngine`: each scenario COLUMN contributes one
artifact (``exe:{column}``, the column's batched callable from
``scenarios/batched.py``) and one stage per packed replicate batch;
commit order is declaration order, so ``cells.jsonl`` is deterministic
whatever the worker pool does. It runs on ``cuda`` unless the caller
passes ``device="cpu"``.

Contracts, the JAX package's:

* **one callable a column**, made once per column cache key and shared
  by every batch; the port compiles nothing, so its compile events (the
  kernel builds and graph captures, ``batched.compile_event_count``) are
  0 once the kernels are built;
* **degrade-don't-abort** — a failed batch (a CUDA error too) becomes
  failed rows (rows mode) or a failed block (aggregate mode) for exactly
  its cells, and the matrix goes on; ``fail_policy="raise"`` aborts. A
  failure is never rerun on the CPU or in a plain version;
* **checkpoint/resume** through the pipeline's ``_Checkpoint`` journal
  (fingerprint header, torn-line tolerance, ``.stale`` set-aside): a
  resumed run packs only the missing replicates, and a complete column
  declares no artifact need, so it builds and launches nothing;
* **streaming aggregates by default**: each batch runs the column's
  ``aggregate_executable`` and journals one block record (merged stats
  and the packed rep list); the fingerprint gains ``|mode=
  scenarios-agg-v1`` and the block scan asserts every record's schema
  tag (a lying header sets the journal aside too);
* **rows mode** (``ATE_TPU_SCENARIO_ROWS=1`` or ``MatrixSpec(rows=
  True)``): one journal record and one host row per cell;
* **extend-reps resume** in both modes (the replicate count stays out of
  the fingerprint); blocks pack rep-contiguous chunks of the declared
  width, so an extension reduces the segments a straight run would.

The fingerprints and schema tags are the JAX package's, so the journal
header of a spec is the JAX package's byte for byte.
``ATE_TPU_SCENARIO_SHARD`` (or ``MatrixSpec(shard=True)``) shards the
replicate axis over the ranks of a multi-GPU world, as the JAX package
shards it over its devices: batch widths pad to the rank count
(``plan_columns(devices=A)``), each batch's cell ids are committed
row-sharded over a ``data`` mesh through the metered artifact plane
(``host_upload``), every rank computes its block of lanes, the lanes
are gathered in lane order, and the fixed-order aggregates are taken
over the gathered lanes, so a sharded column equals the unsharded one.
Rank 0 alone writes the journal and the exports; every rank returns the
same report. On a world of one rank the knob changes nothing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.observability.sketch import (
    CalibrationSketch,
    FixedBinSketch,
)
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.parallel.mesh import barrier, is_writer
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.errors import ChaosStageFault
from ate_replication_causalml_torch.scenarios.aggregate import (
    AGG_SCHEMA_TAG,
    ERROR_SKETCH_BINS,
    ERROR_SKETCH_RANGE,
    N_STATS,
    Z95,
    AggState,
    aggregate_executable,
    fold_rows,
)
from ate_replication_causalml_torch.scenarios.batched import (
    SCENARIO_ESTIMATORS,
    SCHEMA_TAG,
    batch_mask,
    cached_executable,
    column_cache_key,
    column_executable,
    compile_event_count,
    generate_cell,
    pad_ids,
    scalar_executable,
)
from ate_replication_causalml_torch.scenarios.dgp import (
    STOCK_DGPS,
    DGPSpec,
    data_cell_id,
    estimator_salt,
)

_BATCH_ENV = "ATE_TPU_SCENARIO_BATCH"
_REPS_ENV = "ATE_TPU_SCENARIO_REPS"
_SHARD_ENV = "ATE_TPU_SCENARIO_SHARD"
_ROWS_ENV = "ATE_TPU_SCENARIO_ROWS"

_Z95 = Z95


def _env_int(name: str, default: int) -> int:
    """Bad values raise at config time: a typo'd knob must not silently
    run a long grid at the default scale."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a positive integer") from None
    if value < 1:
        raise ValueError(f"{name}={value}: expected a positive integer")
    return value


def default_batch_width() -> int:
    return _env_int(_BATCH_ENV, 32)


def default_reps() -> int:
    return _env_int(_REPS_ENV, 64)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


def _env_shard() -> bool:
    return _env_flag(_SHARD_ENV)


def _env_rows() -> bool:
    return _env_flag(_ROWS_ENV)


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """One scenario matrix: the DGP grid, the estimator set, and the
    replicate and batching policy. ``shard=None`` defers to
    ``ATE_TPU_SCENARIO_SHARD``; ``rows=None`` to ``ATE_TPU_SCENARIO_ROWS``
    (streaming aggregates by default)."""

    dgps: tuple[DGPSpec, ...]
    estimators: tuple[str, ...]
    n_reps: int = 64
    batch_width: int = 32
    seed: int = 0
    fail_policy: str = "degrade"
    shard: bool | None = None
    rows: bool | None = None

    def __post_init__(self) -> None:
        if self.fail_policy not in ("degrade", "raise"):
            raise ValueError(
                f"fail_policy must be 'degrade' or 'raise', got {self.fail_policy!r}")
        for name in self.estimators:
            if name not in SCENARIO_ESTIMATORS:
                raise ValueError(
                    f"unknown scenario estimator {name!r}; known: {sorted(SCENARIO_ESTIMATORS)}")
        # Names are the column/journal/cell-id namespace: duplicates would
        # collide on journal keys and merge their aggregates.
        dgp_names = [d.name for d in self.dgps]
        for seq, what in ((dgp_names, "DGP"), (self.estimators, "estimator")):
            dupes = {x for x in seq if list(seq).count(x) > 1}
            if dupes:
                raise ValueError(f"duplicate {what} name(s) in MatrixSpec: {sorted(dupes)}")

    def resolved_rows(self) -> bool:
        """Whether this run journals per-cell rows or streaming blocks."""
        return _env_rows() if self.rows is None else bool(self.rows)

    def fingerprint(self) -> str:
        """Resume validity (the JAX package's string): DGP field tuples,
        estimator set, seed, schema tag. Replicate count and batch width
        are absent (extend-reps resume; widths interchangeable over one
        journal); aggregate mode appends its own tag, so a rows journal
        and a block journal never resume each other."""
        dgps = ";".join(repr(d.fields()) for d in self.dgps)
        fp = f"{SCHEMA_TAG}|dgps=[{dgps}]|est={list(self.estimators)!r}|seed={self.seed}"
        if not self.resolved_rows():
            fp += f"|mode={AGG_SCHEMA_TAG}"
        return fp


def micro_matrix_spec(n_reps: int | None = None, batch_width: int | None = None,
                      n: int = 384, seed: int = 0, rows: bool | None = None) -> MatrixSpec:
    """The canonical micro matrix (2 DGPs × 3 estimators): the
    calibration design and the heterogeneous confounded design through
    the three vmapped GLM-class estimators."""
    calib = dataclasses.replace(STOCK_DGPS["calibration"], n=n)
    hetero = dataclasses.replace(STOCK_DGPS["hetero_confounded"], n=n)
    return MatrixSpec(
        dgps=(calib, hetero),
        estimators=("naive", "ipw_logit", "aipw_logit"),
        n_reps=default_reps() if n_reps is None else n_reps,
        batch_width=default_batch_width() if batch_width is None else batch_width,
        seed=seed,
        rows=rows,
    )


def column_name(dgp: DGPSpec, estimator: str) -> str:
    return f"{dgp.name}:{estimator}"


def cell_row_id(dgp_name: str, estimator: str, rep: int) -> str:
    """The journal key of one cell (the ``method`` field)."""
    return f"{dgp_name}:{estimator}:{rep}"


def block_row_id(column: str, batch: tuple[int, ...]) -> str:
    """The journal key of one streaming block."""
    return f"agg:{column}:r{batch[0]}-{batch[-1]}"


@dataclasses.dataclass(frozen=True)
class ColumnPlan:
    """One scheduled column: the replicates still to compute and their
    fixed-width batches (the last pads to the width)."""

    name: str
    dgp: DGPSpec
    estimator: str
    width: int
    mode: str                      # "vmapped" | "sequential"
    remaining: tuple[int, ...]
    batches: tuple[tuple[int, ...], ...]


def _resolve_shard(spec: MatrixSpec) -> int:
    """The ranks the replicate axis shards over: the world's size when
    ``ATE_TPU_SCENARIO_SHARD`` (or ``spec.shard``) asks for it and the
    world has more than one rank, else 1 (the knob changes nothing)."""
    from ate_replication_causalml_torch.parallel.mesh import world_size

    shard = _env_shard() if spec.shard is None else spec.shard
    return world_size() if shard and world_size() > 1 else 1


def plan_columns(spec: MatrixSpec, done: Callable[[str], bool] = lambda _cell: False,
                 devices: int = 1) -> tuple[list[ColumnPlan], list[str]]:
    """Pure cell-batching planner: pack each column's not-yet-done
    replicates into fixed-width batches; non-vmappable engines pack at
    width 1. Sharded runs (the shard knob and ``devices`` > 1) pad the
    width up to a multiple of ``devices``. Returns ``(plans, skipped)``,
    ``skipped`` the (DGP, estimator) columns the estimator declared
    inapplicable."""
    plans: list[ColumnPlan] = []
    skipped: list[str] = []
    shard = _env_shard() if spec.shard is None else spec.shard
    for dgp in spec.dgps:
        for est_name in spec.estimators:
            est = SCENARIO_ESTIMATORS[est_name]
            col = column_name(dgp, est_name)
            if not est.applicable(dgp):
                skipped.append(col)
                continue
            width = min(spec.batch_width, spec.n_reps) if est.vmapped else 1
            if shard and est.vmapped and devices > 1:
                from ate_replication_causalml_torch.parallel.shardio import pad_to_multiple

                width = pad_to_multiple(width, devices)
            remaining = tuple(r for r in range(spec.n_reps)
                              if not done(cell_row_id(dgp.name, est_name, r)))
            batches = tuple(remaining[i:i + width] for i in range(0, len(remaining), width))
            plans.append(ColumnPlan(
                name=col, dgp=dgp, estimator=est_name, width=width,
                mode="vmapped" if est.vmapped else "sequential",
                remaining=remaining, batches=batches,
            ))
    return plans, skipped


# ── aggregates ────────────────────────────────────────────────────────


def column_aggregates(rows: Iterable[dict], nominal: float = 0.95) -> dict:
    """Per-column Monte-Carlo summaries from cell rows (pure, host-side):
    coverage of the per-replicate truth by the 95% CI, bias and RMSE of
    the point estimate, power of the |ate|/se > z test, the binomial MC
    standard errors, and the mergeable error and coverage sketches.
    Failed cells count into ``n_failed`` and nothing else; no-SE
    estimators report ``coverage=None``/``power=None``."""
    rows = list(rows)
    ok = [r for r in rows
          if r.get("status", "ok") == "ok" and isinstance(r.get("ate"), (int, float))
          and math.isfinite(r["ate"])]
    with_se = [r for r in ok if isinstance(r.get("se"), (int, float)) and math.isfinite(r["se"])]
    out: dict = {
        "n_cells": len(rows),
        "n_ok": len(ok),
        "n_failed": len(rows) - len(ok),
        "coverage": None,
        "power": None,
        "bias": None,
        "rmse": None,
        "coverage_mc_se": None,
        "nominal": nominal,
    }
    if ok:
        errs = [r["ate"] - r["tau_true"] for r in ok]
        out["bias"] = sum(errs) / len(errs)
        out["rmse"] = math.sqrt(sum(e * e for e in errs) / len(errs))
        out["mean_tau_true"] = sum(r["tau_true"] for r in ok) / len(ok)
    if with_se:
        covered = sum(1 for r in with_se if r["lower_ci"] <= r["tau_true"] <= r["upper_ci"])
        rejected = sum(1 for r in with_se if abs(r["ate"]) > _Z95 * r["se"])
        n = len(with_se)
        out["coverage"] = covered / n
        out["power"] = rejected / n
        # Binomial MC standard error at the NOMINAL rate.
        out["coverage_mc_se"] = math.sqrt(nominal * (1.0 - nominal) / n)
    err_sketch = FixedBinSketch(*ERROR_SKETCH_RANGE, ERROR_SKETCH_BINS)
    if ok:
        err_sketch.update(errs)
    cov_sketch = CalibrationSketch()
    if with_se:
        cov_sketch.update([nominal] * len(with_se),
                          [r["lower_ci"] <= r["tau_true"] <= r["upper_ci"] for r in with_se])
    out["sketches"] = {"error": err_sketch.to_dict(), "coverage": cov_sketch.to_dict()}
    return out


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def compare_cells(cells_a: Iterable[dict], cells_b: Iterable[dict]) -> dict:
    """Per-column batched-vs-scalar comparison: for each column the max
    deviation of ate/se/tau_true in f32 ulps at the compared magnitude
    (NaN == NaN). Returns ``{"columns": {col: max_ulp}, "max_ulp",
    "exact_columns", "missing"}``."""
    am = {r["method"]: r for r in cells_a}
    bm = {r["method"]: r for r in cells_b}
    missing = sorted(set(am) ^ set(bm))
    per_col: dict[str, float] = {}
    for cell in set(am) & set(bm):
        ra, rb = am[cell], bm[cell]
        worst = per_col.get(ra["column"], 0.0)
        for field in ("ate", "se", "tau_true"):
            a, b = ra.get(field), rb.get(field)
            a_nan, b_nan = not _finite(a), not _finite(b)
            if a_nan and b_nan:
                continue
            if a_nan != b_nan:
                worst = float("inf")
                continue
            if a == b:
                continue
            scale = float(np.spacing(np.float32(max(abs(a), abs(b)))))
            worst = max(worst, abs(a - b) / scale)
        per_col[ra["column"]] = worst
    finite_ulps = [u for u in per_col.values() if math.isfinite(u)]
    return {
        "columns": per_col,
        "max_ulp": (float("inf") if len(finite_ulps) < len(per_col)
                    else max(finite_ulps, default=0.0)),
        "exact_columns": sorted(c for c, u in per_col.items() if u == 0.0),
        "missing": missing,
    }


# ── the runner ────────────────────────────────────────────────────────


@dataclasses.dataclass
class MatrixReport:
    """One matrix run: per-cell rows (rows mode), per-column aggregates,
    and the evidence (wall seconds, compile events, batches)."""

    cells: list = dataclasses.field(default_factory=list)
    columns: dict = dataclasses.field(default_factory=dict)
    skipped_columns: list = dataclasses.field(default_factory=list)
    n_resumed: int = 0
    n_computed: int = 0
    n_failed: int = 0
    wall_s: float = 0.0
    compile_events_delta: float = 0.0
    n_columns: int = 0
    n_batches: int = 0
    #: a SIGTERM drain cut this run short: the journal holds the
    #: committed prefix and a rerun resumes it.
    drained: bool = False
    #: "aggregate" (streaming, the default) or "rows".
    mode: str = "rows"
    #: streaming mode: block records committed and merged column states.
    n_blocks: int = 0
    states: dict = dataclasses.field(default_factory=dict)


def _cells_counter():
    return obs.counter("scenario_cells_total",
                       "scenario-matrix cells by column and computed/resumed/failed status")


def _dispatch_counter():
    return obs.counter("scenario_batch_dispatch_total",
                       "scenario-matrix batch dispatches by column and vmapped/sequential mode")


def _blocks_counter():
    return obs.counter("scenario_aggregate_blocks_total",
                       "streaming aggregate blocks by column and computed/resumed/failed status")


def _cell_record(plan: ColumnPlan, rep: int, ate: float, se: float, tau_true: float,
                 seconds: float) -> dict:
    ate, se, tau_true = float(ate), float(se), float(tau_true)
    status = "ok" if math.isfinite(ate) else "failed"
    rec = {
        "method": cell_row_id(plan.dgp.name, plan.estimator, rep),
        "column": plan.name,
        "dgp": plan.dgp.name,
        "estimator": plan.estimator,
        "rep": rep,
        "ate": ate,
        "se": se,
        "lower_ci": ate - _Z95 * se if math.isfinite(se) else ate,
        "upper_ci": ate + _Z95 * se if math.isfinite(se) else ate,
        "tau_true": tau_true,
        "status": status,
        "seconds": round(seconds, 6),
    }
    if status == "failed":
        rec["error"] = f"NonFiniteResult: ate={ate!r}"
    return rec


def _failed_record(plan: ColumnPlan, rep: int, error: str) -> dict:
    nan = float("nan")
    return {
        "method": cell_row_id(plan.dgp.name, plan.estimator, rep),
        "column": plan.name,
        "dgp": plan.dgp.name,
        "estimator": plan.estimator,
        "rep": rep,
        "ate": nan, "se": nan, "lower_ci": nan, "upper_ci": nan,
        "tau_true": nan,
        "status": "failed",
        "error": error,
        "seconds": 0.0,
    }


# ── streaming block records ──────────────────────────────────────────


def _pack_reps(batch: tuple[int, ...]) -> list[list[int]]:
    """Run-length ``[[lo, hi], ...]`` encoding of a block's rep set:
    O(runs) bytes a record, never O(cells)."""
    runs: list[list[int]] = []
    for r in batch:
        if runs and r == runs[-1][1] + 1:
            runs[-1][1] = r
        else:
            runs.append([r, r])
    return runs


def _unpack_reps(packed: list) -> list[int]:
    return [r for lo, hi in packed for r in range(lo, hi + 1)]


def _packed_count(packed: list) -> int:
    return sum(hi - lo + 1 for lo, hi in packed)


def _block_record(plan: ColumnPlan, batch: tuple[int, ...], state: AggState,
                  seconds: float) -> dict:
    return {
        "method": block_row_id(plan.name, batch),
        "schema": AGG_SCHEMA_TAG,
        "column": plan.name,
        "dgp": plan.dgp.name,
        "estimator": plan.estimator,
        "reps": _pack_reps(batch),
        "width": plan.width,
        "status": "ok",
        "stats": list(state.stats),
        "seconds": round(seconds, 6),
    }


def _failed_block_record(plan: ColumnPlan, batch: tuple[int, ...], error: str) -> dict:
    return {
        "method": block_row_id(plan.name, batch),
        "schema": AGG_SCHEMA_TAG,
        "column": plan.name,
        "dgp": plan.dgp.name,
        "estimator": plan.estimator,
        "reps": _pack_reps(batch),
        "width": plan.width,
        "status": "failed",
        "error": error,
        "seconds": 0.0,
    }


def _block_resumable(rec: dict) -> bool:
    """A block record the resume scan may trust: schema-tagged, status
    ok, a full finite stat vector and a well-formed packed rep set."""
    if rec.get("schema") != AGG_SCHEMA_TAG or rec.get("status", "ok") != "ok":
        return False
    stats = rec.get("stats")
    if not isinstance(stats, list) or len(stats) != N_STATS:
        return False
    if not all(_finite(v) for v in stats):
        return False
    reps = rec.get("reps")
    return (isinstance(reps, list) and bool(reps)
            and all(isinstance(run, list) and len(run) == 2
                    and all(isinstance(r, int) for r in run) and run[0] <= run[1]
                    for run in reps))


def _scan_blocks(ckpt, fingerprint: str, log: Callable[[str], None]) -> dict:
    """Index a block journal's resumable records by column, asserting
    every record's schema tag first: a journal whose header lies (rows
    records under a block header) is renamed ``.stale`` and the scan
    restarts empty. Returns ``{column: {rep: record}}``."""
    from ate_replication_causalml_torch.pipeline import _unused_stale_path

    foreign = [m for m, rec in ckpt.done.items() if rec.get("schema") != AGG_SCHEMA_TAG]
    if foreign:
        if ckpt.path and os.path.exists(ckpt.path):
            stale = _unused_stale_path(ckpt.path)
            os.replace(ckpt.path, stale)
            log(f"checkpoint {ckpt.path}: {len(foreign)} record(s) without the "
                f"{AGG_SCHEMA_TAG!r} schema tag (e.g. {foreign[0]!r}) — not a block journal; "
                f"moved to {stale} and starting fresh")
            # Re-seed the header the rename removed.
            obs.atomic_write_text(ckpt.path, json.dumps(
                {"method": "__config__", "fingerprint": fingerprint}) + "\n")
        ckpt.done.clear()
        return {}
    by_column: dict[str, dict[int, dict]] = {}
    for rec in ckpt.done.values():
        if not _block_resumable(rec):
            continue
        col = by_column.setdefault(rec["column"], {})
        for rep in _unpack_reps(rec["reps"]):
            col[rep] = rec
    return by_column


def _trusted_blocks(blocks_by_col: dict, n_reps: int) -> tuple[dict, dict]:
    """The block records a run at ``n_reps`` may merge: all reps inside
    the grid and no overlap with an already accepted block (merging one
    twice would double-count), in min-rep order. Returns ``(trusted,
    covered)`` = ``{column: [records]}``, ``{column: set(reps)}``."""
    trusted: dict[str, list[dict]] = {}
    covered: dict[str, set[int]] = {}
    for col, by_rep in blocks_by_col.items():
        uniq = {rec["method"]: rec for rec in by_rep.values()}
        cov: set[int] = set()
        keep: list[dict] = []
        for rec in sorted(uniq.values(), key=lambda r: r["reps"][0][0]):
            reps = set(_unpack_reps(rec["reps"]))
            if max(reps) >= n_reps or reps & cov:
                continue
            keep.append(rec)
            cov |= reps
        trusted[col] = keep
        covered[col] = cov
    return trusted, covered


def _install_drain(engine, log: Callable[[str], None]):
    """SIGTERM → engine drain, returning a restore thunk (a SIGTERM after
    the run must kill the process again)."""
    import signal

    def _drain(signum, frame, _engine=engine):
        log("SIGTERM: draining scenario matrix (in-flight batches will commit)")
        _engine.request_drain()

    try:
        prev = signal.signal(signal.SIGTERM, _drain)
    except ValueError:
        return lambda: None  # not the main thread: no signal wiring

    def restore():
        try:
            signal.signal(signal.SIGTERM, prev)
        except ValueError:
            pass

    return restore


def generate_executable(dgp: DGPSpec, column: str = ""):
    """The sequential (forest) path's per-column draw:
    ``gen(root_key, cell_id, salt) -> (x, w, y, tau_true, est_key)``."""
    return cached_executable(("scenario-gen", dgp.fields()), lambda: (
        lambda root_key, cid, salt: generate_cell(dgp, root_key, cid, salt)),
        column or dgp.name, "generate")


@dataclasses.dataclass
class _Mode:
    """What differs between the rows path and the aggregate path: the
    column callable, how a stage body turns a batch into journal
    records, and the failure records."""

    exe: Callable            # (plan) -> the column's callable
    art_key: tuple           # suffix of the artifact cache key
    vmapped: Callable        # (plan, batch, exe) -> records
    sequential: Callable     # (plan, batch) -> records
    failed: Callable         # (plan, batch, error) -> records


def _drive(spec: MatrixSpec, plans: list[ColumnPlan], mode: _Mode, commit, report, n_workers,
           prefetch, dev, log, drain_on_sigterm, outdir, span_attrs: dict, shard=None) -> None:
    """Declare one artifact a vmapped column and one stage a batch, wrap
    each stage in the chaos fault and the degrade policy, and run the
    engine; the report's wall and compile events are filled whatever
    happens. Sharded, the vmapped columns' nodes run in the "mesh" lane,
    so every rank issues their collectives in one order."""
    lane = "mesh" if shard is not None else None
    from ate_replication_causalml_torch.scheduler import ArtifactSpec, StageSpec, SweepEngine

    fingerprint = spec.fingerprint()
    artifacts: list = []
    stages: list = []

    def make_exe_artifact(plan: ColumnPlan) -> str:
        name = f"exe:{plan.name}"
        fit = lambda c=None, p=plan: mode.exe(p)
        artifacts.append(ArtifactSpec(
            name, fit=fit,
            key=(fingerprint, column_cache_key(plan.dgp, plan.estimator, plan.width))
            + mode.art_key,
            warm=fit, exclusive=lane))
        return name

    def wrap_degrade(st: StageSpec, plan: ColumnPlan, batch: tuple[int, ...]) -> StageSpec:
        inner = st.run

        def run(cache):
            try:
                return inner(cache)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if spec.fail_policy != "degrade":
                    raise
                err = f"{type(e).__name__}: {e}"
                obs.emit("scenario_batch_failed", status="error", column=plan.name,
                         batch=len(batch), error=err)
                return mode.failed(plan, batch, err)

        return dataclasses.replace(st, run=run)

    # Chaos stage faults: planned against the declared batch order up
    # front (worker completion order cannot race the ``times`` budget),
    # injected inside the degrade wrapper.
    inj = chaos.active()
    stage_faults: frozenset[str] = frozenset()
    if inj is not None:
        stage_faults = inj.plan_stage_faults(
            [f"{p.name}#b{bi}" for p in plans for bi in range(len(p.batches))])

    def wrap_stage_fault(st: StageSpec) -> StageSpec:
        def run(cache, _name=st.name):
            # Recorded when raised, never at plan time.
            inj.record_stage_fault(_name)
            raise ChaosStageFault(f"chaos: injected stage fault on {_name!r}")

        return dataclasses.replace(st, run=run)

    for plan in plans:
        if not plan.batches:
            continue
        exe_name = make_exe_artifact(plan) if plan.mode == "vmapped" else None
        for bi, batch in enumerate(plan.batches):
            if plan.mode == "vmapped":
                st = StageSpec(f"{plan.name}#b{bi}",
                               lambda cache, p=plan, b=batch, e=exe_name: mode.vmapped(
                                   p, b, cache.get(e)),
                               needs=(exe_name,), exclusive=lane)
            else:
                st = StageSpec(f"{plan.name}#b{bi}",
                               lambda cache, p=plan, b=batch: mode.sequential(p, b))
            if st.name in stage_faults:
                st = wrap_stage_fault(st)
            stages.append(wrap_degrade(st, plan, batch))
            report.n_batches += 1

    with obs.span("run_matrix", columns=len(plans), reps=spec.n_reps, out=outdir or "",
                  **span_attrs) as root_sp:
        if stages:
            _load_cuda_linalg(dev)
            engine = SweepEngine(artifacts, stages, commit=commit, workers=n_workers,
                                 prefetch=prefetch, device=dev,
                                 span_parent=getattr(root_sp, "span_id", None))
            restore = _install_drain(engine, log) if drain_on_sigterm else (lambda: None)
            try:
                engine.run()
            finally:
                restore()
            if engine.draining:
                report.drained = True


def _load_cuda_linalg(dev: torch.device) -> None:
    """PyTorch loads its CUDA linear-algebra library on the first
    ``torch.linalg`` call, and that load is not thread-safe: two engine
    workers' first Cholesky raced and one failed its block ("lazy wrapper
    should be called at most once"). Load it on the calling thread."""
    if dev.type == "cuda":
        torch.linalg.cholesky_ex(torch.eye(1, device=dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _export(spec: MatrixSpec, report: MatrixReport, outdir: str | None, log) -> None:
    if not outdir or not is_writer():
        return
    try:
        obs.atomic_write_json(os.path.join(outdir, "matrix_report.json"),
                              _report_json(spec, report))
        obs.write_run_artifacts(outdir)
    except Exception as e:  # noqa: BLE001 — the export must not replace
        # the run's real exception.
        log(f"matrix export failed: {e!r}")


def run_matrix(
    spec: MatrixSpec,
    outdir: str | None = None,
    workers: int | None = None,
    scheduler: str | None = None,
    prefetch: bool | None = None,
    log: Callable[[str], None] = print,
    drain_on_sigterm: bool = False,
    device=None,
) -> MatrixReport:
    """Run the matrix through the engine on ``device`` (``cuda`` unless
    told otherwise). Telemetry exports to ``outdir`` beside
    ``cells.jsonl`` and ``matrix_report.json``. With ``drain_on_sigterm``
    (the CLI default) SIGTERM drains the engine: in-flight batches
    commit in declared order and a rerun resumes where the drain
    stopped. Streaming aggregates are the default; ``MatrixSpec(rows=
    True)`` or ``ATE_TPU_SCENARIO_ROWS=1`` materializes the cell table."""
    dev = resolve_device(device)
    shard = _Shard.resolve(spec, log)
    runner = _run_matrix_rows if spec.resolved_rows() else _run_matrix_aggregate
    report = runner(spec, outdir=outdir, workers=workers, scheduler=scheduler,
                    prefetch=prefetch, log=log, drain_on_sigterm=drain_on_sigterm, dev=dev,
                    shard=shard)
    barrier()  # rank 0's journal and exports are written before any rank returns
    return report


class _Shard:
    """The sharded dispatch of one matrix run over the world's ranks:
    rank r computes lanes ``[r·W/A, (r+1)·W/A)`` of each width-W batch."""

    def __init__(self, devices: int):
        from ate_replication_causalml_torch.parallel.mesh import DATA_AXIS, make_mesh, row_sharded

        self.devices = devices
        self.mesh = make_mesh((DATA_AXIS,))
        self.layout = row_sharded(self.mesh, DATA_AXIS)

    @classmethod
    def resolve(cls, spec: MatrixSpec, log) -> "_Shard | None":
        devices = _resolve_shard(spec)
        if devices == 1:
            return None
        log(f"scenario matrix: sharded dispatch over {devices} devices")
        return cls(devices)

    def lanes(self, plan, batch, root_key):
        """This batch's (ate, se, tau_true), each (W,), on this rank's
        device: the cell ids committed row-sharded (metered
        ``host_upload``), this rank's lanes computed at width W/A, the
        lanes all-gathered in lane order."""
        from ate_replication_causalml_torch.parallel import shardio
        from ate_replication_causalml_torch.parallel.mesh import replicated

        ids = shardio.commit(pad_ids(plan.dgp.name, batch, plan.width), self.layout,
                             artifact=plan.name)
        exe = column_executable(plan.dgp, SCENARIO_ESTIMATORS[plan.estimator],
                                plan.width // self.devices, column=plan.name)
        # The uint32 ids as int64 (through an int32 view: the cast from
        # uint32 is not on every device).
        local = exe(root_key, ids.local.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
        lanes = tuple(shardio.DArray(t, self.layout, (plan.width,)) for t in local)
        return tuple(t.local for t in shardio.reshard(lanes, replicated(self.mesh),
                                                      artifact=plan.name))


def _run_matrix_rows(spec, outdir, workers, scheduler, prefetch, log, drain_on_sigterm,
                     dev, shard=None) -> MatrixReport:
    """The per-cell path: one journal record and one host row a cell,
    cell-granular resume, per-cell degrade."""
    from ate_replication_causalml_torch.pipeline import (
        _Checkpoint,
        _resolve_scheduler,
        _row_resumable,
    )

    obs.install_monitoring()
    n_workers = _resolve_scheduler(scheduler, workers, log)
    t_start = time.monotonic()
    compiles_before = compile_event_count()
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    ckpt = _Checkpoint(os.path.join(outdir, "cells.jsonl") if outdir else None,
                       spec.fingerprint(), log=log, write=is_writer())
    barrier()  # every rank has read the journal before rank 0 appends

    def resumable(cell: str) -> bool:
        rec = ckpt.get(cell)
        return rec is not None and _row_resumable(rec)[0]

    plans, skipped = plan_columns(spec, done=resumable,
                                  devices=shard.devices if shard else 1)
    report = MatrixReport(skipped_columns=skipped, n_columns=len(plans))
    cells_c, disp_c = _cells_counter(), _dispatch_counter()
    root_key = rnd.key(spec.seed, device=dev)

    # Resumed cells never reach the engine: their rows join the report
    # now, in plan order.
    for plan in plans:
        remaining = set(plan.remaining)
        for rep in range(spec.n_reps):
            if rep in remaining:
                continue
            rec = ckpt.get(cell_row_id(plan.dgp.name, plan.estimator, rep))
            if rec is not None:
                report.cells.append(rec)
                report.n_resumed += 1
                cells_c.inc(1, column=plan.name, status="resumed")

    def vmapped(plan, batch, exe):
        t0 = time.perf_counter()
        # The final partial batch pads to the column's width with
        # duplicate ids; padded outputs are discarded here.
        if shard is not None:
            ate, se, tt = shard.lanes(plan, batch, root_key)
        else:
            ate, se, tt = exe(root_key, pad_ids(plan.dgp.name, batch, plan.width))
        ate, se, tt = (t.detach().cpu().numpy() for t in (ate, se, tt))
        dt = time.perf_counter() - t0
        disp_c.inc(1, column=plan.name, mode="vmapped")
        per_cell = dt / max(1, len(batch))
        return [_cell_record(plan, rep, ate[i], se[i], tt[i], per_cell)
                for i, rep in enumerate(batch)]

    def sequential(plan, batch):
        est = SCENARIO_ESTIMATORS[plan.estimator]
        gen = generate_executable(plan.dgp, column=plan.name)
        salt = estimator_salt(est.name)
        rows = []
        for rep in batch:
            t0 = time.perf_counter()
            x, w, y, tau_true, est_key = gen(root_key, data_cell_id(plan.dgp.name, rep), salt)
            ate, se = est.fn(plan.dgp, x, w, y, est_key)
            disp_c.inc(1, column=plan.name, mode="sequential")
            rows.append(_cell_record(plan, rep, float(ate), float(se), float(tau_true),
                                     time.perf_counter() - t0))
        return rows

    mode = _Mode(
        exe=lambda p: column_executable(p.dgp, SCENARIO_ESTIMATORS[p.estimator], p.width,
                                        column=p.name),
        art_key=(), vmapped=vmapped, sequential=sequential,
        failed=lambda p, b, err: [_failed_record(p, rep, err) for rep in b])

    def commit(spec_stage, rows: list) -> None:
        for rec in rows:
            ckpt.put(rec)
            report.cells.append(rec)
            if rec.get("status", "ok") == "ok":
                report.n_computed += 1
                cells_c.inc(1, column=rec["column"], status="computed")
            else:
                report.n_failed += 1
                cells_c.inc(1, column=rec["column"], status="failed")
        ok = sum(1 for r in rows if r.get("status", "ok") == "ok")
        log(f"  [{spec_stage.name}] {ok}/{len(rows)} cells ok")

    try:
        _drive(spec, plans, mode, commit, report, n_workers, prefetch, dev, log,
               drain_on_sigterm, outdir, {}, shard)
    finally:
        _sync(dev)
        report.wall_s = time.monotonic() - t_start
        report.compile_events_delta = compile_event_count() - compiles_before
        # Per-column aggregates over whatever completed.
        by_col: dict[str, list] = {}
        for rec in report.cells:
            by_col.setdefault(rec["column"], []).append(rec)
        report.columns = {col: column_aggregates(rows) for col, rows in by_col.items()}
        _export(spec, report, outdir, log)
    log(f"scenario matrix: {report.n_computed} computed, {report.n_resumed} resumed, "
        f"{report.n_failed} failed across {report.n_columns} columns in {report.wall_s:.1f}s "
        f"(compile events +{report.compile_events_delta:.0f})")
    return report


def _run_matrix_aggregate(spec, outdir, workers, scheduler, prefetch, log, drain_on_sigterm,
                          dev, shard=None) -> MatrixReport:
    """The streaming path: each batch runs the column's aggregate callable
    and journals one block record; ``report.cells`` stays empty, resume
    is block-granular, and a failed block journals a failed-block record
    for exactly its reps. A resumed block with failed cells inside is
    complete (the non-finite estimate is folded into ``n_failed``); a
    failed block carries no stats and recomputes on the next run."""
    from ate_replication_causalml_torch.pipeline import _Checkpoint, _resolve_scheduler

    obs.install_monitoring()
    n_workers = _resolve_scheduler(scheduler, workers, log)
    t_start = time.monotonic()
    compiles_before = compile_event_count()
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    fingerprint = spec.fingerprint()
    ckpt = _Checkpoint(os.path.join(outdir, "cells.jsonl") if outdir else None,
                       fingerprint, log=log, write=is_writer())
    barrier()  # every rank has read the journal before rank 0 appends
    trusted, covered = _trusted_blocks(_scan_blocks(ckpt, fingerprint, log), spec.n_reps)

    def resumed(cell: str) -> bool:
        col, _, rep = cell.rpartition(":")
        return int(rep) in covered.get(col, ())

    plans, skipped = plan_columns(spec, done=resumed, devices=shard.devices if shard else 1)
    # Sequential (forest) columns dispatch a cell at a time, but a width-1
    # BLOCK would journal one record a cell: re-pack their remaining reps
    # into batch_width chunks, each folded host-side through batch_stats.
    seq_width = min(spec.batch_width, spec.n_reps)
    plans = [
        p if p.mode == "vmapped" else dataclasses.replace(
            p, width=seq_width,
            batches=tuple(p.remaining[i:i + seq_width]
                          for i in range(0, len(p.remaining), seq_width)))
        for p in plans
    ]
    report = MatrixReport(skipped_columns=skipped, n_columns=len(plans), mode="aggregate")
    cells_c, disp_c, blocks_c = _cells_counter(), _dispatch_counter(), _blocks_counter()
    failed_by_col: dict[str, int] = {}
    root_key = rnd.key(spec.seed, device=dev)

    # Resumed blocks never reach the engine: merge their states now, in
    # plan order.
    for plan in plans:
        for rec in trusted.get(plan.name, ()):
            state = AggState.from_array(np.asarray(rec["stats"]))
            report.states[plan.name] = report.states.get(plan.name, AggState.zero()).merge(state)
            n = _packed_count(rec["reps"])
            report.n_resumed += n
            cells_c.inc(n, column=plan.name, status="resumed")
            blocks_c.inc(1, column=plan.name, status="resumed")

    def vmapped(plan, batch, exe):
        t0 = time.perf_counter()
        mask = batch_mask(batch, plan.width, plan.dgp.dtype)
        if shard is not None:
            # The fixed-order aggregate over the gathered lanes.
            ate, se, tt = shard.lanes(plan, batch, root_key)
            stats = batch_stats(ate, se, tt, torch.as_tensor(mask).to(ate.device))
        else:
            stats = exe(root_key, pad_ids(plan.dgp.name, batch, plan.width), mask)
        state = AggState.from_array(stats)
        disp_c.inc(1, column=plan.name, mode="vmapped")
        return [_block_record(plan, batch, state, time.perf_counter() - t0)]

    def sequential(plan, batch):
        est = SCENARIO_ESTIMATORS[plan.estimator]
        gen = generate_executable(plan.dgp, column=plan.name)
        salt = estimator_salt(est.name)
        t0 = time.perf_counter()
        triples = []
        for rep in batch:
            x, w, y, tau_true, est_key = gen(root_key, data_cell_id(plan.dgp.name, rep), salt)
            ate, se = est.fn(plan.dgp, x, w, y, est_key)
            disp_c.inc(1, column=plan.name, mode="sequential")
            triples.append((float(ate), float(se), float(tau_true)))
        state = fold_rows(triples, plan.width, plan.dgp.dtype)
        return [_block_record(plan, batch, state, time.perf_counter() - t0)]

    mode = _Mode(
        exe=lambda p: aggregate_executable(p.dgp, SCENARIO_ESTIMATORS[p.estimator], p.width,
                                           column=p.name),
        art_key=("agg",), vmapped=vmapped, sequential=sequential,
        failed=lambda p, b, err: [_failed_block_record(p, b, err)])

    def commit(spec_stage, recs: list) -> None:
        for rec in recs:
            ckpt.put(rec)
            report.n_blocks += 1
            col = rec["column"]
            n = _packed_count(rec["reps"])
            if rec.get("status", "ok") == "ok":
                state = AggState.from_array(np.asarray(rec["stats"]))
                report.states[col] = report.states.get(col, AggState.zero()).merge(state)
                report.n_computed += n
                cells_c.inc(n, column=col, status="computed")
                blocks_c.inc(1, column=col, status="computed")
                log(f"  [{spec_stage.name}] block ok ({n} cells)")
            else:
                failed_by_col[col] = failed_by_col.get(col, 0) + n
                report.n_failed += n
                cells_c.inc(n, column=col, status="failed")
                blocks_c.inc(1, column=col, status="failed")
                log(f"  [{spec_stage.name}] block FAILED ({n} cells)")

    try:
        _drive(spec, plans, mode, commit, report, n_workers, prefetch, dev, log,
               drain_on_sigterm, outdir, {"mode": "aggregate"}, shard)
    finally:
        _sync(dev)
        report.wall_s = time.monotonic() - t_start
        report.compile_events_delta = compile_event_count() - compiles_before
        # Column summaries from merged sums; failed-block cells never
        # folded into any stat vector, so they are accounted explicitly.
        report.columns = {}
        for col, st in report.states.items():
            summ = st.summary()
            extra = failed_by_col.pop(col, 0)
            summ["n_cells"] += extra
            summ["n_failed"] += extra
            report.columns[col] = summ
        for col, extra in failed_by_col.items():
            summ = AggState.zero().summary()
            summ["n_cells"] = extra
            summ["n_failed"] = extra
            report.columns[col] = summ
        _export(spec, report, outdir, log)
    log(f"scenario matrix [streaming]: {report.n_computed} computed, {report.n_resumed} "
        f"resumed, {report.n_failed} failed across {report.n_columns} columns / "
        f"{report.n_blocks} blocks in {report.wall_s:.1f}s "
        f"(compile events +{report.compile_events_delta:.0f})")
    return report


def _report_json(spec: MatrixSpec, report: MatrixReport) -> dict:
    def _san(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: _san(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_san(x) for x in v]
        return v

    return _san({
        "fingerprint": spec.fingerprint(),
        "mode": report.mode,
        "n_reps": spec.n_reps,
        "batch_width": spec.batch_width,
        "n_blocks": report.n_blocks,
        "columns": report.columns,
        "skipped_columns": report.skipped_columns,
        "n_computed": report.n_computed,
        "n_resumed": report.n_resumed,
        "n_failed": report.n_failed,
        "wall_s": round(report.wall_s, 3),
        "compile_events_delta": report.compile_events_delta,
        "drained": report.drained,
        "cells": report.cells,
    })


def run_scalar_replay(spec: MatrixSpec, log: Callable[[str], None] = print,
                      device=None) -> MatrixReport:
    """The scalar baseline of the vmapped columns: every cell through the
    column's scalar replay (:func:`~.batched.cell_fn`), one dispatch a
    cell, on ``device`` (``cuda`` unless told otherwise). Non-vmapped
    columns have no batched-vs-scalar distinction and are reported as
    ``skipped_columns``."""
    dev = resolve_device(device)
    obs.install_monitoring()
    t0 = time.monotonic()
    compiles_before = compile_event_count()
    plans, skipped = plan_columns(spec)
    skipped = list(skipped) + [f"{p.name}: non-vmapped — no scalar-replay leg"
                               for p in plans if not SCENARIO_ESTIMATORS[p.estimator].vmapped]
    plans = [p for p in plans if SCENARIO_ESTIMATORS[p.estimator].vmapped]
    report = MatrixReport(skipped_columns=skipped, n_columns=len(plans))
    root_key = rnd.key(spec.seed, device=dev)
    for plan in plans:
        exe = scalar_executable(plan.dgp, SCENARIO_ESTIMATORS[plan.estimator], column=plan.name)
        for rep in range(spec.n_reps):
            tc = time.perf_counter()
            try:
                ate, se, tt = exe(root_key, data_cell_id(plan.dgp.name, rep))
                rec = _cell_record(plan, rep, float(ate), float(se), float(tt),
                                   time.perf_counter() - tc)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # Mirror the batched leg's degrade-don't-abort.
                if spec.fail_policy != "degrade":
                    raise
                rec = _failed_record(plan, rep, f"{type(e).__name__}: {e}")
            report.cells.append(rec)
            if rec["status"] == "ok":
                report.n_computed += 1
            else:
                report.n_failed += 1
    report.wall_s = time.monotonic() - t0
    report.compile_events_delta = compile_event_count() - compiles_before
    by_col: dict[str, list] = {}
    for rec in report.cells:
        by_col.setdefault(rec["column"], []).append(rec)
    report.columns = {c: column_aggregates(r) for c, r in by_col.items()}
    log(f"scalar replay: {report.n_computed} cells ({report.n_failed} failed) "
        f"in {report.wall_s:.1f}s")
    return report


def main(argv: list[str] | None = None) -> MatrixReport:
    import argparse

    ap = argparse.ArgumentParser(description="Run a Monte-Carlo scenario matrix")
    ap.add_argument("--out", default=None,
                    help="output directory (cells.jsonl + matrix_report.json + telemetry)")
    ap.add_argument("--dgps", default="calibration,hetero_confounded",
                    help=f"comma list from {sorted(STOCK_DGPS)}")
    ap.add_argument("--estimators", default="naive,ipw_logit,aipw_logit")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--rows", action="store_true",
                    help="materialize the per-cell row table instead of streaming aggregate "
                    "blocks; same as ATE_TPU_SCENARIO_ROWS=1")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    spec = MatrixSpec(
        dgps=tuple(STOCK_DGPS[d] for d in args.dgps.split(",") if d),
        estimators=tuple(e for e in args.estimators.split(",") if e),
        n_reps=default_reps() if args.reps is None else args.reps,
        batch_width=default_batch_width() if args.batch is None else args.batch,
        seed=args.seed,
        rows=True if args.rows else None,
    )
    return run_matrix(spec, outdir=args.out,
                      scheduler="sequential" if args.sequential else None,
                      workers=args.workers, drain_on_sigterm=True, device=args.device)


if __name__ == "__main__":
    main()
