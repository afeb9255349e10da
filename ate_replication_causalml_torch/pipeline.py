"""The notebook-equivalent sweep, run one row after the other.

Port of ``ate_replication_causalml_tpu/pipeline.py``: data ingest →
prep → bias injection → RCT oracle → every estimator row of
``ate_replication.Rmd`` in notebook order → one result table, with

* **checkpoint/resume**: each row is appended to ``results.jsonl`` the
  moment it finishes, under a fingerprint of the configuration, the data
  source, the device and this package's name and version; a rerun on the
  same output directory resumes the finished rows, and a journal written
  under another fingerprint (another config, device or package, the JAX
  package's included) is set aside as ``*.stale[.N]``;
* **graceful degradation**: under ``fail_policy="degrade"`` a failing row
  becomes a ``status="failed"`` row (error, attempts, seconds), retried
  on resume; ``"raise"`` aborts on the first failure;
* **shared nuisances**: the logistic propensity, the AIPW outcome model,
  the LASSO fold ids, the LASSO propensity and the RF OOB propensity are
  fitted once, by the first row that needs them, and handed to every
  row that consumes them;
* ``report.json``, ``REPORT.md`` and, with ``plots=True``, the three
  figures.

Every row runs on one device (``cuda`` unless ``device="cpu"`` is
passed). The JAX package's concurrent scheduler, telemetry, tracing and
chaos hooks are not ported: ``scheduler`` takes only ``None`` or
"sequential", and ``workers`` and ``prefetch`` only ``None``.

CLI::

    python -m ate_replication_causalml_torch.pipeline --out results/ \\
        [--csv socialpresswgeooneperhh_NEIGH.csv] [--quick] [--no-plots] \\
        [--sequential] [--device cpu]
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
from ate_replication_causalml_torch.models.forest import rf_oob_propensity
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.lasso import default_foldid
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


def _atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to a temporary file beside ``path``, then rename it
    over ``path``: a kill leaves the old file or the new one, never half."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class _Checkpoint:
    """Append-only JSONL of finished result rows, keyed by method name.

    The first record is a config fingerprint; a journal written under
    another fingerprint is set aside (renamed ``*.stale`` / ``*.stale.N``,
    never clobbering an earlier one) instead of being reused. Torn lines
    (a kill mid-append) are skipped and logged; the row is recomputed.
    """

    def __init__(self, path: str | None, fingerprint: str, log=print):
        self.path = path
        self.done: dict[str, dict] = {}
        if path and os.path.exists(path):
            recs = []
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        recs.append(json.loads(line))
                    except json.JSONDecodeError:
                        log(f"checkpoint {path}: skipping unparsable line")
            header = next((r for r in recs if r.get("method") == "__config__"), None)
            if header is None or header.get("fingerprint") != fingerprint:
                stale = _unused_stale_path(path)
                os.replace(path, stale)
                log(f"checkpoint {path} was written under a different config; "
                    f"moved to {stale} and starting fresh")
            else:
                self.done = {r["method"]: r for r in recs if r["method"] != "__config__"}
        if path and not self.done and not os.path.exists(path):
            _atomic_write_text(path, json.dumps({"method": "__config__",
                                                 "fingerprint": fingerprint}) + "\n")

    def get(self, method: str) -> dict | None:
        return self.done.get(method)

    def put(self, rec: dict) -> None:
        rec = _jsonsafe(rec)
        self.done[rec["method"]] = rec
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


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


def _check_scheduler(scheduler, workers, prefetch) -> None:
    if scheduler not in (None, "sequential"):
        raise ValueError(f"scheduler must be None or 'sequential' (the concurrent scheduler is "
                         f"not ported), got {scheduler!r}")
    if workers is not None or prefetch is not None:
        raise ValueError("workers and prefetch belong to the concurrent scheduler, which is not "
                         f"ported; pass None (got workers={workers!r}, prefetch={prefetch!r})")


def _nan_or(v):
    return float("nan") if v is None else v


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
    """The full notebook run, checkpointed and timed, one row after the
    other on ``device`` (``cuda`` unless ``device="cpu"``).

    Each stage's key is ``fold_in(key(config.seed), crc32(name))``, so a
    resumed run gives the remaining rows the keys a fresh run would.
    ``report.timings_s`` holds each computed row's wall seconds, and each
    shared nuisance's under ``artifact:<name>`` (fitted by the first row
    that needs it, outside that row's time)."""
    _check_scheduler(scheduler, workers, prefetch)
    dev = resolve_device(device)
    if plots and outdir:
        viz.require_matplotlib()
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    ckpt = _Checkpoint(os.path.join(outdir, "results.jsonl") if outdir else None,
                       _fingerprint(config, csv_path, dev), log=log)

    df, df_mod, n_dropped = build_frames(config, csv_path, device=dev)
    log(f"prepared df n={df.n}, dropped {n_dropped} -> df_mod n={df_mod.n} on {dev.type}")
    report = SweepReport(oracle=None, results=ResultTable(), n_dropped=n_dropped,
                         n_biased=df_mod.n)
    timings = report.timings_s
    root_key = rnd.key(config.seed, device=dev)

    def key_for(name: str) -> torch.Tensor:
        return rnd.fold_in(root_key, zlib.crc32(name.encode()))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Shared nuisances: name -> (fit, the artifacts it needs).
    artifacts = {
        "p_logistic": (lambda: logistic_propensity(df_mod.x, df_mod.w), ()),
        "outcome_mu": (lambda: outcome_model_mu(df_mod), ()),
        "folds:ps_lasso": (lambda: default_foldid(key_for("ps_lasso"), df_mod.n), ()),
        "folds:seq_lasso": (lambda: default_foldid(key_for("seq_lasso"), df_mod.n), ()),
        "folds:usual_lasso": (lambda: default_foldid(key_for("usual_lasso"), df_mod.n), ()),
        "lasso_ps": (lambda: prop_score_lasso(df_mod, foldid=cache["folds:ps_lasso"]),
                     ("folds:ps_lasso",)),
        "rf_oob_propensity": (lambda: rf_oob_propensity(
            df_mod, key=key_for("dr_rf_prop"), n_trees=config.dr_trees,
            depth=config.forest_depth), ()),
    }
    cache: dict = {}

    def ensure(name: str) -> None:
        """Fit ``name`` (and what it needs) unless it is in the cache."""
        if name in cache:
            return
        fit, needs = artifacts[name]
        for dep in needs:
            ensure(dep)
        t0 = time.perf_counter()
        cache[name] = fit()
        sync()
        timings[f"artifact:{name}"] = time.perf_counter() - t0

    def cf_row():
        cf = causal_forest_report(df_mod, key=key_for("causal_forest"), n_trees=config.cf_trees,
                                  nuisance_trees=config.cf_nuisance_trees)
        return cf.result, {"incorrect_ate": cf.incorrect_ate, "incorrect_se": cf.incorrect_se}

    c = cache       # the decls' short name for it
    stage_decls: list[tuple[str, Callable[[], object], tuple[str, ...]]] = [
        ("oracle", lambda: naive_ate(df, method="oracle"), ()),
        ("naive", lambda: naive_ate(df_mod), ()),
        ("Direct Method", lambda: ate_condmean_ols(df_mod), ()),
        ("Propensity_Weighting", lambda: prop_score_weight(df_mod, c["p_logistic"]),
         ("p_logistic",)),
        ("Propensity_Regression", lambda: prop_score_ols(df_mod, c["p_logistic"]),
         ("p_logistic",)),
        ("Propensity_Weighting_LASSOPS",
         lambda: prop_score_weight(df_mod, c["lasso_ps"], method="Propensity_Weighting_LASSOPS"),
         ("lasso_ps",)),
        ("Single-equation LASSO",
         lambda: ate_condmean_lasso(df_mod, foldid=c["folds:seq_lasso"]), ("folds:seq_lasso",)),
        ("Usual LASSO", lambda: ate_lasso(df_mod, foldid=c["folds:usual_lasso"]),
         ("folds:usual_lasso",)),
        ("Doubly Robust with Random Forest PS",
         lambda: doubly_robust(df_mod, lambda f: c["rf_oob_propensity"], key=key_for("dr_rf"),
                               mu=c["outcome_mu"]),
         ("rf_oob_propensity", "outcome_mu")),
        ("Doubly Robust with logistic regression PS",
         lambda: doubly_robust_glm(df_mod, key=key_for("dr_glm"), p=c["p_logistic"],
                                   mu=c["outcome_mu"]),
         ("p_logistic", "outcome_mu")),
        ("Belloni et.al", lambda: belloni(df_mod, key=key_for("belloni")), ()),
        ("Double Machine Learning",
         lambda: double_ml(df_mod, n_trees=config.dml_trees, depth=config.forest_depth,
                           key=key_for("dml"), device=dev), ()),
        ("residual_balancing",
         lambda: residual_balance_ate(df_mod, key=key_for("balance"),
                                      max_iters=config.balance_iters), ()),
        # The result row plus the notebook's deliberately "incorrect"
        # aggregate (Rmd:258-262), carried in the checkpoint record.
        ("Causal Forest(GRF)", cf_row, ()),
    ]
    assert [m for m, _, _ in stage_decls[1:]] == list(SWEEP_METHODS)

    rows: dict[str, EstimatorResult] = {}
    for method, fn, needs in stage_decls:
        rows[method] = _run_stage(method, fn, needs, ckpt, ensure, sync, config, report, log)

    report.oracle = rows["oracle"]
    for m in SWEEP_METHODS:
        report.results.append(rows[m])
    cf_rec = ckpt.get("Causal Forest(GRF)") or {}
    report.incorrect_cf_ate = cf_rec.get("incorrect_ate")
    report.incorrect_cf_se = cf_rec.get("incorrect_se")

    if outdir:
        _atomic_write_text(os.path.join(outdir, "report.json"), json.dumps(_jsonsafe({
            "oracle": report.oracle.to_dict(),
            "results": [r.to_dict() for r in report.results],
            "n_dropped": report.n_dropped,
            "n_biased": report.n_biased,
            "incorrect_cf": [report.incorrect_cf_ate, report.incorrect_cf_se],
            "timings_s": {k: round(v, 3) for k, v in report.timings_s.items()},
            "failures": report.failures,
            "device": dev.type,
        }), indent=1))
    if plots and outdir:
        # A degraded oracle cannot anchor the reference band.
        oracle_fig = report.oracle if math.isfinite(report.oracle.ate) else None
        report.figure_paths = viz.notebook_figures(report.results, oracle_fig, outdir)
        log(f"figures: {report.figure_paths}")
    if outdir:
        log(f"report: {write_report_md(report, outdir, csv_path=csv_path)}")
    return report


def _run_stage(method, fn, needs, ckpt, ensure, sync, config, report, log) -> EstimatorResult:
    """One row: resumed from the checkpoint when its record is resumable,
    else computed (its nuisances first) and journaled; under "degrade" a
    failure becomes a ``status="failed"`` row. ^C always propagates."""
    cached = ckpt.get(method)
    if cached is not None:
        ok, why = _row_resumable(cached)
        if ok:
            report.resumed += 1
            report.timings_s[method] = cached.get("seconds", 0.0)
            log(f"  [resume] {method}: ate={cached['ate']:.4f}")
            return EstimatorResult(method=cached["method"], ate=cached["ate"],
                                   lower_ci=_nan_or(cached["lower_ci"]),
                                   upper_ci=_nan_or(cached["upper_ci"]),
                                   se=_nan_or(cached["se"]))
        log(f"  [retry] {method}: checkpoint row not resumable ({why}); recomputing")
    prior = cached.get("attempts") if cached else 0
    attempts = (int(prior) + 1 if isinstance(prior, (int, float)) and not isinstance(prior, bool)
                else 1)
    report.computed += 1
    t0 = time.perf_counter()
    try:
        for name in needs:
            ensure(name)
        t0 = time.perf_counter()
        out = fn()
        sync()
        res, extras = out if isinstance(out, tuple) else (out, {})
        if not math.isfinite(res.ate):
            raise FloatingPointError(f"estimator returned ATE {res.ate!r} from finite inputs; "
                                     "refusing to record it")
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        if config.fail_policy != "degrade":
            raise
        dt = time.perf_counter() - t0
        err = f"{type(e).__name__}: {e}"
        nan = float("nan")
        res = EstimatorResult(method=method, ate=nan, lower_ci=nan, upper_ci=nan, se=nan,
                              status="failed")
        report.failures[method] = {"error": err, "attempts": attempts, "seconds": round(dt, 3)}
        ckpt.put(dict(res.to_dict(), error=err, attempts=attempts, seconds=round(dt, 3)))
        log(f"  [FAILED] {method}: {err} (attempt {attempts}, {dt:.1f}s); degrading, "
            "sweep continues")
        return res
    dt = time.perf_counter() - t0
    report.timings_s[method] = dt
    ckpt.put(dict(res.to_dict(), seconds=round(dt, 3), attempts=attempts, **extras))
    if "incorrect_ate" in extras:
        log(f"  Incorrect ATE: {extras['incorrect_ate']:.3f} (SE: {extras['incorrect_se']:.3f})"
            "  [deliberate negative example, Rmd:262]")
    log(f"  {method}: ate={res.ate:.4f} ci=[{res.lower_ci:.4f},{res.upper_ci:.4f}] ({dt:.1f}s)")
    return res


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
    _atomic_write_text(path, "\n".join(lines))
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
                    help="accepted: the port's sweep is always sequential")
    ap.add_argument("--workers", type=int, default=None,
                    help="not supported (the concurrent scheduler is not ported): raises")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv if argv is None else list(argv))

    config = SweepConfig()
    if args.quick:
        config = config.quick()
    report = run_sweep(config, csv_path=args.csv, outdir=args.out, plots=not args.no_plots,
                       scheduler="sequential", workers=args.workers, device=args.device)
    print(repr(report.results))
    return report


if __name__ == "__main__":
    main()
