"""The port's sweep (``pipeline.py``) against the JAX package's:
one MICRO sweep (``tests/test_pipeline_driver.py``'s shapes: 1,200-row
sample → 252 biased rows, 16-tree forests of depth 4, a 600-iteration
balancing budget) through both packages on the CPU (the JAX package
sequential, on one device, float32), matched row by row; then the
journal's mechanics on copies of the port's output directory: resume,
stale set-aside, torn lines, failed rows, degrade against raise, and
the report.

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

import jax
import pytest
import torch

from ate_replication_causalml_torch import pipeline as tp
from ate_replication_causalml_torch.data.pipeline import PrepConfig as TPrep
from ate_replication_causalml_tpu import pipeline as jp
from ate_replication_causalml_tpu.data.pipeline import PrepConfig as JPrep


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


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweeps")
    with jax.enable_x64(False):
        ref = jp.run_sweep(_micro(jp, JPrep), outdir=str(root / "jax"), plots=False,
                           log=lambda s: None, scheduler="sequential")
    logs = []
    got = tp.run_sweep(MICRO, outdir=str(root / "port"), plots=True, log=logs.append,
                       device="cpu")
    return dict(ref=ref, got=got, root=root, logs=logs)


def _copy(sweeps, tmp_path, name="out") -> str:
    out = str(tmp_path / name)
    shutil.copytree(str(sweeps["root"] / "port"), out)
    return out


def _journal(out) -> list[str]:
    with open(os.path.join(out, "results.jsonl")) as f:
        return f.readlines()


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
    def no_frames(*a, **k):
        raise AssertionError("the sweep started")

    monkeypatch.setattr(tp, "build_frames", no_frames)
    for kw in (dict(scheduler="concurrent"), dict(workers=2), dict(prefetch=True)):
        with pytest.raises(ValueError):
            tp.run_sweep(MICRO, plots=False, device="cpu", **kw)
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.run_sweep(MICRO, plots=False)
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tp.run_sweep(MICRO, outdir=str(tmp_path / "p"), plots=True, device="cpu")


def test_main_arguments(monkeypatch):
    """The CLI's flags reach run_sweep; --workers raises there."""
    seen = {}

    def fake_run_sweep(config, **kw):
        seen.update(config=config, **kw)
        return tp.SweepReport(oracle=None, results=tp.ResultTable(), n_dropped=0, n_biased=0)

    monkeypatch.setattr(tp, "run_sweep", fake_run_sweep)
    tp.main(["--out", "o", "--quick", "--no-plots", "--sequential", "--device", "cpu"])
    assert seen["config"] == tp.SweepConfig().quick() and seen["outdir"] == "o"
    assert seen["plots"] is False and seen["device"] == "cpu" and seen["workers"] is None
    monkeypatch.undo()
    with pytest.raises(ValueError, match="workers"):
        tp.main(["--out", "o", "--workers", "2", "--device", "cpu"])
