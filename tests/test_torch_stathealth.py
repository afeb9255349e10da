"""The port's statistical-health plane (``observability/sketch.py``,
``observability/stathealth.py``, ``stat_health_slos``) against the JAX
package's, on the CPU.

The state is integer counts, so everything is exact: the same values
give byte-identical sketch JSON, equal merges, quantiles, PSI and KS; the
same batches under the same injected clock give a byte-identical
``stat_health.json``, equal ``health()`` and equal
``serving_stat_windows_total`` / ``stat_drift_events_total`` /
``serving_stat_rows_total`` counters. Inputs come from numpy seeds and
include NaNs, both tails and values on the bin edges; the port's
vectorized numpy path is also held to its own element loop.
"""

import dataclasses
import json

import numpy as np
import pytest

from ate_replication_causalml_torch.observability import registry as treg
from ate_replication_causalml_torch.observability import sketch as tsk
from ate_replication_causalml_torch.observability import slo as tslo
from ate_replication_causalml_torch.observability import stathealth as tsh
from ate_replication_causalml_tpu.observability import registry as jreg
from ate_replication_causalml_tpu.observability import sketch as jsk
from ate_replication_causalml_tpu.observability import slo as jslo
from ate_replication_causalml_tpu.observability import stathealth as jsh

SKETCH_CASES = [(-32.0, 32.0, 8), (-4.0, 4.0, 8), (0.0, 1.0, 10), (-1.5, 2.5, 3)]


def _values(seed: int, lo: float, hi: float, n_bins: int) -> np.ndarray:
    """Normal draws over the range and past both ends, the interior bin
    edges themselves, and NaNs."""
    rng = np.random.default_rng(seed)
    width = (hi - lo) / n_bins
    v = rng.normal((lo + hi) / 2, (hi - lo) / 2.5, size=400)
    edges = np.asarray([lo + i * width for i in range(0, n_bins + 1)])
    v = np.concatenate([v, edges, [np.nan, np.nan, lo - 1e-9, hi]])
    return rng.permutation(v)


@pytest.mark.parametrize("case", range(len(SKETCH_CASES)))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("feed", ["array", "list"])
def test_fixed_bin_sketch_equals_jax(case, dtype, feed):
    lo, hi, n_bins = SKETCH_CASES[case]
    v = _values(case, lo, hi, n_bins).astype(dtype)
    a, b = v[:200], v[200:]
    ta, tb = tsk.FixedBinSketch(lo, hi, n_bins), tsk.FixedBinSketch(lo, hi, n_bins)
    ja, jb = jsk.FixedBinSketch(lo, hi, n_bins), jsk.FixedBinSketch(lo, hi, n_bins)
    ta.update(a if feed == "array" else a.tolist())
    tb.update(b if feed == "array" else b.tolist())
    ja.update(a.tolist())  # the JAX package's element loop
    jb.update(b.tolist())
    assert ta.to_json() == ja.to_json() and tb.to_json() == jb.to_json()
    one = tsk.FixedBinSketch(lo, hi, n_bins)
    for x in a.tolist():
        one.add(x)
    assert one.to_json() == ta.to_json()
    merged, jmerged = ta.merge(tb), ja.merge(jb)
    assert merged.to_json() == jmerged.to_json()
    assert merged.to_json() == tb.merge(ta).to_json()
    assert tsk.FixedBinSketch.from_json(jmerged.to_json()).to_json() == jmerged.to_json()
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert merged.quantile(q) == jmerged.quantile(q)
    assert tsk.psi(ta, tb) == jsk.psi(ja, jb)
    assert tsk.ks_statistic(ta, tb) == jsk.ks_statistic(ja, jb)
    assert (merged.total(), merged.located()) == (jmerged.total(), jmerged.located())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_sketch_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(-0.2, 1.2, size=300), [np.nan, 0.0, 1.0, 0.5]])
    y = rng.uniform(size=p.shape[0]) < np.clip(np.nan_to_num(p), 0, 1)
    t, j = tsk.CalibrationSketch(10), jsk.CalibrationSketch(10)
    t.update(p, y)
    j.update(p, y)
    assert t.to_json() == j.to_json()
    assert t.calibration_error() == j.calibration_error()
    t2, j2 = tsk.CalibrationSketch(10), jsk.CalibrationSketch(10)
    t2.update(p[::-1], y[::-1])
    j2.update(p[::-1], y[::-1])
    assert t.merge(t2).to_json() == j.merge(j2).to_json()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _batches(seed: int, n: int, p: int, shift_at: int | None):
    """(cate, x) batches a dispatcher would feed: float32, rows 1–64,
    the covariates shifted by 2.5 from batch ``shift_at`` on."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = int(rng.integers(1, 65))
        x = rng.normal(size=(rows, p)).astype(np.float32)
        if shift_at is not None and i >= shift_at:
            x[:, 0] += np.float32(2.5)
        cate = (rng.normal(size=rows) * 3 + x[:, 0]).astype(np.float32)
        out.append((cate, x))
    return out


MONITOR_CASES = {
    "stationary": dict(shift_at=None, calibration=None),
    "drift": dict(shift_at=12, calibration=None),
    "calibration": dict(shift_at=None, calibration=(1, 2)),
    "drift_calibration_two_models": dict(shift_at=8, calibration=(0, 3), models=("a", "b")),
}


def _run_monitor(mod, reg_mod, case: dict, batches):
    clock = _Clock()
    reg = reg_mod.MetricsRegistry()
    models = case.get("models", ("default",))
    mon = mod.StatHealthMonitor(models, window_s=1.0, clock=clock, registry=reg,
                                min_count=40, calibration_cols=case["calibration"])
    for i, (cate, x) in enumerate(batches):
        clock.t = 0.37 * i
        mon.observe(models[i % len(models)], cate, x)
    return mon, reg


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_state_report_and_counters_equal_jax(case, tmp_path):
    cfg = MONITOR_CASES[case]
    batches = _batches(len(case), 40, 5, cfg["shift_at"])
    tmon, treg_ = _run_monitor(tsh, treg, cfg, batches)
    jmon, jreg_ = _run_monitor(jsh, jreg, cfg, batches)
    tstate, jstate = tmon.state_dict(), jmon.state_dict()
    assert json.dumps(tstate, sort_keys=True) == json.dumps(jstate, sort_keys=True)
    assert tmon.health() == jmon.health()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    trep = tsh.write_stat_health(str(tmp_path / "t"), tstate)
    jsh.write_stat_health(str(tmp_path / "j"), jstate)
    tbytes = (tmp_path / "t" / tsh.STAT_HEALTH_BASENAME).read_bytes()
    assert tbytes == (tmp_path / "j" / jsh.STAT_HEALTH_BASENAME).read_bytes()
    # The file is its own recompute input.
    again = tsh.stat_health_report(json.loads(tbytes)["state"])
    assert json.dumps(again, indent=1) + "\n" == tbytes.decode()
    assert tsh.render_summary(trep) == jsh.render_summary(jsh.stat_health_report(jstate))
    want = {k: v for k, v in jreg_.snapshot()["counters"].items() if k.startswith(("serving_stat",
                                                                                    "stat_"))}
    assert treg_.snapshot()["counters"] == want
    if cfg["shift_at"] is not None:
        assert trep["drift"]["events"] > 0  # the shift was seen
    if cfg["calibration"] is not None:
        assert any(m["calibration"]["windows"] for m in trep["summary"].values())


def test_stat_health_slos_equal_jax():
    for kw in ({}, {"models": ("default", "tenant_b"), "objective": 0.8,
                    "windows_s": (10.0, 60.0)}):
        got = [dataclasses.asdict(s) for s in tslo.stat_health_slos(**kw)]
        want = [dataclasses.asdict(s) for s in jslo.stat_health_slos(**kw)]
        assert got == want
