"""Statistical-health plane of the serving daemon.

Port of ``ate_replication_causalml_tpu/observability/stathealth.py``:
the same channels, windows, thresholds, counters and report bytes. The
rest of the observability stack says whether the daemon is *fast*; this
module says whether it is plausibly *right*. A
:class:`StatHealthMonitor` accumulates deterministic, mergeable
sketches (:mod:`.sketch`) per served model over three channels:

* ``cate``: the served CATE point estimates,
* ``covariate``: per-request-row covariate means (the cheap location
  summary of the incoming feature distribution),
* ``propensity``: a logistic squash of the configured propensity
  feature column (overlap degradation is where AIPW-style estimators
  break first),

plus an optional propensity-calibration channel (predicted probability
against empirical treatment over reliability buckets). Each channel
keeps an all-time ``total`` sketch (the fleet-mergeable artifact) and a
current clock-gridded window; sealed windows are compared pairwise with
PSI and the KS statistic, and each sealed evaluation lands in the
``serving_stat_windows_total`` counter with a ``status`` label, which
:func:`~.slo.stat_health_slos` turns into burn-rate objectives.

Determinism: the sketch totals are integer-count functions of the
served multiset, insertion-order independent and, because served
answers are bit-identical, byte-identical per seed. The windowed
detector state reads an injectable clock (``time.monotonic`` by
default) and is deterministic only under an injected clock.

Host-side only: the daemon's dispatcher calls
:meth:`StatHealthMonitor.observe` with the numpy arrays of the batch's
one host read, so the plane adds no device launch and no host sync. The
covariate means are sequential float64 sums (``np.cumsum`` along a row,
the order of Python's ``sum``) and the logistic squash is ``math.exp``
per row, so every value binned equals the JAX package's.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Sequence

import numpy as np

from ate_replication_causalml_torch.observability.sketch import (
    CalibrationSketch,
    FixedBinSketch,
    ks_statistic,
    psi,
)

STAT_HEALTH_SCHEMA_VERSION = 1
STAT_HEALTH_BASENAME = "stat_health.json"

#: window-pair drift thresholds: PSI > 0.25 is the classic "population
#: moved" screen; the KS bound is set above two-sample noise at the
#: minimum window count below.
PSI_DRIFT_THRESHOLD = 0.25
KS_DRIFT_THRESHOLD = 0.30
#: midpoint-ECE above this marks a calibration window miscalibrated.
CALIBRATION_THRESHOLD = 0.10
#: both windows of a pair need at least this much located mass before
#: the detectors are trusted — with 8 bins + tails, PSI's smoothing
#: bias at n=200 is ≈ 2·10/200 = 0.1, comfortably under 0.25.
MIN_WINDOW_COUNT = 200
#: drift-evaluation window width, seconds (``ATE_TPU_STAT_WINDOW``).
DEFAULT_WINDOW_S = 5.0
#: per-channel fixed-bin resolution — deliberately coarse: drift power
#: scales with per-bin mass, and 8 bins + tails keeps stationary PSI
#: noise far from the threshold at MIN_WINDOW_COUNT.
DEFAULT_BINS = 8
#: sealed windows / series entries retained per channel (bounded, like
#: the SLO engine's tick history).
MAX_WINDOWS = 64

#: the distributional channels, in fixed report order.
CHANNELS = ("cate", "covariate", "propensity")

#: fixed sketch ranges per channel. Out-of-range mass is not lost — it
#: lands in the tails, which PSI/KS compare like any other cell.
CHANNEL_RANGES = {
    "cate": (-32.0, 32.0),
    "covariate": (-4.0, 4.0),
    "propensity": (0.0, 1.0),
}

_WINDOW_STATUSES = ("ok", "drift", "sparse")
_CALIBRATION_STATUSES = ("ok", "miscal", "sparse")


def _sigmoid(z: float) -> float:
    if z >= 0.0:
        return 1.0 / (1.0 + math.exp(-z))
    e = math.exp(z)
    return e / (1.0 + e)


class _Channel:
    """One model × channel accumulator: all-time total, current window,
    bounded sealed-window history, and the evaluation series."""

    __slots__ = ("lo", "hi", "bins", "total", "current", "index",
                 "windows", "series")

    def __init__(self, lo: float, hi: float, bins: int):
        self.lo, self.hi, self.bins = lo, hi, bins
        self.total = FixedBinSketch(lo, hi, bins)
        self.current = FixedBinSketch(lo, hi, bins)
        self.index: int | None = None
        self.windows: list[tuple[int, FixedBinSketch]] = []
        self.series: list[dict] = []


class _CalibrationChannel:
    __slots__ = ("buckets", "total", "current", "index", "windows",
                 "series")

    def __init__(self, buckets: int = 10):
        self.buckets = buckets
        self.total = CalibrationSketch(buckets)
        self.current = CalibrationSketch(buckets)
        self.index: int | None = None
        self.windows: list[tuple[int, CalibrationSketch]] = []
        self.series: list[dict] = []


class StatHealthMonitor:
    """Per-model streaming statistical health over served traffic.

    ``observe`` is called by the dispatcher per dispatched batch with
    host-side arrays; everything else is a read. Thread-safe the
    one instance lock around every state mutation
    and every consistent read.

    ``calibration_cols`` — ``(propensity_col, treatment_col)`` feature
    indices — arms the calibration channel: predicted = logistic of
    the propensity column, empirical = treatment column > 0. Unarmed
    (the default), the channel stays empty and its SLO never spends
    budget (an empty window is zero burn).
    """

    def __init__(
        self,
        model_ids: Sequence[str] = ("default",),
        *,
        window_s: float = DEFAULT_WINDOW_S,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
        bins: int = DEFAULT_BINS,
        psi_threshold: float = PSI_DRIFT_THRESHOLD,
        ks_threshold: float = KS_DRIFT_THRESHOLD,
        calibration_threshold: float = CALIBRATION_THRESHOLD,
        min_count: int = MIN_WINDOW_COUNT,
        max_windows: int = MAX_WINDOWS,
        propensity_col: int = 0,
        calibration_cols: tuple[int, int] | None = None,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {min_count}")
        self.window_s = float(window_s)
        self._clock = clock
        self._registry = registry
        self._bins = int(bins)
        self._psi_threshold = float(psi_threshold)
        self._ks_threshold = float(ks_threshold)
        self._calibration_threshold = float(calibration_threshold)
        self._min_count = int(min_count)
        self._max_windows = int(max_windows)
        self._propensity_col = int(propensity_col)
        self._calibration_cols = (
            (int(calibration_cols[0]), int(calibration_cols[1]))
            if calibration_cols is not None else None
        )
        self._lock = threading.RLock()
        self._t0: float | None = None
        self._rows: dict[str, int] = {}
        self._drift_events: dict[str, int] = {}
        self._channels: dict[str, dict[str, _Channel]] = {}
        self._calibration: dict[str, _CalibrationChannel] = {}
        for m in model_ids:
            self._ensure_model_locked(str(m))

    # ── accumulation ────────────────────────────────────────────────────

    def _ensure_model_locked(self, model: str) -> None:
        # Callers already hold the instance lock; it is an RLock, so
        # the ``with`` re-enters for free.
        with self._lock:
            if model in self._channels:
                return
            self._channels[model] = {
                ch: _Channel(*CHANNEL_RANGES[ch], self._bins)
                for ch in CHANNELS
            }
            self._calibration[model] = _CalibrationChannel()
            self._rows.setdefault(model, 0)
            self._drift_events.setdefault(model, 0)

    def observe(self, model: str, cate, x, now: float | None = None) -> None:
        """Fold one dispatched batch: served CATE values and the
        matching request rows (row-major, any nested iterable of numbers
        or a numpy array). Host-side only: callers hand in materialized
        numpy, never a device tensor."""
        model = str(model) or "default"
        cate_vals = np.asarray(cate, dtype=np.float64).ravel()
        rows = np.asarray(x, dtype=np.float64)
        if rows.ndim != 2:
            rows = rows.reshape(len(rows), -1)
        n_rows, p = rows.shape
        cov_means = (np.cumsum(rows, axis=1)[:, -1] / p if p else np.zeros((0,)))
        pcol = self._propensity_col
        prop = np.asarray([_sigmoid(v) for v in rows[:, pcol].tolist()]
                          if p > pcol else [], dtype=np.float64)
        calib = None
        if self._calibration_cols is not None:
            pc, tc = self._calibration_cols
            if p > pc and p > tc:
                calib = [(_sigmoid(a), b > 0.0)
                         for a, b in zip(rows[:, pc].tolist(), rows[:, tc].tolist())]
        with self._lock:
            self._ensure_model_locked(model)
            if now is None:
                now = self._clock()
            if self._t0 is None:
                self._t0 = now
            idx = int((now - self._t0) // self.window_s)
            self._rows[model] += n_rows
            for ch_name, vals in (("cate", cate_vals),
                                  ("covariate", cov_means),
                                  ("propensity", prop)):
                ch = self._channels[model][ch_name]
                self._roll_locked(model, ch_name, ch, idx)
                ch.total.update(vals)
                ch.current.update(vals)
            cal = self._calibration[model]
            self._roll_calibration_locked(model, cal, idx)
            if calib:
                p_hat = [p for p, _ in calib]
                treated = [t for _, t in calib]
                cal.total.update(p_hat, treated)
                cal.current.update(p_hat, treated)
        self._emit("serving_stat_rows_total", n_rows, model=model)

    # ── window sealing + evaluation ─────────────────────────────────────

    def _roll_locked(self, model: str, ch_name: str, ch: _Channel,
                     idx: int) -> None:
        if ch.index is None:
            ch.index = idx
            return
        if idx <= ch.index:
            return
        if ch.current.total() > 0:
            self._seal_locked(model, ch_name, ch)
        ch.current = FixedBinSketch(ch.lo, ch.hi, ch.bins)
        ch.index = idx

    def _seal_locked(self, model: str, ch_name: str, ch: _Channel) -> None:
        sealed = (ch.index, ch.current)
        prev = ch.windows[-1] if ch.windows else None
        ch.windows.append(sealed)
        del ch.windows[:-self._max_windows]
        if prev is None:
            return  # a pair detector has nothing to say about window 1
        prev_idx, prev_sketch = prev
        psi_v = psi(prev_sketch, ch.current)
        ks_v = ks_statistic(prev_sketch, ch.current)
        if min(prev_sketch.located(), ch.current.located()) < self._min_count:
            status = "sparse"
        elif psi_v > self._psi_threshold or ks_v > self._ks_threshold:
            status = "drift"
        else:
            status = "ok"
        ch.series.append({
            "index": ch.index,
            "prev_index": prev_idx,
            "psi": round(psi_v, 9),
            "ks": round(ks_v, 9),
            "status": status,
        })
        del ch.series[:-self._max_windows]
        self._emit("serving_stat_windows_total", 1, model=model,
                   channel=ch_name, status=status)
        if status == "drift":
            with self._lock:  # re-entrant; caller holds it already
                self._drift_events[model] += 1
            if psi_v > self._psi_threshold:
                self._emit("stat_drift_events_total", 1, model=model,
                           channel=ch_name, detector="psi")
            if ks_v > self._ks_threshold:
                self._emit("stat_drift_events_total", 1, model=model,
                           channel=ch_name, detector="ks")

    def _roll_calibration_locked(self, model: str,
                                 cal: _CalibrationChannel,
                                 idx: int) -> None:
        if cal.index is None:
            cal.index = idx
            return
        if idx <= cal.index:
            return
        if cal.current.total() > 0:
            err = cal.current.calibration_error()
            if cal.current.located() < self._min_count:
                status = "sparse"
            elif err is not None and err > self._calibration_threshold:
                status = "miscal"
            else:
                status = "ok"
            cal.windows.append((cal.index, cal.current))
            del cal.windows[:-self._max_windows]
            cal.series.append({
                "index": cal.index,
                "error": None if err is None else round(err, 9),
                "status": status,
            })
            del cal.series[:-self._max_windows]
            self._emit("serving_stat_windows_total", 1, model=model,
                       channel="calibration", status=status)
            if status == "miscal":
                with self._lock:  # re-entrant; caller holds it already
                    self._drift_events[model] += 1
                self._emit("stat_drift_events_total", 1, model=model,
                           channel="calibration", detector="calibration")
        cal.current = CalibrationSketch(cal.buckets)
        cal.index = idx

    def _emit(self, name: str, value: int, **labels) -> None:
        if self._registry is not None:
            self._registry.counter(name).inc(value, **labels)

    # ── reads ───────────────────────────────────────────────────────────

    def state_dict(self) -> dict:
        """The raw, JSON-able monitor state — everything
        :func:`stat_health_report` derives from, models sorted and
        channels in fixed order so equal state serializes to equal
        bytes."""
        with self._lock:
            models = {}
            for m in sorted(self._channels):
                chans = {}
                for ch_name in CHANNELS:
                    ch = self._channels[m][ch_name]
                    chans[ch_name] = {
                        "total": ch.total.to_dict(),
                        "current": {
                            "index": ch.index,
                            "sketch": ch.current.to_dict(),
                        },
                        "windows": [
                            {"index": i, "sketch": s.to_dict()}
                            for i, s in ch.windows
                        ],
                        "series": [dict(e) for e in ch.series],
                    }
                cal = self._calibration[m]
                models[m] = {
                    "rows": self._rows[m],
                    "channels": chans,
                    "calibration": {
                        "enabled": self._calibration_cols is not None,
                        "total": cal.total.to_dict(),
                        "current": {
                            "index": cal.index,
                            "sketch": cal.current.to_dict(),
                        },
                        "windows": [
                            {"index": i, "sketch": s.to_dict()}
                            for i, s in cal.windows
                        ],
                        "series": [dict(e) for e in cal.series],
                    },
                }
            return {
                "schema_version": STAT_HEALTH_SCHEMA_VERSION,
                "window_s": self.window_s,
                "bins": self._bins,
                "thresholds": {
                    "psi": self._psi_threshold,
                    "ks": self._ks_threshold,
                    "calibration": self._calibration_threshold,
                    "min_count": self._min_count,
                },
                "models": models,
            }

    def health(self) -> dict:
        """The compact form ``/healthz``, ``/varz`` neighbours and the
        ``stats`` wire op embed."""
        with self._lock:
            models = {}
            for m in sorted(self._channels):
                chans = {}
                for ch_name in CHANNELS:
                    ch = self._channels[m][ch_name]
                    chans[ch_name] = {
                        "count": ch.total.total(),
                        "windows": len(ch.series),
                        "last_status": (
                            ch.series[-1]["status"] if ch.series else None
                        ),
                    }
                cal = self._calibration[m]
                models[m] = {
                    "rows": self._rows[m],
                    "drift_events": self._drift_events[m],
                    "channels": chans,
                    "calibration": {
                        "enabled": self._calibration_cols is not None,
                        "count": cal.total.total(),
                        "last_status": (
                            cal.series[-1]["status"] if cal.series else None
                        ),
                    },
                }
            return {"window_s": self.window_s, "models": models}


# ── the pure report (daemon dump == analyzer recompute, bit for bit) ───


def _summarize_channel(ch_state: dict) -> dict:
    total = FixedBinSketch.from_dict(ch_state["total"])
    series = ch_state["series"]
    psis = [e["psi"] for e in series if e.get("psi") is not None]
    kss = [e["ks"] for e in series if e.get("ks") is not None]
    statuses = [e["status"] for e in series]
    return {
        "count": total.total(),
        "underflow": total.underflow,
        "overflow": total.overflow,
        "nan": total.nan,
        "p50": _round9(total.quantile(0.5)),
        "p90": _round9(total.quantile(0.9)),
        "windows": len(series),
        "ok": statuses.count("ok"),
        "drift": statuses.count("drift"),
        "sparse": statuses.count("sparse"),
        "worst_psi": _round9(max(psis)) if psis else None,
        "worst_ks": _round9(max(kss)) if kss else None,
        "last_status": statuses[-1] if statuses else None,
    }


def _summarize_calibration(cal_state: dict) -> dict:
    total = CalibrationSketch.from_dict(cal_state["total"])
    series = cal_state["series"]
    errors = [e["error"] for e in series if e.get("error") is not None]
    statuses = [e["status"] for e in series]
    return {
        "enabled": bool(cal_state["enabled"]),
        "count": total.total(),
        "error": _round9(total.calibration_error()),
        "windows": len(series),
        "ok": statuses.count("ok"),
        "miscal": statuses.count("miscal"),
        "sparse": statuses.count("sparse"),
        "worst_error": _round9(max(errors)) if errors else None,
        "last_status": statuses[-1] if statuses else None,
    }


def _round9(v):
    return None if v is None else round(float(v), 9)


def stat_health_report(state: dict) -> dict:
    """The full ``stat_health.json`` payload as a PURE function of the
    monitor's raw state: the daemon's dump calls exactly this, so a
    reader recomputes the file bit for bit from the raw state it embeds
    verbatim."""
    summary = {}
    drifted = []
    events = 0
    for m in sorted(state["models"]):
        ms = state["models"][m]
        chans = {}
        for ch_name in CHANNELS:
            chans[ch_name] = _summarize_channel(ms["channels"][ch_name])
            if chans[ch_name]["last_status"] == "drift":
                drifted.append(f"{m}:{ch_name}")
            events += chans[ch_name]["drift"]
        cal = _summarize_calibration(ms["calibration"])
        if cal["last_status"] == "miscal":
            drifted.append(f"{m}:calibration")
        events += cal["miscal"]
        summary[m] = {
            "rows": ms["rows"],
            "channels": chans,
            "calibration": cal,
        }
    return {
        "schema_version": STAT_HEALTH_SCHEMA_VERSION,
        "state": state,
        "summary": summary,
        "drift": {"events": events, "drifted": drifted},
    }


def write_stat_health(outdir: str, state: dict) -> dict:
    """THE one write recipe for ``stat_health.json``: the same bytes for
    the same state."""
    import os

    from ate_replication_causalml_torch.observability.export import atomic_write_json

    report = stat_health_report(state)
    atomic_write_json(os.path.join(outdir, STAT_HEALTH_BASENAME), report)
    return report


def render_summary(report: dict) -> str:
    """One line per model, for a human reader."""
    lines = []
    for m, ms in sorted(report["summary"].items()):
        chans = ms["channels"]
        bits = ", ".join(
            f"{ch}: {c['count']} obs / {c['windows']} win"
            f" ({c['drift']} drift)"
            for ch, c in chans.items()
        )
        lines.append(f"stat_health[{m}]: rows {ms['rows']} — {bits}")
    d = report["drift"]
    lines.append(
        f"stat_health: {d['events']} drift event(s), "
        f"currently drifted: {d['drifted'] or 'none'}"
    )
    return "\n".join(lines)
