"""SLO engine: declared objectives over rolling windows.

Port of ``ate_replication_causalml_tpu/observability/slo.py`` (the
engine, the serving daemon's stock objectives, the per-model fleet
objectives, the statistical-health objectives and the router's). An
:class:`SLO` declares an objective ("99.9% of requests succeed", "99%
finish under 250 ms") and the :class:`SLOEngine`
evaluates it over several rolling windows as a **burn rate**: the rate
the error budget is spent, 1.0 being exactly on budget (the multi-window
burn-rate shape of the SRE workbook).

Sources are registry families:

* ``latency`` SLOs read a :class:`~.registry.BucketHistogram` (good =
  observations in buckets whose upper bound is <= the threshold);
* ``availability`` SLOs read a labeled counter (good = samples matching
  ``good_match``, total = every sample in scope not ignored).

Every window figure is a difference between two :meth:`SLOEngine.tick`
snapshots taken from an injectable clock, so two evaluations over the
same snapshots give the same report.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

from ate_replication_causalml_torch.observability import registry as _registry

#: slo_report layout version (the JAX package's).
SLO_SCHEMA_VERSION = 1

#: Default multi-window ladder (ascending, enforced): 1 min for fast
#: burns, 5 min for sustained ones, 30 min for slow leaks.
DEFAULT_WINDOWS: tuple[float, ...] = (60.0, 300.0, 1800.0)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective over one registry family."""

    name: str
    #: "latency" (bucket histogram + threshold) or "availability"
    #: (labeled counter + good_match).
    kind: str
    #: target good fraction in (0, 1); 0.999 is a 0.1% budget.
    objective: float
    #: source family name in the registry.
    metric: str
    #: rolling windows, seconds, strictly ascending.
    windows_s: tuple[float, ...] = DEFAULT_WINDOWS
    #: latency only: observations <= this are good.
    threshold_s: float | None = None
    #: availability only: the ``k=v`` pairs (comma-separated, all must
    #: match) that mark a sample good.
    good_match: str = "status=ok"
    #: availability only: pairs restricting which samples count at all
    #: (the per-model scope ``model=tenantA``); empty = every sample.
    scope_match: str = ""
    #: availability only: ``|``-separated alternatives of pair groups
    #: that take a sample out of both the totals and the good side.
    ignore_match: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"SLO {self.name}: unknown kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name}: objective must be in (0, 1), "
                             f"got {self.objective}")
        windows = tuple(float(w) for w in self.windows_s)
        if not windows or any(w <= 0 for w in windows) or any(
                b <= a for a, b in zip(windows, windows[1:])):
            raise ValueError(f"SLO {self.name}: windows must be positive and strictly "
                             f"ascending, got {self.windows_s!r}")
        object.__setattr__(self, "windows_s", windows)
        if self.kind == "latency" and self.threshold_s is None:
            raise ValueError(f"SLO {self.name}: latency SLOs need threshold_s")


def default_serving_slos(latency_threshold_s: float = 0.25,
                         windows_s: tuple[float, ...] = DEFAULT_WINDOWS) -> tuple[SLO, ...]:
    """The daemon's stock objectives: 99.9% of requests reach ``ok``
    (rejects and errors spend the budget), 99% of served requests finish
    under the latency threshold."""
    return (
        SLO(name="availability", kind="availability", objective=0.999,
            metric="serving_requests_total", windows_s=windows_s),
        SLO(name="latency", kind="latency", objective=0.99,
            metric="serving_request_seconds", windows_s=windows_s,
            threshold_s=latency_threshold_s),
    )


def fleet_slos(models: tuple[str, ...], objective: float = 0.999,
               windows_s: tuple[float, ...] = DEFAULT_WINDOWS,
               metric: str = "serving_fleet_requests_total") -> tuple[SLO, ...]:
    """One ``fleet:<model>`` availability objective per served model,
    scoped to that model's samples. Shed rejects (the response to a burn)
    and the caller's own errors (bad_request, retired_model) count toward
    neither side, so shedding cannot latch and a malformed-request
    spammer cannot burn a tenant's budget."""
    return tuple(
        SLO(name=f"fleet:{m}", kind="availability", objective=objective,
            metric=metric, windows_s=windows_s, scope_match=f"model={m}",
            good_match="status=ok",
            ignore_match="status=rejected_shed|status=rejected_bad_request"
                         "|status=rejected_retired_model")
        for m in models
    )


def stat_health_slos(models: tuple[str, ...] = ("default",), objective: float = 0.9,
                     windows_s: tuple[float, ...] = DEFAULT_WINDOWS,
                     metric: str = "serving_stat_windows_total") -> tuple[SLO, ...]:
    """Statistical-health objectives over the sealed-window counter the
    :class:`~.stathealth.StatHealthMonitor` emits, two a model:

    * ``stat_drift:<model>``: the fraction of sealed distribution
      windows (cate / covariate / propensity) whose window-pair PSI and
      KS stayed under the drift thresholds. ``sparse`` windows and the
      calibration channel (its own objective) count toward neither side.
    * ``stat_calibration:<model>``: the fraction of sealed calibration
      windows under the reliability threshold; empty, so zero burn,
      while the calibration feed is unarmed.

    The default objective tolerates 1 drifted window in 10
    (``ATE_TPU_STAT_DRIFT_BURN`` overrides)."""
    out = []
    for m in models:
        out.append(SLO(name=f"stat_drift:{m}", kind="availability", objective=objective,
                       metric=metric, windows_s=windows_s, scope_match=f"model={m}",
                       good_match="status=ok",
                       ignore_match="channel=calibration|status=sparse"))
        out.append(SLO(name=f"stat_calibration:{m}", kind="availability",
                       objective=objective, metric=metric, windows_s=windows_s,
                       scope_match=f"channel=calibration,model={m}", good_match="status=ok",
                       ignore_match="status=sparse"))
    return tuple(out)


def router_slos(latency_threshold_s: float = 0.25,
                windows_s: tuple[float, ...] = DEFAULT_WINDOWS) -> tuple[SLO, ...]:
    """The fleet router's objectives, spent on what clients see:

    * ``router:availability``: 99.9% of forwards reach ``ok``. The
      daemons' typed rejects (``outcome=reject``) are the caller's or the
      daemon's budget and count toward neither side; connection errors,
      protocol errors and ``unavailable`` spend it.
    * ``router:latency``: 99% of forwards finish under the threshold,
      over the router-observed e2e histogram (``router_request_seconds``).
    * ``router:failover``: 99% of forwards land on the first ring owner
      (``path=direct``); a burn here means a backend flaps while
      availability still holds."""
    return (
        SLO(name="router:availability", kind="availability", objective=0.999,
            metric="router_requests_total", windows_s=windows_s,
            good_match="outcome=ok", ignore_match="outcome=reject"),
        SLO(name="router:latency", kind="latency", objective=0.99,
            metric="router_request_seconds", windows_s=windows_s,
            threshold_s=latency_threshold_s),
        SLO(name="router:failover", kind="availability", objective=0.99,
            metric="router_request_path_total", windows_s=windows_s,
            good_match="path=direct"),
    )


def _pairs(spec: str) -> tuple[str, ...]:
    return tuple(p for p in spec.split(",") if p)


def _match(label_key: str, pairs: tuple[str, ...]) -> bool:
    """Whether every ``k=v`` pair appears in the canonical label key."""
    present = label_key.split(",")
    return all(p in present for p in pairs)


class SLOEngine:
    """Rolling-window burn-rate evaluation over registry snapshots.

    :meth:`tick` records the current cumulative (good, total) per SLO;
    :meth:`evaluate` ticks once more and differences the history. The
    history is bounded by the longest declared window (plus slack)."""

    def __init__(self, slos: tuple[SLO, ...] | list[SLO] | None = None,
                 registry: _registry.MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.slos = tuple(slos) if slos is not None else default_serving_slos()
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._registry = registry if registry is not None else _registry.REGISTRY
        self._clock = clock
        self._lock = threading.Lock()
        #: (tick_mono, {slo_name: (good, total)}), oldest first.
        self._history: collections.deque = collections.deque()
        longest = max((w for s in self.slos for w in s.windows_s), default=60.0)
        self._retention_s = longest * 1.25 + 1.0

    def _totals(self, slo: SLO) -> tuple[float, float]:
        """Current cumulative ``(good, total)`` for one SLO."""
        m = self._registry.family(slo.metric)
        if m is None:
            return 0.0, 0.0
        if slo.kind == "latency":
            if not isinstance(m, _registry.BucketHistogram):
                raise TypeError(f"SLO {slo.name}: metric {slo.metric!r} is {m.kind}, "
                                "latency SLOs need a bucket_histogram")
            good, total = m.good_total_le(slo.threshold_s)
            return float(good), float(total)
        samples = self._registry.peek(slo.metric) or {}
        scope = _pairs(slo.scope_match)
        ignore_alts = [_pairs(alt) for alt in slo.ignore_match.split("|") if alt]
        good_pairs = scope + _pairs(slo.good_match)
        kept = {k: v for k, v in samples.items()
                if not any(_match(k, alt) for alt in ignore_alts)}
        total = float(sum(v for k, v in kept.items() if _match(k, scope)))
        good = float(sum(v for k, v in kept.items() if _match(k, good_pairs)))
        return good, total

    def tick(self) -> float:
        """Record one snapshot; returns its clock reading. The daemon
        ticks after every dispatched batch."""
        now = self._clock()
        totals = {slo.name: self._totals(slo) for slo in self.slos}
        with self._lock:
            self._history.append((now, totals))
            while self._history and now - self._history[0][0] > self._retention_s:
                self._history.popleft()
        return now

    @staticmethod
    def _baseline(hist, now: float, window_s: float):
        """The snapshot a window differences against: the newest tick at
        or before ``now - window_s``, or the oldest while the window is
        not filled yet (reported as ``actual_s``)."""
        base = hist[0]
        for t, totals in hist:
            if t <= now - window_s:
                base = (t, totals)
            else:
                break
        return base

    def evaluate(self) -> dict:
        """Tick, then render the full ``slo_report`` payload."""
        now = self.tick()
        with self._lock:
            hist = list(self._history)
        slos_out = []
        for slo in self.slos:
            cur_good, cur_total = hist[-1][1][slo.name]
            budget = 1.0 - slo.objective
            windows = []
            worst = 0.0
            for w in slo.windows_s:
                bt, btotals = self._baseline(hist, now, w)
                base_good, base_total = btotals[slo.name]
                d_good = cur_good - base_good
                d_total = cur_total - base_total
                err = max(0.0, 1.0 - d_good / d_total) if d_total > 0 else 0.0
                burn = err / budget
                worst = max(worst, burn)
                windows.append({"window_s": w, "actual_s": round(now - bt, 6),
                                "good": d_good, "total": d_total,
                                "error_rate": round(err, 6), "burn_rate": round(burn, 4)})
            slos_out.append({"name": slo.name, "kind": slo.kind, "objective": slo.objective,
                             "threshold_s": slo.threshold_s, "metric": slo.metric,
                             "windows": windows, "worst_burn_rate": round(worst, 4),
                             "burning": worst > 1.0})
        return {"schema_version": SLO_SCHEMA_VERSION, "slos": slos_out}

    def health(self) -> dict:
        """The compact form the ``stats`` op embeds: per-SLO worst burn
        rate and the overall burning flag."""
        report = self.evaluate()
        return {
            "burning": any(s["burning"] for s in report["slos"]),
            "slos": {s["name"]: {"worst_burn_rate": s["worst_burn_rate"],
                                 "burning": s["burning"]}
                     for s in report["slos"]},
        }
