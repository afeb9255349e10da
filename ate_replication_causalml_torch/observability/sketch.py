"""Deterministic, mergeable streaming sketches.

Port of ``ate_replication_causalml_tpu/observability/sketch.py``, the
same classes, statistics and JSON bytes. Two fixed-shape sketches back
the statistical-health plane:

* :class:`FixedBinSketch`: a fixed-edge histogram over ``[lo, hi)``
  with explicit underflow/overflow/NaN tails. State is INTEGER counts
  only (no float accumulators), so merge is exactly associative and
  commutative, the empty sketch is a true identity, and the result is
  independent of insertion order: per-daemon sketches merge fleet-wide
  without a coordinator or a seed.
* :class:`CalibrationSketch`: fixed buckets over predicted probability
  ``[0, 1]`` carrying ``(count, positives)`` integer pairs per bucket.
  Reliability is read against the bucket midpoint rather than a float
  mean-of-predictions, for the same exact-merge reason.

Window-pair drift statistics over :class:`FixedBinSketch` pairs:

* :func:`psi`: population stability index with Laplace-style ``+0.5``
  smoothing per cell (the classic "PSI > 0.25 means the population
  moved" screening statistic).
* :func:`ks_statistic`: the two-sample Kolmogorov–Smirnov ``D`` over
  the binned CDFs (a lower bound on the exact-sample ``D``; exact when
  the distributions are supported on the bin edges).

:meth:`FixedBinSketch.update` bins a sequence or array in one
vectorized pass (``np.searchsorted`` on the same interior edges,
``side="right"``: the ``bisect_right`` convention), which gives the JAX
package's element-loop counts. Host-side only: nothing here touches a
tensor.
"""

from __future__ import annotations

import json
import math

import numpy as np

SKETCH_SCHEMA_VERSION = 1

# Laplace smoothing mass added per cell before the PSI log-ratio —
# keeps empty cells finite while leaving the statistic deterministic
# (an integer-count function, not an estimator with a seed).
_PSI_SMOOTH = 0.5


class FixedBinSketch:
    """Fixed-edge integer histogram with explicit tails.

    ``n_bins`` uniform bins over ``[lo, hi)``; values below ``lo``
    count into ``underflow``, values at/above ``hi`` into ``overflow``,
    NaNs into ``nan`` (NaN has no distributional location, so it is
    mass-conserved but excluded from quantiles/PSI/KS).
    """

    __slots__ = ("lo", "hi", "n_bins", "counts", "underflow", "overflow",
                 "nan", "_edges", "_width")

    def __init__(self, lo: float, hi: float, n_bins: int):
        if not (n_bins >= 1 and math.isfinite(lo) and math.isfinite(hi)
                and lo < hi):
            raise ValueError(
                f"FixedBinSketch wants finite lo < hi and n_bins >= 1, "
                f"got lo={lo} hi={hi} n_bins={n_bins}"
            )
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_bins = int(n_bins)
        self.counts = [0] * self.n_bins
        self.underflow = 0
        self.overflow = 0
        self.nan = 0
        self._width = (self.hi - self.lo) / self.n_bins
        # Interior edges only: bin i covers [edges[i-1], edges[i]) with
        # the closed/open convention fixed by searchsorted(side="right")
        # (bisect_right's), so a value exactly on an edge lands
        # deterministically in the right bin.
        self._edges = np.asarray([self.lo + i * self._width
                                  for i in range(1, self.n_bins)], np.float64)

    # ── accumulation ────────────────────────────────────────────────────

    def update(self, values) -> None:
        """Fold a sequence or array of numbers in, in one vectorized
        pass."""
        v = np.asarray(values, dtype=np.float64).ravel()
        nan = np.isnan(v)
        under = v < self.lo
        over = v >= self.hi
        self.nan += int(nan.sum())
        self.underflow += int(under.sum())
        self.overflow += int(over.sum())
        inside = v[~(nan | under | over)]
        if inside.size:
            idx = np.searchsorted(self._edges, inside, side="right")
            for i, c in enumerate(np.bincount(idx, minlength=self.n_bins).tolist()):
                self.counts[i] += c

    def add(self, value: float) -> None:
        self.update(np.array([value]))

    # ── merge algebra ───────────────────────────────────────────────────

    def compatible(self, other: "FixedBinSketch") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.n_bins == other.n_bins)

    def merge(self, other: "FixedBinSketch") -> "FixedBinSketch":
        """Pure merge: a NEW sketch whose counts are the cell-wise sum.
        Associative, commutative, and ``FixedBinSketch(lo, hi, n)`` is
        the identity — integer addition, nothing else."""
        if not self.compatible(other):
            raise ValueError(
                f"merge of incompatible sketches: "
                f"({self.lo},{self.hi},{self.n_bins}) vs "
                f"({other.lo},{other.hi},{other.n_bins})"
            )
        out = FixedBinSketch(self.lo, self.hi, self.n_bins)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.underflow = self.underflow + other.underflow
        out.overflow = self.overflow + other.overflow
        out.nan = self.nan + other.nan
        return out

    # ── reads ───────────────────────────────────────────────────────────

    def total(self) -> int:
        """All mass, NaN included — the conservation total."""
        return self.underflow + self.overflow + self.nan + sum(self.counts)

    def located(self) -> int:
        """Mass with a distributional location (everything but NaN)."""
        return self.underflow + self.overflow + sum(self.counts)

    def cells(self) -> list:
        """The extended count vector ``[underflow, *bins, overflow]`` —
        the common support PSI/KS compare over."""
        return [self.underflow, *self.counts, self.overflow]

    def quantile(self, q: float) -> float | None:
        """Binned quantile of the located mass: underflow reads as
        ``lo``, a bin as its midpoint, overflow as ``hi``. None when
        empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants 0 <= q <= 1, got {q}")
        n = self.located()
        if n == 0:
            return None
        # Smallest cell whose cumulative count reaches rank ceil(q*n),
        # rank at least 1 — the conservative "type 1" inverse CDF.
        rank = max(1, math.ceil(q * n))
        cum = self.underflow
        if cum >= rank:
            return self.lo
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.lo + (i + 0.5) * self._width
        return self.hi

    # ── serialization (byte-stable) ─────────────────────────────────────

    def to_dict(self) -> dict:
        return {
            "kind": "fixed_bin",
            "lo": self.lo,
            "hi": self.hi,
            "n_bins": self.n_bins,
            "counts": list(self.counts),
            "underflow": self.underflow,
            "overflow": self.overflow,
            "nan": self.nan,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FixedBinSketch":
        if d.get("kind") != "fixed_bin":
            raise ValueError(f"not a fixed_bin sketch dict: {d.get('kind')!r}")
        out = cls(d["lo"], d["hi"], d["n_bins"])
        counts = [int(c) for c in d["counts"]]
        if len(counts) != out.n_bins or any(c < 0 for c in counts):
            raise ValueError("fixed_bin counts shape/sign mismatch")
        out.counts = counts
        out.underflow = int(d["underflow"])
        out.overflow = int(d["overflow"])
        out.nan = int(d["nan"])
        if min(out.underflow, out.overflow, out.nan) < 0:
            raise ValueError("fixed_bin tail counts must be >= 0")
        return out

    def to_json(self) -> str:
        """Canonical byte-stable encoding (sorted keys, no whitespace)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "FixedBinSketch":
        return cls.from_dict(json.loads(s))


class CalibrationSketch:
    """Reliability buckets over predicted probability ``[0, 1]``.

    Each bucket carries ``(count, positives)`` integers; the
    calibration error reads predicted as the bucket midpoint, so the
    whole sketch stays an integer-count object with exact merges."""

    __slots__ = ("n_buckets", "counts", "positives", "nan")

    def __init__(self, n_buckets: int = 10):
        if n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
        self.n_buckets = int(n_buckets)
        self.counts = [0] * self.n_buckets
        self.positives = [0] * self.n_buckets
        self.nan = 0

    def update(self, predicted, outcomes) -> None:
        """Fold paired iterables: predicted probability and the binary
        empirical outcome (anything truthy counts positive). Predicted
        values are clamped to [0, 1]; NaN predictions are mass-counted
        but carry no bucket."""
        n = self.n_buckets
        for p, y in zip(predicted, outcomes):
            p = float(p)
            if math.isnan(p):
                self.nan += 1
                continue
            b = min(n - 1, max(0, int(min(1.0, max(0.0, p)) * n)))
            self.counts[b] += 1
            if y:
                self.positives[b] += 1

    def merge(self, other: "CalibrationSketch") -> "CalibrationSketch":
        if self.n_buckets != other.n_buckets:
            raise ValueError(
                f"merge of incompatible calibration sketches: "
                f"{self.n_buckets} vs {other.n_buckets} buckets"
            )
        out = CalibrationSketch(self.n_buckets)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.positives = [a + b
                         for a, b in zip(self.positives, other.positives)]
        out.nan = self.nan + other.nan
        return out

    def total(self) -> int:
        return self.nan + sum(self.counts)

    def located(self) -> int:
        return sum(self.counts)

    def calibration_error(self) -> float | None:
        """Expected calibration error against bucket midpoints:
        ``Σ_b (n_b / N) · |midpoint_b − positives_b / n_b|``. None when
        no located mass."""
        n = self.located()
        if n == 0:
            return None
        err = 0.0
        for b, (c, pos) in enumerate(zip(self.counts, self.positives)):
            if c == 0:
                continue
            mid = (b + 0.5) / self.n_buckets
            err += (c / n) * abs(mid - pos / c)
        return err

    def to_dict(self) -> dict:
        return {
            "kind": "calibration",
            "n_buckets": self.n_buckets,
            "counts": list(self.counts),
            "positives": list(self.positives),
            "nan": self.nan,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationSketch":
        if d.get("kind") != "calibration":
            raise ValueError(
                f"not a calibration sketch dict: {d.get('kind')!r}"
            )
        out = cls(d["n_buckets"])
        counts = [int(c) for c in d["counts"]]
        positives = [int(p) for p in d["positives"]]
        if (len(counts) != out.n_buckets
                or len(positives) != out.n_buckets
                or any(c < 0 for c in counts)
                or any(p < 0 for p in positives)
                or any(p > c for c, p in zip(counts, positives))):
            raise ValueError("calibration counts/positives mismatch")
        out.counts = counts
        out.positives = positives
        out.nan = int(d["nan"])
        if out.nan < 0:
            raise ValueError("calibration nan count must be >= 0")
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "CalibrationSketch":
        return cls.from_dict(json.loads(s))


# ── window-pair drift statistics ────────────────────────────────────────


def _check_pair(a: FixedBinSketch, b: FixedBinSketch) -> None:
    if not a.compatible(b):
        raise ValueError("drift statistics want sketches over the same "
                         "edges; merge-compatible pairs only")


def psi(a: FixedBinSketch, b: FixedBinSketch) -> float:
    """Population stability index between two compatible sketches over
    the extended cells (underflow + bins + overflow), with ``+0.5``
    smoothing per cell so empty cells stay finite. ``>= 0``, exactly
    ``0.0`` when the smoothed cell fractions coincide."""
    _check_pair(a, b)
    ca, cb = a.cells(), b.cells()
    k = len(ca)
    ta = sum(ca) + _PSI_SMOOTH * k
    tb = sum(cb) + _PSI_SMOOTH * k
    out = 0.0
    for na, nb in zip(ca, cb):
        pa = (na + _PSI_SMOOTH) / ta
        pb = (nb + _PSI_SMOOTH) / tb
        out += (pa - pb) * math.log(pa / pb)
    # Guard the tiny negative float residue when the distributions
    # coincide to rounding.
    return max(0.0, out)


def ks_statistic(a: FixedBinSketch, b: FixedBinSketch) -> float:
    """Two-sample KS ``D`` over the binned CDFs: the max absolute gap
    between cumulative located fractions across the extended cells.
    ``0.0`` when either side is empty (no evidence, not a fit)."""
    _check_pair(a, b)
    ca, cb = a.cells(), b.cells()
    na, nb = sum(ca), sum(cb)
    if na == 0 or nb == 0:
        return 0.0
    d = 0.0
    cum_a = cum_b = 0
    for xa, xb in zip(ca, cb):
        cum_a += xa
        cum_b += xb
        d = max(d, abs(cum_a / na - cum_b / nb))
    return d
