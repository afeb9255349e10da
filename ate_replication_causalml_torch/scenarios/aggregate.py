"""Streaming aggregates of the scenario matrix.

Port of ``ate_replication_causalml_tpu/scenarios/aggregate.py``. Each
column's coverage, bias, RMSE and power are folded as sufficient
statistics on the device: a width-W batch returns one fixed-length f32
stat vector (:data:`N_STATS` sums: counts, Σerr, Σerr², cover hits,
reject hits, error-histogram cells), so the host sees O(1) bytes a block
and the journal O(blocks) records.

Exactness: :func:`batch_stats` is the one epilogue. The streaming
callable (:func:`aggregate_executable`: ``batch_stats`` of the column's
lanes) and the reference fold over materialized rows
(:func:`fold_rows`) call the same torch function, and every W-lane sum
in it is :func:`~..ops.linalg.fixed_sum`'s, whose order depends on
neither the device nor the shape: the streaming state equals the fold
of the rows bit for bit, on the card and on the CPU alike. (In the JAX
package the equality rests on XLA fusing the epilogue the same way in
both executables, which it does not always do.)

* Every stat is a plain per-lane sum with masked lanes excluded by
  ``where`` (never by multiplying: ``0·NaN`` is NaN), so block states
  merge by addition on the host (:meth:`AggState.merge`), in declared
  block order, in float64.
* The fold must chunk rows into the same width-W blocks the streaming
  run dispatched (``fold_rows(..., width=W)``): f32 sums depend on the
  segments.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ate_replication_causalml_torch.observability.sketch import (
    CalibrationSketch,
    FixedBinSketch,
)
from ate_replication_causalml_torch.ops.linalg import fixed_sum
from ate_replication_causalml_torch.scenarios.batched import (
    ScenarioEstimator,
    cached_executable,
    column_cache_key,
    lane_outputs,
)
from ate_replication_causalml_torch.scenarios.dgp import DGPSpec

#: bump when the stat-vector layout or the epilogue numerics change. The
#: JAX package's tag: it rides the checkpoint fingerprint and every
#: block record's ``schema`` field.
AGG_SCHEMA_TAG = "scenarios-agg-v1"

#: 95% normal critical value (estimators.base.Z_95).
Z95 = 1.96

#: Error-sketch shape shared with the rows-mode column aggregates and
#: the serving stat-health plane.
ERROR_SKETCH_RANGE = (-8.0, 8.0)
ERROR_SKETCH_BINS = 8

#: Stat-vector layout, fixed order: 8 moment/count sums, then the error
#: histogram's extended cells ``[underflow, *bins, overflow]``.
STAT_FIELDS = (
    "n_cells",      # unmasked lanes dispatched
    "n_ok",         # finite point estimate
    "n_se",         # finite point estimate AND finite SE
    "sum_err",      # Σ (ate - tau_true)        over ok lanes
    "sum_err2",     # Σ (ate - tau_true)²       over ok lanes
    "sum_tau",      # Σ tau_true                over ok lanes
    "cover_hits",   # Σ 1[|ate - tau| <= z·se]  over se lanes
    "reject_hits",  # Σ 1[|ate| > z·se]         over se lanes
)
N_STATS = len(STAT_FIELDS) + ERROR_SKETCH_BINS + 2


def batch_stats(ate: torch.Tensor, se: torch.Tensor, tau_true: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """The segment-reduce epilogue: ``(W,) × 4 -> (N_STATS,)`` f32, on
    the inputs' device. ``mask`` marks the real lanes. Every sum is
    :func:`fixed_sum`'s, so the vector's bits depend only on the lanes'
    values: the streaming path and the fold of the same rows agree."""
    dtype = ate.dtype
    zero = torch.zeros((), dtype=dtype, device=ate.device)
    live = mask != 0
    ok = live & torch.isfinite(ate)
    has_se = ok & torch.isfinite(se)
    z = torch.tensor(Z95, dtype=dtype, device=ate.device)
    err = torch.where(ok, ate - tau_true, zero)
    covered = has_se & (ate - z * se <= tau_true) & (tau_true <= ate + z * se)
    rejected = has_se & (torch.abs(ate) > z * se)

    def count(flags):
        return fixed_sum(flags.to(dtype))

    lo, hi = ERROR_SKETCH_RANGE
    width = (hi - lo) / ERROR_SKETCH_BINS
    # Extended-cell index: -1 underflow, n_bins overflow (FixedBinSketch
    # cells); clamped in float first, so a huge error saturates.
    idx = torch.clamp(torch.floor((err - lo) / torch.tensor(width, dtype=dtype, device=ate.device)),
                      -1, ERROR_SKETCH_BINS).to(torch.int32)
    hist = [count(ok & (idx == cell - 1)) for cell in range(ERROR_SKETCH_BINS + 2)]
    return torch.stack([
        count(live), count(ok), count(has_se),
        fixed_sum(torch.where(ok, err, zero)),
        fixed_sum(torch.where(ok, err * err, zero)),
        fixed_sum(torch.where(ok, tau_true, zero)),
        count(covered), count(rejected), *hist,
    ])


@dataclasses.dataclass(frozen=True)
class AggState:
    """One column's merged sufficient statistics: what a streaming block
    journals and a resumed run merges again. Host-side float64; merge is
    addition in declared block order."""

    stats: tuple[float, ...]

    def __post_init__(self) -> None:
        if len(self.stats) != N_STATS:
            raise ValueError(f"AggState wants {N_STATS} stats, got {len(self.stats)}")

    @classmethod
    def zero(cls) -> "AggState":
        return cls((0.0,) * N_STATS)

    @classmethod
    def from_array(cls, arr) -> "AggState":
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        return cls(tuple(float(v) for v in np.asarray(arr).reshape(-1)))

    def merge(self, other: "AggState") -> "AggState":
        return AggState(tuple(a + b for a, b in zip(self.stats, other.stats)))

    def __getattr__(self, name: str):
        try:
            return self.stats[STAT_FIELDS.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def hist_cells(self) -> list[int]:
        """``[underflow, *bins, overflow]`` as exact ints."""
        return [int(v) for v in self.stats[len(STAT_FIELDS):]]

    def summary(self, nominal: float = 0.95) -> dict:
        """The per-column aggregate dict, schema-compatible with the rows
        mode's ``column_aggregates`` (coverage, power, bias, RMSE, MC-SE
        and the mergeable sketches), from sums."""
        n_cells = int(self.n_cells)
        n_ok = int(self.n_ok)
        n_se = int(self.n_se)
        out: dict = {
            "n_cells": n_cells,
            "n_ok": n_ok,
            "n_failed": n_cells - n_ok,
            "coverage": None,
            "power": None,
            "bias": None,
            "rmse": None,
            "coverage_mc_se": None,
            "nominal": nominal,
        }
        if n_ok:
            out["bias"] = self.sum_err / n_ok
            out["rmse"] = math.sqrt(max(0.0, self.sum_err2 / n_ok))
            out["mean_tau_true"] = self.sum_tau / n_ok
        if n_se:
            out["coverage"] = self.cover_hits / n_se
            out["power"] = self.reject_hits / n_se
            out["coverage_mc_se"] = math.sqrt(nominal * (1.0 - nominal) / n_se)
        err_sketch = FixedBinSketch(*ERROR_SKETCH_RANGE, ERROR_SKETCH_BINS)
        cells = self.hist_cells()
        err_sketch.underflow = cells[0]
        err_sketch.overflow = cells[-1]
        err_sketch.counts = cells[1:-1]
        cov_sketch = CalibrationSketch()
        if n_se:
            # Every se-lane is one (predicted=nominal, covered) pair.
            bucket = min(cov_sketch.n_buckets - 1, int(nominal * cov_sketch.n_buckets))
            cov_sketch.counts[bucket] = n_se
            cov_sketch.positives[bucket] = int(self.cover_hits)
        out["sketches"] = {"error": err_sketch.to_dict(), "coverage": cov_sketch.to_dict()}
        return out


# ── callables ────────────────────────────────────────────────────────


def aggregate_executable(spec: DGPSpec, est: ScenarioEstimator, width: int, column: str = ""):
    """The column's one streaming callable: ``exe(root_key, cell_ids[W],
    mask[W]) -> stats[N_STATS]`` (on the root key's device):
    :func:`batch_stats` of the column's lanes, so a block's W rows never
    reach the host. One per column a process, ``kind="aggregate"``."""
    if not est.vmapped:
        raise ValueError(
            f"estimator {est.name!r} is not vmappable — fold its eager "
            "cells host-side through fold_rows instead"
        )
    key = column_cache_key(spec, est.name, width) + ("agg",)

    def build():
        def exe(root_key, ids, mask):
            if len(ids) != width:
                raise ValueError(f"column built for width {width}, got {len(ids)} ids")
            ate, se, tau_true = lane_outputs(spec, est, root_key, ids)
            return batch_stats(ate, se, tau_true, torch.as_tensor(mask).to(ate.device))

        return exe

    return cached_executable(key, build, column or f"{spec.name}:{est.name}", "aggregate")


def fold_executable(width: int, dtype: str = "float32"):
    """The reference fold: the same :func:`batch_stats` over width-W row
    arrays (numpy, folded on the CPU: the epilogue's bits do not depend
    on the device). One a width, shared across columns."""
    key = ("scenario-agg-fold", width, dtype)

    def build():
        def exe(ate, se, tau, mask):
            t = [torch.as_tensor(np.asarray(a, dtype=dtype)) for a in (ate, se, tau, mask)]
            return batch_stats(*t)

        return exe

    return cached_executable(key, build, f"fold:w{width}", "aggregate_fold")


def fold_rows(rows, width: int, dtype: str = "float32") -> AggState:
    """Fold materialized ``(ate, se, tau_true)`` triples into an
    :class:`AggState` through :func:`fold_executable`, chunked into the
    width-W mask-padded blocks a streaming run dispatches. ``rows`` is an
    iterable of 3-tuples in replicate order."""
    rows = list(rows)
    exe = fold_executable(width, dtype)
    state = AggState.zero()
    np_dtype = np.dtype(dtype)
    for i in range(0, len(rows), width):
        chunk = rows[i:i + width]
        pad = width - len(chunk)
        ate = np.asarray([r[0] for r in chunk] + [0.0] * pad, np_dtype)
        se = np.asarray([r[1] for r in chunk] + [0.0] * pad, np_dtype)
        tau = np.asarray([r[2] for r in chunk] + [0.0] * pad, np_dtype)
        mask = np.asarray([1.0] * len(chunk) + [0.0] * pad, np_dtype)
        state = state.merge(AggState.from_array(exe(ate, se, tau, mask)))
    return state
