"""Adversarial failure-frontier search over the DGP knob space.

Port of ``ate_replication_causalml_tpu/scenarios/frontier.py``. The
matrix answers "how do these estimators do on THESE designs"; the
frontier asks where each estimator's coverage collapses, and what the
minimal knob vector that breaks it is: a seeded refinement loop over the
``overlap × confounding`` corner (η → 0 under strong γ, the
overlap-violation regime of arXiv:1604.07125) and the ``dimension ×
sparsity`` edge (dense coefficients against the approximate-sparsity
premise of arXiv:1201.0224).

* **probes are streaming blocks** through the column's
  :func:`~.aggregate.aggregate_executable`, merged host-side as
  :class:`~.aggregate.AggState`;
* **MC-SE-aware acquisition** — a probe starts at ``n_reps``; when the
  coverage deficit exceeds ``refine_z`` binomial MC standard errors it
  extends to ``refine_reps`` (new blocks appended); the verdict is
  ``failing`` iff the deficit exceeds ``fail_z`` MC-SEs;
* **ddmin shrinking** — every failing knob vector is delta-debugged
  (:func:`~..resilience.campaign.ddmin`) to a 1-minimal set of deltas
  from the baseline that still fails, confirmed by one fresh probe and
  recorded with a one-line repro (which names this package's module);
* **resumable** — probe blocks journal to ``frontier.jsonl`` through the
  pipeline's ``_Checkpoint``; ``FAILURE_ATLAS.json`` is written with
  sorted keys and no wall-clock, so the same root seed gives the same
  bytes, resumed or straight through. Fingerprints and schema tags are
  the JAX package's.

The search runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Callable

import numpy as np

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.scenarios.aggregate import (
    AggState,
    N_STATS,
    aggregate_executable,
)
from ate_replication_causalml_torch.scenarios.batched import (
    SCENARIO_ESTIMATORS,
    batch_mask,
    pad_ids,
)
from ate_replication_causalml_torch.scenarios.dgp import DGPSpec

#: bump when the probe-record layout, the acquisition rule or the atlas
#: schema change — old frontier journals must not resume new searches.
FRONTIER_SCHEMA_TAG = "scenarios-frontier-v1"

#: DGPSpec fields a frontier axis may vary, with the caster that keeps
#: journal/atlas values and DGPSpec construction in exact agreement.
KNOB_FIELDS: dict[str, Callable] = {
    "n": int, "p": int, "sparsity": int,
    "confounding": float, "overlap": float, "tau_scale": float,
}


def _probes_counter():
    return obs.counter(
        "scenario_frontier_probes_total",
        "frontier probe blocks by estimator and computed/resumed status",
    )


@dataclasses.dataclass(frozen=True)
class FrontierAxis:
    """One named failure surface: a small set of DGP knobs and the grid
    values each takes (declared order IS probe/atlas order). The grid
    is the cartesian product — corners are where the literature's
    failure modes live, and interior points give the surface its MC
    error-banded shape."""

    name: str
    knobs: tuple[tuple[str, tuple[float, ...]], ...]

    def __post_init__(self) -> None:
        for knob, values in self.knobs:
            if knob not in KNOB_FIELDS:
                raise ValueError(
                    f"axis {self.name!r}: unknown knob {knob!r}; "
                    f"known: {sorted(KNOB_FIELDS)}"
                )
            if not values:
                raise ValueError(
                    f"axis {self.name!r}: knob {knob!r} has no values"
                )

    def points(self) -> list[dict]:
        """Knob vectors in declared cartesian order."""
        names = [k for k, _ in self.knobs]
        grids = [v for _, v in self.knobs]
        return [
            dict(zip(names, combo))
            for combo in itertools.product(*grids)
        ]


@dataclasses.dataclass(frozen=True)
class FrontierSpec:
    """The whole search: baseline design, axes, estimators, replicate
    policy and the acquisition thresholds. ``n_reps`` is the initial
    probe budget; probes whose coverage deficit exceeds ``refine_z``
    MC-SEs extend to ``refine_reps``; ``fail_z`` MC-SEs at the final
    count is the failure verdict."""

    axes: tuple[FrontierAxis, ...]
    estimators: tuple[str, ...]
    baseline: DGPSpec
    n_reps: int = 64
    refine_reps: int = 192
    batch_width: int = 32
    seed: int = 0
    nominal: float = 0.95
    fail_z: float = 4.0
    refine_z: float = 2.0

    def __post_init__(self) -> None:
        for name in self.estimators:
            est = SCENARIO_ESTIMATORS.get(name)
            if est is None:
                raise ValueError(f"unknown scenario estimator {name!r}")
            if not est.vmapped:
                raise ValueError(
                    f"frontier probes stream through the vmapped "
                    f"aggregate executable; {name!r} is not vmappable"
                )
        if self.refine_reps < self.n_reps:
            raise ValueError("refine_reps must be >= n_reps")

    def width(self) -> int:
        """One probe-block width for the WHOLE search (initial and
        refined probes alike): refinement extends a probe by appending
        blocks, and f32 merges are segment-dependent — changing width
        mid-probe would break both block reuse and bit-determinism."""
        return min(self.batch_width, self.n_reps)

    def fingerprint(self) -> str:
        """Journal resume validity. Replicate counts stay OUT (the
        extend-reps contract: raising budgets resumes completed
        blocks); the block width is IN (blocks of different widths can
        never merge bit-exactly)."""
        axes = ";".join(f"{a.name}={a.knobs!r}" for a in self.axes)
        return (
            f"{FRONTIER_SCHEMA_TAG}|base={self.baseline.fields()!r}"
            f"|axes=[{axes}]|est={list(self.estimators)!r}"
            f"|seed={self.seed}|w={self.width()}"
            f"|nominal={self.nominal!r}|fz={self.fail_z!r}"
            f"|rz={self.refine_z!r}"
        )


def knobs_id(knobs: dict) -> str:
    """Canonical order-free identity of a knob vector — the journal /
    probe-cache / repro vocabulary. ``%g`` formatting round-trips every
    grid value exactly (ints stay ints, 0.02 stays 0.02)."""
    return ",".join(f"{k}={knobs[k]:g}" for k in sorted(knobs))


def parse_knobs(text: str) -> dict:
    """Inverse of :func:`knobs_id` (the ``--repro --knobs`` operand)."""
    out: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if k not in KNOB_FIELDS:
            raise ValueError(f"unknown frontier knob {k!r}")
        out[k] = KNOB_FIELDS[k](float(v))
    return out


def dgp_for(baseline: DGPSpec, knobs: dict) -> DGPSpec:
    """The probed design: baseline with the knob deltas applied. The
    name encodes the deltas — DGP names are the cell-id/executable-key
    namespace, so distinct knob vectors must never collide."""
    deltas = {k: KNOB_FIELDS[k](v) for k, v in knobs.items()}
    name = f"fr({knobs_id(knobs)})" if knobs else f"fr(base:{baseline.name})"
    return dataclasses.replace(baseline, name=name, **deltas)


def probe_row_id(est_name: str, knobs: dict, batch: tuple[int, ...]) -> str:
    return f"probe:{est_name}|{knobs_id(knobs)}|r{batch[0]}-{batch[-1]}"


def _probe_resumable(rec: dict) -> bool:
    if rec.get("schema") != FRONTIER_SCHEMA_TAG:
        return False
    if rec.get("status", "ok") != "ok":
        return False
    stats = rec.get("stats")
    if not isinstance(stats, list) or len(stats) != N_STATS:
        return False
    return all(
        isinstance(v, (int, float)) and math.isfinite(v) for v in stats
    )


class FrontierSearch:
    """The seeded search loop. One instance per run; every probe result
    is cached by ``(estimator, knob vector, reps)``, so the ddmin
    shrinker re-probes each candidate subset at most once and the
    full-vector seed probe is free."""

    def __init__(self, spec: FrontierSpec, ckpt=None,
                 log: Callable[[str], None] = print, device=None):
        self.spec = spec
        self.ckpt = ckpt
        self.log = log
        self.root_key = rnd.key(spec.seed, device=resolve_device(device))
        self.cache: dict[tuple, AggState] = {}
        self.blocks = 0          # probe blocks folded (computed + resumed)
        self.cells = 0           # probe cells those blocks carried
        self.shrink_probes = 0   # distinct probes the shrinker spent

    # ── probing ───────────────────────────────────────────────────────

    def probe(self, est_name: str, knobs: dict, n_reps: int,
              journal: bool = True) -> AggState:
        """Merged aggregate state of ``n_reps`` replicates of the probed
        column, block-journaled and block-resumable. ``journal=False``
        is the fresh-confirmation/repro path: recompute every block,
        trust nothing."""
        key = (est_name, knobs_id(knobs), n_reps)
        if journal and key in self.cache:
            return self.cache[key]
        spec = self.spec
        est = SCENARIO_ESTIMATORS[est_name]
        dgp = dgp_for(spec.baseline, knobs)
        width = spec.width()
        exe = aggregate_executable(
            dgp, est, width, column=f"frontier:{est_name}:{dgp.name}",
        )
        probes_c = _probes_counter()
        state = AggState.zero()
        for lo in range(0, n_reps, width):
            batch = tuple(range(lo, min(lo + width, n_reps)))
            method = probe_row_id(est_name, knobs, batch)
            rec = self.ckpt.get(method) if (journal and self.ckpt) else None
            if rec is not None and _probe_resumable(rec):
                block = AggState.from_array(np.asarray(rec["stats"]))
                probes_c.inc(1, estimator=est_name, status="resumed")
            else:
                ids = pad_ids(dgp.name, batch, width)
                mask = batch_mask(batch, width, dgp.dtype)
                block = AggState.from_array(exe(self.root_key, ids, mask))
                probes_c.inc(1, estimator=est_name, status="computed")
                if journal and self.ckpt is not None:
                    self.ckpt.put({
                        "method": method,
                        "schema": FRONTIER_SCHEMA_TAG,
                        "estimator": est_name,
                        "knobs": {k: knobs[k] for k in sorted(knobs)},
                        "reps": [batch[0], batch[-1]],
                        "width": width,
                        "status": "ok",
                        "stats": list(block.stats),
                    })
            state = state.merge(block)
            self.blocks += 1
            self.cells += len(batch)
        if journal:
            self.cache[key] = state
        return state

    def verdict(self, state: AggState, n_reps: int) -> dict:
        """Pure classification of one probed state. ``degenerate``
        means no SE-carrying replicate survived (coverage undefined) —
        reported, never silently dropped."""
        spec = self.spec
        summ = state.summary(spec.nominal)
        cov, mc = summ["coverage"], summ["coverage_mc_se"]
        out = {
            "reps": n_reps,
            "n_ok": summ["n_ok"],
            "n_se": int(state.n_se),
            "coverage": cov,
            "mc_se": mc,
            "bias": summ["bias"],
            "rmse": summ["rmse"],
            "power": summ["power"],
        }
        if cov is None:
            out["deficit"] = None
            out["verdict"] = "degenerate"
            return out
        deficit = spec.nominal - cov
        out["deficit"] = deficit
        out["verdict"] = (
            "failing" if deficit > spec.fail_z * mc else "ok"
        )
        return out

    def probe_point(self, est_name: str, knobs: dict) -> dict:
        """One grid cell: initial probe, MC-SE-aware refinement, final
        verdict."""
        spec = self.spec
        state = self.probe(est_name, knobs, spec.n_reps)
        cell = self.verdict(state, spec.n_reps)
        refined = False
        if (
            cell["deficit"] is not None
            and cell["deficit"] > spec.refine_z * cell["mc_se"]
            and spec.refine_reps > spec.n_reps
        ):
            refined = True
            state = self.probe(est_name, knobs, spec.refine_reps)
            cell = self.verdict(state, spec.refine_reps)
        cell["refined"] = refined
        return cell

    # ── shrinking ─────────────────────────────────────────────────────

    def shrink(self, est_name: str, knobs: dict, reps: int) -> dict:
        """ddmin the failing knob vector down to a 1-minimal delta set
        that still fails at the same replicate count, then CONFIRM with
        one fresh un-journaled probe. Atoms are (knob, value) deltas
        from the baseline; knobs already at baseline value contribute
        no atom (they cannot be part of any minimal explanation)."""
        from ate_replication_causalml_torch.resilience.campaign import ddmin

        base = self.spec.baseline
        atoms = sorted(
            (k, v) for k, v in knobs.items()
            if KNOB_FIELDS[k](v) != getattr(base, k)
        )
        probed = [0]

        def fails(subset: list) -> bool:
            sub = dict(subset)
            # A candidate subset can leave the estimator inapplicable
            # (e.g. keeping p=96 while dropping the n knob that made
            # the design estimable) — that is "not this failure", never
            # a probe.
            if not SCENARIO_ESTIMATORS[est_name].applicable(
                dgp_for(base, sub)
            ):
                return False
            key = (est_name, knobs_id(sub), reps)
            if key not in self.cache:
                probed[0] += 1
            state = self.probe(est_name, sub, reps)
            v = self.verdict(state, reps)
            return v["verdict"] == "failing"

        minimal = dict(ddmin(atoms, fails)) if atoms else {}
        self.shrink_probes += probed[0]
        confirm = self.verdict(
            self.probe(est_name, minimal, reps, journal=False), reps,
        )
        repro = (
            "python -m ate_replication_causalml_torch.scenarios.frontier "
            f"--repro --estimator {est_name} "
            f"--knobs '{knobs_id(minimal)}' --reps {reps} "
            f"--seed {self.spec.seed} --n {base.n} "
            f"--batch {self.spec.width()}"
        )
        return {
            "minimal_knobs": {k: minimal[k] for k in sorted(minimal)},
            "confirmed": confirm["verdict"] == "failing",
            "confirm_coverage": confirm["coverage"],
            "repro": repro,
        }


def run_frontier(
    spec: FrontierSpec, outdir: str | None = None,
    log: Callable[[str], None] = print, device=None,
) -> dict:
    """The full search: probe every axis grid cell for every estimator,
    refine where coverage is collapsing, shrink every failure, return
    (and atomically export) the atlas. The atlas carries no wall-clock
    and no resume-history-dependent fields — same root seed, byte-same
    FAILURE_ATLAS.json. Runs on ``device`` (``cuda`` unless told
    otherwise)."""
    from ate_replication_causalml_torch.pipeline import _Checkpoint

    obs.install_monitoring()
    ckpt = None
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        ckpt = _Checkpoint(
            os.path.join(outdir, "frontier.jsonl"),
            spec.fingerprint(), log=log,
        )
    search = FrontierSearch(spec, ckpt=ckpt, log=log, device=device)
    axes_out: list[dict] = []
    failures: list[dict] = []
    with obs.span("run_frontier", axes=len(spec.axes),
                  estimators=len(spec.estimators)):
        for axis in spec.axes:
            cells: list[dict] = []
            for knobs in axis.points():
                for est_name in spec.estimators:
                    dgp = dgp_for(spec.baseline, knobs)
                    est = SCENARIO_ESTIMATORS[est_name]
                    entry: dict = {
                        "estimator": est_name,
                        "knobs": {k: knobs[k] for k in sorted(knobs)},
                    }
                    if not est.applicable(dgp):
                        entry["verdict"] = "skipped"
                        cells.append(entry)
                        continue
                    cell = search.probe_point(est_name, knobs)
                    entry.update(cell)
                    cells.append(entry)
                    if cell["verdict"] != "failing":
                        continue
                    log(
                        f"frontier: {est_name} FAILS at "
                        f"{knobs_id(knobs)} (coverage "
                        f"{cell['coverage']:.3f}, deficit "
                        f"{cell['deficit']:.3f} > "
                        f"{spec.fail_z:g}·{cell['mc_se']:.4f}) — "
                        f"shrinking"
                    )
                    shrunk = search.shrink(est_name, knobs, cell["reps"])
                    failures.append({
                        "estimator": est_name,
                        "axis": axis.name,
                        "knobs": entry["knobs"],
                        "reps": cell["reps"],
                        "coverage": cell["coverage"],
                        "mc_se": cell["mc_se"],
                        **shrunk,
                    })
            axes_out.append({
                "name": axis.name,
                "knobs": {k: list(v) for k, v in axis.knobs},
                "cells": cells,
            })
    atlas = {
        "schema": FRONTIER_SCHEMA_TAG,
        "schema_version": 1,
        "fingerprint": spec.fingerprint(),
        "seed": spec.seed,
        "nominal": spec.nominal,
        "fail_z": spec.fail_z,
        "refine_z": spec.refine_z,
        "n_reps": spec.n_reps,
        "refine_reps": spec.refine_reps,
        "block_width": spec.width(),
        "baseline": {
            f.name: getattr(spec.baseline, f.name)
            for f in dataclasses.fields(spec.baseline)
        },
        "estimators": list(spec.estimators),
        "axes": axes_out,
        "failures": failures,
        "probes": {
            "blocks": search.blocks,
            "cells": search.cells,
            "shrink_probes": search.shrink_probes,
        },
    }
    if outdir:
        obs.atomic_write_json(
            os.path.join(outdir, "FAILURE_ATLAS.json"), atlas,
            sort_keys=True,
        )
        try:
            obs.write_run_artifacts(outdir)
        except Exception as e:  # noqa: BLE001 — telemetry export must
            # not fail the search whose atlas already committed.
            log(f"frontier telemetry export failed: {e!r}")
    log(
        f"frontier: {sum(len(a['cells']) for a in axes_out)} grid cells, "
        f"{len(failures)} failure(s), {search.blocks} probe blocks "
        f"({search.cells} cells)"
    )
    return atlas


# ── stock specs ──────────────────────────────────────────────────────


def default_frontier_spec(seed: int = 0) -> FrontierSpec:
    """The committed-atlas search: both literature axes at full scale.
    Axis A sweeps the overlap-violation corner (arXiv:1604.07125's
    regime) at the baseline n=96, where weak-overlap IPW genuinely
    destabilizes (at large n the logit propensity recovers and the
    corner merely undercovers inside the MC band). Axis B sweeps
    dimension against coefficient density (dense p≫small-sample
    designs — the anti-sparsity stress of arXiv:1201.0224); it pins
    n=256 through a single-valued axis knob so every p stays estimable
    (n > p + 2) — which also makes n part of the shrinker's atom
    vocabulary, so an axis-B failure's minimal vector names BOTH the
    dimension and the sample size it needs."""
    baseline = DGPSpec(
        name="frontier_base", n=96, p=4, tau="constant",
        tau_scale=0.8, confounding=0.0, overlap=0.5, sparsity=0,
    )
    return FrontierSpec(
        axes=(
            FrontierAxis(
                "overlap_confounding",
                (("confounding", (0.0, 2.0, 4.0, 6.0)),
                 ("overlap", (0.5, 0.1, 0.02))),
            ),
            FrontierAxis(
                "dimension_sparsity",
                (("n", (256,)),
                 ("p", (4, 48, 96)), ("sparsity", (0, 4))),
            ),
        ),
        estimators=("ipw_logit", "aipw_logit"),
        baseline=baseline,
        n_reps=64,
        refine_reps=192,
        batch_width=32,
        seed=seed,
    )


def micro_frontier_spec(seed: int = 0) -> FrontierSpec:
    """The tier-1 search: the 2×2 corners of the overlap/confounding
    axis for one estimator — four probed columns, compile budget
    O(4), seconds not minutes, but the same acquisition/shrink/atlas
    machinery end to end (the γ/η interaction still makes the minimal
    failing vector the PAIR of knobs)."""
    baseline = DGPSpec(
        name="frontier_micro_base", n=96, p=4, tau="constant",
        tau_scale=0.8, confounding=0.0, overlap=0.5, sparsity=0,
    )
    return FrontierSpec(
        axes=(
            FrontierAxis(
                "overlap_confounding",
                (("confounding", (0.0, 6.0)),
                 ("overlap", (0.5, 0.02))),
            ),
        ),
        estimators=("ipw_logit",),
        baseline=baseline,
        n_reps=16,
        refine_reps=48,
        batch_width=16,
        seed=seed,
    )


# ── CLI ──────────────────────────────────────────────────────────────


def main(argv: list[str] | None = None) -> dict:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(
        description="Adversarial failure-frontier search")
    ap.add_argument("--out", default=None,
                    help="output directory (frontier.jsonl + "
                    "FAILURE_ATLAS.json + telemetry)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--micro", action="store_true",
                    help="run the tier-1 micro search instead of the "
                    "full committed-atlas search")
    ap.add_argument("--repro", action="store_true",
                    help="replay ONE probe fresh (no journal, no "
                    "cache) and print its verdict as JSON — the "
                    "one-line repro the atlas records per failure")
    ap.add_argument("--estimator", default="ipw_logit")
    ap.add_argument("--knobs", default="",
                    help="comma list k=v of knob deltas from baseline")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--n", type=int, default=None,
                    help="baseline sample size override (repro lines "
                    "pin the atlas baseline's n)")
    ap.add_argument("--batch", type=int, default=None,
                    help="probe block width override (repro lines pin "
                    "the search's width — f32 merges are "
                    "segment-dependent)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    spec = (micro_frontier_spec(seed=args.seed) if args.micro
            else default_frontier_spec(seed=args.seed))
    if args.n is not None:
        spec = dataclasses.replace(
            spec, baseline=dataclasses.replace(spec.baseline, n=args.n))
    if args.batch is not None:
        spec = dataclasses.replace(spec, batch_width=args.batch)

    if args.repro:
        reps = spec.refine_reps if args.reps is None else args.reps
        # Pin the block segmentation exactly: width() floors at n_reps,
        # so a tiny --reps repro must not accidentally shrink the width
        # the failing search used.
        if args.batch is not None:
            spec = dataclasses.replace(
                spec, n_reps=max(spec.n_reps, args.batch))
        search = FrontierSearch(spec, ckpt=None, log=print, device=args.device)
        knobs = parse_knobs(args.knobs)
        state = search.probe(args.estimator, knobs, reps, journal=False)
        verdict = search.verdict(state, reps)
        verdict["estimator"] = args.estimator
        verdict["knobs"] = {k: knobs[k] for k in sorted(knobs)}
        print(_json.dumps(verdict, sort_keys=True))
        return verdict

    return run_frontier(spec, outdir=args.out, device=args.device)


if __name__ == "__main__":
    main()
