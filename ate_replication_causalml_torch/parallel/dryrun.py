"""The multi-GPU dry run: every sharded leg on N ranks at tiny shapes.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.
:func:`dryrun_multigpu` spawns N ranks (``parallel/spawn.py``), each
joins the world, and every rank runs :func:`run_legs`:

* ``data`` — the nuisance step on rows sharded over the data axis of a
  (data, boot) mesh: the outcome-model and propensity IRLS fits with
  their X'WX / X'Wz ``all_reduce``d (``ops/glm.py::logistic_glm_sharded``)
  and the AIPW combination over the global rows;
* ``boot`` — the AIPW bootstrap with replicates sharded over the boot
  axis (``ops/bootstrap.py::aipw_bootstrap_se_sharded``);
* ``tree`` — a forest with its trees sharded over every rank
  (``models/forest.py::fit_forest_sharded``), and the causal forest,
  nuisances and little-bag groups sharded the same way;
* ``fold`` — ``cv_glmnet`` with its fold fits sharded over every rank;
* ``run_sweep(use_mesh=True)`` at the campaign's MICRO scale (left out
  with ``sweep=False``, for a caller that runs that sweep itself).

The shapes are the JAX dry run's (128 rows a device, 21 features, a
256-row forest of 2 trees a device, depth 3, 16 bins); ``nfolds`` is the
rank count, at least 2 (a one-fold CV has no training rows). Run it as::

    python -m ate_replication_causalml_torch.parallel.dryrun --ranks 2 \\
        --backend gloo --device cpu
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from ate_replication_causalml_torch.parallel.mesh import (
    BOOT_AXIS,
    DATA_AXIS,
    FOLD_AXIS,
    TREE_AXIS,
    all_gather_cat,
    all_reduce_sum,
    make_mesh,
    use_mesh,
    world_size,
)
from ate_replication_causalml_torch.parallel.multihost import DEFAULT_TIMEOUT_S, rank_device


def nuisance_step_sharded(x, w, y, mesh, axis_name: str = DATA_AXIS):
    """The JAX dry run's ``nuisance_step`` on this rank's rows of a
    row-sharded (x, w, y): the logit outcome model's (mu0, mu1) and the
    logit propensity p, both IRLS fits over every rank's rows, and the
    reference's AIPW τ over the global rows (R's ``na.rm`` on the first
    mean). Returns (tau, p, mu0, mu1), the three vectors this rank's rows."""
    from ate_replication_causalml_torch.estimators.aipw import _control_sign
    from ate_replication_causalml_torch.ops.bootstrap import _est1
    from ate_replication_causalml_torch.ops.glm import logistic_glm_sharded, predict_proba
    from ate_replication_causalml_torch.ops.linalg import add_intercept

    base = add_intercept(x)
    with_w = lambda col: torch.cat([base, col[:, None]], dim=1)
    fit = logistic_glm_sharded(with_w(w), y, mesh, axis_name)
    mu0 = predict_proba(fit.coef, with_w(torch.zeros_like(w)))
    mu1 = predict_proba(fit.coef, with_w(torch.ones_like(w)))
    p = logistic_glm_sharded(base, w, mesh, axis_name).fitted
    est1 = _est1(w, y, p, mu0, mu1, _control_sign("r"))
    ok = ~torch.isnan(est1)
    sums = all_reduce_sum(torch.stack([torch.where(ok, est1, 0.0).sum(), ok.sum().to(x.dtype),
                                       (mu1 - mu0).sum(), torch.tensor(float(x.shape[0]),
                                                                       dtype=x.dtype,
                                                                       device=x.device)]),
                          mesh, axis_name)
    tau = sums[0] / sums[1] + sums[2] / sums[3]
    return tau, p, mu0, mu1


def dryrun_data(n_devices: int, device):
    """The dry run's (x, w, y): 128 rows a device, 21 features, the JAX
    dry run's threefry draws from ``key(0)``."""
    from ate_replication_causalml_torch.ops import random as rnd

    n = 128 * n_devices
    kx, kw, ky = rnd.split(rnd.key(0, device=device), 3).unbind(0)
    x = rnd.normal(kx, (n, 21))
    w = (rnd.uniform(kw, (n,)) < 0.3).to(torch.float32)
    y = (rnd.uniform(ky, (n,)) < 0.4).to(torch.float32)
    return x, w, y


def micro_sweep_config():
    """The campaign's MICRO sweep: 1,200 rows from a 3,000-row pool, 16
    trees of depth 4 in every forest, 600 ADMM iterations, the mesh on."""
    from ate_replication_causalml_torch.data.pipeline import PrepConfig
    from ate_replication_causalml_torch.pipeline import SweepConfig

    return dataclasses.replace(SweepConfig().quick(), prep=PrepConfig(n_obs=1200),
                               synthetic_pool=3000, dr_trees=16, dml_trees=16, cf_trees=16,
                               cf_nuisance_trees=16, forest_depth=4, balance_iters=600,
                               use_mesh=True)


def run_legs(log: Callable[[str], None] = lambda s: None, sweep_out: str | None = None,
             sweep: bool = True) -> dict:
    """Every leg of the dry run on this rank (every rank of the world runs
    it). Returns the rank's summary; raises on a non-finite result. The
    sweep leg (left out when ``sweep`` is False) runs on the default
    (concurrent) engine and writes its journal and report to
    ``sweep_out`` when given."""
    from ate_replication_causalml_torch.data.frame import CausalFrame
    from ate_replication_causalml_torch.models.causal_forest import (
        average_treatment_effect,
        fit_causal_forest,
    )
    from ate_replication_causalml_torch.models.forest import fit_forest_sharded, predict_forest
    from ate_replication_causalml_torch.ops import random as rnd
    from ate_replication_causalml_torch.ops.bootstrap import aipw_bootstrap_se_sharded
    from ate_replication_causalml_torch.ops.lasso import cv_glmnet
    from ate_replication_causalml_torch.parallel import shardio
    from ate_replication_causalml_torch.pipeline import SWEEP_METHODS, run_sweep

    n_dev = world_size()
    dev = rank_device()
    data_ax = 2 if n_dev % 2 == 0 else 1
    boot_ax = n_dev // data_ax
    mesh = make_mesh((DATA_AXIS, BOOT_AXIS), (data_ax, boot_ax))
    x, w, y = dryrun_data(n_dev, dev)

    # data: rows over 'data', the IRLS sums all_reduced.
    rows = shardio.commit((x, w, y), shardio.row_sharding(mesh, x.shape[0]), artifact="dryrun")
    tau, p, mu0, mu1 = nuisance_step_sharded(*(r.local for r in rows), mesh)

    # boot: the vectors gathered whole, replicates over 'boot'.
    whole = [all_gather_cat(v, mesh, DATA_AXIS) for v in (rows[1].local, rows[2].local, p, mu0,
                                                          mu1)]
    with use_mesh(mesh):
        se = aipw_bootstrap_se_sharded(*whole, key=rnd.key(7, device=dev), n_boot=boot_ax * 16,
                                       axis_name=BOOT_AXIS)
    if not (math.isfinite(float(tau)) and math.isfinite(float(se))):
        raise AssertionError(f"dry run: tau {float(tau)}, se {float(se)}")

    # tree: trees over every rank.
    tree_mesh = make_mesh((TREE_AXIS,))
    forest = fit_forest_sharded(x[:256], w[:256], rnd.key(11, device=dev), tree_mesh,
                                n_trees=2 * n_dev, depth=3, n_bins=16)
    vote = predict_forest(forest, x[:256]).vote
    if not bool(torch.isfinite(vote).all()):
        raise AssertionError("dry run: non-finite tree-sharded votes")
    cf_fit = fit_causal_forest(CausalFrame(x=x[:256], w=w[:256], y=y[:256]), n_trees=2 * n_dev,
                               depth=3, nuisance_trees=n_dev, nuisance_depth=3, n_bins=16,
                               mesh=tree_mesh)
    cf_eff = average_treatment_effect(cf_fit)
    if not (math.isfinite(float(cf_eff.estimate)) and math.isfinite(float(cf_eff.std_err))):
        raise AssertionError("dry run: non-finite tree-sharded causal forest ATE")

    # fold: the CV folds over every rank.
    fold_mesh = make_mesh((FOLD_AXIS,))
    with use_mesh(fold_mesh):
        cv = cv_glmnet(x[:256], y[:256], nfolds=max(2, n_dev), fold_axis=FOLD_AXIS)
    if not math.isfinite(float(cv.lambda_min)):
        raise AssertionError("dry run: non-finite fold-sharded lambda_min")

    summary = {
        "mesh": (data_ax, boot_ax), "tau": float(tau), "se": float(se),
        "forest_trees": forest.n_trees, "cf_ate": float(cf_eff.estimate),
        "cf_se": float(cf_eff.std_err), "lambda_min": float(cv.lambda_min),
    }
    line = (f"dryrun_multigpu ok: mesh=({data_ax}x{boot_ax}) tau={summary['tau']:.4f} "
            f"se={summary['se']:.4f}; tree-sharded forest {forest.n_trees} trees ok; "
            f"tree-sharded causal forest ate={summary['cf_ate']:.4f} ok; fold-sharded cv "
            f"lambda_min={summary['lambda_min']:.4f}")
    if not sweep:
        log(line)
        return summary

    # run_sweep's own tree + fold mesh composition.
    logs: list[str] = []
    report = run_sweep(micro_sweep_config(), outdir=sweep_out, plots=False, log=logs.append,
                       device=dev)
    mesh_lines = [m for m in logs if m.startswith("mesh:")]
    if n_dev > 1 and not (mesh_lines and mesh_lines[0].startswith(f"mesh: {n_dev} devices")):
        raise AssertionError(f"dry run: no mesh line for {n_dev} ranks: {logs[:3]}")
    got = [r.method for r in report.results.rows]
    if got != list(SWEEP_METHODS) or not all(math.isfinite(r.ate) for r in report.results.rows):
        raise AssertionError(f"dry run: sweep rows {[(r.method, r.ate) for r in report.results.rows]}")
    summary.update({
        "mesh_line": mesh_lines[0] if mesh_lines else None,
        "sweep": [(r.method, r.ate, r.lower_ci, r.upper_ci, r.se, r.status)
                  for r in report.results.rows],
        "sweep_oracle": report.oracle.ate, "sweep_computed": report.computed,
    })
    log(f"{line}; run_sweep[use_mesh] {summary['mesh_line']!r} -> {len(got)} finite rows")
    return summary


def _rank_legs(around: Callable | None, sweep_out: str | None, sweep: bool):
    legs = functools.partial(run_legs, sweep_out=sweep_out, sweep=sweep)
    return legs() if around is None else around(legs)


def dryrun_multigpu(world_size: int, backend: str | None = "gloo", device: str = "cpu", *,
                    timeout: float = DEFAULT_TIMEOUT_S, around: Callable | None = None,
                    scratch: str | None = None, sweep_out: str | None = None,
                    sweep: bool = True) -> list:
    """Spawn ``world_size`` ranks on ``backend`` / ``device`` and run every
    leg of the dry run in each; returns the ranks' summaries, which must
    agree. ``around`` (an importable function) wraps the legs in each
    rank: ``around(run_legs)``'s value is that rank's value (the chip
    script counts and checks the kernels there). A world of one forms a
    real one-rank group, so its collectives run. ``sweep_out``: the
    sweep leg's output directory (rank 0 writes it); ``sweep=False``
    leaves that leg out."""
    from ate_replication_causalml_torch.parallel.spawn import run_ranks

    values = run_ranks(_rank_legs, world_size, backend=backend, device=device,
                       args=(around, sweep_out, sweep), timeout=timeout, scratch=scratch)
    # repr: exact for floats, and NaN (a LASSO row's SE) equals NaN there.
    if around is None and any(repr(v) != repr(values[0]) for v in values[1:]):
        raise AssertionError(f"dry run: ranks disagree: {values}")
    return values


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the multi-GPU dry run")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default=None, help="nccl (cards), gloo (CPU, or a shared card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    print(dryrun_multigpu(args.ranks, backend, args.device)[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
