"""Rank bodies of the port's multi-GPU tests.

``parallel/spawn.py::run_ranks`` starts each rank in a fresh process
that imports this module by name (the tests directory is on the
ranks' ``sys.path``), so it imports only the port: the tests compute
the JAX side in their own process and pass numpy arrays in and out.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def _delta(family: str, before: dict) -> dict:
    from ate_replication_causalml_torch import observability as obs

    after = obs.REGISTRY.peek(family) or {}
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def shardio_body(vals: dict, padded_vals: dict) -> dict:
    """The artifact plane on this world: round trips, the padded row
    shard, the statuses and bytes each call meters."""
    from ate_replication_causalml_torch import observability as obs
    from ate_replication_causalml_torch.parallel import shardio
    from ate_replication_causalml_torch.parallel.mesh import (
        DATA_AXIS,
        make_mesh,
        replicated,
        row_sharded,
        world_size,
    )

    mesh = make_mesh((DATA_AXIS,))
    n = len(next(iter(vals.values())))
    rs = shardio.row_sharding(mesh, n)
    rep = replicated(mesh)
    out: dict = {"world": world_size(), "uneven_replicated":
                 shardio.row_sharding(mesh, n + 1).is_fully_replicated or world_size() == 1}
    dev = shardio.commit(vals, rs, artifact="rt")
    out["layouts_ok"] = all(leaf.layout == rs for leaf in dev.values())
    out["host"] = shardio.gather_host(dev, artifact="rt")
    back = shardio.reshard(shardio.reshard(dev, rep, artifact="rt"), rs, artifact="rt")
    out["back"] = shardio.gather_host(back, artifact="rt")
    pdev, mask, n_out = shardio.shard_rows_padded(padded_vals, mesh, artifact="pad_rt")
    out["padded"] = {"n": n_out, "rows": [leaf.shape[0] for leaf in pdev.values()],
                     "local_rows": [leaf.local.shape[0] for leaf in pdev.values()],
                     "mask": shardio.gather_host(mask, artifact="pad_rt"),
                     "back": shardio.gather_rows_padded(pdev, n_out, artifact="pad_rt")}
    out["padded"]["back_readonly"] = not any(v.flags.writeable
                                             for v in out["padded"]["back"].values())
    ints = np.arange(len(next(iter(padded_vals.values()))), dtype=np.float32) - 300.0
    idev, imask, _ = shardio.shard_rows_padded(ints, mesh, artifact="pad_sum")
    from ate_replication_causalml_torch.parallel.mesh import all_reduce_sum

    out["masked_sum"] = float(all_reduce_sum((idev.local * imask.local).sum(), mesh, DATA_AXIS))
    out["ints_sum"] = float(ints.sum())
    # statuses: a unique shape so nothing above seeded its path
    before = dict(obs.REGISTRY.peek(shardio.CALLS_FAMILY) or {})
    v = np.arange(4 * world_size() * 37, dtype=np.float32).reshape(4 * world_size(), 37)
    d = shardio.commit(v, row_sharded(mesh, DATA_AXIS), artifact="once")
    r1 = shardio.reshard(d, rep, artifact="once")
    shardio.reshard(d, rep, artifact="once")
    shardio.reshard(r1, rep, artifact="once")
    out["calls"] = _delta(shardio.CALLS_FAMILY, before)
    # bytes by path
    v = np.arange(2048, dtype=np.float32)
    before = dict(obs.REGISTRY.peek(shardio.BYTES_FAMILY) or {})
    d = shardio.commit(v, shardio.row_sharding(mesh, v.size), artifact="bytes_t")
    shardio.handoff(d, artifact="bytes_t")
    host = shardio.gather_host(d, artifact="bytes_t")
    bounced = shardio.host_bounce(d, artifact="bytes_t")
    out["bytes"] = _delta(shardio.BYTES_FAMILY, before)
    out["bytes_host"] = host
    out["bytes_bounced"] = _np(bounced)
    try:
        host[0] = 0.0
        out["host_writable"] = True
    except ValueError:
        out["host_writable"] = False
    return out


def cache_body(raw: np.ndarray) -> dict:
    """A laned artifact declared row-sharded, consumed by two undeclared
    stages on two workers, a "host" and a "device" consumer: the bytes
    the shard plane moves, what each consumer gets, the fits."""
    from ate_replication_causalml_torch.parallel import shardio
    from ate_replication_causalml_torch.parallel.mesh import DATA_AXIS, make_mesh
    from ate_replication_causalml_torch.scheduler import ArtifactSpec, StageSpec, SweepEngine

    from ate_replication_causalml_torch import observability as obs

    mesh = make_mesh((DATA_AXIS,))
    rs = shardio.row_sharding(mesh, raw.size)
    got: dict = {}
    fits: list = []

    def fit(c):
        fits.append(torch.as_tensor(raw))
        return fits[-1]

    arts = [ArtifactSpec("reg_p", fit=fit, key=("k",), exclusive="mesh", sharding=rs)]
    stages = [StageSpec(name, run=lambda c, name=name: got.setdefault(name, c.get("reg_p")),
                        needs=("reg_p",), consumes_sharding=consumes, exclusive=lane)
              for name, consumes, lane in (("u1", {}, None), ("u2", {}, None),
                                           ("h", {"reg_p": "host"}, None),
                                           ("d", {"reg_p": "device"}, "mesh"))]
    before = dict(obs.REGISTRY.peek(shardio.BYTES_FAMILY) or {})
    SweepEngine(arts, stages, workers=2, prefetch=False).run()
    return {"moved": _delta(shardio.BYTES_FAMILY, before), "fits": len(fits),
            "u1": _np(got["u1"]),
            "all_the_fit": all(got[k] is fits[0] for k in ("u1", "u2", "h", "d"))}


def pod_mesh_body(dpps) -> dict:
    import warnings

    from ate_replication_causalml_torch.parallel.multihost import make_pod_mesh

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = make_pod_mesh(data_parallel_per_slice=dpps)
    from ate_replication_causalml_torch.parallel.mesh import all_gather_cat

    t = torch.tensor([float(torch.distributed.get_rank())])
    return {"shape": mesh.shape, "coords": (mesh.coord("boot"), mesh.coord("data")),
            "data_group": _np(all_gather_cat(t, mesh, "data")).tolist(),
            "boot_group": _np(all_gather_cat(t, mesh, "boot")).tolist(),
            "warned": [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]}


def world_body() -> dict:
    """What a rank sees of the world it joined."""
    from ate_replication_causalml_torch.parallel.multihost import init_multihost, world_info

    info = world_info()
    return {"rank": info.rank, "size": info.size, "backend": info.backend,
            "device": str(info.device), "again": init_multihost()}


def forest_body(x, y, ycont, wt, yt, key_data, cfg: dict) -> dict:
    """The tree-sharded classifier, regressor and causal grow and the
    row-sharded leaf index on this world, as numpy fields."""
    from ate_replication_causalml_torch.models import causal_forest as tcf
    from ate_replication_causalml_torch.models import forest as tf
    from ate_replication_causalml_torch.ops import random as rnd
    from ate_replication_causalml_torch.parallel.mesh import DATA_AXIS, TREE_AXIS, make_mesh

    mesh = make_mesh((TREE_AXIS,))
    key = rnd.key_from_jax(key_data, device="cpu")
    t = lambda a: torch.as_tensor(a)
    fields = ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges",
              "train_fp")
    out = {}
    for name, target, fit in (("classifier", y, tf.fit_forest_sharded),
                              ("regressor", ycont, tf.fit_forest_regressor_sharded)):
        fo = fit(t(x), t(target), key, mesh, n_trees=cfg["trees"], depth=cfg["depth"],
                 n_bins=cfg["n_bins"], hist_mode="dense")
        out[name] = {f: _np(getattr(fo, f)) for f in fields}
    cfo = tcf.grow_causal_forest_sharded(t(x), t(wt), t(yt), key, mesh, n_trees=cfg["trees"],
                                         depth=cfg["depth"], n_bins=cfg["n_bins"],
                                         hist_mode="dense")
    out["causal"] = {f: _np(getattr(cfo, f)) for f in ("split_feat", "split_bin", "leaf_stats",
                                                       "in_sample", "bin_edges")}
    out["leaf_index"] = tcf.compute_leaf_index_sharded(cfo, x, mesh=make_mesh((DATA_AXIS,)))
    out["leaf_index_one"] = _np(tcf.compute_leaf_index(cfo, t(x)))
    return out


def estimators_body(boot: dict, cv_cases: list, glm: dict, matrix_spec) -> dict:
    """The boot-, fold- and data-sharded estimators and the sharded
    matrix on this world."""
    from ate_replication_causalml_torch import observability as obs
    from ate_replication_causalml_torch import scenarios as sc
    from ate_replication_causalml_torch.ops import lasso as tl
    from ate_replication_causalml_torch.ops import random as rnd
    from ate_replication_causalml_torch.ops.bootstrap import aipw_bootstrap_se_sharded
    from ate_replication_causalml_torch.parallel import shardio
    from ate_replication_causalml_torch.parallel.dryrun import nuisance_step_sharded
    from ate_replication_causalml_torch.parallel.mesh import (
        BOOT_AXIS,
        DATA_AXIS,
        FOLD_AXIS,
        make_mesh,
        use_mesh,
    )

    t = lambda a: torch.as_tensor(a)
    out: dict = {}
    with use_mesh(make_mesh((BOOT_AXIS,))):
        se, taus = aipw_bootstrap_se_sharded(*(t(boot[k]) for k in ("w", "y", "p", "mu0", "mu1")),
                                             key=rnd.key_from_jax(boot["key"], device="cpu"),
                                             n_boot=boot["n_boot"], return_taus=True)
    out["boot"] = {"se": float(se), "taus": _np(taus)}
    out["cv"] = []
    with use_mesh(make_mesh((FOLD_AXIS,))):
        for case in cv_cases:
            cv = tl.cv_glmnet(t(case["x"]), t(case["y"]), case["family"], foldid=case["foldid"],
                              nfolds=case["nfolds"], fold_axis=FOLD_AXIS)
            out["cv"].append({"index_min": int(cv.index_min), "index_1se": int(cv.index_1se),
                              "cvm": _np(cv.cvm), "cvsd": _np(cv.cvsd),
                              "coefs": _np(cv.path.coefs), "lambdas": _np(cv.path.lambdas)})
    mesh = make_mesh((DATA_AXIS,))
    rows = shardio.commit((glm["x"], glm["w"], glm["y"]), shardio.row_sharding(mesh, len(glm["w"])),
                          artifact="glm")
    tau, p, mu0, mu1 = nuisance_step_sharded(*(r.local for r in rows), mesh)
    out["glm"] = {"tau": float(tau), **{k: shardio.gather_host(
        shardio.DArray(v, rows[1].layout, (len(glm["w"]),)), artifact="glm")
        for k, v in (("p", p), ("mu0", mu0), ("mu1", mu1))}}
    before = dict(obs.REGISTRY.peek(shardio.BYTES_FAMILY) or {})
    rep = sc.run_matrix(matrix_spec, scheduler="sequential", log=lambda s: None, device="cpu")
    out["matrix"] = {"cells": rep.cells, "moved": _delta(shardio.BYTES_FAMILY, before)}
    return out


def sweep_body(outdir: str, scheduler: str | None, rerun: bool) -> dict:
    """run_sweep(use_mesh=True) at MICRO into ``outdir`` (``scheduler``
    None: the concurrent engine on 2 workers), then, with ``rerun``, the
    same sweep again (everything resumed)."""
    import time

    from ate_replication_causalml_torch.parallel.dryrun import micro_sweep_config
    from ate_replication_causalml_torch.pipeline import run_sweep

    out: dict = {}
    for name in ("run", "rerun")[: 1 + rerun]:
        logs: list[str] = []
        t0 = time.perf_counter()
        rep = run_sweep(micro_sweep_config(), outdir=outdir, plots=False, log=logs.append,
                        device="cpu", scheduler=scheduler, workers=2)
        out[name] = {"rows": [(r.method, r.ate, r.lower_ci, r.upper_ci, r.se, r.status)
                              for r in rep.results.rows],
                     "oracle": rep.oracle.ate, "computed": rep.computed,
                     "resumed": rep.resumed, "mesh": [s for s in logs if s.startswith("mesh:")],
                     "wall_s": time.perf_counter() - t0}
    return out
