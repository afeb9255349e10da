"""The tree-sharded forests on two gloo ranks against the JAX package's
sharded fits on two of its CPU devices (``hist_backend=
"pallas_interpret"``, dense histograms), and against the one-process
grow of the same keys.

Contracts:

* the plan: the port follows the JAX "pallas" plan (histogram floor
  16); under ``pallas_interpret`` the JAX floor is 1, so the test first
  asserts with the JAX ``sharded_fit_plan`` that both plans agree here;
* the classifier (integer weights): every field ``array_equal`` to the
  JAX sharded forest, and to the one-process grow of each rank's keys;
* the regressor on a continuous target: counts, bin edges and the codes
  fingerprint exact; leaves on agreeing paths within
  8·eps_f32·(|tree mean| + Σc·|y − mean| / Σc) of the JAX package's (the
  bound of ``tests/test_torch_forest.py``);
* the causal grow: ``in_sample`` and the bin edges exact; splits as in
  ``tests/test_torch_causal_forest.py`` (at least 90% agree, each
  differing split a float tie within 1e-5 relative); the forest equals
  the one-process grow of the ranks' group keys bit for bit;
* ``compute_leaf_index_sharded``: ``array_equal`` to the one-rank index
  and to the JAX package's, dtype included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.parallel.spawn import run_ranks
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.models import forest as jf
from ate_replication_causalml_tpu.parallel.mesh import TREE_AXIS, DATA_AXIS, make_mesh
from test_torch_causal_forest import path_differs, residuals, route_to_level, split_comparison

CFG = dict(n=300, p=6, trees=16, depth=4, n_bins=16)
A = 2
SEED = 11
# The JAX package's sharded fits under "pallas_interpret" raise in this
# image's jax (a pallas_call inside shard_map fails its check_vma); its
# own mesh tests run them on the XLA histogram backend, which is
# bit-exact to the kernel's (tests/test_hist_pallas.py).
JAX_BACKEND = "xla"
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def sharded():
    n, p = CFG["n"], CFG["p"]
    x, wt, yt = residuals(5, n, p)
    rng = np.random.default_rng(3)
    y = (rng.random(n) < 1 / (1 + np.exp(-1.5 * x[:, 0]))).astype(np.float32)
    ycont = (3.0 + x[:, 0] + 0.5 * x[:, 2] + rng.normal(size=n)).astype(np.float32)
    with jax.enable_x64(False):
        k = jax.random.key(SEED)
        key_data = np.asarray(jax.random.key_data(k))
        jmesh = make_mesh((TREE_AXIS,), devices=jax.devices()[:A])
        kw = dict(n_trees=CFG["trees"], depth=CFG["depth"], n_bins=CFG["n_bins"],
                  hist_backend=JAX_BACKEND, hist_mode="dense")
        xj = jnp.asarray(x)
        jcls = jf.fit_forest_sharded(xj, jnp.asarray(y), k, jmesh, **kw)
        jreg = jf.fit_forest_regressor_sharded(xj, jnp.asarray(ycont), k, jmesh, **kw)
        jcau = jcf.grow_causal_forest_sharded(xj, jnp.asarray(wt), jnp.asarray(yt), k, jmesh,
                                              **kw)
        jli = jcf.compute_leaf_index_sharded(jcau, x, mesh=make_mesh(
            (DATA_AXIS,), devices=jax.devices()[:A]))
    cfg = {k: CFG[k] for k in ("trees", "depth", "n_bins")}
    ranks = run_ranks(bodies.forest_body, A, args=(x, y, ycont, wt, yt, key_data, cfg),
                      timeout=120)
    asnp = lambda fo, names: {f: np.asarray(getattr(fo, f)) for f in names}
    return dict(x=x, y=y, ycont=ycont, wt=wt, yt=yt, key_data=key_data, ranks=ranks,
                jcls=asnp(jcls, bodies_fields()), jreg=asnp(jreg, bodies_fields()),
                jcau=asnp(jcau, ("split_feat", "split_bin", "leaf_stats", "in_sample",
                                 "bin_edges")), jli=np.asarray(jli))


def bodies_fields():
    return ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges",
            "train_fp")


def dispatch_major(parts: list, n_disp: int, keep: int) -> np.ndarray:
    """Ranks' (n_disp·per, ...) blocks interleaved dispatch-major."""
    a = np.stack(parts)
    per = a.shape[1] // n_disp
    a = a.reshape(len(parts), n_disp, per, *a.shape[2:]).swapaxes(0, 1)
    return a.reshape(-1, *a.shape[3:])[:keep]


def test_plans_agree_with_jax():
    n, p, depth, n_bins = CFG["n"], CFG["p"], CFG["depth"], CFG["n_bins"]
    per_dev = -(-CFG["trees"] // A)
    port = tf.sharded_fit_plan(n, depth, per_dev, n_bins=n_bins, p=p, hist_mode="dense")
    for backend in ("pallas_interpret", JAX_BACKEND):
        assert port == jf.sharded_fit_plan(n, depth, per_dev, hist_backend=backend,
                                           n_bins=n_bins, p=p, hist_mode="dense")
    assert port == jf.sharded_fit_plan(n, depth, per_dev, hist_backend="pallas",
                                       n_bins=n_bins, p=p, hist_mode="dense")
    groups = -(-(CFG["trees"] // 2) // A)
    from ate_replication_causalml_torch.models.plan import sharded_causal_plan

    assert sharded_causal_plan(n, depth, groups, 2, p, n_bins, "dense") == jf.plan_tree_dispatch(
        n, depth, groups, cap=16, trees_per_unit=2, leaf_onehot=False, streaming=True, p=p,
        n_bins=n_bins, kernel_weights=5, hist_floor=1, hist_partition=False)
    # The flagship shapes: the plan the chip script relies on.
    assert tf.sharded_fit_plan(11_016, 9, 1_250, p=21) == jf.sharded_fit_plan(
        11_016, 9, 1_250, hist_backend="pallas", p=21)


@pytest.mark.parametrize("field", bodies_fields())
def test_classifier_equals_jax_sharded_forest(sharded, field):
    for r in sharded["ranks"]:
        assert np.array_equal(r["classifier"][field], sharded["jcls"][field]), field


def test_classifier_equals_one_process_grow_of_the_same_keys(sharded):
    x, y = torch.as_tensor(sharded["x"]), torch.as_tensor(sharded["y"])
    n, p = x.shape
    chunk, cpd, n_disp = tf.sharded_fit_plan(n, CFG["depth"], -(-CFG["trees"] // A),
                                             n_bins=CFG["n_bins"], p=p, hist_mode="dense")
    key = rnd.key_from_jax(sharded["key_data"], device="cpu")
    codes = tf.binarize(x, tf.quantile_bins(x, CFG["n_bins"]))
    parts = [tf._grow_from_keys(tf.sharded_tree_keys(key, n_disp, A, chunk * cpd, r), codes, y,
                                depth=CFG["depth"], mtry=int(np.sqrt(p)), n_bins=CFG["n_bins"],
                                hist_mode="dense", tree_chunk=16, pool="ref")
             for r in range(A)]
    for j, f in enumerate(("split_feat", "split_bin", "leaf_value", "counts", "train_leaf")):
        want = dispatch_major([q[j].numpy() for q in parts], n_disp, CFG["trees"])
        assert np.array_equal(sharded["ranks"][0]["classifier"][f], want), f


def test_regressor_within_float_bounds(sharded):
    mine, ref = sharded["ranks"][0]["regressor"], sharded["jreg"]
    for f in ("counts", "bin_edges", "train_fp"):
        assert np.array_equal(mine[f], ref[f]), f
    x, y = sharded["x"], sharded["ycont"]
    codes = tf.binarize(torch.as_tensor(x), torch.as_tensor(mine["bin_edges"]))
    c = mine["counts"].astype(np.float64)
    mu = (c * y).sum(axis=1) / c.sum(axis=1)
    differs = (mine["split_feat"] != ref["split_feat"]) | (mine["split_bin"] != ref["split_bin"])
    depth = CFG["depth"]
    leaf = route_to_level(codes, torch.as_tensor(mine["split_feat"]),
                          torch.as_tensor(mine["split_bin"]), depth)
    checked = 0
    for t in range(CFG["trees"]):
        for j in range(1 << depth):
            if path_differs(differs, t, depth, j):
                continue
            rows = leaf[t] == j
            cw = c[t, rows].sum()
            if cw == 0:
                continue
            scale = abs(mu[t]) + (c[t, rows] * np.abs(y[rows] - mu[t])).sum() / cw
            assert abs(mine["leaf_value"][t, j] - ref["leaf_value"][t, j]) <= 8 * EPS32 * scale
            checked += 1
    assert checked >= CFG["trees"] * (1 << depth) // 4


def test_causal_grow_against_jax_and_one_process(sharded):
    from ate_replication_causalml_torch.models.plan import sharded_causal_plan

    mine, ref = sharded["ranks"][0]["causal"], sharded["jcau"]
    for f in ("in_sample", "bin_edges"):
        assert np.array_equal(mine[f], ref[f]), f
    x = torch.as_tensor(sharded["x"])
    n, p = x.shape
    groups = CFG["trees"] // 2
    chunk, cpd, n_disp = sharded_causal_plan(n, CFG["depth"], -(-groups // A), 2, p,
                                             CFG["n_bins"], "dense")
    key = rnd.key_from_jax(sharded["key_data"], device="cpu")
    # The sharded forest's group keys, in its order, are the first
    # ``groups`` of split(key, n_disp · A · per): the honest masks follow.
    gkeys = rnd.split(key, n_disp * A * chunk * cpd)[:groups]
    _, _, grow, _ = tcf.little_bag_masks(gkeys, n, max(2, int(n * 0.5)), 2)

    class _F:  # the fields split_comparison reads, as tensors
        split_feat = torch.as_tensor(mine["split_feat"])
        split_bin = torch.as_tensor(mine["split_bin"])
        bin_edges = torch.as_tensor(mine["bin_edges"])

    agreement, ties, _ = split_comparison(sharded["x"], sharded["wt"], sharded["yt"], ref, _F,
                                          grow.numpy())
    assert agreement >= 0.9
    for t, lv, m, s_mine, s_ref in ties:
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)
    # The one-process grow of each rank's group keys, bit for bit.
    codes = tf.binarize(x, tf.quantile_bins(x, CFG["n_bins"]))
    parts = [tcf._grow_from_group_keys(
        tf.sharded_tree_keys(key, n_disp, A, chunk * cpd, r), codes,
        torch.as_tensor(sharded["wt"]), torch.as_tensor(sharded["yt"]), mtry=None,
        depth=CFG["depth"], n_bins=CFG["n_bins"], min_node=5, sample_fraction=0.5, k=2,
        honesty=True, group_chunk=tcf.DEFAULT_GROUP_CHUNK, hist_mode="dense", pool="ref")
        for r in range(A)]
    for j, f in enumerate(("split_feat", "split_bin", "leaf_stats", "in_sample")):
        want = dispatch_major([q[j].numpy() for q in parts], n_disp, CFG["trees"])
        assert np.array_equal(mine[f], want), f
    for r in sharded["ranks"][1:]:
        for f, v in mine.items():
            assert np.array_equal(r["causal"][f], v), f


def test_leaf_index_sharded_equals_one_rank_and_jax(sharded):
    for r in sharded["ranks"]:
        li = r["leaf_index"]
        assert li.dtype == r["leaf_index_one"].dtype == np.uint8
        assert np.array_equal(li, r["leaf_index_one"])
    # The JAX index of the JAX-grown forest agrees wherever the two
    # forests' splits agree on the whole path; identical forests agree
    # everywhere, so hold the port's index on the JAX forest itself.
    jfo = tcf.CausalForest(*(torch.as_tensor(sharded["jcau"][f]) for f in
                             ("split_feat", "split_bin", "leaf_stats", "in_sample")),
                           bin_edges=torch.as_tensor(sharded["jcau"]["bin_edges"]),
                           ci_group_size=2)
    mine = tcf.compute_leaf_index(jfo, torch.as_tensor(sharded["x"])).numpy()
    assert mine.dtype == sharded["jli"].dtype and np.array_equal(mine, sharded["jli"])
