"""The JAX package's matmul backends in the port (``hist_backend`` "xla"
/ "onehot", ``row_backend="matmul"``) against the JAX package's same
backends, on the CPU at small sizes (n ≤ 400, 4-8 trees, depth ≤ 5). The
port grows and predicts them with its kernels (here their plain
versions): the classifier and regressor with the streaming grower, the
causal forest with the direct-ρ grower. The JAX side runs without x64
(the suite enables it), as in production.

Contracts and bounds:

* classifier forests and regressor forests on a binary target: every
  weight is an integer, every histogram sum exact in any order, so the
  forests are equal field for field (``array_equal``);
* a regressor on a continuous target, and both causal modes: the
  histograms are float sums that the port adds in another order than
  XLA's dot, so a split may differ where two candidates tie.
  Each differing split whose path agrees is shown to be a tie: its two
  candidates' float64 scores on the node's rows differ by no more than
  the float32 rounding both could carry (:func:`_tie_bound`, derived in
  its docstring; the causal modes use ``test_torch_causal_forest.py``'s
  1e-5 relative, which is 2·n·eps_f32 at its 150-row nodes); leaves on
  agreeing paths within the same sums' float32 bound;
* ``predict_cate(row_backend="matmul")``: the JAX package's route selects
  one leaf and its payload a row, so the port's kernel route is taken
  under that name, within the JAX package's matmul predict's bound
  (|Δ| ≤ 1e-6·(1 + |·|), as ``test_torch_causal_forest.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame as TFrame
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.parallel.mesh import make_mesh
from ate_replication_causalml_tpu.data.frame import CausalFrame as JFrame
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.models import forest as jf
from tests.test_torch_causal_forest import (
    causal_pair,
    honest_masks,
    path_differs,
    residuals,
    split_comparison,
)

EPS32 = float(np.finfo(np.float32).eps)
BACKENDS = ("xla", "onehot")
FOREST_FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges")
KW = dict(n_trees=6, depth=5, n_bins=16)


def _keys(seed):
    with jax.enable_x64(False):
        k = jax.random.key(seed)
        data = np.asarray(jax.random.key_data(k))
    return k, rnd.key_from_jax(data, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    n, p = 400, 6
    x = rng.normal(size=(n, p)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2])  # heavy ties
    y01 = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    ycont = (2.0 + x[:, 0] - 0.5 * x[:, 1] + rng.normal(size=n)).astype(np.float32)
    return x, y01, ycont


def _fit(kind, x, y, backend, seed=3, **kw):
    """(JAX forest fields, port forest) of one fit on one key."""
    jk, tk = _keys(seed)
    jfit = jf.fit_forest_classifier if kind == "classifier" else jf.fit_forest_regressor
    tfit = tf.fit_forest_classifier if kind == "classifier" else tf.fit_forest_regressor
    with jax.enable_x64(False):
        ref = jfit(jnp.asarray(x), jnp.asarray(y), jk, hist_backend=backend, **KW, **kw)
        ref = {f: np.asarray(getattr(ref, f)) for f in FOREST_FIELDS}
    return ref, tfit(torch.as_tensor(x), torch.as_tensor(y), tk, hist_backend=backend, **KW, **kw)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_integer_weight_forests_equal_jax(data, kind, backend):
    """Binary target: the JAX package's same-backend forest, bit for bit."""
    x, y01, _ = data
    ref, mine = _fit(kind, x, y01, backend)
    for f in FOREST_FIELDS:
        assert np.array_equal(getattr(mine, f).numpy(), ref[f]), f


def test_backends_grow_one_forest(data):
    """Integer weights: "xla", "onehot" and the kernel grower ("auto",
    its plain versions here) grow the same forest from one key, and a
    chunk of 2 trees the same as the default chunk."""
    x, y01, _ = data
    _, tk = _keys(4)
    grow = lambda b, **kw: tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(y01), tk,
                                                   hist_backend=b, **KW, **kw)
    auto = grow("auto")
    for b, kw in (("xla", {}), ("onehot", {}), ("onehot", {"tree_chunk": 2})):
        other = grow(b, **kw)
        for f in FOREST_FIELDS:
            assert torch.equal(getattr(other, f), getattr(auto, f)), (b, kw, f)


def _node_rows(codes, feat, bins, t, level, node):
    """Rows of tree t at ``node`` of ``level`` under the split tables."""
    at = np.zeros(codes.shape[0], np.int64)
    for lv in range(level):
        f, b = feat[t, lv][at], bins[t, lv][at]
        at = 2 * at + (codes[np.arange(codes.shape[0]), f] > b)
    return at == node


def _tie_bound(level, n_rows, wabs, cl, cr, yl, yr):
    """The float32 rounding one candidate's score can carry.

    A histogram cell sums at most n float32 products, each rounded, and a
    level-l cell is a parent's minus l sibling subtractions: its error is
    at most e = (l + 2)·n·eps·Σ|w| over the node's rows. The score
    −(S_L²/c_L + S_R²/c_R) (counts exact) then moves by at most
    2e·(|S_L|/c_L + |S_R|/c_R), plus its own rounding, 4·eps·|score|."""
    e = (level + 2) * n_rows * EPS32 * wabs
    score = yl * yl / cl + yr * yr / cr
    return 2 * e * (abs(yl) / cl + abs(yr) / cr) + 4 * EPS32 * score


def _forest_ties(x, y, ref, mine):
    """Differing splits of two regressor forests on agreeing paths:
    (agreement over live nodes, [(t, level, node, |Δscore|, bound)], the
    differs mask)."""
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges).numpy()
    feat, bins = mine.split_feat.numpy(), mine.split_bin.numpy()
    differs = (feat != ref["split_feat"]) | (bins != ref["split_bin"])
    depth = feat.shape[1]
    live = np.zeros_like(differs)
    for lv in range(depth):
        live[:, lv, : 1 << lv] = True
    counts = mine.counts.numpy().astype(np.float64)
    ties = []
    for t, lv, m in np.argwhere(differs & live):
        if path_differs(differs, t, lv, m):
            continue
        rows = _node_rows(codes, feat, bins, t, lv, m)
        c = counts[t]
        mu = (c * y).sum() / c.sum()
        w = c * (y.astype(np.float64) - mu)

        def score(f, b):
            left = rows & (codes[:, f] <= b)
            right = rows & ~left
            cl, cr = c[left].sum(), c[right].sum()
            yl, yr = w[left].sum(), w[right].sum()
            return -(yl * yl / cl + yr * yr / cr), _tie_bound(
                lv, rows.sum(), np.abs(w[rows]).sum(), cl, cr, yl, yr)

        s_mine, b_mine = score(feat[t, lv, m], bins[t, lv, m])
        s_ref, b_ref = score(ref["split_feat"][t, lv, m], ref["split_bin"][t, lv, m])
        ties.append((t, lv, m, abs(s_mine - s_ref), b_mine + b_ref))
    return 1.0 - differs[live].mean(), ties, differs


@pytest.mark.parametrize("backend", BACKENDS)
def test_continuous_regressor_splits_agree_or_tie(data, backend):
    x, _, ycont = data
    ref, mine = _fit("regressor", x, ycont, backend)
    assert np.array_equal(mine.counts.numpy(), ref["counts"])
    agreement, ties, differs = _forest_ties(x, ycont, ref, mine)
    assert agreement >= 0.9, agreement
    for t, lv, m, gap, bound in ties:
        assert gap <= bound, (t, lv, m, gap, bound)
    # Leaves on agreeing paths: base + S/c with S a float32 sum of at
    # most n products (n·eps·Σ|w|), μ likewise over all rows.
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges).numpy()
    depth = mine.depth
    counts = mine.counts.numpy().astype(np.float64)
    checked = 0
    for t in range(mine.n_trees):
        c = counts[t]
        mu = (c * ycont).sum() / c.sum()
        mu_err = len(c) * EPS32 * (c * np.abs(ycont)).sum() / c.sum()
        for j in range(1 << depth):
            if path_differs(differs, t, depth, j):
                continue
            rows = _node_rows(codes, mine.split_feat.numpy(), mine.split_bin.numpy(), t, depth, j)
            cl = c[rows].sum()
            if cl == 0:
                assert mine.leaf_value[t, j] == pytest.approx(float(mu), abs=2 * mu_err)
                continue
            wabs = (c[rows] * np.abs(ycont[rows] - mu)).sum()
            bound = 2 * (rows.sum() * EPS32 * wabs / cl + mu_err) + 4 * EPS32 * abs(ref[
                "leaf_value"][t, j])
            assert abs(float(mine.leaf_value[t, j]) - ref["leaf_value"][t, j]) <= bound, (t, j)
            checked += 1
    assert checked >= mine.n_trees * (1 << depth) // 4


@pytest.fixture(scope="module", params=BACKENDS)
def causal(request):
    x, wt, yt = residuals(5, 300, 5)
    ref, jfo, mine, key_data = causal_pair(x, wt, yt, n_trees=8, depth=4, n_bins=16,
                                           hist_mode="dense", backend=request.param,
                                           hist_backend=request.param)
    return dict(backend=request.param, x=x, wt=wt, yt=yt, ref=ref, jfo=jfo, mine=mine,
                key_data=key_data)


def test_causal_modes_splits_agree_or_tie(causal):
    x, mine, ref = causal["x"], causal["mine"], causal["ref"]
    assert np.array_equal(mine.in_sample.numpy(), ref["in_sample"])
    grow = honest_masks(mine, causal["key_data"], x.shape[0])[1]
    agreement, ties, _ = split_comparison(x, causal["wt"], causal["yt"], ref, mine, grow)
    assert agreement >= 0.9, agreement
    for t, lv, m, s_mine, s_ref in ties:
        assert np.isfinite(s_mine) and np.isfinite(s_ref), (t, lv, m, s_mine, s_ref)
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)


def test_causal_modes_leaf_stats_on_agreeing_paths(causal):
    """The honest leaves: J-half counts exact, each moment within
    8·eps·Σ|channel| over the leaf's rows."""
    from tests.test_torch_causal_forest import route_to_level

    x, mine, ref = causal["x"], causal["mine"], causal["ref"]
    base, grow, est = honest_masks(mine, causal["key_data"], x.shape[0])
    _, _, differs = split_comparison(x, causal["wt"], causal["yt"], ref, mine, grow)
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges)
    leaf = route_to_level(codes, mine.split_feat, mine.split_bin, mine.depth)
    chan = tcf._moments_stack(torch.as_tensor(causal["wt"]), torch.as_tensor(causal["yt"])).numpy()
    got, want = mine.leaf_stats.numpy(), ref["leaf_stats"]
    checked = 0
    for t in range(mine.n_trees):
        for j in range(1 << mine.depth):
            if path_differs(differs, t, mine.depth, j):
                continue
            rows = (leaf[t] == j) & est[t]
            assert got[t, j, 0] == want[t, j, 0] == rows.sum()
            assert np.all(np.abs(got[t, j] - want[t, j])
                          <= 8 * EPS32 * np.abs(chan[rows]).sum(axis=0)), (t, j)
            checked += 1
    assert checked >= mine.n_trees * (1 << mine.depth) // 2


@pytest.mark.parametrize("oob", [True, False])
def test_predict_cate_matmul(causal, oob):
    """``row_backend="matmul"`` on the JAX-grown forest carried across:
    within the JAX package's "matmul" predict's bound, the port's kernel
    route's bits, and with the leaf index and a 128-row ``row_chunk``, or
    through the serving form (``lower_predict_cate_masked``, all rows
    real), the same bits again."""
    x = causal["x"]
    with jax.enable_x64(False):
        ref = jcf.predict_cate(causal["jfo"], jnp.asarray(x), oob=oob, row_backend="matmul")
        tau_ref, var_ref = np.asarray(ref.cate), np.asarray(ref.variance)
    carried = tcf.causal_forest_from_jax(causal["ref"], device="cpu")
    xt = torch.as_tensor(x)
    got = tcf.predict_cate(carried, xt, oob=oob, row_backend="matmul")
    assert np.all(np.abs(got.cate.numpy() - tau_ref) <= 1e-6 * (1 + np.abs(tau_ref)))
    assert np.all(np.abs(got.variance.numpy() - var_ref) <= 1e-6 * (1 + np.abs(var_ref)))
    stream = tcf.predict_cate(carried, xt, oob=oob)
    li = tcf.compute_leaf_index(carried, xt)
    chunked = tcf.predict_cate(carried, xt, oob=oob, row_chunk=128, leaf_index=li,
                               row_backend="matmul")
    for other in (stream, chunked):
        assert torch.equal(got.cate, other.cate) and torch.equal(got.variance, other.variance)
    if not oob:
        warm = tcf.lower_predict_cate_masked(carried, x.shape[0], row_backend="matmul")
        served = warm(carried, x, np.ones(x.shape[0], np.float32))
        assert np.array_equal(served.cate, got.cate.numpy())
        assert np.array_equal(served.variance, got.variance.numpy())


def test_fit_causal_forest_onehot_equals_jax():
    """``fit_causal_forest(hist_backend="onehot")`` end to end against the
    JAX package's: the half-samples exact, the nuisances (OOB means of
    exact forests, summed over trees in another order) within 1e-6, at
    least 90% of the live split table equal, the ATE and SE within the
    report bound of ``test_torch_causal_forest.py`` (2e-2)."""
    rng = np.random.default_rng(5)
    n, p = 400, 5
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x[:, 1] + (0.5 + x[:, 2]) * w)))).astype(np.float32)
    jk, tk = _keys(7)
    kw = dict(n_trees=8, depth=4, nuisance_trees=8, nuisance_depth=4, n_bins=16,
              hist_backend="onehot")
    with jax.enable_x64(False):
        ref = jcf.fit_causal_forest(JFrame(*(jnp.asarray(a) for a in (x, w, y))), jk, **kw)
        jeff = jcf.average_treatment_effect(ref)
        ref_est, ref_se = float(jeff.estimate), float(jeff.std_err)
    got = tcf.fit_causal_forest(TFrame(*(torch.as_tensor(a) for a in (x, w, y))), tk, **kw)
    eff = tcf.average_treatment_effect(got)
    assert np.array_equal(got.forest.in_sample.numpy(), np.asarray(ref.forest.in_sample))
    for a, b in ((got.y_hat, ref.y_hat), (got.w_hat, ref.w_hat)):
        assert np.all(np.abs(a.numpy() - np.asarray(b)) <= 1e-6)
    same = ((got.forest.split_feat.numpy() == np.asarray(ref.forest.split_feat))
            & (got.forest.split_bin.numpy() == np.asarray(ref.forest.split_bin)))
    live = np.zeros(same.shape, bool)
    for lv in range(4):
        live[:, lv, : 1 << lv] = True
    assert same[live].mean() >= 0.9
    assert abs(float(eff.estimate) - ref_est) <= 2e-2
    assert abs(float(eff.std_err) - ref_se) <= 2e-2


@pytest.mark.parametrize("backend", BACKENDS)
def test_causal_grow_chunking_does_not_change_the_forest(backend):
    x, wt, yt = residuals(6, 200, 4)
    grow = lambda gc: tcf.grow_causal_forest(
        *(torch.as_tensor(a) for a in (x, wt, yt)), rnd.key(9, device="cpu"), n_trees=8,
        depth=3, n_bins=16, group_chunk=gc, hist_backend=backend)
    a, b = grow(1), grow(8)
    for f in ("split_feat", "split_bin", "leaf_stats", "in_sample"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_xla_on_a_one_rank_mesh_equals_unsharded(data):
    """The sharded fits take "xla": on a one-rank tree mesh every key is
    grown here, so the forest and the causal grow equal the unsharded."""
    x, y01, _ = data
    mesh = make_mesh(("tree",))
    _, tk = _keys(5)
    xt, yt_ = torch.as_tensor(x), torch.as_tensor(y01)
    sharded = tf.fit_forest_sharded(xt, yt_, tk, mesh, hist_backend="xla", **KW)
    plain = tf.fit_forest_classifier(xt, yt_, tk, hist_backend="xla", **KW)
    for f in FOREST_FIELDS:
        assert torch.equal(getattr(sharded, f), getattr(plain, f)), f
    cx, cwt, cyt = (torch.as_tensor(a) for a in residuals(6, 200, 4))
    ckw = dict(n_trees=8, depth=3, n_bins=16, hist_backend="xla")
    cs = tcf.grow_causal_forest_sharded(cx, cwt, cyt, tk, mesh, **ckw)
    cu = tcf.grow_causal_forest(cx, cwt, cyt, tk, **ckw)
    for f in ("split_feat", "split_bin", "leaf_stats", "in_sample"):
        assert torch.equal(getattr(cs, f), getattr(cu, f)), f


def test_sharded_onehot_is_refused(data):
    x, y01, _ = data
    mesh = make_mesh(("tree",))
    _, tk = _keys(5)
    xt, yt_ = torch.as_tensor(x), torch.as_tensor(y01)
    with pytest.raises(ValueError, match="sharded path"):
        tf.fit_forest_sharded(xt, yt_, tk, mesh, hist_backend="onehot", **KW)
    with pytest.raises(ValueError, match="sharded path"):
        tf.fit_forest_regressor_sharded(xt, yt_, tk, mesh, hist_backend="onehot", **KW)
    with pytest.raises(ValueError, match="sharded path"):
        tcf.grow_causal_forest_sharded(xt, yt_, yt_, tk, mesh, n_trees=2, depth=2,
                                       hist_backend="onehot")
    with pytest.raises(ValueError, match="single-device"):
        tcf.fit_causal_forest(TFrame(xt, yt_, yt_), tk, 2, 2, 2, 2, "onehot", None, mesh)


@pytest.mark.parametrize("hist_mode", ["partition", "partition+pack", "auto"])
def test_direct_rho_hist_modes_grow_one_forest(hist_mode):
    """The direct-ρ grower's [1, ρ] histograms through every formulation
    of the histogram kernel: the same sums, so the same forest as
    "dense", and "onehot" (the JAX package's mask mode) the same as
    "xla" (its gather mode)."""
    x, wt, yt = residuals(6, 300, 5)
    grow = lambda b, mode: tcf.grow_causal_forest(
        *(torch.as_tensor(a) for a in (x, wt, yt)), rnd.key(9, device="cpu"), n_trees=8,
        depth=5, n_bins=16, hist_backend=b, hist_mode=mode)
    ref = grow("xla", "dense")
    for b in BACKENDS:
        got = grow(b, hist_mode)
        for f in ("split_feat", "split_bin", "leaf_stats", "in_sample"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (b, f)
