"""models/forest.py: the port's streaming grower equals the JAX
package's (pallas_interpret backend, dense histogram mode) element for
element — bin edges, codes, split tables, leaf values, bootstrap counts,
training leaves and OOB votes. The JAX side runs without x64, as in
production (under x64 ``select_split``'s uniform draws are float64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops import tree as tt
from ate_replication_causalml_tpu.models import forest as jf

N, P, TREES, DEPTH = 2000, 21, 8, 4
FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf", "train_fp")


def _data(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, P)).astype(np.float32)
    x[:, 5] = np.round(x[:, 5])            # heavy ties
    x[:, 6] = (x[:, 6] > 0.3)              # binary column
    w = (rng.random(N) < 1 / (1 + np.exp(-x[:, 0] - x[:, 6]))).astype(np.float32)
    return x, w


def classifier_pair(x, w, *, n_trees=TREES, depth=DEPTH, backend="pallas_interpret",
                    new_rows=True):
    """The JAX classifier forest (``backend``, dense mode) and the port's,
    grown from one key on the same numpy inputs: (reference fields,
    reference predictions, the port's forest). Also used at the
    notebook's size by ``scripts/torch_parity.py``."""
    with jax.enable_x64(False):
        k = jax.random.key(12325)
        jfo = jf.fit_forest_classifier(jnp.asarray(x), jnp.asarray(w), k, n_trees=n_trees,
                                       depth=depth, hist_backend=backend, hist_mode="dense")
        jpred = jf.predict_forest(jfo, jnp.asarray(x), oob=True)
        ref = {f: np.asarray(getattr(jfo, f)) for f in FIELDS}
        ref_pred = {"oob_vote": np.asarray(jpred.vote), "oob_prob": np.asarray(jpred.prob)}
        if new_rows:
            jnew = jf.predict_forest(jfo, jnp.asarray(x), oob=False)
            ref_pred.update(vote=np.asarray(jnew.vote), prob=np.asarray(jnew.prob))
        key_data = np.asarray(jax.random.key_data(k))
    tk = rnd.key_from_jax(key_data, device="cpu")
    mine = tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), tk,
                                    n_trees=n_trees, depth=depth, hist_mode="dense")
    return ref, ref_pred, mine


@pytest.fixture(scope="module")
def fitted():
    x, w = _data()
    return (x, w) + classifier_pair(x, w)


def test_quantile_bins_and_binarize_equal():
    x, _ = _data(9)
    with jax.enable_x64(False):
        je = np.asarray(jf.quantile_bins(jnp.asarray(x), 64))
        jc = np.asarray(jf.binarize(jnp.asarray(x), jnp.asarray(je)))
        jfp = int(jf.codes_fingerprint(jnp.asarray(jc)))
    te = tf.quantile_bins(torch.as_tensor(x), 64)
    assert np.array_equal(te.numpy(), je)
    tc = tf.binarize(torch.as_tensor(x), te)
    assert tc.dtype == torch.int32 and np.array_equal(tc.numpy(), jc)
    assert int(tf.codes_fingerprint(tc)) == jfp


def test_quantile_bins_nan_column():
    x, _ = _data(10)
    x[7, 2] = np.nan
    with jax.enable_x64(False):
        je = np.asarray(jf.quantile_bins(jnp.asarray(x), 16))
    assert np.array_equal(tf.quantile_bins(torch.as_tensor(x), 16).numpy(), je, equal_nan=True)


def test_bitrev_perm_equal():
    for level in range(10):
        assert tf.bitrev_perm(level) == jf.bitrev_perm(level)


@pytest.mark.parametrize("field", FIELDS)
def test_forest_field_equal(fitted, field):
    _, _, ref, _, mine = fitted
    got = getattr(mine, field).numpy()
    assert got.dtype == ref[field].dtype and got.shape == ref[field].shape
    assert np.array_equal(got, ref[field])


def test_oob_votes_equal_and_probs_within_bound(fitted):
    """Votes are exact (counts of 0/1 over ≤8 trees); the mean leaf
    probability sums ≤8 f32 terms in another order: ≤ 4 ulp of 1."""
    x, _, _, ref_pred, mine = fitted
    got = tf.predict_forest(mine, torch.as_tensor(x), oob=True)
    assert np.array_equal(got.vote.numpy(), ref_pred["oob_vote"])
    assert np.max(np.abs(got.prob.numpy() - ref_pred["oob_prob"])) <= 4 * np.finfo(np.float32).eps


def test_new_row_prediction_equal(fitted):
    """oob=False re-routes every row through the route and lookup paths."""
    x, _, _, ref_pred, mine = fitted
    stripped = dataclasses.replace(mine, train_leaf=None)
    got = tf.predict_forest(stripped, torch.as_tensor(x), oob=False)
    assert np.array_equal(got.vote.numpy(), ref_pred["vote"])
    assert np.max(np.abs(got.prob.numpy() - ref_pred["prob"])) <= 4 * np.finfo(np.float32).eps
    # Routing from the split tables reproduces the leaves recorded in growth.
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges)
    assert torch.equal(tf.forest_apply(mine, codes), mine.train_leaf)


def test_forest_from_jax_roundtrip(fitted):
    _, _, ref, _, mine = fitted
    again = tf.forest_from_jax(ref, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(again, f), getattr(mine, f)), f


def test_oob_rejects_other_matrix(fitted):
    x, _, _, _, mine = fitted
    with pytest.raises(ValueError, match="fingerprint"):
        tf.predict_forest(mine, torch.as_tensor(x[::-1].copy()), oob=True)
    with pytest.raises(ValueError, match="training matrix"):
        tf.predict_forest(mine, torch.as_tensor(x[:10]), oob=True)


def test_tree_chunking_does_not_change_the_forest(fitted):
    x, w, _, _, mine = fitted
    tk = rnd.key(12325, device="cpu")
    other = tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), tk,
                                     n_trees=TREES, depth=DEPTH, tree_chunk=3)
    for f in FIELDS:
        assert torch.equal(getattr(other, f), getattr(mine, f)), f


def _regressor_pair(x, y):
    """The JAX regressor (pallas_interpret, dense) and the port's, from
    one key, with the regressors' own mtry default (p // 3)."""
    with jax.enable_x64(False):
        k = jax.random.key(77)
        jfo = jf.fit_forest_regressor(jnp.asarray(x), jnp.asarray(y), k, n_trees=TREES,
                                      depth=DEPTH, hist_backend="pallas_interpret",
                                      hist_mode="dense")
        ref = {f: np.asarray(getattr(jfo, f)) for f in FIELDS}
        key_data = np.asarray(jax.random.key_data(k))
    mine = tf.fit_forest_regressor(torch.as_tensor(x), torch.as_tensor(y),
                                   rnd.key_from_jax(key_data, device="cpu"),
                                   n_trees=TREES, depth=DEPTH)
    return ref, mine


def test_regressor_equals_jax_on_a_binary_target():
    """A {0, 1} target keeps the weights integer (no centering), so every
    histogram sum is exact: the whole regressor forest equals the JAX
    package's, which also holds the p // 3 mtry default to the reference."""
    x, _ = _data()
    y = (np.random.default_rng(4).random(N) < 0.4).astype(np.float32)
    ref, mine = _regressor_pair(x, y)
    for f in FIELDS:
        assert np.array_equal(getattr(mine, f).numpy(), ref[f]), f


def _route_to_level(codes, feat, bins, level):
    """Node index (in the stored 2k/2k+1 layout) of every (tree, row) at ``level``."""
    node = torch.zeros((feat.shape[0], codes.shape[0]), dtype=torch.int32)
    for lv in range(level):
        m = 1 << lv
        bit = tt.route_bits(codes, node, feat[:, lv, :m].contiguous(), bins[:, lv, :m].contiguous())
        node = node * 2 + bit
    return node.numpy()


def test_regressor_continuous_target_within_float_bounds():
    """A continuous target is centered by each tree's bootstrap mean, so
    the histogram weights are floats and the two packages add them in
    another order. Contract:

    * bootstrap counts, bin edges and the codes fingerprint are exact;
    * where a split differs below agreeing ones, both splits score the
      same in float64 up to 1e-5 relative (ties broken by f32 rounding
      residue: same rows sent left, or an equal score); f32 reordering
      moves a score by a few ulp;
    * every leaf whose path agrees holds the same value up to
      8·eps_f32·(|tree mean| + Σc·|y − mean| / Σc), eight ulp of the
      magnitude of its terms (observed: at most 1.09·eps_f32·that scale).

    The offset of 3 makes a wrong centering (the mean not re-added, or
    added twice) miss the leaf bound by orders of magnitude."""
    x, _ = _data()
    rng = np.random.default_rng(5)
    y = (3.0 + x[:, 0] + 0.5 * x[:, 6] + rng.normal(size=N)).astype(np.float32)
    ref, mine = _regressor_pair(x, y)
    for f in ("counts", "bin_edges", "train_fp"):
        assert np.array_equal(getattr(mine, f).numpy(), ref[f]), f

    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges)
    cnp = codes.numpy().astype(np.int64)
    c = mine.counts.numpy().astype(np.float64)
    mu = (c * y).sum(axis=1) / c.sum(axis=1)
    feat, bins = mine.split_feat.numpy(), mine.split_bin.numpy()
    differs = (feat != ref["split_feat"]) | (bins != ref["split_bin"])

    def path_differs(t, lv, m):  # a split above node m of level lv differs
        return any(differs[t, a, m >> (lv - a)] for a in range(lv))

    for t, lv, m in np.argwhere(differs):
        if path_differs(t, lv, m):
            continue  # the two packages' nodes hold different rows here
        rows = _route_to_level(codes, mine.split_feat, mine.split_bin, lv)[t] == m
        ct, yt = c[t, rows], c[t, rows] * (y[rows] - mu[t])

        def score(f, b):
            left = cnp[rows, f] <= b
            cl, cr, yl, yr = ct[left].sum(), ct[~left].sum(), yt[left].sum(), yt[~left].sum()
            return -(yl * yl / max(cl, 1e-12) + yr * yr / max(cr, 1e-12))

        s_mine = score(feat[t, lv, m], bins[t, lv, m])
        s_ref = score(ref["split_feat"][t, lv, m], ref["split_bin"][t, lv, m])
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)

    leaf = _route_to_level(codes, mine.split_feat, mine.split_bin, DEPTH)
    eps = np.finfo(np.float32).eps
    checked = 0
    for t in range(TREES):
        for j in range(1 << DEPTH):
            if path_differs(t, DEPTH, j):
                continue
            rows = leaf[t] == j
            cw = c[t, rows].sum()
            if cw == 0:
                continue
            scale = abs(mu[t]) + (c[t, rows] * np.abs(y[rows] - mu[t])).sum() / cw
            assert abs(mine.leaf_value[t, j].item() - ref["leaf_value"][t, j]) <= 8 * eps * scale
            checked += 1
    assert checked >= TREES * (1 << DEPTH) // 2


def test_regressor_recovers_a_step():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1500, 4)).astype(np.float32)
    y = np.where(x[:, 1] > 0.0, 3.0, -1.0).astype(np.float32)
    f = tf.fit_forest_regressor(torch.as_tensor(x), torch.as_tensor(y), rnd.key(1, device="cpu"),
                                n_trees=16, depth=3, mtry=4)
    pred = tf.forest_oob_mean(f, torch.as_tensor(x)).numpy()
    assert np.corrcoef(pred, y)[0, 1] > 0.95


def test_unported_hist_mode_rejected():
    x, w = _data()
    with pytest.raises(ValueError, match="not ported"):
        tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), rnd.key(0, device="cpu"),
                                 n_trees=2, depth=2, hist_mode="partition")
