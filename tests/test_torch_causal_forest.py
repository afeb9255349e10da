"""models/causal_forest.py and estimators/causal_forest_est.py against the
JAX package, which runs its streaming grower as its own tests run it
(``hist_backend="pallas_interpret"``), in ``hist_mode="dense"`` and
``"auto"`` (the "auto" case is sized so that its K=5 level at width 16
takes the partition kernel). The JAX side runs without x64, as in
production (under x64 its uniform and Bernoulli draws are float64).

Contracts and bounds (each bound a few times the largest difference
these tests measured; the reading is beside it):

* exact: the half-samples (``in_sample``), the honest grow/estimate
  masks, the bin edges, and the leaves' J-half counts on agreeing paths;
* splits: the histograms are float sums taken in another order, so a
  split may differ where two candidates tie. At least 90% of the live
  split table agrees (seen, seeds 3-5: 1.0, 1.0 and 0.9917 in the dense
  case, 1.0, 1.0 and 0.9960 in the auto case; the fixture's seed 5 has
  one differing split in each), and each differing split whose path
  agrees scores within 1e-5 relative of the JAX package's choice in
  float64 on the node's grow rows (seen: relative difference 0, both
  candidates send the same grow rows left: a cumulative sum across an
  empty bin, rounded differently by XLA's scan);
* leaf statistics on agreeing paths: |Δ| ≤ 8·eps_f32·Σ|channel| over the
  leaf's rows (seen: 0);
* ``predict_cate`` on a JAX-grown forest carried across: |Δτ̂| ≤
  1e-6·(1 + |τ̂|) and |Δvar| ≤ 1e-6·(1 + var), both ``variance_compat``
  values (seen, seeds 3-5: at most 1.5e-7 and 1.4e-7 of that scale);
* ``average_treatment_effect`` and ``incorrect_forest_ate`` on that
  forest and common nuisances: |Δ| ≤ 1e-6 (seen: at most 6.0e-8);
* ``causal_forest_report`` end to end (each package grows its own
  forests): |Δ| ≤ 2e-2 on the ATEs and SEs. A tie flip moves whole rows
  between leaves: seen 3.6e-3 on the ATE at frame seed 5 (the test's),
  at most 3.0e-8 at seeds 6 and 7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame as TFrame
from ate_replication_causalml_torch.estimators import causal_forest_est as tce
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops import tree as tt
from ate_replication_causalml_tpu.data.frame import CausalFrame as JFrame
from ate_replication_causalml_tpu.estimators import causal_forest_est as jce
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.models import forest as jf

FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")
CONFIGS = {
    "dense": dict(n=300, p=5, n_bins=16, n_trees=8, depth=4, hist_mode="dense"),
    "auto": dict(n=300, p=21, n_bins=64, n_trees=4, depth=6, hist_mode="auto"),
}
EPS32 = float(np.finfo(np.float32).eps)
MIN_NODE = 5


def residuals(seed, n, p):
    """Covariates and centered-like residuals w̃, ỹ with a heterogeneous
    effect (τ(x) = 1 + x0), made by numpy from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    x[:, 1] = np.round(x[:, 1])                      # heavy ties
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = ((1.0 + x[:, 0]) * wt + 0.3 * rng.normal(size=n)).astype(np.float32)
    return x, wt, yt


def causal_pair(x, wt, yt, *, n_trees, depth, n_bins, hist_mode, seed=11,
                backend="pallas_interpret", **kw):
    """The JAX causal forest (``backend``) and the port's, grown from one
    key on the same numpy inputs: (reference fields, the JAX forest, the
    port's forest, key data). Also used at the notebook's size by
    ``scripts/torch_parity.py``."""
    with jax.enable_x64(False):
        k = jax.random.key(seed)
        jfo = jcf.grow_causal_forest(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(yt), k,
                                     n_trees=n_trees, depth=depth, n_bins=n_bins,
                                     hist_backend=backend, hist_mode=hist_mode)
        ref = {f: np.asarray(getattr(jfo, f)) for f in FIELDS}
        key_data = np.asarray(jax.random.key_data(k))
    mine = tcf.grow_causal_forest(torch.as_tensor(x), torch.as_tensor(wt), torch.as_tensor(yt),
                                  rnd.key_from_jax(key_data, device="cpu"), n_trees=n_trees,
                                  depth=depth, n_bins=n_bins, hist_mode=hist_mode, **kw)
    return ref, jfo, mine, key_data


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def grown(request):
    cfg = dict(CONFIGS[request.param])
    n, p = cfg.pop("n"), cfg.pop("p")
    x, wt, yt = residuals(5, n, p)  # a seed with one float tie in each case
    ref, jfo, mine, key_data = causal_pair(x, wt, yt, **cfg)
    return dict(cfg=cfg, x=x, wt=wt, yt=yt, ref=ref, jfo=jfo, mine=mine, key_data=key_data)


def honest_masks(mine, key_data, n):
    """The port's little-bag masks for the forest's groups."""
    k = mine.ci_group_size
    gkeys = rnd.split(rnd.key_from_jax(key_data, device="cpu"), mine.n_trees // k)
    _, base, grow, est = tcf.little_bag_masks(gkeys, n, max(2, int(n * 0.5)), k)
    return base.numpy(), grow.numpy(), est.numpy()


def route_to_level(codes, feat, bins, level):
    """Node (stored 2k/2k+1 layout) of every (tree, row) at ``level``."""
    node = torch.zeros((feat.shape[0], codes.shape[0]), dtype=torch.int32)
    for lv in range(level):
        m = 1 << lv
        node = node * 2 + tt.route_bits(codes, node, feat[:, lv, :m].contiguous(),
                                        bins[:, lv, :m].contiguous())
    return node.numpy()


def split_comparison(x, wt, yt, ref, mine, grow):
    """Split agreement, and for every differing split whose path agrees
    the float64 scores of both candidates on the node's grow rows:
    (agreement fraction, [(tree, level, node, score_port, score_jax)],
    differs mask)."""
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges)
    cnp = codes.numpy()
    feat, bins = mine.split_feat.numpy(), mine.split_bin.numpy()
    differs = (feat != ref["split_feat"]) | (bins != ref["split_bin"])
    depth = feat.shape[1]
    live = np.zeros_like(differs)
    for lv in range(depth):
        live[:, lv, : 1 << lv] = True
    agreement = 1.0 - differs[live].mean()
    w64, y64 = wt.astype(np.float64), yt.astype(np.float64)
    ties = []
    for t, lv, m in np.argwhere(differs):
        if path_differs(differs, t, lv, m):
            continue
        rows = (route_to_level(codes, mine.split_feat, mine.split_bin, lv)[t] == m) & grow[t]
        w, y = w64[rows], y64[rows]
        c = float(rows.sum())
        wbar, ybar = w.sum() / max(c, 1.0), y.sum() / max(c, 1.0)
        varw = c * (w * w).sum() - w.sum() ** 2
        tau = (c * (w * y).sum() - w.sum() * y.sum()) / varw if varw > 1e-12 else 0.0
        rho = (w - wbar) * ((y - ybar) - (w - wbar) * tau)

        def score(f, b):
            left = cnp[rows, f] <= b
            cl, cr = left.sum(), (~left).sum()
            if cl < MIN_NODE or cr < MIN_NODE:
                return np.inf
            rl, rr = rho[left].sum(), rho[~left].sum()
            return -(rl * rl / cl + rr * rr / cr)

        ties.append((t, lv, m, score(feat[t, lv, m], bins[t, lv, m]),
                     score(ref["split_feat"][t, lv, m], ref["split_bin"][t, lv, m])))
    return agreement, ties, differs


def path_differs(differs, t, lv, m):
    """Whether a split on the path above node m of level lv differs."""
    return any(differs[t, a, m >> (lv - a)] for a in range(lv))


def test_exact_subsample_mask_equals_jax():
    for seed, n, s in ((0, 1000, 500), (1, 11016, 5508), (2, 7, 7), (3, 50, 1), (4, 300, 150)):
        keys = rnd.split(rnd.key(seed, device="cpu"), 3)
        got = tf.exact_subsample_mask(keys, n, s).numpy()
        jkeys = jax.random.split(jax.random.key(seed), 3)
        for i in range(3):
            ref = np.asarray(jf.exact_subsample_mask(jkeys[i], n, s))
            assert np.array_equal(got[i], ref) and got[i].sum() == s
    with pytest.raises(ValueError):
        tf.exact_subsample_mask(rnd.key(0, device="cpu"), 10, 11)


def test_half_samples_and_honest_masks_exact(grown):
    """``in_sample`` equals the JAX forest's; the grow/estimate masks
    equal the JAX package's own draws (``exact_subsample_mask`` and
    ``bernoulli`` on the keys of its ``grow_group``/``grow_one``)."""
    mine, ref, n = grown["mine"], grown["ref"], grown["x"].shape[0]
    assert np.array_equal(mine.in_sample.numpy(), ref["in_sample"])
    assert np.array_equal(mine.bin_edges.numpy(), ref["bin_edges"])
    base, grow, est = honest_masks(mine, grown["key_data"], n)
    k = mine.ci_group_size
    with jax.enable_x64(False):
        gkeys = jax.random.split(jax.random.wrap_key_data(grown["key_data"]), mine.n_trees // k)
        for g in range(mine.n_trees // k):
            sk, tk = jax.random.split(gkeys[g])
            in_mask = np.asarray(jf.exact_subsample_mask(sk, n, max(2, int(n * 0.5))))
            for j, tree_key in enumerate(jax.random.split(tk, k)):
                bern = np.asarray(jax.random.bernoulli(tree_key, 0.5, (n,)))
                t = g * k + j
                assert np.array_equal(base[t], in_mask)
                assert np.array_equal(grow[t], in_mask & bern)
                assert np.array_equal(est[t], in_mask & ~bern)


def test_splits_agree_or_tie(grown):
    agreement, ties, _ = split_comparison(grown["x"], grown["wt"], grown["yt"], grown["ref"],
                                          grown["mine"], honest_masks(grown["mine"],
                                                                      grown["key_data"],
                                                                      grown["x"].shape[0])[1])
    assert agreement >= 0.9, agreement
    for t, lv, m, s_mine, s_ref in ties:
        assert np.isfinite(s_mine) and np.isfinite(s_ref), (t, lv, m, s_mine, s_ref)
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)


def test_leaf_stats_on_agreeing_paths(grown):
    x, mine, ref = grown["x"], grown["mine"], grown["ref"]
    _, _, est = honest_masks(mine, grown["key_data"], x.shape[0])
    _, _, differs = split_comparison(x, grown["wt"], grown["yt"], ref, mine,
                                     honest_masks(mine, grown["key_data"], x.shape[0])[1])
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges)
    depth = mine.depth
    leaf = route_to_level(codes, mine.split_feat, mine.split_bin, depth)
    chan = tcf._moments_stack(torch.as_tensor(grown["wt"]), torch.as_tensor(grown["yt"])).numpy()
    got, want = mine.leaf_stats.numpy(), ref["leaf_stats"]
    checked = 0
    for t in range(mine.n_trees):
        for j in range(1 << depth):
            if path_differs(differs, t, depth, j):
                continue
            rows = (leaf[t] == j) & est[t]
            assert got[t, j, 0] == want[t, j, 0] == rows.sum()
            scale = np.abs(chan[rows]).sum(axis=0)
            assert np.all(np.abs(got[t, j] - want[t, j]) <= 8 * EPS32 * scale), (t, j)
            checked += 1
    assert checked >= mine.n_trees * (1 << depth) // 2


@pytest.mark.parametrize("variance_compat", ["unbiased", "grf"])
def test_predict_cate_on_a_forest_carried_across(grown, variance_compat):
    x = grown["x"]
    with jax.enable_x64(False):
        ref = jcf.predict_cate(grown["jfo"], jnp.asarray(x), oob=True,
                               variance_compat=variance_compat)
        tau_ref, var_ref = np.asarray(ref.cate), np.asarray(ref.variance)
    carried = tcf.causal_forest_from_jax(grown["ref"], device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(carried, f).numpy(), grown["ref"][f])
    got = tcf.predict_cate(carried, torch.as_tensor(x), oob=True,
                           variance_compat=variance_compat)
    assert np.all(np.abs(got.cate.numpy() - tau_ref) <= 1e-6 * (1 + np.abs(tau_ref)))
    assert np.all(np.abs(got.variance.numpy() - var_ref) <= 1e-6 * (1 + np.abs(var_ref)))
    assert np.isfinite(got.cate.numpy()).all() and (got.variance.numpy() >= 0).all()


def test_average_treatment_effect_on_jax_nuisances(grown):
    """The AIPW step and the mean-of-CATEs demo on the carried-across
    forest and common nuisances: |Δ| ≤ 1e-6."""
    x, wt, yt = grown["x"], grown["wt"], grown["yt"]
    rng = np.random.default_rng(8)
    w_hat = np.clip(0.5 + 0.2 * rng.normal(size=len(wt)), 0.05, 0.95).astype(np.float32)
    w = (w_hat + wt > 0.5).astype(np.float32)
    y_hat = (0.3 + 0.1 * x[:, 0]).astype(np.float32)
    y = y_hat + yt
    with jax.enable_x64(False):
        jfit = jcf.FittedCausalForest(grown["jfo"], *(jnp.asarray(a) for a in (y_hat, w_hat, x, y, w)))
        jeff = jcf.average_treatment_effect(jfit)
        jbad = jcf.incorrect_forest_ate(jcf.predict_cate(grown["jfo"], jnp.asarray(x)))
    tfit = tcf.FittedCausalForest(tcf.causal_forest_from_jax(grown["ref"], device="cpu"),
                                  *(torch.as_tensor(a) for a in (y_hat, w_hat, x, y, w)))
    teff = tcf.average_treatment_effect(tfit)
    tbad = tcf.incorrect_forest_ate(tcf.predict_cate(tfit.forest, torch.as_tensor(x)))
    for a, b in ((teff.estimate, jeff.estimate), (teff.std_err, jeff.std_err),
                 (tbad[0], jbad[0]), (tbad[1], jbad[1])):
        assert abs(float(a) - float(b)) <= 1e-6, (float(a), float(b))


def test_group_chunking_does_not_change_the_forest(grown):
    """Group i grows from split(key, n_groups)[i] whatever the chunking,
    and equals the JAX package's padded dispatch plan (``in_sample``)."""
    cfg = grown["cfg"]
    other = tcf.grow_causal_forest(
        torch.as_tensor(grown["x"]), torch.as_tensor(grown["wt"]), torch.as_tensor(grown["yt"]),
        rnd.key_from_jax(grown["key_data"], device="cpu"), group_chunk=1, **cfg)
    for f in FIELDS:
        assert torch.equal(getattr(other, f), getattr(grown["mine"], f)), f


def _frames(seed, n, p):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x[:, 1] + (0.5 + x[:, 2]) * w)))).astype(np.float32)
    return (JFrame(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)),
            TFrame(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(y)))


def test_causal_forest_report_within_bound():
    """The notebook row end to end at a small size: nuisance forests (y,
    w ∈ {0, 1}: integer histograms, exact), OOB means, the causal grow,
    predict_cate and the AIPW step, each package growing its own
    forests. Tie flips move whole rows between leaves, hence the wider
    bound: |Δ| ≤ 2e-2 on the ATEs and SEs."""
    jframe, tframe = _frames(5, 400, 5)
    kw = dict(n_trees=8, depth=4, nuisance_trees=8, nuisance_depth=4, n_bins=16,
              hist_mode="dense")
    with jax.enable_x64(False):
        k = jax.random.key(7)
        ref = jce.causal_forest_report(jframe, key=k, hist_backend="pallas_interpret", **kw)
        key_data = np.asarray(jax.random.key_data(k))
    got = tce.causal_forest_report(tframe, key=rnd.key_from_jax(key_data, device="cpu"), **kw)
    assert got.result.method == ref.result.method == "Causal Forest(GRF)"
    for a, b in ((got.result.ate, ref.result.ate), (got.result.se, ref.result.se),
                 (got.incorrect_ate, ref.incorrect_ate), (got.incorrect_se, ref.incorrect_se)):
        assert np.isfinite(a) and abs(a - b) <= 2e-2, (a, b)
    assert got.result.se > 0


def test_compute_leaf_index_equals_jax(grown):
    """The route kernel's leaf index of every (tree, row) on a forest
    carried across: exact, in the JAX package's storage type."""
    x = grown["x"]
    with jax.enable_x64(False):
        ref = np.asarray(jcf.compute_leaf_index(grown["jfo"], jnp.asarray(x), tree_chunk=2))
    got = tcf.compute_leaf_index(tcf.causal_forest_from_jax(grown["ref"], device="cpu"),
                                 torch.as_tensor(x), tree_chunk=3).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_causal_forest_ate_is_the_reports_row():
    _, tframe = _frames(6, 300, 4)
    kw = dict(key=rnd.key(3, device="cpu"), n_trees=4, depth=3, nuisance_trees=4,
              nuisance_depth=3, n_bins=16)
    row = tce.causal_forest_ate(tframe, **kw)
    times = {}
    assert row == tce.causal_forest_report(tframe, stage_times=times, **kw).result
    assert sorted(times) == ["aipw", "causal_grow", "nuisance", "predict_cate"]
