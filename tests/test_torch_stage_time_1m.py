"""``scripts/torch_stage_time_1m.py`` (the port's twin of
``scripts/stage_time_1m.py``) and the paths only a large n takes, against
the JAX package on the CPU at small sizes. The JAX side runs without x64,
as in production, with its default backends (what the JAX script calls);
its references are built here from the same ``jax.random`` calls as
``bench.py:75-84`` and ``scripts/stage_time_1m.py:47-56`` (importing
either would switch on XLA's persistent cache for the whole worker).

Contracts and bounds:

* the two panels (``make_panel``, ``make``) at n = 4,096: bit for bit.
  The sigmoids are taken in float64 and rounded once, while
  ``jax.nn.sigmoid`` rounds otherwise by an ulp; a 0/1 draw differs only
  where its uniform falls between the two roundings (about 1e-8 a row);
* the six stages at 2,048 rows (4 nuisance trees of depth 9, 8 causal
  trees of depth 8) from one key: Ŵ bit for bit (a 0/1 target, integer
  histogram weights); the Y forest's splits differ only at float ties and
  its training-row leaf values and Ŷ within 8·eps_f32·(1 + |·|) (as
  ``tests/test_torch_forest.py`` holds a continuous target); the causal
  grow on the port's residuals: half-samples exact, splits agreeing on at
  least 90% and every differing split a tie (as
  ``tests/test_torch_causal_forest.py``); the CATE + AIPW stage within
  1e-6 on one forest, and end to end within 0.1 SE (ATE) and 1% (SE);
* the Poisson path as ``style="auto"`` reaches it: the same threshold,
  n = 100,001 selects it in both packages, B = 10,000 at n = 1,000,000
  gives a chunk of 125 in both (no draw); at n = 100,001, B = 50, chunk
  25 the counts are bit for bit and the taus within the bound
  :func:`poisson_tau_bound` derives from the two summation orders (a
  worst case over any order, ~5e-3; seen: 2.2e-8, 4e-6 of it);
* the leaf index and the predict across the JAX package's row blocks
  (``row_chunk`` 4,096 at n = 10,000, on one forest in both packages):
  the leaf index bit for bit; the JAX package's blocked predict equals
  its unblocked one bit for bit (its rows are independent), and the
  port's equals itself bit for bit with and without the leaf index and
  at either ``row_chunk``; port against JAX within 1e-6·(1 + |·|), the
  bound of ``test_predict_cate_on_a_forest_carried_across``, but for the
  rows whose pooled Var(w̃) is rounding residue at the 1e-12 validity test
  (at most 0.1% of them; seen: one of 10,000);
* the script's CLI (``--device cpu --once``) runs all six stages, the
  predict and the AIPW, and prints them.
"""

import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import bootstrap as tbt
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.models import forest as jf
from ate_replication_causalml_tpu.ops import bootstrap as jbt
from tests.test_torch_causal_forest import (
    honest_masks,
    path_differs,
    route_to_level,
    split_comparison,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(_REPO, "scripts", "torch_stage_time_1m.py")
EPS32 = float(np.finfo(np.float32).eps)
U32 = EPS32 / 2   # float32's unit roundoff


def _load_script():
    spec = importlib.util.spec_from_file_location("torch_stage_time_1m", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


st = _load_script()


def jax_make_panel(key, n):
    """``bench.py:75-84``."""
    kx, kw, ky = jax.random.split(key, 3)
    x = jax.random.normal(kx, (n, 21), dtype=jnp.float32)
    logits_w = -1.6 + 0.3 * x[:, 0] - 0.2 * x[:, 1]
    w = (jax.random.uniform(kw, (n,)) < jax.nn.sigmoid(logits_w)).astype(jnp.float32)
    logits_y = -0.5 + 0.8 * x[:, 2] + 0.4 * w
    y = (jax.random.uniform(ky, (n,)) < jax.nn.sigmoid(logits_y)).astype(jnp.float32)
    return x, w, y


def jax_make(n):
    """``scripts/stage_time_1m.py:47-56``."""
    key = jax.random.key(0)
    kx, kw, ky = jax.random.split(key, 3)
    x = jax.random.normal(kx, (n, 21), dtype=jnp.float32)
    tau = 1.0 + (x[:, 0] > 0)
    w = (jax.random.uniform(kw, (n,)) < jax.nn.sigmoid(0.8 * x[:, 1])).astype(jnp.float32)
    y = 0.5 * x[:, 1] + tau * w + 0.5 * jax.random.normal(ky, (n,))
    return x, w, y.astype(jnp.float32)


def test_panels_bit_for_bit():
    n = 4096
    with jax.enable_x64(False):
        ref_panel = [np.asarray(a) for a in jax_make_panel(jax.random.key(0), n)]
        ref_make = [np.asarray(a) for a in jax_make(n)]
    panel = st.make_panel(rnd.key(0, device="cpu"), n)
    frame = st.make(n, "cpu")
    for got, want in zip((*panel, frame.x, frame.w, frame.y), ref_panel + ref_make):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)
    # The two panels share their covariates; both W are 0/1 draws, both
    # non-trivial.
    assert torch.equal(panel[0], frame.x)
    for w in (panel[1], frame.w, panel[2]):
        assert set(np.unique(w.numpy())) == {0.0, 1.0}
    drawn = st.draw_panels(n, "cpu")
    assert st.panel_differences(drawn, {"x": frame.x, "panel_w": panel[1], "panel_y": panel[2],
                                        "make_w": frame.w, "make_y": frame.y}) == {
        "panel": 0, "make": 0}


SIX = dict(n=2048, trees=8, nuisance_trees=4, seed=1)


@pytest.fixture(scope="module")
def six_stages():
    """The twin's ``run`` (the six stages) and the JAX package's calls of
    ``scripts/stage_time_1m.py:run`` from the same key on the same panel:
    both nuisance forests and their OOB means; the causal grow on the
    port's residuals (so its splits compare split for split), and the
    AIPW step on that forest and the port's nuisances. Also the port's Y
    forest, fit again from its key (``run`` releases it)."""
    n, seed, nt = SIX["n"], SIX["seed"], SIX["nuisance_trees"]
    fitted, rec = st.run(st.make(n, "cpu"), SIX["trees"], seed, "test", nuisance_trees=nt)
    wt = fitted.w - fitted.w_hat
    yt = fitted.y - fitted.y_hat
    with jax.enable_x64(False):
        x, w, y = jax_make(n)
        ky, kw_, kc = jax.random.split(jax.random.key(seed), 3)
        fy = jf.fit_forest_regressor(x, y, ky, n_trees=nt, depth=9)
        w_hat = jf.forest_oob_mean(jf.fit_forest_regressor(x, w, kw_, n_trees=nt, depth=9), x)
        forest = jcf.grow_causal_forest(x, jnp.asarray(wt.numpy()), jnp.asarray(yt.numpy()), kc,
                                        n_trees=SIX["trees"], depth=8)
        eff = jcf.average_treatment_effect(jcf.FittedCausalForest(
            forest=forest, y_hat=jnp.asarray(fitted.y_hat.numpy()),
            w_hat=jnp.asarray(fitted.w_hat.numpy()), x=x, y=y, w=w))
        ref = {"y_forest": {f: np.asarray(getattr(fy, f)) for f in
                            ("split_feat", "split_bin", "counts", "train_leaf")},
               "w_hat": np.asarray(w_hat),
               **{f: np.asarray(getattr(forest, f)) for f in
                  ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")},
               "ate": float(eff.estimate), "se": float(eff.std_err),
               "ky": np.asarray(jax.random.key_data(ky)),
               "kc": np.asarray(jax.random.key_data(kc))}
    y_forest = tf.fit_forest_regressor(fitted.x, fitted.y, rnd.key_from_jax(ref["ky"], "cpu"),
                                       n_trees=nt, depth=9)
    return ref, fitted, rec, y_forest


def test_six_stages_record(six_stages):
    _, fitted, rec, _ = six_stages
    assert list(rec["stages"]) == ["fit_y", "oob_y", "fit_w", "oob_w", "grow", "cate_aipw"]
    for row in rec["stages"].values():
        # On the CPU no kernel launches and no device peak is read.
        assert row["s"] >= 0 and row["peak_bytes"] is None and row["launches"] == {}
    assert fitted.forest.n_trees == SIX["trees"] and fitted.forest.depth == 8


def test_six_stages_nuisances(six_stages):
    """Ŵ bit for bit (a 0/1 target: integer weights, exact sums). The Y
    forest (a continuous target): bootstrap counts exact; every split
    that differs below agreeing ones is a float tie (both candidates'
    float64 SSE on the node's in-bag rows within 1e-5 relative, as in
    ``tests/test_torch_forest.py``); a training row's leaf value within
    8·eps_f32·(1 + |·|) wherever its whole path agrees; Ŷ is the mean of
    those values over the row's out-of-bag trees (recomputed here in
    float64 from the port's forest, within 8·eps_f32·(1 + |Ŷ|))."""
    ref, fitted, _, mine = six_stages
    assert np.array_equal(fitted.w_hat.numpy(), ref["w_hat"])
    rf = ref["y_forest"]
    assert np.array_equal(mine.counts.numpy(), rf["counts"])
    x, y = fitted.x, fitted.y.numpy().astype(np.float64)
    codes = tf.binarize(x, mine.bin_edges)
    cnp = codes.numpy()
    c = mine.counts.numpy().astype(np.float64)
    mu = (c * y).sum(axis=1) / c.sum(axis=1)
    feat, bins = mine.split_feat.numpy(), mine.split_bin.numpy()
    differs = (feat != rf["split_feat"]) | (bins != rf["split_bin"])
    for t, lv, m in np.argwhere(differs):
        if path_differs(differs, t, lv, m):
            continue
        rows = route_to_level(codes, mine.split_feat, mine.split_bin, lv)[t] == m
        ct, yt = c[t, rows], c[t, rows] * (y[rows] - mu[t])

        def score(f, b):
            left = cnp[rows, f] <= b
            cl, cr, yl, yr = ct[left].sum(), ct[~left].sum(), yt[left].sum(), yt[~left].sum()
            return -(yl * yl / max(cl, 1e-12) + yr * yr / max(cr, 1e-12))

        s_mine, s_ref = score(feat[t, lv, m], bins[t, lv, m]), score(rf["split_feat"][t, lv, m],
                                                                    rf["split_bin"][t, lv, m])
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)
    leaf = route_to_level(codes, mine.split_feat, mine.split_bin, 9)
    agrees = np.stack([[not path_differs(differs, t, 9, j) for j in leaf[t]]
                       for t in range(mine.n_trees)])
    tl, jl = mine.train_leaf.numpy(), rf["train_leaf"]
    assert agrees.mean() >= 0.5
    assert np.all(np.abs(tl - jl)[agrees] <= 8 * EPS32 * (1 + np.abs(jl[agrees])))
    oob = c == 0
    y_hat = (tl * oob).sum(axis=0, dtype=np.float64) / np.maximum(oob.sum(axis=0), 1)
    got = fitted.y_hat.numpy()
    assert np.all(np.abs(got - y_hat) <= 8 * EPS32 * (1 + np.abs(y_hat)))


def test_six_stages_causal_grow(six_stages):
    """The grow on the port's residuals: half-samples and bin edges
    exact; splits as ``tests/test_torch_causal_forest.py`` holds them."""
    ref, fitted, _, _ = six_stages
    mine = fitted.forest
    assert np.array_equal(mine.in_sample.numpy(), ref["in_sample"])
    assert np.array_equal(mine.bin_edges.numpy(), ref["bin_edges"])
    wt = (fitted.w - fitted.w_hat).numpy()
    yt = (fitted.y - fitted.y_hat).numpy()
    grow = honest_masks(mine, ref["kc"], SIX["n"])[1]
    agreement, ties, _ = split_comparison(fitted.x.numpy(), wt, yt, ref, mine, grow)
    assert agreement >= 0.9, agreement
    for t, lv, m, s_mine, s_ref in ties:
        assert np.isfinite(s_mine) and np.isfinite(s_ref), (t, lv, m, s_mine, s_ref)
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)


def test_six_stages_ate_and_se(six_stages):
    """The CATE + AIPW stage on the JAX package's forest carried across
    and the same nuisances: ATE and SE within 1e-6 (the AIPW step's bound
    in ``tests/test_torch_causal_forest.py``). End to end, each on its own
    forest: a tie flip moves whole rows between leaves, and with 8 trees a
    row's CATE rests on about 4 out-of-bag trees, so the ATE is held
    within 0.1 of its SE and the SE within 1% (seen: 0.045 SE and 0.23%)."""
    ref, fitted, rec, _ = six_stages
    carried = tcf.FittedCausalForest(forest=tcf.causal_forest_from_jax(ref, device="cpu"),
                                     y_hat=fitted.y_hat, w_hat=fitted.w_hat, x=fitted.x,
                                     y=fitted.y, w=fitted.w)
    eff = tcf.average_treatment_effect(carried)
    assert abs(float(eff.estimate) - ref["ate"]) <= 1e-6
    assert abs(float(eff.std_err) - ref["se"]) <= 1e-6
    assert math.isfinite(rec["ate"]) and abs(rec["ate"] - ref["ate"]) <= 0.1 * ref["se"]
    assert rec["se"] > 0 and abs(rec["se"] - ref["se"]) <= 0.01 * ref["se"]


def test_poisson_is_autos_choice_above_the_threshold(monkeypatch):
    """``style="auto"`` takes the Poisson path above 100,000 rows and the
    chunk rule gives 125 a chunk at 1M × 10,000 in both packages: the
    replicate functions are replaced by recorders, so nothing is drawn."""
    assert tbt.POISSON_AUTO_THRESHOLD == jbt.POISSON_AUTO_THRESHOLD == 100_000
    seen = []

    def recorder(style, zeros):
        def fn(*a, n_boot, chunk, **k):
            seen.append((style, chunk))
            return zeros(n_boot)
        return fn

    for mod, zeros in ((jbt, jnp.zeros), (tbt, torch.zeros)):
        monkeypatch.setattr(mod, "aipw_bootstrap_taus_poisson", recorder("poisson", zeros))
        monkeypatch.setattr(mod, "aipw_bootstrap_taus_chunked", recorder("multinomial", zeros))
    cases = ((1_000_000, 10_000), (100_001, 50), (100_000, 50))
    for n, b in cases:
        for mod, arr in ((jbt, jnp.zeros((n,), jnp.float32)), (tbt, torch.zeros(n))):
            key = jax.random.key(0) if mod is jbt else rnd.key(0, device="cpu")
            mod.aipw_bootstrap_se(arr, arr, arr, arr, arr, key=key, n_boot=b)
    assert seen == [("poisson", 125)] * 2 + [("poisson", 50)] * 2 + [("multinomial", 50)] * 2


def _aipw_vectors(n, seed=21):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.95, n).astype(np.float32)
    w = (rng.random(n) < p).astype(np.float32)
    mu0 = rng.uniform(0.1, 0.9, n).astype(np.float32)
    mu1 = np.clip(mu0 + rng.normal(0.1, 0.05, n), 0.01, 0.99).astype(np.float32)
    y = (rng.random(n) < np.where(w > 0, mu1, mu0)).astype(np.float32)
    return w, y, p, mu0, mu1


def poisson_tau_bound(counts, e1, e2):
    """The largest |Δτ| the two packages' summation orders allow, per
    replicate, for τ = A/B + C/D with A = Σcᵢe1ᵢ, B = Σcᵢ (every est1
    finite), C = Σcᵢe2ᵢ, D = Σcᵢ. B and D are sums of integers below
    2²⁴: exact in float32 in any order. A product cᵢe1ᵢ rounds once; a
    float32 sum of n terms in ANY order is within γ_{n−1}·Σ|terms| of the
    exact sum (γ_k = k·u/(1 − k·u), u the unit roundoff). The port's
    ``c @ e1`` is a BLAS order, so it takes the any-order bound γ_n; the
    JAX package's ``sum(c * e1)`` is XLA:CPU's windowed reduction
    (windows of 32 summed in order, window sums likewise), at most
    32 additions a window level, ⌈log₃₂ n⌉ levels: γ_{32·levels + 1}.
    Each division and the final add round once more (u each)."""
    n = counts.shape[1]
    levels = math.ceil(math.log(n, 32))
    g = lambda k: k * U32 / (1 - k * U32)
    c = counts.astype(np.float64)
    d = c.sum(axis=1)
    out = np.zeros(c.shape[0])
    for e in (e1, e2):
        s_abs = (c * np.abs(e.astype(np.float64))).sum(axis=1)
        q = (c * e.astype(np.float64)).sum(axis=1) / d
        out += (g(n) + g(32 * levels + 1)) * s_abs / d + 2 * U32 * np.abs(q)
    tau = ((c * e1.astype(np.float64)).sum(axis=1) + (c * e2.astype(np.float64)).sum(axis=1)) / d
    return out + 2 * U32 * np.abs(tau)


def test_poisson_counts_and_taus_at_the_threshold(monkeypatch):
    """n = 100,001, B = 50, chunk 25 through ``aipw_bootstrap_se`` (style
    "auto"): each package's replicate taus are recorded as "auto" draws
    them, and its SE is their SD."""
    n, b, chunk = 100_001, 50, 25
    vec = _aipw_vectors(n)
    taus = {}
    for name, mod in (("jax", jbt), ("port", tbt)):
        orig = mod.aipw_bootstrap_taus_poisson

        def keep(*a, _orig=orig, _name=name, **k):
            taus[_name] = _orig(*a, **k)
            return taus[_name]

        monkeypatch.setattr(mod, "aipw_bootstrap_taus_poisson", keep)
    with jax.enable_x64(False):
        k = jax.random.key(5)
        j_se = float(jbt.aipw_bootstrap_se(*(jnp.asarray(v) for v in vec), key=k, n_boot=b,
                                           chunk=chunk))
        j_taus = np.asarray(taus["jax"])
        assert j_se == float(np.asarray(jbt.sd(taus["jax"])))
        j_counts = [np.asarray(jbt._poisson1_counts(ck, (chunk, n)))
                    for ck in jax.random.split(k, b // chunk)]
        key_data = np.asarray(jax.random.key_data(k))
    tk = rnd.key_from_jax(key_data, device="cpu")
    t_se = float(tbt.aipw_bootstrap_se(*(torch.as_tensor(v) for v in vec), key=tk, n_boot=b,
                                       chunk=chunk))
    t_taus = taus["port"].numpy()
    assert t_se == float(tbt.sd(taus["port"]))
    t_counts = [tbt._poisson1_counts(ck, (chunk, n)).numpy() for ck in rnd.split(tk, b // chunk)]
    for a, c in zip(t_counts, j_counts):
        assert np.array_equal(a, c)
    w, y, p, mu0, mu1 = vec
    e1 = (w * (y - mu1) / p + (1.0 - w) * (y - mu0) / (1.0 - p)).astype(np.float32)
    e2 = (mu1 - mu0).astype(np.float32)
    bound = poisson_tau_bound(np.concatenate(t_counts), e1, e2)
    assert np.all(np.abs(t_taus - j_taus) <= bound), np.max(np.abs(t_taus - j_taus) / bound)


def _forest_pair(n, p=21, n_bins=64, depth=8, trees=8, seed=9):
    """One random causal forest in both packages, made by numpy from a
    seed: random split tables, and honest leaf statistics summed from
    residuals with a heterogeneous effect over a random estimate half of
    each tree's random half-sample. Returns the rows too."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    edges = np.sort(np.quantile(x, np.linspace(0, 1, n_bins + 1)[1:-1], axis=0).T, axis=1)
    half = 1 << (depth - 1)
    feat = rng.integers(0, p, size=(trees, depth, half)).astype(np.int32)
    bins = rng.integers(0, n_bins, size=(trees, depth, half)).astype(np.int32)
    codes = tf.binarize(torch.as_tensor(x), torch.as_tensor(edges.astype(np.float32)))
    leaf = route_to_level(codes, torch.as_tensor(feat), torch.as_tensor(bins), depth)
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = ((1.0 + x[:, 0]) * wt + 0.3 * rng.normal(size=n)).astype(np.float32)
    chan = np.stack([np.ones_like(wt), wt, yt, wt * wt, wt * yt], axis=1)
    in_sample = rng.random((trees // 2, n)) < 0.5
    in_sample = np.repeat(in_sample, 2, axis=0)
    est = in_sample & (rng.random((trees, n)) < 0.5)
    stats = np.zeros((trees, 1 << depth, 5), np.float32)
    for t in range(trees):
        np.add.at(stats[t], leaf[t][est[t]], chan[est[t]])
    arrays = {"split_feat": feat, "split_bin": bins, "leaf_stats": stats,
              "in_sample": in_sample, "bin_edges": edges.astype(np.float32)}
    jfo = jcf.CausalForest(**{k: jnp.asarray(v) for k, v in arrays.items()}, ci_group_size=2)
    return x, arrays, jfo, tcf.causal_forest_from_jax(arrays, device="cpu")


def test_leaf_index_and_predict_across_the_jax_row_blocks():
    n, block = 10_000, 4096
    x, _, jfo, mine = _forest_pair(n)
    with jax.enable_x64(False):
        jx = jnp.asarray(x)
        j_li = np.asarray(jcf.compute_leaf_index(jfo, jx, row_chunk=block))
        blocked = jcf.predict_cate(jfo, jx, oob=True, row_chunk=block)
        whole = jcf.predict_cate(jfo, jx, oob=True)
        j_cate, j_var = np.asarray(blocked.cate), np.asarray(blocked.variance)
        assert np.array_equal(j_cate, np.asarray(whole.cate))
        assert np.array_equal(j_var, np.asarray(whole.variance))
    tx = torch.as_tensor(x)
    t_li = tcf.compute_leaf_index(mine, tx)
    assert t_li.numpy().dtype == j_li.dtype and np.array_equal(t_li.numpy(), j_li)
    assert torch.equal(tcf.compute_leaf_index(mine, tx, row_chunk=block), t_li)
    plain = tcf.predict_cate(mine, tx, oob=True)
    for other in (tcf.predict_cate(mine, tx, oob=True, leaf_index=t_li),
                  tcf.predict_cate(mine, tx, oob=True, row_chunk=block, leaf_index=t_li)):
        assert torch.equal(other.cate, plain.cate) and torch.equal(other.variance, plain.variance)
    cate, var = plain.cate.numpy(), plain.variance.numpy()
    # A row whose only valid leaves hold one estimate row each has a
    # pooled Var(w̃) of rounding residue: the validity test (> 1e-12)
    # zeroes its CATE in one package and not in the other. Such rows are
    # left out of the bound, and are few.
    degenerate = (cate == 0) != (j_cate == 0)
    assert degenerate.mean() <= 1e-3, degenerate.sum()
    ok = ~degenerate
    assert np.all(np.abs(cate - j_cate)[ok] <= 1e-6 * (1 + np.abs(j_cate[ok])))
    assert np.all(np.abs(var - j_var)[ok] <= 1e-6 * (1 + np.abs(j_var[ok])))
    assert (var >= 0).all() and (var > 0).any() and np.isfinite(cate).all()


def test_cli_runs_every_stage_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The CLI at 300 rows, with the nuisance forests and the bootstrap
    cut (4 trees, 100 replicates) for the CPU's time."""
    monkeypatch.setattr(st, "NUISANCE_TREES", 4)
    monkeypatch.setattr(st, "N_BOOT", 100)
    trace = tmp_path / "trace.json"
    st.main(["--device", "cpu", "--once", "--rows", "300", "--trees", "8", "--predict", "--aipw",
             "--trace-out", str(trace)])
    lines = capsys.readouterr().out.strip().splitlines()
    text = "\n".join(lines)
    for stage in ("fit_y", "oob_y", "fit_w", "oob_w", "grow", "cate_aipw", "leaf_index",
                  "predict_2", "aipw_3"):
        assert f".{stage}: " in text, stage
    assert "[steady]" not in text
    out = json.loads(lines[-1])
    assert out["device"] == "cpu" and out["rows"] == 300 and "steady" not in out
    assert list(out["first"]["stages"]) == ["fit_y", "oob_y", "fit_w", "oob_w", "grow",
                                            "cate_aipw"]
    assert math.isfinite(out["first"]["ate"]) and out["first"]["se"] > 0
    assert math.isfinite(out["predict"]["mean_cate"]) and out["predict"]["mean_var"] >= 0
    assert out["aipw"]["n_boot"] == 100 and out["aipw"]["boot_se"] > 0
    assert out["aipw"]["plugin_se"] > 0
    legs = [e for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("name") == "bench_leg" and e.get("args", {}).get("leg") == "first"]
    assert legs
