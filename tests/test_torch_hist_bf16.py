"""The bf16 form of the histograms (``bf16=True``; ``hist_backend=
"pallas_bf16"``) against the JAX package's bf16 kernels, which run in
interpret mode as its own tests run them (``bin_histogram_pallas(...,
bf16=True, interpret=True)`` and the batched and shared entries), in the
dense, partition and partition+pack formulations; and the forests grown
under "pallas_bf16" against the JAX package's, whose growers put their
Pallas calls in interpret mode here through ``monkeypatch`` on
``hist_pallas._pallas_batched_vmappable``,
``_pallas_batched_shared_vmappable`` and ``tree_pallas._route_vmappable``
/ ``_lookup_vmappable`` (their ``__wrapped__`` with ``interpret=True``).
The JAX side runs without x64, as in production.

Contracts and bounds:

* integer weights (Poisson counts and counts·y01, in [-256, 256]): bf16
  rounds them to themselves and every sum is exact, so the port's bf16
  histograms are ``array_equal`` to the JAX package's bf16 kernels and to
  the port's own float32 form, and the bf16 classifier forest equals the
  JAX package's and the port's "auto" forest field for field;
* weights halfway between two bfloat16 values round to even in both
  packages (``array_equal`` on the rounded values and on histograms of
  them, whose sums are exact);
* float weights (a regressor's counts·y, the causal forest's five
  channels): both sides add the same bf16-rounded addends in float32, in
  another order, so a cell may differ by the roundings of its running
  sum: |Δ| ≤ 64·eps_f32·Σ|w_bf16| per (tree, channel), the bound the
  card's float histograms are held to (``chip_smoke.py``, FLOAT_ULPS);
* the regressor's and the causal forest's splits agree except where two
  candidates tie on those float32 sums: each differing split whose path
  agrees scores within its float32 rounding of the JAX package's choice
  in float64 on the node's bf16-rounded addends (the regressor: the
  bound of ``test_torch_growers_matmul.py``; the causal forest: 1e-5
  relative, as ``test_torch_causal_forest.py``); leaves stay float32
  sums, as in the JAX package (``forest.py:1207-1211``,
  ``causal_forest.py:562``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops import tree as tt
from ate_replication_causalml_tpu.models import forest as jf
from ate_replication_causalml_tpu.ops import hist_pallas as jh
from ate_replication_causalml_tpu.ops import tree_pallas as jtp
from tests.test_torch_causal_forest import (
    MIN_NODE,
    causal_pair,
    honest_masks,
    path_differs,
    residuals,
    route_to_level,
)
from tests.test_torch_growers_matmul import _node_rows, _tie_bound

N_BINS = 64
EPS32 = float(np.finfo(np.float32).eps)
FLOAT_ULPS = 64
FORMS = ("dense", "partition", "partition+pack")
FOREST_FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges")
FOREST_KW = dict(n_trees=6, depth=4, n_bins=16)


def _weights(kind, rng, t, n):
    """(T, K, n) float32: "integer" K=2 Poisson counts and counts·y01;
    "regressor" K=2 counts and counts·(a continuous y); "rho" the
    causal grower's five channels [1, w̃, ỹ, w̃², w̃ỹ] (shared: (5, n))."""
    if kind == "rho":
        wt = (rng.random(n) - 0.4).astype(np.float32)
        yt = rng.normal(size=n).astype(np.float32)
        return np.stack([np.ones(n, np.float32), wt, yt, wt * wt, wt * yt])
    counts = rng.poisson(1.0, size=(t, n)).astype(np.float32)
    y = ((rng.random(n) < 0.4) if kind == "integer" else rng.normal(size=n)).astype(np.float32)
    return np.ascontiguousarray(np.stack([counts, counts * y], axis=1))


def _case(seed, kind, n=1800, p=21, t=3, m=16):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 1, size=(t, n)).astype(np.int32)  # −1 and m drop out
    return codes, ids, _weights(kind, rng, t, n)


def _jax(codes, ids, w, m, form):
    """The JAX package's bf16 kernel in interpret mode."""
    entry = (jh.bin_histogram_pallas_batched_shared if w.ndim == 2
             else jh.bin_histogram_pallas_batched)
    with jax.enable_x64(False):
        return np.asarray(entry(jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(w),
                                max_nodes=m, n_bins=N_BINS, interpret=True, bf16=True,
                                partition=form != "dense", pack=form.endswith("pack")))


def _port(codes, ids, w, m, form, bf16=True):
    wrapper = th.bin_histogram_shared if w.ndim == 2 else th.bin_histogram_batched
    return wrapper(torch.as_tensor(codes), torch.as_tensor(ids), torch.as_tensor(w), max_nodes=m,
                   n_bins=N_BINS, mode=form, bf16=bf16).numpy()


def _jax_bf16(w):
    """XLA's astype to bfloat16 and back, as the JAX kernels round."""
    with jax.enable_x64(False):
        return np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))


def _within_bound(got, ref, w):
    """|Δ| ≤ 64·eps·Σ|w_bf16| per (tree, channel) of a (T, K, M, p, b) output."""
    scale = np.abs(_jax_bf16(w)).sum(axis=-1)
    scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
    return bool(np.all(np.abs(got - ref) <= FLOAT_ULPS * EPS32 * scale))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_integer_weights_equal_jax_bf16_and_f32(form, shared):
    """Integer weights: the port's bf16 form is the JAX package's bf16
    kernel and the port's float32 form, bit for bit (JAX's
    ``test_bf16_kernel_bit_exact_for_integer_weights``)."""
    codes, ids, w = _case(3 + shared, "integer")
    if shared:
        w = np.ascontiguousarray(w[0])
    got = _port(codes, ids, w, 16, form)
    assert np.array_equal(got, _jax(codes, ids, w, 16, form))
    assert np.array_equal(got, _port(codes, ids, w, 16, form, bf16=False))


def test_single_tree_is_the_t1_case():
    """``bin_histogram(bf16=True)``: the JAX package's single-tree
    ``bin_histogram_pallas(bf16=True)`` on float weights, within the bound."""
    codes, ids, w = _case(5, "regressor", t=1, m=8)
    with jax.enable_x64(False):
        ref = np.asarray(jh.bin_histogram_pallas(
            jnp.asarray(codes), jnp.asarray(ids[0]), jnp.asarray(w[0]), max_nodes=8,
            n_bins=N_BINS, interpret=True, bf16=True))
    got = th.bin_histogram(torch.as_tensor(codes), torch.as_tensor(ids[0]),
                           torch.as_tensor(w[0]), max_nodes=8, n_bins=N_BINS, bf16=True).numpy()
    assert _within_bound(got[None], ref[None], w)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["regressor", "rho"])
def test_float_weights_within_bound_of_jax_bf16(kind, form):
    """Float weights: the same bf16-rounded addends summed in another
    order, within 64·eps·Σ|w_bf16|; and not the float32 form's sums."""
    codes, ids, w = _case(7, kind, m=32)
    got = _port(codes, ids, w, 32, form)
    assert _within_bound(got, _jax(codes, ids, w, 32, form), w)
    assert not np.array_equal(got, _port(codes, ids, w, 32, form, bf16=False))


def test_forms_equal_each_other_bit_for_bit():
    """Dense, partition and packed add each cell's rows in one order, so
    the bf16 form gives one answer for float weights too."""
    codes, ids, w = _case(9, "rho", m=64)
    dense = _port(codes, ids, w, 64, "dense")
    for form in FORMS[1:]:
        assert np.array_equal(_port(codes, ids, w, 64, form), dense), form


def _halfway(seed, shape):
    """float32 values exactly halfway between two adjacent bfloat16
    values (low 16 bits 0x8000), of both signs, magnitudes in [0.5, 8)."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0x3F00, 0x4100, size=shape).astype(np.uint32)
    sign = rng.integers(0, 2, size=shape).astype(np.uint32) << 15
    return (((hi | sign) << 16) | 0x8000).view(np.float32)


def test_halfway_weights_round_to_even_as_jax():
    """Ties: ``round_bf16`` rounds as XLA's astype (to even; both
    directions occur), and histograms of tie weights (exact sums: 8-bit
    mantissas over four binades) equal the JAX package's bf16 kernel in
    every form."""
    w = _halfway(11, (2, 2, 1500))
    rounded = th.round_bf16(torch.as_tensor(w)).numpy()
    assert np.array_equal(rounded, _jax_bf16(w))
    up = np.abs(rounded) > np.abs(w)
    assert up.any() and (~up).any()
    rng = np.random.default_rng(12)
    codes = rng.integers(0, N_BINS, size=(1500, 21)).astype(np.int32)
    ids = rng.integers(-1, 9, size=(2, 1500)).astype(np.int32)
    for form in FORMS:
        assert np.array_equal(_port(codes, ids, w, 8, form), _jax(codes, ids, w, 8, form)), form


def test_partition_sort_plain_rounds_the_gathered_weights():
    """The partition passes' first step carries the weights rounded in
    the bf16 form (where the TPU kernel rounds its permuted weights)."""
    codes, ids, w = _case(13, "rho", n=900, m=8)
    t_ids, t_w = torch.as_tensor(ids), torch.as_tensor(w)
    plain = th.partition_sort_plain(t_ids, 8, 2, t_w)
    rounded = th.partition_sort_plain(t_ids, 8, 2, t_w, bf16=True)
    for a, b in zip(plain[:3], rounded[:3]):
        assert torch.equal(a, b)
    assert torch.equal(rounded[3], th.round_bf16(plain[3]))
    assert torch.equal(th.partition_sort(t_ids, 8, 2, t_w, bf16=True)[3], rounded[3])


# ---------------------------------------------------------------------------
# Forests under "pallas_bf16".
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's Pallas callables with ``interpret=True``: its
    growers take interpret mode only under "pallas_interpret", whose
    histograms are float32."""
    for name in ("_pallas_batched_vmappable", "_pallas_batched_shared_vmappable"):
        orig = getattr(jh, name)

        def forced(max_nodes, n_bins, bf16, interpret, partition=False, pack=False, _o=orig):
            return _o.__wrapped__(max_nodes, n_bins, bf16, True, partition, pack)

        monkeypatch.setattr(jh, name, functools.lru_cache(maxsize=None)(forced))
    for name in ("_route_vmappable", "_lookup_vmappable"):
        orig = getattr(jtp, name)
        monkeypatch.setattr(jtp, name, functools.lru_cache(maxsize=None)(
            lambda interpret, _o=orig: _o.__wrapped__(True)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    n, p = 400, 6
    x = rng.normal(size=(n, p)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2])  # heavy ties
    y01 = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    ycont = (2.0 + x[:, 0] - 0.5 * x[:, 1] + rng.normal(size=n)).astype(np.float32)
    return x, y01, ycont


def _fit(x, y, backend, seed=3):
    """(the JAX package's forest fields under "pallas_bf16", the port's
    forest under ``backend``), one key."""
    with jax.enable_x64(False):
        k = jax.random.key(seed)
        ref = jf.fit_forest_classifier(jnp.asarray(x), jnp.asarray(y), k,
                                       hist_backend="pallas_bf16", **FOREST_KW)
        ref = {f: np.asarray(getattr(ref, f)) for f in FOREST_FIELDS}
        key_data = np.asarray(jax.random.key_data(k))
    tk = rnd.key_from_jax(key_data, device="cpu")
    return ref, tf.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(y), tk,
                                         hist_backend=backend, **FOREST_KW)


def test_classifier_equals_jax_and_auto(jax_interpret, data):
    """A 0/1 target: the bf16 forest is the JAX package's bf16 forest and
    the port's "auto" forest, field for field."""
    x, y01, _ = data
    ref, mine = _fit(x, y01, "pallas_bf16")
    _, auto = _fit(x, y01, "auto")
    for f in FOREST_FIELDS:
        assert np.array_equal(getattr(mine, f).numpy(), ref[f]), f
        assert torch.equal(getattr(mine, f), getattr(auto, f)), f


def _regressor_addends(mine, y):
    """(counts, the bf16-rounded counts·(y − μ)) of every tree, float64:
    the y channel's addends as the port's grower forms them."""
    counts = mine.counts.to(torch.float32)
    yf = torch.as_tensor(y)
    mu = torch.sum(counts * yf, dim=1) / torch.clamp(torch.sum(counts, dim=1), min=1e-12)
    w = th.round_bf16(counts * (yf[None, :] - mu[:, None]))
    return counts.double().numpy(), w.double().numpy()


def test_regressor_splits_agree_or_tie_and_leaves_stay_f32(jax_interpret, data):
    x, _, ycont = data
    ref, mine = _fit(x, ycont, "pallas_bf16")
    assert np.array_equal(mine.counts.numpy(), ref["counts"])
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges).numpy()
    feat, bins = mine.split_feat.numpy(), mine.split_bin.numpy()
    differs = (feat != ref["split_feat"]) | (bins != ref["split_bin"])
    live = np.zeros_like(differs)
    for lv in range(mine.depth):
        live[:, lv, : 1 << lv] = True
    assert 1.0 - differs[live].mean() >= 0.9
    counts, w_bf = _regressor_addends(mine, ycont)
    for t, lv, m in np.argwhere(differs & live):
        if path_differs(differs, t, lv, m):
            continue
        rows = _node_rows(codes, feat, bins, t, lv, m)
        c, w = counts[t], w_bf[t]

        def score(f, b):
            left = rows & (codes[:, f] <= b)
            right = rows & ~left
            cl, cr, yl, yr = c[left].sum(), c[right].sum(), w[left].sum(), w[right].sum()
            return -(yl * yl / cl + yr * yr / cr), _tie_bound(
                lv, rows.sum(), np.abs(w[rows]).sum(), cl, cr, yl, yr)

        (s_mine, b_mine), (s_ref, b_ref) = score(feat[t, lv, m], bins[t, lv, m]), score(
            ref["split_feat"][t, lv, m], ref["split_bin"][t, lv, m])
        assert abs(s_mine - s_ref) <= b_mine + b_ref, (t, lv, m)
    # Leaves stay float32 sums of the unrounded weights (the bf16 form
    # stops at the split search): the grower's own leaf record of them,
    # bit for bit, and the JAX package's leaves on agreeing paths within
    # test_torch_growers_matmul.py's bound (the same sums in other orders).
    depth = mine.depth
    leaf_ids = torch.as_tensor(route_to_level(torch.as_tensor(codes), mine.split_feat,
                                              mine.split_bin, depth))
    c32, yf = mine.counts.to(torch.float32), torch.as_tensor(ycont)
    mu = torch.sum(c32 * yf, dim=1) / torch.clamp(torch.sum(c32, dim=1), min=1e-12)
    w2 = torch.stack([c32, c32 * (yf[None, :] - mu[:, None])], dim=1).contiguous()
    want, _ = tt.leaf_record(th.node_sums_plain(leaf_ids, w2, 1 << depth), mu, mu, leaf_ids)
    assert torch.equal(mine.leaf_value, want)
    for t in range(mine.n_trees):
        c = counts[t]
        mu64 = (c * ycont).sum() / c.sum()
        mu_err = len(c) * EPS32 * (c * np.abs(ycont)).sum() / c.sum()
        for j in range(1 << depth):
            if path_differs(differs, t, depth, j):
                continue
            rows = leaf_ids[t].numpy() == j
            cl = c[rows].sum()
            wabs = (c[rows] * np.abs(ycont[rows] - mu64)).sum() / max(cl, 1.0)
            bound = (2 * (rows.sum() * EPS32 * wabs + mu_err)
                     + 4 * EPS32 * abs(ref["leaf_value"][t, j]))
            assert abs(float(mine.leaf_value[t, j]) - ref["leaf_value"][t, j]) <= bound, (t, j)


def _causal_bf16_score(mom, rows, left):
    """The streaming grower's split score (``causal_forest.py::_tables``)
    in float64 on the node's bf16-rounded channels ``mom`` (n, 5)."""
    node, lsum = mom[rows].sum(axis=0), mom[rows & left].sum(axis=0)
    c, sw, sy, sww, swy = node
    wbar, ybar = sw / max(c, 1.0), sy / max(c, 1.0)
    varw = c * sww - sw * sw
    tau = (c * swy - sw * sy) / varw if varw > 1e-12 else 0.0

    def rho(s):
        return (s[4] - wbar * s[2] + (2 * tau * wbar - ybar) * s[1]
                + (wbar * ybar - tau * wbar * wbar) * s[0] - tau * s[3])

    cl, cr = lsum[0], c - lsum[0]
    if cl < MIN_NODE or cr < MIN_NODE:
        return np.inf
    rl = rho(lsum)
    rr = rho(node) - rl
    return -(rl * rl / cl + rr * rr / cr)


def test_causal_splits_agree_or_tie_and_leaf_stats_stay_f32(jax_interpret):
    x, wt, yt = residuals(5, 300, 5)
    ref, _, mine, key_data = causal_pair(x, wt, yt, n_trees=8, depth=4, n_bins=16,
                                         hist_mode="dense", backend="pallas_bf16",
                                         hist_backend="pallas_bf16")
    assert np.array_equal(mine.in_sample.numpy(), ref["in_sample"])
    _, grow, est = honest_masks(mine, key_data, x.shape[0])
    codes = tf.binarize(torch.as_tensor(x), mine.bin_edges)
    cnp = codes.numpy()
    feat, bins = mine.split_feat.numpy(), mine.split_bin.numpy()
    differs = (feat != ref["split_feat"]) | (bins != ref["split_bin"])
    live = np.zeros_like(differs)
    for lv in range(mine.depth):
        live[:, lv, : 1 << lv] = True
    assert 1.0 - differs[live].mean() >= 0.9
    mom5 = tcf._moments_stack(torch.as_tensor(wt), torch.as_tensor(yt))
    mom = th.round_bf16(mom5).double().numpy()
    for t, lv, m in np.argwhere(differs & live):
        if path_differs(differs, t, lv, m):
            continue
        rows = (route_to_level(codes, mine.split_feat, mine.split_bin, lv)[t] == m) & grow[t]
        s_mine = _causal_bf16_score(mom, rows, cnp[:, feat[t, lv, m]] <= bins[t, lv, m])
        s_ref = _causal_bf16_score(mom, rows, cnp[:, ref["split_feat"][t, lv, m]]
                                   <= ref["split_bin"][t, lv, m])
        assert np.isfinite(s_mine) and np.isfinite(s_ref), (t, lv, m)
        assert abs(s_mine - s_ref) <= 1e-5 * max(abs(s_mine), abs(s_ref)), (t, lv, m)
    # The honest leaf sums: float32 node sums of the unrounded channels.
    leaf = torch.as_tensor(route_to_level(codes, mine.split_feat, mine.split_bin, mine.depth))
    leaf = torch.where(torch.as_tensor(est), leaf, -1)
    want = th.node_sums_plain(leaf, mom5.T.contiguous(), 1 << mine.depth)
    assert torch.equal(mine.leaf_stats, want)
    chan = np.abs(mom5.double().numpy())
    got_np, ref_np = mine.leaf_stats.numpy(), ref["leaf_stats"]
    for t in range(mine.n_trees):
        for j in range(1 << mine.depth):
            if path_differs(differs, t, mine.depth, j):
                continue
            scale = chan[(leaf[t] == j).numpy()].sum(axis=0)
            assert np.all(np.abs(got_np[t, j] - ref_np[t, j]) <= 8 * EPS32 * scale), (t, j)

