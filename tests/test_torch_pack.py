"""ops/pack.py and the packed histogram mode against the JAX package.

* ``pack_codes``, ``unpack_codes`` and ``extract_slot`` equal the JAX
  package's (``array_equal``; the port's words are int32, the JAX
  package's the same integers in float32), with codes 0 and 127 in every
  slot and p = 20, 21 and 22;
* the pack policy (``resolve_predict_pack``, ``resolve_hist_mode_packed``,
  ``mode_for_width`` and the dispatch checks) case by case, as
  ``tests/test_predict_pack.py`` holds the JAX package's;
* the plain "partition+pack" histogram (pack → unpack → plain) against
  the JAX package's Pallas partition kernel with ``pack=True`` in
  interpret mode: integer weights ``array_equal``; float weights within
  8·eps_f32·Σ|w| per (tree, channel) cell (both sum the same f32 products
  in another order; Σ over at most 1,500 rows here);
* ``compute_leaf_index`` and ``predict_cate`` with ``pack=True`` equal
  ``pack=False`` and the JAX package's ``pack=True``;
* the growers under the packed policy grow the unpacked forests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import pack as tp
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.ops import hist_pallas as jh
from ate_replication_causalml_tpu.ops import pack as jp

N_BINS = 64
EPS32 = float(np.finfo(np.float32).eps)


def _boundary_codes(p: int) -> np.ndarray:
    """Every combination of 0 and 127 over three slots, in every word,
    then random codes: (8 + 40, p) int32."""
    combos = np.array([[a, b, c] for a in (0, 127) for b in (0, 127) for c in (0, 127)])
    head = np.tile(combos, (1, -(-p // 3)))[:, :p]
    rng = np.random.default_rng(p)
    return np.concatenate([head, rng.integers(0, 128, size=(40, p))]).astype(np.int32)


@pytest.mark.parametrize("p", [20, 21, 22])
def test_pack_unpack_extract_equal_jax(p):
    codes = _boundary_codes(p)
    with jax.enable_x64(False):
        jw = np.asarray(jp.pack_codes(jnp.asarray(codes)))
        ju = np.asarray(jp.unpack_codes(jnp.asarray(jw), p))
        jslots = [np.asarray(jp.extract_slot(jnp.asarray(jw), jnp.float32(s))) for s in range(3)]
    tw = tp.pack_codes(torch.as_tensor(codes))
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (len(codes), tp.packed_width(p))
    assert np.array_equal(tw.numpy(), jw)
    assert int(tw.max()) <= 127 + 127 * 128 + 127 * 128 * 128
    tu = tp.unpack_codes(tw, p)
    assert tu.dtype == torch.int32
    assert np.array_equal(tu.numpy(), ju) and np.array_equal(tu.numpy(), codes)
    for s in range(3):
        assert np.array_equal(tp.extract_slot(tw, s).numpy(), jslots[s])
    # A tensor of slots broadcasts as the JAX package's float slots do.
    slot_t = torch.arange(3, dtype=torch.int32)[None, :]
    assert np.array_equal(tp.extract_slot(tw[:, :1], slot_t).numpy(),
                          np.stack([js[:, 0] for js in jslots], axis=1))
    assert tp.PACK_SLOTS == jp.PACK_SLOTS and tp.PACK_RADIX == jp.PACK_RADIX
    assert tp.ENV_PACK == jp.ENV_PACK and tp.packed_width(p) == jp.packed_width(p)


def test_resolve_predict_pack_equals_jax(monkeypatch):
    monkeypatch.delenv(tp.ENV_PACK, raising=False)
    for arg in (None, True, False, "1", "0", "auto", " AUTO "):
        assert tp.resolve_predict_pack(arg) is jp.resolve_predict_pack(arg), arg
    assert tp.resolve_predict_pack() is False
    monkeypatch.setenv(tp.ENV_PACK, "1")
    assert tp.resolve_predict_pack() is jp.resolve_predict_pack() is True
    monkeypatch.setenv(tp.ENV_PACK, " AUTO ")
    assert tp.resolve_predict_pack() is jp.resolve_predict_pack() is False
    monkeypatch.setenv(tp.ENV_PACK, "bogus")
    for fn in (tp.resolve_predict_pack, jp.resolve_predict_pack):
        with pytest.raises(ValueError, match="ATE_TPU_PREDICT_PACK"):
            fn()
    for n_bins in (16, 64, 128, 129, 256):
        assert tp.packable(n_bins) == jp.packable(n_bins)


def test_mode_suffix_plumbing_equals_jax(monkeypatch):
    """The cases of tests/test_predict_pack.py::test_mode_suffix_plumbing,
    each on both packages."""
    monkeypatch.delenv(tp.ENV_PACK, raising=False)
    monkeypatch.delenv(th.HIST_MODE_ENV, raising=False)
    for mod in (th, jh):
        assert mod.split_pack_mode("partition+pack") == ("partition", True)
        assert mod.split_pack_mode("dense") == ("dense", False)
        assert mod.with_pack_mode("auto", True) == "auto+pack"
        assert mod.with_pack_mode("partition+pack", False) == "partition"
        assert mod.mode_for_width("auto+pack", 64, 2) == "partition+pack"
        assert mod.mode_for_width("auto+pack", 1, 2) == "dense"
        assert mod.mode_for_width("dense+pack", 64, 2) == "dense"
        assert mod.resolve_hist_mode_packed("partition+pack", 64) == "partition+pack"
        assert mod.resolve_hist_mode_packed("partition+pack", 256) == "partition"
        assert mod.resolve_hist_mode_packed(None, 64) == "auto"
    for mode in ("dense", "partition", "auto", "auto+pack", "partition+pack", "dense+pack"):
        for k in (2, 5):
            for width in (1, 2, 4, 8, 16, 32, 64, 128):
                assert th.mode_for_width(mode, width, k) == jh.mode_for_width(mode, width, k)
    monkeypatch.setenv(tp.ENV_PACK, "1")
    for n_bins in (64, 128, 256):
        assert th.resolve_hist_mode_packed(None, n_bins) == jh.resolve_hist_mode_packed(None, n_bins)
    assert th.resolve_hist_mode_packed(None, 64) == "auto+pack"
    assert th.resolve_hist_mode_packed("Dense", 64) == "dense+pack"
    # Dispatch: "+pack" applies to the partition kernel only.
    assert th._check_dispatch_mode("partition+pack") == ("partition", True)
    assert th._check_dispatch_mode("partition") == ("partition", False)
    assert jh._check_mode("partition+pack", "pallas") == (True, True)
    for check in (lambda: th._check_dispatch_mode("dense+pack"),
                  lambda: jh._check_mode("dense+pack", "pallas")):
        with pytest.raises(ValueError, match="partition kernel only"):
            check()


def _case(seed, n, p, t, k, m, integer):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    codes[:3] = [0, N_BINS - 1, 0] * (p // 3) + [0] * (p % 3)  # boundary bins
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)
    if integer:
        w = rng.integers(0, 5, size=(t, k, n)).astype(np.float32)
    else:
        w = rng.normal(size=(t, k, n)).astype(np.float32)
    return codes, ids, w


def _within(got, ref, w):
    scale = np.abs(w).sum(axis=-1)
    scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
    return bool(np.all(np.abs(got - ref) <= 8 * EPS32 * scale))


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("p,t,m", [(21, 3, 16), (20, 2, 32), (22, 1, 4)])
def test_packed_plain_equals_jax_partition_pack(integer, p, t, m):
    codes, ids, w = _case(p * 10 + m, 1500, p, t, 2, m, integer)
    with jax.enable_x64(False):
        ref = np.asarray(jh.bin_histogram_batched(
            jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(w), max_nodes=m, n_bins=N_BINS,
            backend="pallas_interpret", mode="partition+pack"))
    tc, ti, tw = (torch.as_tensor(a) for a in (codes, ids, w))
    got = th.bin_histogram_batched(tc, ti, tw, max_nodes=m, n_bins=N_BINS, mode="partition+pack")
    words = tp.pack_codes(tc)
    again = th.bin_histogram_batched(tc, ti, tw, max_nodes=m, n_bins=N_BINS,
                                     mode="partition+pack", packed=words)
    unpacked = th.bin_histogram_batched(tc, ti, tw, max_nodes=m, n_bins=N_BINS, mode="partition")
    assert torch.equal(got, again) and torch.equal(got, unpacked)
    if integer:
        assert np.array_equal(got.numpy(), ref)
    else:
        assert _within(got.numpy(), ref, w)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_packed_shared_plain_equals_jax(integer):
    """The shared-weights form, one tree (``bin_histogram_shared``) and
    three trees (the batched shared kernel with ``pack=True``)."""
    codes, ids, w = _case(7, 1200, 21, 3, 5, 16, integer)
    ws = np.ascontiguousarray(w[0])
    with jax.enable_x64(False):
        one = np.asarray(jh.bin_histogram_shared(
            jnp.asarray(codes), jnp.asarray(ids[0]), jnp.asarray(ws), max_nodes=16,
            n_bins=N_BINS, backend="pallas_interpret", mode="partition+pack"))
        many = np.asarray(jh.bin_histogram_pallas_batched_shared(
            jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(ws), max_nodes=16, n_bins=N_BINS,
            interpret=True, partition=True, pack=True))
    tc, ti, tw = (torch.as_tensor(a) for a in (codes, ids, ws))
    got = th.bin_histogram_shared(tc, ti, tw, max_nodes=16, n_bins=N_BINS, mode="partition+pack")
    assert torch.equal(got, th.bin_histogram_shared(tc, ti, tw, max_nodes=16, n_bins=N_BINS,
                                                    mode="partition"))
    for g, r in ((got[:1].numpy(), one[None]), (got.numpy(), many)):
        assert np.array_equal(g, r) if integer else _within(g, r, ws)


def test_packed_mode_checks():
    codes, ids, w = (torch.as_tensor(a) for a in _case(1, 100, 7, 1, 2, 2, True))
    with pytest.raises(ValueError, match="partition kernel only"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS, mode="dense+pack")
    with pytest.raises(TypeError, match="packed must be"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS,
                                 mode="partition+pack", packed=codes)
    with pytest.raises(ValueError, match="n_bins <= 128"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=256, mode="partition+pack")
    # Slots per block of the packed pass: node groups keep all three at
    # every width of the paths (K=2 and K=5).
    assert [th.packed_slots(2, m, 64) for m in (32, 64, 128)] == [3, 3, 3]
    assert [th.packed_slots(5, m, 64) for m in (16, 32, 64, 128)] == [3, 3, 3, 3]


def test_packed_mode_launches_or_raises_off_the_cpu():
    """Off the CPU the packed mode and pack_codes go to their kernels and
    never to the plain version: a device without a kernel raises (meta
    tensors reach that point without a card)."""
    codes, ids, w = (torch.as_tensor(a).to("meta") for a in _case(2, 100, 7, 1, 2, 4, False))
    with pytest.raises(ValueError, match="no pack kernel for device meta"):
        tp.pack_codes(codes)
    with pytest.raises(ValueError, match="no histogram kernel for device meta"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=4, n_bins=N_BINS,
                                 mode="partition+pack")
    with pytest.raises(ValueError, match="no histogram kernel for device meta"):
        th.bin_histogram_shared(codes, ids, w[0], max_nodes=4, n_bins=N_BINS,
                                mode="partition+pack", packed=torch.empty((100, 3), dtype=torch.int32,
                                                                          device="meta"))


def _leaf_moments(rng, n_trees, n_leaves):
    """Honest leaf statistics [count, Σw̃, Σỹ, Σw̃², Σw̃ỹ] of 2–20 random
    residual rows per leaf (consistent moments, as a grown forest has)."""
    out = np.zeros((n_trees, n_leaves, 5), np.float32)
    for t in range(n_trees):
        for j in range(n_leaves):
            wt = rng.random(rng.integers(2, 21)) - 0.5
            yt = (1.0 + rng.normal()) * wt + 0.3 * rng.normal(size=wt.size)
            out[t, j] = [wt.size, wt.sum(), yt.sum(), (wt * wt).sum(), (wt * yt).sum()]
    return out


def _synthetic_forests(seed=5, T=8, D=4, n=60, p=7, nb=16):
    """One random causal forest in both packages' containers."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        split_feat=rng.integers(0, p, size=(T, D, 1 << (D - 1))).astype(np.int32),
        split_bin=rng.integers(0, nb - 1, size=(T, D, 1 << (D - 1))).astype(np.int32),
        leaf_stats=_leaf_moments(rng, T, 1 << D),
        in_sample=rng.uniform(size=(T, n)) < 0.5,
        bin_edges=np.sort(rng.normal(size=(p, nb - 1)), axis=1).astype(np.float32),
    )
    jfo = jcf.CausalForest(**{k: jnp.asarray(v) for k, v in arrays.items()}, ci_group_size=2)
    return jfo, tcf.causal_forest_from_jax(arrays, device="cpu"), rng.normal(size=(53, p)).astype(np.float32)


def test_leaf_index_and_predict_cate_pack_equal(monkeypatch):
    monkeypatch.delenv(tp.ENV_PACK, raising=False)
    jfo, tfo, x = _synthetic_forests()
    with jax.enable_x64(False):
        jli = np.asarray(jcf.compute_leaf_index(jfo, jnp.asarray(x), pack=True))
        jpc = jcf.predict_cate(jfo, jnp.asarray(x), oob=False, row_backend="matmul", pack=True)
        jtau, jvar = np.asarray(jpc.cate), np.asarray(jpc.variance)
    tx = torch.as_tensor(x)
    li = {pk: tcf.compute_leaf_index(tfo, tx, pack=pk) for pk in (False, True, "1")}
    for v in li.values():
        assert v.dtype == li[False].dtype and np.array_equal(v.numpy(), jli)
    pc = {pk: tcf.predict_cate(tfo, tx, oob=False, pack=pk) for pk in (False, True)}
    assert torch.equal(pc[True].cate, pc[False].cate)
    assert torch.equal(pc[True].variance, pc[False].variance)
    assert np.all(np.abs(pc[True].cate.numpy() - jtau) <= 1e-6 * (1 + np.abs(jtau)))
    assert np.all(np.abs(pc[True].variance.numpy() - jvar) <= 1e-6 * (1 + np.abs(jvar)))
    monkeypatch.setenv(tp.ENV_PACK, "bogus")  # resolved (and refused) as in the JAX package
    with pytest.raises(ValueError, match="ATE_TPU_PREDICT_PACK"):
        tcf.compute_leaf_index(tfo, tx)
    with pytest.raises(ValueError, match="ATE_TPU_PREDICT_PACK"):
        tcf.predict_cate(tfo, tx, oob=False)


def test_growers_under_the_packed_policy(monkeypatch):
    """ATE_TPU_PREDICT_PACK=1 sends the partition widths to the packed
    pass (words packed once per fit): the classifier and the causal
    forest equal their unpacked selves field for field."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(900, 21)).astype(np.float32)
    w = (rng.random(900) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    wt = (rng.random(900) - 0.5).astype(np.float32)
    yt = ((1 + x[:, 1]) * wt + 0.3 * rng.normal(size=900)).astype(np.float32)
    tx, tw, twt, tyt = (torch.as_tensor(a) for a in (x, w, wt, yt))
    fit = lambda **kw: tf.fit_forest_classifier(tx, tw, rnd.key(4, device="cpu"), n_trees=4,
                                                depth=8, **kw)
    grow = lambda **kw: tcf.grow_causal_forest(tx, twt, tyt, rnd.key(4, device="cpu"), n_trees=4,
                                               depth=7, **kw)
    monkeypatch.delenv(tp.ENV_PACK, raising=False)
    base_f, base_c = fit(hist_mode="dense"), grow(hist_mode="dense")
    calls = []
    real = th.bin_histogram_packed_plain
    monkeypatch.setattr(th, "bin_histogram_packed_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv(tp.ENV_PACK, "1")
    for got, base, fields in ((fit(), base_f, ("split_feat", "split_bin", "leaf_value", "train_leaf")),
                              (grow(), base_c, ("split_feat", "split_bin", "leaf_stats", "in_sample"))):
        for f in fields:
            assert torch.equal(getattr(got, f), getattr(base, f)), f
    # Classifier: widths 32 and 64 of depth 8; causal: widths 16 and 32 of depth 7.
    assert len(calls) == 4
