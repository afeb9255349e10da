"""ops/tree.py: the plain route bits and leaf lookup equal the JAX
package's Pallas kernels (interpret mode); the fused passes' plain
versions equal the sequences they replace: ``route_advance`` the grower's
route and id updates, ``traverse`` the JAX package's per-level routing
(``_tree_route_stream``) and leaf lookup, ``leaf_record`` the grower's
leaf values and training-row lookup, all exact. The CUDA kernels are held
against the plain versions in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import tree as tt
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.ops import tree_pallas as jt

N_BINS = 64


def _route_case(seed, n, p, t, m):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)  # −1 and ≥ M give 0
    feat = rng.integers(0, p, size=(t, m)).astype(np.int32)
    thr = rng.integers(0, N_BINS, size=(t, m)).astype(np.int32)
    return codes, ids, feat, thr


@pytest.mark.parametrize("t,m", [(1, 1), (3, 8), (2, 256)])
def test_route_plain_equals_pallas_interpret(t, m):
    codes, ids, feat, thr = _route_case(t * 7 + m, 2500, 21, t, m)
    got = tt.route_bits(*(torch.as_tensor(a) for a in (codes, ids, feat, thr))).numpy()
    codes_t = jt.codes_transposed(jnp.asarray(codes))
    for i in range(t):
        ref = np.asarray(jt.route_bits(codes_t, jnp.asarray(ids[i]), jnp.asarray(feat[i]),
                                       jnp.asarray(thr[i]), backend="pallas_interpret"))
        assert np.array_equal(got[i], ref)
    assert np.all(got[ids < 0] == 0) and np.all(got[ids >= m] == 0)


@pytest.mark.parametrize("k,slots", [(1, 512), (3, 16)])
def test_lookup_plain_equals_pallas_interpret(k, slots):
    rng = np.random.default_rng(k * slots)
    t, n = 3, 2100
    table = rng.normal(size=(t, k, slots)).astype(np.float32)
    ids = rng.integers(-2, slots + 3, size=(t, n)).astype(np.int32)
    got = tt.table_lookup(torch.as_tensor(table), torch.as_tensor(ids)).numpy()
    assert got.shape == (t, k, n)
    for i in range(t):
        ref = np.asarray(jt.table_lookup(jnp.asarray(table[i]), jnp.asarray(ids[i]),
                                         backend="pallas_interpret"))
        assert np.array_equal(got[i], ref)


def test_wrappers_reject_wrong_dtypes():
    codes, ids, feat, thr = (torch.as_tensor(a) for a in _route_case(0, 50, 3, 1, 2))
    with pytest.raises(TypeError):
        tt.route_bits(codes, ids.long(), feat, thr)
    with pytest.raises(TypeError):
        tt.table_lookup(torch.zeros(1, 1, 4, dtype=torch.float64), ids)



def _advance_case(seed, n, p, t, m, masked):
    """A level of width m: ids in [-1, m + 2) (−1 and ≥ M route left),
    node_int below 2^20, features in [-1, p + 1) (outside [0, p) reads a
    code of 0), and an optional mask."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    node_int = rng.integers(0, 1 << 20, size=(t, n)).astype(np.int32)
    node_rev = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)
    feat = rng.integers(-1, p + 1, size=(t, m)).astype(np.int32)
    thr = rng.integers(0, N_BINS, size=(t, m)).astype(np.int32)
    mask = rng.random((t, n)) < 0.6 if masked else None
    return codes, node_int, node_rev, feat, thr, mask


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [1, 2, 8, 32, 128, 256])
def test_route_advance_plain_equals_the_grower_sequence(m, masked, last):
    """The grower's level step as models/forest.py and
    models/causal_forest.py wrote it before the fused kernel: route,
    ``node_int * 2 + bit``, ``node_rev + bit * m``, the next level's
    ``where(node_int % 2 == 0, node_rev, -1)`` (or the leaf ids), the
    grow/estimate mask's ``where``."""
    codes, node_int, node_rev, feat, thr, mask = (
        None if a is None else torch.as_tensor(a)
        for a in _advance_case(m * 4 + masked * 2 + last, 1003, 21, 3, m, masked))
    bit = tt.route_bits(codes, node_rev, feat, thr)
    want_int = node_int * 2 + bit
    want_rev = node_rev + bit * m
    want = want_int if last else torch.where(want_int % 2 == 0, want_rev, -1)
    if mask is not None:
        want = torch.where(mask, want, -1)
    got_int, got_rev = node_int.clone(), node_rev.clone()
    got = tt.route_advance(codes, got_int, got_rev, feat, thr, mask=mask, last=last)
    assert got.dtype == torch.int32
    assert torch.equal(got, want) and torch.equal(got_int, want_int) and torch.equal(got_rev, want_rev)


def _forest_tables(seed, t, depth, p):
    """Split tables (T, D, 2^(D-1)) with features in [-1, p + 1) and the
    frozen nodes' (0, 63) among them."""
    rng = np.random.default_rng(seed)
    width = 1 << (depth - 1)
    feat = rng.integers(-1, p + 1, size=(t, depth, width)).astype(np.int32)
    thr = rng.integers(0, N_BINS, size=(t, depth, width)).astype(np.int32)
    frozen = rng.random((t, depth, width)) < 0.1
    feat[frozen], thr[frozen] = 0, N_BINS - 1
    return feat, thr


@pytest.mark.parametrize("depth,k", [(8, None), (8, 5), (9, None), (9, 1)])
def test_traverse_plain_equals_jax_route_stream_and_lookup(depth, k):
    """Leaf ids: the JAX package's ``_tree_route_stream`` (one interpret-
    mode route kernel per level); payload: its ``table_lookup`` of the
    (K, L) payload at those leaves. Exact."""
    t, n, p = 2, 1500, 21
    rng = np.random.default_rng(depth * 10 + (k or 0))
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    feat, thr = _forest_tables(depth + 100, t, depth, p)
    table = None if k is None else rng.normal(size=(t, 1 << depth, k)).astype(np.float32)
    got = tt.traverse(torch.as_tensor(codes), torch.as_tensor(feat), torch.as_tensor(thr),
                      None if table is None else torch.as_tensor(table)).numpy()
    assert got.shape == ((t, n) if k is None else (t, k, n))
    codes_t = jt.codes_transposed(jnp.asarray(codes))
    for i in range(t):
        leaf = jcf._tree_route_stream(jnp.asarray(feat[i]), jnp.asarray(thr[i]), codes_t, depth,
                                      backend="pallas_interpret")
        if k is None:
            assert np.array_equal(got[i], np.asarray(leaf))
        else:
            ref = jt.table_lookup(jnp.asarray(table[i].T), leaf, backend="pallas_interpret")
            assert np.array_equal(got[i], np.asarray(ref))


@pytest.mark.parametrize("center", [0.0, 1.0])
def test_leaf_record_plain_equals_the_grower_sequence(center):
    """models/forest.py's chunk end as written before the fused kernel:
    the leaf values (empty leaves take the tree's mean) and
    ``table_lookup`` of every training row's leaf, on leaf sums in the
    card's (T, K, L)-transposed layout. Bitwise."""
    rng = np.random.default_rng(int(center))
    t, leaves, n = 4, 512, 2000
    counts = rng.poisson(1.0, size=(t, leaves)).astype(np.float32)  # about a third empty
    sums = (counts * rng.normal(size=(t, leaves))).astype(np.float32)
    ls = torch.as_tensor(np.stack([counts, sums], axis=1)).transpose(1, 2)  # (T, L, 2) view
    mu = torch.as_tensor(rng.random(t).astype(np.float32))
    base = center * mu
    node = torch.as_tensor(rng.integers(-1, leaves + 2, size=(t, n)).astype(np.int32))
    leaf_c, leaf_y = ls[..., 0], ls[..., 1]
    want_value = torch.where(
        leaf_c > 0, base[:, None] + leaf_y / torch.clamp(leaf_c, min=1e-12), mu[:, None])
    want_train = tt.table_lookup(want_value[:, None, :].contiguous(), node)[:, 0]
    value, train = tt.leaf_record(ls, base, mu, node)
    assert torch.equal(value, want_value) and torch.equal(train, want_train)
    assert bool((counts == 0).any()) and torch.equal(value[torch.as_tensor(counts == 0)],
                                                     mu[:, None].expand(t, leaves)[torch.as_tensor(counts == 0)])


def test_fused_wrappers_reject_wrong_inputs():
    codes, node_int, node_rev, feat, thr, _ = (torch.as_tensor(a) if a is not None else None
                                               for a in _advance_case(0, 50, 3, 2, 4, False))
    with pytest.raises(TypeError):
        tt.route_advance(codes, node_int.long(), node_rev, feat, thr)
    with pytest.raises(TypeError):
        tt.route_advance(codes, node_int, node_rev, feat, thr, mask=torch.ones(2, 50))
    f3, b3 = (torch.as_tensor(a) for a in _forest_tables(0, 2, 3, 3))
    with pytest.raises(TypeError):
        tt.traverse(codes, f3[:, :, :2], b3[:, :, :2])  # W < 2^(D-1)
    with pytest.raises(TypeError):
        tt.traverse(codes, f3, b3, torch.zeros(2, 8, 1, dtype=torch.float64))
    with pytest.raises(TypeError):
        tt.leaf_record(torch.zeros(2, 8, 3), torch.zeros(2), torch.zeros(2), node_int)
