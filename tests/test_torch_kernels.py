"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a card.

This file imports no JAX, so it runs on a machine that has none; run it
there without the suite's JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import forest as fo
from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops import tree as tt

N_BINS = 64
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _hist_case(seed, n, p, t, m, dev):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)
    counts = rng.poisson(1.0, size=(t, n)).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = np.stack([counts, counts * y], axis=1)
    return tuple(torch.as_tensor(a, device=dev) for a in (codes, ids, w))


@pytest.mark.parametrize("n,t,m", [(11016, 16, 1), (11016, 16, 128), (100_000, 3, 32), (5, 2, 4)])
def test_hist_kernel_equals_plain(cuda, n, t, m):
    codes, ids, w = _hist_case(n + m, n, 21, t, m, cuda)
    before = th.bin_histogram_batched.launches
    got = th.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS, integer_weights=True)
    torch.cuda.synchronize()
    assert th.bin_histogram_batched.launches == before + 1
    assert torch.equal(got, th.bin_histogram_batched_plain(codes, ids, w, m, N_BINS))
    # Reruns are bitwise equal (fixed-order cross-block pass, integer weights).
    assert torch.equal(got, th.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS,
                                                     integer_weights=True))


def test_node_sums_kernel_equals_plain(cuda):
    _, ids, w = _hist_case(3, 11016, 1, 16, 512, cuda)
    before = th.node_sums.launches
    got = th.node_sums(ids, w, 512, integer_weights=True)
    torch.cuda.synchronize()
    assert th.node_sums.launches == before + 1
    assert torch.equal(got, th.node_sums_plain(ids, w, 512))


def test_kernels_refuse_float_weights_and_count_only_launches(cuda):
    codes, ids, w = _hist_case(4, 1000, 21, 2, 8, cuda)
    with pytest.raises(ValueError, match="integer_weights=True"):
        th.bin_histogram_batched(codes, ids, w * 0.5, max_nodes=8, n_bins=N_BINS)
    with pytest.raises(ValueError, match="continuous target grows on the CPU only"):
        fo.fit_forest_regressor(torch.randn(500, 4, device=cuda), torch.randn(500, device=cuda),
                                rnd.key(1, device=cuda), n_trees=2, depth=2)
    # An empty call launches nothing and counts nothing.
    before = th.bin_histogram_batched.launches
    empty = th.bin_histogram_batched(codes[:0], ids[:, :0], w[:, :, :0], max_nodes=8, n_bins=N_BINS,
                                     integer_weights=True)
    assert th.bin_histogram_batched.launches == before and not bool(empty.any())


@pytest.mark.parametrize("m", [1, 32, 256])
def test_route_kernel_equals_plain(cuda, m):
    rng = np.random.default_rng(m)
    n, p, t = 11016, 21, 16
    codes = torch.as_tensor(rng.integers(0, N_BINS, size=(n, p)).astype(np.int32), device=cuda)
    ids = torch.as_tensor(rng.integers(-1, m + 2, size=(t, n)).astype(np.int32), device=cuda)
    feat = torch.as_tensor(rng.integers(0, p, size=(t, m)).astype(np.int32), device=cuda)
    thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, m)).astype(np.int32), device=cuda)
    before = tt.route_bits.launches
    got = tt.route_bits(codes, ids, feat, thr)
    torch.cuda.synchronize()
    assert tt.route_bits.launches == before + 1
    assert torch.equal(got, tt.route_bits_plain(codes, ids, feat, thr))


def test_lookup_kernel_equals_plain(cuda):
    rng = np.random.default_rng(4)
    table = torch.as_tensor(rng.normal(size=(16, 2, 512)).astype(np.float32), device=cuda)
    ids = torch.as_tensor(rng.integers(-1, 520, size=(16, 11016)).astype(np.int32), device=cuda)
    got = tt.table_lookup(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, tt.table_lookup_plain(table, ids))


def test_forest_on_card_equals_forest_on_cpu(cuda):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 21)).astype(np.float32)
    w = (rng.random(3000) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    kw = dict(n_trees=20, depth=6)
    card = fo.fit_forest_classifier(torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda),
                                    rnd.key(5, device=cuda), **kw)
    host = fo.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w),
                                    rnd.key(5, device="cpu"), **kw)
    for f in ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf", "train_fp"):
        assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f
