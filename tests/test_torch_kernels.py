"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a card.

This file imports no JAX, so it runs on a machine that has none; run it
there without the suite's JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.estimators import dml
from ate_replication_causalml_torch.models import causal_forest as cf
from ate_replication_causalml_torch.models import forest as fo
from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import lasso as tl
from ate_replication_causalml_torch.ops import pack as tp
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops import tree as tt

N_BINS = 64
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


EPS32 = float(np.finfo(np.float32).eps)


def _hist_case(seed, n, p, t, m, dev, k=2):
    """Codes in [0, n_bins + 3) (the top three add nothing), ids in
    [-1, m + 2) (−1 and ≥ m add nothing), K integer weight channels:
    counts, counts·y, then counts·(c mod 3) for further channels."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS + 3, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)
    counts = rng.poisson(1.0, size=(t, n)).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    extra = [counts * (rng.integers(0, 3, size=n).astype(np.float32)) for _ in range(k - 2)]
    w = np.stack([counts, counts * y] + extra, axis=1)[:, :k]
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (codes, ids, w))


def _moments(seed, n, dev):
    """The causal grower's five float channels [1, w̃, ỹ, w̃², w̃ỹ], (5, n)."""
    rng = np.random.default_rng(seed)
    wt = (rng.random(n) - 0.4).astype(np.float32)
    yt = rng.normal(size=n).astype(np.float32)
    return torch.as_tensor(np.stack([np.ones(n, np.float32), wt, yt, wt * wt, wt * yt]), device=dev)


def _float_bound(got, want, w):
    """|Δ| ≤ 16·eps_f32·Σ|w| per channel: two f32 sums of the same terms
    in other orders (the kernel's ascending rows per range, the plain
    version's index_add_), each within n·eps·Σ|w| of the exact sum in
    the worst case and ~√n·eps·Σ|w| in practice."""
    scale = w.abs().sum(dim=-1)
    scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
    return bool(torch.all((got - want).abs() <= 16 * EPS32 * scale))


COUNTERS = {"dense": "launches", "partition": "partition_launches",
            "partition+pack": "packed_launches"}
# (n, T, M, K, p): the paths' shapes, unaligned row counts with one row
# range (n = 5, 1,000) and several (11,016, 100,003), every K the kernels
# instantiate that the tests reach (1, 2, 3, 5, 8), M not a power of two
# (nor a multiple of the node groups), p not a multiple of a block's
# features or of a packed word's three slots.
HIST_CASES = [(11016, 16, 1, 2, 21), (11016, 16, 128, 2, 21), (100_003, 3, 32, 2, 21),
              (5, 2, 4, 2, 21), (1000, 4, 100, 1, 20), (1000, 2, 8, 3, 22),
              (5508, 16, 64, 5, 21), (3001, 3, 100, 8, 21)]


@pytest.mark.parametrize("mode", ["dense", "partition", "partition+pack"])
@pytest.mark.parametrize("n,t,m,k,p", HIST_CASES)
def test_hist_kernel_equals_plain(cuda, mode, n, t, m, k, p):
    """Integer weights: every formulation exact, reruns bitwise equal,
    one launch counted per call."""
    codes, ids, w = _hist_case(n + m + k, n, p, t, m, cuda, k)
    counter = COUNTERS[mode]
    before = getattr(th.bin_histogram_batched, counter)
    got = th.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode=mode)
    torch.cuda.synchronize()
    assert getattr(th.bin_histogram_batched, counter) == before + 1
    assert torch.equal(got, th.bin_histogram_batched_plain(codes, ids, w, m, N_BINS))
    assert torch.equal(got, th.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS,
                                                     mode=mode))


def test_hist_kernel_equals_plain_at_a_million_rows(cuda):
    """bench.py's forest size: 1,000,000 rows, 16 trees, K=2, M=128, three
    row ranges of 333,334 rows; dense and partition exact."""
    codes, ids, w = _hist_case(1, 1_000_000, 21, 16, 128, cuda)
    want = th.bin_histogram_batched_plain(codes, ids, w, 128, N_BINS)
    for mode in ("dense", "partition"):
        got = th.bin_histogram_batched(codes, ids, w, max_nodes=128, n_bins=N_BINS, mode=mode)
        assert torch.equal(got, want), mode


def _entry_call(mode, m, dev):
    """One histogram entry point's C call at (n=2,048, T=4, M=m, K=2,
    p=21), its arguments fixed on the current stream: a function that
    launches it once and returns the C code, the output it writes, and
    its dynamic shared-memory bytes."""
    from ate_replication_causalml_torch.kernels import build

    n, t, k_w, p = 2048, 4, 2, 21
    codes, ids, w = _hist_case(m, n, p, t, m, dev)
    n_parts = th._n_parts(n, t, p)
    out = torch.zeros((t, k_w, m, p, N_BINS), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tail = (ids.data_ptr(), w.data_ptr(), k_w * n, t, k_w, m, N_BINS, n_parts)
    if mode == "dense":
        shape = (k_w, m, p, N_BINS, t, n_parts)
        partial = (torch.empty((n_parts,) + tuple(out.shape), dtype=torch.float32, device=dev)
                   if n_parts > 1 else out)
        args = (codes.data_ptr(), n, p, *tail, th.dense_features_per_block(*shape),
                th.dense_node_groups(k_w, m, N_BINS), th.dense_warps_per_feature(*shape),
                partial.data_ptr(), out.data_ptr(), stream)
        keep = (codes, ids, w, partial)
        k, smem = build.kernel("hist"), th.dense_block_bytes(*shape)
    else:
        words = tp.pack_codes(codes)
        perm, seg, _, _ = th.partition_sort(ids, m, n_parts)
        args = (words.data_ptr(), n, p, *tail, th.packed_slots(k_w, m, N_BINS),
                th.packed_node_groups(k_w, m, N_BINS), perm.data_ptr(), seg.data_ptr(),
                out.data_ptr(), stream)
        keep = (codes, ids, w, words, perm, seg)
        k, smem = build.kernel("hist_partition_packed"), th.packed_block_bytes(k_w, m, N_BINS)

    def launch(_keep=keep):
        return k.fn(*args)

    want = th.bin_histogram_batched_plain(codes, ids, w, m, N_BINS)
    return launch, out, want, smem


def test_hist_entries_launch_from_threads_at_other_sizes(cuda):
    """The concurrent sweep's workers launch one kernel at other shared-
    memory sizes from several threads, each on its own stream. A kernel's
    shared-memory cap is the function's, so a thread that lowered it
    between another's set and launch failed that launch ``invalid
    argument`` (``csrc/smem_cap.cuh`` only ever raises it). Two threads a
    size, each calling its C entry point 5,000 times with the GIL
    released: every call returns 0, and each output equals the plain
    version."""
    import threading

    cases = [("dense", 1), ("dense", 64), ("partition+pack", 8), ("partition+pack", 128)] * 2
    errors, results = [], {}
    start = threading.Barrier(len(cases))

    def run(i):
        mode, m = cases[i]
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                launch, out, want, smem = _entry_call(mode, m, cuda)
                torch.cuda.current_stream().synchronize()
                start.wait()
                codes = [launch() for _ in range(5000)]
                torch.cuda.current_stream().synchronize()
            results[i] = (smem, [c for c in codes if c != 0], torch.equal(out, want))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{mode} M={m}: {type(e).__name__}: {e}")
            start.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    sizes = {cases[i]: r[0] for i, r in results.items()}
    assert sizes[("dense", 1)] < sizes[("dense", 64)] and \
        sizes[("partition+pack", 8)] < sizes[("partition+pack", 128)], sizes
    failed = {cases[i]: sorted(set(r[1])) for i, r in results.items() if r[1]}
    assert not failed, f"nonzero codes from the C entry points: {failed}"
    assert all(r[2] for r in results.values())


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128])
def test_shared_float_kernel_within_bound_and_stable(cuda, m):
    """K=5 float channels shared by 16 trees at the causal path's shape:
    within the bound of the plain version, two launches bitwise equal,
    and dense, partition and the packed pass give the same bits (each
    cell sums its rows in ascending order within each row range in all
    three)."""
    codes, ids, _ = _hist_case(m, 11016, 21, 16, m, cuda)
    w = _moments(m, 11016, cuda)
    dense = th.bin_histogram_shared(codes, ids, w, max_nodes=m, n_bins=N_BINS)
    part = th.bin_histogram_shared(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition")
    packed = th.bin_histogram_shared(codes, ids, w, max_nodes=m, n_bins=N_BINS,
                                     mode="partition+pack")
    again = th.bin_histogram_shared(codes, ids, w, max_nodes=m, n_bins=N_BINS)
    torch.cuda.synchronize()
    assert torch.equal(dense, again) and torch.equal(dense, part) and torch.equal(dense, packed)
    assert _float_bound(dense, th.bin_histogram_batched_plain(codes, ids, w, m, N_BINS), w)
    # Per-tree float weights take the same path with a tree stride.
    wt = w[None].repeat(16, 1, 1)
    assert torch.equal(th.bin_histogram_batched(codes, ids, wt, max_nodes=m, n_bins=N_BINS), dense)


# (n, T, p) → the row ranges of the unpacked partition pass: 1 (no
# cluster), 2, 3 (the paths') and 8 (one cluster each), 16 (one slab per
# range and the second pass); n, p ragged.
RANGE_CASES = {1: (1000, 3, 21), 2: (3001, 3, 22), 3: (5000, 3, 20), 8: (15001, 3, 21),
               16: (100_003, 3, 21)}


@pytest.mark.parametrize("n_parts", sorted(RANGE_CASES))
@pytest.mark.parametrize("k", range(1, 9))
def test_partition_equals_dense_at_every_range_count(cuda, k, n_parts):
    """The unpacked partition pass, clustered (2–8 ranges) or not (1 range;
    16 ranges take the slabs): bitwise equal to dense, to the packed pass
    and, for integer weights, to the plain version, for K = 1–8 at a
    ragged M; float weights bitwise equal to dense and within the bound of
    the plain version."""
    n, t, p = RANGE_CASES[n_parts]
    m = 100 if k % 2 == 0 else 77
    assert th._n_parts(n, t, p) == n_parts
    assert th.partition_cluster_ranges(n_parts) == (n_parts if 2 <= n_parts <= 8 else 1)
    codes, ids, wi = _hist_case(k * 100 + n_parts, n, p, t, m, cuda, k)
    wf = (wi * 0.37 + torch.rand(wi.shape, generator=torch.Generator().manual_seed(k)).to(cuda)).contiguous()
    for w in (wi, wf):
        run = lambda mode: th.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS,
                                                    mode=mode)
        before = th.bin_histogram_batched.partition_launches
        part = run("partition")
        torch.cuda.synchronize()
        assert th.bin_histogram_batched.partition_launches == before + 1
        assert torch.equal(part, run("dense")) and torch.equal(part, run("partition"))
        assert torch.equal(part, run("partition+pack"))
        want = th.bin_histogram_batched_plain(codes, ids, w, m, N_BINS)
        assert torch.equal(part, want) if w is wi else _float_bound(part, want, w)


@pytest.mark.parametrize("n_parts", sorted(RANGE_CASES))
def test_partition_sort_equals_plain(cuda, n_parts):
    """The shared first step equals its plain version: perm and seg (which
    both accumulate passes read) on every written position, and with
    weights (per-tree and shared) the same perm and seg and each
    position's node and weights in perm order."""
    n, t, p = RANGE_CASES[n_parts]
    for m in (1, 77, 128):
        _, ids, w = _hist_case(m + n_parts, n, p, t, m, cuda, 3)
        perm, seg, _, _ = th.partition_sort(ids, m, n_parts)
        want = th.partition_sort_plain(ids.cpu(), m, n_parts, w.cpu())
        written = want[0] >= 0
        assert torch.equal(seg.cpu(), want[1])
        assert torch.equal(perm.cpu()[written], want[0][written])
        for weights, plain in ((w, want), (w[0].contiguous(),
                                           th.partition_sort_plain(ids.cpu(), m, n_parts,
                                                                   w[0].cpu()))):
            got = th.partition_sort(ids, m, n_parts, weights)
            assert torch.equal(got[0].cpu()[written], want[0][written])
            assert torch.equal(got[1], seg)
            assert torch.equal(got[2].cpu()[written], plain[2][written])
            assert torch.equal(got[3].cpu().transpose(1, 2)[written],
                               plain[3].transpose(1, 2)[written])


@pytest.mark.parametrize("p", [20, 21, 22])
def test_pack_kernel_equals_plain(cuda, p):
    rng = np.random.default_rng(p)
    codes = torch.as_tensor(rng.integers(0, 128, size=(11016, p)).astype(np.int32), device=cuda)
    codes[:8, :3] = torch.as_tensor([[a, b, c] for a in (0, 127) for b in (0, 127)
                                     for c in (0, 127)], dtype=torch.int32, device=cuda)
    before = tp.pack_codes.launches
    words = tp.pack_codes(codes)
    torch.cuda.synchronize()
    assert tp.pack_codes.launches == before + 1
    assert torch.equal(words, tp.pack_codes_plain(codes))
    assert torch.equal(tp.unpack_codes(words, p), codes)


# (K, M, p): the paths' packed widths (K=2: 32–128, K=5: 16–128, one to
# ten node groups), ragged feature counts (a last word with one or two
# slots), M not a multiple of the node groups, and K = 1, 3, 8.
PACKED_CASES = [(2, 32, 21), (2, 128, 21), (2, 64, 20), (5, 16, 21), (5, 32, 21), (5, 64, 21),
                (5, 128, 21), (5, 64, 22), (5, 128, 20), (2, 100, 21), (1, 64, 22),
                (3, 128, 20), (8, 64, 21)]


@pytest.mark.parametrize("k,m,p", PACKED_CASES)
def test_packed_kernel_equals_unpacked_and_plain(cuda, k, m, p):
    """The packed pass against the unpacked partition kernel (bit for bit,
    integer and float weights) and the plain version (exact for integer
    weights, within the float bound otherwise); two launches equal."""
    codes, ids, wi = _hist_case(k * 1000 + m + p, 11016 if k == 5 else 5508, p, 16, m, cuda, k)
    if k != 5:
        w, shared, fn = wi, False, th.bin_histogram_batched
    else:
        w, shared, fn = _moments(m, codes.shape[0], cuda), True, th.bin_histogram_shared
    words = tp.pack_codes(codes)
    before = fn.packed_launches
    got = fn(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition+pack", packed=words)
    torch.cuda.synchronize()
    assert fn.packed_launches == before + 1
    again = fn(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition+pack", packed=words)
    unpacked = fn(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition")
    assert torch.equal(got, again) and torch.equal(got, unpacked)
    want = th.bin_histogram_batched_plain(codes, ids, w, m, N_BINS)
    if shared:
        assert _float_bound(got, want, w)
    else:
        assert torch.equal(got, want)
    # Without words the wrapper packs them itself (one pack launch).
    before = tp.pack_codes.launches
    assert torch.equal(fn(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition+pack"), got)
    assert tp.pack_codes.launches == before + 1


def test_packed_dml_forest_on_card_vs_cpu(cuda, monkeypatch):
    """A DML nuisance forest under ATE_TPU_PREDICT_PACK=1 (depth 9: widths
    32–128 take the packed pass) on the card equals the CPU port's, and the
    DML row's τ and SE on the card are within 1e-6 of the CPU port's."""
    monkeypatch.setenv(tp.ENV_PACK, "1")
    monkeypatch.delenv(th.HIST_MODE_ENV, raising=False)
    rng = np.random.default_rng(7)
    n = 6000
    x = rng.normal(size=(n, 21)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x[:, 1] + 0.4 * w)))).astype(np.float32)
    before = th.bin_histogram_batched.packed_launches
    card = fo.fit_forest_classifier(torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda),
                                    rnd.key(5, device=cuda), n_trees=16, depth=9)
    assert th.bin_histogram_batched.packed_launches == before + 3
    host = fo.fit_forest_classifier(torch.as_tensor(x), torch.as_tensor(w), rnd.key(5, device="cpu"),
                                    n_trees=16, depth=9)
    for f in ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf", "train_fp"):
        assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f
    frame = CausalFrame(*(torch.as_tensor(a) for a in (x, w, y)))
    on_card = dml.double_ml(frame, n_trees=16, depth=9, key=rnd.key(3, device="cpu"))
    on_cpu = dml.double_ml(frame, n_trees=16, depth=9, key=rnd.key(3, device="cpu"), device="cpu")
    assert abs(on_card.ate - on_cpu.ate) <= 1e-6 and abs(on_card.se - on_cpu.se) <= 1e-6


def test_node_sums_kernel_equals_plain(cuda):
    _, ids, w = _hist_case(3, 11016, 1, 16, 512, cuda)
    before = th.node_sums.launches
    got = th.node_sums(ids, w, 512)
    torch.cuda.synchronize()
    assert th.node_sums.launches == before + 1
    assert torch.equal(got, th.node_sums_plain(ids, w, 512))
    # The causal leaf payload: K=5 shared float channels at M=256.
    _, lid, _ = _hist_case(4, 11016, 1, 16, 256, cuda)
    ws = _moments(4, 11016, cuda)
    before = th.node_sums_shared.launches
    got = th.node_sums_shared(lid, ws, 256)
    assert th.node_sums_shared.launches == before + 1
    assert torch.equal(got, th.node_sums_shared(lid, ws, 256))
    want = th.node_sums_plain(lid, ws, 256)
    assert torch.all((got - want).abs() <= 16 * EPS32 * ws.abs().sum(dim=1)[None, None, :])


def test_kernels_take_float_weights_and_count_only_launches(cuda):
    """Float weights now launch the kernel (counted once per launch); an
    empty call launches nothing and counts nothing."""
    codes, ids, w = _hist_case(4, 1000, 21, 2, 8, cuda)
    before = th.bin_histogram_batched.launches
    got = th.bin_histogram_batched(codes, ids, w * 0.5 + 0.1, max_nodes=8, n_bins=N_BINS)
    assert th.bin_histogram_batched.launches == before + 1
    assert _float_bound(got, th.bin_histogram_batched_plain(codes, ids, w * 0.5 + 0.1, 8, N_BINS),
                        w * 0.5 + 0.1)
    before = th.bin_histogram_batched.launches
    empty = th.bin_histogram_batched(codes[:0], ids[:, :0], w[:, :, :0], max_nodes=8, n_bins=N_BINS)
    assert th.bin_histogram_batched.launches == before and not bool(empty.any())


def _path_agrees(f1, b1, f2, b2):
    """(T, 2^D) mask: leaves whose every split on the path agrees."""
    n_trees, depth, _ = f1.shape
    differs = (f1 != f2) | (b1 != b2)
    leaf = np.arange(1 << depth)
    ok = np.ones((n_trees, 1 << depth), bool)
    for a in range(depth):
        ok &= ~differs[:, a, leaf >> (depth - a)]
    return ok


def test_continuous_regressor_on_card_vs_cpu(cuda):
    """A continuous target now grows on the card (float weights, ordered
    sums). Against the CPU port: counts and edges exact, at least 90% of
    the split table equal (a float tie may flip), and every leaf whose
    path agrees within 8·eps·(|tree mean| + 4) of the CPU's (|y| < 4)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 21)).astype(np.float32)
    y = (3.0 + x[:, 0] + 0.2 * rng.normal(size=3000)).astype(np.float32)
    kw = dict(n_trees=16, depth=6)
    card = fo.fit_forest_regressor(torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda),
                                   rnd.key(5, device=cuda), **kw)
    host = fo.fit_forest_regressor(torch.as_tensor(x), torch.as_tensor(y), rnd.key(5, device="cpu"),
                                   **kw)
    for f in ("counts", "bin_edges", "train_fp"):
        assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f
    f1, b1 = card.split_feat.cpu().numpy(), card.split_bin.cpu().numpy()
    f2, b2 = host.split_feat.numpy(), host.split_bin.numpy()
    assert np.mean((f1 == f2) & (b1 == b2)) >= 0.9
    ok = _path_agrees(f1, b1, f2, b2)
    v1, v2 = card.leaf_value.cpu().numpy(), host.leaf_value.numpy()
    assert np.all(np.abs(v1 - v2)[ok] <= 8 * EPS32 * (np.abs(v2) + 4.0)[ok])


def test_causal_forest_on_card_vs_cpu(cuda):
    """The causal grow at a few trees on the card against the CPU port:
    half-samples exact, at least 90% of the split table equal, leaf
    statistics on agreeing paths within 16·eps·Σ|channel| (counts exact),
    and predict_cate of one forest within 1e-6·(1 + |τ̂|) on both."""
    rng = np.random.default_rng(1)
    n, p = 11016, 21
    x = rng.normal(size=(n, p)).astype(np.float32)
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = ((1.0 + x[:, 0]) * wt + 0.3 * rng.normal(size=n)).astype(np.float32)
    kw = dict(n_trees=16, depth=8)
    card = cf.grow_causal_forest(*(torch.as_tensor(a, device=cuda) for a in (x, wt, yt)),
                                 rnd.key(3, device=cuda), **kw)
    host = cf.grow_causal_forest(*(torch.as_tensor(a) for a in (x, wt, yt)),
                                 rnd.key(3, device="cpu"), **kw)
    assert torch.equal(card.in_sample.cpu(), host.in_sample)
    f1, b1 = card.split_feat.cpu().numpy(), card.split_bin.cpu().numpy()
    f2, b2 = host.split_feat.numpy(), host.split_bin.numpy()
    assert np.mean((f1 == f2) & (b1 == b2)) >= 0.9
    ok = _path_agrees(f1, b1, f2, b2)
    s1, s2 = card.leaf_stats.cpu().numpy(), host.leaf_stats.numpy()
    # Per-leaf scale Σ|channel| over the leaf's estimate rows (CPU forest).
    gkeys = rnd.split(rnd.key(3, device="cpu"), 8)
    _, _, _, est = cf.little_bag_masks(gkeys, n, n // 2, 2)
    codes = fo.binarize(torch.as_tensor(x), host.bin_edges)
    leaf = cf._tree_route_stream(host.split_feat, host.split_bin, codes, 8).numpy()
    chan = np.abs(np.stack([np.ones(n), wt, yt, wt * wt, wt * yt], axis=1))
    scale = np.zeros(s2.shape)
    for t in range(16):
        np.add.at(scale[t], leaf[t][est[t].numpy()], chan[est[t].numpy()])
    assert np.array_equal(s1[..., 0][ok], s2[..., 0][ok])
    assert np.all((np.abs(s1 - s2) <= 16 * EPS32 * scale)[ok])
    on_card = cf.predict_cate(card, torch.as_tensor(x, device=cuda))
    host_copy = cf.CausalForest(*(getattr(card, f).cpu() for f in
                                  ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")))
    on_cpu = cf.predict_cate(host_copy, torch.as_tensor(x))
    tau = on_cpu.cate.numpy()
    assert np.all(np.abs(on_card.cate.cpu().numpy() - tau) <= 1e-6 * (1 + np.abs(tau)))


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


def _advance_inputs(seed, n, t, m, masked, dev, p=21):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    node_int = rng.integers(0, 1 << 20, size=(t, n)).astype(np.int32)
    node_rev = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)
    feat = rng.integers(-1, p + 1, size=(t, m)).astype(np.int32)
    thr = rng.integers(0, N_BINS, size=(t, m)).astype(np.int32)
    out = [torch.as_tensor(a, device=dev) for a in (codes, node_int, node_rev, feat, thr)]
    out.append(torch.as_tensor(rng.random((t, n)) < 0.6, device=dev) if masked else None)
    return out


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", [(11016, m) for m in (1, 2, 4, 8, 16, 32, 64, 128, 256)]
                         + [(1001, 32), (3000, 8192)])
def test_route_advance_kernel_equals_plain(cuda, n, m, masked, last):
    """Every width of a depth-9 grow level at the notebook's rows (16-byte
    streams), a row count that is not a multiple of 4 (scalar streams),
    and a width past the shared-memory tables (8,192 nodes): the ids and
    both advanced streams ``torch.equal`` to the plain version's."""
    codes, node_int, node_rev, feat, thr, mask = _advance_inputs(m + n, n, 16, m, masked, cuda)
    want_int, want_rev = node_int.clone(), node_rev.clone()
    want = tt.route_advance_plain(codes, want_int, want_rev, feat, thr, mask, last)
    before = tt.route_advance.launches
    got = tt.route_advance(codes, node_int, node_rev, feat, thr, mask=mask, last=last)
    torch.cuda.synchronize()
    assert tt.route_advance.launches == before + 1
    assert torch.equal(got, want) and torch.equal(node_int, want_int)
    assert torch.equal(node_rev, want_rev)


# (T, n, depth, K or None for the leaf ids, p, codes below): the causal
# predict chunk, DML's forest apply (21 trees a block), an unaligned row
# count, a payload at its shared budget (depth 11), staged tables past
# 48 KB of shared memory with the codes (depth 12), tables and payload
# past their budgets (depth 13), depth 1, codes too wide for the byte
# tile (p = 45), and codes past 255 in some tiles (those blocks read
# global codes).
TRAVERSE_CASES = [(32, 11016, 8, 5, 21, 64), (32, 11016, 8, None, 21, 64),
                  (2000, 11016, 9, 1, 21, 64), (16, 1001, 9, None, 21, 64),
                  (3, 5000, 11, 2, 21, 64), (2, 3001, 12, None, 21, 64),
                  (2, 3001, 13, 3, 21, 64), (5, 100, 1, 1, 21, 64),
                  (4, 3000, 8, 2, 45, 64), (6, 5000, 7, None, 21, 300)]


@pytest.mark.parametrize("t,n,depth,k,p,top", TRAVERSE_CASES)
def test_traverse_kernel_equals_plain(cuda, t, n, depth, k, p, top):
    rng = np.random.default_rng(depth * 7 + n)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    if top > N_BINS:
        codes[rng.random(n) < 0.001] = top  # a few rows: wide codes in some tiles only
    codes = torch.as_tensor(codes, device=cuda)
    width = 1 << (depth - 1)
    feat = torch.as_tensor(rng.integers(-1, p + 1, size=(t, depth, width)).astype(np.int32),
                           device=cuda)
    thr = torch.as_tensor(rng.integers(0, top, size=(t, depth, width)).astype(np.int32),
                          device=cuda)
    table = None if k is None else torch.as_tensor(
        rng.normal(size=(t, 1 << depth, k)).astype(np.float32), device=cuda)
    before = tt.traverse.launches
    got = tt.traverse(codes, feat, thr, table)
    torch.cuda.synchronize()
    assert tt.traverse.launches == before + 1
    assert torch.equal(got, tt.traverse_plain(codes, feat, thr, table))


@pytest.mark.parametrize("t,leaves,n", [(16, 512, 11016), (16, 512, 1001), (3, 16384, 5000),
                                        (4, 8, 0)])
def test_leaf_record_kernel_equals_plain(cuda, t, leaves, n):
    """The leaf values (empty leaves included) and the training rows'
    values ``torch.equal`` to the plain version: the same float32
    division, IEEE-rounded, and add; leaf sums in node_sums' transposed
    layout; staged (512 leaves) and unstaged (16,384) values."""
    rng = np.random.default_rng(leaves + n)
    counts = rng.poisson(1.0, size=(t, leaves)).astype(np.float32)
    sums = (counts * rng.normal(size=(t, leaves))).astype(np.float32)
    ls = torch.as_tensor(np.stack([counts, sums], axis=1), device=cuda).transpose(1, 2)
    mu = torch.as_tensor(rng.random(t).astype(np.float32), device=cuda)
    node = torch.as_tensor(rng.integers(-1, leaves + 2, size=(t, n)).astype(np.int32), device=cuda)
    for base in (0.0 * mu, mu):
        before = tt.leaf_record.launches
        value, train = tt.leaf_record(ls, base, mu, node)
        torch.cuda.synchronize()
        assert tt.leaf_record.launches == before + 1
        want_value, want_train = tt.leaf_record_plain(ls, base, mu, node)
        assert torch.equal(value, want_value) and torch.equal(train, want_train)


def test_leaf_index_and_row_chunk_on_card(cuda):
    """compute_leaf_index on the card equals the CPU's, and predict_cate
    with a leaf index or a row_chunk gives the bits of the plain call."""
    rng = np.random.default_rng(6)
    n, p = 3000, 21
    x = rng.normal(size=(n, p)).astype(np.float32)
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = ((1.0 + x[:, 0]) * wt + 0.3 * rng.normal(size=n)).astype(np.float32)
    forest = cf.grow_causal_forest(*(torch.as_tensor(a, device=cuda) for a in (x, wt, yt)),
                                   rnd.key(3, device=cuda), n_trees=16, depth=8)
    xc = torch.as_tensor(x, device=cuda)
    li = cf.compute_leaf_index(forest, xc, 6, 1000)
    host = cf.CausalForest(*(getattr(forest, f).cpu() for f in
                             ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")))
    assert torch.equal(li.cpu(), cf.compute_leaf_index(host, torch.as_tensor(x)))
    whole = cf.predict_cate(forest, xc)
    for kw in (dict(row_chunk=1000), dict(leaf_index=li), dict(row_chunk=1024, leaf_index=li)):
        got = cf.predict_cate(forest, xc, **kw)
        assert torch.equal(got.cate, whole.cate) and torch.equal(got.variance, whole.variance), kw


def _cd_case(seed, n_fits, p, dtype, dev, n_lam=5, zero_pf=0):
    """Gram systems of standardized random designs (n = max(2p, 60) rows,
    y on the first three columns plus noise), one per fit; penalty
    factors 1 with the first ``zero_pf`` at 0, normalized to sum to p;
    each fit's log-linear λ path from its own λ_max down to 1e-2 of it."""
    rng = np.random.default_rng(seed)
    n = max(2 * p, 60)
    gram, xty = [], []
    for _ in range(n_fits):
        x = rng.normal(size=(n, p))
        x = (x - x.mean(0)) / x.std(0)
        y = x[:, :3] @ np.array([1.0, -0.5, 0.25])[: min(3, p)] + rng.normal(size=n)
        gram.append(x.T @ x / n)
        xty.append(x.T @ y / n)
    pf = np.ones(p)
    pf[:zero_pf] = 0.0
    pf = pf * p / pf.sum()
    xty = np.array(xty)
    lam_max = np.max(np.abs(xty[:, pf > 0]) / pf[pf > 0], axis=1)
    lams = lam_max[:, None] * np.exp(np.linspace(0.0, np.log(1e-2), n_lam))[None, :]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    return as_t(np.array(gram)), as_t(xty), as_t(np.broadcast_to(pf, (n_fits, p))), as_t(lams)


# Kernel against its plain version on the same card tensors. The two sum
# each dot product G_j·β in other orders (the kernel: lane-strided fused
# multiply-add chains and a shuffle butterfly over all but the last d
# coordinates updated, then those d terms oldest first; the plain version:
# PyTorch's sum), so the iterates differ by rounding; the sweeps run to a
# threshold far below that rounding's square (CD_THRESH), so both stop at
# the fixed point to within a few ulps amplified by the conditioning.
CD_THRESH = {torch.float32: 1e-13, torch.float64: 1e-26}
CD_BOUND = {torch.float32: 2e-5, torch.float64: 1e-12}   # |Δβ| ≤ bound·(1 + |β|)


def _cd_close(got, want, dtype):
    return bool(torch.all((got - want).abs() <= CD_BOUND[dtype] * (1 + want.abs())))


def _cd_kernel_equals_plain(gram, xty, pf, lams, dtype, alpha=1.0):
    """One launch counted; two launches equal bits; within CD_BOUND of the
    plain version; a warm start from the second λ gives the same bits."""
    kw = dict(alpha=alpha, thresh=CD_THRESH[dtype])
    before = tl.cd_path.launches
    betas, sweeps = tl.cd_path(gram, xty, pf, lams, **kw)
    torch.cuda.synchronize()
    assert tl.cd_path.launches == before + 1
    again, sweeps_again = tl.cd_path(gram, xty, pf, lams, **kw)
    assert torch.equal(betas, again) and torch.equal(sweeps, sweeps_again)
    want, want_sweeps = tl.cd_path_plain(gram, xty, pf, lams, **kw)
    assert _cd_close(betas, want, dtype), float((betas - want).abs().max())
    assert bool((sweeps >= 1).all()) and bool((sweeps < tl.MAX_SWEEPS).all())
    # A warm start: the path resumed from its second λ gives the same run.
    resumed, _ = tl.cd_path(gram, xty, pf, lams[:, 2:].contiguous(), betas[:, 1].contiguous(),
                            **kw)
    assert torch.equal(resumed, betas[:, 2:])
    return betas, sweeps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p,n_fits,n_lam,zero_pf", [
    (1, 3, 5, 0), (2, 3, 5, 0), (3, 3, 5, 1), (21, 11, 8, 0), (22, 11, 8, 1), (33, 3, 5, 2),
    (224, 2, 3, 0), (225, 2, 3, 0), (462, 2, 3, 0), (463, 2, 3, 0), (530, 2, 2, 0)])
def test_cd_path_kernel_equals_plain(cuda, dtype, p, n_fits, n_lam, zero_pf):
    """p = 1, 2, 3 (a window of the other p − 1 coordinates); the three
    small rows' 21 and 22 (W at penalty factor 0); ragged 33; the largest
    staged Gram (224 in float32) and the first streamed through the ring
    (225); Belloni's 462 and odd 463 (rows 4 bytes off 8-byte alignment);
    530, past 512. One launch counted; two launches equal bits; within
    CD_BOUND of the plain version; the warm-start resume equal bits."""
    _cd_kernel_equals_plain(*_cd_case(p, n_fits, p, dtype, cuda, n_lam, zero_pf), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("edge", [0, 1])
def test_cd_path_kernel_at_the_delay(cuda, dtype, edge):
    """p = d, the last p whose window holds the other p − 1 coordinates,
    and p = d + 1, the first pipelined one (d = the kernel's delay)."""
    p = tl.cd_delay() + edge
    _cd_kernel_equals_plain(*_cd_case(100 + p, 4, p, dtype, cuda, 6, 1), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [5, 22, 462])
def test_cd_path_kernel_elastic_net(cuda, dtype, p):
    """α = 0.5: the ridge part of the divisor, G_jj + λ(1 − α)·pf_j, which
    the kernel prepares once per λ (and for p ≤ d in the update)."""
    _cd_kernel_equals_plain(*_cd_case(50 + p, 3, p, dtype, cuda, 6, 1), dtype, alpha=0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [22, 462])
def test_cd_path_kernel_fits_stop_apart(cuda, dtype, p):
    """Three fits of one launch stop at other sweeps within each λ: one
    with c = 0 (β stays 0: one sweep a λ, so a λ boundary every p
    updates), two ordinary ones (one sweep at λ_max, several after). The
    values the kernel sums ahead do not leak across a frozen fit or a λ
    boundary: each fit launched alone gives the batch's bits, and the
    batch holds to the plain version and resumes equal bits."""
    gram, xty, pf, lams = _cd_case(7 + p, 3, p, dtype, cuda, 6, 0)
    xty[0] = 0.0
    lams[0] = lams[1]                     # fit 0's own λ_max would be 0
    betas, sweeps = _cd_kernel_equals_plain(gram, xty, pf, lams, dtype)
    assert bool((sweeps[0] == 1).all()) and bool((sweeps[1:, 1:] > 1).all())
    for b in range(3):
        alone = tl.cd_path(*(t[b : b + 1].contiguous() for t in (gram, xty, pf, lams)),
                           thresh=CD_THRESH[dtype])
        assert torch.equal(alone[0], betas[b : b + 1]) and torch.equal(alone[1], sweeps[b : b + 1])


def test_cd_kernel_float_division_is_div_rn(cuda):
    """The kernel divides a float32 update by the double reciprocal of its
    divisor (taken once per λ), rounded to float: bit for bit IEEE
    division, held here against the card's div_rn on 2^24 random bit
    patterns of each operand (every class: zeros, subnormals, infinities,
    NaN), on 2^24 pairs of the sizes the updates see, and on edge pairs."""
    from ate_replication_causalml_torch.kernels import build

    k = build.kernel("cd_div_check")
    gen = torch.Generator(device=cuda).manual_seed(8)
    n = 1 << 24
    bits = torch.randint(-(2**31), 2**31, (2, n), dtype=torch.int64, device=cuda, generator=gen)
    cases = [bits.to(torch.int32).view(torch.float32)]
    ab = torch.rand((2, n), device=cuda, generator=gen)
    cases.append(torch.stack([(ab[0] - 0.5) * 4.0, 0.5 + ab[1] * 2.0]))
    f32 = torch.finfo(torch.float32)
    edge = torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0, f32.max, f32.tiny, f32.tiny / 8, 1e-45,
                         float("inf"), float("-inf"), float("nan"), 1 + f32.eps, 1 - f32.eps / 2],
                        device=cuda)
    cases.append(torch.cartesian_prod(edge, edge).T.contiguous())
    for a, b in cases:
        a, b = a.contiguous(), b.contiguous()
        bad = torch.zeros(1, dtype=torch.int64, device=cuda)
        build.check(k, k.fn(a.data_ptr(), b.data_ptr(), a.numel(), bad.data_ptr(),
                            torch.cuda.current_stream(cuda).cuda_stream))
        assert int(bad) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cd_path_kernel_runs_max_sweeps(cuda, dtype):
    """A near-collinear pair (G_12 = 0.9995, c = (1, −1)) at a small λ:
    Gauss–Seidel contracts by G_12² a sweep while each move stays above
    sqrt(thresh), so the default threshold needs every one of MAX_SWEEPS;
    both versions stop there, within a bound scaled by the conditioning
    (κ ≈ 4,000)."""
    g = torch.tensor([[[1.0, 0.9995], [0.9995, 1.0]]], dtype=dtype, device=cuda)
    c = torch.tensor([[1.0, -1.0]], dtype=dtype, device=cuda)
    pf = torch.ones((1, 2), dtype=dtype, device=cuda)
    lams = torch.tensor([[0.5, 1e-6]], dtype=dtype, device=cuda)
    betas, sweeps = tl.cd_path(g, c, pf, lams)
    want, want_sweeps = tl.cd_path_plain(g, c, pf, lams)
    assert int(sweeps[0, 1]) == int(want_sweeps[0, 1]) == tl.MAX_SWEEPS
    assert bool(torch.all((betas - want).abs() <= 4000 * CD_BOUND[dtype] * (1 + want.abs())))


def test_cv_glmnet_on_card_launches_only_the_kernel(cuda, monkeypatch):
    """A CUDA tensor never reaches the plain CD path: with the plain
    version made to raise, a gaussian cv_glmnet on the card is one launch
    (the full fit and ten folds in one batch) and a binomial one a launch
    per IRLS iteration; the selected indices equal the CPU port's."""
    def refuse(*a, **k):
        raise AssertionError("the plain CD path ran on CUDA tensors")

    rng = np.random.default_rng(8)
    n, p = 600, 12
    x = rng.normal(size=(n, p)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + rng.normal(size=n)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 2]))).astype(np.float32)
    key = rnd.key(4, device="cpu")
    host = {f: tl.cv_glmnet(torch.as_tensor(x), torch.as_tensor(t), f, key=key)
            for f, t in (("gaussian", y), ("binomial", w))}
    monkeypatch.setattr(tl, "cd_path_plain", refuse)
    monkeypatch.setattr(tl, "_cd_sweeps", refuse)
    xc = torch.as_tensor(x, device=cuda)
    for family, t in (("gaussian", y), ("binomial", w)):
        before = tl.cd_path.launches
        got = tl.cv_glmnet(xc, torch.as_tensor(t, device=cuda), family, key=key.to(cuda))
        launches = tl.cd_path.launches - before
        assert launches == 1 if family == "gaussian" else 1 <= launches <= 100 * tl.MAX_IRLS
        ref = host[family]
        assert (int(got.index_min), int(got.index_1se)) == (int(ref.index_min), int(ref.index_1se))
        assert torch.allclose(got.path.coefs.cpu(), ref.path.coefs, rtol=1e-3, atol=1e-4)


# The balancing QP and the sweep on the card.

def _arm(n, k, seed, shift):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)) + shift
    return x, x.mean(axis=0) + rng.normal(size=k) * (0.3 if shift else 0.03)


@pytest.mark.parametrize("n,k,seed,shift", [(40, 4, 0, 0.0), (300, 6, 1, 0.0), (2000, 21, 2, 0.2)])
def test_balance_qp_x64_on_card_vs_cpu(cuda, n, k, seed, shift):
    """The float64 ADMM on the card against the CPU port: the same
    iterations, γ within 1e-11 (matrix products and sums in another
    order, carried through the contracting iteration; the bound of
    tests/test_torch_qp.py against the JAX package)."""
    from ate_replication_causalml_torch.ops import qp

    x, target = _arm(n, k, seed, shift)
    host = qp.balance_qp_x64(torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(target))
    card = qp.balance_qp_x64(torch.as_tensor(x, dtype=torch.float32, device=cuda),
                             torch.as_tensor(target, device=cuda))
    assert card.gamma.device.type == "cuda" and card.gamma.dtype == torch.float64
    assert card.iters == host.iters < 4000
    assert float((card.gamma.cpu() - host.gamma).abs().max()) <= 1e-11


def test_residual_balance_ate_on_card(cuda, monkeypatch):
    """The residual_balancing row on the card: one cd_path launch an arm
    (each arm's CV fit is one batch), each arm's ADMM iterations those of
    the CPU port, τ and SE within 5e-5 of it (tests/test_torch_balance.py's
    bound)."""
    from ate_replication_causalml_torch.estimators import balance

    rng = np.random.default_rng(9)
    n, p = 2000, 21
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    y = (x[:, 1] + 0.1 * w + rng.normal(size=n) > 0).astype(np.float32)
    iters = []
    solve = balance.approx_balance_sol

    def record(*a, **k):
        out = solve(*a, **k)
        iters.append(out[2])
        return out

    monkeypatch.setattr(balance, "approx_balance_sol", record)
    host = balance.residual_balance_ate(CausalFrame(*(torch.as_tensor(a) for a in (x, w, y))))
    before = tl.cd_path.launches
    card = balance.residual_balance_ate(
        CausalFrame(*(torch.as_tensor(a, device=cuda) for a in (x, w, y))))
    assert tl.cd_path.launches - before == 2
    assert iters[:2] == iters[2:]
    assert abs(card.ate - host.ate) <= 5e-5 and abs(card.se - host.se) <= 5e-5


def _kernel_launches() -> int:
    return sum(getattr(fn, attr) for fn, attr in (
        (th.bin_histogram_batched, "launches"), (th.bin_histogram_batched, "partition_launches"),
        (th.bin_histogram_batched, "packed_launches"), (th.bin_histogram_shared, "launches"),
        (th.bin_histogram_shared, "partition_launches"),
        (th.bin_histogram_shared, "packed_launches"), (th.node_sums, "launches"),
        (th.node_sums_shared, "launches"), (tt.route_bits, "launches"),
        (tt.table_lookup, "launches"), (tp.pack_codes, "launches"), (tt.route_advance, "launches"),
        (tt.traverse, "launches"), (tt.leaf_record, "launches"), (tl.cd_path, "launches")))


def test_run_sweep_on_card_then_resume(cuda, tmp_path):
    """The MICRO sweep (tests/test_torch_pipeline.py's configuration) on
    the card, the default device: every row finite, the kernels launched;
    a second run on the same directory resumes all 14 records, launches
    no kernel and returns the same rows."""
    import dataclasses

    from ate_replication_causalml_torch import pipeline
    from ate_replication_causalml_torch.data.pipeline import PrepConfig

    micro = dataclasses.replace(
        pipeline.SweepConfig().quick(), prep=PrepConfig(n_obs=1200), synthetic_pool=3000,
        dr_trees=16, dml_trees=16, cf_trees=16, cf_nuisance_trees=16, forest_depth=4,
        balance_iters=600, use_mesh=False)
    out = str(tmp_path / "sweep")
    before = _kernel_launches()
    first = pipeline.run_sweep(micro, outdir=out, plots=False, log=lambda s: None)
    assert _kernel_launches() > before and tl.cd_path.launches > 0
    assert first.results.methods() == list(pipeline.SWEEP_METHODS) and first.computed == 14
    assert all(np.isfinite(r.ate) and r.status == "ok" for r in first.results)
    before = _kernel_launches()
    again = pipeline.run_sweep(micro, outdir=out, plots=False, log=lambda s: None)
    assert _kernel_launches() == before
    assert (again.computed, again.resumed) == (0, 14)
    same = lambda a, b: pipeline._jsonsafe(a.to_dict()) == pipeline._jsonsafe(b.to_dict())
    assert same(again.oracle, first.oracle)
    assert all(same(a, b) for a, b in zip(again.results, first.results))


def _serve_forest(seed, dev, t=8, depth=3, p=4, n_bins=8, n=50):
    """A small causal forest whose leaf statistics are sums of drawn rows."""
    rng = np.random.default_rng(seed)
    stats = np.zeros((t, 1 << depth, 5))
    for tree in range(t):
        for leaf in range(1 << depth):
            c = int(rng.integers(2, 12))
            wt, yt = rng.normal(size=c), rng.normal(size=c)
            stats[tree, leaf] = (c, wt.sum(), yt.sum(), (wt * wt).sum(), (wt * yt).sum())
    arrays = {
        "split_feat": rng.integers(0, p, size=(t, depth, 1 << depth)).astype(np.int32),
        "split_bin": rng.integers(0, n_bins - 1, size=(t, depth, 1 << depth)).astype(np.int32),
        "leaf_stats": stats.astype(np.float32),
        "in_sample": rng.uniform(size=(t, n)) < 0.5,
        "bin_edges": np.sort(rng.normal(size=(p, n_bins - 1)), axis=1).astype(np.float32),
    }
    return cf.CausalForest(**{k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
                           ci_group_size=2)


@pytest.mark.parametrize("batch", [1, 16, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_warm_predict_graph_replay_equals_eager(cuda, batch, masked):
    """A warmed predict is one CUDA graph: each replay equals the eager
    predict_cate bit for bit (masked rows exactly 0), a same-shape forest
    rebinds without a capture, and every replay adds the traverse
    launches it runs (one a 32-tree chunk)."""
    from ate_replication_causalml_torch import observability as obs

    f1, f2 = _serve_forest(6, cuda), _serve_forest(7, cuda)
    lower = cf.lower_predict_cate_masked if masked else cf.lower_predict_cate
    warm = lower(f1, batch)
    assert warm.traverse_per_replay == 1
    captures = sum((obs.REGISTRY.peek("graph_captures_total") or {}).values())
    rng = np.random.default_rng(8)
    mask = (np.arange(batch) < max(1, batch - 3)).astype(np.float32)
    for f in (f1, f2, f1):
        x = rng.normal(size=(batch, 4)).astype(np.float32)
        before = tt.traverse.launches
        got = warm(f, x, mask) if masked else warm(f, x)
        assert tt.traverse.launches - before == 1
        want = cf.predict_cate(f, torch.as_tensor(x, device=cuda), oob=False)
        for g, w in ((got.cate, want.cate), (got.variance, want.variance)):
            w = w.cpu().numpy()
            if masked:
                real = mask > 0
                assert np.array_equal(g[real], w[real]) and np.all(g[~real] == 0.0)
            else:
                assert np.array_equal(g, w)
    assert sum((obs.REGISTRY.peek("graph_captures_total") or {}).values()) == captures


def test_card_daemon_serves_bit_identical(cuda, tmp_path):
    """The daemon on the card: a checkpoint loaded onto it, one graph a
    bucket, 40 requests from two threads bit-identical to the offline
    predict_cate on the card, no build and no capture after warm."""
    import threading

    from ate_replication_causalml_torch.serving.coalescer import BucketPlan
    from ate_replication_causalml_torch.serving.daemon import CateServer, ServeConfig
    from ate_replication_causalml_torch.utils.checkpoint import save_fitted

    forest = _serve_forest(9, cuda)
    ckpt = str(tmp_path / "forest.npz")
    save_fitted(ckpt, forest)
    rng = np.random.default_rng(10)
    xs = [rng.normal(size=(s, 4)).astype(np.float32) for s in (1, 3, 4, 9, 16) * 8]
    off = cf.predict_cate(forest, torch.as_tensor(np.concatenate(xs), device=cuda), oob=False)
    server = CateServer(ServeConfig(checkpoint=ckpt, buckets=BucketPlan.parse("4,16"),
                                    window_s=0.002, max_depth=64))
    server.startup()
    out = {}

    def producer(k):
        for i in range(k, len(xs), 2):
            out[i] = server.serve_one(f"r{i}", xs[i])

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    start = 0
    for i, x in enumerate(xs):
        n = x.shape[0]
        assert np.array_equal(out[i][0], off.cate[start:start + n].cpu().numpy())
        assert np.array_equal(out[i][1], off.variance[start:start + n].cpu().numpy())
        start += n
    assert server.builds_in_window() == {"kernel": 0.0, "graph": 0.0}
    server.stop()


def test_card_rotation_while_serving_captures_nothing(cuda, tmp_path):
    """A same-geometry rotation on the card while a second thread's
    requests replay the graphs: every reply bit for bit the offline
    predict_cate of the version it names, the fitted checkpoints' leaf
    index built at startup and before each swap, and no kernel build and
    no graph capture in the window."""
    import threading
    import time

    from ate_replication_causalml_torch.serving.coalescer import BucketPlan
    from ate_replication_causalml_torch.serving.daemon import CateServer, ServeConfig
    from ate_replication_causalml_torch.utils.checkpoint import save_fitted

    rng = np.random.default_rng(12)
    forests, paths = {}, {}
    for k, seed in (("a", 9), ("b", 11)):
        f = _serve_forest(seed, cuda)
        col = torch.as_tensor(rng.uniform(size=50).astype(np.float32), device=cuda)
        x = torch.as_tensor(rng.normal(size=(50, 4)).astype(np.float32), device=cuda)
        paths[k] = str(tmp_path / f"{k}.npz")
        save_fitted(paths[k], cf.FittedCausalForest(forest=f, y_hat=col, w_hat=col, x=x, y=col,
                                                    w=col))
        forests[k] = f
    server = CateServer(ServeConfig(checkpoint=paths["a"], buckets=BucketPlan.parse("4,16"),
                                    window_s=0.002, max_depth=64))
    server.startup()
    assert server.stats()["fleet"]["default"]["leaf_index_rows"] == 50
    xs = [rng.normal(size=(s, 4)).astype(np.float32) for s in (1, 3, 4, 9, 16) * 40]
    replies, stop = [], threading.Event()

    def producer():
        for i, x in enumerate(xs):
            if stop.is_set():
                return
            replies.append((x, server.serve_request(f"r{i}", x)))

    t = threading.Thread(target=producer)
    t.start()
    by_version = {1: "a"}
    for v, k in ((2, "b"), (3, "a"), (4, "b")):
        time.sleep(0.02)
        assert server.rotate("default", paths[k]) == "rotated"
        by_version[v] = k
    t.join(120)
    stop.set()
    assert server.stats()["fleet"]["default"]["leaf_index_rows"] == 50
    seen = set()
    for x, req in replies:
        want = cf.predict_cate(forests[by_version[req.model_version]],
                               torch.as_tensor(x, device=cuda), oob=False)
        assert np.array_equal(req.result[0], want.cate.cpu().numpy())
        assert np.array_equal(req.result[1], want.variance.cpu().numpy())
        seen.add(req.model_version)
    assert len(seen) >= 2
    assert server.builds_in_window() == {"kernel": 0.0, "graph": 0.0}
    server.stop()
