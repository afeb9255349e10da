"""ops/hist.py: the plain histogram and node sums, per-tree and shared
weights, equal the JAX package's Pallas kernels (run in interpret mode,
dense and partition), and the kernel-mode policy names the same
formulation per width as the JAX package's. The CUDA kernels are held
against the plain version in tests/test_torch_kernels.py.

Float bound: both sides sum the same f32 products in another order, so
a cell may differ by a few roundings of its running sum. Per cell
|Δ| ≤ 8·eps_f32·Σ|w| (Σ over the rows of the call, at most 1,500 here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import pack as tp
from ate_replication_causalml_tpu.ops import hist_pallas as jh

N_BINS = 64


def _case(seed, n, p, t, k, m, integer=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, N_BINS, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m + 2, size=(t, n)).astype(np.int32)  # −1 and ≥ M drop out
    if integer:
        counts = rng.poisson(1.0, size=(t, n)).astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32)
        w = np.stack([counts, counts * y], axis=1)[:, :k]
    else:
        w = rng.normal(size=(t, k, n)).astype(np.float32)
    return codes, ids, w


def _jax_batched(codes, ids, w, m, partition=False):
    return np.asarray(jh.bin_histogram_pallas_batched(
        jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(w),
        max_nodes=m, n_bins=N_BINS, interpret=True, partition=partition))


def _torch_batched(codes, ids, w, m, mode="dense"):
    return th.bin_histogram_batched(torch.as_tensor(codes), torch.as_tensor(ids),
                                    torch.as_tensor(w), max_nodes=m, n_bins=N_BINS,
                                    mode=mode).numpy()


def _jax_shared(codes, ids, w, m, partition=False):
    return np.asarray(jh.bin_histogram_pallas_batched_shared(
        jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(w),
        max_nodes=m, n_bins=N_BINS, interpret=True, partition=partition))


def _torch_shared(codes, ids, w, m, mode="dense"):
    return th.bin_histogram_shared(torch.as_tensor(codes), torch.as_tensor(ids),
                                   torch.as_tensor(w), max_nodes=m, n_bins=N_BINS,
                                   mode=mode).numpy()


def _within_float_bound(got, ref, w):
    """|Δ| ≤ 8·eps·Σ|w| per (tree, channel) of a (T, K, M, p, b) output;
    w is (T, K, n) or (K, n) shared."""
    scale = np.abs(w).sum(axis=-1)
    scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
    return bool(np.all(np.abs(got - ref) <= 8 * np.finfo(np.float32).eps * scale))


def _moments(seed, n):
    """The causal grower's five channels [1, w̃, ỹ, w̃², w̃ỹ], (5, n)."""
    rng = np.random.default_rng(seed)
    wt = (rng.random(n) - 0.4).astype(np.float32)
    yt = rng.normal(size=n).astype(np.float32)
    return np.stack([np.ones(n, np.float32), wt, yt, wt * wt, wt * yt])


@pytest.mark.parametrize("t,m", [(1, 1), (3, 4), (4, 16)])
def test_plain_equals_pallas_interpret_integer_weights(t, m):
    codes, ids, w = _case(t * 100 + m, 1500, 21, t, 2, m)
    assert np.array_equal(_torch_batched(codes, ids, w, m), _jax_batched(codes, ids, w, m))


def test_plain_float_weights_within_bound():
    """Float weights: both sides sum the same products in another order.
    Bound: |Δ| ≤ 8·eps_f32·Σ|w| per cell (a sum of ≤1500 f32 terms;
    largest seen 7.6e-6 at T=4, M=128, about 0.2 of the bound)."""
    codes, ids, w = _case(5, 1500, 7, 2, 3, 8, integer=False)
    got, ref = _torch_batched(codes, ids, w, 8), _jax_batched(codes, ids, w, 8)
    assert _within_float_bound(got, ref, w)


@pytest.mark.parametrize("mode", ["dense", "partition"])
@pytest.mark.parametrize("t,m", [(1, 1), (3, 16), (2, 64)])
def test_shared_weights_integer_equal_pallas_interpret(mode, t, m):
    """One (K, n) integer stack shared by T trees: exact in both modes."""
    codes, ids, w = _case(40 + t + m, 1200, 21, t, 2, m)
    ws = np.ascontiguousarray(w[0])
    ref = _jax_shared(codes, ids, ws, m, partition=mode == "partition")
    assert np.array_equal(_torch_shared(codes, ids, ws, m, mode), ref)
    # The shared form equals the per-tree form with the stack repeated.
    wt = np.repeat(ws[None], t, axis=0)
    assert np.array_equal(_torch_batched(codes, ids, wt, m, mode), ref)


@pytest.mark.parametrize("mode", ["dense", "partition"])
def test_shared_weights_float_within_bound(mode):
    """The causal grower's five float channels, honest membership as −1
    ids, against the JAX kernel: within 8·eps·Σ|w| per cell."""
    codes, ids, _ = _case(41, 1500, 21, 4, 2, 16)
    w = _moments(3, 1500)
    got = _torch_shared(codes, ids, w, 16, mode)
    ref = _jax_shared(codes, ids, w, 16, partition=mode == "partition")
    assert _within_float_bound(got, ref, w)


def test_partition_equals_dense_on_integer_stacks():
    """Both JAX formulations and the port's agree exactly on integer
    weights (the partition kernel's contract is dense's)."""
    codes, ids, w = _case(42, 1500, 21, 3, 2, 32)
    dense = _jax_batched(codes, ids, w, 32)
    assert np.array_equal(_jax_batched(codes, ids, w, 32, partition=True), dense)
    assert np.array_equal(_torch_batched(codes, ids, w, 32, "partition"), dense)


def test_single_tree_is_the_t1_case_of_the_batched_kernel():
    codes, ids, w = _case(11, 1200, 21, 1, 2, 8)
    ref = np.asarray(jh.bin_histogram_pallas(
        jnp.asarray(codes), jnp.asarray(ids[0]), jnp.asarray(w[0]),
        max_nodes=8, n_bins=N_BINS, interpret=True))
    got = th.bin_histogram(torch.as_tensor(codes), torch.as_tensor(ids[0]),
                           torch.as_tensor(w[0]), max_nodes=8, n_bins=N_BINS).numpy()
    assert np.array_equal(got, ref)


def test_result_independent_of_tree_batch():
    codes, ids, w = _case(12, 900, 21, 5, 2, 4)
    whole = _torch_batched(codes, ids, w, 4)
    for i in range(5):
        assert np.array_equal(whole[i], _torch_batched(codes, ids[i : i + 1], w[i : i + 1], 4)[0])


@pytest.mark.parametrize("m", [1, 16, 512])
def test_node_sums_equal_pallas_interpret(m):
    _, ids, w = _case(13 + m, 1300, 1, 3, 2, m)
    got = th.node_sums(torch.as_tensor(ids), torch.as_tensor(w), m).numpy()
    assert got.shape == (3, m, 2)
    for i in range(3):
        ref = np.asarray(jh.node_sums(jnp.asarray(ids[i]), jnp.asarray(w[i]), m,
                                      backend="pallas_interpret"))
        assert np.array_equal(got[i], ref)


@pytest.mark.parametrize("m", [1, 256])
def test_node_sums_shared_equal_pallas_interpret(m):
    """The honest leaf payload: K=5 shared channels, estimate-half
    membership as −1 ids. Integer stacks exact, float ones within
    8·eps·Σ|w|."""
    _, ids, w = _case(50 + m, 1300, 1, 3, 2, m)
    for ws, exact in ((np.ascontiguousarray(w[0]), True), (_moments(m, 1300), False)):
        got = th.node_sums_shared(torch.as_tensor(ids), torch.as_tensor(ws), m).numpy()
        assert got.shape == (3, m, ws.shape[0])
        for i in range(3):
            ref = np.asarray(jh.node_sums_shared(jnp.asarray(ids[i]), jnp.asarray(ws), m,
                                                 backend="pallas_interpret"))
            if exact:
                assert np.array_equal(got[i], ref)
            else:
                scale = np.abs(ws).sum(axis=1)[None, :]
                assert np.all(np.abs(got[i] - ref) <= 8 * np.finfo(np.float32).eps * scale)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("p,n_bins", [(5, 16), (21, 64), (21, 128), (3, 256)])
def test_mode_policy_equals_jax(k, p, n_bins):
    """Under every policy the port picks the JAX package's formulation
    for every kernel width (the crossover is the JAX package's TPU
    FLOP model, copied)."""
    assert th.partition_crossover_width(k, p, n_bins) == jh.partition_crossover_width(k, p, n_bins)
    for mode in ("dense", "partition", "auto"):
        for width in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            assert th.mode_for_width(mode, width, k, p, n_bins) == jh.mode_for_width(
                mode, width, k, p, n_bins)
    for mode in ("dense", "partition"):
        assert th.hist_level_flops(mode, 11016, 64, k, p, n_bins) == jh.hist_level_flops(
            mode, 11016, 64, k, p, n_bins)
    assert th.partition_crossover_width(5) == 16 and th.partition_crossover_width(2) == 32


def test_resolve_hist_mode_reads_the_jax_packages_settings(monkeypatch):
    monkeypatch.delenv(th.HIST_MODE_ENV, raising=False)
    monkeypatch.delenv(tp.ENV_PACK, raising=False)
    assert th.resolve_hist_mode(None) == jh.resolve_hist_mode(None) == "auto"
    monkeypatch.setenv(th.HIST_MODE_ENV, "Partition")
    assert th.resolve_hist_mode(None) == jh.resolve_hist_mode(None) == "partition"
    assert th.resolve_hist_mode("dense") == "dense"
    monkeypatch.setenv(th.HIST_MODE_ENV, "bogus")
    with pytest.raises(ValueError, match="ATE_TPU_HIST_MODE"):
        th.resolve_hist_mode(None)
    monkeypatch.setenv(th.HIST_MODE_ENV, "auto")
    monkeypatch.setenv(tp.ENV_PACK, "1")  # the packed policy, now ported
    assert th.resolve_hist_mode_packed(None, 64) == jh.resolve_hist_mode_packed(None, 64) == "auto+pack"
    assert th.resolve_hist_mode_packed(None, 256) == "auto"  # 256 bins never pack
    with pytest.raises(ValueError, match="ATE_TPU_HIST_MODE"):
        th.resolve_hist_mode("partition+pack")  # the suffix is resolve_hist_mode_packed's


def test_unported_modes_rejected():
    """Every formulation of the JAX package now runs: "partition" and
    "partition+pack" give the dense bits. "dense+pack" is refused as in
    the JAX package, and "auto" is resolved per width by the caller,
    never at dispatch."""
    codes, ids, w = (torch.as_tensor(a) for a in _case(1, 100, 3, 1, 2, 2))
    with pytest.raises(ValueError, match="partition kernel only"):
        th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS, mode="dense+pack")
    for mode in ("auto", "bogus", "auto+pack"):
        with pytest.raises(ValueError, match="mode_for_width"):
            th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS, mode=mode)
    dense = th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS)
    for mode in ("partition", "partition+pack"):
        assert torch.equal(th.bin_histogram_batched(codes, ids, w, max_nodes=2, n_bins=N_BINS,
                                                    mode=mode), dense)


def test_kernel_path_takes_float_weights_and_raises_off_cuda():
    """Off the CPU every wrapper goes to its kernel whatever the weights:
    float weights are taken (the kernels add in a fixed order), and a
    device without a kernel raises instead of falling back (meta tensors
    reach that point without a card), in every formulation."""
    codes, ids, w = (torch.as_tensor(a).to("meta")
                     for a in _case(3, 100, 3, 2, 2, 4, integer=False))
    calls = (
        lambda: th.bin_histogram_batched(codes, ids, w, max_nodes=4, n_bins=N_BINS),
        lambda: th.bin_histogram_batched(codes, ids, w, max_nodes=4, n_bins=N_BINS,
                                         mode="partition"),
        lambda: th.bin_histogram_batched(codes, ids, w, max_nodes=4, n_bins=N_BINS,
                                         mode="partition+pack"),
        lambda: th.bin_histogram_shared(codes, ids, w[0], max_nodes=4, n_bins=N_BINS),
        lambda: th.bin_histogram_shared(codes, ids, w[0], max_nodes=4, n_bins=N_BINS,
                                        mode="partition+pack"),
        lambda: th.node_sums(ids, w, 4),
        lambda: th.node_sums_shared(ids, w[0], 4),
    )
    for call in calls:
        with pytest.raises(ValueError, match="no histogram kernel for device meta"):
            call()


def test_wrapper_rejects_wrong_dtypes():
    codes, ids, w = (torch.as_tensor(a) for a in _case(2, 100, 3, 1, 2, 2))
    with pytest.raises(TypeError):
        th.bin_histogram_batched(codes.long(), ids, w, max_nodes=2, n_bins=N_BINS)
    with pytest.raises(TypeError):
        th.bin_histogram_batched(codes, ids, w.double(), max_nodes=2, n_bins=N_BINS)
    with pytest.raises(TypeError, match=r"\(K, n\)"):
        th.bin_histogram_shared(codes, ids, w, max_nodes=2, n_bins=N_BINS)



# (K, M, p, n_bins): the paths' shapes (K=2 classifier levels and leaf
# sums, K=5 causal levels and honest leaf sums, p=21, 64 bins) and edges
# (every K to 8, M not a power of two, p of 1, 2, 20 and 22, 1 and 128 bins).
GEOMETRY_CASES = (
    [(2, m, 21, 64) for m in (1, 2, 4, 8, 16, 32, 64, 128)]
    + [(5, m, 21, 64) for m in (1, 2, 4, 8, 16, 32, 64, 128)]
    + [(2, 512, 1, 1), (5, 256, 1, 1)]
    + [(k, 100, 21, 64) for k in (1, 3, 8)]
    + [(8, 128, 20, 64), (4, 3, 22, 128), (6, 77, 2, 16), (7, 1, 1, 128), (2, 1000, 1, 1)]
)
PATH_PACKED = [(2, m) for m in (32, 64, 128)] + [(5, m) for m in (16, 32, 64, 128)]


@pytest.mark.parametrize("n,n_trees", [(11016, 16), (1_000_000, 16), (5, 2), (11016, 1)])
@pytest.mark.parametrize("k,m,p,n_bins", GEOMETRY_CASES)
def test_dense_geometry_gives_each_cell_one_warp(k, m, p, n_bins, n, n_trees):
    """The dense kernel's blocks (feature group × node group) and warps
    (feature × contiguous node run) cover each (feature, node) cell
    exactly once; a block stays within 16 warps and the two-blocks-per-SM
    budget, or within a block's 227 KB where one node's tile exceeds it."""
    shape = (k, m, p, n_bins, n_trees, th._n_parts(n, n_trees, p))
    f_per = th.dense_features_per_block(*shape)
    groups = th.dense_node_groups(k, m, n_bins)
    slices = th.dense_warps_per_feature(*shape)
    group = -(-m // groups)
    run = -(-group // slices)
    assert 1 <= f_per * slices <= th._DENSE_MAX_WARPS and groups <= m
    owners = np.zeros((p, m), np.int64)
    for fg in range(-(-p // f_per)):
        for g in range(groups):
            nodes = min(group, m - g * group)
            for warp in range(f_per * slices):
                f = fg * f_per + warp % f_per
                lo = (warp // f_per) * run
                if f < p and lo < nodes:
                    owners[f, g * group + lo: g * group + min(lo + run, nodes)] += 1
    assert (owners == 1).all()
    used = th.dense_block_bytes(*shape)
    assert used <= th._MAX_SMEM_BYTES
    one_node = 4 * k * n_bins + th._dense_stage_bytes(k, 1)
    assert used <= th._DENSE_SMEM_BUDGET or one_node > th._DENSE_SMEM_BUDGET


@pytest.mark.parametrize("k,m,p,n_bins", GEOMETRY_CASES)
def test_packed_geometry_gives_each_cell_one_block(k, m, p, n_bins):
    """The packed pass's blocks (word × slot group × node group) cover each
    (feature, node) cell exactly once, within a quarter of an SM's shared
    memory (four 16-warp blocks on an SM), and take all 3 slots of a word
    at every shape here (K ≤ 8, n_bins ≤ 128)."""
    slots = th.packed_slots(k, m, n_bins)
    groups = th.packed_node_groups(k, m, n_bins)
    group = -(-m // groups)
    owners = np.zeros((p, m), np.int64)
    for word in range(tp.packed_width(p)):
        for sg in range(-(-tp.PACK_SLOTS // slots)):
            for g in range(groups):
                s0 = sg * slots
                for s in range(s0, min(s0 + slots, tp.PACK_SLOTS)):
                    f = word * tp.PACK_SLOTS + s
                    if f < p:
                        owners[f, g * group: min(m, (g + 1) * group)] += 1
    assert (owners == 1).all()
    assert th.packed_block_bytes(k, m, n_bins) <= th._PACKED_SMEM_BUDGET
    assert slots == tp.PACK_SLOTS


@pytest.mark.parametrize("k,m", PATH_PACKED)
def test_packed_pass_keeps_three_slots_on_the_paths(k, m):
    """At the paths' partition widths (K=2: 32–128, K=5: 16–128) a block
    takes all three slots of a word, where a whole (K, M, 64) tile per
    slot took 2 or 1 at K=5 M ≥ 64; node groups absorb the width, at
    least two of them."""
    assert th.packed_slots(k, m, N_BINS) == 3
    groups = th.packed_node_groups(k, m, N_BINS)
    assert 3 * 4 * k * -(-m // groups) * N_BINS <= th._PACKED_SMEM_BUDGET
    # The fewest groups that fit, but at least two.
    assert groups == 2 or 3 * 4 * k * -(-m // (groups - 1)) * N_BINS > th._PACKED_SMEM_BUDGET


@pytest.mark.parametrize("k,m,p,n,f_per", [(2, 1, 21, 11016, 3), (2, 16, 21, 11016, 3),
                                          (2, 128, 21, 11016, 1), (5, 8, 21, 11016, 3),
                                          (2, 128, 21, 1_000_000, 1), (2, 512, 1, 11016, 1)])
def test_dense_grid_fills_the_card_at_the_paths_shapes(k, m, p, n, f_per):
    """At the paths' shapes (16 trees) the dense grid has at least 2.5
    blocks per SM of an H100, as few features per block as that needs;
    a block with a feature to itself splits its nodes over 4 warps."""
    n_parts = th._n_parts(n, 16, p)
    shape = (k, m, p, 64 if p > 1 else 1, 16, n_parts)
    assert th.dense_features_per_block(*shape) == f_per
    groups = th.dense_node_groups(k, m, shape[3])
    assert 16 * n_parts * groups * -(-p // f_per) >= 330 or f_per == 1
    assert th.dense_warps_per_feature(*shape) == (4 if f_per == 1 else 1)


def _node_runs(seg_r, runs):
    """The unpacked partition pass's warp → node-run split as the kernel
    computes it (``csrc/hist_partition.cu::partition_accumulate``): run r
    takes the nodes whose segment midpoints lie in [r·chunk, (r + 1)·chunk),
    the last run every node from its first on."""
    m = len(seg_r) - 1
    chunk2 = 2 * -(-int(seg_r[m]) // runs)
    mids2 = seg_r[:m] + seg_r[1:]  # twice the midpoints, non-decreasing
    first_by_mid = lambda q2: int(np.searchsorted(mids2, q2, side="left"))
    return [(first_by_mid(r * chunk2), m if r + 1 == runs else first_by_mid((r + 1) * chunk2))
            for r in range(runs)]


def _seg_ids(shape, m, n, rng):
    """Node ids of one tree: uniform with dropped rows, only every third
    node used (empty nodes), every row in the last node, or every row in
    node 0."""
    if shape == "uniform":
        return rng.integers(-1, m + 2, size=n)
    if shape == "sparse":
        return 3 * rng.integers(0, -(-m // 3), size=n)
    return np.full(n, m - 1 if shape == "last" else 0)


@pytest.mark.parametrize("shape", ["uniform", "sparse", "last", "first"])
@pytest.mark.parametrize("n,n_trees", [(11016, 16), (5, 2), (15001, 3)])
@pytest.mark.parametrize("k,m,p,n_bins", GEOMETRY_CASES)
def test_partition_geometry_gives_each_cell_one_warp(k, m, p, n_bins, n, n_trees, shape):
    """The unpacked partition pass's blocks (row range × feature) and
    warps (node runs) give each (range, feature, node) cell exactly one
    block and one warp, on segments with empty nodes and with one node
    holding every row, at M not a multiple of 16; a run's rows start
    where the last one's end (whole nodes, in order)."""
    n_parts = th._n_parts(n, n_trees, p)
    rng = np.random.default_rng(k * 1000 + m + p)
    ids = _seg_ids(shape, m, min(n, 4000), rng).astype(np.int32)[None]
    _, seg, _, _ = th.partition_sort_plain(torch.as_tensor(ids), m, n_parts)
    for part in range(n_parts):
        seg_r = seg[0, part].numpy()
        node_runs = _node_runs(seg_r, 16)
        owners = np.zeros(m, np.int64)  # per node, for each of the p feature blocks
        for a, b in node_runs:
            owners[a:b] += 1
        assert (owners == 1).all(), part
        bounds = [seg_r[a] for a, _ in node_runs] + [seg_r[node_runs[-1][1]]]
        assert bounds[0] == 0 and bounds[-1] == seg_r[m] and np.all(np.diff(bounds) >= 0)


def test_node_run_split_balances_uniform_nodes():
    """Midpoints, not segment starts: at M=16 (one node per run) with
    uniform ids, no run takes a second node; splitting at starts gave some
    runs two (1.7× the rows)."""
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 16, size=(8, 3672)).astype(np.int32)
    _, seg, _, _ = th.partition_sort_plain(torch.as_tensor(ids), 16, 1)
    for tree in range(8):
        assert _node_runs(seg[tree, 0].numpy(), 16) == [(r, r + 1) for r in range(16)]


@pytest.mark.parametrize("n,k,m", [(11016, 2, 32), (11016, 2, 64), (11016, 2, 128), (11016, 5, 16),
                                   (11016, 5, 32), (11016, 5, 64), (5508, 2, 128)])
def test_partition_cluster_holds_the_ranges_at_the_paths_shapes(n, k, m):
    """At the paths' partition widths (16 trees, p=21) the row ranges (3)
    form one cluster, within the portable size of 8, so no partial slab is
    written; a block takes one feature, so the grid (ranges × features ×
    trees) has over 2.5 blocks per SM, and four of its (K, M, 64) tiles fit
    an SM at K=2 M ≤ 64 and K=5 M ≤ 32, two at K=2 M=128 and K=5 M=64."""
    n_parts = th._n_parts(n, 16, 21)
    assert n_parts == 3 and th.partition_cluster_ranges(n_parts) == n_parts <= 8
    assert n_parts * 21 * 16 >= 330
    per_sm = th._SM_SMEM_BYTES // (4 * k * m * 64 + th._BLOCK_RESERVED_BYTES)
    assert per_sm >= (4 if k * m <= 160 else 2)


@pytest.mark.parametrize("n_parts,cluster", [(1, 1), (2, 2), (3, 3), (8, 8), (9, 1), (16, 1)])
def test_partition_cluster_ranges(n_parts, cluster):
    """One range needs no cluster; 2–8 form one; more keep the slabs."""
    assert th.partition_cluster_ranges(n_parts) == cluster


@pytest.mark.parametrize("n,m,n_parts", [(23, 5, 3), (1000, 100, 1), (4097, 16, 3), (300, 7, 16)])
def test_partition_sort_plain_is_a_stable_sort_per_range(n, m, n_parts):
    """perm lists each range's rows with an id in [0, M) once, by (id,
    row), from the range's first position, −1 after them; seg holds each
    node's first position and the range's count; node_sorted and w_sorted
    hold each position's node and weights (per-tree or shared)."""
    rng = np.random.default_rng(n + m)
    ids = rng.integers(-2, m + 3, size=(3, n)).astype(np.int32)
    w = rng.normal(size=(3, 2, n)).astype(np.float32)
    perm, seg, node_sorted, w_sorted = th.partition_sort_plain(
        torch.as_tensor(ids), m, n_parts, torch.as_tensor(w))
    shared = th.partition_sort_plain(torch.as_tensor(ids), m, n_parts, torch.as_tensor(w[0]))
    assert torch.equal(shared[0], perm) and torch.equal(shared[2], node_sorted)
    span = -(-n // n_parts)
    for t in range(3):
        for part in range(n_parts):
            lo, hi = min(n, part * span), min(n, (part + 1) * span)
            rows = [r for r in range(lo, hi) if 0 <= ids[t, r] < m]
            want = sorted(rows, key=lambda r: (ids[t, r], r))
            got = perm[t, lo:hi].numpy()
            assert list(got[: len(want)]) == want and (got[len(want):] == -1).all()
            counts = np.bincount([ids[t, r] for r in rows], minlength=m)
            assert list(seg[t, part].numpy()) == [0] + list(np.cumsum(counts))
            k = len(want)
            assert list(node_sorted[t, lo:lo + k].numpy()) == [ids[t, r] for r in want]
            assert np.array_equal(w_sorted[t, :, lo:lo + k].numpy(), w[t][:, want])
            assert np.array_equal(shared[3][t, :, lo:lo + k].numpy(), w[0][:, want])
            assert (node_sorted[t, lo + k:hi] == -1).all() and not w_sorted[t, :, lo + k:hi].any()
