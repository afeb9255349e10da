"""Weighted bin histograms for forest split search.

Port of the tree-batched histogram of
``ate_replication_causalml_tpu/ops/hist_pallas.py``:

    hist[t, k, m, f, b] = Σ_row  w[t, k, row] · 1[ids[t, row] = m] · 1[codes[row, f] = b]

T trees share one ``codes`` stream; ids outside ``[0, max_nodes)``
contribute nothing. The weights are per tree, (T, K, n), or one (K, n)
stack shared by every tree (``*_shared``: the causal grower's moment
channels, with each tree's membership folded into its ids as −1). The
JAX package runs this as a Pallas TPU kernel behind ``custom_vmap``
rules that fold the growers' per-tree vmaps into the kernel's tree axis;
here the tree axis is explicit.

Three formulations with one contract, chosen per kernel width by the
JAX package's policy (:func:`resolve_hist_mode_packed`,
:func:`mode_for_width`): ``dense`` (``csrc/hist.cu``), ``partition``
(``csrc/hist_partition.cu``, rows grouped by node first) and
``partition+pack`` (the same file's packed pass: the codes are read as
int32 words of three 7-bit codes, ``ops/pack.py``). All add each cell's
rows in ascending row order within each row range and the ranges in a
fixed order, so float sums are reproducible and the three formulations
give the same bits.

Each public function has a plain PyTorch version (``*_plain``) in this
module. The wrapper runs it for CPU tensors only; for CUDA tensors it
launches the hand-written kernel or raises. Each wrapper counts its
dense-kernel launches in ``<wrapper>.launches`` and, for the histogram
wrappers, its partition-kernel launches in
``<wrapper>.partition_launches`` and its packed ones in
``<wrapper>.packed_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ate_replication_causalml_torch.kernels import build
from ate_replication_causalml_torch.ops.pack import (
    PACK_SLOTS,
    pack_codes,
    packable,
    packed_width,
    resolve_predict_pack,
    unpack_codes,
)

# Shared memory one block may use on Hopper (227 KB), and one SM's (228 KB,
# of which each resident block reserves 1 KB).
_MAX_SMEM_BYTES = 232_448
_SM_SMEM_BYTES = 233_472
_BLOCK_RESERVED_BYTES = 1024
_SMS = 132  # an H100 SXM's streaming multiprocessors
# The dense kernel's block (csrc/hist.cu): one warp per feature, at most
# 16; rows staged 128 at a time, 4 stages deep; tiles and stages within a
# budget that leaves two blocks on an SM; and at least 2.5 blocks per SM
# in the grid where fewer features per block allow it (a block of 7
# features left 12 of 132 SMs with two blocks at K=2 M=16, and ran slower
# than blocks of 3: scripts/torch_hist_geometry.py, PERF.md PR 4).
_DENSE_MAX_WARPS = 16
_DENSE_STAGE_ROWS = 128
_DENSE_STAGES = 4
_DENSE_SMEM_BUDGET = _SM_SMEM_BYTES // 2 - _BLOCK_RESERVED_BYTES
_DENSE_MIN_BLOCKS = 5 * _SMS // 2
# A feature with a block to itself splits its nodes over this many warps
# (one warp alone walks its range's rows with the SM mostly idle; same
# script).
_DENSE_WARPS_PER_LONE_FEATURE = 4
# The packed pass's block (csrc/hist_partition.cu): 16 warps, four blocks
# on an SM, so its three tiles stay within a quarter of the SM.
_PACKED_SMEM_BUDGET = _SM_SMEM_BYTES // 4 - _BLOCK_RESERVED_BYTES
# The unpacked partition pass's row ranges form one thread-block cluster
# of at most 8 (the portable cluster size); more ranges keep the partial
# slabs and the second pass.
_MAX_CLUSTER_RANGES = 8
# Weight channels one launch takes (kMaxWeights in csrc/hist_common.cuh).
_MAX_WEIGHTS = 8
# Row ranges split the rows only while (trees × features × ranges)
# stays under this many blocks (8 per SM of an H100's 132), so the
# scratch slabs stay a small multiple of the output.
_TARGET_BLOCKS = 1056
_MIN_ROWS_PER_BLOCK = 2048

# ---------------------------------------------------------------------------
# Kernel-mode policy, copied from the JAX package (hist_pallas.py:919-1095) so
# that one setting names the same formulation per kernel width in both
# packages. The crossover comes from the TPU kernels' MXU FLOP model; it is
# kept as it is, and PERF.md records both formulations' card times per
# width for a later re-derivation.
# ---------------------------------------------------------------------------

HIST_MODE_ENV = "ATE_TPU_HIST_MODE"
HIST_MODES = ("dense", "partition", "auto")
#: The packed-codes pass rides the mode string as a suffix
#: ("partition+pack"), as in the JAX package.
PACK_SUFFIX = "+pack"
_LANES = 128
_PART_BLOCK = 8


def with_pack_mode(mode: str, pack: bool) -> str:
    """Attach the pack suffix to a resolved policy mode (or strip it)."""
    base, _ = split_pack_mode(mode)
    return base + PACK_SUFFIX if pack else base


def split_pack_mode(mode: str) -> tuple[str, bool]:
    """→ (base mode, packed?)."""
    if mode.endswith(PACK_SUFFIX):
        return mode[: -len(PACK_SUFFIX)], True
    return mode, False


def resolve_hist_mode(mode: str | None = None) -> str:
    """The kernel-mode policy: ``mode`` when given, else
    ``ATE_TPU_HIST_MODE`` (case-insensitive, default "auto": dense below
    :func:`partition_crossover_width`, partition from it)."""
    raw = mode if mode is not None else os.environ.get(HIST_MODE_ENV, "auto")
    val = str(raw).strip().lower()
    if val not in HIST_MODES:
        raise ValueError(
            f"{HIST_MODE_ENV}/hist_mode must be one of {HIST_MODES} (case-insensitive), "
            f"got {raw!r}"
        )
    return val


def resolve_hist_mode_packed(mode: str | None = None, n_bins: int = 64) -> str:
    """:func:`resolve_hist_mode` plus the pack policy: the growers' one
    config-time call. An explicit ``+pack`` suffix on ``mode`` wins;
    otherwise ``ATE_TPU_PREDICT_PACK`` decides (``ops/pack.py``); either
    way packing engages only where a 7-bit slot is exact
    (``n_bins`` ≤ 128), and wider-bin forests keep the unpacked path."""
    explicit = False
    if isinstance(mode, str):
        mode, explicit = split_pack_mode(mode)
    base = resolve_hist_mode(mode)
    pack = (explicit or resolve_predict_pack(None)) and packable(n_bins)
    return with_pack_mode(base, pack)


def hist_level_flops(mode: str, n_rows: int, max_nodes: int, n_weights: int,
                     p: int = 21, n_bins: int = 64, tile: int = 2048) -> dict:
    """The JAX package's MXU-FLOP model of one tree's level histogram on
    the TPU (``hist_pallas.py:988``, unpacked modes): ``useful`` is the
    mode-independent work, ``total`` what the TPU kernel issues."""
    if mode not in ("dense", "partition"):
        raise ValueError(f"flop model mode must be dense|partition, got {mode!r}")
    f_pb = max(1, _LANES // n_bins)
    p_blocks = -(-p // f_pb)
    lanes = p_blocks * _LANES
    c_cols = p_blocks * f_pb
    n_tiles = max(1, -(-n_rows // tile))
    rows_pad = n_tiles * tile
    useful = 2.0 * n_rows * n_weights * p * n_bins
    if mode == "dense":
        total = 2.0 * rows_pad * n_weights * max_nodes * lanes
    else:
        tp = tile + (max_nodes + 1) * _PART_BLOCK
        per_tile = tp * tile * c_cols + n_weights * tile * tp + tp * n_weights * lanes
        total = 2.0 * n_tiles * per_tile
    return {"useful": useful, "total": total}


@functools.lru_cache(maxsize=None)
def partition_crossover_width(n_weights: int, p: int = 21, n_bins: int = 64,
                              tile: int = 2048) -> int:
    """Smallest kernel width (a power of two ≤ 128) at which the TPU
    model's partition FLOPs beat dense's; 256 when dense wins everywhere."""
    for width in (1, 2, 4, 8, 16, 32, 64, 128):
        dense = hist_level_flops("dense", tile, width, n_weights, p, n_bins, tile)
        part = hist_level_flops("partition", tile, width, n_weights, p, n_bins, tile)
        if part["total"] < dense["total"]:
            return width
    return 256


def mode_for_width(mode: str, width: int, n_weights: int, p: int = 21,
                   n_bins: int = 64) -> str:
    """A resolved policy ("dense" | "partition" | "auto", each with an
    optional ``+pack``) → the kernel formulation for one kernel width
    (the node count it allocates). The suffix passes through on
    partition widths and drops on dense ones: "auto+pack" is "dense"
    below the crossover and "partition+pack" from it."""
    mode, pack = split_pack_mode(mode)
    if mode == "auto":
        mode = "partition" if width >= partition_crossover_width(n_weights, p, n_bins) else "dense"
    elif mode not in ("dense", "partition"):
        raise ValueError(f"unknown histogram mode {mode!r}")
    return mode + PACK_SUFFIX if mode == "partition" and pack else mode


def _check_dispatch_mode(mode: str) -> tuple[str, bool]:
    """A kernel call takes a resolved formulation → (base, packed?):
    "auto" is resolved per width by the caller (:func:`mode_for_width`),
    and ``+pack`` applies to the partition kernel only, as in the JAX
    package's ``_check_mode``."""
    base, pack = split_pack_mode(mode)
    if base not in ("dense", "partition"):
        raise ValueError(
            f"histogram kernel mode must be 'dense' or 'partition' at dispatch (resolve "
            f"'auto' via mode_for_width), got {mode!r}"
        )
    if pack and base != "partition":
        raise ValueError(
            f"the {PACK_SUFFIX!r} suffix applies to the partition kernel only, got {mode!r} "
            "(mode_for_width strips it on dense)"
        )
    return base, pack


def _check_inputs(codes, ids, weights, shared: bool):
    if codes.dtype != torch.int32 or codes.ndim != 2:
        raise TypeError(f"codes must be (n, p) int32, got {codes.dtype} {tuple(codes.shape)}")
    if ids.dtype != torch.int32 or ids.ndim != 2 or ids.shape[1] != codes.shape[0]:
        raise TypeError(f"ids must be (T, n) int32, got {ids.dtype} {tuple(ids.shape)}")
    want = "(K, n)" if shared else "(T, K, n)"
    ok_shape = (weights.ndim == 2 if shared
                else weights.ndim == 3 and weights.shape[0] == ids.shape[0])
    if weights.dtype != torch.float32 or not ok_shape or weights.shape[-1] != codes.shape[0]:
        raise TypeError(f"weights must be {want} float32, got {weights.dtype} "
                        f"{tuple(weights.shape)}")
    if not (codes.device == ids.device == weights.device):
        raise ValueError("codes, ids and weights must lie on one device")


def _packed_words(codes, packed, n_bins: int):
    """The (n, ceil(p/3)) int32 words of the packed pass: ``packed`` as
    given (a grower packs once per fit), else packed here."""
    if not packable(n_bins):
        raise ValueError(f"the packed pass needs n_bins <= 128 (7-bit slots), got {n_bins}")
    if packed is None:
        return pack_codes(codes)
    n, p = codes.shape
    if (packed.dtype != torch.int32 or tuple(packed.shape) != (n, packed_width(p))
            or packed.device != codes.device):
        raise TypeError(f"packed must be ({n}, {packed_width(p)}) int32 on {codes.device}, got "
                        f"{packed.dtype} {tuple(packed.shape)} on {packed.device}")
    return packed


def bin_histogram_batched_plain(codes, ids, weights, max_nodes: int, n_bins: int):
    """The plain PyTorch version: one ``index_add_`` per (tree, channel).
    ``weights`` is (T, K, n), or (K, n) shared by every tree."""
    n, p = codes.shape
    n_trees = ids.shape[0]
    if weights.ndim == 2:
        weights = weights.expand(n_trees, *weights.shape)
    k_w = weights.shape[1]
    out = torch.zeros((n_trees, k_w, max_nodes, p, n_bins), dtype=torch.float32,
                      device=codes.device)
    codes64 = codes.long()
    code_ok = (codes64 >= 0) & (codes64 < n_bins)
    feat_bin = torch.arange(p, device=codes.device) * n_bins + codes64  # (n, p)
    flat = out.view(n_trees, k_w, -1)
    for t in range(n_trees):
        node = ids[t].long()
        ok = ((node >= 0) & (node < max_nodes))[:, None] & code_ok
        cell = (node[:, None] * (p * n_bins) + feat_bin)[ok]
        for k in range(k_w):
            flat[t, k].index_add_(0, cell, weights[t, k][:, None].expand(n, p)[ok])
    return out


def bin_histogram_packed_plain(codes, ids, weights, max_nodes: int, n_bins: int, packed=None):
    """The plain version of the packed mode: the words (``packed``, or
    :func:`~.pack.pack_codes` of ``codes``) unpacked with
    :func:`~.pack.unpack_codes`, then :func:`bin_histogram_batched_plain`."""
    words = _packed_words(codes, packed, n_bins)
    return bin_histogram_batched_plain(unpack_codes(words, codes.shape[1]), ids, weights,
                                       max_nodes, n_bins)


def _n_parts(n: int, n_trees: int, p: int) -> int:
    """Row ranges per (tree, feature); the same for every formulation, so
    they add the same partial sums in the same order."""
    return max(1, min(-(-n // _MIN_ROWS_PER_BLOCK), _TARGET_BLOCKS // (n_trees * p)))


# ---------------------------------------------------------------------------
# Launch geometry. A block's cells are (feature, node) pairs; each lies in
# exactly one block and one warp, so each cell keeps one writer and its
# rows' order. Tests check the cover and the shared-memory budgets.
# ---------------------------------------------------------------------------


def _dense_stage_bytes(n_weights: int, features: int) -> int:
    return 4 * _DENSE_STAGES * _DENSE_STAGE_ROWS * (1 + n_weights + features)


def dense_node_groups(n_weights: int, max_nodes: int, n_bins: int) -> int:
    """Blocks that split the dense kernel's nodes: 1 while one feature's
    (K, M, n_bins) tile and the row stages fit the block budget, else the
    fewest contiguous node groups whose tile does (K=5 M=128: 2)."""
    room = _DENSE_SMEM_BUDGET - _dense_stage_bytes(n_weights, 1)
    group = max(1, min(max_nodes, room // (4 * n_weights * n_bins)))
    return -(-max_nodes // group)


def dense_features_per_block(n_weights: int, max_nodes: int, p: int, n_bins: int,
                             n_trees: int, n_parts: int) -> int:
    """F, the features one dense block takes (one warp each): as many
    tiles as fit the block budget with the row stages (at most 16), fewer
    while the grid (trees × row ranges × node groups × feature groups)
    has under 2.5 blocks per SM, then evened out over the ceil(p / F)
    feature groups (K=2, p=21, 16 trees, 3 ranges: 3 at M=1–16, 1 at
    M=128)."""
    groups = dense_node_groups(n_weights, max_nodes, n_bins)
    tile = 4 * n_weights * -(-max_nodes // groups) * n_bins
    fits = [f for f in range(1, min(p, _DENSE_MAX_WARPS) + 1)
            if f * tile + _dense_stage_bytes(n_weights, f) <= _DENSE_SMEM_BUDGET]
    busy = [f for f in fits if n_trees * n_parts * groups * -(-p // f) >= _DENSE_MIN_BLOCKS]
    features = max(busy) if busy else min(fits, default=1)
    return -(-p // -(-p // features))


def dense_warps_per_feature(n_weights: int, max_nodes: int, p: int, n_bins: int,
                            n_trees: int, n_parts: int) -> int:
    """Warps that split one feature's node group into contiguous runs: 4
    where a block takes one feature (large tiles, node sums), never more
    than the group's nodes; 1 otherwise."""
    if dense_features_per_block(n_weights, max_nodes, p, n_bins, n_trees, n_parts) > 1:
        return 1
    group = -(-max_nodes // dense_node_groups(n_weights, max_nodes, n_bins))
    return min(_DENSE_WARPS_PER_LONE_FEATURE, group)


def dense_block_bytes(n_weights: int, max_nodes: int, p: int, n_bins: int, n_trees: int,
                      n_parts: int) -> int:
    """Dynamic shared memory of one dense block: F tiles and the stages."""
    features = dense_features_per_block(n_weights, max_nodes, p, n_bins, n_trees, n_parts)
    group = -(-max_nodes // dense_node_groups(n_weights, max_nodes, n_bins))
    return 4 * features * n_weights * group * n_bins + _dense_stage_bytes(n_weights, features)


def packed_slots(n_weights: int, max_nodes: int, n_bins: int) -> int:
    """Slots of a packed word one block of the packed pass takes: 3 (every
    K ≤ 8 at n_bins ≤ 128), fewer only where three one-node tiles exceed
    the block budget. ``max_nodes`` does not enter: node groups absorb it."""
    return max(1, min(PACK_SLOTS, _PACKED_SMEM_BUDGET // (4 * n_weights * n_bins)))


def packed_node_groups(n_weights: int, max_nodes: int, n_bins: int) -> int:
    """Blocks that split the packed pass's nodes: the fewest contiguous
    groups whose ``packed_slots`` tiles fit the block budget, and at least
    2, which doubles the blocks of the narrow widths (K=2: 2 to M=64, 4 at
    M=128; K=5: 2 at M=16, 5 at M=64; scripts/torch_hist_geometry.py)."""
    per_node = 4 * packed_slots(n_weights, max_nodes, n_bins) * n_weights * n_bins
    group = max(1, min(max_nodes, _PACKED_SMEM_BUDGET // per_node))
    return max(-(-max_nodes // group), min(max_nodes, 2))


def packed_block_bytes(n_weights: int, max_nodes: int, n_bins: int) -> int:
    """Dynamic shared memory of one block of the packed pass."""
    group = -(-max_nodes // packed_node_groups(n_weights, max_nodes, n_bins))
    return 4 * packed_slots(n_weights, max_nodes, n_bins) * n_weights * group * n_bins


def partition_cluster_ranges(n_parts: int) -> int:
    """Row ranges one thread-block cluster of the unpacked partition pass
    sums: all of them from 2 to 8 (the paths have 3), else 1: one range
    writes its tile directly, and more than 8 write one slab each for the
    second pass."""
    return n_parts if 1 < n_parts <= _MAX_CLUSTER_RANGES else 1


def partition_max_active_clusters(n: int, n_trees: int, n_weights: int, max_nodes: int, p: int,
                                  n_bins: int) -> int:
    """How many clusters (or blocks, without one) of the unpacked partition
    pass's launch at this shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``). Needs a card."""
    n_parts = _n_parts(n, n_trees, p)
    count = ctypes.c_int(0)
    k = build.kernel("hist_partition_clusters")
    build.check(k, k.fn(p, n_trees, n_weights, max_nodes, n_bins, n_parts,
                        int(partition_cluster_ranges(n_parts) > 1), ctypes.addressof(count)))
    return count.value


def partition_sort_plain(ids, max_nodes: int, n_parts: int, weights=None):
    """The plain version of the partition passes' first step: per (tree,
    row range), the rows whose id lies in [0, max_nodes), stably sorted by
    id → (perm, seg, node_sorted, w_sorted). perm (T, n) int32: each
    range's sorted rows from the range's first position, −1 after them;
    seg (T, n_parts, max_nodes + 1) int32: each node's first position
    within its range, the range's count last; with ``weights`` ((T, K, n),
    or (K, n) shared by every tree), node_sorted (T, n) int32 and w_sorted
    (T, K, n) float32: the node and weights of the row at each position
    (−1 and 0.0 where perm is −1), else None and None."""
    n_trees, n = ids.shape
    span = -(-n // n_parts)
    perm = torch.full((n_trees, n), -1, dtype=torch.int32, device=ids.device)
    seg = torch.zeros((n_trees, n_parts, max_nodes + 1), dtype=torch.int32, device=ids.device)
    for part in range(n_parts):
        lo, hi = part * span, min(n, (part + 1) * span)
        if lo >= hi:
            continue
        node = ids[:, lo:hi].long()
        key = torch.where((node >= 0) & (node < max_nodes), node, max_nodes)
        order = torch.sort(key, dim=1, stable=True).indices
        counts = torch.zeros((n_trees, max_nodes + 1), dtype=torch.int64, device=ids.device)
        counts.scatter_add_(1, key, torch.ones_like(key))
        seg[:, part, 1:] = torch.cumsum(counts[:, :max_nodes], dim=1).to(torch.int32)
        valid = torch.arange(hi - lo, device=ids.device)[None] < seg[:, part, -1:]
        perm[:, lo:hi] = torch.where(valid, (order + lo).to(torch.int32), -1)
    if weights is None:
        return perm, seg, None, None
    written = perm >= 0
    rows = perm.long().clamp(min=0)
    node_sorted = torch.where(written, torch.gather(ids, 1, rows), -1)
    w = weights if weights.ndim == 3 else weights.expand(n_trees, *weights.shape)
    w_sorted = torch.gather(w, 2, rows[:, None, :].expand(-1, w.shape[1], -1))
    return perm, seg, node_sorted, torch.where(written[:, None, :], w_sorted, 0.0)


def partition_sort(ids, max_nodes: int, n_parts: int, weights=None):
    """The partition passes' first step on the card (``csrc/hist_partition.cu``
    ``partition_rows``): :func:`partition_sort_plain`'s output, except that
    positions after a range's sorted rows are not written; the plain
    version for CPU tensors. The histogram wrappers run it within each
    partition launch (with ``weights`` for the unpacked pass) and count it
    there."""
    if ids.device.type == "cpu":
        return partition_sort_plain(ids, max_nodes, n_parts, weights)
    if ids.dtype != torch.int32 or ids.ndim != 2 or not ids.is_contiguous():
        raise TypeError(f"ids must be contiguous (T, n) int32, got {ids.dtype} {tuple(ids.shape)}")
    n_trees, n = ids.shape
    perm = torch.empty((n_trees, n), dtype=torch.int32, device=ids.device)
    seg = torch.empty((n_trees, n_parts, max_nodes + 1), dtype=torch.int32, device=ids.device)
    node_sorted = w_sorted = None
    w_ptr = w_stride = k_w = node_ptr = ws_ptr = 0  # no weights: perm and seg alone
    if weights is not None:
        if weights.device != ids.device or not weights.is_contiguous():
            raise ValueError("weights must be contiguous, on the device of ids")
        k_w = weights.shape[-2]
        w_ptr, w_stride = weights.data_ptr(), 0 if weights.ndim == 2 else k_w * n
        node_sorted = torch.empty((n_trees, n), dtype=torch.int32, device=ids.device)
        w_sorted = torch.empty((n_trees, k_w, n), dtype=torch.float32, device=ids.device)
        node_ptr, ws_ptr = node_sorted.data_ptr(), w_sorted.data_ptr()
    k = build.kernel("partition_sort")
    build.check(k, k.fn(ids.data_ptr(), n, n_trees, max_nodes, n_parts, w_ptr, w_stride, k_w,
                        perm.data_ptr(), seg.data_ptr(), node_ptr, ws_ptr,
                        torch.cuda.current_stream(ids.device).cuda_stream))
    return perm, seg, node_sorted, w_sorted


def _launch(codes, ids, weights, max_nodes: int, n_bins: int, mode: str, counter,
            packed=None) -> torch.Tensor:
    """Launch ``csrc/hist.cu`` (dense) or ``csrc/hist_partition.cu``
    (partition, and its packed pass for "partition+pack") on the current
    stream; add one to ``counter.launches``, ``counter.partition_launches``
    or ``counter.packed_launches``. ``weights`` (K, n) is shared by every
    tree (a tree stride of 0)."""
    if codes.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {codes.device}")
    base, pack = _check_dispatch_mode(mode)
    n, p = codes.shape
    n_trees = ids.shape[0]
    k_w = weights.shape[-2]
    w_tree_stride = 0 if weights.ndim == 2 else k_w * n
    out = torch.empty((n_trees, k_w, max_nodes, p, n_bins), dtype=torch.float32,
                      device=codes.device)
    if n_trees == 0 or n == 0 or p == 0:
        return out.zero_()
    if k_w > _MAX_WEIGHTS:
        raise ValueError(f"the histogram kernels take at most {_MAX_WEIGHTS} weight channels, "
                         f"got {k_w}")
    smem = 4 * k_w * max_nodes * n_bins
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"histogram tile K·M·n_bins = {k_w}·{max_nodes}·{n_bins} floats needs "
            f"{smem} B of shared memory, more than a block has ({_MAX_SMEM_BYTES} B)"
        )
    words = _packed_words(codes, packed, n_bins) if pack else None
    for name, t in (("codes", codes), ("ids", ids), ("weights", weights), ("packed", words)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_parts = _n_parts(n, n_trees, p)
    cluster = partition_cluster_ranges(n_parts)
    # One partial slab per row range, added by a second pass: the dense
    # kernel's, and the unpacked partition pass's past 8 ranges. A cluster
    # of the unpacked pass, or a block of the packed pass, adds its ranges
    # itself.
    slabs = n_parts > 1 and (base == "dense" or (not pack and cluster == 1))
    partial = (torch.empty((n_parts,) + tuple(out.shape), dtype=torch.float32,
                           device=codes.device) if slabs else out)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    tail = (ids.data_ptr(), weights.data_ptr(), w_tree_stride, n_trees, k_w, max_nodes, n_bins,
            n_parts)
    if base == "dense":
        shape = (k_w, max_nodes, p, n_bins, n_trees, n_parts)
        geometry = (dense_features_per_block(*shape), dense_node_groups(k_w, max_nodes, n_bins),
                    dense_warps_per_feature(*shape))
        k = build.kernel("hist")
        build.check(k, k.fn(codes.data_ptr(), n, p, *tail, *geometry, partial.data_ptr(),
                            out.data_ptr(), stream))
        counter.launches += 1
        return out
    if pack:
        perm, seg, _, _ = partition_sort(ids, max_nodes, n_parts)
        geometry = (packed_slots(k_w, max_nodes, n_bins),
                    packed_node_groups(k_w, max_nodes, n_bins))
        k = build.kernel("hist_partition_packed")
        build.check(k, k.fn(words.data_ptr(), n, p, *tail, *geometry, perm.data_ptr(),
                            seg.data_ptr(), out.data_ptr(), stream))
        counter.packed_launches += 1
        return out
    perm, seg, node_sorted, w_sorted = partition_sort(ids, max_nodes, n_parts, weights)
    k = build.kernel("hist_partition")
    build.check(k, k.fn(codes.data_ptr(), n, p, n_trees, k_w, max_nodes, n_bins, n_parts,
                        int(cluster > 1), perm.data_ptr(), seg.data_ptr(), node_sorted.data_ptr(),
                        w_sorted.data_ptr(), partial.data_ptr(), out.data_ptr(), stream))
    counter.partition_launches += 1
    return out


def _histogram(codes, ids, weights, max_nodes, n_bins, mode, packed, shared, counter):
    _, pack = _check_dispatch_mode(mode)
    _check_inputs(codes, ids, weights, shared=shared)
    if codes.device.type == "cpu":
        if pack:
            return bin_histogram_packed_plain(codes, ids, weights, max_nodes, n_bins, packed)
        return bin_histogram_batched_plain(codes, ids, weights, max_nodes, n_bins)
    return _launch(codes, ids, weights, max_nodes, n_bins, mode, counter, packed)


def bin_histogram_batched(codes, ids, weights, *, max_nodes: int, n_bins: int,
                          mode: str = "dense", packed=None) -> torch.Tensor:
    """Tree-batched histograms: codes (n, p) int32, ids (T, n) int32,
    weights (T, K, n) float32 → (T, K, max_nodes, p, n_bins) float32.
    ``mode`` is the resolved formulation, "dense", "partition" or
    "partition+pack"; the last reads ``packed``, the (n, ceil(p/3))
    int32 words of ``codes`` (:func:`~.pack.pack_codes`; packed here
    when None). Other modes ignore ``packed``."""
    return _histogram(codes, ids, weights, max_nodes, n_bins, mode, packed, False,
                      bin_histogram_batched)


bin_histogram_batched.launches = 0
bin_histogram_batched.partition_launches = 0
bin_histogram_batched.packed_launches = 0


def bin_histogram_shared(codes, ids, weights, *, max_nodes: int, n_bins: int,
                         mode: str = "dense", packed=None) -> torch.Tensor:
    """:func:`bin_histogram_batched` with one (K, n) weight stack shared
    by every tree (the JAX package's ``bin_histogram_shared``); each
    tree's row membership rides in its ids (−1 drops a row)."""
    return _histogram(codes, ids, weights, max_nodes, n_bins, mode, packed, True,
                      bin_histogram_shared)


bin_histogram_shared.launches = 0
bin_histogram_shared.partition_launches = 0
bin_histogram_shared.packed_launches = 0


def bin_histogram(codes, ids, weights, *, max_nodes: int, n_bins: int,
                  mode: str = "dense") -> torch.Tensor:
    """Single-tree case: ids (n,), weights (K, n) → (K, max_nodes, p, n_bins)."""
    return bin_histogram_batched(
        codes, ids[None], weights[None], max_nodes=max_nodes, n_bins=n_bins, mode=mode,
    )[0]


def node_sums_plain(ids, weights, num_nodes: int) -> torch.Tensor:
    """The plain version of :func:`node_sums` and :func:`node_sums_shared`."""
    codes0 = torch.zeros((ids.shape[1], 1), dtype=torch.int32, device=ids.device)
    h = bin_histogram_batched_plain(codes0, ids, weights, num_nodes, 1)
    return h[:, :, :, 0, 0].transpose(1, 2)


def _node_sums(ids, weights, num_nodes: int, shared: bool, counter) -> torch.Tensor:
    codes0 = torch.zeros((ids.shape[1], 1), dtype=torch.int32, device=ids.device)
    _check_inputs(codes0, ids, weights, shared=shared)
    if ids.device.type == "cpu":
        return node_sums_plain(ids, weights, num_nodes)
    h = _launch(codes0, ids, weights, num_nodes, 1, "dense", counter)
    return h[:, :, :, 0, 0].transpose(1, 2)


def node_sums(ids, weights, num_nodes: int) -> torch.Tensor:
    """Per-node weighted sums: ids (T, n) int32, weights (T, K, n) float32
    → (T, num_nodes, K). The degenerate histogram with one constant
    feature and one bin, through the dense kernel."""
    return _node_sums(ids, weights, num_nodes, False, node_sums)


node_sums.launches = 0


def node_sums_shared(ids, weights, num_nodes: int) -> torch.Tensor:
    """:func:`node_sums` with one (K, n) weight stack shared by every tree:
    the causal forest's honest leaf payloads, the estimate-half
    membership folded into the ids."""
    return _node_sums(ids, weights, num_nodes, True, node_sums_shared)


node_sums_shared.launches = 0
