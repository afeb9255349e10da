"""Random-forest classifier/regressor engine — the streaming grower.

Port of the streaming (kernel) grower of
``ate_replication_causalml_tpu/models/forest.py``, the engine behind the
AIPW row's random-forest propensity (``ate_functions.R:169-174``):
bootstrap-per-tree (Poisson(1) counts), per-node feature subsampling
(mtry = floor(sqrt(p))), the Gini/SSE split score on quantile-binned
features, level-wise growth to a fixed depth, OOB vote probabilities.

Trees grow in chunks along an explicit leading tree axis: each level of
a chunk is one histogram launch (``ops/hist.py``), one split selection
in PyTorch, and one ``route_advance`` launch (``ops/tree.py``: the route
bits and the id updates of the level); each chunk ends with one leaf-sum
launch and one ``leaf_record`` launch (the leaf values and the training
rows' values). Prediction routes every (tree, row) to its leaf value in
one ``traverse`` launch. The random streams are
the JAX package's threefry streams bit for bit (``ops/random.py``), and
with integer weights every histogram sum is exact, so a classifier
forest grown here equals the JAX package's (split tables, leaf values,
counts, training leaves, OOB votes) element for element.

With a mesh (:func:`fit_forest_sharded`, the JAX package's tree-sharded
fit) each rank of the mesh's tree axis grows its share of the trees and
the trees are all-gathered in the JAX sharded plan's order, so the
sharded forest equals the JAX package's sharded forest.

The JAX package's non-streaming backends (``hist_backend="xla"`` and
``"onehot"``, its CPU default) are taken and grow with the kernels too:
they share the streaming grower's random streams and split scores, so
integer weights give the same forest bit for bit, and float weights
differ only where float32 rounding decides a tie. Its explicit Pallas
names are taken as well: "pallas" is the port's kernels (the "auto"
forest), "pallas_bf16" runs the split search's histograms in their bf16
form (weights rounded to bfloat16, float32 sums; the leaf sums stay
float32, as in the JAX package), which leaves a classifier's integer
weights exact and changes a regressor's forest, and "pallas_interpret",
the JAX package's CPU test mode, names the plain versions and is taken
for CPU tensors only.

Per-tree layout, as in the JAX package: ``split_feat``/``split_bin``
index internal nodes per level as [0, 2^level) offsets (children of
node k are 2k/2k+1); a row goes RIGHT when ``code > split_bin``; a
frozen node stores (0, n_bins−1), which sends every row left.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.bootstrap import _poisson1_counts
from ate_replication_causalml_torch.ops.hist import (
    bin_histogram_batched,
    mode_for_width,
    node_sums,
    resolve_hist_mode_packed,
    split_pack_mode,
)
from ate_replication_causalml_torch.ops.pack import pack_codes
from ate_replication_causalml_torch.ops.tree import leaf_record, route_advance, traverse
from ate_replication_causalml_torch.models.plan import sharded_fit_plan
from ate_replication_causalml_torch.parallel.mesh import TREE_AXIS, all_gather_cat, check_mesh
from ate_replication_causalml_torch.parallel.retry import require_all, run_shards

# Trees grown together: one kernel launch per level covers the chunk.
DEFAULT_TREE_CHUNK = 16
# The port's default histogram backend: its kernels on the card, their
# plain versions on the CPU. (The JAX package's "auto" picks Pallas on a
# TPU and "onehot" elsewhere; the port keeps "auto" for its kernels so
# that no CPU result of the port moves.)
HIST_BACKEND = "auto"
# The JAX package's non-streaming backends: the same forests from the
# kernels (the causal grower keeps their direct per-level ρ channel).
NON_STREAMING_BACKENDS = ("xla", "onehot")
# The JAX package's Pallas names: the port's kernels; their bf16 form for
# the split search; the plain versions (CPU tensors only).
PALLAS_BACKENDS = ("pallas", "pallas_bf16", "pallas_interpret")
HIST_BACKENDS = (HIST_BACKEND,) + NON_STREAMING_BACKENDS + PALLAS_BACKENDS
# Rows per step of the compare-count binarization (bounds its (rows, p,
# n_bins) boolean temporary).
_BINARIZE_ROWS = 65_536


@dataclasses.dataclass(frozen=True)
class Forest:
    """A fitted level-wise forest (the JAX package's ``Forest``, on tensors).

    ``leaf_value`` is the bootstrap-weighted P(y=1) (or mean) in each
    depth-D leaf; empty leaves fall back to the tree's overall rate.
    ``train_leaf`` holds every training row's leaf value, recorded
    during growth, so OOB predictions need no re-routing; ``train_fp``
    fingerprints the training codes so ``predict_forest(oob=True)`` can
    reject a matrix that is not the training matrix.
    """

    split_feat: torch.Tensor   # (T, D, 2^(D-1)) int32
    split_bin: torch.Tensor    # (T, D, 2^(D-1)) int32
    leaf_value: torch.Tensor   # (T, 2^D) float32
    counts: torch.Tensor       # (T, n) uint8 bootstrap counts (clamped at 255)
    bin_edges: torch.Tensor | None = None   # (p, n_bins-1)
    train_leaf: torch.Tensor | None = None  # (T, n) float32
    train_fp: torch.Tensor | None = None    # () int32

    @property
    def n_trees(self) -> int:
        return self.split_feat.shape[0]

    @property
    def depth(self) -> int:
        return self.split_feat.shape[1]


_FOREST_DTYPES = {
    "split_feat": torch.int32, "split_bin": torch.int32, "leaf_value": torch.float32,
    "counts": torch.uint8, "bin_edges": torch.float32, "train_leaf": torch.float32,
    "train_fp": torch.int32,
}


def forest_from_jax(arrays: dict[str, np.ndarray], device=None) -> Forest:
    """The port's :class:`Forest` from a JAX ``Forest``'s fields as numpy
    arrays (missing or None fields stay None)."""
    dev = resolve_device(device)
    fields = {}
    for name, dtype in _FOREST_DTYPES.items():
        a = arrays.get(name)
        fields[name] = None if a is None else torch.from_numpy(np.array(a)).to(dev, dtype)
    return Forest(**fields)


def codes_fingerprint(codes: torch.Tensor) -> torch.Tensor:
    """Order-sensitive int32 fingerprint Σ codes[i,j]·(31·i + j + 1) with
    int32 wraparound (the JAX package's). Summed in int64 and wrapped
    explicitly: torch's int32 ``sum`` promotes to int64, and the sum
    mod 2^32 is the same whichever width the products were taken in."""
    n, p = codes.shape
    mix = (31 * torch.arange(n, device=codes.device)[:, None]
           + torch.arange(p, device=codes.device)[None, :] + 1)
    s = torch.sum(codes.long() * mix)
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)


def _fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add does.

    In float64 the product of two float32 values is exact; TwoSum gives
    the sum's rounding error, which decides the one case where rounding
    the float64 sum to float32 differs from rounding the exact value: a
    float64 sum that falls exactly halfway between two float32 values."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    prod = a * b
    s = prod + c
    bv = s - prod
    err = (prod - (s - bv)) + (c - bv)  # s + err == prod + c exactly
    r = s.astype(np.float32)
    other = np.where(s > r, np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    tie = (s == (r.astype(np.float64) + other.astype(np.float64)) / 2) & (err != 0)
    return np.where(tie, np.where(err > 0, np.maximum(r, other), np.minimum(r, other)), r)


def quantile_bins(x: torch.Tensor, n_bins: int = 64) -> torch.Tensor:
    """Per-feature quantile bin edges, (p, n_bins-1): ``jnp.quantile``'s
    sort path with its interpolation arithmetic (weights in x's dtype,
    ``low·(1−hw) + high·hw``, NaN poisons the column).

    The JAX package's reference (XLA on the CPU) evaluates the float32
    interpolation as one fused multiply-add, ``fma(low, 1−hw, high·hw)``;
    that is reproduced exactly here. The quantile levels, weights and
    the interpolation are computed on the host and the (p, n_bins−1)
    edges moved to ``x``'s device: a device ``linspace`` may differ from
    the host's by an ulp, and one moved edge changes the bin codes.
    Only the sort runs on the device."""
    n = x.shape[0]
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=x.dtype)[1:-1]
    qn = qs * torch.tensor(n - 1, dtype=x.dtype)
    low, high = torch.floor(qn), torch.ceil(qn)
    hw = qn - low
    lw = 1.0 - hw
    xs = torch.sort(x, dim=0).values
    lv = xs[low.clamp(0, n - 1).long().to(x.device)].cpu()
    hv = xs[high.clamp(0, n - 1).long().to(x.device)].cpu()
    if x.dtype == torch.float32:
        high_part = (hv * hw[:, None]).numpy()
        res = torch.from_numpy(_fma_f32(lv.numpy(), lw[:, None].numpy(), high_part))
    else:
        res = lv * lw[:, None] + hv * hw[:, None]
    res = res.to(x.device)
    res = torch.where(torch.isnan(x).any(dim=0)[None, :], float("nan"), res)
    return res.T.contiguous()


def binarize(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Map features to int32 bin codes in [0, n_bins): code = #{edges < x}
    (``searchsorted(side="left")`` for non-NaN input)."""
    n_bins = edges.shape[1] + 1
    if n_bins > 256:
        raise ValueError(f"n_bins={n_bins} > 256 is not supported")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], _BINARIZE_ROWS):
        blk = x[s : s + _BINARIZE_ROWS]
        out[s : s + _BINARIZE_ROWS] = torch.sum(
            blk[:, :, None] > edges[None, :, :], dim=2, dtype=torch.int32
        )
    return out


def exact_subsample_mask(k: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """Uniform s-of-n subsample as a boolean mask, (..., n) for keys (..., 2).

    One u32 draw per row; the rows below the s-th smallest draw are
    taken, and ties at that value in index order, so the mask holds
    exactly s rows. The s-th order statistic comes from a 32-round
    binary search on the value domain (one count per round), as in the
    JAX package, so the mask is the JAX package's bit for bit."""
    if not 1 <= s <= n:
        raise ValueError(f"need 1 <= s <= n, got s={s}, n={n}")
    draws = rnd.bits(k, (n,))  # (..., n) int64 in [0, 2^32)
    lo = torch.zeros(draws.shape[:-1] + (1,), dtype=torch.int64, device=draws.device)
    hi = lo + 0xFFFFFFFF
    for _ in range(32):  # count(≤ lo) < s ≤ count(≤ hi)
        mid = lo + (hi - lo) // 2
        take_hi = torch.sum(draws <= mid, dim=-1, keepdim=True) >= s
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    zero_enough = torch.sum(draws == 0, dim=-1, keepdim=True) >= s
    kth = torch.where(zero_enough, 0, hi)
    below = draws < kth
    short = s - torch.sum(below, dim=-1, keepdim=True)
    ties = draws == kth
    return below | (ties & (torch.cumsum(ties.to(torch.int32), dim=-1) <= short))


@functools.lru_cache(maxsize=None)
def bitrev_perm(level: int) -> tuple[int, ...]:
    """Bit-reversal permutation of ``2^level`` node ids (an involution).

    The streaming grower indexes per-level histograms by bit-reversed
    node ids: a node's rev id has its child-side bit as the MSB, so the
    left children of every level occupy rev ids [0, m/2) and the
    full-level histogram is one concatenation ``[left, parent − left]``."""
    m = 1 << level
    out = [0] * m
    for r in range(m):
        v = 0
        for i in range(level):
            v |= ((r >> i) & 1) << (level - 1 - i)
        out[r] = v
    return tuple(out)


def streaming_level_loop(codes, n_trees, depth, n_bins, hist_fn, tables_fn, grow_mask=None,
                         est_mask=None, sibling=True):
    """The bit-reversed level loop of the streaming grower, over a
    leading tree axis.

    Per level: the full-level histogram assembles as
    ``cat([left, parent − left])`` in rev node order (sibling
    subtraction: only left children are histogrammed), splits are
    chosen by ``tables_fn`` (rev order), and one ``route_advance`` launch
    routes the rows, advances both id streams in place (interleaved
    ``node_int``, the stored 2k/2k+1 layout; ``node_rev``, where the new
    side bit becomes the MSB) and writes the ids the next step reads.

    Args:
      codes: (n, p) int32 bin codes.
      hist_fn: (ids (T, n), m) → (T, K, m, p, n_bins) histograms of the
        rows at the given rev node ids (−1 contributes nothing).
      tables_fn: (hist_full, level, perm) → (bf_rev, bb_rev), (T, m) each.
      grow_mask: optional (T, n) bool; rows outside it are −1 in every
        histogram's ids (every row is routed).
      est_mask: optional (T, n) bool; rows outside it are −1 in the leaf
        ids returned.
      sibling: False histograms every node of each level (``hist_fn``
        gets the grow rows' rev ids and m) instead of the left children,
        for channels that change from level to level.

    Returns (feats (T, depth, 2^(depth−1)), bins (same), leaf ids (T, n)).
    """
    n = codes.shape[0]
    dev = codes.device
    max_nodes = 1 << (depth - 1)
    node_int = torch.zeros((n_trees, n), dtype=torch.int32, device=dev)
    node_rev = torch.zeros((n_trees, n), dtype=torch.int32, device=dev)
    # Level 0: every row at the root, rev id 0.
    ids = node_rev if grow_mask is None else torch.where(grow_mask, node_rev, -1)
    prev = None
    feats_l, bins_l = [], []
    for level in range(depth):
        m = 1 << level
        if not sibling:
            hist = hist_fn(node_rev if grow_mask is None else torch.where(grow_mask, node_rev, -1),
                           m)
        elif prev is None:
            hist = hist_fn(ids, 1)
        else:
            # The ids are the left children's: their rev id == their parent's.
            hist_left = hist_fn(ids, m // 2)
            hist = torch.cat([hist_left, prev - hist_left], dim=2)
        prev = hist
        perm = bitrev_perm(level)
        bf_rev, bb_rev = tables_fn(hist, level, perm)
        last = level == depth - 1
        ids = route_advance(codes, node_int, node_rev, bf_rev.contiguous(), bb_rev.contiguous(),
                            mask=est_mask if last else grow_mask, last=last)
        # graftlint: disable=TGL003 — the level's bit-reversal order, a host list of m ints: one small host-to-device copy a level
        perm_t = torch.as_tensor(perm, device=dev)
        pad = max_nodes - m
        feats_l.append(torch.nn.functional.pad(bf_rev[:, perm_t], (0, pad)))
        bins_l.append(torch.nn.functional.pad(bb_rev[:, perm_t], (0, pad), value=n_bins - 1))
    return torch.stack(feats_l, dim=1), torch.stack(bins_l, dim=1), ids


def select_split(score, lk, level_nodes, p, n_bins, mtry, perm=None):
    """Each node's best (feature, bin) from the masked (T, m, p, n_bins)
    score with randomForest's per-node mtry feature subsampling; ``lk``
    holds one key per tree. Nodes with no finite score fall back to
    (feature 0, bin n_bins−1): every row routes left. ``perm`` re-maps
    the per-node draws when the score rows are in rev node order."""
    n_trees = score.shape[0]
    feat_scores = rnd.uniform(lk, (level_nodes, p))  # (T, m, p)
    if perm is not None:
        # graftlint: disable=TGL003 — the level's bit-reversal order, a host list of m ints: one small host-to-device copy a level
        feat_scores = feat_scores[:, torch.as_tensor(perm, device=score.device)]
    kth = torch.sort(feat_scores, dim=2).values[:, :, mtry - 1 : mtry]
    score = torch.where((feat_scores <= kth)[..., None], score, math.inf)
    flat = score.reshape(n_trees, level_nodes, p * n_bins)
    best = torch.argmin(flat, dim=2)
    has_split = torch.isfinite(torch.amin(flat, dim=2))
    best_feat = torch.where(has_split, best // n_bins, 0).to(torch.int32)
    best_bin = torch.where(has_split, best % n_bins, n_bins - 1).to(torch.int32)
    return best_feat, best_bin


def _split_tables(hist, lk, level_nodes, p, n_bins, mtry, perm):
    """Score a full-level (T, 2, m, p, bins) histogram and pick per-node
    splits. Minimizing −(S_L²/c_L + S_R²/c_R) is the SSE criterion, and
    the weighted-Gini one when y is 0/1."""
    cl = torch.cumsum(hist[:, 0], dim=3)
    yl = torch.cumsum(hist[:, 1], dim=3)
    cr, yr = cl[..., -1:] - cl, yl[..., -1:] - yl
    eps = 1e-12
    score = -(yl * yl / torch.clamp(cl, min=eps) + yr * yr / torch.clamp(cr, min=eps))
    score = torch.where((cl > 0) & (cr > 0), score, math.inf)
    return select_split(score, lk, level_nodes, p, n_bins, mtry, perm=perm)


def packed_codes_for(codes: torch.Tensor, hist_mode: str) -> torch.Tensor | None:
    """The packed words a grower builds once per fit (``ops/pack.py``)
    when its resolved policy carries ``+pack`` on a base that can reach
    the partition kernel; None otherwise."""
    base, pack = split_pack_mode(hist_mode)
    return pack_codes(codes) if pack and base != "dense" else None


def _grow_chunk(tree_keys, codes, yf, center, *, depth, mtry, n_bins, hist_mode, words=None,
                bf16=False):
    """Grow one chunk of trees (one key per tree, (T, 2)).

    ``center`` is 0.0 for binary targets (the histogram weights stay
    integer) and 1.0 for continuous ones: each tree's bootstrap-weighted
    mean is subtracted before accumulation and re-added at the leaves,
    so the sibling subtraction never cancels a large outcome level.
    ``hist_mode`` is the resolved policy; each level's kernel width
    picks its formulation (:func:`mode_for_width`, K = 2). ``words`` are
    the packed codes that the "partition+pack" levels read. ``bf16``: the
    levels' histograms in their bf16 form; the leaf sums stay float32."""
    n_trees = tree_keys.shape[0]
    n, p = codes.shape
    n_leaves = 1 << depth
    ck, gk = rnd.split(tree_keys).unbind(dim=1)
    counts = _poisson1_counts(ck, (n,))  # (T, n) float32
    mu = torch.sum(counts * yf, dim=1) / torch.clamp(torch.sum(counts, dim=1), min=1e-12)
    yt = yf[None, :] - center * mu[:, None]
    base = center * mu
    weights2 = torch.stack([counts, counts * yt], dim=1).contiguous()  # (T, 2, n)
    level_keys = rnd.split(gk, depth)  # (T, depth, 2)

    feats, bins, node_of_row = streaming_level_loop(
        codes, n_trees, depth, n_bins,
        hist_fn=lambda ids, m: bin_histogram_batched(
            codes, ids, weights2, max_nodes=m, n_bins=n_bins,
            mode=mode_for_width(hist_mode, m, 2, p, n_bins), packed=words, bf16=bf16),
        tables_fn=lambda hist, level, perm: _split_tables(
            hist, level_keys[:, level], 1 << level, p, n_bins, mtry, perm),
    )
    ls = node_sums(node_of_row, weights2, n_leaves)  # (T, L, 2)
    leaf_value, train_vals = leaf_record(ls, base, mu, node_of_row)
    # Counts persist only for the OOB mask (count == 0); the clamp can
    # never flip an in-bag row to OOB the way a wrapping cast could.
    return feats, bins, leaf_value, torch.clamp(counts, max=255).to(torch.uint8), train_vals


def check_hist_backend(hist_backend: str, sharded: bool = False, device=None) -> None:
    """The JAX package's ``hist_backend`` argument: "auto" (the port's
    kernels on the card, their plain versions on the CPU), "xla" and
    "onehot" (:data:`NON_STREAMING_BACKENDS`, grown on the same kernels),
    and the Pallas names (:data:`PALLAS_BACKENDS`): "pallas" (the kernels,
    as "auto"), "pallas_bf16" (their bf16 form in the split search) and
    "pallas_interpret" (the plain versions), which a CUDA ``device``
    refuses: the card runs the kernels, never their plain versions in
    their place. A sharded fit refuses "onehot" as the JAX package does."""
    if hist_backend not in HIST_BACKENDS:
        raise ValueError(f"hist_backend={hist_backend!r} is not ported: the port takes "
                         f"{HIST_BACKENDS} ({HIST_BACKEND!r}: its CUDA kernels)")
    check_interpret(hist_backend, device, "hist_backend")
    if sharded and hist_backend == "onehot":
        raise ValueError(
            "hist_backend='onehot' is not supported on the sharded path "
            "(the shared bin one-hot is not built here); use 'auto'/'xla'/'pallas'"
        )


def check_interpret(backend, device, arg: str) -> None:
    """Refuse "pallas_interpret" (the JAX package's CPU test mode, the
    plain versions here) for data on a CUDA device."""
    if backend == "pallas_interpret" and device is not None and torch.device(device).type == "cuda":
        raise ValueError(f"{arg}='pallas_interpret' names the plain CPU versions and takes CPU "
                         "tensors only; on the card use 'pallas' or 'auto' (the CUDA kernels)")


def _is_binary01(y: torch.Tensor) -> bool:
    """Whether the target is exactly {0, 1}-valued (decides centering)."""
    return bool(torch.all((y == 0) | (y == 1)))


def fit_forest_classifier(
    x: torch.Tensor,
    y: torch.Tensor,
    key: torch.Tensor,
    n_trees: int = 500,
    depth: int = 9,
    mtry: int | None = None,
    n_bins: int = 64,
    tree_chunk: int | None = DEFAULT_TREE_CHUNK,
    hist_backend: str = HIST_BACKEND,
    hist_mode: str | None = None,
) -> Forest:
    """Fit a classification forest of ``n_trees`` depth-``depth`` trees.

    mtry defaults to floor(sqrt(p)) (randomForest's classification
    default). Tree ``i`` grows from ``split(key, n_trees)[i]``, so the
    chunking does not change a single number (None: the default 16; the
    JAX package sizes it to the TPU's memory). ``hist_backend``: "auto"
    (the default) grows with the port's kernels on the card and their
    plain versions on the CPU; it is not the JAX package's CPU "auto",
    which resolves to "onehot". "xla" and "onehot", the JAX package's
    non-streaming backends, grow on the same kernels: integer weights give
    the JAX package's same forest under every backend, float weights
    differ from its "xla"/"onehot" only where float32 rounding decides a
    tie. "pallas" is "auto"; "pallas_bf16" runs the levels' histograms in
    their bf16 form (the same forest for a 0/1 target, another for a
    continuous one); "pallas_interpret" takes CPU tensors only
    (:func:`check_hist_backend`). ``hist_mode`` is
    the histogram policy, "dense" | "partition" | "auto" with an optional
    "+pack", resolved as the JAX package does
    (:func:`~..ops.hist.resolve_hist_mode_packed`: ``ATE_TPU_HIST_MODE``
    when None, default "auto": dense below the crossover width,
    partition from it; ``ATE_TPU_PREDICT_PACK=1`` or "+pack" sends the
    partition widths to the packed pass, whose words are packed once
    here). Every formulation gives the same sums, so the mode does not
    change the forest.
    """
    check_hist_backend(hist_backend, device=x.device)
    n, p = x.shape
    if mtry is None:
        mtry = max(1, int(np.sqrt(p)))
    hist_mode = resolve_hist_mode_packed(hist_mode, n_bins)
    edges = quantile_bins(x, n_bins)
    codes = binarize(x, edges)
    fields = _grow_from_keys(rnd.split(key.to(x.device), n_trees), codes, y, depth=depth,
                             mtry=mtry, n_bins=n_bins, hist_mode=hist_mode,
                             tree_chunk=tree_chunk, pool="forest_classifier",
                             bf16=hist_backend == "pallas_bf16")
    return _forest(fields, edges, codes)


def _forest(fields, edges, codes) -> Forest:
    feats, bins, leaf_value, counts, train_leaf = fields
    return Forest(split_feat=feats, split_bin=bins, leaf_value=leaf_value, counts=counts,
                  bin_edges=edges, train_leaf=train_leaf, train_fp=codes_fingerprint(codes))


def _grow_from_keys(tree_keys, codes, y, *, depth, mtry, n_bins, hist_mode, tree_chunk, pool,
                    bf16=False):
    """Grow one tree a key (``tree_keys`` (T, 2)) in chunks of
    ``tree_chunk`` trees; returns the five per-tree fields (split
    features, split bins, leaf values, counts, training leaf values).
    ``bf16``: the split search's histograms in their bf16 form."""
    tree_chunk = DEFAULT_TREE_CHUNK if tree_chunk is None else tree_chunk
    center = 0.0 if _is_binary01(y) else 1.0
    words = packed_codes_for(codes, hist_mode)
    yf = y.to(torch.float32)

    def chunk_shard(i: int):
        s = i * tree_chunk
        return _grow_chunk(tree_keys[s : s + tree_chunk], codes, yf, center, depth=depth,
                           mtry=mtry, n_bins=n_bins, hist_mode=hist_mode, words=words, bf16=bf16)

    # Classified retry (parallel/retry.py): a transient failure re-runs
    # only its chunk, bit for bit (its keys are explicit); a programming
    # or CUDA error raises on the first attempt.
    chunks = require_all(run_shards(obs.instrument_dispatch(pool, chunk_shard),
                                    -(-tree_keys.shape[0] // tree_chunk), pool=pool))
    return tuple(torch.cat([c[j] for c in chunks], dim=0) for j in range(5))


def dispatch_major_gather(t: torch.Tensor, mesh, axis: str, n_disp: int) -> torch.Tensor:
    """All ranks' (n_disp · per, ...) blocks of ``t`` (each rank's trees
    in dispatch-major, local order) as one (n_disp · A · per, ...) tensor
    in the JAX sharded fit's dispatch-major, device, local order."""
    cat = all_gather_cat(t, mesh, axis)
    a = mesh.shape[axis]
    per = t.shape[0] // n_disp
    return cat.reshape(a, n_disp, per, *t.shape[1:]).transpose(0, 1).reshape(-1, *t.shape[1:])


def sharded_tree_keys(key: torch.Tensor, n_disp: int, a: int, per: int, rank: int):
    """This rank's keys of a sharded fit: slice ``[i, r·per : (r+1)·per]``
    of each dispatch i of ``split(key, n_disp · a · per)``, dispatch-major."""
    keys = rnd.split(key, n_disp * a * per).reshape(n_disp, a * per, 2)
    return keys[:, rank * per : (rank + 1) * per].reshape(-1, 2)


def fit_forest_sharded(
    x: torch.Tensor,
    y: torch.Tensor,
    key: torch.Tensor,
    mesh,
    n_trees: int = 500,
    depth: int = 9,
    mtry: int | None = None,
    n_bins: int = 64,
    axis_name: str = TREE_AXIS,
    hist_backend: str = HIST_BACKEND,
    hist_mode: str | None = None,
    tree_chunk: int | None = DEFAULT_TREE_CHUNK,
) -> Forest:
    """Tree-parallel forest fit over a mesh axis: every rank of the axis
    grows its share of the trees against the whole (replicated) data,
    and the trees are all-gathered.

    The forest is the JAX package's sharded forest: the plan
    (:func:`~.plan.sharded_fit_plan`, its "pallas" plan) gives
    (chunk, chunks_per_disp, n_disp), the keys are
    ``split(key, n_disp · A · per_disp_dev)``, rank r grows slice
    ``[i, r·per : (r+1)·per]`` of dispatch i, and the gathered trees,
    in dispatch-major, device, local order, are cut to ``n_trees``.
    Each rank grows its trees with the port's kernels in chunks of
    ``tree_chunk`` (the chunking changes no number); "xla" and the Pallas
    names grow the same way ("pallas_bf16" in its bf16 form) and "onehot"
    is refused, as in the JAX package. Every rank returns the whole
    forest. A mesh of one rank grows every key itself."""
    check_hist_backend(hist_backend, sharded=True, device=x.device)
    check_mesh(mesh, axis_name)
    n, p = x.shape
    if mtry is None:
        mtry = max(1, int(np.sqrt(p)))
    hist_mode = resolve_hist_mode_packed(hist_mode, n_bins)
    a = mesh.shape[axis_name]
    chunk, chunks_per_disp, n_disp = sharded_fit_plan(n, depth, -(-n_trees // a), n_bins=n_bins,
                                                      p=p, hist_mode=hist_mode,
                                                      hist_backend=hist_backend)
    per = chunk * chunks_per_disp
    edges = quantile_bins(x, n_bins)
    codes = binarize(x, edges)
    mine = sharded_tree_keys(key.to(x.device), n_disp, a, per, mesh.coord(axis_name))
    fields = _grow_from_keys(mine, codes, y, depth=depth, mtry=mtry, n_bins=n_bins,
                             hist_mode=hist_mode, tree_chunk=tree_chunk, pool="forest_sharded",
                             bf16=hist_backend == "pallas_bf16")
    fields = [dispatch_major_gather(f, mesh, axis_name, n_disp)[:n_trees] for f in fields]
    return _forest(fields, edges, codes)


def fit_forest_regressor_sharded(
    x: torch.Tensor,
    y: torch.Tensor,
    key: torch.Tensor,
    mesh,
    n_trees: int = 500,
    depth: int = 9,
    mtry: int | None = None,
    **kwargs,
) -> Forest:
    """Tree-sharded regression forest: the sharded engine with
    randomForest's regression mtry default (max(1, floor(p/3)))."""
    if mtry is None:
        mtry = max(1, x.shape[1] // 3)
    return fit_forest_sharded(x, y, key, mesh, n_trees=n_trees, depth=depth, mtry=mtry, **kwargs)


def fit_forest_regressor(
    x: torch.Tensor,
    y: torch.Tensor,
    key: torch.Tensor,
    n_trees: int = 500,
    depth: int = 9,
    mtry: int | None = None,
    **kwargs,
) -> Forest:
    """Regression forest — the same engine (SSE split score), leaf values
    are bootstrap-weighted means; mtry defaults to randomForest's
    regression default max(1, floor(p/3)). A continuous target's
    centered weights are floats; the kernels add them in a fixed order,
    so a forest grown twice on the card is the same forest."""
    if mtry is None:
        mtry = max(1, x.shape[1] // 3)
    return fit_forest_classifier(x, y, key, n_trees=n_trees, depth=depth, mtry=mtry, **kwargs)


class ForestPredictions(NamedTuple):
    prob: torch.Tensor   # mean leaf probability over trees
    vote: torch.Tensor   # fraction of trees voting class 1 (randomForest "prob")


def forest_apply(forest: Forest, codes: torch.Tensor) -> torch.Tensor:
    """Leaf value of every (tree, row), (T, n): one ``traverse`` launch
    routes each row through every level and reads its leaf's value."""
    table = forest.leaf_value[:, :, None].contiguous()
    return traverse(codes, forest.split_feat.contiguous(), forest.split_bin.contiguous(),
                    table)[:, 0]


def _oob_reduce(leaf_vals, counts):
    """OOB-masked tree averages: each row averages the trees whose
    bootstrap count for it is zero."""
    votes = (leaf_vals > 0.5).to(torch.float32)
    mask = (counts == 0).to(torch.float32)
    denom = torch.clamp(mask.sum(dim=0), min=1.0)
    return (leaf_vals * mask).sum(dim=0) / denom, (votes * mask).sum(dim=0) / denom


def _mean_reduce(leaf_vals):
    votes = (leaf_vals > 0.5).to(torch.float32)
    return leaf_vals.mean(dim=0), votes.mean(dim=0)


def predict_forest(forest: Forest, x: torch.Tensor, oob: bool = False) -> ForestPredictions:
    """Forest predictions for rows ``x``.

    ``vote`` is randomForest's ``predict(type="prob")``: the fraction of
    trees whose leaf majority class is 1. With ``oob=True`` (valid only
    for the training matrix, in training row order) each row averages
    only the trees whose bootstrap count for it is zero — the
    reference's OOB propensity (``ate_functions.R:174``) — from the leaf
    values recorded during growth.
    """
    if oob and x.shape[0] != forest.counts.shape[1]:
        raise ValueError(
            "oob=True is only valid for the training matrix: forest was "
            f"fit on {forest.counts.shape[1]} rows, got {x.shape[0]}"
        )
    if oob and forest.train_leaf is not None:
        if forest.train_fp is not None and forest.bin_edges is not None:
            fp = codes_fingerprint(binarize(x, forest.bin_edges))
            if int(fp) != int(forest.train_fp):
                raise ValueError(
                    "oob=True with recorded training leaves, but x does not "
                    "fingerprint as the training matrix (permuted or altered "
                    "rows?); pass oob=False for new data"
                )
        leaf_vals = forest.train_leaf
    else:
        leaf_vals = forest_apply(forest, binarize(x, forest.bin_edges))
    prob, vote = _oob_reduce(leaf_vals, forest.counts) if oob else _mean_reduce(leaf_vals)
    return ForestPredictions(prob=prob, vote=vote)


def forest_oob_mean(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """OOB leaf-mean prediction on the training matrix."""
    return predict_forest(forest, x, oob=True).prob


def rf_oob_propensity(
    frame: CausalFrame,
    key: torch.Tensor | None = None,
    n_trees: int = 500,
    depth: int = 9,
    mesh=None,
    **kwargs,
) -> torch.Tensor:
    """The reference's AIPW propensity: classification forest of W on X,
    OOB vote fractions (``ate_functions.R:169-174``). With a ``mesh``,
    trees shard over its tree axis (:func:`fit_forest_sharded`)."""
    if key is None:
        key = rnd.key(12325, device=frame.device)  # the seed the reference meant to set
    if mesh is not None:
        forest = fit_forest_sharded(frame.x, frame.w, key, mesh, n_trees=n_trees, depth=depth,
                                    **kwargs)
    else:
        forest = fit_forest_classifier(frame.x, frame.w, key, n_trees=n_trees, depth=depth,
                                       **kwargs)
    return predict_forest(forest, frame.x, oob=True).vote
