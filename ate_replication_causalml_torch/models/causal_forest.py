"""Honest causal forest — the notebook's "Causal Forest(GRF)" row.

Port of ``ate_replication_causalml_tpu/models/causal_forest.py``, the
replacement for ``grf::causal_forest(X, Y, W, num.trees=2000,
honesty=TRUE)`` followed by ``estimate_average_effect``
(``ate_replication.Rmd:249-272``):

* local centering: OOB regression forests give Ŷ(x) and Ŵ(x), and the
  causal forest grows on the residuals ỹ = Y − Ŷ, w̃ = W − Ŵ;
* gradient-based honest splits, level-wise to a fixed depth: a node's
  split maximizes the heterogeneity of GRF's pseudo-outcome
  ρ = (w̃ − w̄)((ỹ − ȳ) − (w̃ − w̄)τ), which is a per-node linear
  combination of five level-invariant row channels [1, w̃, ỹ, w̃², w̃ỹ].
  Each level is one shared-weights histogram of those channels
  (``ops/hist.py::bin_histogram_shared``, sibling subtraction), the
  split tables are built from it in PyTorch (``_tables``), and rows
  route with one ``route_advance`` launch per level — the JAX package's
  streaming grower;
* honesty: each tree's half-sample is split in two by a Bernoulli
  draw; the I half (grow mask) chooses splits, the J half (estimate
  mask) fills the leaves' five sufficient statistics
  (``node_sums_shared``); membership rides in the kernels' ids as −1,
  written by ``route_advance`` under the grow and estimate masks;
* little bags: trees grow in groups of ``ci_group_size`` sharing one
  exact s-of-n half-sample; ``predict_cate`` estimates the CATE's
  variance from between- and within-group spread (grf's bootstrap of
  little bags, sandwich form).

The random streams are the JAX package's bit for bit (``ops/random.py``),
so the port draws the same half-samples, honesty splits and mtry scores.
The histogram sums are float; the port adds them in another order than
the JAX package, so a split can differ where two candidates tie in
float32 (the tests bound how often, and check that each is a tie).

Under the packed policy (``ATE_TPU_PREDICT_PACK=1`` or a "+pack"
``hist_mode``) the partition levels read packed codes, built once per
fit. ``compute_leaf_index`` and ``predict_cate`` take ``pack`` and
resolve it as the JAX package does; the JAX package's packed routing is
an XLA contraction with the same leaves, and the port routes with its
``traverse`` kernel either way (one launch routes a tree chunk's rows
through every level to their leaves), so ``pack`` changes no number.

The entry points take the JAX package's parameters in its order.
The serving daemon's counterparts of the JAX package's AOT lowers,
:func:`lower_predict_cate` and :func:`lower_predict_cate_masked`, return
a :class:`WarmPredict` for one query shape: on the card one CUDA graph
of ``predict_cate`` captured around static input and forest buffers.
Not ported: the non-streaming ``xla``/``onehot`` formulations, the
sharded grower (a ``mesh`` raises) and the matmul row backends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.models.forest import (
    HIST_BACKEND,
    binarize,
    check_hist_backend,
    exact_subsample_mask,
    fit_forest_regressor,
    forest_oob_mean,
    packed_codes_for,
    quantile_bins,
    select_split,
    streaming_level_loop,
)
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops.hist import (
    bin_histogram_shared,
    mode_for_width,
    node_sums_shared,
    resolve_hist_mode_packed,
)
from ate_replication_causalml_torch.ops.pack import packable, resolve_predict_pack
from ate_replication_causalml_torch.parallel.retry import require_all, run_shards
from ate_replication_causalml_torch.kernels import build
from ate_replication_causalml_torch.ops.tree import table_lookup, traverse

_EPS = 1e-12
# The JAX package's defaults for rows per block of prediction and routing.
DEFAULT_ROW_CHUNK = 65536
# Little-bag groups grown together: 8 groups of 2 trees, one kernel
# launch per level for 16 trees.
DEFAULT_GROUP_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class CausalForest:
    """A fitted honest causal forest (the JAX package's ``CausalForest``).

    Split layout as in :class:`~.forest.Forest` (children of node k are
    2k/2k+1; frozen nodes route every row left). ``leaf_stats`` holds
    each depth-D leaf's honest (J-half) sufficient statistics
    [count, Σw̃, Σỹ, Σw̃², Σw̃ỹ]; ``in_sample`` marks the rows a tree saw
    (either half), which OOB prediction excludes.
    """

    split_feat: torch.Tensor   # (T, D, 2^(D-1)) int32
    split_bin: torch.Tensor    # (T, D, 2^(D-1)) int32
    leaf_stats: torch.Tensor   # (T, 2^D, 5) float32
    in_sample: torch.Tensor    # (T, n) bool
    bin_edges: torch.Tensor    # (p, n_bins-1)
    ci_group_size: int = 2

    @property
    def n_trees(self) -> int:
        return self.split_feat.shape[0]

    @property
    def depth(self) -> int:
        return self.split_feat.shape[1]


@dataclasses.dataclass(frozen=True)
class FittedCausalForest:
    """Causal forest + the nuisance estimates it was centered on, bound
    to its training data (the reference predicts on the training set,
    ``ate_replication.Rmd:259``)."""

    forest: CausalForest
    y_hat: torch.Tensor   # (n,) OOB E[Y|X]
    w_hat: torch.Tensor   # (n,) OOB E[W|X], the propensity
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor


class CatePredictions(NamedTuple):
    cate: torch.Tensor       # τ̂(x) per row
    variance: torch.Tensor   # little-bags variance estimate per row


class AverageEffect(NamedTuple):
    estimate: torch.Tensor
    std_err: torch.Tensor


_CF_DTYPES = {
    "split_feat": torch.int32, "split_bin": torch.int32, "leaf_stats": torch.float32,
    "in_sample": torch.bool, "bin_edges": torch.float32,
}


def causal_forest_from_jax(arrays: dict, device=None) -> CausalForest:
    """The port's :class:`CausalForest` from a JAX ``CausalForest``'s
    fields as numpy arrays (``ci_group_size`` as an int, default 2)."""
    dev = resolve_device(device)
    fields = {name: torch.from_numpy(np.array(arrays[name])).to(dev, dtype)
              for name, dtype in _CF_DTYPES.items()}
    return CausalForest(**fields, ci_group_size=int(arrays.get("ci_group_size", 2)))


def _moments_stack(wt: torch.Tensor, yt: torch.Tensor) -> torch.Tensor:
    """(n, 5) per-row sufficient-statistic stack [1, w̃, ỹ, w̃², w̃ỹ]."""
    return torch.stack([torch.ones_like(wt), wt, yt, wt * wt, wt * yt], dim=1)


def _node_tau(mom: torch.Tensor):
    """Per-node (w̄, ȳ, τ) from the five moments, mom (..., 5)."""
    c, sw, sy, sww, swy = mom.unbind(dim=-1)
    wbar = sw / torch.clamp(c, min=1.0)
    ybar = sy / torch.clamp(c, min=1.0)
    varw = c * sww - sw * sw
    tau = torch.where(varw > _EPS, (c * swy - sw * sy) / torch.clamp(varw, min=_EPS), 0.0)
    return wbar, ybar, tau


def _tables(hist, keys, level, perm, *, p, n_bins, mtry, min_node):
    """Split tables of one level from its (T, 5, m, p, n_bins) histogram
    of the channels [1, w̃, ỹ, w̃², w̃ỹ] (rev node order):

      Σ_left ρ = S4 − w̄·S2 + (2τw̄ − ȳ)·S1 + (w̄ȳ − τw̄²)·S0 − τ·S3

    over the cumulative bin sums S, with each node's (w̄, ȳ, τ) from the
    bin marginal of feature 0. The expression order is the JAX
    package's: float32 cancellation decides near-ties."""
    mom_nodes = hist[:, :, :, 0, :].sum(dim=3).transpose(1, 2)   # (T, m, 5)
    wbar, ybar, tau = _node_tau(mom_nodes)                        # (T, m) each
    s_cum = torch.cumsum(hist, dim=4)                             # (T, 5, m, p, b)
    bc = lambda v: v[:, :, None, None]
    cl = s_cum[:, 0]
    rl = (
        s_cum[:, 4]
        - bc(wbar) * s_cum[:, 2]
        + bc(2.0 * tau * wbar - ybar) * s_cum[:, 1]
        + bc(wbar * ybar - tau * wbar * wbar) * s_cum[:, 0]
        - bc(tau) * s_cum[:, 3]
    )
    ct, rt = cl[..., -1:], rl[..., -1:]
    cr, rr = ct - cl, rt - rl
    score = -(rl * rl / torch.clamp(cl, min=_EPS) + rr * rr / torch.clamp(cr, min=_EPS))
    score = torch.where((cl >= min_node) & (cr >= min_node), score, torch.inf)
    return select_split(score, keys[:, level], 1 << level, p, n_bins, mtry, perm=perm)


def little_bag_masks(group_keys, n: int, s: int, k: int, honesty: bool = True):
    """The random row memberships of G little-bag groups of k trees
    (group keys (G, 2)), the JAX package's ``grow_group``/``grow_one``
    streams: each group's exact s-of-n half-sample, and each tree's
    honest split of it by ``bernoulli(tree_key, 0.5)``.

    Returns (tree_keys (T, 2), in_sample, grow_mask, est_mask), the masks
    (T, n) bool with T = G·k."""
    n_groups = group_keys.shape[0]
    sub_tree = rnd.split(group_keys)                        # (G, 2, 2): subsample, trees
    in_mask = exact_subsample_mask(sub_tree[:, 0], n, s)    # (G, n)
    tree_keys = rnd.split(sub_tree[:, 1], k).reshape(n_groups * k, 2)
    base = in_mask.repeat_interleave(k, dim=0)
    if not honesty:
        return tree_keys, base, base, base
    bern = rnd.bernoulli(tree_keys, 0.5, (n,))
    return tree_keys, base, base & bern, base & ~bern


def _grow_groups(group_keys, codes, mom5, *, n, s, k, depth, mtry, n_bins, min_node,
                 honesty, hist_mode, words=None):
    """Grow G little-bag groups of k trees (group keys (G, 2)): the JAX
    package's ``grow_group`` → ``grow_one`` → ``grow_one_streaming``,
    with the groups' trees on one explicit tree axis (T = G·k).
    ``words``: the packed codes of the "partition+pack" levels."""
    p = codes.shape[1]
    tree_keys, base, grow_mask, est_mask = little_bag_masks(group_keys, n, s, k, honesty)
    # The honesty draw spent tree_key itself; the level keys drop split
    # slot 0: the JAX package's frozen stream.
    level_keys = rnd.split(tree_keys, depth + 1)[:, 1:]     # (T, depth, 2)
    n_trees = tree_keys.shape[0]

    feats, bins, leaf_ids = streaming_level_loop(
        codes, n_trees, depth, n_bins,
        hist_fn=lambda ids, m: bin_histogram_shared(
            codes, ids, mom5, max_nodes=m, n_bins=n_bins,
            mode=mode_for_width(hist_mode, m, 5, p, n_bins), packed=words),
        tables_fn=lambda hist, level, perm: _tables(
            hist, level_keys, level, perm, p=p, n_bins=n_bins, mtry=mtry, min_node=min_node),
        grow_mask=grow_mask, est_mask=est_mask,
    )
    leaf_stats = node_sums_shared(leaf_ids, mom5, 1 << depth)       # (T, L, 5)
    return feats, bins, leaf_stats, base


def grow_causal_forest(
    x: torch.Tensor,
    wt: torch.Tensor,
    yt: torch.Tensor,
    key: torch.Tensor,
    n_trees: int = 2000,
    depth: int = 8,
    mtry: int | None = None,
    n_bins: int = 64,
    min_node: int = 5,
    sample_fraction: float = 0.5,
    ci_group_size: int = 2,
    honesty: bool = True,
    group_chunk: int = DEFAULT_GROUP_CHUNK,
    hist_mode: str | None = None,
) -> CausalForest:
    """Grow the causal forest on centered treatment/outcome residuals.

    ``n_trees`` is rounded up to a multiple of ``ci_group_size``; each
    group of trees shares one without-replacement half-sample
    (``sample_fraction`` of the rows) and every tree splits its sample
    into honest I (grow) / J (estimate) halves. Group ``i`` grows from
    ``split(key, n_groups)[i]``: the i-th key does not depend on the
    count, so the forest equals the JAX package's padded dispatch plan's
    and ``group_chunk`` changes no number. ``hist_mode`` as in
    :func:`~.forest.fit_forest_classifier` (K = 5 channels: partition
    from width 16 under "auto"; packed there under the packed policy)."""
    n, p = x.shape
    if mtry is None:
        mtry = int(np.ceil(np.sqrt(p))) + 20  # grf's default, capped at p below
    mtry = min(mtry, p)
    k = ci_group_size
    n_groups = -(-n_trees // k)
    hist_mode = resolve_hist_mode_packed(hist_mode, n_bins)
    edges = quantile_bins(x, n_bins)
    codes = binarize(x, edges)
    words = packed_codes_for(codes, hist_mode)
    mom5 = _moments_stack(wt, yt).T.contiguous()            # (5, n), shared by every tree
    s = max(2, int(n * sample_fraction))
    group_keys = rnd.split(key.to(x.device), n_groups)

    def chunk_shard(i: int):
        g = i * group_chunk
        return _grow_groups(group_keys[g : g + group_chunk], codes, mom5, n=n, s=s, k=k,
                            depth=depth, mtry=mtry, n_bins=n_bins, min_node=min_node,
                            honesty=honesty, hist_mode=hist_mode, words=words)

    # Classified retry, as the classifier's chunks (parallel/retry.py).
    chunks = require_all(run_shards(obs.instrument_dispatch("causal_forest", chunk_shard),
                                    -(-n_groups // group_chunk), pool="causal_forest"))
    cat = lambda j: torch.cat([c[j] for c in chunks], dim=0)
    return CausalForest(split_feat=cat(0), split_bin=cat(1), leaf_stats=cat(2),
                        in_sample=cat(3), bin_edges=edges, ci_group_size=k)


@contextlib.contextmanager
def stage(times: dict | None, name: str, device: torch.device):
    """Record the wall time of a block into ``times[name]`` (seconds,
    the current stream synchronized at both ends); a no-op when ``times``
    is None. The current stream, not the device: in the concurrent sweep
    a device-wide sync would wait for every other worker's stream too
    and charge their work to this stage."""
    if times is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def fit_causal_forest(
    frame: CausalFrame,
    key: torch.Tensor | None = None,
    n_trees: int = 2000,
    depth: int = 8,
    nuisance_trees: int = 500,
    nuisance_depth: int = 9,
    hist_backend: str = HIST_BACKEND,
    hist_mode: str | None = None,
    mesh=None,
    axis_name: str = "tree",
    *,
    stage_times: dict | None = None,
    **grow_kwargs,
) -> FittedCausalForest:
    """grf-equivalent fit on one device: OOB regression forests for Ŷ and
    Ŵ, then the honest causal forest on the residuals
    (``ate_replication.Rmd:250-255``). The JAX package's parameters in
    its order: ``hist_backend`` takes only "auto", and ``mesh`` (with
    ``axis_name``) only None — the sharded fit is not ported.
    ``stage_times``, when given, receives the wall seconds of "nuisance"
    and "causal_grow"."""
    check_hist_backend(hist_backend)
    check_no_mesh(mesh)
    if key is None:
        key = rnd.key(12345, device=frame.device)  # the seed grf is given (Rmd:255)
    ky, kw, kc = rnd.split(key.to(frame.device), 3).unbind(dim=0)
    x, w, y = frame.x, frame.w, frame.y
    with stage(stage_times, "nuisance", frame.device):
        fy = fit_forest_regressor(x, y, ky, n_trees=nuisance_trees, depth=nuisance_depth,
                                  hist_mode=hist_mode)
        y_hat = forest_oob_mean(fy, x)
        del fy
        fw = fit_forest_regressor(x, w, kw, n_trees=nuisance_trees, depth=nuisance_depth,
                                  hist_mode=hist_mode)
        w_hat = forest_oob_mean(fw, x)
        del fw
    with stage(stage_times, "causal_grow", frame.device):
        forest = grow_causal_forest(x, w - w_hat, y - y_hat, kc, n_trees=n_trees, depth=depth,
                                    hist_mode=hist_mode, **grow_kwargs)
    return FittedCausalForest(forest=forest, y_hat=y_hat, w_hat=w_hat, x=x, y=y, w=w)


def check_no_mesh(mesh) -> None:
    """The JAX package's ``mesh`` argument: the port runs on one device."""
    if mesh is not None:
        raise ValueError("mesh is not supported: the port's sharded (multi-GPU) fit is not "
                         "ported; pass mesh=None")


def _tree_route_stream(feats, bins, codes, depth):
    """Leaf index of every (tree, row), (T, n) int32 (the JAX package's
    ``_tree_route_stream``): one ``traverse`` launch through every level."""
    if depth != feats.shape[1]:
        raise ValueError(f"depth {depth} is not the split tables' {feats.shape[1]}")
    return traverse(codes, feats.contiguous(), bins.contiguous())


def _resolve_pack_for(forest: CausalForest, pack) -> bool:
    """The JAX package's pack resolution for one forest: the policy
    (``pack``, else ``ATE_TPU_PREDICT_PACK``; a bad value raises) and the
    7-bit bound on its bins. Routing runs on the route kernel whatever
    it says: packed routing is an XLA contraction in the JAX package,
    with the same leaves."""
    return resolve_predict_pack(pack) and packable(int(forest.bin_edges.shape[1]) + 1)


def _check_row_chunk(row_chunk: int) -> None:
    if row_chunk < 1:
        raise ValueError(f"row_chunk must be >= 1, got {row_chunk}")


def compute_leaf_index(forest: CausalForest, x: torch.Tensor, tree_chunk: int = 32,
                       row_chunk: int = DEFAULT_ROW_CHUNK,
                       pack: bool | str | None = None) -> torch.Tensor:
    """Per-(tree, row) leaf indices for a query matrix, (T, n), in the
    JAX package's storage type (uint8 up to depth 8, else int16/int32):
    one ``traverse`` launch per block of ``tree_chunk`` trees, over every
    row. ``row_chunk`` is validated (>= 1) and needs no blocking: it
    bounds the JAX package's one-hot operands, which the port's kernels
    do not have. ``pack`` is resolved as in the JAX package and changes
    nothing (:func:`_resolve_pack_for`)."""
    _check_row_chunk(row_chunk)
    _resolve_pack_for(forest, pack)
    codes = binarize(x, forest.bin_edges)
    depth = forest.depth
    dtype = torch.uint8 if depth <= 8 else (torch.int16 if depth <= 15 else torch.int32)
    return torch.cat([
        _tree_route_stream(forest.split_feat[t : t + tree_chunk],
                           forest.split_bin[t : t + tree_chunk], codes, depth).to(dtype)
        for t in range(0, forest.n_trees, tree_chunk)
    ], dim=0)


def _grf_df_flag(variance_compat: str) -> float:
    """Validate ``variance_compat`` and map it to the between-group df
    selector: 1.0 for grf's num_groups, 0.0 for the unbiased gn − 1."""
    if variance_compat not in ("unbiased", "grf"):
        raise ValueError(
            f"variance_compat must be 'unbiased' or 'grf', got {variance_compat!r}"
        )
    return float(variance_compat == "grf")


def _tau_from_sums(S, M):
    """α-weighted residual-on-residual regression from accumulated
    normalized moments S (5, …) over M valid trees: (τ, pooled Var(w̃));
    ``var > _EPS`` is the validity mask."""
    Mc = torch.clamp(M, min=1.0)
    mw, my, mww, mwy = (S[i] / Mc for i in (1, 2, 3, 4))
    var = mww - mw * mw
    tau = torch.where(var > _EPS, (mwy - mw * my) / torch.clamp(var, min=_EPS), 0.0)
    return tau, var


def _leaf_payload(forest, codes, t0, t1, leaf_index):
    """(Tc, 5, n) leaf statistics of trees [t0, t1) at every row: one
    ``traverse`` launch (the rows routed through every level, the payload
    read in its stored (T, L, 5) layout) or, with ``leaf_index`` (T, n),
    one lookup launch."""
    if leaf_index is None:
        return traverse(codes, forest.split_feat[t0:t1].contiguous(),
                        forest.split_bin[t0:t1].contiguous(),
                        forest.leaf_stats[t0:t1].contiguous())
    return table_lookup(forest.leaf_stats[t0:t1].transpose(1, 2).contiguous(),
                        leaf_index[t0:t1].to(torch.int32).contiguous())


def _sum_lead(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading dim by pairwise halving, every step one
    elementwise add. A row's sum is then the same bits whatever the
    other rows and their count: PyTorch's reductions pick their order
    by shape (the CPU's vectorized outer sums, the card's launch
    configuration), so a ``sum(dim=0)`` of 3 rows and of 256 rows can
    round one row differently, and serving pads a request into a larger
    batch. The JAX package's predict is row-independent the same way."""
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        s = t[:h] + t[h : 2 * h]
        t = torch.cat((s, t[2 * h :])) if t.shape[0] % 2 else s
    return t[0]


def _chunk_moments(forest, codes, g0, g1, oob, leaf_index, n):
    """The little-bag sums of groups [g0, g1) for every row: the leaf
    payload (:func:`_leaf_payload`) and the per-chunk ψ-moments of the JAX
    package's ``chunk_fn``. Returns the chunk's (5, n) moment sums, its
    pooled τ_c (n,) and its nine group-level sums (9, n): the count of
    groups whose every tree is valid, ΣP_g, ΣB_g, ΣP_g², ΣB_g², ΣP_gB_g,
    and the within-group Σdev_P², Σdev_P·dev_B, Σdev_B². Every sum over
    trees or groups is :func:`_sum_lead`'s, so each row's bits are
    independent of the other rows."""
    k = forest.ci_group_size
    t0, t1 = g0 * k, g1 * k
    gc = g1 - g0
    stats = _leaf_payload(forest, codes, t0, t1, leaf_index)  # (Tc, 5, n)
    cnt = stats[:, 0]
    valid = cnt > 0
    if oob:
        valid = valid & ~forest.in_sample[t0:t1]
    m = torch.where(valid[:, None], stats / torch.clamp(cnt, min=1.0)[:, None], 0.0)
    S_sum = _sum_lead(m)                 # (5, n)
    m = m.reshape(gc, k, 5, n)
    valid = valid.reshape(gc, k, n)
    mw, my, mww, mwy = (m[:, :, i] for i in (1, 2, 3, 4))
    A_t = mwy - mw * my                  # per-tree Cov(w̃, ỹ)
    B_t = mww - mw * mw                  # per-tree Var(w̃)
    ok_g = valid.all(dim=1).to(torch.float32)   # groups whose every tree is valid
    A_g = _sum_lead(A_t.transpose(0, 1)) / k
    B_g = _sum_lead(B_t.transpose(0, 1)) / k
    tau_c, _ = _tau_from_sums(S_sum, S_sum[0])
    P_t = A_t - tau_c * B_t
    P_g = A_g - tau_c * B_g
    devP = (P_t - P_g[:, None]) * ok_g[:, None]
    devB = (B_t - B_g[:, None]) * ok_g[:, None]
    within = _sum_lead(torch.stack((devP * devP, devP * devB, devB * devB), dim=2)
                       .transpose(0, 1))  # (gc, 3, n)
    groups = torch.stack((ok_g, ok_g * P_g, ok_g * B_g, ok_g * P_g * P_g, ok_g * B_g * B_g,
                          ok_g * P_g * B_g), dim=1)
    return S_sum, tau_c, _sum_lead(torch.cat((groups, within), dim=1))


def predict_cate(
    forest: CausalForest,
    x: torch.Tensor,
    oob: bool = True,
    tree_chunk: int = 32,
    row_chunk: int = DEFAULT_ROW_CHUNK,
    leaf_index: torch.Tensor | None = None,
    row_backend: str | None = None,
    variance_compat: str = "unbiased",
    pack: bool | str | None = None,
) -> CatePredictions:
    """Forest-weighted CATE τ̂(x) with the little-bags variance.

    ``oob=True`` (training matrix only) excludes each tree's own
    subsample from its contributions, grf's in-sample ``predict(forest)``
    (``ate_replication.Rmd:259``). Trees are taken ``tree_chunk`` at a
    time (whole groups), each chunk's ψ-moments at its own pooled τ_c
    and shifted to the global τ̂ afterwards, as in the JAX package. Every
    row is computed on its own: its bits do not depend on the other rows
    of ``x`` (:func:`_sum_lead`), which serving relies on.
    ``row_chunk`` is validated (>= 1) and needs no blocking: the JAX
    package blocks rows to bound its (rows, nodes) one-hot operands, and
    the port's kernels have none. ``leaf_index``:
    the (T, n) leaf ids of this ``x`` from :func:`compute_leaf_index`;
    routing is skipped and the payload read through them, the same bits.
    ``row_backend``: None or "pallas", the port's kernels (the JAX
    package's matmul formulations are not ported). ``variance_compat``:
    "unbiased" (gn − 1 between-group df) or "grf" (grf's num_groups).
    ``pack`` as in :func:`compute_leaf_index`."""
    grf_df = _grf_df_flag(variance_compat)
    _check_row_backend(row_backend)
    _check_row_chunk(row_chunk)
    _resolve_pack_for(forest, pack)
    n = x.shape[0]
    if oob and n != forest.in_sample.shape[1]:
        raise ValueError(
            "oob=True is only valid for the training matrix: forest was "
            f"fit on {forest.in_sample.shape[1]} rows, got {n}; "
            "pass oob=False for new data"
        )
    codes = None
    if leaf_index is None:
        codes = binarize(x, forest.bin_edges)
    else:
        leaf_index = torch.as_tensor(leaf_index, device=x.device)
        if tuple(leaf_index.shape) != (forest.n_trees, n):
            raise ValueError(f"leaf_index must be (T, n) = {(forest.n_trees, n)}, "
                             f"got {tuple(leaf_index.shape)}")
    k = forest.ci_group_size
    n_groups = forest.n_trees // k
    group_chunk = max(1, tree_chunk // k)
    outs = [_chunk_moments(forest, codes, g, min(g + group_chunk, n_groups), oob, leaf_index, n)
            for g in range(0, n_groups, group_chunk)]
    S_c, tau_c, G_c = (torch.stack(a) for a in zip(*outs))
    S_b = _sum_lead(S_c)
    tau, H = _tau_from_sums(S_b, S_b[0])
    d = tau[None, :] - tau_c             # shift each chunk's ψ-moments to the global τ̂
    gn, SP, SP2, ssw = _sum_lead(torch.stack((
        G_c[:, 0],
        G_c[:, 1] - d * G_c[:, 2],
        G_c[:, 3] - 2.0 * d * G_c[:, 5] + d * d * G_c[:, 4],
        G_c[:, 6] - 2.0 * d * G_c[:, 7] + d * d * G_c[:, 8],
    ), dim=1))
    # Var(τ̂) = max(V_between(ψ) − V_within(ψ)/k, 0) / H².
    ngr = torch.clamp(gn, min=1.0)
    mean_psi = SP / ngr
    between_df = ngr if grf_df > 0 else torch.clamp(gn - 1.0, min=1.0)
    v_between = torch.clamp(SP2 - gn * mean_psi * mean_psi, min=0.0) / between_df
    v_within = ssw / torch.clamp(gn * (k - 1.0), min=1.0)
    var_psi = torch.clamp(v_between - v_within / k, min=0.0)
    variance = torch.where(H > _EPS, var_psi / torch.clamp(H, min=_EPS) ** 2, 0.0)
    return CatePredictions(cate=tau, variance=variance)


def _check_row_backend(row_backend) -> None:
    if row_backend not in (None, "pallas"):
        raise ValueError(f"row_backend={row_backend!r} is not ported: the port takes None or "
                         "'pallas' (its CUDA kernels)")


#: The forest's tensor fields, the buffers a warmed predict reads.
_CF_TENSORS = tuple(_CF_DTYPES)


class WarmPredict:
    """A predict warmed for one query shape ``(batch, p)``, the port's
    counterpart of the JAX package's AOT executable. Call it as
    ``warm(forest, x)`` (masked: ``warm(forest, x, mask)``) with host
    ``x`` (batch, p) float32; it returns :class:`CatePredictions` of host
    float32 numpy arrays.

    On the card: at construction the kernels are built, ``predict_cate``
    runs once on a side stream (``warm-up``) and is captured as one
    ``torch.cuda.CUDAGraph`` around static buffers: the query, the mask,
    and a copy of the forest's tensors. The forest is the call's runtime
    argument: a call with another forest object of the same geometry
    (a degraded-mode reload, a same-shape fleet model) copies its
    tensors into the captured buffers first, and nothing is captured
    again. A call is one copy into the static query buffer, one replay
    and one host read. Every replay adds the ``traverse`` launches it
    runs to ``traverse.launches`` (the capture's own recorded launches
    are taken back out), and every capture counts in
    ``graph_captures_total``.

    On the CPU the same callable runs ``predict_cate`` on the given forest
    and query directly, without a graph.

    Masked: the outputs are multiplied by a (batch,) 0/1 row mask, as the
    JAX package's fused executable does: real rows keep their bits (×1.0
    is exact), masked rows are exact zeros."""

    def __init__(self, forest: CausalForest, batch: int, *, masked: bool, oob: bool,
                 tree_chunk: int, row_chunk: int, row_backend: str | None,
                 variance_compat: str, pack: bool | str | None):
        _grf_df_flag(variance_compat)
        _check_row_backend(row_backend)
        _check_row_chunk(row_chunk)
        _resolve_pack_for(forest, pack)
        self.batch = int(batch)
        self.p = int(forest.bin_edges.shape[0])
        self.masked = masked
        self._kw = dict(oob=oob, tree_chunk=tree_chunk, row_chunk=row_chunk,
                        row_backend=row_backend, variance_compat=variance_compat, pack=pack)
        self.device = forest.bin_edges.device
        self.shapes = {f: tuple(getattr(forest, f).shape) for f in _CF_TENSORS}
        self.graph = None
        self.traverse_per_replay = 0
        self._bound = None
        if self.device.type == "cuda":
            self._capture(forest)

    def _run(self, forest, x, mask):
        out = predict_cate(forest, x, **self._kw)
        both = torch.stack((out.cate, out.variance))
        return both * mask if mask is not None else both

    def _capture(self, forest) -> None:
        dev = self.device
        build.build_all()
        self._forest = CausalForest(**{f: getattr(forest, f).clone() for f in _CF_TENSORS},
                                    ci_group_size=forest.ci_group_size)
        self._bound = forest
        self._x = torch.zeros((self.batch, self.p), dtype=torch.float32, device=dev)
        self._mask = (torch.ones((self.batch,), dtype=torch.float32, device=dev)
                      if self.masked else None)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(self._forest, self._x, self._mask)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = traverse.launches
        with torch.cuda.graph(graph):
            self._out = self._run(self._forest, self._x, self._mask)
        # The capture records the launches; they run at each replay.
        self.traverse_per_replay = traverse.launches - before
        build.count_launch(traverse, n=-self.traverse_per_replay)
        obs.counter("graph_captures_total", "CUDA graphs captured").inc(1, kind="predict_cate")
        self.graph = graph

    def _bind(self, forest) -> None:
        """Copy another forest's tensors into the captured buffers."""
        if forest.ci_group_size != self._forest.ci_group_size or any(
                tuple(getattr(forest, f).shape) != self.shapes[f] for f in _CF_TENSORS):
            raise ValueError("forest geometry differs from the warmed predict's; "
                             "warm a new one")
        for f in _CF_TENSORS:
            getattr(self._forest, f).copy_(getattr(forest, f))
        self._bound = forest

    def __call__(self, forest: CausalForest, x, mask=None) -> CatePredictions:
        if (mask is not None) != self.masked:
            raise TypeError("a masked warmed predict takes (forest, x, mask); an unmasked "
                            "one (forest, x)")
        x = torch.as_tensor(x, dtype=torch.float32)
        if tuple(x.shape) != (self.batch, self.p):
            raise ValueError(f"x must be {(self.batch, self.p)}, got {tuple(x.shape)}")
        if self.graph is None:
            m = None if mask is None else torch.as_tensor(mask, dtype=torch.float32)
            both = self._run(forest, x.to(self.device), m)
        else:
            if forest is not self._bound:
                self._bind(forest)
            self._x.copy_(x)
            if mask is not None:
                self._mask.copy_(torch.as_tensor(mask, dtype=torch.float32))
            self.graph.replay()
            build.count_launch(traverse, n=self.traverse_per_replay)
            both = self._out
        host = both.cpu().numpy()
        return CatePredictions(cate=host[0].copy(), variance=host[1].copy())


def lower_predict_cate(
    forest: CausalForest,
    batch: int,
    *,
    oob: bool = False,
    tree_chunk: int = 32,
    row_chunk: int = DEFAULT_ROW_CHUNK,
    row_backend: str | None = None,
    variance_compat: str = "unbiased",
    pack: bool | str | None = None,
) -> WarmPredict:
    """The predict for a fixed ``(batch, p)`` query shape, warmed (on the
    card: built and captured), called as ``warm(forest, x)``: the
    counterpart of the JAX package's AOT lower, whose ``.compile()``
    executable the daemon calls as ``compiled(forest, x, None)``. The
    forest is a runtime argument, so a same-shape reload reuses it. The
    JAX package's ``donate`` has no counterpart: the warmed predict
    copies the query into its own buffer."""
    return WarmPredict(forest, batch, masked=False, oob=oob, tree_chunk=tree_chunk,
                       row_chunk=row_chunk, row_backend=row_backend,
                       variance_compat=variance_compat, pack=pack)


def lower_predict_cate_masked(
    forest: CausalForest,
    batch: int,
    *,
    oob: bool = False,
    tree_chunk: int = 32,
    row_chunk: int = DEFAULT_ROW_CHUNK,
    row_backend: str | None = None,
    variance_compat: str = "unbiased",
    pack: bool | str | None = None,
) -> WarmPredict:
    """:func:`lower_predict_cate` for a fused bucket group, called as
    ``warm(forest, x, mask)`` with a (batch,) float32 0/1 row mask: real
    rows bit-identical to the unmasked predict, masked rows exactly 0."""
    return WarmPredict(forest, batch, masked=True, oob=oob, tree_chunk=tree_chunk,
                       row_chunk=row_chunk, row_backend=row_backend,
                       variance_compat=variance_compat, pack=pack)


def _aipw_from_cate(w, y, y_hat, w_hat, tau_i, clip=0.01):
    e = torch.clamp(w_hat, clip, 1.0 - clip)
    wt = w - e
    yt = y - y_hat
    gamma = tau_i + wt / (e * (1.0 - e)) * (yt - wt * tau_i)
    est = gamma.mean()
    se = torch.sqrt(gamma.var(correction=1) / gamma.shape[0])
    return est, se


def average_treatment_effect(fitted: FittedCausalForest,
                             cate: CatePredictions | None = None) -> AverageEffect:
    """grf ≤0.10 ``estimate_average_effect`` (``ate_replication.Rmd:265``):
    AIPW over the forest's own OOB nuisances with doubly-robust scores
    Γᵢ = τ̂(xᵢ) + (Wᵢ−ê)/(ê(1−ê))·(ỹᵢ − w̃ᵢ·τ̂(xᵢ)); SE = sd(Γ)/√n."""
    if cate is None:
        cate = predict_cate(fitted.forest, fitted.x, oob=True)
    est, se = _aipw_from_cate(fitted.w, fitted.y, fitted.y_hat, fitted.w_hat, cate.cate)
    return AverageEffect(estimate=est, std_err=se)


def incorrect_forest_ate(cate: CatePredictions):
    """The notebook's deliberate negative example
    (``ate_replication.Rmd:258-262``): ATE as the plain mean of CATE
    predictions, SE as sqrt(mean per-point variance)."""
    return cate.cate.mean(), torch.sqrt(cate.variance.mean())
