"""Per-row side of forest growth and prediction: route bits, leaf
lookups, and the fused passes that carry the level loops.

Port of ``ate_replication_causalml_tpu/ops/tree_pallas.py``:

* :func:`route_bits` — ``bit[t, row] = codes[row, feat[t, id]] > thr[t, id]``
  with ``id = ids[t, row]``; an id outside ``[0, M)`` gives 0;
* :func:`table_lookup` — ``out[t, k, row] = table[t, k, ids[t, row]]``;
  an id outside ``[0, L)`` gives 0.

Both are exact integer selections. The JAX package's
``codes_transposed``/``route_table`` exist only for the TPU's matrix
unit; on the card the kernels read ``codes`` (n, p) directly.

The growers and the predictors call the JAX package's two kernels once
per level and once per lookup, with elementwise steps between them; on
the card those sequences are one launch each:

* :func:`route_advance` — one grow level's row-side step (route bit,
  both id streams advanced in place, the next step's ids written);
* :func:`traverse` — every (tree, row) routed through all levels to its
  leaf, then the leaf id or a K-channel leaf payload;
* :func:`leaf_record` — a classifier/regressor chunk's leaf values and
  every training row's value.

Each is held to the sequence it replaces, which is its plain version.

Each wrapper runs its plain PyTorch version for CPU tensors only and
launches its CUDA kernel (``csrc/route.cu``, ``csrc/lookup.cu``) for
CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ate_replication_causalml_torch.kernels import build


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise TypeError(msg)


def _check_device(name: str, *tensors) -> str:
    """"cpu" or "cuda" for the wrapper's inputs; raises on anything else
    and, for CUDA, on tensors on several devices or not contiguous."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    for t in tensors:
        _require(t.device == dev and t.is_contiguous(),
                 f"{name} inputs must be contiguous, on one device")
    return "cuda"


def route_bits_plain(codes, ids, best_feat, best_bin) -> torch.Tensor:
    """The plain version of :func:`route_bits`."""
    n, p = codes.shape
    m = best_feat.shape[1]
    node = ids.long()
    ok = (node >= 0) & (node < m)
    safe = node.clamp(0, max(m - 1, 0))
    feat = best_feat.long().gather(1, safe)
    thr = best_bin.gather(1, safe)
    feat_ok = (feat >= 0) & (feat < p)
    rows = torch.arange(n, device=codes.device)[None, :]
    code = torch.where(feat_ok, codes[rows, feat.clamp(0, p - 1)], 0)
    return (ok & (code > thr)).to(torch.int32)


def route_bits(codes, ids, best_feat, best_bin) -> torch.Tensor:
    """Route bit (1 = right) of every (tree, row) for one level.

    codes (n, p) int32, ids (T, n) int32, best_feat/best_bin (T, M)
    int32 split tables in whatever order ``ids`` indexes → (T, n) int32.
    """
    _require(codes.dtype == torch.int32 and codes.ndim == 2, "codes must be (n, p) int32")
    _require(ids.dtype == torch.int32 and ids.ndim == 2 and ids.shape[1] == codes.shape[0],
             "ids must be (T, n) int32")
    _require(best_feat.dtype == best_bin.dtype == torch.int32
             and best_feat.shape == best_bin.shape and best_feat.ndim == 2
             and best_feat.shape[0] == ids.shape[0],
             "best_feat/best_bin must be (T, M) int32")
    if _check_device("route", codes, ids, best_feat, best_bin) == "cpu":
        return route_bits_plain(codes, ids, best_feat, best_bin)
    n_trees, n = ids.shape
    out = torch.empty((n_trees, n), dtype=torch.int32, device=codes.device)
    if n_trees == 0 or n == 0:
        return out
    k = build.kernel("route")
    build.check(k, k.fn(
        codes.data_ptr(), n, codes.shape[1], ids.data_ptr(), best_feat.data_ptr(),
        best_bin.data_ptr(), n_trees, best_feat.shape[1], out.data_ptr(), _stream(codes),
    ))
    route_bits.launches += 1
    return out


route_bits.launches = 0


def table_lookup_plain(table, ids) -> torch.Tensor:
    """The plain version of :func:`table_lookup`."""
    n_trees, k_ch, n_slots = table.shape
    node = ids.long()
    ok = (node >= 0) & (node < n_slots)
    safe = node.clamp(0, max(n_slots - 1, 0))
    vals = table.gather(2, safe[:, None, :].expand(n_trees, k_ch, ids.shape[1]))
    return torch.where(ok[:, None, :], vals, torch.zeros_like(vals))


def table_lookup(table, ids) -> torch.Tensor:
    """Per-tree K-channel lookup: table (T, K, L) float32, ids (T, n)
    int32 → (T, K, n) float32."""
    _require(table.dtype == torch.float32 and table.ndim == 3, "table must be (T, K, L) float32")
    _require(ids.dtype == torch.int32 and ids.ndim == 2 and ids.shape[0] == table.shape[0],
             "ids must be (T, n) int32")
    if _check_device("lookup", table, ids) == "cpu":
        return table_lookup_plain(table, ids)
    n_trees, k_ch, n_slots = table.shape
    n = ids.shape[1]
    out = torch.empty((n_trees, k_ch, n), dtype=torch.float32, device=table.device)
    if n_trees == 0 or n == 0:
        return out
    k = build.kernel("lookup")
    build.check(k, k.fn(
        table.data_ptr(), n_trees, k_ch, n_slots, ids.data_ptr(), n, out.data_ptr(),
        _stream(table),
    ))
    table_lookup.launches += 1
    return out


table_lookup.launches = 0


def route_advance_plain(codes, node_int, node_rev, best_feat, best_bin, mask=None,
                        last=False) -> torch.Tensor:
    """The plain version of :func:`route_advance`: the grower's sequence
    it replaces (a route, the two id updates, the next ids, the mask)."""
    m = best_feat.shape[1]
    bit = route_bits_plain(codes, node_rev, best_feat, best_bin)
    node_int.copy_(node_int * 2 + bit)
    node_rev.copy_(node_rev + bit * m)
    ids = node_int.clone() if last else torch.where(node_int % 2 == 0, node_rev, -1)
    return ids if mask is None else torch.where(mask, ids, -1)


def route_advance(codes, node_int, node_rev, best_feat, best_bin, mask=None,
                  last=False) -> torch.Tensor:
    """One grow level's row-side step, in place, in one launch.

    codes (n, p) int32; node_int, node_rev (T, n) int32, the interleaved
    (2k/2k+1) and bit-reversed node ids, advanced in place; best_feat,
    best_bin (T, M) int32, the level's split tables in rev order (M =
    2^level). With ``bit`` the route bit at ``id = node_rev``
    (:func:`route_bits`): ``node_int = 2·node_int + bit``, ``node_rev +=
    bit·M``. Returns (T, n) int32: the next level's histogram ids (the
    left child's rev id where ``bit`` is 0, else −1) or, with ``last``,
    the leaf ids ``node_int``; −1 wherever the optional (T, n) bool
    ``mask`` is false."""
    _require(codes.dtype == torch.int32 and codes.ndim == 2, "codes must be (n, p) int32")
    for name, t in (("node_int", node_int), ("node_rev", node_rev)):
        _require(t.dtype == torch.int32 and t.ndim == 2 and t.shape[1] == codes.shape[0],
                 f"{name} must be (T, n) int32")
    _require(node_int.shape == node_rev.shape, "node_int and node_rev must have one shape")
    _require(best_feat.dtype == best_bin.dtype == torch.int32
             and best_feat.shape == best_bin.shape and best_feat.ndim == 2
             and best_feat.shape[0] == node_int.shape[0],
             "best_feat/best_bin must be (T, M) int32")
    _require(mask is None or (mask.dtype == torch.bool and mask.shape == node_int.shape),
             "mask must be (T, n) bool")
    inputs = (codes, node_int, node_rev, best_feat, best_bin) + (() if mask is None else (mask,))
    if _check_device("route_advance", *inputs) == "cpu":
        return route_advance_plain(codes, node_int, node_rev, best_feat, best_bin, mask, last)
    n_trees, n = node_int.shape
    _require(n_trees <= 65535, "route_advance takes at most 65,535 trees a launch")
    out = torch.empty((n_trees, n), dtype=torch.int32, device=codes.device)
    if n_trees == 0 or n == 0:
        return out
    k = build.kernel("route_advance")
    build.check(k, k.fn(
        codes.data_ptr(), n, codes.shape[1], best_feat.data_ptr(), best_bin.data_ptr(),
        n_trees, best_feat.shape[1], node_int.data_ptr(), node_rev.data_ptr(),
        None if mask is None else mask.data_ptr(), int(last), out.data_ptr(), _stream(codes),
    ))
    route_advance.launches += 1
    return out


route_advance.launches = 0


def traverse_plain(codes, split_feat, split_bin, table=None) -> torch.Tensor:
    """The plain version of :func:`traverse`: one route per level, then a
    lookup of the transposed payload (the sequence it replaces)."""
    n_trees, depth, _ = split_feat.shape
    node = torch.zeros((n_trees, codes.shape[0]), dtype=torch.int32, device=codes.device)
    for level in range(depth):
        m = 1 << level
        node = node * 2 + route_bits_plain(codes, node, split_feat[:, level, :m],
                                           split_bin[:, level, :m])
    if table is None:
        return node
    return table_lookup_plain(table.transpose(1, 2), node)


def traverse(codes, split_feat, split_bin, table=None) -> torch.Tensor:
    """Every (tree, row) from the root to its leaf, in one launch.

    codes (n, p) int32; split_feat, split_bin (T, D, W) int32 per-level
    tables in the stored 2k/2k+1 layout (level ``a`` uses its first 2^a
    entries, W ≥ 2^(D−1)); each level is :func:`route_bits`' contract.
    Returns the leaf ids (T, n) int32, or with ``table`` (T, L, K)
    float32 (the payload in its stored layout) the payload
    ``out[t, k, row] = table[t, leaf, k]``, (T, K, n) float32, 0 for a
    leaf outside [0, L)."""
    _require(codes.dtype == torch.int32 and codes.ndim == 2, "codes must be (n, p) int32")
    _require(split_feat.dtype == split_bin.dtype == torch.int32
             and split_feat.shape == split_bin.shape and split_feat.ndim == 3,
             "split_feat/split_bin must be (T, D, W) int32")
    n_trees, depth, width = split_feat.shape
    _require(depth >= 1 and width >= 1 << (depth - 1), "split tables need W >= 2^(D-1)")
    _require(table is None or (table.dtype == torch.float32 and table.ndim == 3
                               and table.shape[0] == n_trees),
             "table must be (T, L, K) float32")
    inputs = (codes, split_feat, split_bin) + (() if table is None else (table,))
    if _check_device("traverse", *inputs) == "cpu":
        return traverse_plain(codes, split_feat, split_bin, table)
    n, p = codes.shape
    dev = codes.device
    if table is None:
        out = torch.empty((n_trees, n), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((n_trees, table.shape[2], n), dtype=torch.float32, device=dev)
    if n_trees == 0 or n == 0:
        return out
    n_slots, n_chan = (0, 0) if table is None else table.shape[1:]
    k = build.kernel("traverse")
    build.check(k, k.fn(
        codes.data_ptr(), n, p, split_feat.data_ptr(), split_bin.data_ptr(), n_trees, depth,
        width, None if table is None else table.data_ptr(), n_slots, n_chan, out.data_ptr(),
        _stream(codes),
    ))
    traverse.launches += 1
    return out


traverse.launches = 0


def leaf_record_plain(leaf_sums, base, mu, node) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`leaf_record`: the grower's sequence it
    replaces (the leaf values, then a lookup of every row's leaf)."""
    leaf_c, leaf_y = leaf_sums[..., 0], leaf_sums[..., 1]
    leaf_value = torch.where(
        leaf_c > 0, base[:, None] + leaf_y / torch.clamp(leaf_c, min=1e-12), mu[:, None]
    )
    return leaf_value, table_lookup_plain(leaf_value[:, None, :], node)[:, 0]


def leaf_record(leaf_sums, base, mu, node) -> tuple[torch.Tensor, torch.Tensor]:
    """A classifier/regressor chunk's leaf values and every training row's
    value, in one launch.

    leaf_sums (T, L, 2) float32 [count, sum] (any strides: the leaf sums
    as :func:`~.hist.node_sums` returns them), base and mu (T,) float32,
    node (T, n) int32 leaf ids → (leaf_value (T, L), train_vals (T, n)),
    float32: ``leaf_value = count > 0 ? base + sum / max(count, 1e-12) :
    mu`` in float32, the division IEEE-rounded, and ``train_vals[t, row]
    = leaf_value[t, node[t, row]]`` (0 outside [0, L))."""
    _require(leaf_sums.dtype == torch.float32 and leaf_sums.ndim == 3
             and leaf_sums.shape[2] == 2, "leaf_sums must be (T, L, 2) float32")
    n_trees, n_leaves, _ = leaf_sums.shape
    for name, t in (("base", base), ("mu", mu)):
        _require(t.dtype == torch.float32 and t.shape == (n_trees,), f"{name} must be (T,) float32")
    _require(node.dtype == torch.int32 and node.ndim == 2 and node.shape[0] == n_trees,
             "node must be (T, n) int32")
    if _check_device("leaf_record", node, base, mu) == "cpu":
        return leaf_record_plain(leaf_sums, base, mu, node)
    dev = node.device
    _require(leaf_sums.device == dev, "leaf_record inputs must be on one device")
    n = node.shape[1]
    leaf_value = torch.empty((n_trees, n_leaves), dtype=torch.float32, device=dev)
    train_vals = torch.empty((n_trees, n), dtype=torch.float32, device=dev)
    if n_trees == 0:
        return leaf_value, train_vals
    _require(n_trees <= 65535, "leaf_record takes at most 65,535 trees a launch")
    k = build.kernel("leaf_record")
    build.check(k, k.fn(
        leaf_sums.data_ptr(), *leaf_sums.stride(), base.data_ptr(), mu.data_ptr(), n_trees,
        n_leaves, node.data_ptr(), n, leaf_value.data_ptr(), train_vals.data_ptr(),
        _stream(node),
    ))
    leaf_record.launches += 1
    return leaf_value, train_vals


leaf_record.launches = 0
