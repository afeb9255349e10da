"""Per-row side of forest growth: route bits and leaf lookups.

Port of ``ate_replication_causalml_tpu/ops/tree_pallas.py``:

* :func:`route_bits` — ``bit[t, row] = codes[row, feat[t, id]] > thr[t, id]``
  with ``id = ids[t, row]``; an id outside ``[0, M)`` gives 0;
* :func:`table_lookup` — ``out[t, k, row] = table[t, k, ids[t, row]]``;
  an id outside ``[0, L)`` gives 0.

Both are exact integer selections. The JAX package's
``codes_transposed``/``route_table`` exist only for the TPU's matrix
unit; on the card the kernels read ``codes`` (n, p) directly.

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
    if codes.device.type == "cpu":
        return route_bits_plain(codes, ids, best_feat, best_bin)
    if codes.device.type != "cuda":
        raise ValueError(f"no route kernel for device {codes.device}")
    for t in (codes, ids, best_feat, best_bin):
        _require(t.device == codes.device and t.is_contiguous(),
                 "route_bits inputs must be contiguous, on one device")
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
    if table.device.type == "cpu":
        return table_lookup_plain(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"no lookup kernel for device {table.device}")
    for t in (table, ids):
        _require(t.device == table.device and t.is_contiguous(),
                 "table_lookup inputs must be contiguous, on one device")
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
