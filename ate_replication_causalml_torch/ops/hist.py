"""Weighted bin histograms for forest split search.

Port of the dense tree-batched histogram of
``ate_replication_causalml_tpu/ops/hist_pallas.py``:

    hist[t, k, m, f, b] = Σ_row  w[t, k, row] · 1[ids[t, row] = m] · 1[codes[row, f] = b]

T trees share one ``codes`` stream; ids outside ``[0, max_nodes)``
contribute nothing. The JAX package runs this as a Pallas TPU kernel
behind a ``custom_vmap`` rule that folds the grower's per-tree vmap into
the kernel's tree axis; here the tree axis is explicit.

Each public function has a plain PyTorch version (``*_plain``) in this
module. The wrapper runs it for CPU tensors only; for CUDA tensors it
launches the hand-written kernel (``csrc/hist.cu``) or raises. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

The kernel adds a block's rows with shared-memory float atomics, whose
order varies between runs: the sums are exact, and reruns bitwise
equal, only for integer-valued weights. The CUDA path therefore runs
only when the caller passes ``integer_weights=True`` (the classifier's
Poisson counts and counts·y with y in {0, 1}); float weights need an
ordered in-block reduction that is still to be ported (ROADMAP Queue B).
"""

from __future__ import annotations

import torch

from ate_replication_causalml_torch.kernels import build

# Shared memory one block may use on Hopper (227 KB).
_MAX_SMEM_BYTES = 232_448
# Row ranges split the rows only while (trees × features × ranges)
# stays under this many blocks (8 per SM of an H100's 132), so the
# scratch slabs stay a small multiple of the output.
_TARGET_BLOCKS = 1056
_MIN_ROWS_PER_BLOCK = 2048


def check_mode(mode: str) -> None:
    """Only the dense formulation is ported; the partition kernel and
    its packed-codes branch are still to be ported (ROADMAP Queue B)."""
    if mode != "dense":
        raise ValueError(
            f"histogram mode {mode!r} is not ported to the torch package: only "
            "'dense' runs here (the partition kernel and '+pack' are still to be "
            "ported, ROADMAP Queue B)"
        )


def _check_inputs(codes, ids, weights):
    if codes.dtype != torch.int32 or codes.ndim != 2:
        raise TypeError(f"codes must be (n, p) int32, got {codes.dtype} {tuple(codes.shape)}")
    if ids.dtype != torch.int32 or ids.ndim != 2 or ids.shape[1] != codes.shape[0]:
        raise TypeError(f"ids must be (T, n) int32, got {ids.dtype} {tuple(ids.shape)}")
    if (weights.dtype != torch.float32 or weights.ndim != 3
            or weights.shape[0] != ids.shape[0] or weights.shape[2] != codes.shape[0]):
        raise TypeError(
            f"weights must be (T, K, n) float32, got {weights.dtype} {tuple(weights.shape)}"
        )
    if not (codes.device == ids.device == weights.device):
        raise ValueError("codes, ids and weights must lie on one device")


def bin_histogram_batched_plain(codes, ids, weights, max_nodes: int, n_bins: int):
    """The plain PyTorch version: one ``index_add_`` per (tree, channel)."""
    n, p = codes.shape
    n_trees, k_w, _ = weights.shape
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


def _check_cuda(device: torch.device, integer_weights: bool) -> None:
    if not integer_weights:
        raise ValueError(
            "the CUDA histogram kernel is exact and reproducible only for integer-valued "
            "weights: pass integer_weights=True for such weights (float weights need the "
            "ordered in-block reduction, still to be ported, ROADMAP Queue B)"
        )
    if device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {device}")


def _launch(codes, ids, weights, max_nodes: int, n_bins: int, counter) -> torch.Tensor:
    """Launch ``csrc/hist.cu`` on the current stream and add one to
    ``counter.launches``; returns the output."""
    n, p = codes.shape
    n_trees, k_w, _ = weights.shape
    out = torch.empty((n_trees, k_w, max_nodes, p, n_bins), dtype=torch.float32,
                      device=codes.device)
    if n_trees == 0 or n == 0 or p == 0:
        return out.zero_()
    smem = 4 * k_w * max_nodes * n_bins
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"histogram tile K·M·n_bins = {k_w}·{max_nodes}·{n_bins} floats needs "
            f"{smem} B of shared memory, more than a block has ({_MAX_SMEM_BYTES} B)"
        )
    for name, t in (("codes", codes), ("ids", ids), ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_parts = max(1, min(-(-n // _MIN_ROWS_PER_BLOCK), _TARGET_BLOCKS // (n_trees * p)))
    partial = (torch.empty((n_parts,) + tuple(out.shape), dtype=torch.float32,
                           device=codes.device) if n_parts > 1 else out)
    k = build.kernel("hist")
    build.check(k, k.fn(
        codes.data_ptr(), n, p, ids.data_ptr(), weights.data_ptr(), n_trees, k_w,
        max_nodes, n_bins, n_parts, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream,
    ))
    counter.launches += 1
    return out


def bin_histogram_batched(codes, ids, weights, *, max_nodes: int, n_bins: int,
                          mode: str = "dense", integer_weights: bool = False) -> torch.Tensor:
    """Tree-batched histograms: codes (n, p) int32, ids (T, n) int32,
    weights (T, K, n) float32 → (T, K, max_nodes, p, n_bins) float32.
    ``integer_weights=True`` states that every weight is an integer; the
    CUDA path requires it."""
    check_mode(mode)
    _check_inputs(codes, ids, weights)
    if codes.device.type == "cpu":
        return bin_histogram_batched_plain(codes, ids, weights, max_nodes, n_bins)
    _check_cuda(codes.device, integer_weights)
    return _launch(codes, ids, weights, max_nodes, n_bins, bin_histogram_batched)


bin_histogram_batched.launches = 0


def bin_histogram(codes, ids, weights, *, max_nodes: int, n_bins: int,
                  mode: str = "dense", integer_weights: bool = False) -> torch.Tensor:
    """Single-tree case: ids (n,), weights (K, n) → (K, max_nodes, p, n_bins)."""
    return bin_histogram_batched(
        codes, ids[None], weights[None], max_nodes=max_nodes, n_bins=n_bins, mode=mode,
        integer_weights=integer_weights,
    )[0]


def node_sums_plain(ids, weights, num_nodes: int) -> torch.Tensor:
    """The plain version of :func:`node_sums`."""
    codes0 = torch.zeros((ids.shape[1], 1), dtype=torch.int32, device=ids.device)
    h = bin_histogram_batched_plain(codes0, ids, weights, num_nodes, 1)
    return h[:, :, :, 0, 0].transpose(1, 2)


def node_sums(ids, weights, num_nodes: int, *, integer_weights: bool = False) -> torch.Tensor:
    """Per-node weighted sums: ids (T, n) int32, weights (T, K, n) float32
    → (T, num_nodes, K). The degenerate histogram with one constant
    feature and one bin, through the same kernel (``integer_weights`` as
    in :func:`bin_histogram_batched`)."""
    codes0 = torch.zeros((ids.shape[1], 1), dtype=torch.int32, device=ids.device)
    _check_inputs(codes0, ids, weights)
    if ids.device.type == "cpu":
        return node_sums_plain(ids, weights, num_nodes)
    _check_cuda(ids.device, integer_weights)
    h = _launch(codes0, ids, weights, num_nodes, 1, node_sums)
    return h[:, :, :, 0, 0].transpose(1, 2)


node_sums.launches = 0
