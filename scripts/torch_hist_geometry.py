"""Device time of the histogram kernels under other launch geometries.

    python3 scripts/torch_hist_geometry.py > build/hist_geometry.jsonl

The A/B behind the geometry helpers of ``ops/hist.py``: for the dense
kernel, features per block and warps per feature
(``dense_features_per_block``, ``dense_warps_per_feature``); for the
packed pass, node groups (``packed_node_groups``). Each variant replaces
one helper for the call, is held ``torch.equal`` to the default's output
(every geometry gives the same bits), and is timed on the device: ten
calls captured in a CUDA graph and replayed, as ``chip_smoke.py`` times
kernels. Inputs are uniform random codes and ids at the paths' shapes
(16 trees, 21 features, 64 bins) and bench.py's 1,000,000 rows; the
defaults' rows also carry the ``scatter_add_`` yardstick and, for the
packed pass, the unpacked partition kernel on the same inputs. Prints
one JSON line per measurement. It needs a card and imports no JAX. A
development tool: ``chip_smoke.py`` does not run it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ate_replication_causalml_torch.ops import hist, pack  # noqa: E402

N_BINS = 64
DENSE = [(11016, 1, 2, 21), (11016, 16, 2, 21), (11016, 8, 5, 21), (11016, 128, 2, 21),
         (11016, 512, 2, 1), (1_000_000, 128, 2, 21)]  # (n, M, K, p)
PACKED = [(5508, 32, 2), (5508, 64, 2), (5508, 128, 2), (11016, 16, 5), (11016, 32, 5),
          (11016, 64, 5), (11016, 128, 5)]  # (n, M, K)


def device_ms(fn, calls: int = 10, reps: int = 10) -> float:
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (calls * reps)


@contextlib.contextmanager
def helper(name: str, value: int):
    """``hist.<name>`` returns ``value`` inside the block."""
    saved = getattr(hist, name)
    setattr(hist, name, lambda *args: value)
    try:
        yield
    finally:
        setattr(hist, name, saved)


def inputs(rng, n, p, m, k, dev):
    codes = rng.integers(0, N_BINS if p > 1 else 1, size=(n, p)).astype(np.int32)
    ids = rng.integers(-1, m, size=(16, n)).astype(np.int32)
    w = rng.poisson(1.0, size=(16, k, n)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (codes, ids, w))


def yardstick(codes, ids, w, m, n_bins):
    """One ``scatter_add_`` over precomputed flat cell indices."""
    n, p = codes.shape
    t, k = ids.shape[0], w.shape[1]
    dev = codes.device
    cell = (((torch.arange(t, device=dev)[:, None, None, None] * k
              + torch.arange(k, device=dev)[None, :, None, None]) * m
             + ids.long()[:, None, :, None]) * p + torch.arange(p, device=dev)) * n_bins
    cell = cell + codes.long()[None, None]
    sel = ((ids >= 0) & (ids < m))[:, None, :, None].expand(t, k, n, p)
    idx, val = cell[sel], w[:, :, :, None].expand(t, k, n, p)[sel]
    size = t * k * m * p * n_bins
    return lambda: torch.zeros(size, device=dev).scatter_add_(0, idx, val)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_hist_geometry: needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def emit(**row):
        print(json.dumps({"device": torch.cuda.get_device_name(0), **row}), flush=True)

    for n, m, k, p in DENSE:
        n_bins = N_BINS if p > 1 else 1
        codes, ids, w = inputs(rng, n, p, m, k, dev)
        run = lambda: hist.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=n_bins)
        want = run()
        calls = 2 if n > 100_000 else 10
        shape = (k, m, p, n_bins, 16, hist._n_parts(n, 16, p))
        emit(kernel="dense", n=n, M=m, K=k, p=p, features=hist.dense_features_per_block(*shape),
             warps_per_feature=hist.dense_warps_per_feature(*shape), ms=device_ms(run, calls),
             library_ms=device_ms(yardstick(codes, ids, w, m, n_bins), calls))
        if m <= 16 and p > 1:  # features per block, one warp each
            variants = [{"dense_features_per_block": f, "dense_warps_per_feature": 1}
                        for f in (1, 2, 3, 4, 7)]
        else:  # warps per feature
            variants = [{"dense_warps_per_feature": s} for s in (1, 2, 4, 8)]
        for variant in variants:
            with contextlib.ExitStack() as stack:
                for name, value in variant.items():
                    stack.enter_context(helper(name, value))
                if not torch.equal(run(), want):
                    raise AssertionError(f"dense {variant} M={m}: bits differ")
                emit(kernel="dense", n=n, M=m, K=k, p=p, **variant, ms=device_ms(run, calls))

    for n, m, k in PACKED:
        codes, ids, w = inputs(rng, n, 21, m, k, dev)
        words = pack.pack_codes(codes)
        run = lambda: hist.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS,
                                                 mode="partition+pack", packed=words)
        unpacked = lambda: hist.bin_histogram_batched(codes, ids, w, max_nodes=m, n_bins=N_BINS,
                                                      mode="partition")
        want = unpacked()
        groups = hist.packed_node_groups(k, m, N_BINS)
        emit(kernel="packed", n=n, M=m, K=k, node_groups=groups, ms=device_ms(run),
             unpacked_ms=device_ms(unpacked),
             library_ms=device_ms(yardstick(codes, ids, w, m, N_BINS)))
        for g in sorted({max(1, groups // 2), min(m, 2 * groups)} - {groups}):
            if 3 * 4 * k * -(-m // g) * N_BINS > hist._MAX_SMEM_BYTES:
                continue
            with helper("packed_node_groups", g):
                if not torch.equal(run(), want):
                    raise AssertionError(f"packed node_groups={g} M={m} K={k}: bits differ")
                emit(kernel="packed", n=n, M=m, K=k, node_groups=g, ms=device_ms(run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
