"""Device time of the histogram kernels under other launch geometries.

    python3 scripts/torch_hist_geometry.py > build/hist_geometry.jsonl
    python3 scripts/torch_hist_geometry.py --only partition
    python3 scripts/torch_hist_geometry.py --only partition --repo DIR

The A/B behind the geometry helpers of ``ops/hist.py``: for the dense
kernel, features per block and warps per feature
(``dense_features_per_block``, ``dense_warps_per_feature``); for the
packed pass, node groups (``packed_node_groups``); for the unpacked
partition pass, its row ranges summed in one thread-block cluster against
one partial slab per range and a second pass
(``partition_cluster_ranges``). Each variant replaces one helper for the
call, is held ``torch.equal`` to the default's output (every geometry
gives the same bits), and is timed on the device with ``chip_smoke.py``'s
``device_ms``: ten calls captured in a CUDA graph and replayed. The dense
and packed inputs are uniform random codes and ids at the paths' shapes
(16 trees, 21 features, 64 bins) and bench.py's 1,000,000 rows; the
defaults' rows also carry the ``scatter_add_`` yardstick and, for the
packed pass, the unpacked partition kernel on the same inputs. The
partition section runs on the notebook's codes (the biased 11,016 × 21
frame, 64 bins) with uniform ids, 16 trees, K=2 Poisson counts at
M=32/64/128 and the K=5 shared moment channels at M=16/32/64, and splits
each call's device time by kernel (``partition_rows``,
``partition_gather``, ``partition_accumulate``, ``hist_reduce``) with
``chip_smoke.py``'s ``stage_ms`` (``torch.profiler``). ``--repo DIR``
imports the package from another checkout (an earlier commit unpacked
with ``git archive``, for the split before a change) and times only its
default partition call and that split, through the public wrappers.
Prints one JSON line per measurement. It needs a card and imports no
JAX. A development tool: ``chip_smoke.py`` does not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _package_root() -> str:
    """The checkout to import the package from: ``--repo`` or this one."""
    if "--repo" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--repo") + 1])
    return ROOT


sys.path.insert(0, _package_root())

from ate_replication_causalml_torch.data.pipeline import PrepConfig, inject_bias, prepare_dataset  # noqa: E402
from ate_replication_causalml_torch.data.synthetic import make_ggl_like  # noqa: E402
from ate_replication_causalml_torch.models import forest as fo  # noqa: E402
from ate_replication_causalml_torch.ops import hist, pack  # noqa: E402


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module, for its timing
    helpers; the package it imports is the one already imported above."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_smoke = _chip_smoke()
device_ms, stage_ms = _smoke.device_ms, _smoke.stage_ms

N_BINS = 64
DENSE = [(11016, 1, 2, 21), (11016, 16, 2, 21), (11016, 8, 5, 21), (11016, 128, 2, 21),
         (11016, 512, 2, 1), (1_000_000, 128, 2, 21)]  # (n, M, K, p)
PACKED = [(5508, 32, 2), (5508, 64, 2), (5508, 128, 2), (11016, 16, 5), (11016, 32, 5),
          (11016, 64, 5), (11016, 128, 5)]  # (n, M, K)
PARTITION = [(2, 32), (2, 64), (2, 128), (5, 16), (5, 32), (5, 64)]  # (K, M)


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


def dense_section(rng, dev, emit) -> None:
    """Features per block and warps per feature of the dense kernel."""
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


def packed_section(rng, dev, emit) -> None:
    """Node groups of the packed pass."""
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


def notebook_codes(dev) -> torch.Tensor:
    """The biased notebook frame's 64-bin codes, (11,016, 21)."""
    frame = prepare_dataset(make_ggl_like(120_000, seed=0), PrepConfig(), device=dev)
    x = inject_bias(frame, PrepConfig())[0].x
    return fo.binarize(x, fo.quantile_bins(x, N_BINS))


def partition_section(rng, dev, emit, variants: bool) -> None:
    """The unpacked partition pass at the paths' widths: device time and
    stage split of the default geometry, then (with ``variants``) its
    ``scatter_add_`` yardstick and the slab form, bitwise equal to the
    default."""
    codes = notebook_codes(dev)
    n, p = codes.shape
    counts = torch.as_tensor(rng.poisson(1.0, size=(16, n)).astype(np.float32), device=dev)
    y = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32), device=dev)
    wt = torch.as_tensor((rng.random(n) - 0.5).astype(np.float32), device=dev)
    yt = torch.as_tensor((rng.random(n) * 2 - 1).astype(np.float32), device=dev)
    per_tree = torch.stack([counts, counts * y], dim=1).contiguous()
    moments = torch.stack([torch.ones_like(wt), wt, yt, wt * wt, wt * yt]).contiguous()
    n_parts = hist._n_parts(n, 16, p)
    for k, m in PARTITION:
        ids = torch.as_tensor(rng.integers(-1, m, size=(16, n)).astype(np.int32), device=dev)
        shared = k == 5
        w = moments if shared else per_tree
        wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
        run = lambda: wrapper(codes, ids, w, max_nodes=m, n_bins=N_BINS, mode="partition")
        row = dict(kernel="partition", n=n, M=m, K=k, ranges=n_parts, weights="float" if shared
                   else "integer", ms=device_ms(run), stage_ms=stage_ms(run))
        if not variants:
            emit(**row)
            continue
        emit(**row, cluster=hist.partition_cluster_ranges(n_parts),
             library_ms=device_ms(yardstick(codes, ids, w.expand(16, k, n) if shared else w, m,
                                            N_BINS)))
        want = run()
        with helper("partition_cluster_ranges", 1):  # the slab form
            if not torch.equal(run(), want):
                raise AssertionError(f"partition slab form K={k} M={m}: bits differ")
            emit(kernel="partition", n=n, M=m, K=k, partition_cluster_ranges=1, ms=device_ms(run),
                 stage_ms=stage_ms(run))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("dense", "packed", "partition"), default=None,
                    help="run one section (default: all three)")
    ap.add_argument("--repo", default=None,
                    help="import the package from this checkout; partition: its default call "
                         "and stage split alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_hist_geometry: needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    repo = _package_root()

    def emit(**row):
        print(json.dumps({"device": torch.cuda.get_device_name(0), "repo": repo, **row}),
              flush=True)

    if args.only in (None, "dense"):
        dense_section(rng, dev, emit)
    if args.only in (None, "packed"):
        packed_section(rng, dev, emit)
    if args.only in (None, "partition"):
        partition_section(rng, dev, emit, args.repo is None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
