#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ate_replication_causalml_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around it; it
imports nothing of JAX. Phases, each printing one JSON line:

1. device  — the card, and ``nvidia-smi``'s name and power limit line;
2. build   — compiles every kernel of ``csrc/`` with nvcc (sm_90a);
3. kernels — each kernel's wrapper on card tensors at the shapes the
   DR-RF path gives it, held against its plain PyTorch version with
   ``torch.equal`` (all three kernels are exact there), with CUDA-event
   times of the kernel, the plain version and a one-call PyTorch
   yardstick, and the least time the card could take (``bound_ms``);
4. path    — the notebook's "Doubly Robust with Random Forest PS" row at
   its configuration (120k-row synthetic pool, 50k-row sample, bias
   injection to 11,016 rows; 2,500 trees of depth 9; sandwich and
   1,000-replicate bootstrap SE), with launch counts read around it;
5. parity  — the same path at 32 trees on the card and on the CPU: split
   tables, leaves and OOB votes equal, τ within a stated bound.

Then the kernel summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Details go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Imported after the path is set; in a directory without the package
# this fails, and the script exits non-zero with no result.
from ate_replication_causalml_torch.data.pipeline import PrepConfig, inject_bias, prepare_dataset  # noqa: E402
from ate_replication_causalml_torch.data.synthetic import make_ggl_like  # noqa: E402
from ate_replication_causalml_torch.estimators.aipw import doubly_robust, outcome_model_mu  # noqa: E402
from ate_replication_causalml_torch.estimators.naive import naive_ate  # noqa: E402
from ate_replication_causalml_torch.kernels import build  # noqa: E402
from ate_replication_causalml_torch.models import forest as fo  # noqa: E402
from ate_replication_causalml_torch.ops import hist, tree  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402
from ate_replication_causalml_torch.ops.bootstrap import _poisson1_counts  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor-core float32; integer compares counted at it too

# The notebook row's configuration (SweepConfig defaults).
POOL_ROWS, POOL_SEED, TRUE_ATE = 120_000, 0, 0.095
DR_TREES, DEPTH, N_BINS, N_BOOT = 2_500, 9, 64, 1_000
PARITY_TREES = 32
BIG_ROWS = 1_000_000  # bench.py's forest rows
# Card vs CPU, τ and sandwich SE: the f32 IRLS and AIPW sums reassociate.
# Observed on an H100 80GB HBM3 at 700 W: |Δτ| 2.46e-7, |Δse| 1.9e-9.
TAU_BOUND = 1e-6

RECORD: dict = {}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    RECORD.setdefault("lines", []).append(obj)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    fn()
    sync()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    sync()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts() -> None:
    hist.bin_histogram_batched.launches = 0
    hist.node_sums.launches = 0
    tree.route_bits.launches = 0
    tree.table_lookup.launches = 0


def read_counts() -> dict:
    return {
        "hist": hist.bin_histogram_batched.launches,
        "node_sums": hist.node_sums.launches,
        "route": tree.route_bits.launches,
        "lookup": tree.table_lookup.launches,
    }


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build_all()
    ptxas = {
        name: [ln.strip() for ln in b.ptxas.splitlines() if "registers" in ln or "spill" in ln]
        for name, b in built.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": max(b.seconds for b in built.values()), "ptxas": ptxas})


def notebook_frames(device: str):
    """The notebook's data: synthetic pool → prepare_dataset → inject_bias."""
    cfg = PrepConfig()
    raw = make_ggl_like(POOL_ROWS, seed=POOL_SEED, true_ate=TRUE_ATE)
    frame = prepare_dataset(raw, cfg, device=device)
    frame_mod, _ = inject_bias(frame, cfg)
    return frame, frame_mod


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item() if got.shape == want.shape else math.inf
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |Δ| {diff})")
    return 0.0


def kernel_cases(codes: torch.Tensor, rng: np.random.Generator, t: int = 16):
    """Inputs at the DR-RF path's shapes: T=16 trees of a chunk, Poisson
    counts and counts·w weights, node ids with the grower's −1 rows."""
    dev = codes.device
    n = codes.shape[0]
    keys = rnd.split(rnd.key(7, device=dev), t)
    counts = _poisson1_counts(keys, (n,))
    wv = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32), device=dev)
    weights = torch.stack([counts, counts * wv], dim=1).contiguous()

    def ids(m: int) -> torch.Tensor:
        a = rng.integers(-1, m, size=(t, n)).astype(np.int32)
        return torch.as_tensor(a, device=dev)

    return weights, ids


def measure_hist(codes, weights, ids, m, reps=20):
    n, p = codes.shape
    t, k, _ = weights.shape
    got = hist.bin_histogram_batched(codes, ids, weights, max_nodes=m, n_bins=N_BINS,
                                     integer_weights=True)
    want = hist.bin_histogram_batched_plain(codes, ids, weights, m, N_BINS)
    err = check_equal(f"hist M={m} n={n}", got, want)
    # One PyTorch call over precomputed flat (tree, channel, node, feature, bin) indices.
    valid = (ids >= 0) & (ids < m)
    cell = (((torch.arange(t, device=codes.device)[:, None, None, None] * k
              + torch.arange(k, device=codes.device)[None, :, None, None]) * m
             + ids.long()[:, None, :, None]) * p
            + torch.arange(p, device=codes.device)) * N_BINS + codes.long()[None, None]
    sel = valid[:, None, :, None].expand(t, k, n, p)
    flat_idx = cell[sel]
    flat_val = weights[:, :, :, None].expand(t, k, n, p)[sel]
    size = got.numel()
    lib_out = torch.zeros(size, device=codes.device).scatter_add_(0, flat_idx, flat_val)
    check_equal(f"hist M={m} scatter_add_", lib_out.view_as(got), want)
    ms = time_ms(lambda: hist.bin_histogram_batched(codes, ids, weights, max_nodes=m, n_bins=N_BINS,
                                                    integer_weights=True), reps)
    plain_ms = time_ms(lambda: hist.bin_histogram_batched_plain(codes, ids, weights, m, N_BINS),
                       max(3, reps // 4))
    library_ms = time_ms(lambda: torch.zeros(size, device=codes.device).scatter_add_(0, flat_idx, flat_val), reps)
    n_valid = int(valid.sum())
    nbytes = 4 * (codes.numel() + ids.numel() + weights.numel() + got.numel())
    b_ms, b_by = bound(nbytes, n_valid * p * k)
    return {"M": m, "n": n, "T": t, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels(frame_mod) -> dict:
    rng = np.random.default_rng(2024)
    x = frame_mod.x
    codes = fo.binarize(x, fo.quantile_bins(x, N_BINS))
    n, p = codes.shape
    weights, ids = kernel_cases(codes, rng)
    t = weights.shape[0]

    hist_rows = [measure_hist(codes, weights, ids(m), m) for m in (1, 2, 4, 8, 16, 32, 64, 128)]
    # bench.py's forest row count: one million rows, at the deepest width.
    big_codes = torch.as_tensor(rng.integers(0, N_BINS, size=(BIG_ROWS, p)).astype(np.int32), device=x.device)
    big_w, big_ids = kernel_cases(big_codes, rng)
    hist_rows.append(measure_hist(big_codes, big_w, big_ids(128), 128, reps=5))
    del big_codes, big_w
    emit({"phase": "kernels", "kernel": "hist", "rows": hist_rows})

    # node_sums: leaf sums at 2^depth leaves.
    leaves = 1 << DEPTH
    leaf_ids = ids(leaves)
    got = hist.node_sums(leaf_ids, weights, leaves, integer_weights=True)
    err = check_equal("node_sums", got, hist.node_sums_plain(leaf_ids, weights, leaves))
    k = weights.shape[1]
    valid = (leaf_ids >= 0) & (leaf_ids < leaves)
    seg = ((torch.arange(t, device=x.device)[:, None, None] * k
            + torch.arange(k, device=x.device)[None, :, None]) * leaves + leaf_ids.long()[:, None, :])
    sel = valid[:, None, :].expand_as(seg)
    seg_idx, seg_val = seg[sel], weights[sel]
    lib = torch.zeros(t * k * leaves, device=x.device).scatter_add_(0, seg_idx, seg_val)
    check_equal("node_sums scatter_add_", lib.view(t, k, leaves).transpose(1, 2), got)
    b_ms, b_by = bound(4 * (leaf_ids.numel() + weights.numel() + got.numel()), int(valid.sum()) * k)
    ns_row = {"M": leaves, "n": n, "T": t, "max_abs_err": err,
              "ms": time_ms(lambda: hist.node_sums(leaf_ids, weights, leaves, integer_weights=True), 20),
              "plain_ms": time_ms(lambda: hist.node_sums_plain(leaf_ids, weights, leaves), 5),
              "library_ms": time_ms(lambda: torch.zeros(t * k * leaves, device=x.device)
                                    .scatter_add_(0, seg_idx, seg_val), 20),
              "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "kernel": "node_sums", "rows": [ns_row]})

    # route: every level width of a depth-9 tree.
    route_rows = []
    for m in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        rid = ids(m)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, m)).astype(np.int32), device=x.device)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, m)).astype(np.int32), device=x.device)
        got = tree.route_bits(codes, rid, feat, thr)
        err = check_equal(f"route M={m}", got, tree.route_bits_plain(codes, rid, feat, thr))
        b_ms, b_by = bound(4 * (codes.numel() + rid.numel() + feat.numel() + thr.numel() + got.numel()),
                           rid.numel())
        route_rows.append({
            "M": m, "n": n, "T": t, "max_abs_err": err,
            "ms": time_ms(lambda: tree.route_bits(codes, rid, feat, thr), 20),
            "plain_ms": time_ms(lambda: tree.route_bits_plain(codes, rid, feat, thr), 20),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernels", "kernel": "route", "rows": route_rows})

    # lookup: the 512-leaf training-row value recording (K = 1).
    table = torch.as_tensor(rng.random((t, 1, leaves)).astype(np.float32), device=x.device)
    lid = ids(leaves)
    got = tree.table_lookup(table, lid)
    err = check_equal("lookup", got, tree.table_lookup_plain(table, lid))
    gidx = lid.long().clamp(0, leaves - 1)[:, None, :]
    b_ms, b_by = bound(4 * (table.numel() + lid.numel() + got.numel()), lid.numel())
    lookup_row = {"M": leaves, "n": n, "T": t, "max_abs_err": err,
                  "ms": time_ms(lambda: tree.table_lookup(table, lid), 20),
                  "plain_ms": time_ms(lambda: tree.table_lookup_plain(table, lid), 20),
                  "library_ms": time_ms(lambda: torch.gather(table, 2, gidx), 20),
                  "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "kernel": "lookup", "rows": [lookup_row]})
    # The deepest main-path width stands for each kernel in the summary.
    return {"hist": hist_rows[7], "node_sums": ns_row, "route": route_rows[-1], "lookup": lookup_row}


def phase_path(frame, frame_mod) -> dict:
    stages = {}
    t0 = time.perf_counter()
    oracle = naive_ate(frame, method="oracle")
    naive = naive_ate(frame_mod)
    sync()
    stages["naive_s"] = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    p_rf = fo.rf_oob_propensity(frame_mod, key=rnd.key(12325, device="cuda"),
                                n_trees=DR_TREES, depth=DEPTH)
    sync()
    stages["forest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu = outcome_model_mu(frame_mod)
    sync()
    stages["outcome_glm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dr = doubly_robust(frame_mod, lambda f: p_rf, mu=mu)
    stages["aipw_sandwich_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dr_boot = doubly_robust(frame_mod, lambda f: p_rf, bootstrap_se=True, n_boot=N_BOOT,
                            key=rnd.key(0, device="cuda"), mu=mu)
    stages["aipw_bootstrap_s"] = time.perf_counter() - t0
    counts = read_counts()

    if tuple(frame_mod.x.shape) != (11_016, 21):
        raise AssertionError(f"biased frame is {tuple(frame_mod.x.shape)}, expected (11016, 21)")
    if p_rf.shape != (frame_mod.n,) or not bool(torch.isfinite(p_rf).all()):
        raise AssertionError("propensity is not a finite (n,) vector")
    for r in (oracle, naive, dr, dr_boot):
        if not (math.isfinite(r.ate) and math.isfinite(r.se) and r.se > 0):
            raise AssertionError(f"{r.method}: non-finite estimate or SE ({r})")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing} ({counts})")
    out = {"phase": "path", "rows": frame_mod.n, "trees": DR_TREES, "depth": DEPTH,
           "oracle": [oracle.ate, oracle.se], "naive": [naive.ate, naive.se],
           "dr_rf_sandwich": [dr.ate, dr.se], "dr_rf_bootstrap": [dr_boot.ate, dr_boot.se],
           "propensity_range": [float(p_rf.min()), float(p_rf.max())],
           "stages": stages, "launches": counts}
    emit(out)
    return counts


def phase_parity(frame_mod) -> None:
    key = rnd.key(12325, device="cuda")
    card = fo.fit_forest_classifier(frame_mod.x, frame_mod.w, key, n_trees=PARITY_TREES, depth=DEPTH)
    cpu_frame = frame_mod.to("cpu")
    host = fo.fit_forest_classifier(cpu_frame.x, cpu_frame.w, key.cpu(), n_trees=PARITY_TREES, depth=DEPTH)
    for f in ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges", "train_fp"):
        if not torch.equal(getattr(card, f).cpu(), getattr(host, f)):
            raise AssertionError(f"card and CPU forests differ in {f}")
    v_card = fo.predict_forest(card, frame_mod.x, oob=True).vote
    v_host = fo.predict_forest(host, cpu_frame.x, oob=True).vote
    if not torch.equal(v_card.cpu(), v_host):
        raise AssertionError("card and CPU OOB votes differ")
    r_card = doubly_robust(frame_mod, lambda f: v_card)
    r_host = doubly_robust(cpu_frame, lambda f: v_host)
    d_tau, d_se = abs(r_card.ate - r_host.ate), abs(r_card.se - r_host.se)
    if not (d_tau <= TAU_BOUND and d_se <= TAU_BOUND):
        raise AssertionError(f"card vs CPU DR: |Δτ| {d_tau}, |Δse| {d_se} > {TAU_BOUND}")
    emit({"phase": "parity", "trees": PARITY_TREES, "forest_equal": True, "votes_equal": True,
          "tau_card": r_card.ate, "tau_cpu": r_host.ate, "abs_dtau": d_tau, "abs_dse": d_se,
          "bound": TAU_BOUND})


SOURCES = {
    "hist": ("ate_replication_causalml_torch/csrc/hist.cu", "ate_replication_causalml_tpu/ops/hist_pallas.py:243"),
    "node_sums": ("ate_replication_causalml_torch/csrc/hist.cu", "ate_replication_causalml_tpu/ops/hist_pallas.py:243"),
    "route": ("ate_replication_causalml_torch/csrc/route.cu", "ate_replication_causalml_tpu/ops/tree_pallas.py:198"),
    "lookup": ("ate_replication_causalml_torch/csrc/lookup.cu", "ate_replication_causalml_tpu/ops/tree_pallas.py:67"),
}


def main() -> int:
    name, smi = phase_device()
    phase_build()
    frame, frame_mod = notebook_frames("cuda")
    timing = phase_kernels(frame_mod)
    counts = phase_path(frame, frame_mod)
    phase_parity(frame_mod)
    kernels = []
    for k, (src, rep) in SOURCES.items():
        row = timing[k]
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        "launches": counts[k], "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    RECORD["kernels"] = kernels
    RECORD["nvidia_smi"] = smi
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
