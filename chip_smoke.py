#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ate_replication_causalml_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around it; it
imports nothing of JAX. Phases, each printing one JSON line:

1. device  — the card, and ``nvidia-smi``'s name and power limit line;
2. build   — compiles every kernel library of ``csrc/`` with nvcc (sm_90a)
   and records each device function's registers and spill bytes from
   ptxas; fails if ``hist_dense``, ``partition_accumulate`` or
   ``partition_accumulate_packed`` (any K) spills;
3. kernels — each kernel's wrapper on card tensors at the shapes the
   DR-RF, causal forest and DML paths give it, held against its plain
   PyTorch version: ``torch.equal`` on integer weights, on route, lookup
   and pack, 64·eps·Σ|w| per (tree, channel) on float weights, and two
   launches ``torch.equal`` to each other; with CUDA-event times of the
   kernel, the plain version and a one-call PyTorch yardstick, and the
   least time the card could take (``bound_ms``), and ``factor`` = kernel
   ms / yardstick ms. ``ms`` is device time (a CUDA graph of 10 calls
   replayed, ``device_ms``); ``call_ms`` one call timed from the host,
   launch gaps included (the method of PRs 1–3). Dense, partition and the packed pass
   (``partition+pack``) are timed at every width and must give the same
   bits, K=2 integer and K=5 float; the packed rows report their slots
   and node groups per block, the partition rows their row ranges per
   cluster, features per block and ``cudaOccupancyMaxActiveClusters``,
   and the partition passes' first step (``hist.partition_sort``: the
   sort and the gather into perm order) is held ``torch.equal`` to its
   plain version at every width. The fused row passes of ``ops/tree.py``:
   ``route_advance`` at every grow width (with and without a mask, and
   the last level), ``traverse`` at the causal predict chunk and at DML's
   forest apply (leaf ids and payload), ``leaf_record`` at a classifier
   chunk, each ``torch.equal`` to its plain version, two launches equal,
   and timed beside the PyTorch sequence it replaces (``replaced_ms``,
   one replayed graph of the old route and lookup kernels and the
   elementwise ops around them). The coordinate-descent kernel
   (``ops/lasso.py::cd_path``, ``csrc/lasso.cu``) at the shapes
   the LASSO and balancing rows give it, its inputs captured from the rows' own
   ``cv_glmnet`` calls: within ``CD_PATH_BOUND`` of its plain version,
   two launches equal, bounded by the recurrence's floor (``bound_ms``)
   with the chain of the whole-dot-product order beside it
   (``order_chain_ms``).
   ``pack_words`` beside its yardstick, the JAX package's own form of
   the step: one ``torch.matmul`` of the float32 codes by the pack
   matrix. The launch floor: a one-element PyTorch op in the same
   graph-replay harness, beside ``pack_words``;
4. path    — the notebook's "Doubly Robust with Random Forest PS" row at
   its configuration (120k-row synthetic pool, 50k-row sample, bias
   injection to 11,016 rows; 2,500 trees of depth 9; sandwich and
   1,000-replicate bootstrap SE), with launch counts read around it and
   τ held to its recorded value (``DR_TAU``); each path's counts of the
   row kernels are held to the counts derived from its configuration
   (``ROW_LAUNCHES``);
5. parity  — the same path at 32 trees on the card and on the CPU: split
   tables, leaves and OOB votes equal, τ within a stated bound;
6. path_cf — the notebook's "Causal Forest(GRF)" row through
   ``causal_forest_report`` at the sweep's configuration (2,000 causal
   trees of depth 8, 500 nuisance trees of depth 9, the sweep's key),
   with stage times and launch counts read around it and the ATE and SE
   held to their recorded values (``CF_ATE``, ``CF_SE``);
6b. path_serve — the CATE serving daemon (``serving/``) on the causal
   row's forest (fit again with path_cf's key): ``save_fitted`` into
   ``build/chip_smoke_serve/``, ``CateServer(ServeConfig(...)).startup()``
   on the card (buckets 1,8,64,256, a 2 ms window, depth 64: one CUDA
   graph a bucket), ``SERVE_REQUESTS`` requests of real covariate rows
   (sizes cycling through ``SERVE_SIZES``) from ``SERVE_PRODUCERS``
   threads through ``submit``, ``SERVE_SEQUENTIAL`` one at a time (the
   per-bucket latency), ``SERVE_WIRE`` through the port's client over
   ``serve_socket``, a burst past the admission depth (typed
   ``overloaded`` rejects) and a ``SERVE_CHAOS`` run (the planned
   faults, degraded mode, verified reloads); every served row bit for
   bit the offline ``predict_cate(forest, x, oob=False)`` on the card,
   ``traverse`` held to its plain version at the serving shapes and
   launched ``traverse_per_replay`` times a replay (warm-up, warm and
   every batch), no kernel build and no graph capture after warm
   (``stop()`` asserts it); prints the startup phases, p50/p99 latency
   per bucket, rows/s, the close reasons and the card's name and power
   limit;
7. parity_cf — the same row at 32 causal and 32 nuisance trees on the
   card and on the CPU, held to stated bounds (split agreement, leaf
   statistics, τ̂ and its variance, the ATE and its SE);
8. path_cf_packed — the causal row again under the packed-code policy
   (``ATE_TPU_PREDICT_PACK=1``: its partition levels take the packed
   pass): the ATE and SE bit for bit those of path_cf, and the 32-tree
   forest of parity_cf grown again under the policy ``torch.equal`` to it;
9. path_dml — the notebook's "Double Machine Learning" row through
   ``double_ml`` at the sweep's configuration (2,000 trees of depth 9 per
   nuisance forest, the sweep's key, ``crossfit="r"``, ``se_mode="r"``)
   under ``ATE_TPU_PREDICT_PACK=1``, with stage times and launch counts,
   τ and SE held to their recorded values (``DML_TAU``, ``DML_SE``);
10. parity_dml — the DML row at 32 trees three ways: packed on the card,
   unpacked on the card, and on the CPU: forests and vote fractions
   ``torch.equal``, τ and SE bit for bit between the card runs and
   within ``TAU_BOUND`` of the CPU's;
10b. path_leaf_index — ``predict_cate``'s ``leaf_index`` and ``row_chunk``
   options on parity_cf's 32-tree card forest: ``compute_leaf_index``
   (``traverse``, leaf ids) and ``predict_cate(leaf_index=…)`` (the lookup
   kernel), with and without a ``row_chunk``, bit for bit the plain call;
11. path_ipw — the Direct Method, Propensity_Weighting,
   Propensity_Regression and "Doubly Robust with logistic regression PS"
   rows on the card (no kernel of their own), with τ, SE and the
   card-vs-CPU differences;
11b. path_lasso — the four LASSO rows (Propensity_Weighting_LASSOPS,
   Single-equation LASSO, Usual LASSO, Belloni et.al) at the sweep's
   configuration on the card and on the CPU port: fold ids held to the
   JAX package's digests, every ``cv_glmnet``'s selected indices to the
   JAX package's, τ and SE to the JAX package's values within stated
   bounds, card against CPU within the same bounds, stage walls and the
   CD kernel's launches (one per gaussian CV, Belloni's two in one, and
   one per IRLS iteration of the binomial one);
11c. path_balance — the residual_balancing row at the sweep's configuration
   (its key, 12,000 ADMM iterations) on the card and on the CPU port: each
   arm's rows, ADMM iterations, worst residual, QP and CV walls and
   cd_path launches (one an arm); fold ids and index_min held to the JAX
   package's (``BALANCE_FOLDS``, ``BALANCE_INDEX``), τ and SE to
   ``BALANCE_JAX`` and card to CPU within ``BALANCE_BOUND``;
11d. path_sweep — the whole notebook through ``pipeline.run_sweep`` at
   ``SweepConfig()`` on the card (its default device), with the
   sequential scheduler, under
   ``ATE_TPU_PREDICT_PACK=1``: every row held to the pin its phase holds
   (the oracle and naive rows to path's, DR-RF to ``SWEEP_DR_TAU``, the
   causal and DML rows bit for bit, the LASSO rows to ``LASSO_JAX``, the
   IPW rows to path_ipw's CPU rows, residual_balancing to
   ``BALANCE_JAX``), each row's wall, the kernels' launches
   (``launches_by_path["sweep"]``, row kernels to ``ROW_LAUNCHES``),
   report.json and REPORT.md parsed; then the same call again on the same
   directory: all 14 records resumed, 0 computed, 0 launches, the same
   rows;
11e. path_sweep_concurrent — the same sweep with the default scheduler
   (the concurrent engine, its default worker count, one CUDA stream a
   worker) into a fresh directory: every record bit for bit path_sweep's,
   every kernel's launches equal, ``results.jsonl``'s lines (seconds
   aside) in the same order, the pins of path_sweep held; then a
   sequential rerun on this directory and a concurrent one on
   path_sweep's, each resuming all 14 records with 0 computed and 0
   launches. Prints both walls, the worker count, each node's start and
   end offsets (the engine's spans), the overlap (the rows' and nuisances'
   seconds over the wall) and the prefetch lane's outcome. Both sweeps'
   telemetry files (``metrics.json``, ``events.jsonl``, ``metrics.prom``,
   ``trace.json``, ``overlap_report.json``) are read with plain json and
   checked (a ``sweep_stage`` span a record with the report's status,
   ``sweep_stage_total`` equal to the rows computed, each lane's busy time
   within the wall, the critical path done by the last commit,
   ``device_memory_bytes`` recorded), and their ``overlap_report.json``
   printed: the critical path, each lane's busy and wait, the sampler's
   samples and period, beside the walls;
11f. path_sweep_chaos — path_sweep's directory copied without the
   journal lines of two light rows (``CHAOS_ROWS``), swept under
   ``ATE_TPU_CHAOS=CHAOS_SPEC`` (one stage fault, one torn append): one
   failed row, the injections the spec predicts, every other record
   resumed; then a clean sweep: the torn line counted, both rows
   recomputed bit for bit path_sweep's, with their share of the launches;
12. stages  — each partition row's device time by kernel (``stage_ms``:
   the sort, the gather, the accumulate pass and any second pass, from
   ``torch.profiler``) and the device activities of one ADMM iteration,
   late: a process that has run the profiler
   launches kernels more slowly afterwards;
13. path_xprof — ``ATE_TPU_XPROF`` at ``SweepConfig().quick()``, last: a
   quick sweep, then its directory without ``XPROF_ROWS``' journal lines
   swept again under the whole-run ``torch.profiler`` capture with the
   default scheduler: the knob forces the sequential sweep, the Chrome
   trace holds each recomputed row's ``record_function`` range and
   launches of ``XPROF_KERNELS``, the rows equal the quick sweep's.

Then the kernel summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. Details go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Imported after the path is set; in a directory without the package
# this fails, and the script exits non-zero with no result.
from ate_replication_causalml_torch import observability as obs  # noqa: E402
from ate_replication_causalml_torch import pipeline  # noqa: E402
from ate_replication_causalml_torch.data.pipeline import PrepConfig, inject_bias, prepare_dataset  # noqa: E402
from ate_replication_causalml_torch.data.synthetic import make_ggl_like  # noqa: E402
from ate_replication_causalml_torch.estimators.aipw import (  # noqa: E402
    doubly_robust,
    doubly_robust_glm,
    outcome_model_mu,
)
from ate_replication_causalml_torch.estimators import balance  # noqa: E402
from ate_replication_causalml_torch.estimators import belloni as bel  # noqa: E402
from ate_replication_causalml_torch.estimators import lasso_est  # noqa: E402
from ate_replication_causalml_torch.estimators.causal_forest_est import causal_forest_report  # noqa: E402
from ate_replication_causalml_torch.estimators import dml  # noqa: E402
from ate_replication_causalml_torch.estimators.ipw import (  # noqa: E402
    logistic_propensity,
    prop_score_ols,
    prop_score_weight,
)
from ate_replication_causalml_torch.estimators.naive import naive_ate  # noqa: E402
from ate_replication_causalml_torch.estimators.ols import ate_condmean_ols  # noqa: E402
from ate_replication_causalml_torch.kernels import build  # noqa: E402
from ate_replication_causalml_torch.models import causal_forest as cf  # noqa: E402
from ate_replication_causalml_torch.models import forest as fo  # noqa: E402
from ate_replication_causalml_torch.ops import hist, lasso, pack, qp, tree  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402
from ate_replication_causalml_torch.ops.bootstrap import _poisson1_counts  # noqa: E402
from ate_replication_causalml_torch.ops.linalg import alias_filter  # noqa: E402
from ate_replication_causalml_torch.resilience import chaos  # noqa: E402
from ate_replication_causalml_torch.serving.client import CateClient  # noqa: E402
from ate_replication_causalml_torch.serving.coalescer import BucketPlan  # noqa: E402
from ate_replication_causalml_torch.serving.daemon import (  # noqa: E402
    CateServer,
    RejectedRequest,
    ServeConfig,
    serve_socket,
)
from ate_replication_causalml_torch.utils.checkpoint import save_fitted  # noqa: E402

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
# The DR-RF row's τ as first recorded on the card (the atomic histogram
# kernel): integer histogram weights are exact in any order, so the
# ordered kernels must give it bit for bit.
DR_TAU = 0.0028399527072906494
# The "Causal Forest(GRF)" row (SweepConfig: cf_trees, cf_nuisance_trees,
# forest_depth for the nuisances; grow_causal_forest's depth 8, 64 bins,
# ci_group_size 2, min_node 5, sample_fraction 0.5, honesty on).
CF_TREES, CF_DEPTH, CF_NUISANCE_TREES = 2_000, 8, 500
CF_PARITY_TREES = 32
# Float histogram sums: the kernel adds each cell's rows in ascending
# order per row range, the plain version (index_add_, float atomics on
# the card) in its own order: |Δ| ≤ FLOAT_ULPS·eps·Σ|w| per (tree,
# channel). Observed on an H100 80GB HBM3 at 700 W: at most 8.6·eps·Σ|w|
# (K=5 shared, M=1, the w̃² channel, where a binary covariate puts about
# a quarter of the rows in one cell).
FLOAT_ULPS = 64
EPS32 = float(np.finfo(np.float32).eps)
# Card vs CPU port, causal row at 32 trees (see phase_parity_cf).
# Observed on an H100 80GB HBM3 at 700 W: split agreement 0.99277, leaf
# statistics on agreeing paths 3.5e-6 relative, τ̂ 0.117 and variance
# 0.040 relative at the worst row, |ΔATE| 3.1e-4, |ΔSE| 1.7e-5.
CF_SPLIT_AGREEMENT = 0.97
CF_LEAF_REL = 2e-5
CF_TAU_BOUND = 0.5
CF_TAU_MEAN_BOUND = 0.01
CF_ATE_BOUND = 2e-3
CF_SE_BOUND = 1e-4
# The causal row's ATE as first recorded on the card with the ordered
# kernels; every kernel and reduction on its path runs in a fixed order,
# so it must hold bit for bit, under the packed policy too.
CF_ATE = 0.10669395327568054
CF_SE = 0.014757290482521057
# The "Double Machine Learning" row (SweepConfig: dml_trees, forest_depth).
DML_TREES = 2_000
DML_PARITY_TREES = 32
# The DML row's τ and SE as first recorded on the card (packed policy):
# integer histogram weights and fixed-order reductions, so bit for bit.
DML_TAU = 0.07885216176509857
DML_SE = 0.010522110387682915
# Direct Method and the propensity rows, card vs CPU port: f32 IRLS and
# normal equations in another summation order, amplified by 1/(p(1−p)).
# Observed on an H100 80GB HBM3 at 700 W: |Δτ| at most 6.0e-7
# (Propensity_Regression), |Δse| at most 3.7e-9.
IPW_BOUND = 5e-6
# The LASSO rows as the JAX package computes them on the CPU at this
# configuration (float32; ``JAX_PLATFORMS=cpu python scripts/torch_parity.py
# --rows lasso``, its "jax" side): fold ids (sha256 of the int64 ids, first
# 16 hex digits) and (index_min, index_1se) of each cv_glmnet, τ and SE.
LASSO_FOLDS = {"ps_lasso": "87afa6469388dd4d", "seq_lasso": "b35183f89db90569",
               "usual_lasso": "19317ecdbe296609", "belloni_xw": "da74d1dde33fa74b",
               "belloni_xy": "65104c64398d10f7"}
LASSO_INDEX = {"ps_lasso": (35, 17), "seq_lasso": (47, 25), "usual_lasso": (46, 27),
               "belloni_xw": (41, 30), "belloni_xy": (35, 23)}
LASSO_JAX = {"Propensity_Weighting_LASSOPS": (-0.005371916573494673, 0.01176401600241661),
             "Single-equation LASSO": (0.08433466404676437, math.nan),
             "Usual LASSO": (0.044370125979185104, math.nan),
             "Belloni et.al": (0.10991007089614868, 0.01186330895870924)}
# |Δτ| and |ΔSE| against LASSO_JAX, and card against CPU port. The
# coordinate descent stops once max_j G_jj·Δβ_j² < 1e-7, so two runs whose
# dot products round differently can stop a sweep apart: path coefficients
# then differ by up to ~sqrt(1e-7)·ys/xs (the CPU port against the JAX
# package: 6.3e-6 on the two p = 22 paths, 6.8e-5 on the binomial one).
# The outcome rows read W's coefficient (|Δτ| 3.9e-6 seen); LASSOPS
# carries the binomial path through 1/(p(1−p)) (1.2e-5 seen); Belloni's τ
# is an OLS on the selected support, held equal, so only the f32 OLS
# remains (5.2e-7 seen).
LASSO_BOUND = {"Propensity_Weighting_LASSOPS": 1e-4, "Single-equation LASSO": 5e-5,
               "Usual LASSO": 5e-5, "Belloni et.al": 1e-5}
# The residual_balancing row (SweepConfig.balance_iters ADMM iterations)
# as the JAX package computes it on the CPU at this configuration
# (float32 frame, float64 ADMM; ``JAX_PLATFORMS=cpu python
# scripts/torch_parity.py --rows balance``, its "jax" side): each arm's fold
# ids (digest as LASSO_FOLDS) and index_min, τ and SE. The JAX package's
# ADMM stops the treated arm (2,077 rows) at 729 iterations, the control
# arm (8,939 rows) at 284.
BALANCE_ITERS = 12_000
BALANCE_FOLDS = {"treated": "d8d0cda7590799bb", "control": "973ba1d3fb4f0653"}
BALANCE_INDEX = {"treated": 37, "control": 44}
BALANCE_JAX = (0.10578039288520813, 0.013546153903007507)
# |Δτ| and |ΔSE| against BALANCE_JAX, and card against CPU port. γ is the
# float64 ADMM iterate, which stops at the first iteration with both
# residuals under 1e-7 (the treated arm 5e-12 under it), so a stop an
# iteration apart moves γ by about the tolerance; the target is a float32
# mean summed in another order (37 ulps, 1.1e-8 here); and the arm's
# elastic net comes from coordinate descent that stops a sweep apart
# (LASSO_BOUND's reason: path coefficients up to ~6e-6 apart). μ = target·β
# + γ·resid is first-order insensitive to β where γ balances X, so the
# bound is LASSO_BOUND's order. Seen: the CPU port against the JAX package
# |Δτ| 2.7e-7, |ΔSE| 0.
BALANCE_BOUND = 5e-5
# The sweep's "Doubly Robust with Random Forest PS" row: its forest's key
# is the sweep's fold_in(key(0), crc32("dr_rf_prop")), not DR_TAU's
# key(12325); τ as first recorded on the card (integer histogram weights
# and fixed-order reductions, so bit for bit).
SWEEP_DR_TAU = 0.04571865499019623
# The sweep's output directories (the results journal, report.json,
# REPORT.md): path_sweep's sequential run and path_sweep_concurrent's.
SWEEP_OUT = os.path.join(REPO, "build", "chip_smoke_sweep")
SWEEP_CONC_OUT = os.path.join(REPO, "build", "chip_smoke_sweep_concurrent")
SWEEP_CHAOS_OUT = os.path.join(REPO, "build", "chip_smoke_sweep_chaos")
XPROF_OUT = os.path.join(REPO, "build", "chip_smoke_xprof")
# The telemetry files run_sweep(outdir=...) writes beside report.json.
TELEMETRY = ("metrics.json", "events.jsonl", "metrics.prom", "trace.json", "overlap_report.json")
# path_sweep_chaos: two light rows dropped from path_sweep's journal, the
# second made to fail and the first's append torn. Their share of the
# launches: one cd_path each (the path_lasso phase's per-row counts).
CHAOS_ROWS = ("Single-equation LASSO", "Usual LASSO")
CHAOS_SPEC = "stage:fail=Usual LASSO;fs:torn_write"
CHAOS_ROWS_LAUNCHES = {"cd_path": 2}
# path_xprof: the rows recomputed under the whole-run profiler at
# SweepConfig().quick(), kept small: the quick balancing row's ADMM takes
# 2,623 iterations of ~1,220 kernels (CPU port count), too many events
# for one Chrome trace.
XPROF_ROWS = ("Direct Method", "Doubly Robust with Random Forest PS")
XPROF_KERNELS = ("route_advance_kernel", "hist_dense")
# The CD kernel against its plain version at the rows' inputs (threshold
# 1e-7): a standardized coefficient's last move is below sqrt(1e-7/G_jj)
# ≈ 3.2e-4 (G_jj ≈ 1), so two runs that stop a sweep apart differ by about
# that; 3× for the geometric tail of the following λs' warm starts.
CD_PATH_BOUND = 1e-3
# Belloni's path is compared with the plain version on two windows of
# λs only (the plain version is ~12 launches per coordinate update at p =
# 462): the first λs, where almost every coefficient is 0, and λs 50–59,
# warm-started from the kernel's λ 49, where the 138-column support forms.
CD_PLAIN_WINDOWS = ((0, 10), (50, 60))
# The CD kernel's floor (csrc/lasso.cu): each update depends on the one
# before, and the recurrence itself needs 11 dependent steps an update at
# any p: the fused multiply-add of the newest coordinate's term, c_j − s,
# + G_jj·β_j, the soft threshold's subtract and max, copysign, and a
# division of at least 5. Each is taken at the float32 pipe's 4-cycle
# dependent-issue latency, at the card's maximum SM clock (nvidia-smi
# clocks.max.sm), times the longest fit's updates.
RECURRENCE_STEPS = 11
CHAIN_CYCLES_PER_STEP = 4
# The chain of the order that keeps G_j·β whole on it (the kernel's first
# form), printed beside it as ``order_chain_ms``:
# G_j·β summed whole on the chain, ceil(p/32) fused multiply-adds, a
# 5-step butterfly of a shuffle and an add (10), and the scalar update
# with β_j's store and load across the warp barrier (12).
CHAIN_FIXED_STEPS = 10 + 12

# path_serve: the daemon at its defaults (buckets 1,8,64,256, a 2 ms window,
# depth 64) on path_cf's forest; request sizes cycle so every bucket
# serves; 4 producer threads, then requests one at a time (each rides its
# own bucket: the per-bucket latency), the port's client over a socket,
# one burst past the admission depth, one chaos run of SERVE_CHAOS.
SERVE_BUCKETS = "1,8,64,256"
SERVE_SIZES = (1, 3, 8, 17, 64, 100, 256)
SERVE_REQUESTS, SERVE_PRODUCERS, SERVE_SEQUENTIAL = 504, 4, 56
SERVE_WIRE, SERVE_CHAOS_REQUESTS = 24, 40
SERVE_CHAOS = "serve:p=0.25,seed=11"
SERVE_CKPT = os.path.join(REPO, "build", "chip_smoke_serve", "forest.npz")

RECORD: dict = {}
# Rows of the path phases that the sweep's rows are held to.
ROWS: dict = {}


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


def capture(fn, calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in one CUDA graph (after a warm-up
    call on the current and on a side stream), replayed once."""
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
    sync()
    return graph


def device_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times between two events, so no host launch gap
    enters (``time_ms`` times one call from the host, gaps included)."""
    graph = capture(fn, calls)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    sync()
    return a.elapsed_time(b) / (calls * reps)


# Device functions a histogram call launches, in match order (a name may
# contain an earlier one).
STAGES = ("partition_accumulate_packed", "partition_accumulate", "partition_rows",
          "partition_gather", "hist_reduce", "hist_dense")


# (partition row, its call): profiled by phase_stages, after the paths,
# because a process that has run torch.profiler launches kernels more
# slowly afterwards, and the paths' walls would show it.
SPLITS: list = []


def stage_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel one call of ``fn`` launches, by
    device function (``STAGES``; anything else as "other"): device
    activities from ``torch.profiler`` over one replay of a CUDA graph of
    ``calls`` calls ("source": "graph"), or over ``calls`` calls launched
    one by one where the trace shows no kernel of the graph ("eager")."""
    graph = capture(fn, calls)

    def profiled(run) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            sync()
        us: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = next((st for st in STAGES if st in e.name), "other")
                us[name] = us.get(name, 0.0) + e.time_range.elapsed_us()
        return us

    us, source = profiled(graph.replay), "graph"
    if not any(st in us for st in STAGES):
        us, source = profiled(lambda: [fn() for _ in range(calls)]), "eager"
    return {"source": source, **{k: v / 1e3 / calls for k, v in sorted(us.items())}}


def timed(row: dict, run, lib, calls: int = 10) -> dict:
    """The device times of a kernel call and its yardstick, and their
    ratio ``factor``; ``call_ms`` and ``call_library_ms`` are one call's
    host-side event times (the method of PRs 1–3's tables)."""
    ms, library_ms = device_ms(run, calls), device_ms(lib, calls)
    row.update(ms=ms, library_ms=library_ms, factor=ms / library_ms)
    return row


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


COUNTERS = {  # kernel name -> (wrapper, its counter for that kernel)
    "hist": (hist.bin_histogram_batched, "launches"),
    "hist_partition": (hist.bin_histogram_batched, "partition_launches"),
    "hist_shared": (hist.bin_histogram_shared, "launches"),
    "hist_partition_shared": (hist.bin_histogram_shared, "partition_launches"),
    "node_sums": (hist.node_sums, "launches"),
    "node_sums_shared": (hist.node_sums_shared, "launches"),
    "route": (tree.route_bits, "launches"),
    "lookup": (tree.table_lookup, "launches"),
    "hist_partition_packed": (hist.bin_histogram_batched, "packed_launches"),
    "hist_partition_shared_packed": (hist.bin_histogram_shared, "packed_launches"),
    "pack_codes": (pack.pack_codes, "launches"),
    "route_advance": (tree.route_advance, "launches"),
    "traverse": (tree.traverse, "launches"),
    "leaf_record": (tree.leaf_record, "launches"),
    "cd_path": (lasso.cd_path, "launches"),
}

# Launches of the row kernels each path must make, from its configuration
# (16-tree chunks; 2,000 causal trees in 125 chunks of 8 two-tree groups;
# predict_cate in 32-tree chunks):
#   route_advance: one per level of every chunk — DR-RF 157 chunks x 9;
#     causal 2 x 32 nuisance chunks x 9 + 125 x 8; DML 4 x 125 x 9;
#   leaf_record: one per classifier/regressor chunk — 157; 64; 500;
#   traverse: one per predict_cate chunk (63) and per forest_apply (4).
# The per-level route and the lookup kernels are off these paths (0);
# the lookup kernel serves predict_cate(leaf_index=...) (path_leaf_index:
# the leaf ids once, then the row_chunk and the two index calls).
ROW_LAUNCHES = {
    "dr_rf": {"route_advance": 1413, "traverse": 0, "leaf_record": 157, "route": 0, "lookup": 0},
    "causal_forest": {"route_advance": 1576, "traverse": 63, "leaf_record": 64, "route": 0,
                      "lookup": 0},
    "dml": {"route_advance": 4500, "traverse": 4, "leaf_record": 500, "route": 0, "lookup": 0},
    # path_leaf_index: one 32-tree chunk, every row in one launch (the
    # leaf ids and a row_chunk call: traverse; two calls through the ids).
    "leaf_index": {"route_advance": 0, "traverse": 2, "leaf_record": 0, "route": 0, "lookup": 2},
}
ROW_LAUNCHES["causal_forest_packed"] = ROW_LAUNCHES["causal_forest"]
# The sweep runs the DR-RF, causal and DML forests once each.
ROW_LAUNCHES["sweep"] = {k: sum(ROW_LAUNCHES[p][k] for p in ("dr_rf", "causal_forest", "dml"))
                         for k in ROW_LAUNCHES["dr_rf"]}
# cd_path launches of the LASSO rows (LASSOPS 160 IRLS iterations, one
# each for Single-equation, Usual and Belloni) and of residual_balancing
# (one an arm).
CD_LAUNCHES = {"lasso": 163, "balance": 2}


PACKED_KERNELS = ("hist_partition_packed", "hist_partition_shared_packed", "pack_codes")
# The JAX package's per-level route and lookup kernels, which the paths
# no longer call (ROW_LAUNCHES holds them at 0 there).
OLD_ROW_KERNELS = ("route", "lookup")
# The LASSO rows' kernel, off the forest paths.
LASSO_KERNELS = ("cd_path",)
UNPACKED_KERNELS = tuple(k for k in COUNTERS
                         if k not in PACKED_KERNELS + OLD_ROW_KERNELS + LASSO_KERNELS)


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def require_launched(counts: dict, names, path: str) -> None:
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing} ({counts})")


def require_row_launches(counts: dict, path: str) -> None:
    """The row kernels' counts on ``path`` equal ROW_LAUNCHES[path]."""
    want = ROW_LAUNCHES[path]
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"row kernel launches on the {path} path: {got}, derived {want}")


@contextlib.contextmanager
def env(name: str, value: str):
    """``name=value`` in the environment for the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def packed_policy():
    """``ATE_TPU_PREDICT_PACK=1`` for the block; the old value restored in
    a finally (an exception in the block propagates)."""
    return env(pack.ENV_PACK, "1")


def require_unpacked(counts: dict, path: str) -> None:
    """The default policy ("auto" packing resolves to unpacked) launches
    no packed kernel."""
    if any(counts[k] for k in PACKED_KERNELS):
        raise AssertionError(f"packed kernels launched on the {path} path under the default "
                             f"policy: {counts}")


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


# Device functions of csrc/, as ptxas names them (mangled); K is the
# template argument of the histogram kernels.
DEVICE_FUNCTIONS = ("partition_accumulate_packed", "partition_accumulate", "partition_rows",
                    "partition_gather", "hist_dense", "hist_reduce", "pack_words", "route_kernel",
                    "lookup_kernel", "route_advance_kernel", "traverse_kernel", "leaf_record_kernel",
                    "cd_path_kernel", "cd_path_small_kernel")
# Kernels that must not spill (every instantiation).
NO_SPILL = ("hist_dense", "partition_accumulate_packed", "partition_accumulate")


def ptxas_functions(log: str) -> dict:
    """``nvcc -Xptxas -v`` → {"name<K>": {registers, stack, spill_bytes}}."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            mangled = ln.split("'")[1] if "'" in ln else ln.rsplit(" ", 1)[-1]
            base = next((b for b in DEVICE_FUNCTIONS if b in mangled), mangled)
            if base + "ILi" in mangled:
                k = mangled.split(base + "ILi", 1)[1].split("E", 1)[0]
            else:     # other template arguments, as mangled (cd_path_kernel<float, true, 1>: fLb1ELi1E)
                k = mangled.split(base + "I", 1)[1].split("Ev", 1)[0] if base + "I" in mangled else None
            name = f"{base}<{k}>" if k else base
            out.setdefault(name, {})
        elif name and "spill stores" in ln:
            nums = [int(x) for x in ln.replace(",", " ").split() if x.isdigit()]
            out[name].update(stack=nums[0], spill_bytes=nums[1] + nums[2])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used", 1)[1].split()[0])
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = build.build_all()
    functions = {}
    for b in {b.library: b for b in built.values()}.values():
        functions.update(ptxas_functions(b.ptxas))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": max(b.seconds for b in built.values()), "functions": functions})
    spilled = {f: v for f, v in functions.items()
               if f.split("<")[0] in NO_SPILL and v.get("spill_bytes", 0)}
    missing = [b for b in NO_SPILL if not any(f.startswith(b + "<") for f in functions)]
    if spilled or missing:
        raise AssertionError(f"ptxas spills {spilled}, or no instantiation of {missing}")
    return functions


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


def moment_channels(n: int, rng: np.random.Generator, dev) -> torch.Tensor:
    """The causal path's five float channels [1, w̃, ỹ, w̃², w̃ỹ], (5, n),
    with residual-like w̃ ∈ (−0.5, 0.5) and ỹ ∈ (−1, 1)."""
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = (rng.random(n) * 2 - 1).astype(np.float32)
    return torch.as_tensor(np.stack([np.ones(n, np.float32), wt, yt, wt * wt, wt * yt]), device=dev)


def check_float(name: str, got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> tuple[float, float]:
    """|got − want| ≤ FLOAT_ULPS·eps·scale everywhere; returns (max |Δ|,
    max |Δ| / bound)."""
    diff = (got.double() - want.double()).abs()
    lim = FLOAT_ULPS * EPS32 * scale.double()
    ratio = float((diff / lim.clamp(min=1e-300)).max())
    if not bool((diff <= lim).all()):
        raise AssertionError(f"{name}: kernel outside {FLOAT_ULPS}·eps·Σ|w| of its plain version "
                             f"(max |Δ| {float(diff.max())}, {ratio:.3g} of the bound)")
    return float(diff.max()), ratio


def hist_library(codes, ids, weights, m):
    """One ``scatter_add_`` over precomputed flat (tree, channel, node,
    feature, bin) indices: the one-call yardstick (index construction
    not timed). ``weights`` (T, K, n) or (K, n) shared."""
    n, p = codes.shape
    t = ids.shape[0]
    w = weights if weights.ndim == 3 else weights.expand(t, *weights.shape)
    k = w.shape[1]
    dev = codes.device
    valid = (ids >= 0) & (ids < m)
    cell = (((torch.arange(t, device=dev)[:, None, None, None] * k
              + torch.arange(k, device=dev)[None, :, None, None]) * m
             + ids.long()[:, None, :, None]) * p
            + torch.arange(p, device=dev)) * N_BINS + codes.long()[None, None]
    sel = valid[:, None, :, None].expand(t, k, n, p)
    flat_idx = cell[sel]
    flat_val = w[:, :, :, None].expand(t, k, n, p)[sel]
    size = t * k * m * p * N_BINS
    return lambda: torch.zeros(size, device=dev).scatter_add_(0, flat_idx, flat_val).view(t, k, m, p, N_BINS)


def measure_hist(codes, weights, ids, m, mode="dense", shared=False, reps=20):
    """One histogram case: the kernel against its plain version (exact
    for integer weights, within FLOAT_ULPS·eps·Σ|w| for float ones), two
    launches bitwise equal, times and bound."""
    n, p = codes.shape
    t = ids.shape[0]
    k = weights.shape[-2]
    wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
    run = lambda: wrapper(codes, ids, weights, max_nodes=m, n_bins=N_BINS, mode=mode)
    plain = lambda: hist.bin_histogram_batched_plain(codes, ids, weights, m, N_BINS)
    got, again = run(), run()
    want = plain()
    integer = bool(torch.equal(weights, weights.round()))
    name = f"hist{'_shared' if shared else ''} {mode} M={m} T={t} K={k} n={n}"
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    lib = hist_library(codes, ids, weights, m)
    if integer:
        err, ratio = check_equal(name, got, want), 0.0
        check_equal(f"{name} scatter_add_", lib(), want)
    else:
        scale = weights.abs().sum(dim=-1)
        scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
        err, ratio = check_float(name, got, want, scale)
        check_float(f"{name} scatter_add_", lib(), want, scale)
    n_valid = int(((ids >= 0) & (ids < m)).sum())
    nbytes = 4 * (codes.numel() + ids.numel() + weights.numel() + got.numel())
    b_ms, b_by = bound(nbytes, n_valid * p * k)
    row = {"M": m, "n": n, "T": t, "K": k, "mode": mode, "weights": "integer" if integer else "float",
           "max_abs_err": err, "err_over_bound": ratio, "call_ms": time_ms(run, reps),
           "call_library_ms": time_ms(lib, reps), "plain_ms": time_ms(plain, max(3, reps // 4)),
           "bound_ms": b_ms, "bound_by": b_by, "out": got}
    return timed(row, run, lib, 2 if n > 100_000 else 10)


def measure_packed(codes, weights, ids, m, shared, reps=20):
    """One case of the packed pass: ``torch.equal`` to the unpacked
    partition kernel on the same inputs, two launches equal, against the
    plain version (exact for integer weights, FLOAT_ULPS·eps·Σ|w| for
    float ones); times of both kernels, the plain version and the
    ``scatter_add_`` yardstick; the bound counts the packed words, ids,
    weights and output bytes (each once)."""
    n, p = codes.shape
    t = ids.shape[0]
    k = weights.shape[-2]
    wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
    words = pack.pack_codes(codes)
    run = lambda: wrapper(codes, ids, weights, max_nodes=m, n_bins=N_BINS, mode="partition+pack",
                          packed=words)
    unpacked = lambda: wrapper(codes, ids, weights, max_nodes=m, n_bins=N_BINS, mode="partition")
    plain = lambda: hist.bin_histogram_packed_plain(codes, ids, weights, m, N_BINS, words)
    got, again, ref = run(), run(), unpacked()
    name = f"hist{'_shared' if shared else ''} partition+pack M={m} T={t} K={k} n={n}"
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: not bitwise equal to the unpacked partition kernel")
    want = plain()
    integer = bool(torch.equal(weights, weights.round()))
    lib = hist_library(codes, ids, weights, m)
    if integer:
        err, ratio = check_equal(name, got, want), 0.0
    else:
        scale = weights.abs().sum(dim=-1)
        scale = (scale if scale.ndim == 2 else scale[None])[:, :, None, None, None]
        err, ratio = check_float(name, got, want, scale)
    n_valid = int(((ids >= 0) & (ids < m)).sum())
    b_ms, b_by = bound(4 * (words.numel() + ids.numel() + weights.numel() + got.numel()),
                       n_valid * p * k)
    row = {"M": m, "n": n, "T": t, "K": k, "mode": "partition+pack",
           "weights": "integer" if integer else "float",
           "slots_per_block": hist.packed_slots(k, m, N_BINS),
           "node_groups": hist.packed_node_groups(k, m, N_BINS), "equal_to_unpacked": True,
           "max_abs_err": err, "err_over_bound": ratio, "call_ms": time_ms(run, reps),
           "call_library_ms": time_ms(lib, reps), "call_unpacked_ms": time_ms(unpacked, reps),
           "unpacked_ms": device_ms(unpacked), "plain_ms": time_ms(plain, max(3, reps // 4)),
           "bound_ms": b_ms, "bound_by": b_by, "perm_bytes": 4 * t * n}
    return timed(row, run, lib)


def pack_matrix(p: int, dev) -> torch.Tensor:
    """The JAX package's pack matrix (``hist_pallas.py:433``): (p, ceil(p/3))
    float32, column f // 3 of row f holding 128^(f % 3)."""
    f = torch.arange(p, device=dev)
    mat = torch.zeros((p, pack.packed_width(p)), dtype=torch.float32, device=dev)
    mat[f, f // pack.PACK_SLOTS] = (float(pack.PACK_RADIX) ** (f % pack.PACK_SLOTS)).float()
    return mat


def pack_row(codes, reps=20):
    """The pack kernel against its plain version at the path's codes; its
    yardstick is the JAX package's own form of the step (``hist_pallas.py:441``),
    one ``torch.matmul`` of the float32 codes (made outside the timed call)
    by the pack matrix, whose exact integer result must equal the words."""
    words = pack.pack_codes(codes)
    err = check_equal("pack_codes", words, pack.pack_codes_plain(codes))
    if not torch.equal(pack.unpack_codes(words, codes.shape[1]), codes):
        raise AssertionError("pack_codes: the words do not unpack to the codes")
    codes_f, mat = codes.float(), pack_matrix(codes.shape[1], codes.device)
    lib = lambda: torch.matmul(codes_f, mat)
    check_equal("pack_codes (matmul yardstick)", lib().to(torch.int32), words)
    b_ms, b_by = bound(4 * (codes.numel() + words.numel()), codes.numel())
    row = {"n": codes.shape[0], "p": codes.shape[1], "max_abs_err": err,
           "call_ms": time_ms(lambda: pack.pack_codes(codes), reps),
           "plain_ms": time_ms(lambda: pack.pack_codes_plain(codes), reps),
           "bound_ms": b_ms, "bound_by": b_by}
    return timed(row, lambda: pack.pack_codes(codes), lib)


def node_sums_row(ids, weights, leaves, shared, reps=20):
    t = ids.shape[0]
    wrapper = hist.node_sums_shared if shared else hist.node_sums
    run = lambda: wrapper(ids, weights, leaves)
    plain = lambda: hist.node_sums_plain(ids, weights, leaves)
    got, again = run(), run()
    want = plain()
    name = f"node_sums{'_shared' if shared else ''} M={leaves}"
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    w = weights if weights.ndim == 3 else weights.expand(t, *weights.shape)
    k = w.shape[1]
    dev = ids.device
    valid = (ids >= 0) & (ids < leaves)
    seg = ((torch.arange(t, device=dev)[:, None, None] * k
            + torch.arange(k, device=dev)[None, :, None]) * leaves + ids.long()[:, None, :])
    sel = valid[:, None, :].expand_as(seg)
    seg_idx, seg_val = seg[sel], w[sel]
    lib = lambda: torch.zeros(t * k * leaves, device=dev).scatter_add_(0, seg_idx, seg_val).view(
        t, k, leaves).transpose(1, 2)
    if shared:
        scale = weights.abs().sum(dim=1)[None, None, :]
        err, ratio = check_float(name, got, want, scale)
        check_float(f"{name} scatter_add_", lib(), want, scale)
    else:
        err, ratio = check_equal(name, got, want), 0.0
        check_equal(f"{name} scatter_add_", lib(), got)
    b_ms, b_by = bound(4 * (ids.numel() + weights.numel() + got.numel()), int(valid.sum()) * k)
    row = {"M": leaves, "n": ids.shape[1], "T": t, "K": k, "max_abs_err": err,
           "err_over_bound": ratio, "call_ms": time_ms(run, reps), "call_library_ms": time_ms(lib, reps),
           "plain_ms": time_ms(plain, 5), "bound_ms": b_ms, "bound_by": b_by}
    return timed(row, run, lib)


def check_sort(ids, weights, m, n_parts) -> None:
    """The partition passes' first step, ``hist.partition_sort`` (the sort
    into perm and seg, and the gather of each position's node and weights
    into perm order), ``torch.equal`` to ``partition_sort_plain`` on every
    position it writes. Its kernels are timed within the partition rows
    (``stage_ms``: ``partition_rows``, ``partition_gather``)."""
    got = hist.partition_sort(ids, m, n_parts, weights)
    want = hist.partition_sort_plain(ids, m, n_parts, weights)
    written = want[0] >= 0
    name = f"partition_sort M={m} K={weights.shape[-2]}"
    check_equal(f"{name} seg", got[1], want[1])
    check_equal(f"{name} perm", got[0][written], want[0][written])
    check_equal(f"{name} node_sorted", got[2][written], want[2][written])
    check_equal(f"{name} w_sorted", got[3].transpose(1, 2)[written],
                want[3].transpose(1, 2)[written])


# Grow widths of a depth-9 tree: route_advance's and route's rows.
WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def check_same(name: str, pairs) -> None:
    """``torch.equal`` on every (got, want) pair."""
    for i, (got, want) in enumerate(pairs):
        check_equal(f"{name} [{i}]", got, want)


def advance_rows(codes, rng, t: int = 16) -> list:
    """``route_advance`` at every grow width, unmasked (classifier levels)
    and masked (causal levels), and the two last levels (width 256
    unmasked, 128 masked): the ids and both advanced streams against the
    plain version and between two launches; device times of the kernel
    and of the sequence it replaces (route, ``node_int * 2 + bit``,
    ``node_rev + bit * M``, the next level's ``where``, the mask's
    ``where``). Timed on a frozen table (every row reads its code and
    goes left), so repeated in-place calls keep every id in range: the
    same bytes as a real level."""
    dev = codes.device
    n, p = codes.shape
    mask = torch.as_tensor(rng.random((t, n)) < 0.5, device=dev)
    cases = [(m, msk, False) for m in WIDTHS for msk in (None, mask)]
    cases += [(256, None, True), (128, mask, True)]
    rows = []
    for m, msk, last in cases:
        ni0 = torch.as_tensor(rng.integers(0, m, size=(t, n)).astype(np.int32), device=dev)
        nr0 = torch.as_tensor(rng.integers(0, m, size=(t, n)).astype(np.int32), device=dev)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, m)).astype(np.int32), device=dev)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, m)).astype(np.int32), device=dev)
        outs = []
        for fn in (tree.route_advance, tree.route_advance, tree.route_advance_plain):
            ni, nr = ni0.clone(), nr0.clone()
            outs.append((fn(codes, ni, nr, feat, thr, msk, last), ni, nr))
        name = f"route_advance M={m} mask={msk is not None} last={last}"
        check_same(name + " (two launches)", zip(outs[0], outs[1]))
        err = check_same(name, zip(outs[0], outs[2])) or 0.0
        frozen = torch.full_like(thr, N_BINS - 1)
        ti, tr = ni0.clone(), nr0.clone()

        def replaced(m=m, msk=msk, last=last):
            bit = tree.route_bits(codes, tr, feat, frozen)
            ni2 = ti * 2 + bit
            nr2 = tr + bit * m
            ids = ni2 if last else torch.where(ni2 % 2 == 0, nr2, -1)
            return (ids if msk is None else torch.where(msk, ids, -1)), ni2, nr2

        run = lambda: tree.route_advance(codes, ti, tr, feat, frozen, msk, last)
        plain = lambda: tree.route_advance_plain(codes, ti, tr, feat, frozen, msk, last)
        nbytes = 4 * codes.numel() + 8 * feat.numel() + 20 * t * n + (t * n if msk is not None else 0)
        b_ms, b_by = bound(nbytes, t * n)
        ms = device_ms(run)
        rows.append({"M": m, "n": n, "T": t, "mask": msk is not None, "last": last,
                     "max_abs_err": err, "ms": ms, "call_ms": time_ms(run, 20),
                     "plain_ms": time_ms(plain, 20), "replaced_ms": device_ms(replaced),
                     "library_ms": None, "factor": None, "bound_ms": b_ms, "bound_by": b_by})
    return rows


def traverse_rows(codes, rng) -> list:
    """``traverse`` at the causal predict chunk (32 trees of depth 8, the
    5-channel payload, and the leaf ids) and at DML's forest apply (2,000
    trees of depth 9, the leaf value, and the leaf ids), against the plain
    version and between two launches, with the device time of the
    sequence it replaces (a route launch, the slice copies and
    ``node * 2 + bit`` per level, then the transposed payload's copy and
    a lookup launch)."""
    dev = codes.device
    n, p = codes.shape
    rows = []
    for t, depth, k in ((32, CF_DEPTH, 5), (32, CF_DEPTH, None), (DML_TREES, DEPTH, 1),
                        (DML_TREES, DEPTH, None)):
        width = 1 << (depth - 1)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, depth, width)).astype(np.int32), device=dev)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, depth, width)).astype(np.int32),
                              device=dev)
        table = None if k is None else torch.as_tensor(
            rng.random((t, 1 << depth, k)).astype(np.float32), device=dev)
        run = lambda: tree.traverse(codes, feat, thr, table)
        plain = lambda: tree.traverse_plain(codes, feat, thr, table)

        def replaced(t=t, depth=depth, feat=feat, thr=thr, table=table):
            node = torch.zeros((t, n), dtype=torch.int32, device=dev)
            for level in range(depth):
                m = 1 << level
                node = node * 2 + tree.route_bits(codes, node, feat[:, level, :m].contiguous(),
                                                  thr[:, level, :m].contiguous())
            return node if table is None else tree.table_lookup(table.transpose(1, 2).contiguous(),
                                                                node)

        got, again = run(), run()
        name = f"traverse T={t} depth={depth} K={k}"
        check_equal(name + " (two launches)", got, again)
        err = check_equal(name, got, plain())
        check_equal(name + " (replaced sequence)", got, replaced())
        # The split tables' live nodes only: level a reads its first 2^a.
        nbytes = (4 * (got.numel() + codes.numel() + (0 if table is None else table.numel()))
                  + 8 * t * ((1 << depth) - 1))
        b_ms, b_by = bound(nbytes, t * n * depth)
        calls = 2 if t > 100 else 10
        rows.append({"T": t, "n": n, "depth": depth, "K": k, "output": "payload" if k else "leaf ids",
                     "max_abs_err": err,
                     "ms": device_ms(run, calls), "call_ms": time_ms(run, 10),
                     "plain_ms": time_ms(plain, 5), "replaced_ms": device_ms(replaced, calls),
                     "library_ms": None, "factor": None, "bound_ms": b_ms, "bound_by": b_by})
        del got, again
    return rows


def leaf_record_rows(weights, ids, t: int = 16) -> list:
    """``leaf_record`` at a classifier chunk (16 trees, 512 leaves, the
    leaf sums as node_sums returns them on the card), binary (base 0) and
    continuous (base = the tree's mean) targets: both outputs
    ``torch.equal`` to the plain version and to the grower's old
    sequence (the leaf values in PyTorch's CUDA ops: the division
    IEEE-rounded on both sides), two launches equal; device times of the
    kernel and that sequence."""
    leaves = 1 << DEPTH
    node = ids(leaves)
    ls = hist.node_sums(node, weights, leaves)
    dev = node.device
    mu = torch.rand(t, device=dev, generator=torch.Generator(dev).manual_seed(3))
    rows = []
    for center in (0.0, 1.0):
        base = center * mu

        def replaced(base=base):
            leaf_c, leaf_y = ls[..., 0], ls[..., 1]
            lv = torch.where(leaf_c > 0, base[:, None] + leaf_y / torch.clamp(leaf_c, min=1e-12),
                             mu[:, None])
            return lv, tree.table_lookup(lv[:, None, :].contiguous(), node)[:, 0]

        run = lambda: tree.leaf_record(ls, base, mu, node)
        plain = lambda: tree.leaf_record_plain(ls, base, mu, node)
        name = f"leaf_record center={center}"
        got = run()
        check_same(name + " (two launches)", zip(got, run()))
        err = check_same(name, zip(got, plain())) or 0.0
        check_same(name + " (replaced sequence)", zip(got, replaced()))
        nbytes = 4 * (ls.numel() + 2 * t + 2 * node.numel() + t * leaves)
        b_ms, b_by = bound(nbytes, 2 * t * leaves)
        rows.append({"T": t, "L": leaves, "n": node.shape[1], "center": center,
                     "empty_leaves": int((ls[..., 0] == 0).sum()), "max_abs_err": err,
                     "ms": device_ms(run), "call_ms": time_ms(run, 20), "plain_ms": time_ms(plain, 20),
                     "replaced_ms": device_ms(replaced), "library_ms": None, "factor": None,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows


def strip(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "out"}


def phase_kernels(frame_mod) -> dict:
    rng = np.random.default_rng(2024)
    x = frame_mod.x
    codes = fo.binarize(x, fo.quantile_bins(x, N_BINS))
    n, p = codes.shape
    weights, ids = kernel_cases(codes, rng)
    words = pack.pack_codes(codes)
    t = weights.shape[0]
    summary = {}

    def both_modes(w, m, shared):
        """Dense, partition and the packed pass on one input, bitwise equal
        to each other. All three are timed at every width (the path takes
        partition from the crossover up), so that a later PR can re-derive
        the crossover."""
        lid = ids(m)
        d = measure_hist(codes, w, lid, m, shared=shared)
        q = measure_hist(codes, w, lid, m, mode="partition", shared=shared)
        wrapper = hist.bin_histogram_shared if shared else hist.bin_histogram_batched
        run = lambda: wrapper(codes, lid, w, max_nodes=m, n_bins=N_BINS, mode="partition+pack",
                              packed=words)
        packed, again = run(), run()
        q["equal_to_dense"] = bool(torch.equal(q["out"], d["out"]))
        q["packed_equal_to_dense"] = bool(torch.equal(packed, d["out"]) and torch.equal(again, packed))
        if not (q["equal_to_dense"] and q["packed_equal_to_dense"]):
            raise AssertionError(f"M={m} K={w.shape[-2]}: partition or packed not bitwise equal "
                                 f"to dense ({q['equal_to_dense']}, {q['packed_equal_to_dense']})")
        q["packed_ms"] = device_ms(run)
        q["packed_factor"] = q["packed_ms"] / q["library_ms"]
        # The unpacked pass's geometry (one feature per block), its first
        # step against the plain version, and where its device time goes.
        n_parts = hist._n_parts(n, t, p)
        check_sort(lid, w, m, n_parts)
        q.update(ranges=n_parts, cluster=hist.partition_cluster_ranges(n_parts),
                 features_per_block=1, sort_equal_to_plain=True,
                 max_active_clusters=hist.partition_max_active_clusters(
                     n, t, w.shape[-2], m, p, N_BINS))
        # Its stage split is profiled after the paths (phase_stages).
        row = strip(q)
        SPLITS.append((row, lambda: wrapper(codes, lid, w, max_nodes=m, n_bins=N_BINS,
                                            mode="partition")))
        return strip(d), row

    # Per-tree weights, K=2 integer (classifier and nuisance levels).
    hist_rows, part_rows = map(list, zip(*(both_modes(weights, m, False)
                                           for m in (1, 2, 4, 8, 16, 32, 64, 128))))
    # bench.py's forest row count: one million rows, at the deepest width.
    big_codes = torch.as_tensor(rng.integers(0, N_BINS, size=(BIG_ROWS, p)).astype(np.int32), device=x.device)
    big_w, big_ids = kernel_cases(big_codes, rng)
    hist_rows.append(strip(measure_hist(big_codes, big_w, big_ids(128), 128, reps=5)))
    del big_codes, big_w
    # The float path of the per-tree kernel (a continuous target's
    # centered counts·y), at the deepest width.
    yc = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=x.device)
    wf = torch.stack([weights[:, 0], weights[:, 0] * yc], dim=1).contiguous()
    float_row = strip(measure_hist(codes, wf, ids(128), 128))
    # The T = 1 case (the single-tree _hist_kernel) at the deepest width.
    t1_ids = ids(128)[:1].contiguous()
    t1_row = strip(measure_hist(codes, weights[:1].contiguous(), t1_ids, 128))
    emit({"phase": "kernels", "kernel": "hist", "rows": hist_rows, "float": float_row, "t1": t1_row})
    emit({"phase": "kernels", "kernel": "hist_partition", "rows": part_rows})
    summary["hist"] = hist_rows[4]             # M=16: the deepest dense width under "auto" (K=2)
    summary["hist_partition"] = part_rows[7]   # M=128
    summary["hist_t1"] = t1_row

    # Shared weights, K=5 float (the causal levels), widths 1–64, and 128.
    mom = moment_channels(n, rng, x.device)
    sh_rows, shp_rows = map(list, zip(*(both_modes(mom, m, True)
                                        for m in (1, 2, 4, 8, 16, 32, 64, 128))))
    emit({"phase": "kernels", "kernel": "hist_shared", "rows": sh_rows})
    emit({"phase": "kernels", "kernel": "hist_partition_shared", "rows": shp_rows})
    summary["hist_shared"] = sh_rows[3]             # M=8: the deepest dense width under "auto" (K=5)
    summary["hist_partition_shared"] = shp_rows[6]  # M=64

    # The packed pass: K=2 integer at the DML path's shape (one fold of
    # 5,508 rows, T=16) at its partition widths; K=5 float shared at the
    # causal path's (11,016 rows), M=16–64 on the path and M=128.
    fold = codes[: n // 2].contiguous()
    fold_w, fold_ids = kernel_cases(fold, rng)
    pk_rows = [measure_packed(fold, fold_w, fold_ids(m), m, False) for m in (32, 64, 128)]
    pks_rows = [measure_packed(codes, mom, ids(m), m, True) for m in (16, 32, 64, 128)]
    emit({"phase": "kernels", "kernel": "hist_partition_packed", "rows": pk_rows})
    emit({"phase": "kernels", "kernel": "hist_partition_shared_packed", "rows": pks_rows})
    summary["hist_partition_packed"] = pk_rows[2]         # M=128
    summary["hist_partition_shared_packed"] = pks_rows[2]  # M=64, the causal path's deepest
    summary["pack_codes"] = pack_row(fold)
    # The launch floor: a one-element PyTorch op in the same harness.
    one = torch.zeros(1, device=x.device)
    summary["pack_codes"]["launch_floor_ms"] = device_ms(lambda: one.add_(1.0))
    emit({"phase": "kernels", "kernel": "pack_codes", "rows": [summary["pack_codes"]]})
    emit({"phase": "kernels", "kernel": "launch_floor", "op": "one.add_(1.0), one float32",
          "device_ms": summary["pack_codes"]["launch_floor_ms"],
          "pack_words_ms": summary["pack_codes"]["ms"]})

    # Leaf sums: 512 leaves, K=2 integer (DR-RF); 256 leaves, K=5 float (causal).
    summary["node_sums"] = node_sums_row(ids(1 << DEPTH), weights, 1 << DEPTH, shared=False)
    summary["node_sums_shared"] = node_sums_row(ids(1 << CF_DEPTH), mom, 1 << CF_DEPTH, shared=True)
    emit({"phase": "kernels", "kernel": "node_sums", "rows": [summary["node_sums"]]})
    emit({"phase": "kernels", "kernel": "node_sums_shared", "rows": [summary["node_sums_shared"]]})

    # route: every level width of a depth-9 tree.
    route_rows = []
    for m in WIDTHS:
        rid = ids(m)
        feat = torch.as_tensor(rng.integers(0, p, size=(t, m)).astype(np.int32), device=x.device)
        thr = torch.as_tensor(rng.integers(0, N_BINS, size=(t, m)).astype(np.int32), device=x.device)
        got = tree.route_bits(codes, rid, feat, thr)
        err = check_equal(f"route M={m}", got, tree.route_bits_plain(codes, rid, feat, thr))
        b_ms, b_by = bound(4 * (codes.numel() + rid.numel() + feat.numel() + thr.numel() + got.numel()),
                           rid.numel())
        route_rows.append({
            "M": m, "n": n, "T": t, "max_abs_err": err,
            "ms": device_ms(lambda: tree.route_bits(codes, rid, feat, thr)),
            "call_ms": time_ms(lambda: tree.route_bits(codes, rid, feat, thr), 20),
            "plain_ms": time_ms(lambda: tree.route_bits_plain(codes, rid, feat, thr), 20),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernels", "kernel": "route", "rows": route_rows})
    summary["route"] = route_rows[-1]

    # lookup: the 512-leaf training-row value recording (K = 1) and the
    # causal leaf payload (K = 5, 256 leaves, 32 trees of a predict chunk).
    lookup_rows = []
    for tt_, kk, leaves in ((t, 1, 1 << DEPTH), (32, 5, 1 << CF_DEPTH)):
        table = torch.as_tensor(rng.random((tt_, kk, leaves)).astype(np.float32), device=x.device)
        lid = torch.as_tensor(rng.integers(-1, leaves, size=(tt_, n)).astype(np.int32), device=x.device)
        got = tree.table_lookup(table, lid)
        err = check_equal("lookup", got, tree.table_lookup_plain(table, lid))
        gidx = lid.long().clamp(0, leaves - 1)[:, None, :].expand(tt_, kk, n)
        b_ms, b_by = bound(4 * (table.numel() + lid.numel() + got.numel()), got.numel())
        row = {"M": leaves, "n": n, "T": tt_, "K": kk, "max_abs_err": err,
               "call_ms": time_ms(lambda: tree.table_lookup(table, lid), 20),
               "plain_ms": time_ms(lambda: tree.table_lookup_plain(table, lid), 20),
               "bound_ms": b_ms, "bound_by": b_by}
        lookup_rows.append(timed(row, lambda: tree.table_lookup(table, lid),
                                 lambda: torch.gather(table, 2, gidx)))
    emit({"phase": "kernels", "kernel": "lookup", "rows": lookup_rows})
    summary["lookup"] = lookup_rows[0]

    # The fused row passes.
    adv = advance_rows(codes, rng)
    emit({"phase": "kernels", "kernel": "route_advance", "rows": adv})
    summary["route_advance"] = adv[-4]          # M=256, unmasked: the classifier's deepest level
    trav = traverse_rows(codes, rng)
    emit({"phase": "kernels", "kernel": "traverse", "rows": trav})
    summary["traverse"] = trav[0]               # the causal predict chunk's payload
    rec = leaf_record_rows(weights, ids)
    emit({"phase": "kernels", "kernel": "leaf_record", "rows": rec})
    summary["leaf_record"] = rec[0]

    cd = cd_rows(frame_mod)
    emit({"phase": "kernels", "kernel": "cd_path", "rows": cd})
    summary["cd_path"] = cd[0]                  # Usual LASSO's path: plain timed on it whole
    return summary


class _Recorder:
    """Stands in for ``lasso.cd_path``: records each call's inputs and
    calls the wrapper; its ``launches`` is the wrapper's own counter (the
    wrapper counts through the module name it is looked up by)."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, *a, **k):
        self.seen.append((a, k))
        return self.fn(*a, **k)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value


@contextlib.contextmanager
def cd_capture():
    """Record the inputs of every ``lasso.cd_path`` call made in the block
    (``ops/lasso.py`` looks the name up at each call)."""
    fn = lasso.cd_path
    lasso.cd_path = _Recorder(fn)
    try:
        yield lasso.cd_path.seen
    finally:
        lasso.cd_path = fn


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def event_ms(fn):
    """``fn()`` once between two CUDA events → (its result, ms)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    a.record()
    out = fn()
    b.record()
    sync()
    return out, a.elapsed_time(b)


def cd_inputs(frame_mod) -> list:
    """The CD kernel's inputs at the shapes the LASSO and balancing rows
    give it, captured from the rows' own CV calls: Usual LASSO's path (11
    fits, p = 22, 100 λs), Belloni's two CV-LASSOs in one batch (22 fits,
    p = 462, 100 λs), the binomial LASSO's first IRLS iteration (11 fits,
    p = 21, one λ) and residual_balancing's two arms (11 fits each, p =
    21, α = 0.9, 100 λs). Each: (name, cd_path's arguments, the row's
    cd_path calls)."""
    dev = frame_mod.device.type
    x = frame_mod.x
    keys = list(rnd.split(sweep_key("belloni", dev)).unbind(dim=-2))
    cases = [("usual", lasso_est._xw_design(frame_mod), [frame_mod.y], "gaussian",
              dict(foldids=[lasso.default_foldid(sweep_key("usual_lasso", dev), frame_mod.n)])),
             ("belloni", bel.interaction_expand(x), [frame_mod.w, frame_mod.y], "gaussian",
              dict(keys=keys)),
             ("ps_irls_1", x, [frame_mod.w], "binomial",
              dict(foldids=[lasso.default_foldid(sweep_key("ps_lasso", dev), frame_mod.n)]))]
    # residual_balancing's elastic nets (α = 0.9), one an arm, on their keys.
    k0, k1 = rnd.split(sweep_key("balance", dev)).unbind(dim=-2)
    treated = frame_mod.w > 0.5
    for arm, rows, k in (("balance_treated", treated, k1), ("balance_control", ~treated, k0)):
        cases.append((arm, x[rows], [frame_mod.y[rows]], "gaussian", dict(alpha=0.9, keys=[k])))
    out = []
    for name, xx, ys, family, kw in cases:
        with cd_capture() as seen:
            lasso.cv_glmnet_many(xx, ys, family, **kw)
        out.append((name, seen[0][0], len(seen)))
    return out


def cd_rows(frame_mod) -> list:
    """The CD kernel at the shapes of ``cd_inputs``. Each: two
    launches equal; within CD_PATH_BOUND of the plain version (Belloni's
    on the windows CD_PLAIN_WINDOWS, each warm-started from the kernel's
    coefficients at the λ before it); device times of the kernel and of
    the plain version (host-timed, on the same λs). ``bound_ms`` is the
    recurrence's floor: the longest fit's sweeps × p updates at
    RECURRENCE_STEPS steps of CHAIN_CYCLES_PER_STEP cycles each, the same
    at every p. Beside it ``order_chain_ms``, the floor of the order that
    keeps G_j·β whole on the chain (CHAIN_FIXED_STEPS + ceil(p/32) steps an
    update), and ``rate_bound_ms``: bytes (the Gram systems, c, pf and λs
    read once, the coefficients and sweep counts written once) or
    operations (this run's sweeps × p × (2p + 10) float operations at the
    peak rate), whichever is larger."""
    clock = sm_clock_mhz()
    rows = []
    for name, (gram, xty, pf, lams, beta0, alpha, thresh), calls in cd_inputs(frame_mod):
        run = lambda: lasso.cd_path(gram, xty, pf, lams, beta0, alpha, thresh)
        betas, sweeps = run()
        again, sweeps2 = run()
        check_equal(f"cd_path {name} (two launches)", again, betas)
        check_equal(f"cd_path {name} sweeps (two launches)", sweeps2, sweeps)
        big = name == "belloni"
        n_fits, p, _ = gram.shape
        n_lam = lams.shape[1]
        windows = []
        for lo, hi in CD_PLAIN_WINDOWS if big else ((0, n_lam),):
            start = beta0 if lo == 0 else betas[:, lo - 1].contiguous()
            plams = lams[:, lo:hi].contiguous()
            plain = lambda: lasso.cd_path_plain(gram, xty, pf, plams, start, alpha, thresh)
            if big:
                (want, want_sweeps), plain_ms = event_ms(plain)
            else:
                (want, want_sweeps), plain_ms = plain(), time_ms(plain, 1)
            err = float((betas[:, lo:hi] - want).abs().max())
            if not err <= CD_PATH_BOUND:
                raise AssertionError(f"cd_path {name} λs {lo}–{hi - 1}: kernel {err} from its "
                                     f"plain version (bound {CD_PATH_BOUND})")
            windows.append({"lambdas": [lo, hi], "max_abs_err": err, "plain_ms": plain_ms,
                            "sweeps_equal_to_plain": float((sweeps[:, lo:hi] == want_sweeps)
                                                           .double().mean())})
        nbytes = 4 * (n_fits * p * p + 2 * n_fits * p + n_fits * n_lam
                      + n_fits * n_lam * p + n_fits * n_lam)
        rate_ms, rate_by = bound(nbytes, int(sweeps.sum()) * p * (2 * p + 10))
        chain = int(sweeps.sum(dim=1).max()) * p
        cycles = CHAIN_CYCLES_PER_STEP * RECURRENCE_STEPS
        chain_ms = chain * cycles / (clock * 1e3)
        order_cycles = CHAIN_CYCLES_PER_STEP * (CHAIN_FIXED_STEPS + -(-p // 32))
        ms = device_ms(run, 1 if big else 10, 3 if big else 10)
        rows.append({"case": name, "B": n_fits, "p": p, "L": n_lam, "dtype": str(gram.dtype),
                     "staged_gram": p * p * 4 + 4 * 4 * ((p + 3) // 4 * 4) <= 200 * 1024,
                     "delay": lasso.cd_delay(),
                     "calls_in_row": calls, "sweeps_total": int(sweeps.sum()),
                     "sweeps_max": int(sweeps.max()), "chain_updates": chain,
                     "max_abs_err": max(w["max_abs_err"] for w in windows),
                     "plain_windows": windows,
                     "ms": ms, "ns_per_chain_update": ms * 1e6 / chain,
                     "call_ms": time_ms(run, 3 if big else 10),
                     "plain_ms": windows[0]["plain_ms"], "library_ms": None, "factor": None,
                     "bound_ms": max(chain_ms, rate_ms),
                     # The chain is one of dependent operations.
                     "bound_by": "operations" if chain_ms >= rate_ms else rate_by,
                     "bound_kind": "chain" if chain_ms >= rate_ms else rate_by,
                     "chain_cycles_per_update": cycles, "sm_clock_mhz": clock,
                     "order_chain_ms": chain * order_cycles / (clock * 1e3),
                     "order_chain_cycles_per_update": order_cycles,
                     "rate_bound_ms": rate_ms, "rate_bound_by": rate_by})
    return rows


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
    require_launched(counts, ("hist", "hist_partition", "node_sums", "route_advance",
                              "leaf_record"), "DR-RF")
    require_unpacked(counts, "DR-RF")
    require_row_launches(counts, "dr_rf")
    if dr.ate != DR_TAU:
        raise AssertionError(f"DR-RF τ moved: {dr.ate!r}, recorded {DR_TAU!r}")
    ROWS.update(oracle=oracle, naive=naive)
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


def sweep_key(name: str, device: str) -> torch.Tensor:
    """The sweep's per-stage key: fold_in(key(0), crc32(name))
    (``ate_replication_causalml_tpu/pipeline.py:586-589``)."""
    return rnd.fold_in(rnd.key(0, device=device), zlib.crc32(name.encode()))


def phase_path_cf(frame_mod) -> tuple[dict, dict]:
    """The "Causal Forest(GRF)" row through its entry point."""
    stages: dict = {}
    reset_counts()
    t0 = time.perf_counter()
    rep = causal_forest_report(frame_mod, key=sweep_key("causal_forest", "cuda"), n_trees=CF_TREES,
                               depth=CF_DEPTH, nuisance_trees=CF_NUISANCE_TREES,
                               nuisance_depth=DEPTH, stage_times=stages)
    sync()
    wall = time.perf_counter() - t0
    counts = read_counts()
    r = rep.result
    for label, v in (("ATE", r.ate), ("SE", r.se), ("incorrect ATE", rep.incorrect_ate),
                     ("incorrect SE", rep.incorrect_se)):
        if not math.isfinite(v):
            raise AssertionError(f"causal forest {label} is not finite: {v}")
    if not r.se > 0:
        raise AssertionError(f"causal forest SE is not positive: {r.se}")
    require_launched(counts, UNPACKED_KERNELS, "causal forest")
    require_unpacked(counts, "causal forest")
    require_row_launches(counts, "causal_forest")
    out = {"phase": "path_cf", "method": r.method, "rows": frame_mod.n, "trees": CF_TREES,
           "depth": CF_DEPTH, "nuisance_trees": CF_NUISANCE_TREES, "nuisance_depth": DEPTH,
           "ate": r.ate, "se": r.se, "ci": [r.lower_ci, r.upper_ci],
           "incorrect_ate": rep.incorrect_ate, "incorrect_se": rep.incorrect_se,
           "stages": stages, "wall_s": wall, "launches": counts}
    emit(out)
    if (r.ate, r.se) != (CF_ATE, CF_SE):
        raise AssertionError(f"causal ATE/SE moved: {r.ate!r}/{r.se!r}, recorded "
                             f"{CF_ATE!r}/{CF_SE!r}")
    return counts, out


def serve_submit(server, rid: str, x, on_fault=None):
    """submit(), retried on the typed retryable rejects as a client does."""
    for _ in range(2000):
        try:
            return server.submit(rid, x)
        except RejectedRequest as rej:
            if rej.code == "serve_fault" and on_fault is not None:
                on_fault(rid)
            elif rej.code not in ("overloaded", "degraded", "serve_fault"):
                raise
            time.sleep(rej.retry_after_s or 0.002)
    raise AssertionError(f"path_serve: no progress on {rid}")


def phase_path_serve(frame_mod, smi: str) -> dict:
    """The CATE serving daemon on the causal row's forest: save_fitted,
    CateServer(...).startup() on the card, requests from producer
    threads through submit() and from the port's client over
    serve_socket, then stop(), which holds the window to no kernel build
    and no graph capture. Every served row is held bit for bit to
    offline ``predict_cate(forest, x, oob=False)`` on the card."""
    fitted = cf.fit_causal_forest(frame_mod, key=sweep_key("causal_forest", "cuda"),
                                  n_trees=CF_TREES, depth=CF_DEPTH,
                                  nuisance_trees=CF_NUISANCE_TREES, nuisance_depth=DEPTH)
    forest = fitted.forest
    shutil.rmtree(os.path.dirname(SERVE_CKPT), ignore_errors=True)
    t0 = time.perf_counter()
    save_fitted(SERVE_CKPT, fitted)
    save_s = time.perf_counter() - t0
    # Real covariate rows of the frame, new data to the forest (oob=False).
    x_all = frame_mod.x.float().cpu().numpy()
    n_req = SERVE_REQUESTS + SERVE_SEQUENTIAL + SERVE_WIRE
    xs, off = [], 0
    for i in range(n_req):
        m = SERVE_SIZES[i % len(SERVE_SIZES)]
        if off + m > x_all.shape[0]:
            off = 0
        xs.append(np.ascontiguousarray(x_all[off:off + m]))
        off += m
    ref = cf.predict_cate(forest, torch.as_tensor(np.concatenate(xs), device="cuda"), oob=False)
    ref_c, ref_v = ref.cate.cpu().numpy(), ref.variance.cpu().numpy()
    starts = np.cumsum([0] + [x.shape[0] for x in xs])
    # The kernel at this path's shapes against its plain version (a
    # 32-tree chunk, the largest and the smallest bucket), uncounted.
    for rows in (256, 1):
        codes = fo.binarize(torch.as_tensor(x_all[:rows], device="cuda"), forest.bin_edges)
        args = (codes, forest.split_feat[:32].contiguous(), forest.split_bin[:32].contiguous(),
                forest.leaf_stats[:32].contiguous())
        if not torch.equal(tree.traverse(*args), tree.traverse_plain(*args)):
            raise AssertionError(f"path_serve: traverse differs from its plain version at "
                                 f"{rows} rows")
    fails: list[str] = []

    def check(label: str, i: int, got) -> None:
        c, v = got
        a, b = starts[i], starts[i + 1]
        if not (np.array_equal(c, ref_c[a:b]) and np.array_equal(v, ref_v[a:b])):
            fails.append(f"{label} request {i} differs from offline predict_cate")

    batches0 = sum((obs.REGISTRY.peek("serving_batches_total") or {}).values())
    reset_counts()
    t0 = time.perf_counter()
    server = CateServer(ServeConfig(checkpoint=SERVE_CKPT, buckets=BucketPlan.parse(SERVE_BUCKETS),
                                    window_s=0.002, max_depth=64, device="cuda"))
    phases = server.startup()
    startup_wall = time.perf_counter() - t0
    warm_traverse = tree.traverse.launches
    per_replay = server._predicts[next(iter(server._predicts))].traverse_per_replay
    # Producers: SERVE_PRODUCERS threads, each its share of the requests.
    done: dict[int, object] = {}
    errors: list[str] = []

    def producer(k: int) -> None:
        try:
            mine = [(i, serve_submit(server, f"r{i}", xs[i]))
                    for i in range(k, SERVE_REQUESTS, SERVE_PRODUCERS)]
            for i, req in mine:
                if not req.wait(60) or req.error is not None:
                    errors.append(f"r{i}: {req.error}")
                done[i] = req
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"producer {k}: {type(e).__name__}: {e}")

    # The port's client over a socket, concurrently.
    bound: list[int] = []
    sock_thread = threading.Thread(target=serve_socket, args=(server, "127.0.0.1", 0),
                                   kwargs={"on_bound": bound.append}, daemon=True)
    sock_thread.start()
    t_wait = time.monotonic()
    while not bound and time.monotonic() - t_wait < 30:
        time.sleep(0.01)
    wire_lat = []
    t0 = time.perf_counter()
    threads = [threading.Thread(target=producer, args=(k,)) for k in range(SERVE_PRODUCERS)]
    for t in threads:
        t.start()
    with CateClient.connect("127.0.0.1", bound[0]) as client:
        if client.ping()["state"] != "serving":
            fails.append("ping: not serving")
        for j in range(SERVE_WIRE):
            i = SERVE_REQUESTS + SERVE_SEQUENTIAL + j
            t1 = time.perf_counter()
            got = client.predict(xs[i], request_id=f"w{i}")
            wire_lat.append(time.perf_counter() - t1)
            check("wire", i, got)
        for t in threads:
            t.join()
        serve_wall = time.perf_counter() - t0
        wire_stats = client.stats()
    if errors:
        raise AssertionError("path_serve: " + "; ".join(errors[:5]))
    for i, req in done.items():
        check("submit", i, req.result)
    served_rows = sum(x.shape[0] for x in xs[:SERVE_REQUESTS]) + sum(
        x.shape[0] for x in xs[SERVE_REQUESTS + SERVE_SEQUENTIAL:])
    loaded: dict[int, list] = {}
    for req in done.values():
        loaded.setdefault(req.batch_bucket, []).append(req.resolved_mono - req.enqueued_mono)
    lat: dict[int, list] = {}
    for i in range(SERVE_REQUESTS, SERVE_REQUESTS + SERVE_SEQUENTIAL):
        req = serve_submit(server, f"s{i}", xs[i])
        if not req.wait(60) or req.error is not None:
            fails.append(f"s{i}: {req.error}")
            continue
        check("sequential", i, req.result)
        lat.setdefault(req.batch_bucket, []).append(req.resolved_mono - req.enqueued_mono)
    # A burst past the admission depth: typed rejects, never a queue.
    burst_codes: dict[str, int] = {}
    burst = []
    for i in range(4 * 64):
        try:
            burst.append(server.submit(f"b{i}", xs[6]))
        except RejectedRequest as rej:
            burst_codes[rej.code] = burst_codes.get(rej.code, 0) + 1
    for req in burst:
        if not req.wait(60) or req.error is not None:
            fails.append(f"burst request {req.request_id}: {req.error}")
        else:
            check("burst", 6, req.result)
    if not burst_codes.get("overloaded"):
        fails.append(f"burst past depth 64 drew no overloaded reject: {burst_codes}")
    # Chaos: a seeded serve: fault set, degraded mode, verified reload.
    faulted: list[str] = []
    ids = [f"c{i}" for i in range(SERVE_CHAOS_REQUESTS)]
    t1 = time.perf_counter()
    with chaos.override(SERVE_CHAOS):
        for i, rid in enumerate(ids):
            req = serve_submit(server, rid, xs[i], on_fault=faulted.append)
            if not req.wait(60) or req.error is not None:
                fails.append(f"chaos request {rid}: {req.error}")
            else:
                check("chaos", i, req.result)
    chaos_s = time.perf_counter() - t1
    expected = [rid for rid in ids if chaos._unit(11, "serve", rid) < 0.25]
    if faulted != expected or not expected:
        fails.append(f"chaos faulted {faulted}, planned {expected}")
    if server.lifecycle.state != "serving" or server.lifecycle.reload_count < 1:
        fails.append(f"chaos: state {server.lifecycle.state}, "
                     f"reloads {server.lifecycle.reload_count}")
    window = server.builds_in_window()
    stats = server.stats()
    server.stop()
    sock_thread.join(10)
    counts = read_counts()
    batches = sum((obs.REGISTRY.peek("serving_batches_total") or {}).values()) - batches0
    n_warm = len(server.config.buckets.sizes)
    if counts["traverse"] != per_replay * (2 * n_warm + batches):
        fails.append(f"traverse launches {counts['traverse']}, want {per_replay} x "
                     f"({2 * n_warm} warm-up and warm + {batches} batches)")
    if any(window.values()):
        fails.append(f"builds in the serving window: {window}")
    require_launched(counts, ("traverse",), "serve")
    others = {k: v for k, v in counts.items() if k != "traverse" and v}
    if others:
        fails.append(f"kernels other than traverse launched: {others}")
    used = {int(k.split("=")[1]) for k, v in (obs.REGISTRY.peek("serving_batches_total") or {}
                                              ).items() if v and k}
    if used != set(BucketPlan.parse(SERVE_BUCKETS).sizes) or set(lat) != used:
        fails.append(f"buckets used {sorted(used)}, one at a time {sorted(lat)}")
    pct = lambda v, q: float(np.percentile(np.asarray(v) * 1e3, q))
    out = {"phase": "path_serve", "nvidia_smi": smi, "trees": CF_TREES, "depth": CF_DEPTH,
           "features": int(x_all.shape[1]), "buckets": SERVE_BUCKETS,
           "checkpoint_mb": os.path.getsize(SERVE_CKPT) / 2**20, "save_s": save_s,
           "startup_s": phases, "startup_wall_s": startup_wall,
           "requests": {"submit": SERVE_REQUESTS, "sequential": SERVE_SEQUENTIAL,
                        "wire": SERVE_WIRE, "burst": len(burst), "chaos": SERVE_CHAOS_REQUESTS},
           "rows": served_rows, "serve_wall_s": serve_wall, "rows_per_s": served_rows / serve_wall,
           "latency_ms": {str(b): {"count": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                          for b, v in sorted(lat.items())},
           "loaded_latency_ms": {str(b): {"count": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                                 for b, v in sorted(loaded.items())},
           "wire_latency_ms": {"p50": pct(wire_lat, 50), "p99": pct(wire_lat, 99)},
           "batches": batches, "traverse_per_replay": per_replay,
           "warm_traverse": warm_traverse, "builds_in_window": window,
           "close_reasons": stats["close_reasons"], "burst_rejects": burst_codes,
           "chaos": {"faulted": len(faulted), "reloads": server.lifecycle.reload_count,
                     "seconds": chaos_s},
           "wire_stats_compile_events": wire_stats["compile_events_in_window"],
           "launches": counts}
    emit(out)
    if fails:
        raise AssertionError("path_serve: " + "; ".join(fails[:8]))
    return counts


def path_agrees(f1, b1, f2, b2) -> np.ndarray:
    """(T, 2^D) mask of the leaves whose every split on the path agrees."""
    n_trees, depth, _ = f1.shape
    differs = (f1 != f2) | (b1 != b2)
    leaf = np.arange(1 << depth)
    ok = np.ones((n_trees, 1 << depth), bool)
    for a in range(depth):
        ok &= ~differs[:, a, leaf >> (depth - a)]
    return ok


def phase_parity_cf(frame_mod) -> cf.FittedCausalForest:
    """The causal row at 32 causal and 32 nuisance trees on the card and
    on the CPU (plain versions). The nuisance forests are integer-weight
    forests (y, w ∈ {0, 1}), equal field for field; their OOB means sum
    over trees in another order, so ŷ, ŵ and with them the residuals
    differ by ulps, and the float histograms add in another order: a
    split can flip at a float tie, which moves whole rows. Held: the
    half-samples exact, the split agreement, τ̂ and its variance, the
    ATE and its SE; and predict_cate of one forest on both devices to
    1e-6·(1 + |τ̂|) (route and lookup are exact, the reductions f32)."""
    key = sweep_key("causal_forest", "cuda")
    kw = dict(n_trees=CF_PARITY_TREES, depth=CF_DEPTH, nuisance_trees=CF_PARITY_TREES,
              nuisance_depth=DEPTH)
    card = cf.fit_causal_forest(frame_mod, key=key, **kw)
    cpu_frame = frame_mod.to("cpu")
    host = cf.fit_causal_forest(cpu_frame, key=key.cpu(), **kw)
    fc, fh = card.forest, host.forest
    if not torch.equal(fc.in_sample.cpu(), fh.in_sample):
        raise AssertionError("card and CPU half-samples differ")
    f1, b1 = fc.split_feat.cpu().numpy(), fc.split_bin.cpu().numpy()
    f2, b2 = fh.split_feat.numpy(), fh.split_bin.numpy()
    live = np.zeros(f1.shape, bool)
    for lv in range(f1.shape[1]):
        live[:, lv, : 1 << lv] = True
    agreement = float(np.mean(((f1 == f2) & (b1 == b2))[live]))
    ok = path_agrees(f1, b1, f2, b2)
    s1, s2 = fc.leaf_stats.cpu().numpy(), fh.leaf_stats.numpy()
    counts_equal = bool(np.array_equal(s1[..., 0][ok], s2[..., 0][ok]))
    leaf_rel = float(np.max(np.abs(s1 - s2)[ok] / (1 + np.abs(s2)[ok]))) if ok.any() else 0.0
    pc, ph = cf.predict_cate(fc, frame_mod.x), cf.predict_cate(fh, cpu_frame.x)
    tau_h, var_h = ph.cate.numpy(), ph.variance.numpy()
    rel_tau = np.abs(pc.cate.cpu().numpy() - tau_h) / (1 + np.abs(tau_h))
    d_tau, d_tau_mean = float(rel_tau.max()), float(rel_tau.mean())
    d_var = float(np.max(np.abs(pc.variance.cpu().numpy() - var_h) / (1 + np.abs(var_h))))
    # One forest (the CPU's) predicted on the card: isolates predict_cate.
    moved = cf.CausalForest(*(getattr(fh, f).cuda() for f in
                              ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")))
    px = cf.predict_cate(moved, frame_mod.x)
    d_tau_same = float(np.max(np.abs(px.cate.cpu().numpy() - tau_h) / (1 + np.abs(tau_h))))
    ec, eh = cf.average_treatment_effect(card, pc), cf.average_treatment_effect(host, ph)
    d_ate, d_se = abs(float(ec.estimate) - float(eh.estimate)), abs(float(ec.std_err) - float(eh.std_err))
    out = {"phase": "parity_cf", "trees": CF_PARITY_TREES, "nuisance_trees": CF_PARITY_TREES,
           "y_hat_max_abs_diff": float((card.y_hat.cpu() - host.y_hat).abs().max()),
           "w_hat_max_abs_diff": float((card.w_hat.cpu() - host.w_hat).abs().max()),
           "split_agreement": agreement, "leaves_on_agreeing_paths": int(ok.sum()),
           "leaf_counts_equal": counts_equal, "leaf_stats_max_rel_diff": leaf_rel,
           "tau_max_rel_diff": d_tau, "tau_mean_rel_diff": d_tau_mean,
           "variance_max_rel_diff": d_var,
           "same_forest_tau_max_rel_diff": d_tau_same,
           "ate_card": float(ec.estimate), "ate_cpu": float(eh.estimate), "abs_date": d_ate,
           "se_card": float(ec.std_err), "se_cpu": float(eh.std_err), "abs_dse": d_se,
           "bounds": {"split_agreement": CF_SPLIT_AGREEMENT, "leaf_rel": CF_LEAF_REL,
                      "tau_rel": CF_TAU_BOUND, "tau_mean_rel": CF_TAU_MEAN_BOUND,
                      "ate": CF_ATE_BOUND, "se": CF_SE_BOUND, "same_forest_tau_rel": 1e-6}}
    emit(out)
    fails = []
    if not counts_equal:
        fails.append("leaf counts differ on agreeing paths")
    if agreement < CF_SPLIT_AGREEMENT:
        fails.append(f"split agreement {agreement} < {CF_SPLIT_AGREEMENT}")
    if not leaf_rel <= CF_LEAF_REL:
        fails.append(f"leaf statistics differ by {leaf_rel} > {CF_LEAF_REL}·(1 + |·|)")
    if not (d_tau <= CF_TAU_BOUND and d_var <= CF_TAU_BOUND and d_tau_mean <= CF_TAU_MEAN_BOUND):
        fails.append(f"τ̂/variance differ by {d_tau}/{d_var} (mean {d_tau_mean}) > "
                     f"{CF_TAU_BOUND} ({CF_TAU_MEAN_BOUND})·(1 + |·|)")
    if not d_tau_same <= 1e-6:
        fails.append(f"predict_cate of one forest differs by {d_tau_same} > 1e-6·(1 + |τ̂|)")
    if not (d_ate <= CF_ATE_BOUND and d_se <= CF_SE_BOUND):
        fails.append(f"ATE/SE differ by {d_ate}/{d_se} > {CF_ATE_BOUND}/{CF_SE_BOUND}")
    if fails:
        raise AssertionError("card vs CPU causal forest: " + "; ".join(fails))
    return card


def phase_path_cf_packed(frame_mod, cf_out: dict, card_32) -> dict:
    """The causal row under the packed-code policy: its partition levels
    (widths 16–64 at K=5, and 32–128 of the nuisance forests) take the
    packed pass, which adds every cell's rows in the unpacked order, so
    the ATE and SE are path_cf's bit for bit; and the 32-tree forest of
    parity_cf, grown again under the policy, is ``torch.equal`` to it."""
    stages: dict = {}
    with packed_policy():
        reset_counts()
        t0 = time.perf_counter()
        rep = causal_forest_report(frame_mod, key=sweep_key("causal_forest", "cuda"),
                                   n_trees=CF_TREES, depth=CF_DEPTH,
                                   nuisance_trees=CF_NUISANCE_TREES, nuisance_depth=DEPTH,
                                   stage_times=stages)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        again = cf.fit_causal_forest(frame_mod, key=sweep_key("causal_forest", "cuda"),
                                     n_trees=CF_PARITY_TREES, depth=CF_DEPTH,
                                     nuisance_trees=CF_PARITY_TREES, nuisance_depth=DEPTH)
    r = rep.result
    equal_32 = all(torch.equal(getattr(again.forest, f), getattr(card_32.forest, f))
                   for f in ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges"))
    equal_32 = equal_32 and torch.equal(again.y_hat, card_32.y_hat) and torch.equal(
        again.w_hat, card_32.w_hat)
    emit({"phase": "path_cf_packed", "policy": f"{pack.ENV_PACK}=1", "ate": r.ate, "se": r.se,
          "ate_unpacked": cf_out["ate"], "se_unpacked": cf_out["se"],
          "incorrect_ate": rep.incorrect_ate, "forest_32_equal_to_unpacked": equal_32,
          "stages": stages, "wall_s": wall, "launches": counts})
    if (r.ate, r.se, rep.incorrect_ate, rep.incorrect_se) != (
            cf_out["ate"], cf_out["se"], cf_out["incorrect_ate"], cf_out["incorrect_se"]):
        raise AssertionError(f"packed causal row differs from the unpacked one: {r} vs {cf_out}")
    if not equal_32:
        raise AssertionError("the 32-tree causal forest under the packed policy differs from "
                             "the unpacked card forest")
    if counts["hist_partition"] or counts["hist_partition_shared"]:
        raise AssertionError(f"unpacked partition launches under the packed policy: {counts}")
    require_launched(counts, ("hist", "hist_shared", "node_sums", "node_sums_shared",
                              "route_advance", "traverse", "leaf_record", "hist_partition_packed",
                              "hist_partition_shared_packed", "pack_codes"), "packed causal forest")
    require_row_launches(counts, "causal_forest_packed")
    return counts


@contextlib.contextmanager
def dml_capture():
    """Record the forests and vote fractions ``double_ml`` computes (its
    ``_fit_nuisance_forest`` and ``_rf_vote``), in call order."""
    seen = {"forests": [], "votes": []}
    fit, vote = dml._fit_nuisance_forest, dml._rf_vote

    def fit_rec(*a, **k):
        seen["forests"].append(fit(*a, **k))
        return seen["forests"][-1]

    def vote_rec(*a, **k):
        seen["votes"].append(vote(*a, **k))
        return seen["votes"][-1]

    dml._fit_nuisance_forest, dml._rf_vote = fit_rec, vote_rec
    try:
        yield seen
    finally:
        dml._fit_nuisance_forest, dml._rf_vote = fit, vote


def phase_path_dml(frame_mod) -> dict:
    """The "Double Machine Learning" row at the sweep's configuration
    under the packed-code policy."""
    stages: dict = {}
    with packed_policy():
        reset_counts()
        t0 = time.perf_counter()
        r = dml.double_ml(frame_mod, n_trees=DML_TREES, depth=DEPTH, key=sweep_key("dml", "cuda"),
                          crossfit="r", se_mode="r", stage_times=stages)
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
    if not (math.isfinite(r.ate) and math.isfinite(r.se) and r.se > 0):
        raise AssertionError(f"DML: non-finite estimate or SE ({r})")
    emit({"phase": "path_dml", "method": r.method, "policy": f"{pack.ENV_PACK}=1",
          "rows": frame_mod.n, "fold_rows": frame_mod.n // 2, "trees": DML_TREES, "depth": DEPTH,
          "crossfit": "r", "se_mode": "r", "ate": r.ate, "se": r.se, "ci": [r.lower_ci, r.upper_ci],
          "stages": stages, "wall_s": wall, "launches": counts})
    if counts["hist_partition"]:
        raise AssertionError(f"unpacked partition launches under the packed policy: {counts}")
    require_launched(counts, ("hist", "hist_partition_packed", "node_sums", "route_advance",
                              "traverse", "leaf_record", "pack_codes"), "DML")
    require_row_launches(counts, "dml")
    if (r.ate, r.se) != (DML_TAU, DML_SE):
        raise AssertionError(f"DML τ/SE moved: {r.ate!r}/{r.se!r}, recorded {DML_TAU!r}/{DML_SE!r}")
    return counts


def phase_parity_dml(frame_mod) -> None:
    """The DML row at 32 trees: packed and unpacked on the card, and on
    the CPU port. Integer histogram weights make every forest exact."""
    kw = dict(n_trees=DML_PARITY_TREES, depth=DEPTH, key=sweep_key("dml", "cuda"))
    with dml_capture() as packed_run, packed_policy():
        r_pk = dml.double_ml(frame_mod, **kw)
    with dml_capture() as card_run:
        r_card = dml.double_ml(frame_mod, **kw)
    with dml_capture() as cpu_run:
        r_cpu = dml.double_ml(frame_mod, device="cpu", **kw)
    fields = ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf")

    def same(a, b) -> bool:
        return (len(a["forests"]) == len(b["forests"]) == len(a["votes"]) == len(b["votes"]) == 4
                and all(torch.equal(getattr(fa, f).cpu(), getattr(fb, f).cpu())
                        for fa, fb in zip(a["forests"], b["forests"]) for f in fields)
                and all(torch.equal(va.cpu(), vb.cpu()) for va, vb in zip(a["votes"], b["votes"])))

    packed_equal, cpu_equal = same(packed_run, card_run), same(card_run, cpu_run)
    d_tau, d_se = abs(r_card.ate - r_cpu.ate), abs(r_card.se - r_cpu.se)
    emit({"phase": "parity_dml", "trees": DML_PARITY_TREES,
          "packed_vs_unpacked_forests_and_votes_equal": packed_equal,
          "card_vs_cpu_forests_and_votes_equal": cpu_equal,
          "tau_packed": r_pk.ate, "tau_card": r_card.ate, "tau_cpu": r_cpu.ate,
          "se_packed": r_pk.se, "se_card": r_card.se, "se_cpu": r_cpu.se,
          "abs_dtau_card_cpu": d_tau, "abs_dse_card_cpu": d_se, "bound": TAU_BOUND})
    if not packed_equal or (r_pk.ate, r_pk.se) != (r_card.ate, r_card.se):
        raise AssertionError("DML: packed and unpacked card runs differ")
    if not cpu_equal:
        raise AssertionError("DML: card and CPU forests or vote fractions differ")
    if not (d_tau <= TAU_BOUND and d_se <= TAU_BOUND):
        raise AssertionError(f"DML card vs CPU: |Δτ| {d_tau}, |Δse| {d_se} > {TAU_BOUND}")


def phase_path_leaf_index(card_32) -> dict:
    """``predict_cate``'s ``leaf_index`` and ``row_chunk`` options on
    parity_cf's 32-tree card forest: ``compute_leaf_index`` (one traverse
    launch, leaf ids), ``predict_cate`` through the index (one lookup
    launch), and both again with ``row_chunk=4096`` (taken, no blocking);
    each bit for bit the plain call's τ̂ and variance."""
    forest, x = card_32.forest, card_32.x
    whole = cf.predict_cate(forest, x)
    reset_counts()
    li = cf.compute_leaf_index(forest, x)
    runs = {"leaf_index": cf.predict_cate(forest, x, leaf_index=li),
            "row_chunk": cf.predict_cate(forest, x, row_chunk=4096),
            "leaf_index_row_chunk": cf.predict_cate(forest, x, row_chunk=4096, leaf_index=li)}
    sync()
    counts = read_counts()
    equal = {k: bool(torch.equal(r.cate, whole.cate) and torch.equal(r.variance, whole.variance))
             for k, r in runs.items()}
    emit({"phase": "path_leaf_index", "trees": forest.n_trees, "rows": x.shape[0],
          "leaf_index_dtype": str(li.dtype), "equal_to_plain_call": equal, "launches": counts})
    if not all(equal.values()):
        raise AssertionError(f"predict_cate options change the bits: {equal}")
    require_row_launches(counts, "leaf_index")
    return counts


def admm_activities(frame_mod) -> dict:
    """Device activities (kernels, copies, sets) of one ADMM iteration of
    the treated arm's float64 solve, from ``torch.profiler``: c(n) the
    activities of a solve capped at n iterations (the cap's freeze point
    is n // 2), so c(2) − c(1) is an iteration that adapts ρ and c(3) −
    c(2) one that does not."""
    x = frame_mod.x[frame_mod.w > 0.5]
    target = torch.mean(frame_mod.x, dim=0)

    def count(iters: int) -> tuple[dict, dict]:
        qp.balance_qp_x64(x, target, max_iters=iters)
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            qp.balance_qp_x64(x, target, max_iters=iters)
            sync()
        kinds, names = {"kernel": 0, "memcpy": 0, "memset": 0}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                low = e.name.lower()
                kinds["memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"] += 1
                names[e.name[:80]] = names.get(e.name[:80], 0) + 1
        return kinds, names

    (c1, _), (c2, n2), (c3, n3) = (count(n) for n in (1, 2, 3))
    frozen_names = {k: n3.get(k, 0) - n2.get(k, 0) for k in n3}
    return {"adapting": {k: c2[k] - c1[k] for k in c1}, "frozen": {k: c3[k] - c2[k] for k in c1},
            "set_up_and_polish": {k: c1[k] - (c3[k] - c2[k]) for k in c1},
            "frozen_by_name": dict(sorted(((k, v) for k, v in frozen_names.items() if v),
                                          key=lambda kv: -kv[1]))}


def phase_stages(frame_mod) -> None:
    """The partition rows' stage split (``stage_ms``) and the ADMM
    iteration's device activities, last, so that the profiler runs after
    every path's wall time was taken."""
    rows = []
    for row, run in SPLITS:
        row["stage_ms"] = stage_ms(run)
        rows.append({k: row[k] for k in ("M", "K", "weights", "ranges", "cluster", "stage_ms")})
    emit({"phase": "stages", "kernel": "hist_partition", "rows": rows,
          "admm_iteration_activities": admm_activities(frame_mod)})


def phase_path_ipw(frame_mod) -> None:
    """The Direct Method, the two propensity rows and DR-GLM (its own
    logistic propensity and outcome model, sandwich SE) on the card, and
    the same rows from the CPU port."""
    stages = {}

    def rows(frame, times):
        t0 = time.perf_counter()
        direct = ate_condmean_ols(frame)
        times["direct_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = logistic_propensity(frame.x, frame.w)
        if frame.device.type == "cuda":
            sync()
        times["logistic_propensity_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = [direct, prop_score_weight(frame, p), prop_score_ols(frame, p)]
        times["weighting_rows_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out.append(doubly_robust_glm(frame))
        times["dr_glm_s"] = time.perf_counter() - t0
        return out

    card = rows(frame_mod, stages)
    host = rows(frame_mod.to("cpu"), {})
    diffs = {c.method: [abs(c.ate - h.ate), abs(c.se - h.se)] for c, h in zip(card, host)}
    emit({"phase": "path_ipw", "rows": frame_mod.n,
          "results": {r.method: [r.ate, r.se] for r in card}, "stages": stages,
          "card_vs_cpu_abs_diff": diffs, "bound": IPW_BOUND})
    for r in card:
        if not (math.isfinite(r.ate) and math.isfinite(r.se) and r.se > 0):
            raise AssertionError(f"{r.method}: non-finite estimate or SE ({r})")
    bad = {m: d for m, d in diffs.items() if max(d) > IPW_BOUND}
    if bad:
        raise AssertionError(f"card vs CPU beyond {IPW_BOUND}: {bad}")
    ROWS["ipw_cpu"] = {h.method: h for h in host}


@contextlib.contextmanager
def cv_capture():
    """Record every ``cv_glmnet`` result the LASSO estimators compute, in
    call order."""
    seen = []
    # Belloni fits its two CV-LASSOs in one cv_glmnet_many call (a list).
    fits = {(lasso_est, "cv_glmnet"): lasso_est.cv_glmnet, (bel, "cv_glmnet_many"): bel.cv_glmnet_many}

    def wrap(fit):
        def rec(*a, **k):
            out = fit(*a, **k)
            seen.extend(out if isinstance(out, list) else [out])
            return out
        return rec

    for (m, name), fit in fits.items():
        setattr(m, name, wrap(fit))
    try:
        yield seen
    finally:
        for (m, name), fit in fits.items():
            setattr(m, name, fit)


def fold_digest(foldid: torch.Tensor) -> str:
    """sha256 of the fold ids as little-endian int64, first 16 hex digits."""
    return hashlib.sha256(foldid.cpu().numpy().astype("<i8").tobytes()).hexdigest()[:16]


def belloni_support(cv_xw, cv_xy) -> list:
    """Belloni's selected columns under compat="r" from its two fits."""
    lam = cv_xw.lambda_min
    c_xw = bel._interp_coef_at(cv_xw.path.lambdas, cv_xw.path.coefs, lam)
    c_xy = bel._interp_coef_at(cv_xy.path.lambdas, cv_xy.path.coefs, lam)
    return torch.nonzero((c_xw > 0) | (c_xy > 0))[:, 0].tolist()


def lasso_rows(frame, times: dict, launches: dict) -> tuple[list, list, dict]:
    """The four LASSO rows as the sweep runs them (``pipeline.py:863-877,
    931-945, 956-958``): fold ids from the sweep's keys, the LASSO
    propensity into the IPW row, Belloni on its key. Returns the results,
    the five cv_glmnet results and the fold ids."""
    dev = frame.device.type
    folds = {k: lasso.default_foldid(sweep_key(k, dev), frame.n)
             for k in ("ps_lasso", "seq_lasso", "usual_lasso")}
    kxw, kxy = rnd.split(sweep_key("belloni", dev)).unbind(dim=-2)
    folds["belloni_xw"] = lasso.default_foldid(kxw, frame.n)
    folds["belloni_xy"] = lasso.default_foldid(kxy, frame.n)
    stages = (("lasso_ps", lambda: prop_score_weight(
                  frame, lasso_est.prop_score_lasso(frame, folds["ps_lasso"]),
                  method="Propensity_Weighting_LASSOPS")),
              ("seq_lasso", lambda: lasso_est.ate_condmean_lasso(frame, folds["seq_lasso"])),
              ("usual_lasso", lambda: lasso_est.ate_lasso(frame, folds["usual_lasso"])),
              ("belloni", lambda: bel.belloni(frame, key=sweep_key("belloni", dev))))
    out = []
    kernel = COUNTERS["cd_path"][0]     # the wrapper itself, under the capture
    with cv_capture() as cvs, cd_capture() as calls:
        for name, fn in stages:
            before, n_calls = kernel.launches, len(calls)
            t0 = time.perf_counter()
            out.append(fn())
            if dev == "cuda":
                sync()
            times[f"{name}_s"] = time.perf_counter() - t0
            launches[name] = {"launches": kernel.launches - before,
                              "cd_path_calls": len(calls) - n_calls}
    return out, list(cvs), folds


def phase_path_lasso(frame_mod) -> dict:
    """The four LASSO rows on the card (launch counts read around them) and
    on the CPU port, held to the JAX package's fold ids, selected indices,
    τ and SE (LASSO_FOLDS, LASSO_INDEX, LASSO_JAX within LASSO_BOUND) and
    to each other within LASSO_BOUND, Belloni's support equal."""
    stages, per_row = {}, {}
    reset_counts()
    card, card_cv, card_folds = lasso_rows(frame_mod, stages, per_row)
    counts = read_counts()
    cpu_stages, cpu_calls = {}, {}
    host, host_cv, host_folds = lasso_rows(frame_mod.to("cpu"), cpu_stages, cpu_calls)
    names = list(LASSO_INDEX)
    index = {"card": {k: [int(c.index_min), int(c.index_1se)] for k, c in zip(names, card_cv)},
             "cpu": {k: [int(c.index_min), int(c.index_1se)] for k, c in zip(names, host_cv)}}
    digests = {"card": {k: fold_digest(v) for k, v in card_folds.items()},
               "cpu": {k: fold_digest(v) for k, v in host_folds.items()}}
    support = {"card": belloni_support(*card_cv[3:]), "cpu": belloni_support(*host_cv[3:])}
    # Belloni's host step: R's aliasing rule on the selected columns
    # (float64 Gram–Schmidt in numpy), timed again on its own.
    cols = bel.interaction_expand(frame_mod.x)[:, support["card"]]
    t0 = time.perf_counter()
    alias_filter(cols, with_intercept=True)
    stages["belloni_alias_filter_s"] = time.perf_counter() - t0
    results = {r.method: {"card": [r.ate, r.se], "cpu": [h.ate, h.se], "jax": list(LASSO_JAX[r.method]),
                          "abs_diff_card_jax": [abs(r.ate - LASSO_JAX[r.method][0]),
                                                abs(r.se - LASSO_JAX[r.method][1])],
                          "abs_diff_card_cpu": [abs(r.ate - h.ate), abs(r.se - h.se)],
                          "bound": LASSO_BOUND[r.method]}
               for r, h in zip(card, host)}
    # The point-only rows have no SE (NaN): written as null.
    printable = {m: {k: [None if isinstance(v, float) and math.isnan(v) else v for v in vals]
                     if isinstance(vals, list) else vals for k, vals in r.items()}
                 for m, r in results.items()}
    emit({"phase": "path_lasso", "rows": frame_mod.n, "results": printable, "index": index,
          "fold_digests": digests, "belloni_support_size": len(support["card"]),
          "belloni_support_equal": support["card"] == support["cpu"], "stages": stages,
          "cpu_stages": cpu_stages, "launches_by_row": per_row, "cpu_cd_path_calls": cpu_calls,
          "launches": counts})
    fails = []
    for dev, got in digests.items():
        if got != LASSO_FOLDS:
            fails.append(f"{dev} fold ids {got} differ from the JAX package's {LASSO_FOLDS}")
    for dev, got in index.items():
        if got != {k: list(v) for k, v in LASSO_INDEX.items()}:
            fails.append(f"{dev} selected indices {got}, the JAX package's {LASSO_INDEX}")
    if support["card"] != support["cpu"]:
        fails.append(f"Belloni support differs: card {support['card']}, cpu {support['cpu']}")
    for method, r in results.items():
        lim = LASSO_BOUND[method]
        for what, (da, ds) in (("JAX", r["abs_diff_card_jax"]), ("CPU", r["abs_diff_card_cpu"])):
            if not (da <= lim and (math.isnan(r["jax"][1]) or ds <= lim)):
                fails.append(f"{method}: card vs {what} |Δτ| {da}, |ΔSE| {ds} > {lim}")
        if not math.isfinite(r["card"][0]):
            fails.append(f"{method}: τ is not finite")
    gaussian = {"seq_lasso": 1, "usual_lasso": 1, "belloni": 1}
    for row, c in per_row.items():
        if c["launches"] != c["cd_path_calls"] or (row in gaussian and c["launches"] != gaussian[row]):
            fails.append(f"{row}: {c['launches']} cd_path launches for {c['cd_path_calls']} calls")
    require_launched(counts, LASSO_KERNELS, "LASSO")
    if any(counts[k] for k in COUNTERS if k not in LASSO_KERNELS):
        fails.append(f"forest kernels launched on the LASSO path: {counts}")
    if fails:
        raise AssertionError("path_lasso: " + "; ".join(fails))
    return counts


@contextlib.contextmanager
def balance_capture(dev: str):
    """Record, per arm in call order, what ``residual_balance_ate`` computes:
    the QP's rows, ADMM iterations, worst residual and wall; the elastic
    net's fold-id digest, index_min, wall and cd_path launches."""
    qps, cvs = [], []
    solve, fit = balance.approx_balance_sol, balance.cv_glmnet

    def qp_rec(x, target, **k):
        t0 = time.perf_counter()
        out = solve(x, target, **k)
        if dev == "cuda":
            sync()
        qps.append({"rows": x.shape[0], "admm_iters": out[2], "worst_resid": float(out[1]),
                    "qp_s": time.perf_counter() - t0})
        return out

    def cv_rec(x, y, **k):
        before, t0 = lasso.cd_path.launches, time.perf_counter()
        out = fit(x, y, **k)
        if dev == "cuda":
            sync()
        cvs.append({"index_min": int(out.index_min), "cv_s": time.perf_counter() - t0,
                    "cd_path_launches": lasso.cd_path.launches - before,
                    "fold_digest": fold_digest(lasso.default_foldid(k["key"], x.shape[0]))})
        return out

    balance.approx_balance_sol, balance.cv_glmnet = qp_rec, cv_rec
    try:
        yield qps, cvs
    finally:
        balance.approx_balance_sol, balance.cv_glmnet = solve, fit


def balance_row(frame) -> tuple:
    """The residual_balancing row as the sweep runs it (its key, its
    budget) → (result, {arm: its QP and CV record}, wall seconds)."""
    dev = frame.device.type
    with balance_capture(dev) as (qps, cvs):
        t0 = time.perf_counter()
        r = balance.residual_balance_ate(frame, key=sweep_key("balance", dev),
                                         max_iters=BALANCE_ITERS)
        wall = time.perf_counter() - t0
    arms = {arm: {**qps[i], **cvs[i]} for i, arm in enumerate(("treated", "control"))}
    for a in arms.values():
        a["ms_per_admm_iter"] = a["qp_s"] * 1e3 / max(a["admm_iters"], 1)
    return r, arms, wall


def phase_path_balance(frame_mod) -> dict:
    """The residual_balancing row at the notebook's configuration on the
    card (launch counts read around it) and on the CPU port: each arm's
    fold ids and index_min held to the JAX package's (BALANCE_FOLDS,
    BALANCE_INDEX), τ and SE to BALANCE_JAX and to each other within
    BALANCE_BOUND, one cd_path launch an arm and no other kernel."""
    reset_counts()
    card, card_arms, wall = balance_row(frame_mod)
    counts = read_counts()
    host, host_arms, host_wall = balance_row(frame_mod.to("cpu"))
    diffs = {"card_jax": [abs(card.ate - BALANCE_JAX[0]), abs(card.se - BALANCE_JAX[1])],
             "cpu_jax": [abs(host.ate - BALANCE_JAX[0]), abs(host.se - BALANCE_JAX[1])],
             "card_cpu": [abs(card.ate - host.ate), abs(card.se - host.se)]}
    emit({"phase": "path_balance", "rows": frame_mod.n, "max_iters": BALANCE_ITERS,
          "card": [card.ate, card.se], "cpu": [host.ate, host.se], "jax": list(BALANCE_JAX),
          "abs_diff": diffs, "bound": BALANCE_BOUND, "arms": card_arms, "cpu_arms": host_arms,
          "admm_iters_equal_card_cpu": all(card_arms[a]["admm_iters"] == host_arms[a]["admm_iters"]
                                           for a in card_arms),
          "wall_s": wall, "cpu_wall_s": host_wall, "launches": counts})
    fails = []
    for dev, arms in (("card", card_arms), ("cpu", host_arms)):
        got = {a: v["fold_digest"] for a, v in arms.items()}
        if got != BALANCE_FOLDS:
            fails.append(f"{dev} fold ids {got}, the JAX package's {BALANCE_FOLDS}")
        got = {a: v["index_min"] for a, v in arms.items()}
        if got != BALANCE_INDEX:
            fails.append(f"{dev} index_min {got}, the JAX package's {BALANCE_INDEX}")
        if any(v["worst_resid"] > 1e-7 or v["admm_iters"] >= BALANCE_ITERS for v in arms.values()):
            fails.append(f"{dev}: an arm's ADMM did not reach the tolerance ({arms})")
    fails += [f"{k} |Δτ|, |ΔSE| {d} > {BALANCE_BOUND}" for k, d in diffs.items()
              if max(d) > BALANCE_BOUND]
    if not (math.isfinite(card.ate) and card.se > 0):
        fails.append(f"non-finite estimate or SE ({card})")
    if counts["cd_path"] != CD_LAUNCHES["balance"] or any(
            v["cd_path_launches"] != 1 for v in card_arms.values()):
        fails.append(f"cd_path launches {counts['cd_path']}, one an arm expected")
    if any(counts[k] for k in COUNTERS if k not in LASSO_KERNELS):
        fails.append(f"forest kernels launched on the balancing path: {counts}")
    if fails:
        raise AssertionError("path_balance: " + "; ".join(fails))
    ROWS["balance_arms"] = card_arms
    return counts


def same_row(a, b) -> bool:
    """Two result rows equal, NaN equal to NaN (the point-only rows' SE)."""
    return pipeline._jsonsafe(a.to_dict()) == pipeline._jsonsafe(b.to_dict())


def sweep_checks(rep) -> list:
    """Each of the sweep's rows against the pin its own phase holds."""
    rows = {r.method: r for r in rep.results}
    fails = []
    for label, want in (("oracle", ROWS["oracle"]), ("naive", ROWS["naive"])):
        got = rep.oracle if label == "oracle" else rows["naive"]
        if (got.ate, got.se) != (want.ate, want.se):
            fails.append(f"{label} {got.ate!r}/{got.se!r}, path phase {want.ate!r}/{want.se!r}")
    dr = rows["Doubly Robust with Random Forest PS"]
    if dr.ate != SWEEP_DR_TAU:
        fails.append(f"DR-RF τ {dr.ate!r}, recorded {SWEEP_DR_TAU!r}")
    cf_row = rows["Causal Forest(GRF)"]
    if (cf_row.ate, cf_row.se) != (CF_ATE, CF_SE):
        fails.append(f"causal ATE/SE {cf_row.ate!r}/{cf_row.se!r}, recorded {CF_ATE!r}/{CF_SE!r}")
    d = rows["Double Machine Learning"]
    if (d.ate, d.se) != (DML_TAU, DML_SE):
        fails.append(f"DML τ/SE {d.ate!r}/{d.se!r}, recorded {DML_TAU!r}/{DML_SE!r}")
    for method, (tau, se) in LASSO_JAX.items():
        r, lim = rows[method], LASSO_BOUND[method]
        if not (abs(r.ate - tau) <= lim and (math.isnan(se) or abs(r.se - se) <= lim)):
            fails.append(f"{method} {r.ate!r}/{r.se!r}, the JAX package's {tau}/{se} (bound {lim})")
    for method, h in ROWS["ipw_cpu"].items():
        r = rows[method]
        if max(abs(r.ate - h.ate), abs(r.se - h.se)) > IPW_BOUND:
            fails.append(f"{method} {r.ate!r}/{r.se!r}, CPU port {h.ate!r}/{h.se!r}")
    b = rows["residual_balancing"]
    if max(abs(b.ate - BALANCE_JAX[0]), abs(b.se - BALANCE_JAX[1])) > BALANCE_BOUND:
        fails.append(f"residual_balancing {b.ate!r}/{b.se!r}, the JAX package's {BALANCE_JAX}")
    for r in [rep.oracle, *rep.results]:
        if r.status != "ok" or not math.isfinite(r.ate):
            why = rep.failures.get(r.method, {}).get("error", "")
            fails.append(f"{r.method}: status {r.status}, τ {r.ate}" + (f" ({why})" if why else ""))
    return fails


def telemetry(out: str, rep, wall: float) -> tuple[dict, list]:
    """Read the five telemetry files of a sweep into ``out`` with plain
    json (the port's own formats, no other parser) and check them: one
    ``sweep_stage`` span a record with the report's status,
    ``sweep_stage_total`` summing to the rows computed, each lane busy at
    most the wall, the critical path done by the last commit (in the
    sequential sweep: ending at the last row), ``device_memory_bytes``
    recorded. Returns the summary the phases print (critical path, each
    lane's busy and wait, the sampler's samples and period, the wall) and
    the failures."""
    fails = [f"{out}: {f} missing" for f in TELEMETRY if not os.path.exists(os.path.join(out, f))]
    if fails:
        return {}, fails
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f.read().splitlines()[1:]]
    with open(os.path.join(out, "trace.json")) as f:
        other = json.load(f)["otherData"]
    with open(os.path.join(out, "overlap_report.json")) as f:
        overlap = json.load(f)
    # The phases read the telemetry of sweeps that computed every row.
    want = {r.method: "failed" if r.method in rep.failures else "computed"
            for r in [rep.oracle, *rep.results]}
    stages = {r["attrs"]["method"]: r["status"] for r in events if r["name"] == "sweep_stage"}
    if stages != want:
        fails.append(f"sweep_stage spans {stages}, the report's {want}")
    computed = sum(v for k, v in metrics["counters"]["sweep_stage_total"].items()
                   if "status=computed" in k)
    if computed != rep.computed:
        fails.append(f"sweep_stage_total computed {computed}, the report's {rep.computed}")
    busy = {t: v["busy_s"] for t, v in overlap["tracks"].items()}
    if any(b > overlap["wall_s"] + 1e-6 for b in busy.values()):
        fails.append(f"lane busy {busy} over the wall {overlap['wall_s']}")
    commits = sorted((r for r in events if r["name"] == "commit"), key=lambda r: r["end_mono_s"])
    path = overlap["critical_path"]
    tail_end = path[-1]["start_s"] + path[-1]["dur_s"] if path else 0.0
    last_commit = commits[-1]["end_mono_s"] - other["mono_origin_s"] if commits else 0.0
    if not path or tail_end > last_commit + 1e-3:
        fails.append(f"critical path ends at {tail_end} s, the last commit at {last_commit} s")
    if overlap["workers"] == 1 and path and path[-1]["name"] != commits[-1]["attrs"]["stage"]:
        fails.append(f"sequential critical path ends at {path[-1]['name']}")
    if not metrics["gauges"].get("device_memory_bytes"):
        fails.append("no device_memory_bytes gauge")
    summary = {"wall_s": wall, "run_sweep_s": overlap["wall_s"], "workers": overlap["workers"],
               "critical_path": [[e["name"], e["dur_s"], e["wait_s"]] for e in path],
               "critical_path_s": overlap["critical_path_s"],
               "overlap_efficiency": overlap["overlap_efficiency"],
               "lanes": {t: {"busy_s": v["busy_s"], "wait_s": v["wait_s"], "nodes": v["nodes"]}
                         for t, v in overlap["tracks"].items()},
               "committer_busy_s": overlap["serialization"]["committer"]["busy_s"],
               "sampler": {"samples": other.get("sampler_ticks"),
                           "period_s": other.get("sampler_interval_s")},
               "device_memory_peak_bytes": max(
                   (v for k, v in metrics["gauges"].get("device_memory_bytes", {}).items()
                    if "allocated_bytes.all.peak" in k), default=None)}
    return summary, fails


def phase_path_sweep() -> dict:
    """The notebook sweep through its entry point, ``pipeline.run_sweep``,
    at the full configuration (``SweepConfig()``) on the card, the default
    device, with the DML row's packed-code policy (``ATE_TPU_PREDICT_PACK=1``
    for the whole run: integer histogram weights and the causal pass give
    the bits of the unpacked policy); every row held to its phase's pin;
    report.json and REPORT.md parsed; then the same call again on the same
    directory: every record resumed, nothing computed, no kernel launched,
    the same rows. The first run's telemetry files are read and checked
    (:func:`telemetry`), and its critical path, lanes and sampler printed."""
    shutil.rmtree(SWEEP_OUT, ignore_errors=True)
    config = pipeline.SweepConfig()
    logs, logs2 = [], []
    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    with packed_policy():
        reset_counts()
        t0 = time.perf_counter()
        rep = pipeline.run_sweep(config, outdir=SWEEP_OUT, plots=False, log=logs.append,
                                 scheduler="sequential")
        wall = time.perf_counter() - t0
        counts = read_counts()
        tele, fails = telemetry(SWEEP_OUT, rep, wall)
        reset_counts()
        t0 = time.perf_counter()
        again = pipeline.run_sweep(config, outdir=SWEEP_OUT, plots=False, log=logs2.append,
                                   scheduler="sequential")
        wall2 = time.perf_counter() - t0
        counts2 = read_counts()
    with open(os.path.join(SWEEP_OUT, "report.json")) as f:
        doc = json.load(f)
    with open(os.path.join(SWEEP_OUT, "REPORT.md")) as f:
        md = f.read()
    n_rows = len(pipeline.SWEEP_METHODS) + 1
    ROWS["sweep"] = {"report": rep, "wall_s": wall, "counts": counts, "telemetry": tele}
    emit({"phase": "path_sweep", "scheduler": "sequential", "config": "SweepConfig()",
          "policy": f"{pack.ENV_PACK}=1", "overlap": overlap(rep, wall),
          "rows_biased": rep.n_biased, "n_dropped": rep.n_dropped,
          "results": {r.method: [r.ate, None if math.isnan(r.se) else r.se]
                      for r in [rep.oracle, *rep.results]},
          "incorrect_cf": [rep.incorrect_cf_ate, rep.incorrect_cf_se],
          "seconds": rep.timings_s, "wall_s": wall, "computed": rep.computed,
          "launches": counts, "telemetry": tele,
          "resume": {"wall_s": wall2, "computed": again.computed, "resumed": again.resumed,
                     "launches": counts2}})
    fails += sweep_checks(rep)
    if [r["method"] for r in doc["results"]] != list(pipeline.SWEEP_METHODS):
        fails.append(f"report.json rows {[r['method'] for r in doc['results']]}")
    missing = [m for m in pipeline.SWEEP_METHODS if f"| {m} | {rep.results[m].ate:.4f} |" not in md]
    if missing or f"## [1] {rep.n_dropped}" not in md:
        fails.append(f"REPORT.md lacks rows {missing} or the drop count")
    if rep.computed != n_rows or (again.computed, again.resumed) != (0, n_rows):
        fails.append(f"computed {rep.computed}; the rerun computed {again.computed}, resumed "
                     f"{again.resumed} of {n_rows}")
    if sum("[resume]" in ln for ln in logs2) != n_rows:
        fails.append("the rerun did not log every row as resumed")
    if any(counts2.values()):
        fails.append(f"the resumed run launched kernels: {counts2}")
    if not (same_row(again.oracle, rep.oracle)
            and all(same_row(a, b) for a, b in zip(again.results, rep.results))):
        fails.append("the resumed rows differ from the computed ones")
    unpacked = ("hist_partition", "hist_partition_shared")
    if any(counts[k] for k in unpacked):
        fails.append(f"unpacked partition launches under the packed policy: {counts}")
    try:
        require_launched(counts, [k for k in COUNTERS if k not in unpacked + OLD_ROW_KERNELS],
                         "sweep")
        require_row_launches(counts, "sweep")
    except AssertionError as e:
        fails.append(str(e))
    if counts["cd_path"] != sum(CD_LAUNCHES.values()):
        fails.append(f"cd_path launches {counts['cd_path']}, derived {sum(CD_LAUNCHES.values())}")
    if fails:
        raise AssertionError("path_sweep: " + "; ".join(fails))
    return counts


def overlap(rep, wall: float) -> float:
    """The sum of the rows' and shared nuisances' seconds over the sweep's
    wall: up to 1 for one row at a time, more where rows overlapped."""
    return sum(rep.timings_s.values()) / wall


def journal(out: str) -> list:
    """``results.jsonl``'s records with their wall seconds taken out."""
    with open(os.path.join(out, "results.jsonl")) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "seconds"} for ln in f]


def rerun(config, out: str, **kw) -> dict:
    """The sweep again on ``out``: its wall, counts and launches."""
    reset_counts()
    t0 = time.perf_counter()
    rep = pipeline.run_sweep(config, outdir=out, plots=False, log=lambda s: None, **kw)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "computed": rep.computed, "resumed": rep.resumed,
            "launches": read_counts(), "report": rep}


def phase_path_sweep_concurrent() -> dict:
    """The notebook sweep through ``pipeline.run_sweep`` with the default
    scheduler (the concurrent engine at its default worker count, one CUDA
    stream a worker) at ``SweepConfig()`` under ``ATE_TPU_PREDICT_PACK=1``,
    into a fresh directory: every record bit for bit path_sweep's
    sequential row from this call, the launches of every kernel equal,
    the journal's lines (seconds aside) in the same order, every pin of
    ``sweep_checks``; then a sequential rerun on this directory and a
    concurrent rerun on path_sweep's: all 14 resumed, 0 computed, 0
    launches. Prints both sweeps' walls and overlap (the rows' and
    nuisances' seconds over the wall), the worker count, each node's start
    and end offsets from the engine's spans, the prefetch lane's outcome,
    and both sweeps' telemetry summaries (critical path, each lane's busy
    and wait, the sampler's samples), this sweep's files checked as
    path_sweep's are."""
    seq = ROWS["sweep"]
    shutil.rmtree(SWEEP_CONC_OUT, ignore_errors=True)
    config = pipeline.SweepConfig()
    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    with packed_policy():
        reset_counts()
        start = time.monotonic()
        t0 = time.perf_counter()
        rep = pipeline.run_sweep(config, outdir=SWEEP_CONC_OUT, plots=False, log=lambda s: None)
        wall = time.perf_counter() - t0
        counts = read_counts()
        records, snap = obs.EVENTS.records(), obs.REGISTRY.snapshot()
        tele, fails = telemetry(SWEEP_CONC_OUT, rep, wall)
        same_journal = journal(SWEEP_CONC_OUT) == journal(SWEEP_OUT)
        seq_again = rerun(config, SWEEP_CONC_OUT, scheduler="sequential")
        conc_again = rerun(config, SWEEP_OUT)
    nodes = sorted(({"node": r["attrs"]["node"], "kind": r["attrs"]["kind"],
                     "worker": r["attrs"]["worker"], "start_s": r["start_mono_s"] - start,
                     "end_s": r["end_mono_s"] - start}
                    for r in records if r["name"] == "scheduler_node"),
                   key=lambda n: n["start_s"])
    workers = snap["gauges"].get("scheduler_workers", {}).get("")
    n_rows = len(pipeline.SWEEP_METHODS) + 1
    emit({"phase": "path_sweep_concurrent", "config": "SweepConfig()",
          "policy": f"{pack.ENV_PACK}=1", "workers": workers,
          "wall_s": wall, "sequential_wall_s": seq["wall_s"],
          "overlap": overlap(rep, wall), "sequential_overlap": overlap(seq["report"], seq["wall_s"]),
          "seconds": rep.timings_s, "nodes": nodes,
          "prefetch": {"outcomes": snap["counters"].get("scheduler_prefetch_total", {}),
                       "seconds": snap["histograms"].get("scheduler_prefetch_seconds", {})},
          "cache": snap["counters"].get("nuisance_cache_requests_total", {}),
          "launches": counts, "computed": rep.computed, "telemetry": tele,
          "sequential_telemetry": seq["telemetry"],
          "sequential_rerun": {k: v for k, v in seq_again.items() if k != "report"},
          "concurrent_rerun_of_sequential": {k: v for k, v in conc_again.items()
                                             if k != "report"}})
    seq_rep = seq["report"]
    pairs = [("oracle", rep.oracle, seq_rep.oracle)] + [
        (a.method, a, b) for a, b in zip(rep.results, seq_rep.results)]
    fails += [f"{m}: {a.ate!r}/{a.se!r}, sequential {b.ate!r}/{b.se!r}"
              for m, a, b in pairs if not same_row(a, b)]
    if counts != seq["counts"]:
        fails.append(f"launches {counts}, sequential {seq['counts']}")
    if not same_journal:
        fails.append("results.jsonl differs from the sequential sweep's (seconds aside)")
    fails += sweep_checks(rep)
    if rep.computed != n_rows or not workers or workers < 2:
        fails.append(f"computed {rep.computed} of {n_rows} on {workers} workers")
    for label, again in (("sequential rerun", seq_again), ("concurrent rerun", conc_again)):
        if (again["computed"], again["resumed"]) != (0, n_rows) or any(again["launches"].values()):
            fails.append(f"{label}: computed {again['computed']}, resumed {again['resumed']}, "
                         f"launches {again['launches']}")
        r = again["report"]
        if not (same_row(r.oracle, rep.oracle)
                and all(same_row(a, b) for a, b in zip(r.results, rep.results))):
            fails.append(f"{label}: the resumed rows differ")
    if fails:
        raise AssertionError("path_sweep_concurrent: " + "; ".join(fails))
    return counts


def drop_rows(src: str, out: str, methods) -> None:
    """A copy of the sweep directory ``src`` whose journal lacks the lines
    of ``methods``."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out)
    path = os.path.join(out, "results.jsonl")
    with open(path) as f:
        lines = [ln for ln in f if json.loads(ln)["method"] not in methods]
    with open(path, "w") as f:
        f.writelines(lines)


def injections(out: str) -> list:
    with open(os.path.join(out, "events.jsonl")) as f:
        recs = [json.loads(ln) for ln in f.read().splitlines()[1:]]
    return [[r["attrs"]["scope"], r["attrs"]["site"]] for r in recs if r["name"] == "chaos_inject"]


def phase_path_sweep_chaos() -> None:
    """Fault injection at the full configuration, cheaply: path_sweep's
    directory copied with the journal lines of two light rows
    (``CHAOS_ROWS``) dropped, then the default (concurrent) sweep under
    ``ATE_TPU_CHAOS=CHAOS_SPEC`` with ``fail_policy="degrade"``: one
    failed row (the one the spec names), the other's journal append torn,
    every other record resumed; then a clean sequential sweep on the same
    directory: the torn line counted, the two rows recomputed bit for bit
    path_sweep's, with exactly their share of the launches
    (``CHAOS_ROWS_LAUNCHES``)."""
    seq = ROWS["sweep"]["report"]
    want = {r.method: r for r in [seq.oracle, *seq.results]}
    drop_rows(SWEEP_OUT, SWEEP_CHAOS_OUT, CHAOS_ROWS)
    config = pipeline.SweepConfig()
    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    with packed_policy():
        with env("ATE_TPU_CHAOS", CHAOS_SPEC):
            faulty = rerun(config, SWEEP_CHAOS_OUT)
        injected = injections(SWEEP_CHAOS_OUT)
        obs.REGISTRY.reset()
        obs.EVENTS.clear()
        clean = rerun(config, SWEEP_CHAOS_OUT, scheduler="sequential")
    with open(os.path.join(SWEEP_CHAOS_OUT, "metrics.json")) as f:
        torn = json.load(f)["counters"]["checkpoint_torn_lines_total"]
    n_rows = len(pipeline.SWEEP_METHODS) + 1
    frep, crep = faulty["report"], clean["report"]
    emit({"phase": "path_sweep_chaos", "config": "SweepConfig()", "spec": CHAOS_SPEC,
          "rows": list(CHAOS_ROWS), "policy": f"{pack.ENV_PACK}=1",
          "faulty": {"wall_s": faulty["wall_s"], "computed": faulty["computed"],
                     "resumed": faulty["resumed"], "failures": frep.failures,
                     "injections": injected, "launches": faulty["launches"]},
          "resume": {"wall_s": clean["wall_s"], "computed": clean["computed"],
                     "resumed": clean["resumed"], "torn_lines": torn,
                     "launches": clean["launches"]}})
    fails = []
    if set(frep.failures) != {"Usual LASSO"} or (faulty["computed"], faulty["resumed"]) != (
            2, n_rows - 2):
        fails.append(f"chaos run: failures {list(frep.failures)}, computed {faulty['computed']}, "
                     f"resumed {faulty['resumed']}")
    if injected != [["stage", "Usual LASSO"],
                    ["fs", os.path.join(SWEEP_CHAOS_OUT, "results.jsonl")]]:
        fails.append(f"injections {injected}")
    if torn.get("") != 1.0 or (clean["computed"], clean["resumed"]) != (2, n_rows - 2):
        fails.append(f"resume: torn lines {torn}, computed {clean['computed']}, "
                     f"resumed {clean['resumed']}")
    for label, rep in (("chaos run", frep), ("resume", crep)):
        fails += [f"{label}: {r.method} {r.ate!r}/{r.se!r}, path_sweep's "
                  f"{want[r.method].ate!r}/{want[r.method].se!r}"
                  for r in [rep.oracle, *rep.results]
                  if r.method not in rep.failures and not same_row(r, want[r.method])]
    share = {k: v for k, v in clean["launches"].items() if v}
    if share != CHAOS_ROWS_LAUNCHES:
        fails.append(f"resume launches {share}, the rows' share {CHAOS_ROWS_LAUNCHES}")
    half = {k: v for k, v in faulty["launches"].items() if v}
    if half != {"cd_path": 1}:
        fails.append(f"chaos run launches {half}: only the computed row's one cd_path expected")
    if fails:
        raise AssertionError("path_sweep_chaos: " + "; ".join(fails))


def phase_path_xprof() -> None:
    """``ATE_TPU_XPROF`` on the card at ``SweepConfig().quick()``, last (a
    process that has run the profiler launches more slowly): a quick sweep
    without the profiler, then a copy of its directory with the journal
    lines of ``XPROF_ROWS`` dropped, rerun with the default scheduler and
    the whole-run capture. The knob must force the sequential sweep; the
    Chrome trace must hold each recomputed row's ``record_function`` range
    and launches of the port's kernels (``XPROF_KERNELS``); the rows must
    equal the sweep's without the profiler."""
    config = pipeline.SweepConfig().quick()
    plain_out = XPROF_OUT + "_plain"
    shutil.rmtree(plain_out, ignore_errors=True)
    plain = rerun(config, plain_out, scheduler="sequential")
    drop_rows(plain_out, XPROF_OUT, XPROF_ROWS)
    prof_dir = os.path.join(XPROF_OUT, "xprof")
    logs = []
    with env("ATE_TPU_XPROF", prof_dir):
        t0 = time.perf_counter()
        rep = pipeline.run_sweep(config, outdir=XPROF_OUT, plots=False, log=logs.append)
        wall = time.perf_counter() - t0
    path = os.path.join(prof_dir, "run_sweep.trace.json")
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    ranges = [obs.sanitize_label(m) for m in XPROF_ROWS]
    kernels = {k: sum(k in n for n in names) for k in XPROF_KERNELS}
    forced = any("forcing the sequential sweep" in ln for ln in logs)
    emit({"phase": "path_xprof", "config": "SweepConfig().quick()", "rows": list(XPROF_ROWS),
          "plain_wall_s": plain["wall_s"], "wall_s": wall, "forced_sequential": forced,
          "trace_bytes": os.path.getsize(path), "trace_events": len(names),
          "ranges": {r: r in names for r in ranges}, "kernel_events": kernels})
    fails = []
    if not forced or any("concurrent sweep" in ln for ln in logs):
        fails.append("ATE_TPU_XPROF did not force the sequential sweep")
    if rep.computed != len(XPROF_ROWS) or not all(r in names for r in ranges):
        fails.append(f"computed {rep.computed}; ranges in the trace {[r in names for r in ranges]}")
    if not any(kernels.values()):
        fails.append(f"no launch of {XPROF_KERNELS} in the trace")
    pr = plain["report"]
    fails += [f"{a.method}: {a.ate!r}/{a.se!r}, without the profiler {b.ate!r}/{b.se!r}"
              for a, b in zip([rep.oracle, *rep.results], [pr.oracle, *pr.results])
              if not same_row(a, b)]
    if fails:
        raise AssertionError("path_xprof: " + "; ".join(fails))


_HIST = "ate_replication_causalml_torch/csrc/hist.cu"
_PART = "ate_replication_causalml_torch/csrc/hist_partition.cu"
_TPU = "ate_replication_causalml_tpu/ops/"
_ROUTE = "ate_replication_causalml_torch/csrc/route.cu"
_LOOKUP = "ate_replication_causalml_torch/csrc/lookup.cu"
SOURCES = {  # kernel -> (source, the TPU kernel it replaces, its device function)
    "hist": (_HIST, _TPU + "hist_pallas.py:243", "hist_dense"),
    "hist_partition": (_PART, _TPU + "hist_pallas.py:335", "partition_accumulate"),
    "hist_shared": (_HIST, _TPU + "hist_pallas.py:782", "hist_dense"),
    "hist_partition_shared": (_PART, _TPU + "hist_pallas.py:335", "partition_accumulate"),
    "node_sums": (_HIST, _TPU + "hist_pallas.py:243", "hist_dense"),
    "node_sums_shared": (_HIST, _TPU + "hist_pallas.py:782", "hist_dense"),
    "route": (_ROUTE, _TPU + "tree_pallas.py:198", "route_kernel"),
    "lookup": (_LOOKUP, _TPU + "tree_pallas.py:67", "lookup_kernel"),
    # The fused passes: the route kernel with the grower's id updates; the
    # route kernel at every level with the lookup kernel; the lookup
    # kernel with the grower's leaf values.
    "route_advance": (_ROUTE, _TPU + "tree_pallas.py:198", "route_advance_kernel"),
    "traverse": (_LOOKUP, _TPU + "tree_pallas.py:198", "traverse_kernel"),
    "leaf_record": (_LOOKUP, _TPU + "tree_pallas.py:67", "leaf_record_kernel"),
    # The pack=True branch of _hist_kernel_batched_partition (:415-445, :463-484).
    "hist_partition_packed": (_PART, _TPU + "hist_pallas.py:463", "partition_accumulate_packed"),
    "hist_partition_shared_packed": (_PART, _TPU + "hist_pallas.py:463",
                                     "partition_accumulate_packed"),
    # Its in-kernel pack matmul.
    "pack_codes": (_PART, _TPU + "hist_pallas.py:441", "pack_words"),
    # Not a TPU kernel: the XLA program of the coordinate descent
    # (_cd_sweeps under the λ scan and the fold vmap).
    "cd_path": ("ate_replication_causalml_torch/csrc/lasso.cu", _TPU + "lasso.py:95",
                "cd_path_kernel"),
}


# The CD kernel's recurrence bound beside the whole-dot-product order's
# chain and its byte-or-operation bound.
CHAIN_KEYS = ("bound_kind", "rate_bound_ms", "rate_bound_by", "chain_updates",
              "ns_per_chain_update", "chain_cycles_per_update", "sm_clock_mhz",
              "order_chain_ms", "delay")


def main() -> int:
    name, smi = phase_device()
    functions = phase_build()
    frame, frame_mod = notebook_frames("cuda")
    timing = phase_kernels(frame_mod)
    by_path = {"dr_rf": phase_path(frame, frame_mod)}
    phase_parity(frame_mod)
    by_path["causal_forest"], cf_out = phase_path_cf(frame_mod)
    by_path["path_serve"] = phase_path_serve(frame_mod, smi)
    card_32 = phase_parity_cf(frame_mod)
    by_path["leaf_index"] = phase_path_leaf_index(card_32)
    by_path["causal_forest_packed"] = phase_path_cf_packed(frame_mod, cf_out, card_32)
    by_path["dml"] = phase_path_dml(frame_mod)
    phase_parity_dml(frame_mod)
    phase_path_ipw(frame_mod)
    by_path["lasso"] = phase_path_lasso(frame_mod)
    by_path["balance"] = phase_path_balance(frame_mod)
    by_path["sweep"] = phase_path_sweep()
    by_path["sweep_concurrent"] = phase_path_sweep_concurrent()
    phase_path_sweep_chaos()
    phase_stages(frame_mod)
    phase_path_xprof()
    kernels = []
    for k, (src, rep, device_fn) in SOURCES.items():
        row = timing[k]
        ptxas = [v for f, v in functions.items() if f.split("<")[0] == device_fn]
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(c[k] for c in by_path.values()),
                        "launches_by_path": {p: c[k] for p, c in by_path.items()},
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "factor": row.get("factor"), "call_ms": row.get("call_ms"),
                        "replaced_ms": row.get("replaced_ms"),
                        "launch_floor_ms": row.get("launch_floor_ms"),
                        **{c: row[c] for c in CHAIN_KEYS if c in row},
                        "registers": max((v.get("registers", 0) for v in ptxas), default=None),
                        "spill_bytes": max((v.get("spill_bytes", 0) for v in ptxas), default=None)})
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
