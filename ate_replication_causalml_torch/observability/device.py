"""Device and build instrumentation.

Port of ``ate_replication_causalml_tpu/observability/device.py``,
remapped to PyTorch and the port's kernel build:

* :func:`install_monitoring` (the JAX package's ``install_jax_monitoring``)
  pre-creates at 0 every counter family ``scripts/check_metrics_schema.py``
  requires (``REQUIRED_COUNTERS``) and the sweep's own families, so "no
  retries", "nothing injected" and "nothing torn" are recorded zeros in
  ``metrics.json``, not missing keys;
* ``compile_cache_hits_total`` / ``compile_cache_misses_total`` count the
  kernel build's hash-named library cache (``kernels/build.py``): a hit
  when a library of the same source hash is already on disk, a miss when
  ``nvcc`` runs;
* ``jax_compiles_total`` stays a recorded 0: nothing in the port traces
  or compiles a program at run time (the serving plane's no-compile
  proof reads it);
* :func:`record_device_memory` reads ``torch.cuda.memory_stats`` into the
  ``device_memory_bytes`` gauge, per CUDA device; it records nothing on
  the CPU, as the JAX package records nothing there.

The JAX package's ``record_compiled_cost`` (XLA's cost and memory
analysis of a compiled program) and ``watch_cache_dir`` (XLA's
persistent compile cache) have no PyTorch counterpart and are not
ported.
"""

from __future__ import annotations

import torch

from ate_replication_causalml_torch.observability.registry import counter, gauge

#: ``scripts/check_metrics_schema.py::REQUIRED_COUNTERS``: the families
#: every instrumented run exports, zero or not.
REQUIRED_COUNTERS = (
    "shard_attempts_total", "shard_retries_total", "shard_failures_total",
    "compile_cache_hits_total", "compile_cache_misses_total",
    "nuisance_cache_requests_total", "scheduler_prefetch_total",
    "hist_kernel_dispatch_total", "artifact_transfer_bytes_total", "artifact_reshard_total",
    "serving_requests_total", "serving_rejected_total", "jax_compiles_total",
    "serving_phase_seconds_total", "serving_batch_close_total",
    "serving_rotations_total", "serving_fleet_requests_total", "serving_retrain_total",
    "serving_retrain_retries_total", "serving_pad_rows_total", "serving_masked_rows_total",
    "scenario_cells_total", "scenario_batch_dispatch_total", "scenario_column_compile_total",
    "watchdog_stalls_total", "serving_deadline_exceeded_total", "drain_total",
    "chaos_campaign_episodes_total", "chaos_invariant_checks_total",
    "serving_stat_rows_total", "serving_stat_windows_total", "stat_drift_events_total",
    "router_requests_total", "router_failover_total", "router_backend_state",
    "scenario_aggregate_blocks_total", "scenario_frontier_probes_total",
)

#: The sweep's own families, pre-created like the JAX package's.
SWEEP_COUNTERS = (
    "shard_backoff_seconds_total", "chaos_injections_total", "checkpoint_torn_lines_total",
    "sweep_stage_total", "tree_dispatch_total", "xla_trace_total", "xprof_trace_total",
)

#: The ``torch.cuda.memory_stats`` keys the gauge records: every
#: allocator-wide byte count, current and peak.
_MEMORY_SUFFIXES = ("_bytes.all.current", "_bytes.all.peak")


def install_monitoring() -> None:
    """Pre-create the counter families at 0 (idempotent)."""
    for name in REQUIRED_COUNTERS + SWEEP_COUNTERS:
        counter(name).inc(0)


def record_device_memory(context: str = "") -> dict:
    """``torch.cuda.memory_stats`` byte counts as ``device_memory_bytes``
    gauges labeled by device, stat and ``context``; returns
    ``{device: stats}``. Nothing on a machine whose CUDA is not in use."""
    out: dict = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    g = gauge("device_memory_bytes", "torch.cuda.memory_stats() per device")
    for i in range(torch.cuda.device_count()):
        stats = {k: v for k, v in torch.cuda.memory_stats(i).items()
                 if k.endswith(_MEMORY_SUFFIXES)}
        if not stats:
            continue
        label = f"cuda:{i}"
        out[label] = stats
        for key, v in stats.items():
            labels = dict(device=label, stat=key)
            if context:
                labels["context"] = context
            g.set(float(v), **labels)
    return out
