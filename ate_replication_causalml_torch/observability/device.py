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

* :func:`watch_cache_dir` gauges a build cache directory at every
  snapshot (the JAX package's watch of XLA's persistent cache; the
  port's cache is the kernel build's directory of hash-named libraries);
* :func:`record_compiled_cost` records a built kernel library's
  ``ptxas`` resources (the JAX package's records XLA's cost and memory
  analysis of a compiled program): registers, stack and spill bytes and
  the ``nvcc`` wall.
"""

from __future__ import annotations

import os
import re

from ate_replication_causalml_torch.observability.registry import (
    REGISTRY,
    bucket_histogram,
    counter,
    enabled,
    gauge,
)

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

_WATCHED_CACHE_DIRS: set[str] = set()

# ptxas -v, one device function: "Used 40 registers, ..." and "N bytes
# stack frame, N bytes spill stores, N bytes spill loads".
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")
_PTXAS_FRAME = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def install_monitoring() -> None:
    """Pre-create the counter families at 0, and the router's request
    path split and e2e ladder, as the JAX package does (idempotent)."""
    for name in REQUIRED_COUNTERS + SWEEP_COUNTERS:
        counter(name).inc(0)
    counter("router_request_path_total",
            "router forwards by direct/failover/exhausted path").inc(0)
    bucket_histogram("router_request_seconds", "router-observed forward latency (e2e)")


def _scan_cache_dir(cache_dir: str) -> tuple[int, int]:
    entries = total = 0
    try:
        with os.scandir(cache_dir) as it:
            for e in it:
                if e.is_file():
                    entries += 1
                    total += e.stat().st_size
    except OSError:
        pass
    return entries, total


def watch_cache_dir(cache_dir: str) -> None:
    """Gauge ``cache_dir`` at every snapshot: ``compile_cache_entries`` /
    ``compile_cache_bytes`` (its files now) and
    ``compile_cache_entries_written`` (files added since the watch began).
    Once per directory: a second call would reset the baseline."""
    if not enabled() or cache_dir in _WATCHED_CACHE_DIRS:
        return
    _WATCHED_CACHE_DIRS.add(cache_dir)
    base_entries, _ = _scan_cache_dir(cache_dir)

    def collect() -> None:
        entries, total = _scan_cache_dir(cache_dir)
        gauge("compile_cache_entries", "build cache entry files").set(entries)
        gauge("compile_cache_bytes", "build cache total bytes").set(total)
        gauge("compile_cache_entries_written",
              "entries added since this process began the watch").set(
            max(0, entries - base_entries))

    REGISTRY.add_collector(collect)
    collect()


def record_compiled_cost(name: str, compiled) -> dict:
    """Record a built kernel library (``kernels.build.Built``: its
    ``ptxas`` report and ``seconds``) as ``compiled_cost`` gauges labeled
    ``entry=name``: the most registers and stack bytes of any of its
    device functions, their spill bytes (stores and loads) summed, and
    the ``nvcc`` wall in this process (0 when the library was reused).
    Returns the numbers."""
    out: dict = {}
    if not enabled():
        return out
    regs = [int(m) for m in _PTXAS_REGISTERS.findall(compiled.ptxas)]
    frames = [tuple(map(int, m)) for m in _PTXAS_FRAME.findall(compiled.ptxas)]
    if regs:
        out["registers"] = float(max(regs))
    if frames:
        out["stack_bytes"] = float(max(f[0] for f in frames))
        out["spill_bytes"] = float(sum(f[1] + f[2] for f in frames))
    out["nvcc_seconds"] = float(compiled.seconds)
    g = gauge("compiled_cost", "resources of each built kernel library")
    for key, v in out.items():
        g.set(v, entry=name, stat=key)
    return out


def record_device_memory(context: str = "") -> dict:
    """``torch.cuda.memory_stats`` byte counts as ``device_memory_bytes``
    gauges labeled by device, stat and ``context``; returns
    ``{device: stats}``. Nothing on a machine whose CUDA is not in use."""
    import torch

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
