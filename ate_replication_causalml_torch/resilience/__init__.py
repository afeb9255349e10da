"""Resilience layer of the port:

* :mod:`.chaos`: the ``ATE_TPU_CHAOS`` fault injector (shard faults,
  torn journal appends, dropped devices, stage failures, worker stalls),
  seeded and deterministic, every injection an observability event;
* :mod:`.errors`: the fatal-against-transient classification the shard
  runner retries by (CUDA errors fatal), and the typed failures;
* :mod:`.backoff`: the shard runner's jittered backoff;
* :mod:`.watchdog`: the heartbeat registry and lane bounds the sweep
  engine stamps, and the watchdog over the serving dispatcher;
* :mod:`.deadline`: the wall-clock :class:`~.deadline.Budget` a serving
  request carries;
* :mod:`.invariants` and :mod:`.campaign`: the chaos campaign, seeded
  multi-scope episodes over the real workloads judged by the invariant
  registry against fault-free references, and its delta-debugging
  shrinker.
"""

from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.errors import (
    FATAL_ERRORS,
    ChaosFault,
    ChaosRotateFault,
    ChaosServeFault,
    ChaosShardFault,
    ChaosSpecError,
    ChaosStageFault,
    CheckpointCorrupt,
    CudaKernelError,
    DeadlineExceeded,
    NonFiniteResult,
    classify,
    transient_errors,
)
from ate_replication_causalml_torch.resilience.deadline import Budget
from ate_replication_causalml_torch.resilience.watchdog import (
    HeartbeatRegistry,
    Watchdog,
    lane_bound_s,
)

__all__ = ["Budget", "FATAL_ERRORS", "ChaosFault", "ChaosRotateFault", "ChaosServeFault",
           "ChaosShardFault", "ChaosSpecError",
           "ChaosStageFault", "CheckpointCorrupt", "CudaKernelError", "DeadlineExceeded",
           "HeartbeatRegistry", "NonFiniteResult", "chaos", "classify", "lane_bound_s",
           "transient_errors", "Watchdog"]
