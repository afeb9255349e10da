"""CATE serving daemon of the port: a checkpointed causal forest
answering ``predict`` requests over the wire, on the card.

Port of ``ate_replication_causalml_tpu/serving``:

* :mod:`.protocol` (length-prefixed framing, byte-identical to the JAX
  package's), :mod:`.coalescer` (deadline-window micro-batching onto
  declared buckets), :mod:`.admission` (bounded-depth admission, the
  lifecycle/reload state machine and verified rotation), :mod:`.fleet`
  (model routing, rotation's swap, retirement, SLO-burn shedding),
  :mod:`.client`, :mod:`.admin` (the read-only HTTP endpoint),
  :mod:`.retrain` (fit → publish → rotate) and :mod:`.loadgen` (seeded
  open-loop load): no tensor math;
* the daemon (:mod:`.daemon`): verified checkpoint load, one warmed
  predict per declared bucket (on the card one CUDA graph each), the
  leaf-index build of a fitted checkpoint, a dispatcher whose steady
  state provably builds and captures nothing, degraded-mode serving
  under the ``serve:`` chaos scope, deadlines, the dispatcher watchdog,
  graceful drain, statistical health, zero-downtime rotation,
  retirement, retraining and live artifact dumps;
* the router (:mod:`.router`): one service over N daemons (the hash
  ring, probe-driven membership, failover and the circuit breaker, the
  rolling ``rotate_all``, the merged fleet dump); it loads no torch.

Entry points: ``python -m ate_replication_causalml_torch.serving`` (a
daemon) and ``python -m ate_replication_causalml_torch.serving.router``.
"""

from ate_replication_causalml_torch.serving.admission import (
    AdmissionController,
    InvalidTransition,
    ReloadSupervisor,
    ServingLifecycle,
)
from ate_replication_causalml_torch.serving.client import (
    CateClient,
    ServingError,
    ServingUnavailable,
)
from ate_replication_causalml_torch.serving.coalescer import (
    Batch,
    BucketPlan,
    Coalescer,
    PendingRequest,
)
from ate_replication_causalml_torch.serving.fleet import (
    BurnShedder,
    ModelFleet,
    ModelLifecycle,
    parse_fleet_spec,
)
from ate_replication_causalml_torch.serving.protocol import (
    ProtocolError,
    decode_frame,
    encode_frame,
    read_frame,
    write_frame,
)

__all__ = [
    "AdmissionController", "BackendSpec", "Batch", "BucketPlan", "BurnShedder",
    "CateClient", "CateServer", "CircuitBreaker", "Coalescer", "ConsistentHashRing",
    "FleetSupervisor", "InvalidTransition", "ModelFleet", "ModelLifecycle",
    "PendingRequest", "ProtocolError", "RejectedRequest", "ReloadSupervisor",
    "RouterConfig", "RouterServer", "ServeConfig", "ServingError", "ServingLifecycle",
    "ServingUnavailable", "decode_frame", "encode_frame", "parse_backend_specs",
    "parse_fleet_spec", "read_frame", "write_frame",
]

_ROUTER_NAMES = ("BackendSpec", "CircuitBreaker", "ConsistentHashRing", "FleetSupervisor",
                 "RouterConfig", "RouterServer", "parse_backend_specs")


def __getattr__(name):
    # The daemon and the forest it loads resolve on first use; so does
    # the router, which ``python -m ...serving.router`` runs as __main__.
    if name in ("CateServer", "ServeConfig", "RejectedRequest"):
        from ate_replication_causalml_torch.serving import daemon

        return getattr(daemon, name)
    if name in _ROUTER_NAMES:
        from ate_replication_causalml_torch.serving import router

        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
