"""CATE serving daemon of the port: a checkpointed causal forest
answering ``predict`` requests over the wire, on the card.

Port of the core of ``ate_replication_causalml_tpu/serving``:

* :mod:`.protocol` (length-prefixed framing, byte-identical to the JAX
  package's), :mod:`.coalescer` (deadline-window micro-batching onto
  declared buckets), :mod:`.admission` (bounded-depth admission and the
  lifecycle/reload state machine), :mod:`.fleet` (model routing and
  SLO-burn shedding) and :mod:`.client`: no tensor math;
* the daemon (:mod:`.daemon`): verified checkpoint load, one warmed
  predict per declared bucket (on the card one CUDA graph each), a
  dispatcher whose steady state provably builds and captures nothing,
  degraded-mode serving under the ``serve:`` chaos scope, deadlines, the
  dispatcher watchdog and graceful drain.

Entry point: ``python -m ate_replication_causalml_torch.serving``.
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
    "AdmissionController", "Batch", "BucketPlan", "BurnShedder",
    "CateClient", "CateServer", "Coalescer", "InvalidTransition",
    "ModelFleet", "ModelLifecycle", "PendingRequest", "ProtocolError",
    "RejectedRequest", "ReloadSupervisor", "ServeConfig", "ServingError",
    "ServingLifecycle", "ServingUnavailable", "decode_frame", "encode_frame",
    "parse_fleet_spec", "read_frame", "write_frame",
]


def __getattr__(name):
    # The daemon and the forest it loads resolve on first use.
    if name in ("CateServer", "ServeConfig", "RejectedRequest"):
        from ate_replication_causalml_torch.serving import daemon

        return getattr(daemon, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
