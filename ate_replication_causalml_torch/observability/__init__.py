"""In-process telemetry of the port: the metrics registry
(``counter``, ``gauge``, ``histogram``; ``REGISTRY``) and the event log
(``span``, ``emit``; ``EVENTS``). Host-side only."""

from ate_replication_causalml_torch.observability.events import EVENTS, EventLog, emit, span
from ate_replication_causalml_torch.observability.registry import (
    REGISTRY,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)

__all__ = ["EVENTS", "EventLog", "MetricsRegistry", "REGISTRY", "counter", "emit", "gauge",
           "histogram", "span"]
