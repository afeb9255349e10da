"""Model-fleet state of the CATE serving daemon.

Port of ``ate_replication_causalml_tpu/serving/fleet.py`` (pure Python):

* :class:`ModelFleet`: the lock-guarded registry of served models. Each
  :class:`ModelEntry` carries the forest reference, a version, the
  geometry signature its warmed predicts were built for, and its own
  lifecycle. A dispatcher reads one consistent ``(forest, version)``
  binding a batch.
* :class:`ModelLifecycle`: per-model ``serving ⇄ degraded`` state, the
  small sibling of the daemon-wide
  :class:`~.admission.ServingLifecycle`: one tenant's degradation gates
  only that tenant's requests.
* :class:`BurnShedder`: SLO-burn-driven admission: a model sheds (typed
  ``shed`` reject with retry-after) while its two fastest SLO windows
  both burn above the threshold. Shed rejects are excluded from the
  driving SLO's totals, so shedding cannot latch.
* :func:`parse_fleet_spec`: the ``ATE_TPU_SERVE_FLEET`` grammar
  (``"tenantA=/path/a.npz,tenantB=/path/b.npz"``).

Same-shape models share warmed predicts: the daemon keys them by
(geometry signature, bucket) and takes the forest as a runtime argument.
Rotation (``swap``), retirement and the leaf-index prebuild of the JAX
package's fleet come with rotation, which is not ported yet.
"""

from __future__ import annotations

import threading

from ate_replication_causalml_torch.observability import events as _events

#: Per-model lifecycle states.
MODEL_SERVING = "serving"
MODEL_DEGRADED = "degraded"


def parse_fleet_spec(spec: str) -> tuple[tuple[str, str], ...]:
    """Parse ``ATE_TPU_SERVE_FLEET``: comma-separated ``id=path`` pairs.
    Ids must be unique and non-empty; a malformed spec raises at config
    time, never silently serves a partial fleet."""
    out: list[tuple[str, str]] = []
    seen: set[str] = set()
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        model_id, eq, path = item.partition("=")
        model_id = model_id.strip()
        path = path.strip()
        if not eq or not model_id or not path:
            raise ValueError(
                f"bad fleet entry {item!r} (want id=path) in {spec!r}"
            )
        if model_id in seen:
            raise ValueError(f"duplicate fleet model id {model_id!r} in {spec!r}")
        seen.add(model_id)
        out.append((model_id, path))
    return tuple(out)


class ModelLifecycle:
    """Per-model ``serving ⇄ degraded`` state machine. Starts SERVING (a
    model enters the fleet only after its checkpoint verified).
    Implements the protocol :class:`~.admission.ReloadSupervisor`
    drives: ``mark_fault`` returns True to exactly one caller (the owner
    of recovery), ``mark_recovered`` flips back. Every transition is a
    ``serving_model_state`` event labeled by model."""

    def __init__(self, model_id: str):
        self.model_id = model_id
        self._lock = threading.Lock()
        self._state = MODEL_SERVING
        self._fault_count = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def can_serve(self) -> bool:
        return self.state == MODEL_SERVING

    def mark_fault(self, reason: str) -> bool:
        """Report a model-scoped fault. True to the one caller that
        moved SERVING → DEGRADED (it owns recovery); concurrent
        reporters, and reports on a degraded model, get False."""
        with self._lock:
            self._fault_count += 1
            if self._state != MODEL_SERVING:
                return False
            self._state = MODEL_DEGRADED
        _events.emit("serving_model_state", status="error",
                     model=self.model_id, frm=MODEL_SERVING,
                     to=MODEL_DEGRADED, reason=reason)
        return True

    def mark_recovered(self) -> None:
        with self._lock:
            if self._state != MODEL_DEGRADED:
                raise RuntimeError(f"model {self.model_id!r} cannot recover from {self._state!r}")
            self._state = MODEL_SERVING
        _events.emit("serving_model_state", status="ok", model=self.model_id,
                     frm=MODEL_DEGRADED, to=MODEL_SERVING)

    @property
    def fault_count(self) -> int:
        with self._lock:
            return self._fault_count


class ModelEntry:
    """One served model: the forest reference and its metadata. The
    forest is replaced only through :class:`ModelFleet` under the fleet
    lock; ``lifecycle`` and ``supervisor`` lock themselves."""

    __slots__ = ("model_id", "forest", "version", "sig", "n_features", "checkpoint",
                 "lifecycle", "supervisor")

    def __init__(self, model_id: str, forest, sig, n_features: int, checkpoint: str):
        self.model_id = model_id
        self.forest = forest
        self.version = 1
        self.sig = sig
        self.n_features = int(n_features)
        self.checkpoint = checkpoint
        self.lifecycle = ModelLifecycle(model_id)
        self.supervisor = None  # wired by the daemon after install


class ModelFleet:
    """Lock-guarded model registry; the daemon's routing table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, ModelEntry] = {}

    def install(self, model_id: str, forest, sig, n_features: int,
                checkpoint: str) -> ModelEntry:
        """Register a verified model at version 1 (startup only)."""
        entry = ModelEntry(model_id, forest, sig, n_features, checkpoint)
        with self._lock:
            if model_id in self._entries:
                raise ValueError(f"model {model_id!r} already installed")
            self._entries[model_id] = entry
        return entry

    def get(self, model_id: str) -> ModelEntry | None:
        with self._lock:
            return self._entries.get(model_id)

    def ids(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._entries)

    def binding(self, model_id: str):
        """Consistent ``(forest, version)`` read — the pair a dispatch
        binds. One lock acquisition, so a concurrent reinstall yields either
        the old pair or the new one, never a mix."""
        with self._lock:
            entry = self._entries[model_id]
            return entry.forest, entry.version

    def reinstall(self, model_id: str, forest) -> None:
        """Degraded-recovery install: replace the forest reference with
        the re-verified LAST GOOD bytes. The version does not advance: a
        recovery is not a rotation, and bit-identity across it is the
        point."""
        with self._lock:
            self._entries[model_id].forest = forest

    def describe(self) -> dict:
        """The ``stats`` op's fleet section. Entry fields are read
        UNDER the fleet lock — a snapshot racing a reinstall must never
        show the new version paired with the old checkpoint path."""
        with self._lock:
            out = {
                e.model_id: {
                    "version": e.version,
                    "checkpoint": e.checkpoint,
                    "n_features": e.n_features,
                }
                for e in self._entries.values()
            }
            entries = list(self._entries.values())
        for e in entries:  # lifecycle has its own lock
            out[e.model_id]["state"] = e.lifecycle.state
            out[e.model_id]["faults"] = e.lifecycle.fault_count
        return out


class BurnShedder:
    """Per-model admission shedding driven by SLO burn rates.

    Reads per-model availability SLOs (named ``fleet:<model>``, built
    by :func:`~..observability.slo.fleet_slos`) out of one
    :class:`~..observability.slo.SLOEngine` report. A model sheds when
    its two fastest windows BOTH burn above ``threshold`` — fast-window
    detection with slow-window confirmation, so one bad batch in an
    otherwise healthy minute cannot flap admission. ``threshold <= 0``
    disables shedding entirely.

    The request path reads ONLY the cached dict — never a full engine
    evaluation (one stale-cache burst would otherwise thunder-herd N
    concurrent connection readers into N simultaneous engine scans on
    the admission hot path). :meth:`update` is the single refresher:
    the daemon calls it from the dispatcher after each batch (so the
    cache is at most one batch stale — exactly as fresh as the SLO
    data feeding it), tests call it directly."""

    SLO_PREFIX = "fleet:"

    def __init__(self, engine, threshold: float):
        self._engine = engine
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        self._burns: dict[str, float] = {}

    def _confirmed_burn(self, slo_report: dict) -> float:
        """The shedding figure for one SLO: the *minimum* of the two
        fastest windows' burn rates (both must exceed the threshold for
        the min to)."""
        windows = slo_report.get("windows", [])[:2]
        if not windows:
            return 0.0
        return min(w.get("burn_rate", 0.0) for w in windows)

    def update(self) -> dict[str, float]:
        """Evaluate the engine now and cache per-model confirmed burn
        rates; returns the fresh map. The ONLY evaluation site —
        called from the dispatcher per batch, never the request
        path."""
        if self.threshold <= 0.0:
            return {}
        report = self._engine.evaluate()
        burns = {
            s["name"][len(self.SLO_PREFIX):]: self._confirmed_burn(s)
            for s in report.get("slos", [])
            if str(s.get("name", "")).startswith(self.SLO_PREFIX)
        }
        with self._lock:
            self._burns = burns
        return dict(burns)

    def burns(self) -> dict[str, float]:
        with self._lock:
            return dict(self._burns)

    def should_shed(self, model_id: str) -> bool:
        """Pure cache read — O(dict lookup) on the admission path."""
        if self.threshold <= 0.0:
            return False
        with self._lock:
            return self._burns.get(model_id, 0.0) > self.threshold
