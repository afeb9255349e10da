"""CATE serving daemon: a checkpointed causal forest answering ``predict``
requests, on the card.

Port of the core of ``ate_replication_causalml_tpu/serving/daemon.py``.
A long-lived process loads a fitted forest once and serves τ̂(x) (and
its variance) for batches of new rows, with a steady state that
provably builds and captures nothing.

Startup phases (each a span and a ``serving_startup_seconds`` gauge):

1. **load**: ``utils/checkpoint.load_fitted`` with SHA-256 verification,
   onto ``ServeConfig.device`` (``cuda`` unless told otherwise); a torn or
   tampered checkpoint refuses to serve. The checkpoint may come from
   either package.
2. **aot**: one warmed predict per declared batch bucket
   (``models/causal_forest.py::lower_predict_cate``): on the card the
   kernels are built (``kernels/build.py``) and ``predict_cate`` is
   captured as one CUDA graph per bucket, the forest a runtime argument
   copied into the captured buffers, so a same-shape reload reuses the
   graphs.
3. **warm**: one zero batch through every bucket's predict.

After warm the daemon marks ``kernel_builds_total`` and
``graph_captures_total``; :meth:`CateServer.stop` asserts the serving
window left both unchanged (the port's counterpart of the JAX package's
``jax_compiles_total`` window). On the card a batch is one copy into the
bucket's static query buffer, one graph replay (the ``traverse`` kernel
once per tree chunk, ``binarize`` and the moment sums as PyTorch ops
inside the graph) and one host read.

The serving core wires together admission (bounded depth, typed
reject-on-overload), the coalescer (micro-batch within a deadline
window, pad to the nearest bucket), the lifecycle and reload supervisor
(degraded mode: on a fault, injected through the ``serve:`` chaos scope
or real, requests get typed retry-after rejects while the checkpoint is
re-verified and reloaded; the answers after recovery are bit-identical,
the model being the same verified bytes), the fleet (models routed by
the header's ``model`` field, typed rejects for unknown ids, per-model
lifecycles, SLO-burn shedding), end-to-end deadlines (the header's
``deadline_ms`` as a :class:`~..resilience.deadline.Budget` checked at
admission, batch close and dispatch pickup), the dispatcher's heartbeat
watchdog, and graceful drain.

Thread model: any number of producer threads call :meth:`submit` /
:meth:`serve_one`; they only enqueue numpy. ONE dispatcher thread owns
the device (host threads collapse the card's dispatch rate, so nothing
else launches).

Not ported yet (each answers the JAX package's typed ``unknown op`` over
the wire): the statistical-health plane, the serving trace with
``dump_artifacts`` and the ``dump`` op, the admin endpoint, rotation,
retirement and the retrain supervisor.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time
from typing import Callable

import numpy as np

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.observability.slo import (
    DEFAULT_WINDOWS,
    SLOEngine,
    default_serving_slos,
    fleet_slos,
)
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.deadline import Budget
from ate_replication_causalml_torch.resilience.watchdog import (
    HeartbeatRegistry,
    Watchdog,
    lane_bound_s,
    poll_s_from_env,
)
from ate_replication_causalml_torch.serving import protocol
from ate_replication_causalml_torch.serving.admission import (
    STOPPED,
    AdmissionController,
    ReloadSupervisor,
    ServingLifecycle,
)
from ate_replication_causalml_torch.serving.coalescer import (
    Batch,
    BucketPlan,
    Coalescer,
    FusionPlan,
    PendingRequest,
)
from ate_replication_causalml_torch.serving.fleet import (
    BurnShedder,
    ModelFleet,
    parse_fleet_spec,
)

ENV_BUCKETS = "ATE_TPU_SERVE_BUCKETS"
ENV_WINDOW_MS = "ATE_TPU_SERVE_WINDOW_MS"
ENV_DEPTH = "ATE_TPU_SERVE_DEPTH"
ENV_RETRY_AFTER_MS = "ATE_TPU_SERVE_RETRY_AFTER_MS"
ENV_SLO_MS = "ATE_TPU_SERVE_SLO_MS"
ENV_FLEET = "ATE_TPU_SERVE_FLEET"
ENV_SHED_BURN = "ATE_TPU_SERVE_FLEET_SHED_BURN"
ENV_FUSE = "ATE_TPU_SERVE_FUSE"
ENV_DRAIN_S = "ATE_TPU_SERVE_DRAIN_S"

DEFAULT_BUCKETS = "1,8,64,256"
DEFAULT_WINDOW_MS = 2.0
DEFAULT_DEPTH = 64
DEFAULT_RETRY_AFTER_MS = 50.0
DEFAULT_SLO_LATENCY_MS = 250.0
#: graceful-drain bound: in-flight work must complete within this many
#: seconds of a SIGTERM or a ``drain`` op.
DEFAULT_DRAIN_S = 30.0
#: dispatcher heartbeat staleness bound; 0 disables the watchdog.
DEFAULT_WATCHDOG_DISPATCH_S = 30.0

#: the dispatcher's watchdog lane name.
DISPATCH_LANE = "dispatch"

#: the model id requests without a ``model`` header route to.
DEFAULT_MODEL = "default"

#: how often the dispatcher refreshes the shedder's burn cache.
SHED_REFRESH_S = 0.25

#: the registry families the no-build window reads.
BUILD_FAMILIES = {"kernel": "kernel_builds_total", "graph": "graph_captures_total"}


class RejectedRequest(RuntimeError):
    """A typed reject: the wire ``error`` code and the retry-after hint.
    :meth:`CateServer.submit` raises it; the protocol layer turns it into
    a reject frame."""

    def __init__(self, code: str, message: str, retry_after_s: float | None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Daemon configuration; :meth:`from_env` reads the JAX package's
    ``ATE_TPU_SERVE_*`` knobs."""

    checkpoint: str
    buckets: BucketPlan = dataclasses.field(
        default_factory=lambda: BucketPlan.parse(DEFAULT_BUCKETS))
    window_s: float = DEFAULT_WINDOW_MS / 1e3
    max_depth: int = DEFAULT_DEPTH
    retry_after_s: float = DEFAULT_RETRY_AFTER_MS / 1e3
    #: None or "pallas": the port's kernels (``predict_cate``'s).
    row_backend: str | None = None
    variance_compat: str = "unbiased"
    tree_chunk: int = 32
    #: latency-SLO threshold: requests over it spend the error budget.
    slo_latency_s: float = DEFAULT_SLO_LATENCY_MS / 1e3
    #: multi-window burn-rate ladder (ascending).
    slo_windows_s: tuple[float, ...] = DEFAULT_WINDOWS
    #: extra served models, ``(model_id, checkpoint)`` pairs beyond
    #: ``checkpoint`` (which serves as DEFAULT_MODEL).
    fleet: tuple[tuple[str, str], ...] = ()
    #: per-model shedding threshold on the two fastest burn windows;
    #: <= 0 disables shedding.
    shed_burn_threshold: float = 0.0
    #: bucket fusion: adjacent buckets share ONE masked predict (on the
    #: card one graph) per group, its masked region back-filled.
    fuse_buckets: bool = False
    #: graceful-drain bound (seconds).
    drain_timeout_s: float = DEFAULT_DRAIN_S
    #: dispatcher heartbeat staleness bound (seconds; <= 0 disables).
    watchdog_dispatch_s: float = DEFAULT_WATCHDOG_DISPATCH_S
    #: watchdog poll cadence.
    watchdog_poll_s: float = 0.25
    #: where the forests live and the predicts run: ``cuda`` unless told
    #: otherwise (``"cpu"`` runs the plain versions, as the tests do).
    device: str | None = None

    @classmethod
    def from_env(cls, checkpoint: str, **overrides) -> "ServeConfig":
        env = os.environ
        base = dict(
            buckets=BucketPlan.parse(env.get(ENV_BUCKETS, DEFAULT_BUCKETS)),
            window_s=float(env.get(ENV_WINDOW_MS, DEFAULT_WINDOW_MS)) / 1e3,
            max_depth=int(env.get(ENV_DEPTH, DEFAULT_DEPTH)),
            retry_after_s=float(env.get(ENV_RETRY_AFTER_MS, DEFAULT_RETRY_AFTER_MS)) / 1e3,
            slo_latency_s=float(env.get(ENV_SLO_MS, DEFAULT_SLO_LATENCY_MS)) / 1e3,
            fleet=parse_fleet_spec(env.get(ENV_FLEET, "")),
            shed_burn_threshold=float(env.get(ENV_SHED_BURN, 0.0)),
            fuse_buckets=env.get(ENV_FUSE, "0").strip().lower() in ("1", "true", "on"),
            drain_timeout_s=float(env.get(ENV_DRAIN_S, DEFAULT_DRAIN_S)),
            watchdog_dispatch_s=lane_bound_s(DISPATCH_LANE, DEFAULT_WATCHDOG_DISPATCH_S),
            watchdog_poll_s=poll_s_from_env(),
        )
        base.update(overrides)
        return cls(checkpoint=checkpoint, **base)

    @property
    def model_ids(self) -> tuple[str, ...]:
        """Every served model id, DEFAULT_MODEL first."""
        ids = (DEFAULT_MODEL,) + tuple(m for m, _ in self.fleet)
        if len(set(ids)) != len(ids):
            raise ValueError(f"fleet model ids collide with {DEFAULT_MODEL!r}: {ids}")
        return ids


def _build_count() -> dict[str, float]:
    """Process-wide kernel builds and graph captures so far."""
    out = {}
    for kind, family in BUILD_FAMILIES.items():
        vals = obs.REGISTRY.peek(family)
        out[kind] = float(sum(vals.values())) if vals else 0.0
    return out


class CateServer:
    """The serving core: verified load → warmed predicts → steady
    dispatch. Producer threads call :meth:`submit` / :meth:`serve_one`;
    ONE dispatcher thread owns the device. Shared state is mutated only
    under ``self._lock``."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.lifecycle = ServingLifecycle()
        self.admission = AdmissionController(config.max_depth)
        self.coalescer = Coalescer(config.buckets, config.window_s,
                                   on_expired=self._on_expired_waiters)
        self.heartbeats = HeartbeatRegistry()
        self._watchdog: Watchdog | None = None
        self._stopped = False
        #: drain rendezvous: set, with the outcome, once the owning drain
        #: has finished, so concurrent drain callers get its real outcome.
        self._drain_done = threading.Event()
        self._drain_outcome: str | None = None
        self._drain_bound: float | None = None
        self._fusion = FusionPlan.pair_adjacent(config.buckets) if config.fuse_buckets else None
        self._lock = threading.RLock()
        self.fleet = ModelFleet()
        #: warmed predicts keyed by (geometry signature, bucket), or
        #: (signature, "fused", width): same-shape models share them.
        self._predicts: dict[tuple, object] = {}
        # None until startup completes: a daemon stopped before its warm
        # phase has no serving window to enforce.
        self._build_mark: dict[str, float] | None = None
        self._startup_s: dict[str, float] = {}
        self._dispatcher: threading.Thread | None = None
        # The daemon-wide reloader: serve-scope faults degrade the whole
        # daemon and re-verify the default model's checkpoint. Per-model
        # faults go through each entry's own supervisor.
        self._reloader = ReloadSupervisor(self.lifecycle, self._load_checkpoint,
                                          self._install_model)
        # The statistical-health objectives (stat_health_slos) come with
        # the statistical-health plane, which is not ported yet.
        self.slo = SLOEngine(
            default_serving_slos(latency_threshold_s=config.slo_latency_s,
                                 windows_s=config.slo_windows_s)
            + fleet_slos(config.model_ids, windows_s=config.slo_windows_s))
        self._shedder = BurnShedder(self.slo, threshold=config.shed_burn_threshold)
        self._shed_next_update = float("-inf")
        self._requests = obs.counter("serving_requests_total",
                                     "CATE serving requests by terminal status")
        self._rejects = obs.counter("serving_rejected_total", "CATE serving rejections by reason")
        self._batches = obs.counter("serving_batches_total", "dispatched micro-batches by bucket")
        self._latency = obs.bucket_histogram("serving_request_seconds",
                                             "served request latency (enqueue to reply)")
        self._fill = obs.bucket_histogram("serving_batch_fill",
                                          "micro-batch fill ratio (real rows / bucket rows)",
                                          bounds=obs.PAD_FRACTION_BOUNDS)
        self._phase_hist = obs.bucket_histogram("serving_phase_seconds",
                                                "per-request lifecycle phase durations")
        self._phase_total = obs.counter("serving_phase_seconds_total",
                                        "summed per-request lifecycle phase seconds")
        self._close_reasons = obs.counter("serving_batch_close_total",
                                          "micro-batch close reasons")
        # ``pad``: unmasked pad rows a per-bucket dispatch computes and
        # discards; ``masked``: a fused dispatch's exact-zero region.
        self._pad = obs.bucket_histogram(
            "serving_pad_fraction", "unmasked pad fraction of per-bucket dispatches",
            bounds=obs.PAD_FRACTION_BOUNDS)
        self._masked = obs.bucket_histogram(
            "serving_masked_fraction", "masked fraction of fused-bucket dispatches",
            bounds=obs.PAD_FRACTION_BOUNDS)
        self._pad_rows = obs.counter("serving_pad_rows_total",
                                     "unmasked pad rows dispatched by per-bucket predicts")
        self._masked_rows = obs.counter("serving_masked_rows_total",
                                        "masked (exact-zero) rows dispatched by fused predicts")
        self._fleet_requests = obs.counter(
            "serving_fleet_requests_total",
            "fleet-routed serving requests by model and terminal status")
        self._deadline_rejects = obs.counter(
            "serving_deadline_exceeded_total",
            "requests rejected typed for an expired deadline, by phase")
        self._drains = obs.counter("drain_total", "graceful-drain outcomes")

    # ── startup ──────────────────────────────────────────────────────

    def _load_model(self, path: str):
        """SHA-256-verified model load onto the configured device; takes
        a ``FittedCausalForest`` or a bare ``CausalForest`` checkpoint.
        Raises ``CheckpointCorrupt`` (startup: refuse to serve; degraded
        reload: stay degraded) on any integrity failure."""
        from ate_replication_causalml_torch.models.causal_forest import (
            CausalForest,
            FittedCausalForest,
        )
        from ate_replication_causalml_torch.utils.checkpoint import load_fitted

        obj = load_fitted(path, device=self.config.device, verify=True)
        forest = obj.forest if isinstance(obj, FittedCausalForest) else obj
        if not isinstance(forest, CausalForest):
            raise TypeError(f"checkpoint {path!r} holds {type(obj).__name__}, "
                            "not a causal forest")
        return forest

    def _load_checkpoint(self):
        """The daemon-wide reloader's reload_fn: re-verify the DEFAULT
        model's last good checkpoint."""
        entry = self.fleet.get(DEFAULT_MODEL)
        return self._load_model(entry.checkpoint if entry is not None else self.config.checkpoint)

    @staticmethod
    def _forest_signature(forest) -> tuple:
        """The geometry warmed predicts are shared under: the little-bag
        size and every tensor field's (name, shape, dtype)."""
        return (forest.ci_group_size,) + tuple(
            (f.name, tuple(getattr(forest, f.name).shape), str(getattr(forest, f.name).dtype))
            for f in dataclasses.fields(forest) if f.name != "ci_group_size")

    def _install_model(self, forest) -> None:
        """Reinstall the DEFAULT model (the daemon-wide degraded reload):
        the re-verified last good bytes go back without a version bump.
        A reload with another geometry is refused (it would need new
        predicts)."""
        entry = self.fleet.get(DEFAULT_MODEL)
        if entry is None:
            raise RuntimeError("default model was never installed")
        if self._forest_signature(forest) != entry.sig:
            raise ValueError(f"reloaded checkpoint changed forest geometry for model "
                             f"{DEFAULT_MODEL!r}; restart the daemon to warm new predicts")
        self.fleet.reinstall(DEFAULT_MODEL, forest)

    def _wire_model_supervisor(self, entry) -> None:
        """Per-model degraded recovery: a model-scoped fault re-verifies
        and reloads that model's last good checkpoint while only its
        requests are refused. The default model's supervisor is the
        daemon-wide reloader."""
        if entry.model_id == DEFAULT_MODEL:
            entry.supervisor = self._reloader
            return

        def reload_last_good():
            forest = self._load_model(entry.checkpoint)
            if self._forest_signature(forest) != entry.sig:
                raise ValueError(f"model {entry.model_id!r} last-good checkpoint "
                                 "changed geometry on reload")
            return forest

        entry.supervisor = ReloadSupervisor(
            entry.lifecycle, reload_last_good,
            lambda forest: self.fleet.reinstall(entry.model_id, forest))

    def _warm_widths(self) -> tuple[tuple, ...]:
        """(key suffix, width, masked) of every predict a geometry needs."""
        if self._fusion is not None:
            return tuple((("fused", w), w, True) for w in self._fusion.widths)
        return tuple(((b,), b, False) for b in self.config.buckets.sizes)

    def startup(self) -> dict[str, float]:
        """Run the three startup phases; returns their seconds (also the
        ``serving_startup_seconds{phase=}`` gauges). *load* verifies and
        installs every model; *aot* and *warm* run once per distinct
        geometry."""
        from ate_replication_causalml_torch.models.causal_forest import (
            lower_predict_cate,
            lower_predict_cate_masked,
        )

        obs.install_monitoring()
        phases: dict[str, float] = {}
        specs = [(DEFAULT_MODEL, self.config.checkpoint)] + list(self.config.fleet)
        with obs.span("serving_startup", checkpoint=self.config.checkpoint,
                      models=",".join(m for m, _ in specs)):
            t0 = time.perf_counter()
            with obs.span("serving_load"):
                for model_id, path in specs:
                    forest = self._load_model(path)
                    entry = self.fleet.install(model_id, forest, self._forest_signature(forest),
                                               int(forest.bin_edges.shape[0]), path)
                    self._wire_model_supervisor(entry)
            phases["load"] = time.perf_counter() - t0

            reps: dict[tuple, object] = {}
            for model_id, _ in specs:
                entry = self.fleet.get(model_id)
                reps.setdefault(entry.sig, entry.forest)

            t0 = time.perf_counter()
            for sig, model in reps.items():
                for suffix, width, masked in self._warm_widths():
                    lower = lower_predict_cate_masked if masked else lower_predict_cate
                    with obs.span("serving_aot_compile", bucket=width, fused=int(masked)):
                        warm = lower(model, width, oob=False, tree_chunk=self.config.tree_chunk,
                                     row_backend=self.config.row_backend,
                                     variance_compat=self.config.variance_compat)
                    with self._lock:
                        self._predicts[(sig,) + suffix] = warm
            phases["aot"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            with obs.span("serving_warm"):
                for sig, model in reps.items():
                    p = int(model.bin_edges.shape[0])
                    for suffix, width, masked in self._warm_widths():
                        zeros = np.zeros((width, p), np.float32)
                        args = (np.ones((width,), np.float32),) if masked else ()
                        self._predicts[(sig,) + suffix](model, zeros, *args)
            phases["warm"] = time.perf_counter() - t0

        g = obs.gauge("serving_startup_seconds", "daemon startup phase durations")
        for phase, secs in phases.items():
            g.set(secs, phase=phase)
        with self._lock:
            self._startup_s = dict(phases)
            self._build_mark = _build_count()
        self.lifecycle.mark_ready()
        self._start_dispatcher()
        self._start_watchdog()
        return phases

    def _start_watchdog(self) -> None:
        """Arm the dispatcher-liveness watchdog."""
        if self.config.watchdog_dispatch_s <= 0:
            return
        wd = Watchdog(self.heartbeats, {DISPATCH_LANE: self.config.watchdog_dispatch_s},
                      poll_s=self.config.watchdog_poll_s, on_stall=self._on_lane_stall,
                      on_recover=self._on_lane_recover)
        with self._lock:
            self._watchdog = wd
        wd.start()

    def _on_lane_stall(self, lane: str, age_s: float) -> None:
        """A stalled dispatcher degrades the daemon (typed rejects with
        retry-after) instead of queueing behind a wedged device call. No
        reload here: recovery waits for the heartbeat itself."""
        if lane == DISPATCH_LANE:
            self.lifecycle.mark_fault(f"watchdog:{lane} heartbeat stale {age_s:.3f}s")

    def _on_lane_recover(self, lane: str, stalled_s: float) -> None:
        """The heartbeat resumed: run the verified-reload recovery."""
        if lane == DISPATCH_LANE:
            self._reloader.retry()

    def stalled_lanes(self) -> tuple[str, ...]:
        with self._lock:
            wd = self._watchdog
        return wd.stalled() if wd is not None else ()

    def _start_dispatcher(self) -> None:
        with self._lock:
            t = self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                    name="serving-dispatch", daemon=True)
        t.start()

    # ── request path (producers) ─────────────────────────────────────

    def _reject(self, code: str, message: str, retry_after_s: float | None = None,
                request_id: str = "", model: str = "") -> RejectedRequest:
        self._rejects.inc(1, reason=code)
        self._requests.inc(1, status=f"rejected_{code}")
        if model:
            self._fleet_requests.inc(1, model=model, status=f"rejected_{code}")
        obs.emit("serving_reject", status="error", reason=code, request_id=str(request_id),
                 model=model)
        return RejectedRequest(code, message, retry_after_s)

    def submit(self, request_id: str, x: np.ndarray, model: str | None = None,
               deadline_ms: float | None = None) -> PendingRequest:
        """Admission + routing + chaos + coalesce. ``model`` selects the
        fleet entry (None/"" routes to DEFAULT_MODEL); ``deadline_ms`` is
        the caller's remaining budget. Returns the pending handle the
        caller waits on; raises :class:`RejectedRequest` for every typed
        refusal. The dispatcher releases the admission slot."""
        model_id = model if model else DEFAULT_MODEL
        try:
            x = np.ascontiguousarray(x, dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise self._reject("bad_request", f"x does not convert to float32 ({e})",
                               request_id=request_id) from e
        if x.ndim != 2:
            raise self._reject("bad_request", f"x must be 2-D, got {x.shape}",
                               request_id=request_id)
        entry = self.fleet.get(model_id)
        if entry is None:
            if not self.fleet.ids():
                state = self.lifecycle.state
                raise self._reject(state, f"daemon is {state}", self.config.retry_after_s,
                                   request_id=request_id)
            raise self._reject("unknown_model",
                               f"unknown model {model_id!r} "
                               f"(serving: {', '.join(sorted(self.fleet.ids()))})",
                               request_id=request_id, model="_unknown_")
        p = entry.n_features
        if x.shape[1] != p:
            raise self._reject("bad_request", f"x has {x.shape[1]} features, model wants {p}",
                               request_id=request_id, model=model_id)
        rows = x.shape[0]
        if rows < 1 or rows > self.config.buckets.max_rows:
            raise self._reject("bad_request",
                               f"rows must be in [1, {self.config.buckets.max_rows}], "
                               f"got {rows} (chunk larger queries client-side)",
                               request_id=request_id, model=model_id)
        budget = None
        if deadline_ms is not None:
            try:
                budget = Budget.from_ms(deadline_ms)
            except (TypeError, ValueError) as e:
                raise self._reject("bad_request",
                                   f"deadline_ms {deadline_ms!r} is not a number ({e})",
                                   request_id=request_id, model=model_id) from e
            if budget.expired():
                self._deadline_rejects.inc(1, phase="admission")
                raise self._reject("deadline_exceeded",
                                   f"deadline of {deadline_ms}ms expired at admission",
                                   self.config.retry_after_s, request_id=request_id,
                                   model=model_id)
        inj = chaos.active()
        if inj is not None and inj.take_serve_fault(request_id):
            # The injected fault walks the real degraded path: the reload
            # re-verifies the checkpoint in the background while this
            # (and any concurrent) request is refused typed.
            self._reloader.report_fault(f"chaos:req/{request_id}")
            raise self._reject("serve_fault",
                               "injected serving fault; degraded-mode recovery running",
                               self.config.retry_after_s, request_id=request_id,
                               model=model_id)
        if not entry.lifecycle.can_serve():
            raise self._reject("model_degraded",
                               f"model {model_id!r} is {entry.lifecycle.state}; "
                               "recovery running", self.config.retry_after_s,
                               request_id=request_id, model=model_id)
        if self._shedder.should_shed(model_id):
            raise self._reject("shed", f"model {model_id!r} is shedding load "
                                       "(SLO burn over threshold)",
                               self.config.retry_after_s, request_id=request_id,
                               model=model_id)
        if not self.lifecycle.can_serve():
            state = self.lifecycle.state
            raise self._reject("degraded" if state == "degraded" else state,
                               f"daemon is {state}", self.config.retry_after_s,
                               request_id=request_id, model=model_id)
        if not self.admission.try_admit():
            raise self._reject("overloaded",
                               f"admission queue at max depth {self.config.max_depth}",
                               self.config.retry_after_s, request_id=request_id,
                               model=model_id)
        req = PendingRequest(str(request_id), x, rows, time.monotonic(), model=model_id,
                             budget=budget)
        try:
            self.coalescer.submit(req)
        except BaseException:
            self.admission.release()
            raise
        return req

    def _expire_requests(self, requests, phase: str, now: float) -> None:
        """Fail ``requests`` with the typed retryable ``deadline_exceeded``
        reject (metered by phase) and release their admission slots."""
        for req in requests:
            self._deadline_rejects.inc(1, phase=phase)
            rej = self._reject("deadline_exceeded",
                               f"deadline expired in {phase} "
                               f"(waited {now - req.enqueued_mono:.6f}s)",
                               self.config.retry_after_s, request_id=req.request_id,
                               model=req.model)
            req.fail(rej, now)
            self.admission.release()

    def _on_expired_waiters(self, requests, now: float) -> None:
        self._expire_requests(requests, "queue", now)

    def serve_request(self, request_id: str, x: np.ndarray, timeout: float | None = 30.0,
                      model: str | None = None,
                      deadline_ms: float | None = None) -> PendingRequest:
        """Blocking request path: submit, wait, return the resolved
        :class:`PendingRequest`. Every call gets a ``serving_request``
        span; rejects raise :class:`RejectedRequest`, dispatch failures
        re-raise the dispatcher's error."""
        with obs.span("serving_request", request_id=str(request_id),
                      rows=int(np.shape(x)[0]) if np.ndim(x) == 2 else -1,
                      model=model or DEFAULT_MODEL) as sp:
            try:
                req = self.submit(request_id, x, model=model, deadline_ms=deadline_ms)
            except RejectedRequest as rej:
                sp.set_status("rejected")
                sp.set_attr("reject", rej.code)
                raise
            if not req.wait(timeout):
                sp.set_status("error")
                self._requests.inc(1, status="timeout")
                raise TimeoutError(f"request {request_id!r} not served in {timeout}s")
            if req.error is not None:
                if isinstance(req.error, RejectedRequest):
                    sp.set_status("rejected")
                    sp.set_attr("reject", req.error.code)
                    raise req.error
                sp.set_status("error")
                self._requests.inc(1, status="error")
                self._latency.observe(req.resolved_mono - req.enqueued_mono, status="error")
                raise req.error
            self._requests.inc(1, status="ok")
            self._latency.observe(req.resolved_mono - req.enqueued_mono, status="ok")
            ph = req.phase_seconds()
            if ph is not None:
                for phase, secs in ph.items():
                    sp.set_attr(f"{phase}_s", round(secs, 9))
                sp.set_attr("e2e_s", round(req.resolved_mono - req.enqueued_mono, 9))
                sp.set_attr("batch_seq", req.batch_seq)
                sp.set_attr("bucket", req.batch_bucket)
                sp.set_attr("pad_fraction", round(1.0 - req.batch_fill, 6))
                sp.set_attr("model_version", req.model_version)
            return req

    def serve_one(self, request_id: str, x: np.ndarray, timeout: float | None = 30.0,
                  model: str | None = None,
                  deadline_ms: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`serve_request`, returning ``(cate, variance)`` for the
        submitted rows."""
        return self.serve_request(request_id, x, timeout=timeout, model=model,
                                  deadline_ms=deadline_ms).result

    # ── dispatch (the single device-owning thread) ───────────────────

    def _dispatch_loop(self) -> None:
        # The idle block stays well under the watchdog bound, or an idle
        # dispatcher would read as stalled.
        idle_s = 0.25
        if self.config.watchdog_dispatch_s > 0:
            idle_s = min(idle_s, max(0.005, self.config.watchdog_dispatch_s / 4.0))
        while True:
            self.heartbeats.beat(DISPATCH_LANE)
            batch = self.coalescer.next_batch(timeout=idle_s)
            if batch is None:
                if self.lifecycle.state == STOPPED:
                    self.heartbeats.clear(DISPATCH_LANE)
                    return
                continue
            self._dispatch(batch)
            self.heartbeats.beat(DISPATCH_LANE)

    def _dispatch(self, batch: Batch) -> None:
        picked = time.monotonic()
        # Dispatch-pickup deadline check: expired requests are rejected
        # here, and a batch left with none live is never dispatched.
        expired = tuple(r for r in batch.requests
                        if r.budget is not None and r.budget.expired())
        if expired:
            self._expire_requests(expired, "dispatch", picked)
            gone = set(map(id, expired))
            live = tuple(r for r in batch.requests if id(r) not in gone)
            if not live:
                obs.emit("serving_batch_all_expired", status="error", seq=batch.seq,
                         requests=len(batch.requests), model=batch.model)
                return
            rows = sum(r.rows for r in live)
            batch = batch._replace(requests=live, rows=rows, fill=rows / batch.bucket)
            for req in live:
                req.batch_fill = batch.fill
        inj = chaos.active()
        if inj is not None:
            # hang: chaos, a stall inside the heartbeat-stamped unit of
            # work, keyed on the batch's first request id.
            stall = inj.hang_delay_s(DISPATCH_LANE, batch.requests[0].request_id)
            if stall > 0:
                time.sleep(stall)
        # One consistent (forest, version) read a batch: a reinstall
        # after this keeps the old reference until the batch resolves.
        entry = self.fleet.get(batch.model)
        model, version = self.fleet.binding(batch.model)
        requests = batch.requests
        rows = batch.rows
        if self._fusion is not None:
            # Fused dispatch: ride the group width and back-fill the masked
            # region with queued same-model requests, FIFO.
            width = self._fusion.width_for(batch.bucket)
            fill_reqs = self.coalescer.take_fill(batch.model, width - rows, picked)
            if fill_reqs:
                requests = requests + fill_reqs
                rows += sum(r.rows for r in fill_reqs)
            for req in requests:
                req.batch_seq = batch.seq
                req.batch_bucket = width
                req.batch_fill = rows / width
            key = (entry.sig, "fused", width)
        else:
            width = batch.bucket
            key = (entry.sig, width)
        with self._lock:
            predict = self._predicts[key]
        p = entry.n_features
        now = time.monotonic
        with obs.span("serving_batch", bucket=width, rows=rows, requests=len(requests),
                      seq=batch.seq, close_reason=batch.close_reason,
                      fill=round(rows / width, 6), model=batch.model, model_version=version,
                      fused=int(self._fusion is not None)):
            try:
                padded = np.zeros((width, p), np.float32)
                off = 0
                for req in requests:
                    padded[off:off + req.rows] = req.x
                    off += req.rows
                device_start = now()
                if self._fusion is not None:
                    mask = np.zeros((width,), np.float32)
                    mask[:rows] = 1.0
                    out = predict(model, padded, mask)
                else:
                    out = predict(model, padded)
                cate, var = out.cate, out.variance
                device_end = now()
            except Exception as e:
                # A dispatch failure fails this batch's requests and walks
                # the model's degraded recovery; the daemon survives.
                for req in requests:
                    req.picked_mono = picked
                    req.model_version = version
                    req.fail(e, now())
                    self._fleet_requests.inc(1, model=batch.model, status="error")
                    self.admission.release()
                entry.supervisor.report_fault(f"dispatch:{type(e).__name__}")
                return
            off = 0
            for req in requests:
                req.picked_mono = picked
                req.device_start_mono = device_start
                req.device_end_mono = device_end
                req.model_version = version
                req.resolve((cate[off:off + req.rows].copy(), var[off:off + req.rows].copy()),
                            now())
                off += req.rows
                self._fleet_requests.inc(1, model=batch.model, status="ok")
                self.admission.release()
        self._batches.inc(1, bucket=width)
        fill = rows / width
        self._fill.observe(fill, bucket=width)
        self._close_reasons.inc(1, reason=batch.close_reason)
        if self._fusion is not None:
            self._masked.observe(1.0 - fill, bucket=width)
            self._masked_rows.inc(width - rows)
        else:
            self._pad.observe(1.0 - fill, bucket=width)
            self._pad_rows.inc(width - rows)
        for req in requests:
            ph = req.phase_seconds()
            if ph is None:
                continue
            for phase, secs in ph.items():
                self._phase_hist.observe(secs, phase=phase)
                self._phase_total.inc(max(0.0, secs), phase=phase)
        # One SLO snapshot a batch; the shedder's full evaluation is
        # throttled.
        self.slo.tick()
        if self._shedder.threshold > 0.0:
            t = time.monotonic()
            with self._lock:
                due = t >= self._shed_next_update
                if due:
                    self._shed_next_update = t + SHED_REFRESH_S
            if due:
                self._shedder.update()

    # ── proof + shutdown ─────────────────────────────────────────────

    def builds_in_window(self) -> dict[str, float]:
        """Kernel builds and graph captures since startup marked them
        (all 0 while serving; 0 before startup completes: no window)."""
        with self._lock:
            mark = self._build_mark
        if mark is None:
            return {kind: 0.0 for kind in BUILD_FAMILIES}
        now = _build_count()
        return {kind: now[kind] - mark[kind] for kind in BUILD_FAMILIES}

    def compile_events_in_window(self) -> float:
        """The builds and captures of :meth:`builds_in_window`, summed:
        the JAX package's no-compile window term, the ``stats`` op's
        ``compile_events_in_window``."""
        return float(sum(self.builds_in_window().values()))

    def startup_seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._startup_s)

    @staticmethod
    def _label_value(key: str, label: str) -> str | None:
        return dict(pair.split("=", 1) for pair in key.split(",") if "=" in pair).get(label)

    def phase_stats(self) -> dict:
        """p50/p99/count per lifecycle phase from the registry's bucket
        histograms; empty before any batch."""
        m = obs.REGISTRY.family("serving_phase_seconds")
        if m is None:
            return {}
        out: dict = {}
        for key, s in sorted(m.peek_counts().items()):
            phase = self._label_value(key, "phase")
            if phase is None:
                continue
            snap = m.snapshot_sample(s)
            out[phase] = {"count": snap["count"],
                          "mean_s": snap["sum"] / snap["count"] if snap["count"] else 0.0,
                          "p50_s": snap["p50"], "p99_s": snap["p99"], "max_s": snap["max"]}
        return out

    def _label_counts(self, family: str, label: str) -> dict[str, int]:
        samples = obs.REGISTRY.peek(family) or {}
        out: dict[str, int] = {}
        for key, v in sorted(samples.items()):
            value = self._label_value(key, label)
            if value is not None and v:
                out[value] = int(v)
        return out

    def close_reason_counts(self) -> dict[str, int]:
        """Batches by close reason."""
        return self._label_counts("serving_batch_close_total", "reason")

    def deadline_exceeded_counts(self) -> dict[str, int]:
        """Typed deadline rejects by the phase the budget died in."""
        return self._label_counts("serving_deadline_exceeded_total", "phase")

    @staticmethod
    def _fraction_mean(family: str) -> float:
        m = obs.REGISTRY.family(family)
        if m is None:
            return 0.0
        counts = m.peek_counts()
        n = sum(s["count"] for s in counts.values())
        return sum(s["sum"] for s in counts.values()) / n if n else 0.0

    def pad_fraction_mean(self) -> float:
        return self._fraction_mean("serving_pad_fraction")

    def masked_fraction_mean(self) -> float:
        return self._fraction_mean("serving_masked_fraction")

    def model_bindings(self) -> dict:
        """Every served model id with its version and checkpoint."""
        return {mid: {"version": info.get("version"), "checkpoint": info.get("checkpoint")}
                for mid, info in self.fleet.describe().items()}

    def stats(self) -> dict:
        """The ``stats`` op payload."""
        return {
            "state": self.lifecycle.state,
            "queue_depth": self.admission.depth,
            "pending": self.coalescer.pending_depth(),
            "buckets": list(self.config.buckets.sizes),
            "startup_seconds": self.startup_seconds(),
            "compile_events_in_window": self.compile_events_in_window(),
            "builds_in_window": self.builds_in_window(),
            "faults": self.lifecycle.fault_count,
            "reloads": self.lifecycle.reload_count,
            "phases": self.phase_stats(),
            "close_reasons": self.close_reason_counts(),
            "pad_fraction_mean": self.pad_fraction_mean(),
            "masked_fraction_mean": self.masked_fraction_mean(),
            "fused_buckets": (None if self._fusion is None
                              else [list(g) for g in self._fusion.groups]),
            "deadline_exceeded": self.deadline_exceeded_counts(),
            "heartbeats": {lane: round(age, 6) for lane, age in self.heartbeats.ages().items()},
            "stalled_lanes": list(self.stalled_lanes()),
            "slo": self.slo.health(),
            "fleet": self.fleet.describe(),
            "models": self.model_bindings(),
            "shed_burn_threshold": self._shedder.threshold,
            "shed_burns": self._shedder.burns(),
        }

    def drain(self, timeout_s: float | None = None, clock=time.monotonic,
              sleep=time.sleep) -> str:
        """Graceful drain: through the ``draining`` state (new admissions
        get typed ``draining`` rejects), queued and in-flight requests
        complete (the coalescer flushes at once), then the daemon stops,
        within ``timeout_s`` (default ``ATE_TPU_SERVE_DRAIN_S``). Returns
        ``"drained"`` (nothing dropped) or ``"timeout"``. One caller owns
        the drain; the others block until it ends and get its outcome."""
        bound = self.config.drain_timeout_s if timeout_s is None else float(timeout_s)
        if not self.lifecycle.mark_draining():
            if self._drain_done.is_set():
                return self._drain_outcome or "timeout"
            if self.lifecycle.state == STOPPED:
                return "drained" if self.admission.depth == 0 else "timeout"
            wait_cap = max(bound, self._drain_bound or 0.0, self.config.drain_timeout_s) + 30.0
            if self._drain_done.wait(wait_cap):
                return self._drain_outcome or "timeout"
            return "timeout"
        self._drain_bound = bound
        budget = Budget.after(bound, clock=clock)
        obs.emit("serving_drain", status="started", bound_s=bound,
                 in_flight=self.admission.depth)
        self.coalescer.close()
        while self.admission.depth > 0 and not budget.expired():
            sleep(min(0.005, max(1e-4, budget.remaining_s())))
        dropped = self.admission.depth
        outcome = "drained" if dropped == 0 else "timeout"
        self._drains.inc(1, outcome=outcome)
        if outcome == "drained":
            obs.emit("serving_drained", status="ok", bound_s=bound)
        else:
            obs.emit("serving_drain_timeout", status="error", bound_s=bound, in_flight=dropped)
        self._drain_outcome = outcome
        try:
            self.stop(timeout=max(1.0, budget.remaining_s()))
        finally:
            self._drain_done.set()
        return outcome

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher and the watchdog and ENFORCE the no-build
        window: a kernel build or a graph capture after warm raises.
        Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.stop()
        self._reloader.join(timeout)
        self.coalescer.close()
        self.lifecycle.mark_stopped()
        with self._lock:
            t = self._dispatcher
        if t is not None:
            t.join(timeout)
        window = self.builds_in_window()
        leaked = float(sum(window.values()))
        obs.gauge("serving_compile_events_in_window",
                  "kernel builds and graph captures during the serving window (must be 0)"
                  ).set(leaked)
        if leaked:
            obs.emit("serving_compile_in_window", status="error", events=leaked, **window)
            raise RuntimeError(f"serving window recorded {window} kernel builds / graph "
                               "captures: the steady state must build nothing")


# ── wire serving (socket / stdio) ────────────────────────────────────


def _handle_op(server: CateServer, header: dict, arrays: dict):
    """One request frame → one reply ``(header, arrays, stop?)``."""
    op = header.get("op")
    rid = str(header.get("id", ""))
    if op == "predict":
        x = arrays.get("x")
        if x is None:
            return {"ok": False, "id": rid, "error": "bad_request",
                    "message": "predict needs an 'x' array"}, {}, False
        try:
            req = server.serve_request(rid, x, model=header.get("model"),
                                       deadline_ms=header.get("deadline_ms"))
        except RejectedRequest as rej:
            reply = {"ok": False, "id": rid, "error": rej.code, "message": rej.message}
            if rej.retry_after_s is not None:
                reply["retry_after_s"] = rej.retry_after_s
            return reply, {}, False
        except Exception as e:
            # Always a reply: a request-scoped failure becomes an error
            # frame, never a dead connection.
            obs.emit("serving_request_error", status="error", request_id=rid,
                     error=f"{type(e).__name__}: {e}")
            return {"ok": False, "id": rid, "error": "error",
                    "message": f"{type(e).__name__}: {e}"}, {}, False
        cate, var = req.result
        return ({"ok": True, "id": rid, "model": req.model, "model_version": req.model_version},
                {"cate": cate, "variance": var}, False)
    if op == "ping":
        return {"ok": True, "op": "ping", "state": server.lifecycle.state}, {}, False
    if op == "stats":
        return {"ok": True, "op": "stats", "stats": server.stats()}, {}, False
    if op == "drain":
        timeout = header.get("timeout_s")
        try:
            timeout = None if timeout is None else float(timeout)
        except (TypeError, ValueError):
            return {"ok": False, "error": "bad_request",
                    "message": f"timeout_s {timeout!r} is not a number"}, {}, False
        outcome = server.drain(timeout)
        return {"ok": outcome == "drained", "op": "drain", "outcome": outcome}, {}, True
    if op == "shutdown":
        return {"ok": True, "op": "shutdown"}, {}, True
    # rotate, retire and dump (not ported yet) land here, as any other op.
    return {"ok": False, "error": "bad_request", "message": f"unknown op {op!r}"}, {}, False


def serve_stream(server: CateServer, rstream, wstream) -> bool:
    """Serve one connection's framed request loop. Returns True when a
    ``shutdown`` or ``drain`` op asked the whole daemon to exit."""
    while True:
        try:
            frame = protocol.read_frame(rstream)
        except protocol.ProtocolError as e:
            # A torn or corrupt frame kills THIS connection, never the
            # daemon: a length-prefixed stream cannot resynchronize.
            obs.emit("serving_protocol_error", status="error", error=str(e))
            return False
        if frame is None:
            return False
        header, arrays = frame
        reply, out_arrays, stop = _handle_op(server, header, arrays)
        protocol.write_frame(wstream, reply, out_arrays)
        if stop:
            return True


def serve_stdio(server: CateServer) -> None:
    """Serve a single peer over stdin/stdout (logs belong on stderr)."""
    import sys

    serve_stream(server, sys.stdin.buffer, sys.stdout.buffer)
    server.stop()


def serve_socket(server: CateServer, host: str = "127.0.0.1", port: int = 0,
                 on_bound: Callable[[int], None] | None = None) -> None:
    """Accept loop: one reader thread a connection, all feeding the shared
    coalescer. Returns after a ``shutdown`` op (or once the daemon
    stopped underneath it). Binds ``port`` (0 = ephemeral; the bound port
    goes to stderr, the ``serving_port`` gauge and ``on_bound``)."""
    import sys

    stop_evt = threading.Event()
    with socket.create_server((host, port)) as srv:
        srv.settimeout(0.25)
        bound = srv.getsockname()[1]
        obs.gauge("serving_port", "bound TCP port").set(bound)
        print(f"# serving on {host}:{bound}", file=sys.stderr, flush=True)
        if on_bound is not None:
            on_bound(bound)

        def _conn(conn: socket.socket) -> None:
            with conn:
                rw = conn.makefile("rwb")
                try:
                    if serve_stream(server, rw, rw):
                        stop_evt.set()
                finally:
                    rw.close()

        threads: list[threading.Thread] = []
        conn_seq = 0
        while not stop_evt.is_set() and server.lifecycle.state != STOPPED:
            threads = [t for t in threads if t.is_alive()]
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conn_seq += 1
            t = threading.Thread(target=_conn, args=(conn,), daemon=True,
                                 name=f"conn-{conn_seq}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(1.0)
    server.stop()
