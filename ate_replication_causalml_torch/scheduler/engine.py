"""DAG-scheduled sweep engine.

Port of ``ate_replication_causalml_tpu/scheduler/engine.py``. A bounded
pool of worker threads executes ready nodes (nuisance artifacts and
estimator stages) concurrently. On the card each worker owns one CUDA
stream and runs every node under ``torch.cuda.device(dev)`` and
``torch.cuda.stream(s)``, so the kernels of two rows can be in flight
together while their threads prepare the next launches. The streams
first wait on an event recorded on the calling thread's stream, which
built the frames; artifacts cross streams through the cache's events
(:mod:`.cache`); at the end the calling thread's stream waits on every
worker's stream.

Determinism contract (asserted in ``tests/test_torch_scheduler.py`` and
``tests/test_torch_pipeline.py``):

* every stage computes exactly the function it computes sequentially,
  on exactly the same inputs: per-stage fold-in keys make a stage's
  numbers independent of execution order, and the
  :class:`~.cache.NuisanceCache` fits a shared artifact once, by one
  thread, from its declared key;
* **commit order is declaration order**: journal appends, report rows
  and log lines run through an ordered committer, stage k's commit only
  after stages 0..k-1 committed, whatever order the bodies finished in;
* **a lane starts its nodes in declaration order** (priority order:
  an artifact just ahead of its first consumer), on every rank of a
  multi-GPU world, so the ranks issue a lane's collectives in one order;
* an abort-class exception (``fail_policy="raise"``) surfaces as the
  earliest *declared* failing stage. Nodes declared before it keep
  running so their rows commit, and commits flush exactly up to the
  failing stage: the journal a sequential run leaves. Operator aborts
  (^C, SystemExit) stop scheduling at once; the committed prefix is
  best-effort, as it is sequentially.

Under ``ATE_TPU_CHAOS`` ``hang:scope=worker`` a selected node sleeps
before it runs (``resilience/chaos.py``): the stall the watchdog below
must report; nothing else changes.

``workers=1`` is the sequential escape hatch: the same node graph,
executed inline on the calling thread and its current stream in priority
order (an artifact just before its first consumer), with no thread, no
extra stream, no event and no prefetch lane.
"""

from __future__ import annotations

import contextlib
import heapq
import os
import threading
import time
from typing import Callable, Iterable

import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.watchdog import HeartbeatRegistry, lane_bound_s
from ate_replication_causalml_torch.scheduler.cache import NuisanceCache
from ate_replication_causalml_torch.scheduler.dag import ArtifactSpec, StageSpec, validate
from ate_replication_causalml_torch.scheduler.prefetch import CompilePrefetcher, default_enabled

_WORKERS_ENV = "ATE_TPU_SWEEP_WORKERS"


def default_workers() -> int:
    """Pool width: ``ATE_TPU_SWEEP_WORKERS`` if set, else ``min(4,
    cpu_count)``."""
    env = os.environ.get(_WORKERS_ENV, "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(4, os.cpu_count() or 1))


class _Node:
    __slots__ = ("kind", "name", "priority", "deps", "exec", "stage_idx", "exclusive")

    def __init__(self, kind, name, priority, deps, exec_fn, stage_idx, exclusive=None):
        self.kind = kind            # "artifact" | "stage"
        self.name = name
        self.priority = priority
        self.deps = deps            # tuple of node names
        self.exec = exec_fn
        self.stage_idx = stage_idx  # commit index for stages; the first
        #                             consumer's index for artifacts
        self.exclusive = exclusive  # lane name (see dag.ArtifactSpec)


class SweepEngine:
    """Execute a validated stage DAG over a shared nuisance cache, on
    ``device``'s streams when it is a CUDA device."""

    def __init__(
        self,
        artifacts: Iterable[ArtifactSpec],
        stages: Iterable[StageSpec],
        *,
        commit: Callable[[StageSpec, object], None] | None = None,
        workers: int | None = None,
        prefetch: bool | None = None,
        device=None,
        stall_bound_s: float | None = None,
        span_parent: str | None = None,
    ):
        arts = list(artifacts)
        self.dag = validate(arts, stages)
        # Clamp like default_workers clamps the env var: workers <= 0
        # must not spawn zero threads and return an empty result.
        self.workers = default_workers() if workers is None else max(1, workers)
        dev = None if device is None else torch.device(device)
        # Streams only for a threaded run on the card; inline runs on
        # the caller's current stream.
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self._streams = self.device is not None and self.workers > 1
        self.cache = NuisanceCache(arts, device=self.device if self._streams else None)
        self.prefetch = default_enabled(dev) if prefetch is None else prefetch
        self._commit_fn = commit
        # Node, commit and prefetch spans open on threads where the
        # caller's root span is not on the thread-local stack.
        self._span_parent = span_parent
        self._mu = threading.Condition()
        # Shared scheduling state: every mutation below is under self._mu.
        self._ready: list[tuple] = []           # heap of (priority, name)
        self._indegree: dict[str, int] = {}
        self._dependents: dict[str, list[str]] = {}
        self._started: set[str] = set()
        self._finished: set[str] = set()
        self._inflight = 0
        self._remaining = 0
        self._results: dict[str, object] = {}
        self._outcomes: dict[int, tuple[StageSpec, object]] = {}
        self._next_commit = 0
        self._commit_busy = False
        self._abort: list[tuple[int, BaseException]] = []
        # Graceful drain (request_drain): no new nodes; in-flight ones
        # finish and their declared-order prefix commits.
        self._draining = False
        self._busy_lanes: set[str] = set()
        self._frames_ready: torch.cuda.Event | None = None
        self._workers_done: list[torch.cuda.Event] = []
        # Liveness: workers stamp heartbeats around every node; a monitor
        # thread (armed by stall_bound_s / ATE_TPU_WATCHDOG_SWEEP_S,
        # 0 = off) reports "ready or in-flight nodes but no completion
        # within the bound" once per episode instead of wedging silently.
        self.heartbeats = HeartbeatRegistry()
        self.stall_bound_s = (lane_bound_s("sweep", 0.0) if stall_bound_s is None
                              else float(stall_bound_s))
        self._last_completion = time.monotonic()
        self._stall_reported = False
        self._monitor_stop = threading.Event()
        self._nodes = self._build_nodes()

    # ── graph construction ────────────────────────────────────────────

    def _build_nodes(self) -> dict[str, _Node]:
        dag = self.dag
        nodes: dict[str, _Node] = {}
        # Only artifacts some stage transitively consumes are scheduled:
        # a fully resumed sweep declares no needs and fits nothing.
        needed = set(dag.first_consumer)
        order = {name: i for i, name in enumerate(dag.artifacts)}
        for name in needed:
            spec = dag.artifacts[name]
            nodes[name] = _Node(
                "artifact", name, (dag.first_consumer[name], 0, -dag.depth[name], order[name]),
                tuple(d for d in spec.needs if d in needed),
                # ensure(), not get(): the artifact node produces the
                # value; only consumers wait for its device work.
                (lambda nm=name: self.cache.ensure(nm)),
                dag.first_consumer[name], exclusive=spec.exclusive)
        for i, spec in enumerate(dag.stages):
            nodes[spec.name] = _Node(
                "stage", spec.name, (i, 1, 0, 0), tuple(d for d in spec.needs if d in needed),
                (lambda sp=spec: sp.run(self.cache)), i, exclusive=spec.exclusive)
        # Each lane starts its nodes in priority order (declaration order,
        # artifacts ahead of their first consumer), not first come, first
        # served: in a multi-GPU world every rank runs this engine, and
        # the collectives of the "mesh" lane's nodes must be issued in
        # the same order on every rank.
        self._lane_order: dict[str, list[str]] = {}
        for node in sorted(nodes.values(), key=lambda n: n.priority):
            if node.exclusive is not None:
                self._lane_order.setdefault(node.exclusive, []).append(node.name)
        self._lane_next = dict.fromkeys(self._lane_order, 0)
        return nodes

    # ── public API ────────────────────────────────────────────────────

    def run(self) -> dict[str, object]:
        """Execute the DAG; returns ``{stage name: value}``.

        Raises the earliest-declared aborting exception, with commits
        flushed exactly up to (not including) that stage."""
        with self._mu:
            self._remaining = len(self._nodes)
            for name, node in self._nodes.items():
                self._indegree[name] = len(node.deps)
                for dep in node.deps:
                    self._dependents.setdefault(dep, []).append(name)
            for name, node in self._nodes.items():
                if self._indegree[name] == 0:
                    heapq.heappush(self._ready, (node.priority, name))
        obs.gauge("scheduler_workers", "sweep worker-pool width").set(float(self.workers))
        prefetcher = None
        if self.prefetch and self.workers > 1:
            items = sorted(self._nodes.values(), key=lambda n: n.priority)
            warm_of = {**{a.name: a.warm for a in self.dag.artifacts.values()},
                       **{s.name: s.warm for s in self.dag.stages}}
            prefetcher = CompilePrefetcher([(n.name, warm_of.get(n.name)) for n in items],
                                           started=self._was_started,
                                           span_parent=self._span_parent)
            prefetcher.start()
        monitor = None
        if self.stall_bound_s > 0:
            monitor = threading.Thread(target=self._monitor, name="sweep-watchdog", daemon=True)
            monitor.start()
        try:
            if self.workers == 1:
                self._worker()
            else:
                if self._streams:
                    # Every worker stream waits for the caller's work so
                    # far (the frames, the root key) before its first node.
                    self._frames_ready = torch.cuda.Event()
                    self._frames_ready.record(torch.cuda.current_stream(self.device))
                threads = [threading.Thread(target=self._worker, name=f"sweep-worker-{i}",
                                            daemon=True) for i in range(self.workers)]
                for t in threads:
                    t.start()
                try:
                    for t in threads:
                        # Bounded joins keep the wait visible to ^C.
                        while t.is_alive():
                            t.join(0.5)
                except BaseException as e:  # noqa: BLE001 — a real ^C lands
                    # here (CPython delivers SIGINT to the main thread):
                    # workers stop taking nodes, drain in-flight work,
                    # and the interrupt surfaces through the abort path.
                    self._operator_abort(e)
                    for t in threads:
                        while t.is_alive():
                            t.join(0.5)
                if self._streams:
                    current = torch.cuda.current_stream(self.device)
                    for event in self._workers_done:
                        current.wait_event(event)
        finally:
            self._monitor_stop.set()
            if monitor is not None:
                monitor.join(5.0)
            if prefetcher is not None:
                prefetcher.stop(timeout=60.0)
        self._flush_commits()
        with self._mu:
            if self._abort:
                idx, exc = min(self._abort, key=lambda ae: ae[0])
                obs.emit("scheduler_abort", status="error", stage_index=idx,
                         error=type(exc).__name__)
                raise exc
            return dict(self._results)

    # ── execution ─────────────────────────────────────────────────────

    def _was_started(self, name: str) -> bool:
        with self._mu:
            return name in self._started

    def _operator_abort(self, exc: BaseException) -> None:
        """Record an operator abort delivered outside a stage body. Index
        −1 sorts before every stage: workers stop taking nodes, nothing
        further commits, and ``run()`` re-raises ``exc``."""
        with self._mu:
            self._abort.append((-1, exc))
            self._mu.notify_all()

    def _take(self) -> _Node | None:
        """Next ready node by priority, or None when drained; blocks
        while work in flight may unlock more nodes.

        Lanes are a scheduling constraint, not a blocking lock: a ready
        node whose lane is busy stays queued and the worker takes the
        next ready node instead, and so does a ready laned node that is
        not its lane's next in priority order. After an abort, nodes declared before
        the earliest aborting stage keep being scheduled (sequentially
        every earlier stage finished before the failing one raised);
        later nodes are skipped. Operator aborts stop scheduling."""
        with self._mu:
            while True:
                if self._remaining == 0 or self._draining:
                    return None
                stop_at: int | None = None
                if self._abort:
                    if any(isinstance(e, (KeyboardInterrupt, SystemExit))
                           for _, e in self._abort):
                        return None
                    stop_at = min(a for a, _ in self._abort)
                skipped: list[tuple] = []
                picked: _Node | None = None
                while self._ready:
                    prio, name = heapq.heappop(self._ready)
                    node = self._nodes[name]
                    if ((stop_at is not None and node.stage_idx >= stop_at)
                            or (node.exclusive is not None
                                and (node.exclusive in self._busy_lanes
                                     or self._lane_order[node.exclusive][
                                         self._lane_next[node.exclusive]] != node.name))):
                        skipped.append((prio, name))
                        continue
                    picked = node
                    break
                for item in skipped:
                    heapq.heappush(self._ready, item)
                if picked is not None:
                    self._started.add(picked.name)
                    self._inflight += 1
                    if picked.exclusive is not None:
                        self._busy_lanes.add(picked.exclusive)
                        self._lane_next[picked.exclusive] += 1
                    return picked
                if stop_at is not None and self._inflight == 0:
                    # Aborted, and nothing in flight can unlock an
                    # earlier-declared node: drain the pool.
                    return None
                # Bounded wait: a missed notify delays a worker by at
                # most the timeout, never wedges it.
                self._mu.wait(0.5)

    def _finish(self, node: _Node, value, error: BaseException | None) -> None:
        with self._mu:
            self._remaining -= 1
            self._inflight -= 1
            self._finished.add(node.name)
            self._last_completion = time.monotonic()
            self._stall_reported = False
            if node.exclusive is not None:
                self._busy_lanes.discard(node.exclusive)
            for dep_name in self._dependents.get(node.name, ()):
                self._indegree[dep_name] -= 1
                if self._indegree[dep_name] == 0:
                    heapq.heappush(self._ready, (self._nodes[dep_name].priority, dep_name))
            if node.kind == "stage":
                if error is None:
                    self._results[node.name] = value
                    self._outcomes[node.stage_idx] = (self.dag.stages[node.stage_idx], value)
                else:
                    self._abort.append((node.stage_idx, error))
            elif error is not None and isinstance(error, (KeyboardInterrupt, SystemExit)):
                # An operator abort inside an artifact fit stops the run;
                # an ordinary artifact failure does not: each consumer
                # retries the fit under its own isolation policy.
                self._abort.append((node.stage_idx, error))
            self._mu.notify_all()

    def _exec(self, node: _Node) -> None:
        t0 = time.perf_counter()
        value, error = None, None
        worker_lane = f"worker/{threading.current_thread().name}"
        self.heartbeats.beat(worker_lane)
        if node.exclusive is not None:
            self.heartbeats.beat(f"lane/{node.exclusive}")
        inj = chaos.active()
        if inj is not None:
            # hang:scope=worker: a deterministic stall inside the stamped
            # unit of work, keyed on the node's name; nothing raises.
            stall = inj.hang_delay_s("worker", node.name)
            if stall > 0:
                time.sleep(stall)
        with obs.span("scheduler_node", parent_id=self._span_parent, node=node.name,
                      kind=node.kind, lane=node.exclusive or "",
                      worker=threading.current_thread().name, stage_idx=node.stage_idx,
                      needs=",".join(node.deps)) as nsp:
            try:
                # The scheduling skip keeps two laned nodes from
                # overlapping; the lane lock also fences the cache's
                # refit of a failed laned artifact from an unlaned stage.
                guard = (self.cache.lane_lock(node.exclusive) if node.exclusive is not None
                         else contextlib.nullcontext())
                with guard:
                    value = node.exec()
            except BaseException as e:  # noqa: BLE001 — routed to the
                # declared-order abort/degrade logic in _finish.
                error = e
                nsp.set_status("error")
                nsp.set_attr("error_type", type(e).__name__)
                if node.kind == "artifact" and not isinstance(e, (KeyboardInterrupt, SystemExit)):
                    obs.emit("artifact_fit_failed", status="error", artifact=node.name,
                             error=f"{type(e).__name__}: {e}")
        obs.histogram("scheduler_node_seconds", "per-node execution seconds").observe(
            time.perf_counter() - t0, kind=node.kind)
        self.heartbeats.beat(worker_lane)
        if node.exclusive is not None:
            self.heartbeats.beat(f"lane/{node.exclusive}")
        self._finish(node, value, error)
        self._flush_commits()

    @contextlib.contextmanager
    def _worker_stream(self):
        """A pool worker's own stream on the run's device, behind the
        caller's frames; on exit an event the caller's stream waits on."""
        if not self._streams:
            yield
            return
        stream = torch.cuda.Stream(device=self.device)
        stream.wait_event(self._frames_ready)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            try:
                yield
            finally:
                done = torch.cuda.Event()
                done.record(stream)
                with self._mu:
                    self._workers_done.append(done)

    def _worker(self) -> None:
        with self._worker_stream():
            while True:
                node = self._take()
                if node is None:
                    return
                self._exec(node)

    # ── liveness ──────────────────────────────────────────────────────

    def request_drain(self) -> None:
        """Graceful drain: stop scheduling new nodes; in-flight nodes
        complete, the declared-order commit prefix flushes, and ``run()``
        returns the partial results without raising. The journal then
        holds the prefix a sequential run stopped at the same point would
        (the scenario matrix's SIGTERM contract)."""
        with self._mu:
            if self._draining:
                return
            self._draining = True
            self._mu.notify_all()
        obs.emit("scheduler_drain", status="ok")

    @property
    def draining(self) -> bool:
        with self._mu:
            return self._draining

    def _remaining_critical_path(self) -> list[str]:
        """The longest dependency chain (by node count) through the
        unfinished nodes: what a stalled run is waiting on."""
        with self._mu:
            done = set(self._finished)
        depth: dict[str, tuple[int, tuple[str, ...]]] = {}

        def chain(name: str) -> tuple[int, tuple[str, ...]]:
            got = depth.get(name)
            if got is not None:
                return got
            best = (1, (name,))
            for dep in self._nodes[name].deps:
                if dep in done or dep not in self._nodes:
                    continue
                d, path = chain(dep)
                if d + 1 > best[0]:
                    best = (d + 1, path + (name,))
            depth[name] = best
            return best

        best_path: tuple[str, ...] = ()
        for name in (n for n in self._nodes if n not in done):
            _, path = chain(name)
            if len(path) > len(best_path):
                best_path = path
        return list(best_path)

    def stall_diagnostic(self, now: float | None = None) -> dict:
        """Critical path through the unfinished nodes, heartbeat ages,
        held lanes, in-flight and ready nodes. A pure read."""
        now = time.monotonic() if now is None else now
        with self._mu:
            ready = sorted(name for _, name in self._ready)
            inflight = sorted(self._started - self._finished)
            held = sorted(self._busy_lanes)
            since = now - self._last_completion
        return {
            "seconds_since_completion": round(since, 6),
            "ready": ready,
            "started_unfinished": inflight,
            "held_lanes": held,
            "heartbeat_ages": {lane: round(age, 6)
                               for lane, age in self.heartbeats.ages(now).items()},
            "critical_path": self._remaining_critical_path(),
        }

    def _check_stall(self, now: float | None = None) -> bool:
        """One monitor pass: ready or in-flight nodes but no completion
        within the bound → emit the diagnostic, once per episode."""
        now = time.monotonic() if now is None else now
        with self._mu:
            busy = self._remaining > 0 and (self._inflight > 0 or bool(self._ready))
            due = (busy and not self._stall_reported
                   and now - self._last_completion > self.stall_bound_s)
            if due:
                self._stall_reported = True
        if not due:
            return False
        diag = self.stall_diagnostic(now)
        obs.counter("watchdog_stalls_total", "watchdog-detected lane stall episodes").inc(
            1, lane="sweep")
        obs.emit("scheduler_stall", status="error", since_s=diag["seconds_since_completion"],
                 bound_s=self.stall_bound_s, critical_path=",".join(diag["critical_path"]),
                 held_lanes=",".join(diag["held_lanes"]),
                 started_unfinished=",".join(diag["started_unfinished"]),
                 heartbeat_ages=",".join(f"{k}={v:.3f}"
                                         for k, v in diag["heartbeat_ages"].items()))
        return True

    def _monitor(self) -> None:
        poll = max(0.01, min(0.25, self.stall_bound_s / 4.0))
        while not self._monitor_stop.wait(poll):
            self._check_stall()

    # ── ordered commit ────────────────────────────────────────────────

    def _flush_commits(self) -> None:
        """Run pending commits in declaration order, one committer at a
        time, never while the engine lock is held (commits write the
        journal and log)."""
        while True:
            with self._mu:
                if self._commit_busy:
                    return
                idx = self._next_commit
                if idx not in self._outcomes:
                    return
                if self._abort and idx >= min(a for a, _ in self._abort):
                    return
                spec, value = self._outcomes.pop(idx)
                self._commit_busy = True
            try:
                if self._commit_fn is not None:
                    with obs.span("commit", parent_id=self._span_parent, stage=spec.name,
                                  stage_idx=idx, track="committer"):
                        self._commit_fn(spec, value)
            except BaseException as e:  # noqa: BLE001 — a failed commit (a
                # full disk mid-append) aborts the run at this stage.
                with self._mu:
                    self._abort.append((idx, e))
                    self._commit_busy = False
                    self._next_commit = idx + 1
                    self._mu.notify_all()
                return
            with self._mu:
                self._commit_busy = False
                self._next_commit = idx + 1
                self._mu.notify_all()
