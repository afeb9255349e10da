"""Prefetch lane of the concurrent sweep.

Port of ``ate_replication_causalml_tpu/scheduler/prefetch.py``. One
background thread walks the upcoming nodes in schedule order and runs
their ``warm`` hooks, so that work a stage would otherwise do on its hot
path at first use is done before the stage's turn comes.

In the port that work is the ``nvcc`` build of the kernel libraries
(``kernels/build.py::build_all``, under the build's own lock, so a stage
that reaches a kernel meanwhile waits for the same build instead of
starting a second one). The JAX package's AOT ``lower(...).compile()``
hooks have no counterpart: PyTorch ops are not compiled ahead of a call,
so every hook but the build is ``None``.

Policy: on by default for a CUDA run (there is a build to hide), off on
the CPU (its plain versions need none); ``ATE_TPU_SWEEP_PREFETCH=1/0``
overrides either way. The lane never affects results: every failure is
counted in ``scheduler_prefetch_total{status=error}`` and emitted as a
``prefetch_error`` event, and the stage builds for itself.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Sequence

import torch

from ate_replication_causalml_torch import observability as obs

_ENV = "ATE_TPU_SWEEP_PREFETCH"


def default_enabled(device=None) -> bool:
    """On for a CUDA ``device``, off otherwise; the env knob overrides."""
    env = os.environ.get(_ENV, "").strip()
    if env in ("0", "1"):
        return env == "1"
    return device is not None and torch.device(device).type == "cuda"


class CompilePrefetcher:
    """Background thread running ``warm`` hooks in schedule order.

    ``items`` are ``(name, warm)`` pairs in the order the engine expects
    to need them; ``started`` tells the lane whether the foreground has
    already claimed a node (warming it then is wasted work)."""

    def __init__(
        self,
        items: Sequence[tuple[str, Callable[[], object] | None]],
        started: Callable[[str], bool] = lambda name: False,
        span_parent: str | None = None,
    ):
        self._items = [(n, w) for n, w in items if w is not None]
        self._started = started
        # The lane's spans open on its own thread, away from the run's
        # root span.
        self._span_parent = span_parent
        self._stop = threading.Event()
        # Guards the handle: start() and stop() may come from different
        # threads, and a double start must not leak a second lane.
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._counter = obs.counter("scheduler_prefetch_total",
                                    "prefetch lane outcomes by node and status")
        # graftlint: disable=JGL021 — created at first use: pre-creating it would change the counter/histogram families of the port's metrics.json, which tests/test_torch_pipeline.py holds to the JAX package's sweep
        self._hist = obs.histogram("scheduler_prefetch_seconds", "per-node prefetch seconds")

    def start(self) -> None:
        if not self._items:
            return
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._run, name="compile-prefetch",
                                            daemon=True)
            self._thread.start()

    def stop(self, timeout: float | None = None) -> None:
        """Stop after the current hook and join."""
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:  # join outside the lock: never block start()
            thread.join(timeout)

    def _run(self) -> None:
        for name, warm in self._items:
            if self._stop.is_set():
                return
            if self._started(name):
                self._counter.inc(1, node=name, status="skipped")
                continue
            t0 = time.perf_counter()
            try:
                with obs.span("prefetch_compile", parent_id=self._span_parent, node=name,
                              track="prefetch"):
                    warm()
            except Exception as e:  # noqa: BLE001 — recorded, never raised: the
                # stage does the work for itself.
                self._counter.inc(1, node=name, status="error")
                obs.emit("prefetch_error", status="error", node=name,
                         error=f"{type(e).__name__}: {e}")
                continue
            self._hist.observe(time.perf_counter() - t0, node=name)
            self._counter.inc(1, node=name, status="compiled")
