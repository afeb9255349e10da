"""Stage timing and device profiling.

Port of ``ate_replication_causalml_tpu/utils/profiling.py``, with
``torch.profiler`` in place of ``jax.profiler``:

* :class:`StageTimer`: accumulates wall seconds per named stage; the
  sweep times every computed row through one. Callers synchronize their
  device work inside the stage themselves;
* :func:`xla_trace`: with ``ATE_TPU_TRACE_DIR`` set (or ``trace_dir``
  given), one ``torch.profiler`` capture of the block, exported as a
  Chrome trace ``<dir>/<label>.trace.json``, the label sanitized; a no-op
  otherwise. The name is the JAX package's, as is its counter
  (``xla_trace_total``);
* :func:`xprof_run` / :func:`xprof_annotation`: with ``ATE_TPU_XPROF=<dir>``
  one whole-run capture (``<dir>/<label>.trace.json``), in which each
  stage is a ``torch.profiler.record_function`` range named like its host
  span, so the device timeline and the host trace line up name for name.

The profiler is process-global, so the sweep runs sequentially while
either knob is set. Stage durations land in the ``stage_seconds``
histogram and as ``stage`` spans; captures are counted.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ate_replication_causalml_torch import observability as obs

_TRACE_ENV = "ATE_TPU_TRACE_DIR"
_XPROF_ENV = "ATE_TPU_XPROF"


class StageTimer:
    """Accumulates wall-clock seconds per named stage."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with obs.span("stage", stage=name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            # graftlint: disable=JGL021 — created at first use: pre-creating it would change the counter/histogram families of the port's metrics.json, which tests/test_torch_pipeline.py holds to the JAX package's sweep
            obs.histogram("stage_seconds", "StageTimer stage durations").observe(dt, stage=name)


def device_profiling_armed() -> bool:
    """Whether ``ATE_TPU_TRACE_DIR`` or ``ATE_TPU_XPROF`` asks for a
    capture: the sweep then runs sequentially."""
    return bool(os.environ.get(_TRACE_ENV) or os.environ.get(_XPROF_ENV))


@contextlib.contextmanager
def _capture(path: str) -> Iterator[None]:
    """One ``torch.profiler`` capture of the block (host ops, and the
    card's kernels where CUDA is available), exported to ``path`` as a
    Chrome trace."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()    # the block's kernels end inside the capture
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def xla_trace(label: str = "trace", trace_dir: str | None = None) -> Iterator[None]:
    """A ``torch.profiler`` capture of the block into
    ``<trace_dir>/<label>.trace.json`` when a trace directory is set
    (``ATE_TPU_TRACE_DIR``); a no-op otherwise. The label becomes a file
    name, so it is sanitized (sweep names carry spaces, dots and
    parentheses)."""
    trace_dir = trace_dir or os.environ.get(_TRACE_ENV)
    if not trace_dir:
        yield
        return
    label = obs.sanitize_label(label)
    os.makedirs(trace_dir, exist_ok=True)
    obs.counter("xla_trace_total", "per-stage torch.profiler captures").inc(1, label=label)
    with _capture(os.path.join(trace_dir, f"{label}.trace.json")):
        yield


def xprof_dir() -> str | None:
    """The whole-run capture's directory (``ATE_TPU_XPROF``), or None."""
    return os.environ.get(_XPROF_ENV) or None


@contextlib.contextmanager
def xprof_run(label: str = "run") -> Iterator[None]:
    """One whole-run ``torch.profiler`` capture into
    ``$ATE_TPU_XPROF/<label>.trace.json`` (a no-op without it); stages
    are told apart by their :func:`xprof_annotation` ranges."""
    d = xprof_dir()
    if not d:
        yield
        return
    label = obs.sanitize_label(label)
    os.makedirs(d, exist_ok=True)
    obs.counter("xprof_trace_total", "whole-run torch.profiler captures").inc(1, label=label)
    with _capture(os.path.join(d, f"{label}.trace.json")):
        yield


@contextlib.contextmanager
def xprof_annotation(label: str) -> Iterator[None]:
    """A ``torch.profiler.record_function`` range named like the host
    span (sanitized alike), active only under ``$ATE_TPU_XPROF``."""
    if not xprof_dir():
        yield
        return
    with record_function(obs.sanitize_label(label)):
        yield
