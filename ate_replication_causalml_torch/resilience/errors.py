"""Error taxonomy of the port's resilience layer.

Port of ``ate_replication_causalml_tpu/resilience/errors.py``. Whether
re-execution can help is decided per exception, once, here:

* **fatal**: programming errors (``TypeError``, ``ValueError``,
  ``AssertionError``, …) raise at once: a retry replays the bug;
* **transient**: runtime and IO failures (``OSError``, plain
  ``RuntimeError``): every shard owns its key, so re-execution is
  recovery, bit for bit;
* ``KeyboardInterrupt`` and ``SystemExit`` are ``BaseException`` and no
  retry or isolation layer catches them.

One deliberate difference from the JAX package: a **CUDA error is
fatal**. A failed kernel build or launch (:class:`CudaKernelError`,
raised by ``kernels/build.py``) and torch's own CUDA errors
(``torch.AcceleratorError``, ``torch.cuda.CudaError``, or a
``RuntimeError`` whose message starts ``CUDA error``) are
``RuntimeError``\\ s, which the JAX package's rule would retry. A sticky
CUDA error poisons the context: a retry either fails again or, worse,
hides a kernel fault. A CUDA out-of-memory error is not sticky and stays
transient, as the JAX package's exhausted device memory is.

Also home to the typed failures the layer raises: :class:`CheckpointCorrupt`,
:class:`DeadlineExceeded`, :class:`NonFiniteResult` and the
:class:`ChaosFault` family (transient by construction, so injected
faults walk the recovery paths real ones would).
"""

from __future__ import annotations

import functools


class ChaosFault(RuntimeError):
    """Base of all deliberately injected faults: a ``RuntimeError``, so
    the classifier treats injections as transient."""


class ChaosShardFault(ChaosFault):
    """Injected in place of a shard thunk's result (``run_shards``)."""


class ChaosStageFault(ChaosFault):
    """Injected at a sweep stage boundary."""


class ChaosServeFault(ChaosFault):
    """Injected at the serving daemon's request boundary (``serve:``
    scope). The daemon answers it with a typed reject-with-retry-after
    and walks its degraded-mode recovery (checkpoint re-verify and
    reload): never a crash, never a wrong value, a bounded retry."""


class ChaosRotateFault(ChaosFault):
    """Injected along the train-to-serve rotation path (``rotate:``
    scope): a retrain fit that dies, or a fault between a candidate's
    verify and its swap. Transient: the retrain supervisor re-runs a
    dead fit, and a mid-swap fault becomes a typed rotation refusal."""


class ChaosSpecError(ValueError):
    """The ``ATE_TPU_CHAOS`` spec does not parse: a configuration error,
    fatal at once, never retried."""


class DeadlineExceeded(RuntimeError):
    """A shard pool's wall-clock deadline passed before the work did."""


class NonFiniteResult(RuntimeError):
    """An estimator produced a NaN/Inf point estimate from finite inputs:
    recorded as a failed row, never as a row."""


class CheckpointCorrupt(RuntimeError):
    """A fitted-model checkpoint failed integrity verification."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"checkpoint {path!r} is corrupt: {reason}")
        self.path = path
        self.reason = reason


class CudaKernelError(RuntimeError):
    """One of the port's CUDA kernels failed to build, or its launch
    returned an error code."""


#: Exception types where re-execution replays the bug.
#: NotImplementedError subclasses RuntimeError, so it is listed to beat
#: the transient check.
FATAL_ERRORS: tuple[type[BaseException], ...] = (
    TypeError,
    ValueError,
    AssertionError,
    KeyError,
    IndexError,
    AttributeError,
    NameError,
    NotImplementedError,
    RecursionError,
)

@functools.cache
def cuda_errors() -> tuple[type[BaseException], ...]:
    """CUDA error types: fatal, though they are RuntimeErrors. torch is
    imported here, on first use, so a process that never classifies an
    error (the fleet router) never loads it."""
    import torch

    return tuple(t for t in (CudaKernelError, getattr(torch, "AcceleratorError", None),
                             getattr(torch.cuda, "CudaError", None))
                 if isinstance(t, type))


def transient_errors() -> tuple[type[BaseException], ...]:
    """Types worth retrying (CUDA errors excepted, see :func:`classify`)."""
    return (RuntimeError, OSError)


def is_cuda_error(exc: BaseException) -> bool:
    """A CUDA error from a kernel of the port or from torch; not an
    out-of-memory error."""
    import torch

    if isinstance(exc, torch.OutOfMemoryError):
        return False
    return isinstance(exc, cuda_errors()) or (
        type(exc) is RuntimeError and str(exc).startswith("CUDA error"))


def classify(exc: BaseException) -> str:
    """``"fatal"`` or ``"transient"``. Fatal wins ties; CUDA errors are
    fatal (the module docstring says why); unknown ``Exception``
    subclasses are fatal: an error the taxonomy has never seen must
    surface, not burn retry budget."""
    if isinstance(exc, FATAL_ERRORS) or is_cuda_error(exc):
        return "fatal"
    if isinstance(exc, transient_errors()):
        return "transient"
    return "fatal"
