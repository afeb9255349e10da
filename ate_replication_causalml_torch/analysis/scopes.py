"""Shared path-scope specs for the port's graftlint rules (a copy of the
JAX package's ``analysis/scopes.py``; the scopes match path segments,
so they fit both packages' trees unchanged).

Every path-scoped rule used to hand-roll its own ``_in_scope`` out of
``endswith``/substring checks — and the checks drifted: PR 4's JGL008
bug (``relpath.endswith("pipeline.py")``) roped ``data/pipeline.py``
into a rule meant for the top-level driver only. :class:`Scope` is the
one implementation all rules share, matching on *path segments* so a
directory named ``xscenarios`` can never satisfy a ``scenarios`` scope
and a nested ``pipeline.py`` can never satisfy a top-level one.

Matching semantics (all against ``/``-normalized relpaths):

* ``dirs`` — the named directory appears as a segment anywhere in the
  dirname (``("scheduler",)`` matches ``pkg/scheduler/engine.py``);
* ``files`` — the relpath's tail segments equal the spec
  (``("observability/slo.py",)`` matches ``pkg/observability/slo.py``
  but not ``pkg/observability/slo.pyx`` or ``myslo.py``);
* ``top_files`` — basename match restricted to package depth ≤ 2
  (``("pipeline.py",)`` matches ``pkg/pipeline.py`` and a bare
  ``pipeline.py``, never ``pkg/data/pipeline.py``);
* ``exclude_files`` — tail-segment matches that veto the above (one
  rule per file: JGL006 hands ``observability/slo.py`` to JGL008).
"""

from __future__ import annotations


def _segments(relpath: str) -> list[str]:
    return relpath.replace("\\", "/").split("/")


def _tail_matches(parts: list[str], spec: str) -> bool:
    tail = spec.split("/")
    return len(parts) >= len(tail) and parts[-len(tail):] == tail


class Scope:
    """A declarative path scope; ``contains(relpath)`` is the single
    membership test every scoped rule uses."""

    def __init__(
        self,
        dirs: tuple[str, ...] = (),
        files: tuple[str, ...] = (),
        top_files: tuple[str, ...] = (),
        exclude_files: tuple[str, ...] = (),
    ):
        self.dirs = tuple(dirs)
        self.files = tuple(files)
        self.top_files = tuple(top_files)
        self.exclude_files = tuple(exclude_files)

    def contains(self, relpath: str) -> bool:
        parts = _segments(relpath)
        for spec in self.exclude_files:
            if _tail_matches(parts, spec):
                return False
        dirnames = parts[:-1]
        if any(d in dirnames for d in self.dirs):
            return True
        if any(_tail_matches(parts, spec) for spec in self.files):
            return True
        return parts[-1] in self.top_files and len(parts) <= 2


# ── the shared scope instances (one definition, no drift) ────────────

#: JGL002 — PRNG discipline applies to the scenario drivers.
SCENARIOS = Scope(dirs=("scenarios",))

#: JGL004 — the numerics contract lives in ops/ and estimators/.
DTYPE = Scope(dirs=("ops", "estimators"))

#: JGL005 — the one module allowed to open files for writing.
EXPORT_MODULE = Scope(files=("observability/export.py",))

#: JGL006 — observability shared state (slo.py belongs to JGL008).
OBSERVABILITY_STATE = Scope(
    dirs=("observability",), exclude_files=("observability/slo.py",)
)

#: JGL008/JGL015..19 driver file — the top-level pipeline only.
SCHEDULER_STATE = Scope(
    dirs=("scheduler", "serving"),
    files=("observability/slo.py",),
    top_files=("pipeline.py",),
)

#: JGL007 exemption — the retry/chaos plane is allowed bare excepts.
RESILIENCE_EXEMPT = Scope(dirs=("resilience",), files=("parallel/retry.py",))

#: JGL009 exemption — telemetry may read wall clocks.
WALLCLOCK_EXEMPT = Scope(dirs=("observability",))

#: JGL010 — host transfers belong to the metered artifact plane.
HOST_TRANSFER = Scope(dirs=("scheduler",), top_files=("pipeline.py",))

#: JGL011 — gather-by-row-id belongs to the model kernels.
MODELS = Scope(dirs=("models",))

#: JGL012 — unbounded joins in the serving/scheduler planes.
UNBOUNDED_JOIN = Scope(
    dirs=("serving", "scheduler"), files=("resilience/watchdog.py",)
)

#: JGL014 — label cardinality in the serving/observability planes.
LABEL_CARDINALITY = Scope(dirs=("serving", "observability"))

#: JGL015–JGL019 — the threaded planes the concurrency analyzer walks.
CONCURRENCY = Scope(
    dirs=("scheduler", "serving", "parallel", "observability", "resilience"),
    top_files=("pipeline.py",),
)

#: JGL021 exemption — where metric families ORIGINATE: the registry
#: primitives themselves and the one sanctioned pre-creation site
#: (``install_monitoring``; the JAX package's ``install_jax_monitoring``).
METRIC_FAMILY_ORIGIN = Scope(
    files=("observability/device.py", "observability/registry.py"),
)
