"""Stage DAG model of the concurrent sweep.

Port of ``ate_replication_causalml_tpu/scheduler/dag.py``. The sweep's
estimators are combinations of a few shared cross-fit nuisances
(Chernozhukov et al. 2018, arXiv:1608.00060): AIPW, DML, Belloni and
IPW reuse the same propensity and outcome fits. So the sweep is a DAG
over nuisance artifacts, not a list of independent rows. This module is
the declaration layer: stages name the artifacts they consume,
artifacts name the artifacts *they* consume (the LASSO propensity
consumes its fold ids), and :func:`validate` turns the declarations
into the structure the engine schedules.

Nothing here runs work: specs carry plain callables, so the scheduler's
tests drive the engine with synthetic specs.

Layouts (``ArtifactSpec.sharding``, ``consumes_sharding``): an
artifact may declare the layout it is stored in (a
``parallel.mesh.Layout``), and a consumer the layout it takes it in
(``"device"``, ``"host"`` or another layout), as in the JAX package;
the port's cache hands every consumer the fit's value (see
:mod:`.cache`). As in the JAX package, a spec takes any layout object
when it is made; :func:`validate` refuses a consume layout for an
artifact the consumer does not need, or for an artifact that declares
no layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

class DagError(ValueError):
    """A malformed sweep declaration: duplicate node names, a stage or
    artifact consuming an artifact nobody declared, an artifact
    dependency cycle, or a consume layout that binds to nothing. Raised
    at build time: a bad DAG must fail before any estimator runs, not
    deadlock the pool."""


@dataclasses.dataclass(frozen=True)
class ArtifactSpec:
    """One fit-once nuisance artifact.

    ``fit`` receives the :class:`~.cache.NuisanceCache` as a resolver so
    an artifact can consume other artifacts (declared in ``needs``).
    ``key`` is the cache identity beyond the name (the data fingerprint
    and the config knobs the fit reads), so two sweeps with different
    configs never share an artifact.
    """

    name: str
    fit: Callable[[object], object]
    needs: tuple[str, ...] = ()
    key: tuple = ()
    #: optional prefetch hook: work the node's first use would otherwise
    #: do on its hot path (see prefetch.py). Must not touch numerics.
    warm: Callable[[], object] | None = None
    #: nodes sharing a non-None lane name never execute concurrently.
    exclusive: str | None = None
    #: the layout tag the value is declared in (the cache stores the
    #: value as the fit returned it either way).
    sharding: object | None = None
    #: artifact name -> the layout this fit consumes it in. Keys must be
    #: a subset of ``needs`` and name artifacts that declare a layout.
    consumes_sharding: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One sweep stage (estimator, oracle, ...) in declared order.

    ``run`` receives the cache resolver; ``needs`` names the artifacts
    it consumes. The engine commits journal, report and log in
    declaration order whatever the completion order, so the declaration
    list is the notebook order contract.
    """

    name: str
    run: Callable[[object], object]
    needs: tuple[str, ...] = ()
    warm: Callable[[], object] | None = None
    #: see ArtifactSpec.exclusive.
    exclusive: str | None = None
    #: see ArtifactSpec.consumes_sharding.
    consumes_sharding: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Dag:
    """Validated DAG: specs by name plus the artifact depth map used to
    order artifact nodes ahead of their first consumer."""

    artifacts: dict[str, ArtifactSpec]
    stages: tuple[StageSpec, ...]
    #: artifact name -> longest chain of artifact-to-artifact deps below
    #: it (leaves are 0). Deeper artifacts must be fit first.
    depth: dict[str, int]
    #: artifact name -> index of the earliest declared stage that
    #: (transitively) consumes it.
    first_consumer: dict[str, int]


def _closure(artifacts: dict[str, ArtifactSpec], roots: Iterable[str]) -> set[str]:
    """All artifacts reachable from ``roots`` through ``needs`` edges."""
    seen: set[str] = set()
    todo = list(roots)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo.extend(artifacts[name].needs)
    return seen


def validate(artifacts: Iterable[ArtifactSpec], stages: Iterable[StageSpec]) -> Dag:
    """Check the declarations and derive scheduling metadata.

    Raises :class:`DagError` on duplicate names, unknown ``needs``
    references, layout declarations that bind to nothing, or artifact
    cycles. Stages only consume artifacts, so stages never form a cycle.
    """
    arts: dict[str, ArtifactSpec] = {}
    for a in artifacts:
        if a.name in arts:
            raise DagError(f"duplicate artifact {a.name!r}")
        arts[a.name] = a
    stage_list = tuple(stages)
    seen_stages: set[str] = set()
    for s in stage_list:
        if s.name in seen_stages or s.name in arts:
            raise DagError(f"duplicate node name {s.name!r}")
        seen_stages.add(s.name)
    for a in arts.values():
        for dep in a.needs:
            if dep not in arts:
                raise DagError(f"artifact {a.name!r} needs unknown artifact {dep!r}")
    for s in stage_list:
        for dep in s.needs:
            if dep not in arts:
                raise DagError(f"stage {s.name!r} needs unknown artifact {dep!r}")
    # A consume layout must bind to a consumed artifact that declares a
    # layout: a key outside ``needs`` is a typo that would silently fall
    # back to the default form.
    for kind, spec in ([("artifact", a) for a in arts.values()]
                       + [("stage", s) for s in stage_list]):
        for dep in spec.consumes_sharding:
            if dep not in spec.needs:
                raise DagError(f"{kind} {spec.name!r} declares consumes_sharding for "
                               f"{dep!r} it does not consume")
            if arts[dep].sharding is None:
                raise DagError(f"{kind} {spec.name!r} declares a consume layout for "
                               f"unsharded artifact {dep!r}")

    # Artifact depth by an iterative DFS; a cycle shows as revisiting the
    # active path (a declaration bug must give DagError, not RecursionError).
    depth: dict[str, int] = {}
    state: dict[str, int] = {}  # 1 = on path, 2 = done
    for root in arts:
        if state.get(root) == 2:
            continue
        state[root] = 1
        stack = [(root, iter(arts[root].needs))]
        while stack:
            name, deps = stack[-1]
            for dep in deps:
                st = state.get(dep)
                if st == 2:
                    continue
                if st == 1:
                    path = tuple(n for n, _ in stack)
                    raise DagError(f"artifact dependency cycle: {' -> '.join(path + (dep,))}")
                state[dep] = 1
                stack.append((dep, iter(arts[dep].needs)))
                break
            else:
                stack.pop()
                state[name] = 2
                depth[name] = max((depth[d] + 1 for d in arts[name].needs), default=0)

    first_consumer: dict[str, int] = {}
    for i, s in enumerate(stage_list):
        for name in _closure(arts, s.needs):
            first_consumer[name] = min(first_consumer.get(name, i), i)
    return Dag(artifacts=arts, stages=stage_list, depth=depth, first_consumer=first_consumer)
