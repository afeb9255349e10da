"""Concurrent sweep scheduler of the port.

* :mod:`~.dag`: stage and artifact declarations, DAG validation;
* :mod:`~.cache`: the fit-once nuisance cache, with CUDA events between
  worker streams;
* :mod:`~.engine`: the bounded worker pool, one CUDA stream a worker,
  with declaration-ordered commits (``workers=1`` runs inline);
* :mod:`~.prefetch`: the background lane that builds the kernels ahead
  of their first use.

``pipeline.py`` is the production consumer; the specs are plain
callables, so the tests schedule synthetic DAGs too.
"""

from ate_replication_causalml_torch.scheduler.cache import NuisanceCache
from ate_replication_causalml_torch.scheduler.dag import (
    ArtifactSpec,
    Dag,
    DagError,
    StageSpec,
    validate,
)
from ate_replication_causalml_torch.scheduler.engine import SweepEngine, default_workers
from ate_replication_causalml_torch.scheduler.prefetch import (
    CompilePrefetcher,
    default_enabled as prefetch_default_enabled,
)

__all__ = ["ArtifactSpec", "CompilePrefetcher", "Dag", "DagError", "NuisanceCache", "StageSpec",
           "SweepEngine", "default_workers", "prefetch_default_enabled", "validate"]
