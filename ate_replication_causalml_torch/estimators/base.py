"""The uniform estimator result protocol.

Every estimator in the reference returns a one-row
``data.frame(Method, ATE, lower_ci, upper_ci)`` that the notebook
``rbind``s into ``result_df`` (``ate_replication.Rmd:129-132, 140-141,
156-157, ... 272``). SURVEY.md §1 identifies this uniform record as the
single most important API contract; here it is a typed dataclass plus an
accumulating result table. A copy of the JAX package's
``estimators/base.py`` (plain Python).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterable

# 95% normal critical value — the reference hardcodes 1.96 everywhere
# (``ate_functions.R:17-18, 35-36, 59-60, ...``).
Z_95 = 1.96


@dataclasses.dataclass(frozen=True)
class EstimatorResult:
    """One estimator's output: point estimate and 95% CI.

    ``se`` is carried explicitly (the reference reconstructs it only
    implicitly via the CI half-width); for estimators with no SE the
    reference sets ``lower_ci == upper_ci == ate``
    (``ate_functions.R:107, 129``) and ``se`` is NaN.

    ``status`` is the resilience layer's degradation marker: ``"ok"``
    for a computed estimate, ``"failed"`` for a stage the sweep isolated
    instead of aborting on (pipeline.py) — such rows carry NaN values
    and render annotated, never as silent garbage.
    """

    method: str
    ate: float
    lower_ci: float
    upper_ci: float
    se: float = float("nan")
    status: str = "ok"

    @classmethod
    def from_point_se(cls, method: str, ate: float, se: float) -> "EstimatorResult":
        ate = float(ate)
        se = float(se)
        return cls(
            method=method,
            ate=ate,
            lower_ci=ate - Z_95 * se,
            upper_ci=ate + Z_95 * se,
            se=se,
        )

    @classmethod
    def point_only(cls, method: str, ate: float) -> "EstimatorResult":
        """No-SE record (single-equation/usual LASSO, ``ate_functions.R:107``)."""
        ate = float(ate)
        return cls(method=method, ate=ate, lower_ci=ate, upper_ci=ate)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ResultTable:
    """Accumulator replacing the notebook's ``result_df`` rbind chain."""

    def __init__(self, rows: Iterable[EstimatorResult] = ()):  # noqa: D401
        self.rows: list[EstimatorResult] = list(rows)

    def append(self, row: EstimatorResult) -> "ResultTable":
        self.rows.append(row)
        return self

    def extend(self, rows: Iterable[EstimatorResult]) -> "ResultTable":
        self.rows.extend(rows)
        return self

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, method: str) -> EstimatorResult:
        for r in self.rows:
            if r.method == method:
                return r
        raise KeyError(method)

    def methods(self) -> list[str]:
        return [r.method for r in self.rows]

    def to_records(self) -> list[dict]:
        return [r.to_dict() for r in self.rows]

    def to_json(self, path: str | None = None) -> str:
        s = json.dumps(self.to_records(), indent=2)
        if path is not None:
            # Write-then-rename so a reader never sees a torn file.
            from ate_replication_causalml_torch.observability.export import atomic_write_text

            atomic_write_text(path, s)
        return s

    @classmethod
    def from_json(cls, s: str) -> "ResultTable":
        return cls(EstimatorResult(**row) for row in json.loads(s))

    def __repr__(self) -> str:
        lines = [f"{'Method':<42} {'ATE':>10} {'lower':>10} {'upper':>10}"]
        for r in self.rows:
            lo = "" if math.isnan(r.lower_ci) else f"{r.lower_ci:10.4f}"
            hi = "" if math.isnan(r.upper_ci) else f"{r.upper_ci:10.4f}"
            lines.append(f"{r.method:<42} {r.ate:10.4f} {lo:>10} {hi:>10}")
        return "\n".join(lines)
