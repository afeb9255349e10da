"""Dataset schema: typed covariate roles.

The reference keeps covariate lists in notebook globals
(``ate_replication.Rmd:49-58``) and several estimators silently read the
``covariates`` global (``ate_functions.R:91, 113, 135, 289, 394-396``).
Here that hidden state becomes an explicit, immutable schema object that
travels with the data (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DatasetSchema:
    """Names and roles of the columns of a causal dataset.

    Attributes:
      continuous: covariates that are z-scored during preprocessing
        (``ate_replication.Rmd:72-74``).
      binary: indicator covariates, passed through unscaled
        (``ate_replication.Rmd:77-79``).
      outcome: outcome column name (renamed to ``Y`` in the reference,
        ``ate_replication.Rmd:90-93``).
      treatment: treatment column name (renamed to ``W``).
    """

    continuous: tuple[str, ...]
    binary: tuple[str, ...]
    outcome: str = "Y"
    treatment: str = "W"

    @property
    def covariates(self) -> tuple[str, ...]:
        """All covariates, continuous first — the reference's column order
        (``ate_replication.Rmd:57``)."""
        return self.continuous + self.binary

    @property
    def all_columns(self) -> tuple[str, ...]:
        return self.covariates + (self.outcome, self.treatment)

    @property
    def n_covariates(self) -> int:
        return len(self.covariates)

    def column_index(self, names: Sequence[str] | str) -> list[int]:
        if isinstance(names, str):
            names = [names]
        cov = list(self.covariates)
        return [cov.index(n) for n in names]

    def replace(self, **kwargs) -> "DatasetSchema":
        return dataclasses.replace(self, **kwargs)


# The Gerber–Green–Larimer 2008 social-pressure schema used by the
# reference notebook (``ate_replication.Rmd:49-58``): 15 continuous +
# 6 binary covariates, outcome ``outcome_voted``, treatment
# ``treat_neighbors``.
GGL_CONTINUOUS = (
    "yob",
    "city",
    "hh_size",
    "totalpopulation_estimate",
    "percent_male",
    "median_age",
    "percent_62yearsandover",
    "percent_white",
    "percent_black",
    "percent_asian",
    "median_income",
    "employ_20to64",
    "highschool",
    "bach_orhigher",
    "percent_hispanicorlatino",
)
GGL_BINARY = ("sex", "g2000", "g2002", "p2000", "p2002", "p2004")

GGL_SCHEMA = DatasetSchema(
    continuous=GGL_CONTINUOUS,
    binary=GGL_BINARY,
    outcome="outcome_voted",
    treatment="treat_neighbors",
)

# After the reference's rename step (``ate_replication.Rmd:90-93``) the
# outcome/treatment are literally called Y/W; estimator code operates on
# this schema.
GGL_SCHEMA_WY = GGL_SCHEMA.replace(outcome="Y", treatment="W")
