"""Columnar causal dataset container on torch tensors.

Port of ``ate_replication_causalml_tpu/data/frame.py``: one ``(n, p)``
covariate matrix in schema order plus ``w``/``y`` vectors, all on one
device, with the schema riding along.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.data.schema import DatasetSchema


@dataclasses.dataclass(frozen=True)
class CausalFrame:
    """Dense causal dataset: covariates ``x`` ~ (n, p), treatment ``w`` ~ (n,),
    outcome ``y`` ~ (n,). Columns of ``x`` follow ``schema.covariates`` order
    (continuous first, then binary — ``ate_replication.Rmd:57``)."""

    x: torch.Tensor
    w: torch.Tensor
    y: torch.Tensor
    schema: DatasetSchema = None

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def p(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def column(self, name: str) -> torch.Tensor:
        """A single covariate column by schema name."""
        (idx,) = self.schema.column_index(name)
        return self.x[:, idx]

    def take(self, indices) -> "CausalFrame":
        """Row-subset (R ``df[idx, ]``)."""
        idx = torch.as_tensor(np.asarray(indices), dtype=torch.int64, device=self.device)
        return CausalFrame(
            x=self.x[idx], w=self.w[idx], y=self.y[idx], schema=self.schema
        )

    def to(self, device=None, dtype=None) -> "CausalFrame":
        return CausalFrame(
            x=self.x.to(device=device, dtype=dtype),
            w=self.w.to(device=device, dtype=dtype),
            y=self.y.to(device=device, dtype=dtype),
            schema=self.schema,
        )

    @classmethod
    def from_columns(
        cls,
        columns: Mapping[str, np.ndarray],
        schema: DatasetSchema,
        dtype=torch.float32,
        device=None,
    ) -> "CausalFrame":
        """Build from a dict of 1-D numpy columns (host-side ingest path)."""
        dev = resolve_device(device)
        x = np.stack([np.asarray(columns[c], dtype=np.float64) for c in schema.covariates], axis=1)
        w = np.asarray(columns[schema.treatment], dtype=np.float64)
        y = np.asarray(columns[schema.outcome], dtype=np.float64)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype).to(dev)
        return cls(x=as_t(x), w=as_t(w), y=as_t(y), schema=schema)

    def design_matrix(self, include_treatment: bool = True, intercept: bool = True) -> torch.Tensor:
        """[1, X, W] design matrix (R formula ``Y ~ .`` — ``ate_functions.R:26``)."""
        cols = [self.x]
        if include_treatment:
            cols.append(self.w[:, None])
        m = torch.cat(cols, dim=1)
        if intercept:
            m = torch.cat([torch.ones_like(m[:, :1]), m], dim=1)
        return m
