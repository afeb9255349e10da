"""Least-squares helpers of the slice: intercept column and Cholesky solves.

Port of the parts of ``ate_replication_causalml_tpu/ops/linalg.py``
that the AIPW path uses. The normal equations are solved by Cholesky
in the input's own precision: float32 stays full float32 on the card
(TF32 is off for the whole package, see ``__init__``).
"""

from __future__ import annotations

import torch


def _chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system ``a x = b`` via Cholesky (``b`` may be 1-D)."""
    chol = torch.linalg.cholesky(a)
    vec = b.ndim == 1
    x = torch.cholesky_solve(b[:, None] if vec else b, chol)
    return x[:, 0] if vec else x


def _spd_inverse(a: torch.Tensor) -> torch.Tensor:
    chol = torch.linalg.cholesky(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.cholesky_solve(eye, chol)


def add_intercept(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(x[:, :1]), x], dim=1)
