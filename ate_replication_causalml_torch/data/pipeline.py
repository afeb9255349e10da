"""Data preparation and bias injection — the reference notebook's L0 stages.

Port of ``ate_replication_causalml_tpu/data/pipeline.py``; reproduces
``ate_replication.Rmd`` exactly (quirks included, SURVEY.md §7.4):

* ``prepare_dataset``: subsample ``n_obs`` rows with R's RNG
  (``Rmd:41-44, 66-68``), z-score the 15 continuous covariates with the
  n-1 sd (R ``scale()``, ``Rmd:72-74``), pass binaries through, rename
  outcome/treatment to Y/W (``Rmd:90-93``), drop NA rows (``Rmd:93``).
* ``inject_bias``: construct confounding from the RCT (``Rmd:97-123``) —
  drop the first ``round(p * k)`` treated units likely to vote and
  control units likely not to vote. The treated-side condition tests
  ``p2002`` twice and never tests ``p2004`` (``Rmd:104``) — a reference
  quirk reproduced verbatim because it shapes ``df_mod``.

The work is host-side NumPy; the resulting ``CausalFrame`` lands on the
requested device (``cuda`` unless the caller says otherwise).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame
from ate_replication_causalml_torch.data.schema import GGL_SCHEMA, DatasetSchema
from ate_replication_causalml_torch.utils.rrandom import RCompatRNG


@dataclasses.dataclass(frozen=True)
class PrepConfig:
    """Notebook-global constants, made explicit (SURVEY.md §5.6)."""

    n_obs: int = 50_000          # ate_replication.Rmd:43
    seed: int = 1991             # ate_replication.Rmd:42
    pt: float = 0.85             # drop fraction, treated side (Rmd:99)
    pc: float = 0.85             # drop fraction, control side (Rmd:100)
    sample_kind: str = "rounding"  # R <= 3.5 sample.int default (2018-era)


def load_raw_csv(path: str, schema: DatasetSchema = GGL_SCHEMA) -> dict[str, np.ndarray]:
    """Load the reference's CSV (``read.csv``, ``ate_replication.Rmd:33``)
    into raw columns keyed by the schema's names. Non-numeric entries
    (R's ``NA`` strings, blanks) become NaN and are dropped later by
    ``prepare_dataset``'s na.omit stage."""
    with open(path, "r") as f:
        header = [h.strip().strip('"') for h in f.readline().rstrip("\n").split(",")]
    wanted = set(schema.all_columns)
    missing = wanted - set(header)
    if missing:
        raise ValueError(f"CSV {path} is missing columns: {sorted(missing)}")
    usecols = [i for i, h in enumerate(header) if h in wanted]
    data = np.genfromtxt(
        path, delimiter=",", skip_header=1, usecols=usecols,
        dtype=np.float64, missing_values=("NA", "", "NaN"), filling_values=np.nan,
    )
    data = np.atleast_2d(data)
    return {header[c]: data[:, j] for j, c in enumerate(usecols)}


def _zscore(col: np.ndarray) -> np.ndarray:
    """R ``scale()``: (x - mean) / sd with the n-1 denominator, NA-tolerant."""
    mu = np.nanmean(col)
    sd = np.nanstd(col, ddof=1)
    return (col - mu) / sd


def prepare_dataset(
    raw: dict[str, np.ndarray],
    config: PrepConfig = PrepConfig(),
    schema: DatasetSchema = GGL_SCHEMA,
    rng: RCompatRNG | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> CausalFrame:
    """Raw columns -> scaled, renamed, NA-free ``CausalFrame`` (the notebook's ``df``).

    ``rng`` defaults to a fresh R-compatible stream seeded with
    ``config.seed`` — ``set.seed(1991)`` followed by ``sample_n``.
    """
    n_raw = len(raw[schema.treatment])
    if rng is None:
        rng = RCompatRNG(config.seed, sample_kind=config.sample_kind)
    idx = rng.sample_n_rows(n_raw, min(config.n_obs, n_raw))

    cols: dict[str, np.ndarray] = {}
    for c in schema.continuous:
        cols[c] = _zscore(np.asarray(raw[c], dtype=np.float64)[idx])
    for c in schema.binary:
        cols[c] = np.asarray(raw[c], dtype=np.float64)[idx]
    cols["Y"] = np.asarray(raw[schema.outcome], dtype=np.float64)[idx]
    cols["W"] = np.asarray(raw[schema.treatment], dtype=np.float64)[idx]

    # na.omit (ate_replication.Rmd:93): drop rows with NA/NaN. R keeps
    # +/-Inf rows (Inf is not NA), so isnan — not isfinite — matches.
    keep = np.ones(len(idx), dtype=bool)
    for v in cols.values():
        keep &= ~np.isnan(v)
    cols = {k: v[keep] for k, v in cols.items()}

    out_schema = schema.replace(outcome="Y", treatment="W")
    return CausalFrame.from_columns(cols, out_schema, dtype=dtype, device=device)


def bias_drop_indices(frame: CausalFrame, config: PrepConfig = PrepConfig()) -> np.ndarray:
    """Row indices the bias injection removes (``ate_replication.Rmd:97-119``),
    0-based, treated drops first, then control drops."""
    col = lambda name: frame.column(name).cpu().numpy()
    w = frame.w.cpu().numpy()

    # Likely voters, dropped from TREATMENT (Rmd:103-105). Note the
    # reference quirk: p2002 appears twice and p2004 not at all.
    drop_from_treat = (
        (col("g2000") == 1) | (col("g2002") == 1)
        | (col("p2000") == 1) | (col("p2002") == 1) | (col("p2002") == 1)
        | (col("city") > 2) | (col("yob") > 2)
    )
    # Likely non-voters, dropped from CONTROL (Rmd:108-110).
    drop_from_control = (
        (col("g2000") == 0) | (col("g2002") == 0)
        | (col("p2000") == 0) | (col("p2002") == 0) | (col("p2004") == 0)
        | (col("city") < -2) | (col("yob") < -2)
    )

    # which() returns ascending indices; the notebook keeps the FIRST
    # round(p*k) of each (Rmd:113-117). R round() is half-to-even, as is
    # np.round.
    drop_treat_idx = np.nonzero((w == 1) & drop_from_treat)[0]
    drop_control_idx = np.nonzero((w == 0) & drop_from_control)[0]
    n_t = int(np.round(config.pt * len(drop_treat_idx)))
    n_c = int(np.round(config.pc * len(drop_control_idx)))
    drop = np.concatenate([drop_treat_idx[:n_t], drop_control_idx[:n_c]])
    _, first = np.unique(drop, return_index=True)
    return drop[np.sort(first)]


def inject_bias(
    frame: CausalFrame, config: PrepConfig = PrepConfig()
) -> tuple[CausalFrame, np.ndarray]:
    """The notebook's ``df_mod <- df[-drop_idx, ]`` (``Rmd:121``).

    Returns (biased frame, dropped indices).
    """
    drop = bias_drop_indices(frame, config)
    keep = np.setdiff1d(np.arange(frame.n), drop, assume_unique=False)
    return frame.take(keep), drop
