"""Synthetic Gerber–Green–Larimer-like data generator.

The real dataset (``socialpresswgeooneperhh_NEIGH.csv``) is gitignored in
the reference repository and must be downloaded
separately (``ate_replication.Rmd:30``), so the framework ships a
synthetic generator producing the same shape: the GGL_SCHEMA columns, a
randomized treatment (the RCT property the oracle relies on,
``ate_replication.Rmd:127-135``), and a binary turnout outcome whose
true ATE is configurable (the published oracle is ≈0.095, BASELINE.md).

Covariates are generated with the correlation structure the reference's
bias injection exploits (``ate_replication.Rmd:97-123``): past-vote flags
(g2000/g2002/p2000/p2002/p2004) strongly predict turnout, and ``city`` /
``yob`` carry wide tails so the ``> 2`` / ``< -2`` z-score conditions
select real subpopulations.

Generation is columnar NumPy on host (this is L0 ingest, not the device hot
path); the result feeds ``prepare_dataset`` exactly like a loaded CSV.
A copy of the JAX package's ``data/synthetic.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from ate_replication_causalml_torch.data.schema import GGL_SCHEMA, DatasetSchema


def make_ggl_like(
    n: int,
    seed: int = 0,
    true_ate: float = 0.095,
    treat_frac: float = 1.0 / 6.0,
    schema: DatasetSchema = GGL_SCHEMA,
) -> dict[str, np.ndarray]:
    """Generate raw (unscaled) columns mimicking the GGL one-per-household file.

    Returns a dict of 1-D float64 arrays keyed by ``schema.all_columns``.
    The treatment is completely randomized (Bernoulli ``treat_frac``),
    so a difference-in-means on the full sample is an unbiased oracle for
    ``true_ate`` — the reference's validation strategy (SURVEY.md §4.1).
    """
    rng = np.random.default_rng(seed)

    # Latent "civic engagement" score drives both past votes and turnout —
    # this is the confounder the bias injection turns into selection.
    civic = rng.normal(0.0, 1.0, n)

    cols: dict[str, np.ndarray] = {}
    # Demographics (raw scales roughly matching the census-block fields).
    cols["yob"] = np.clip(rng.normal(1956.0, 14.0, n) - 0.8 * civic, 1900, 1990).round()
    cols["city"] = rng.integers(1, 9, n).astype(np.float64) + np.round(
        np.clip(0.9 * civic, -3, 3)
    )
    cols["hh_size"] = np.clip(rng.poisson(2.0, n) + 1, 1, 8).astype(np.float64)
    cols["totalpopulation_estimate"] = rng.lognormal(7.8, 0.7, n).round()
    cols["percent_male"] = np.clip(rng.normal(49.5, 3.0, n), 30, 70)
    cols["median_age"] = np.clip(rng.normal(38.0, 6.0, n) + 1.5 * civic, 18, 80)
    cols["percent_62yearsandover"] = np.clip(rng.normal(14.0, 6.0, n) + 2.0 * civic, 0, 60)
    pw = np.clip(rng.normal(85.0, 15.0, n) + 3.0 * civic, 0, 100)
    cols["percent_white"] = pw
    cols["percent_black"] = np.clip(rng.normal(8.0, 10.0, n) - 0.2 * (pw - 85.0), 0, 100)
    cols["percent_asian"] = np.clip(rng.normal(2.0, 3.0, n), 0, 60)
    cols["median_income"] = rng.lognormal(10.8, 0.4, n).round() + 4000.0 * np.clip(civic, -2, 2)
    cols["employ_20to64"] = np.clip(rng.normal(75.0, 8.0, n) + 2.0 * civic, 20, 100)
    cols["highschool"] = np.clip(rng.normal(88.0, 7.0, n) + 2.0 * civic, 30, 100)
    cols["bach_orhigher"] = np.clip(rng.normal(24.0, 12.0, n) + 4.0 * civic, 0, 100)
    cols["percent_hispanicorlatino"] = np.clip(rng.normal(4.0, 6.0, n), 0, 100)
    cols["sex"] = (rng.random(n) < 0.5).astype(np.float64)

    # Past participation: general elections high base rate, primaries low,
    # all loaded on the civic confounder.
    def vote_flag(base_logit: float, load: float) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-(base_logit + load * civic)))
        return (rng.random(n) < p).astype(np.float64)

    cols["g2000"] = vote_flag(1.2, 1.4)
    cols["g2002"] = vote_flag(0.9, 1.4)
    cols["p2000"] = vote_flag(-1.2, 1.2)
    cols["p2002"] = vote_flag(-0.8, 1.2)
    cols["p2004"] = vote_flag(-0.6, 1.2)

    # Randomized treatment (the RCT) and potential outcomes.
    w = (rng.random(n) < treat_frac).astype(np.float64)
    base_logit = -0.7 + 1.1 * civic + 0.4 * (cols["g2002"] - 0.5) + 0.3 * (cols["p2004"] - 0.5)
    p0 = 1.0 / (1.0 + np.exp(-base_logit))
    p1 = np.clip(p0 + true_ate, 0.0, 1.0)
    u = rng.random(n)
    y0 = (u < p0).astype(np.float64)
    y1 = (u < p1).astype(np.float64)  # shared uniform => monotone potential outcomes
    cols[schema.outcome] = np.where(w == 1.0, y1, y0)
    cols[schema.treatment] = w
    return cols
