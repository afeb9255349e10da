#!/usr/bin/env python
"""Hold the card's ``aipw_logit`` frontier lanes to the CPU port's, within
the float32 bound derived below, at the two points of
``default_frontier_spec(0)`` where their coverages differ (n = 256,
p = 96, sparsity 0 and 4).

Usage (on a machine with a CUDA card; ``--device cpu`` compares the CPU
with itself)::

    python scripts/torch_frontier_gap.py [--reps 192] [--device cuda]

Prints one JSON line a point and a summary line, and exits 1 when the
bound does not hold.

**The bound.** Each lane fits two binomial-logit IRLS models in float32
(the propensity on [1, X], the outcome on [1, X, W]; n = 256 rows, 97 and
98 coefficients). Every sum of n terms in a fit (X'WX, X'Wz, the
deviance) carries a relative rounding error of at most
γ_n = n·u / (1 − n·u), u = 2⁻²⁴, whatever order a device sums in, so two
devices' normal equations differ by O(γ_n) relative, and the solution of
a system whose matrix has condition number κ moves by at most about
κ·γ_n relative. The lane's τ̂ and SE are smooth in those coefficients, so
the first-order bound a lane is

    |Δτ̂|, |ΔSE|  ≤  γ_n · κ · (|τ̂| + SE),

κ the larger of the two fits' Hessian condition numbers (float64, at the
float64 fit on the CPU port's draw, which is the same on both devices).
Where γ_n·κ ≥ 1 the perturbation bound is void: the fit is not determined
in float32 at all (a quasi-separated outcome model; κ up to 1e11 at these
points), and the two devices may disagree on the estimate, on whether the
IRLS converges, and so on coverage. The gap is classified as a float32
reduction gap when (1) every lane that is determined and finite on both
devices is within its bound, and (2) every lane whose coverage indicator
or finiteness differs between the devices is undetermined. The CPU port
against the JAX package obeys the same rule (``tests/test_torch_frontier_gap.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ESTIMATOR = "aipw_logit"
POINTS = ({"n": 256, "p": 96, "sparsity": 0}, {"n": 256, "p": 96, "sparsity": 4})
U32 = 2.0 ** -24
Z = 1.959963984540054


def gamma(n: int) -> float:
    return n * U32 / (1.0 - n * U32)


def _spec():
    from ate_replication_causalml_torch.scenarios.frontier import default_frontier_spec

    return default_frontier_spec(0)


def lanes(knobs: dict, device: str, reps: int) -> np.ndarray:
    """(3, reps) float64: each replicate's ``ate``, ``se`` and ``tau_true``
    from the column's batched callable on ``device``."""
    import torch

    from ate_replication_causalml_torch.ops import random as rnd
    from ate_replication_causalml_torch.scenarios import batched as tb
    from ate_replication_causalml_torch.scenarios.frontier import dgp_for

    spec = _spec()
    dgp = dgp_for(spec.baseline, knobs)
    width = spec.width()
    exe = tb.column_executable(dgp, tb.SCENARIO_ESTIMATORS[ESTIMATOR], width)
    root = rnd.key(spec.seed, device=torch.device(device))
    out = []
    for lo in range(0, reps, width):
        batch = tuple(range(lo, min(lo + width, reps)))
        a, s, t = exe(root, tb.pad_ids(dgp.name, batch, width))
        out.append(np.stack([x.cpu().numpy()[:len(batch)] for x in (a, s, t)]))
    return np.concatenate(out, axis=1).astype(np.float64)


def lane_kappas(knobs: dict, reps: int) -> np.ndarray:
    """(reps,) the larger Hessian condition number of a lane's two logit
    fits, in float64 on the CPU port's draw; inf where a fit is not finite."""
    import torch

    from ate_replication_causalml_torch.ops import random as rnd
    from ate_replication_causalml_torch.ops.glm import logistic_glm
    from ate_replication_causalml_torch.ops.linalg import add_intercept
    from ate_replication_causalml_torch.scenarios import batched as tb
    from ate_replication_causalml_torch.scenarios.dgp import generate
    from ate_replication_causalml_torch.scenarios.frontier import dgp_for

    spec = _spec()
    dgp = dgp_for(spec.baseline, knobs)
    width = spec.width()
    cpu = torch.device("cpu")
    root = rnd.key(spec.seed, device=cpu)
    kappas = []
    for lo in range(0, reps, width):
        batch = tuple(range(lo, min(lo + width, reps)))
        keys = rnd.fold_in(root, tb._ids_tensor(tb.pad_ids(dgp.name, batch, width), cpu))
        x, w, y, _ = generate(dgp, keys)
        for b in range(len(batch)):
            xb, wb, yb = x[b].double(), w[b].double(), y[b].double()
            base = add_intercept(xb)
            worst = 0.0
            for design, target in ((base, wb), (torch.cat([base, wb[:, None]], 1), yb)):
                mu = torch.sigmoid(design @ logistic_glm(design, target).coef)
                hess = design.T @ (design * (mu * (1.0 - mu))[:, None])
                k = float(torch.linalg.cond(hess)) if bool(torch.isfinite(hess).all()) else np.inf
                worst = max(worst, k if np.isfinite(k) else np.inf)
            kappas.append(worst)
    return np.asarray(kappas)


def classify(a: np.ndarray, b: np.ndarray, kappa: np.ndarray, n: int) -> dict:
    """The gap between lanes ``a`` (the device under test) and ``b`` (the
    reference), judged by the bound of the module docstring."""
    g = gamma(n)
    determined = g * kappa < 1.0
    finite = np.isfinite(a[:2]).all(0) & np.isfinite(b[:2]).all(0)
    bound = g * kappa * (np.abs(b[0]) + b[1])
    both = determined & finite
    d_ate, d_se = np.abs(a[0] - b[0]), np.abs(a[1] - b[1])
    over = np.nonzero(both & ((d_ate > bound) | (d_se > bound)))[0]
    with np.errstate(invalid="ignore"):
        cov_a = np.abs(a[0] - a[2]) <= Z * a[1]
        cov_b = np.abs(b[0] - b[2]) <= Z * b[1]
    differ = np.nonzero((cov_a != cov_b) | (np.isfinite(a[0]) != np.isfinite(b[0])))[0]
    unexplained = [int(i) for i in differ if determined[i]]
    ratio = np.where(both, np.maximum(d_ate, d_se) / np.where(bound > 0, bound, np.inf), 0.0)
    return {
        "gamma_n": g,
        "lanes": int(a.shape[1]),
        "determined": int(determined.sum()),
        "finite_both": int(finite.sum()),
        "max_abs_d_ate": float(d_ate[both].max(initial=0.0)),
        "max_abs_d_se": float(d_se[both].max(initial=0.0)),
        "max_ratio_to_bound": float(ratio.max(initial=0.0)),
        "over_bound": [int(i) for i in over],
        "coverage_or_finiteness_differ": [int(i) for i in differ],
        "differ_but_determined": unexplained,
        "coverage": [float(np.mean(c[np.isfinite(x[1])])) for c, x in ((cov_a, a), (cov_b, b))],
        "held": not len(over) and not unexplained,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    held = True
    for knobs in POINTS:
        t0 = time.perf_counter()
        dev = lanes(knobs, args.device, args.reps)
        t1 = time.perf_counter()
        cpu = lanes(knobs, "cpu", args.reps)
        kappa = lane_kappas(knobs, args.reps)
        res = classify(dev, cpu, kappa, knobs["n"])
        res.update(knobs=knobs, device=args.device, device_s=round(t1 - t0, 3),
                   kappa_quantiles=[float(q) for q in np.quantile(kappa, [0.5, 0.9, 1.0],
                                                                 method="lower")])
        print(json.dumps(res), flush=True)
        held &= res["held"]
    print(json.dumps({"frontier_gap": "held" if held else "NOT HELD"}))
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
