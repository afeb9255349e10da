#!/usr/bin/env python3
"""The sweep's "Doubly Robust with Random Forest PS" stage on the card
and on the CPU port, step by step.

    python3 scripts/torch_sweep_dr_card.py [--trees 2500] > dr.json

At ``SweepConfig()`` (the sweep's frames, its keys ``fold_in(key(0),
crc32(name))``, 2,500 trees of depth 9, float32) each package-side step
runs on both devices: the frames, the forest's OOB votes, the outcome
model's (mu0, mu1) and τ with its sandwich SE. Then τ again from each
device's nuisances on the other device, so that a card-against-CPU gap
in τ is charged either to the nuisances or to the AIPW arithmetic.
Prints one JSON object with the card's name and power limit, and exits
1 if the card's τ is not within the bound of the CPU's. Needs a CUDA
card; the CPU forest takes a few minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ate_replication_causalml_torch import pipeline  # noqa: E402
from ate_replication_causalml_torch.estimators.aipw import (  # noqa: E402
    doubly_robust,
    outcome_model_mu,
)
from ate_replication_causalml_torch.models.forest import rf_oob_propensity  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402
from ate_replication_causalml_torch.ops.glm import _binomial_deviance  # noqa: E402
from ate_replication_causalml_torch.ops.linalg import _chol_solve, add_intercept  # noqa: E402


def maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def stage(device: str, trees: int) -> dict:
    """The stage's frames, votes, outcome model and row on ``device``."""
    config = pipeline.SweepConfig()
    _, frame, _ = pipeline.build_frames(config, device=device)
    root = rnd.key(config.seed, device=device)
    key = lambda name: rnd.fold_in(root, zlib.crc32(name.encode()))
    t0 = time.perf_counter()
    p = rf_oob_propensity(frame, key=key("dr_rf_prop"), n_trees=trees, depth=config.forest_depth)
    mu = outcome_model_mu(frame)
    row = doubly_robust(frame, lambda f: p, key=key("dr_rf"), mu=mu)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"frame": frame, "p": p, "mu": mu, "row": row, "key": key("dr_rf"),
            "seconds": time.perf_counter() - t0}


def glm_step(x, y, eta):
    """One IRLS iteration of ``logistic_glm``, its intermediates kept."""
    mu = torch.sigmoid(eta)
    w = torch.clamp(mu * (1.0 - mu), min=1e-10)
    z = eta + (y - mu) / w
    xw = x * w[:, None]
    gram, xtwz = xw.T @ x, xw.T @ z
    coef = _chol_solve(gram, xtwz)
    eta_new = x @ coef
    dev = _binomial_deviance(y, torch.sigmoid(eta_new))
    return {"mu": mu, "gram": gram, "xtwz": xtwz, "coef": coef, "eta": eta_new, "dev": dev}


def glm_trace(frame, max_iter: int = 25, epsilon: float = 1e-8) -> list:
    """``logistic_glm``'s loop on the outcome model's design, every step
    kept (the same arithmetic, the same stopping rule)."""
    x = torch.cat([add_intercept(frame.x), frame.w[:, None]], dim=1)
    y = frame.y
    mu0 = (y + 0.5) / 2.0
    eta = torch.log(mu0 / (1.0 - mu0))
    dev = _binomial_deviance(y, mu0)
    steps = []
    while len(steps) < max_iter:
        st = glm_step(x, y, eta)
        st["converged"] = bool(torch.abs(st["dev"] - dev) / (torch.abs(st["dev"]) + 0.1)
                               < epsilon)
        steps.append(st)
        eta, dev = st["eta"], st["dev"]
        if st["converged"]:
            break
    return steps


def glm_compare(fc, fh) -> dict:
    """The outcome model's IRLS card against CPU, step by step."""
    sc, sh = glm_trace(fc), glm_trace(fh)
    rows = []
    for i, (a, b) in enumerate(zip(sc, sh)):
        rows.append({"iter": i + 1, "gram": maxdiff(a["gram"], b["gram"]),
                     "xtwz": maxdiff(a["xtwz"], b["xtwz"]), "coef": maxdiff(a["coef"], b["coef"]),
                     "dev_card": float(a["dev"]), "dev_cpu": float(b["dev"]),
                     "converged": [a["converged"], b["converged"]]})
    # One step from the same η (the CPU's first iterate's input and its
    # last), so the gap is the step's own arithmetic.
    x_h = torch.cat([add_intercept(fh.x), fh.w[:, None]], dim=1)
    same = []
    for label, eta in (("initial", torch.log(((fh.y + 0.5) / 2.0) / (1.0 - (fh.y + 0.5) / 2.0))),
                       ("last", sh[-2]["eta"] if len(sh) > 1 else sh[-1]["eta"])):
        a = glm_step(x_h.cuda(), fh.y.cuda(), eta.cuda())
        b = glm_step(x_h, fh.y, eta)
        same.append({"eta": label, **{k: maxdiff(a[k], b[k])
                                       for k in ("mu", "gram", "xtwz", "coef", "eta", "dev")}})
    return {"iterations": {"card": len(sc), "cpu": len(sh)}, "steps": rows, "same_input": same}


def dr_bound(cpu: dict, card: dict, arithmetic_gap: float) -> dict:
    """The card-against-CPU bound of the DR row from the measured mu gap
    and the clipped propensity (module docstring)."""
    from ate_replication_causalml_torch.estimators.aipw import clip_propensity

    f = cpu["frame"]
    p = clip_propensity(cpu["p"].to(f.w)).double()
    w = f.w.double()
    c1 = (1.0 - w / p).abs()
    c0 = (1.0 + (1.0 - w) / (1.0 - p)).abs()
    d1 = (card["mu"][1].double().cpu() - cpu["mu"][1].double()).abs()
    d0 = (card["mu"][0].double().cpu() - cpu["mu"][0].double()).abs()
    dmu = float(torch.max(d1.max(), d0.max()))
    C = float((c1 + c0).mean())
    linear = float((c1 * d1 + c0 * d0).mean())
    gap = abs(card["row"].ate - cpu["row"].ate)
    bound = dmu * C + arithmetic_gap
    return {"C": C, "C_worst": 2.0 + float(torch.max(1.0 / p, 1.0 / (1.0 - p)).max()),
            "p_min": float(p.min()), "p_max": float(p.max()), "max_dmu": dmu,
            "linear_term": linear, "max_dmu_times_C": dmu * C,
            "arithmetic_gap": arithmetic_gap, "bound": bound, "tau_gap": gap,
            "held": gap <= bound}


def tau(on: dict, p: torch.Tensor, mu) -> list:
    """τ and SE on ``on``'s frame and device from the given nuisances."""
    dev = on["frame"].device
    row = doubly_robust(on["frame"], lambda f: p.to(dev), key=on["key"],
                        mu=tuple(m.to(dev) for m in mu))
    return [row.ate, row.se]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=pipeline.SweepConfig().dr_trees)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_dr_card: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    card, cpu = stage("cuda", args.trees), stage("cpu", args.trees)
    fc, fh = card["frame"], cpu["frame"]
    cross = {"card nuisances, cpu arithmetic": tau(cpu, card["p"], card["mu"]),
             "cpu nuisances, card arithmetic": tau(card, cpu["p"], cpu["mu"])}
    arithmetic_gap = max(abs(cross["card nuisances, cpu arithmetic"][0] - card["row"].ate),
                         abs(cross["cpu nuisances, card arithmetic"][0] - cpu["row"].ate))
    out = {
        "script": "scripts/torch_sweep_dr_card.py", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "trees": args.trees, "rows": fc.n,
        "max_abs_diff": {
            "frame x, w, y": max(maxdiff(fc.x, fh.x), maxdiff(fc.w, fh.w), maxdiff(fc.y, fh.y)),
            "OOB votes": maxdiff(card["p"], cpu["p"]),
            "mu0, mu1": max(maxdiff(card["mu"][0], cpu["mu"][0]),
                            maxdiff(card["mu"][1], cpu["mu"][1])),
        },
        "votes_at_0_or_1": int(((cpu["p"] == 0) | (cpu["p"] == 1)).sum()),
        "tau_se": {
            "card": [card["row"].ate, card["row"].se],
            "cpu": [cpu["row"].ate, cpu["row"].se],
            **cross,
        },
        "glm_steps": glm_compare(fc, fh),
        "bound": dr_bound(cpu, card, arithmetic_gap),
        "seconds": {"card": card["seconds"], "cpu": cpu["seconds"]},
    }
    print(json.dumps(out, indent=1))
    return 0 if out["bound"]["held"] else 1


if __name__ == "__main__":
    sys.exit(main())
