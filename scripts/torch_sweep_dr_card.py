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
Prints one JSON object with the card's name and power limit. Needs a
CUDA card; the CPU forest takes a few minutes.
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
            "card nuisances, cpu arithmetic": tau(cpu, card["p"], card["mu"]),
            "cpu nuisances, card arithmetic": tau(card, cpu["p"], cpu["mu"]),
        },
        "seconds": {"card": card["seconds"], "cpu": cpu["seconds"]},
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
