"""What the sweep's telemetry costs on the card, in one call.

    python3 scripts/torch_telemetry_cost.py --parent DIR [--modes sequential concurrent]
        [--order PCTTCP]

Runs ``run_sweep(SweepConfig(), outdir=…)`` (``ATE_TPU_PREDICT_PACK=1``,
as ``chip_smoke.py`` runs it) once a letter of ``--order``, each in a
fresh process, for each mode (``sequential``: ``scheduler="sequential"``;
``concurrent``: the default engine). The letters:

* ``P``: the package of the checkout ``--parent DIR`` (one without the
  telemetry, for example the commit before it, unpacked with
  ``git archive``): ``report.json`` and the journal, nothing more;
* ``C``: this checkout's package: the five telemetry files as well, and
  in the concurrent sweep the sampler thread;
* ``T``: this checkout's package under ``ATE_TPU_TRACE=0``: the metrics
  and events files, no ``trace.json``, no ``overlap_report.json``, no
  sampler.

So C − T is the sampler and the trace export, and T − P the per-chunk
spans, counters and shard runner plus the metrics export. Each process
builds its package's kernels before the timed call, so no wall holds an
``nvcc`` run. Prints one JSON object a line: the card's name and power
limit first, then each run (wall, rows, files, the sampler's samples),
then a summary a mode; exits 1 if any run's rows differ from the first
run's bit for bit (each run's line names the rows that differ and
carries every row's τ and SE). It needs a card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "telemetry_cost")
FILES = ("report.json", "metrics.json", "events.jsonl", "metrics.prom", "trace.json",
         "overlap_report.json")


def one(repo: str, mode: str, outdir: str) -> dict:
    """One sweep in this process, from the package of ``repo``."""
    sys.path.insert(0, repo)
    import torch

    from ate_replication_causalml_torch import pipeline
    from ate_replication_causalml_torch.kernels import build
    from ate_replication_causalml_torch.ops import pack

    assert pipeline.__file__.startswith(os.path.abspath(repo)), pipeline.__file__
    if not torch.cuda.is_available():
        raise SystemExit("torch_telemetry_cost: needs a CUDA card")
    build.build_all()
    os.environ[pack.ENV_PACK] = "1"
    shutil.rmtree(outdir, ignore_errors=True)
    kw = {"scheduler": "sequential"} if mode == "sequential" else {}
    t0 = time.perf_counter()
    rep = pipeline.run_sweep(pipeline.SweepConfig(), outdir=outdir, plots=False,
                             log=lambda s: None, **kw)
    wall = time.perf_counter() - t0
    samples = None
    if os.path.exists(os.path.join(outdir, "trace.json")):
        with open(os.path.join(outdir, "trace.json")) as f:
            samples = json.load(f).get("otherData", {}).get("sampler_ticks")
    return {"wall_s": wall, "computed": rep.computed,
            "rows": {r.method: [r.ate, r.se] for r in [rep.oracle, *rep.results]},
            "files": [f for f in FILES if os.path.exists(os.path.join(outdir, f))],
            "sampler_samples": samples}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="checkout whose package is run as P")
    ap.add_argument("--modes", nargs="+", default=["sequential", "concurrent"],
                    choices=["sequential", "concurrent"])
    ap.add_argument("--order", default="PCTTCP")
    ap.add_argument("--one", nargs=3, metavar=("REPO", "MODE", "OUTDIR"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(*args.one)), flush=True)
        return 0
    if set(args.order) - set("PCT"):
        ap.error("--order takes the letters P, C and T")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    parent = os.path.abspath(args.parent)
    first_rows, ok = None, True
    for mode in args.modes:
        walls: dict[str, list[float]] = {v: [] for v in "PCT"}
        for i, v in enumerate(args.order):
            env = dict(os.environ)
            env.pop("ATE_TPU_TRACE", None)
            if v == "T":
                env["ATE_TPU_TRACE"] = "0"
            outdir = os.path.join(OUT, f"{mode}-{i}-{v}")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--parent", parent,
                 "--one", parent if v == "P" else REPO, mode, outdir],
                env=env, capture_output=True, text=True)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"run {mode} {i} {v} failed with {proc.returncode}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            rows = res["rows"]
            first_rows = rows if first_rows is None else first_rows
            differ = sorted(m for m in rows if rows[m] != first_rows.get(m))
            res.update(mode=mode, run=i, variant=v, rows_equal=not differ, rows_differ=differ)
            ok &= not differ
            walls[v].append(res["wall_s"])
            print(json.dumps(res), flush=True)
        mean = {v: sum(w) / len(w) for v, w in walls.items() if w}
        print(json.dumps({"mode": mode, "walls_s": walls, "mean_s": mean,
                          "C_minus_T_s": mean["C"] - mean["T"] if {"C", "T"} <= mean.keys()
                          else None,
                          "T_minus_P_s": mean["T"] - mean["P"] if {"P", "T"} <= mean.keys()
                          else None}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
