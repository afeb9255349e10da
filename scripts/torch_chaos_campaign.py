#!/usr/bin/env python
"""The port's chaos campaign CLI (``ate_replication_causalml_torch``).

Usage::

    # a seeded campaign: composed multi-scope fault episodes over the
    # four workloads, judged by the invariant registry
    python scripts/torch_chaos_campaign.py --out results/campaign \
        --seed 7 --episodes 4 --scale micro [--device cpu]

    # restrict the workload mix (fleet is opt-in)
    python scripts/torch_chaos_campaign.py --out results/campaign \
        --workloads sweep,matrix,serving --device cpu

    # re-run a shrinker-emitted one-line repro (exits 1 when the violation
    # fails again: that exit is the repro's contract)
    ATE_TPU_CHAOS='tamper:journal,times=1' \
        python scripts/torch_chaos_campaign.py --repro --workload matrix \
        --seed 17 --scale micro --device cpu

Writes ``campaign_report.json`` (byte-identical for one root seed;
``scripts/check_metrics_schema.py::validate_campaign_report`` checks it)
and the episodes' run directories into ``--out``. Exit status: 0 when
every invariant is green, 1 on a violation (campaign mode) or when the
repro fails again (``--repro``), 2 on a malformed invocation. The
workloads run on ``--device`` (``cuda`` unless told otherwise).

Env: ``ATE_TPU_CAMPAIGN_SEED`` (default of ``--seed``),
``ATE_TPU_CAMPAIGN_EPISODES``, and the budget knobs
``ATE_TPU_CAMPAIGN_REPS`` / ``ATE_TPU_CAMPAIGN_REQUESTS``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ate_replication_causalml_torch.resilience import campaign  # noqa: E402
from ate_replication_causalml_torch.resilience import chaos  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Composed chaos campaigns over the port's workloads")
    ap.add_argument("--out", default=None,
                    help="output dir (campaign_report.json and the episodes' run dirs); "
                    "required for a campaign, a fresh temporary dir under --repro so the "
                    "shrinker's one-line repro runs verbatim")
    ap.add_argument("--seed", type=int, default=None,
                    help=f"root seed (default ${campaign.ENV_SEED} or 0)")
    ap.add_argument("--episodes", type=int, default=None,
                    help=f"episode count (default ${campaign.ENV_EPISODES} or 4)")
    ap.add_argument("--workloads", default=None,
                    help=f"comma list from {','.join(campaign.WORKLOADS)}")
    ap.add_argument("--scale", default="micro", choices=sorted(campaign.SCALES))
    ap.add_argument("--no-shrink", action="store_true",
                    help="report violations without delta-debugging them to a repro")
    ap.add_argument("--repro", action="store_true",
                    help="one episode: run --workload --seed under $ATE_TPU_CHAOS (or "
                    "--chaos) against a fault-free reference; exit 1 if an invariant fails")
    ap.add_argument("--workload", default=None, help="(--repro) the workload to replay")
    ap.add_argument("--chaos", default=None, help="(--repro) chaos spec; default $ATE_TPU_CHAOS")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.repro:
        if not args.workload or args.seed is None:
            ap.error("--repro needs --workload and --seed")
        spec = args.chaos if args.chaos is not None else os.environ.get(chaos.ENV_VAR, "").strip()
        if not spec:
            ap.error("--repro needs --chaos or $ATE_TPU_CHAOS")
        out = args.out
        if out is None:
            import tempfile

            out = tempfile.mkdtemp(prefix="chaos_repro_")
            print(f"# repro artifacts: {out}")
        verdicts = campaign.run_repro(args.workload, args.seed, spec, out, args.scale,
                                      device=args.device)
        for v in verdicts:
            print(f"  {v.invariant:<26} {v.verdict:<5} {v.detail}")
        failed = sorted(v.invariant for v in verdicts if v.verdict == "fail")
        if failed:
            print(f"REPRO RE-FAILS: {failed}")
            return 1
        print("repro did not fail (all invariants green)")
        return 0

    if args.out is None:
        ap.error("campaign mode needs --out")
    workloads = None
    if args.workloads:
        workloads = tuple(w.strip() for w in args.workloads.split(",") if w.strip())
    report = campaign.run_campaign(args.out, root_seed=args.seed, n_episodes=args.episodes,
                                   workloads=workloads, scale=args.scale,
                                   shrink=not args.no_shrink, device=args.device)
    print(report["headline"])
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
