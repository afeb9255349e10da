#!/usr/bin/env python
"""Deterministic load replay against the PyTorch port's CATE serving daemon.

Usage::

    # against a live TCP daemon
    # (python -m ate_replication_causalml_torch.serving --checkpoint f.npz --port 7777)
    python scripts/torch_loadgen.py --connect 127.0.0.1:7777 --features 6 \
        --requests 200 --rate 500 --seed 7

    # spawn a stdio daemon (on the card, or --device cpu), replay, shut it down
    python scripts/torch_loadgen.py --spawn --checkpoint forest.npz \
        --features 6 --requests 120 --seed 7 --buckets 1,8,32 [--device cpu]

Builds a seeded open-loop schedule (Poisson arrivals at ``--rate``,
weighted bucket mix ``--mix``, ids ``{prefix}{i}`` — the same ids a
``serve:`` chaos spec selects on, so chaos replays are coordinated),
replays it through one or more client connections, then prints ONE
JSON record: offered vs achieved rate, client-side p50/p90/p99, and —
fetched from the daemon's ``stats`` op — the server-side per-phase
latency decomposition, close-reason counts and pad fraction. The same
schedule and replay core (``ate_replication_causalml_torch.serving.loadgen``)
backs ``chip_smoke.py``'s serving phases. It takes the flags of the JAX
package's ``scripts/loadgen.py`` (and ``--device`` for the spawned
daemon) and prints a record with the same keys. Neither this script nor
the daemon imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ate_replication_causalml_torch.serving import loadgen  # noqa: E402
from ate_replication_causalml_torch.serving.client import CateClient  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    target = ap.add_mutually_exclusive_group(required=True)
    target.add_argument("--connect", metavar="HOST:PORT",
                        help="replay against a live TCP daemon")
    target.add_argument("--spawn", action="store_true",
                        help="spawn a stdio daemon (needs --checkpoint), "
                             "replay, shut it down")
    ap.add_argument("--checkpoint", default=None,
                    help="forest checkpoint for --spawn")
    ap.add_argument("--features", type=int, required=True,
                    help="query feature count p (must match the model)")
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=loadgen.DEFAULT_RATE_HZ,
                    help="offered arrival rate, Hz (open loop)")
    ap.add_argument("--mix", default=loadgen.DEFAULT_MIX,
                    help="rows:weight bucket mix, e.g. 1:4,8:2,32:1")
    ap.add_argument("--id-prefix", default="r",
                    help="request-id prefix (chaos specs select on ids)")
    ap.add_argument("--models", default=None,
                    help="comma-separated fleet model ids to spread the "
                         "stream across (deterministic per-request "
                         "assignment; default: the daemon's default model)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request end-to-end deadline: stamped into "
                         "every predict header (the server rejects "
                         "expired requests typed, pre-dispatch), used "
                         "as the client's retry-backoff cap; expiries "
                         "are counted, not errors")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="TCP connections for --connect (stdio is one pipe)")
    ap.add_argument("--buckets", default=None,
                    help="--spawn daemon bucket plan override")
    ap.add_argument("--window-ms", type=float, default=None,
                    help="--spawn daemon coalescing window override")
    ap.add_argument("--device", default=None,
                    help="--spawn daemon device: cuda (default) or cpu")
    ap.add_argument("--dump-dir", default=None,
                    help="ask the daemon to dump its observability "
                         "artifacts here after the replay")
    ap.add_argument("--shift-at", type=int, default=None,
                    help="stage a deterministic mid-stream distribution "
                         "shift at this request index: "
                         "requests before the index stay byte-identical "
                         "to the unshifted build of the same seed, so a "
                         "shifted/unshifted pair isolates the drift "
                         "detector's flip")
    ap.add_argument("--shift-kind", default="covariate",
                    choices=loadgen.SHIFT_KINDS,
                    help="covariate: +delta on feature col 0 from "
                         "--shift-at on; checkpoint: rebind the tail of "
                         "the stream to --shift-model")
    ap.add_argument("--shift-model", default=None,
                    help="target model id for --shift-kind checkpoint")
    ap.add_argument("--shift-delta", type=float, default=2.5,
                    help="covariate shift magnitude (feature col 0)")
    args = ap.parse_args(argv)

    models = (
        tuple(m.strip() for m in args.models.split(",") if m.strip())
        if args.models else None
    )
    schedule = loadgen.build_schedule(
        args.seed, args.requests, rate_hz=args.rate, mix=args.mix,
        id_prefix=args.id_prefix, models=models,
    )
    queries = loadgen.build_queries(args.seed, schedule, args.features)
    if args.shift_at is not None:
        schedule, queries = loadgen.apply_shift(
            schedule, queries, shift_at=args.shift_at,
            shift_kind=args.shift_kind, shift_model=args.shift_model,
            shift_delta=args.shift_delta,
        )

    if args.spawn:
        if not args.checkpoint:
            ap.error("--spawn needs --checkpoint")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cmd = [sys.executable, "-m", "ate_replication_causalml_torch.serving",
               "--checkpoint", args.checkpoint, "--stdio"]
        if args.buckets:
            cmd += ["--buckets", args.buckets]
        if args.window_ms is not None:
            cmd += ["--window-ms", str(args.window_ms)]
        if args.device is not None:
            cmd += ["--device", args.device]
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=repo if not path else repo + os.pathsep + path)
        client = CateClient.spawn_stdio(cmd, env=env)
        try:
            record = loadgen.run_wire(
                lambda: client, schedule, queries, concurrency=1,
                close_clients=False, deadline_ms=args.deadline_ms,
            )
            record["transport"] = "stdio"
            _attach_server_stats(client, record, args.dump_dir)
            client.shutdown()
        finally:
            client.close()
    else:
        host, _, port_s = args.connect.rpartition(":")
        if not host or not port_s.isdigit():
            ap.error(f"--connect wants HOST:PORT, got {args.connect!r}")

        def factory() -> CateClient:
            return CateClient.connect(host, int(port_s))

        record = loadgen.run_wire(
            factory, schedule, queries, concurrency=args.concurrency,
            deadline_ms=args.deadline_ms,
        )
        record["transport"] = "tcp"
        stats_client = factory()
        try:
            _attach_server_stats(stats_client, record, args.dump_dir)
        finally:
            stats_client.close()

    record["seed"] = args.seed
    record["mix"] = args.mix
    if args.shift_at is not None:
        record["shift"] = {"at": args.shift_at, "kind": args.shift_kind,
                           "delta": args.shift_delta}
    print(json.dumps(record))
    return 0


def _attach_server_stats(client: CateClient, record: dict,
                         dump_dir: str | None) -> None:
    """Fold the daemon's phase decomposition into the client record —
    the full queue/coalesce/dispatch/device/reply split only the server
    can see — and optionally trigger a live artifact dump."""
    stats = client.stats()
    record["server"] = {
        "phases": stats.get("phases", {}),
        "close_reasons": stats.get("close_reasons", {}),
        "pad_fraction_mean": stats.get("pad_fraction_mean", 0.0),
        "compile_events_in_window": stats.get("compile_events_in_window"),
        # The deadline-reject split: where — admission /
        # queue / dispatch — expired budgets died on the server side.
        "deadline_exceeded": stats.get("deadline_exceeded", {}),
        "heartbeats": stats.get("heartbeats", {}),
        "slo": stats.get("slo", {}),
        "stat_health": stats.get("stat_health", {}),
        "fleet": stats.get("fleet", {}),
        "shed_burns": stats.get("shed_burns", {}),
    }
    if dump_dir:
        record["dumped"] = client.dump(dump_dir)


if __name__ == "__main__":
    sys.exit(main())
