#!/usr/bin/env python
"""Demo / load-gen client for the PyTorch port's CATE serving daemon (no jax).

Usage::

    python -m ate_replication_causalml_torch.serving --checkpoint f.npz --port 7777 &
    python scripts/torch_serve_client.py --port 7777 -n 200 --rows 1,8,32
    python scripts/torch_serve_client.py --port 7777 --x queries.npy

Sends ``n`` predict requests (random standard-normal query rows unless
``--x`` supplies a saved matrix, which is chunked to the declared row
sizes), retries typed rejects under stable ids, and prints latency
percentiles plus the daemon's own ``stats`` (including the zero-compile
window term) — the one-command smoke an operator runs against a live
daemon. The flags and the printed lines are those of the JAX package's
``scripts/serve_client.py``; neither this script nor the daemon imports
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("-n", type=int, default=100, help="requests to send")
    ap.add_argument("--rows", default="1,8,32",
                    help="cycle of per-request row counts")
    ap.add_argument("--features", type=int, default=None,
                    help="feature count for random queries (default: probe "
                         "a 1-row request and read the error hint is not "
                         "possible; required without --x unless the model "
                         "takes 21 features)")
    ap.add_argument("--x", default=None,
                    help=".npy matrix to serve instead of random queries")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ate_replication_causalml_torch.serving.client import CateClient

    rng = np.random.default_rng(args.seed)
    row_cycle = [int(r) for r in args.rows.split(",") if r.strip()]
    if args.x is not None:
        full = np.load(args.x).astype(np.float32)
    else:
        p = args.features if args.features is not None else 21
        full = rng.normal(size=(sum(row_cycle) * args.n, p)).astype(np.float32)

    lat: list[float] = []
    served = 0
    with CateClient.connect(args.host, args.port) as client:
        print(f"# ping: {client.ping()}", file=sys.stderr)
        off = 0
        for i in range(args.n):
            rows = row_cycle[i % len(row_cycle)]
            if off + rows > full.shape[0]:
                off = 0
            x = full[off:off + rows]
            off += rows
            t0 = time.perf_counter()
            cate, var = client.predict(x, request_id=f"demo{i}")
            lat.append(time.perf_counter() - t0)
            served += rows
            assert cate.shape == (rows,) and var.shape == (rows,)
        stats = client.stats()

    lat_ms = np.sort(np.asarray(lat)) * 1e3
    pct = lambda q: float(lat_ms[min(len(lat_ms) - 1, int(q * len(lat_ms)))])
    print(
        f"# {args.n} requests, {served} rows: "
        f"p50={pct(0.50):.2f}ms p95={pct(0.95):.2f}ms p99={pct(0.99):.2f}ms"
    )
    print(f"# daemon stats: {stats}")
    ok = stats.get("compile_events_in_window", 0) == 0
    print(f"# zero-compile window: {'OK' if ok else 'VIOLATED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
