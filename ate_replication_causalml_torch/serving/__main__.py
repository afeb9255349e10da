"""Start the CATE serving daemon on the card.

The counterpart of the JAX package's ``scripts/serve.py``, with its
flags::

    python -m ate_replication_causalml_torch.serving --checkpoint forest.npz --port 7777
    python -m ate_replication_causalml_torch.serving --checkpoint forest.npz --stdio

Loads the SHA-256-verified forest checkpoint (written by either
package's ``save_fitted``) onto the card, builds the kernels and
captures one CUDA graph per declared batch bucket (and, for a fitted
checkpoint, builds its training panel's leaf index), then serves
``predict`` / ``ping`` / ``stats`` / ``rotate`` / ``retire`` / ``dump``
/ ``drain`` / ``shutdown`` over the length-prefixed protocol: TCP
(``--port``, 0 = ephemeral, the bound port printed to stderr) or
stdin/stdout (``--stdio``; logs go to stderr). ``--admin-port`` starts
the read-only HTTP endpoint (``/metrics`` ``/healthz`` ``/readyz``
``/varz``). Knobs default from the ``ATE_TPU_SERVE_*`` and
``ATE_TPU_STAT_*`` variables; flags override. ``--device cpu`` serves
with the plain versions.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="save_fitted() .npz holding a (Fitted)CausalForest")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stdio", action="store_true", help="serve one peer over stdin/stdout")
    mode.add_argument("--port", type=int, default=None,
                      help="TCP port (0 = ephemeral; default without --stdio)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated batch buckets (default $ATE_TPU_SERVE_BUCKETS "
                         "or 1,8,64,256)")
    ap.add_argument("--window-ms", type=float, default=None, help="coalescing deadline window")
    ap.add_argument("--depth", type=int, default=None, help="admission queue depth")
    ap.add_argument("--row-backend", default=None, choices=("pallas", "matmul"),
                    help="predict rows (default, 'pallas' and 'matmul': the CUDA kernels)")
    ap.add_argument("--admin-port", type=int, default=None,
                    help="read-only admin HTTP port (/metrics /healthz /readyz /varz; "
                         "0 = ephemeral; default $ATE_TPU_SERVE_ADMIN_PORT or off)")
    ap.add_argument("--stat-window", type=float, default=None,
                    help="statistical-health drift window in seconds (default "
                         "$ATE_TPU_STAT_WINDOW or 5)")
    ap.add_argument("--stat-drift-burn", type=float, default=None,
                    help="objective of the stat_drift / stat_calibration SLOs (default "
                         "$ATE_TPU_STAT_DRIFT_BURN or 0.9)")
    ap.add_argument("--stat-calibration", default=None,
                    help="calibration feed as pcol:tcol feature columns (default "
                         "$ATE_TPU_STAT_CALIBRATION or off)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency-SLO threshold in ms (default $ATE_TPU_SERVE_SLO_MS or 250)")
    ap.add_argument("--fleet", default=None,
                    help="extra served models as id=path,id2=path2 (default "
                         "$ATE_TPU_SERVE_FLEET; --checkpoint serves as model 'default'; "
                         "same-shape models share one set of CUDA graphs)")
    ap.add_argument("--shed-burn", type=float, default=None,
                    help="per-model SLO-burn shedding threshold (default "
                         "$ATE_TPU_SERVE_FLEET_SHED_BURN or off)")
    ap.add_argument("--fuse", action="store_true", default=None,
                    help="fuse adjacent buckets into one masked predict a group (default "
                         "$ATE_TPU_SERVE_FUSE or off)")
    ap.add_argument("--drain-s", type=float, default=None,
                    help="graceful-drain bound after SIGTERM or a `drain` op (default "
                         "$ATE_TPU_SERVE_DRAIN_S or 30)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ate_replication_causalml_torch.serving.coalescer import BucketPlan
    from ate_replication_causalml_torch.serving.daemon import (
        CateServer,
        ServeConfig,
        _parse_calibration_cols,
        serve_socket,
        serve_stdio,
    )
    from ate_replication_causalml_torch.serving.fleet import parse_fleet_spec

    overrides: dict = {}
    if args.buckets is not None:
        overrides["buckets"] = BucketPlan.parse(args.buckets)
    if args.window_ms is not None:
        overrides["window_s"] = args.window_ms / 1e3
    if args.depth is not None:
        overrides["max_depth"] = args.depth
    if args.row_backend is not None:
        overrides["row_backend"] = args.row_backend
    if args.admin_port is not None:
        overrides["admin_port"] = args.admin_port
    if args.stat_window is not None:
        overrides["stat_window_s"] = args.stat_window
    if args.stat_drift_burn is not None:
        overrides["stat_drift_objective"] = args.stat_drift_burn
    if args.stat_calibration is not None:
        overrides["stat_calibration_cols"] = _parse_calibration_cols(args.stat_calibration)
    if args.slo_ms is not None:
        overrides["slo_latency_s"] = args.slo_ms / 1e3
    if args.fleet is not None:
        overrides["fleet"] = parse_fleet_spec(args.fleet)
    if args.shed_burn is not None:
        overrides["shed_burn_threshold"] = args.shed_burn
    if args.fuse:
        overrides["fuse_buckets"] = True
    if args.drain_s is not None:
        overrides["drain_timeout_s"] = args.drain_s
    if args.device is not None:
        overrides["device"] = args.device
    config = ServeConfig.from_env(args.checkpoint, **overrides)

    server = CateServer(config)
    phases = server.startup()

    def _sigterm(signum, frame):
        # SIGTERM is a graceful drain. The handler interrupts the main
        # thread, which may hold the lifecycle's lock; drain on a helper.
        def _do_drain():
            outcome = server.drain()
            os._exit(0 if outcome == "drained" else 78)

        threading.Thread(target=_do_drain, name="sigterm-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    print("# startup: " + " ".join(f"{k}={v:.2f}s" for k, v in phases.items())
          + f" buckets={list(config.buckets.sizes)} models={list(config.model_ids)}",
          file=sys.stderr, flush=True)
    admin_port = server.stats().get("admin_port")
    if admin_port is not None:
        print(f"# admin endpoint on 127.0.0.1:{admin_port} (/metrics /healthz /readyz /varz)",
              file=sys.stderr, flush=True)
    if args.stdio:
        serve_stdio(server)
    else:
        serve_socket(server, args.host, 0 if args.port is None else args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
