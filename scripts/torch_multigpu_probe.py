"""Probe the port's multi-GPU layer on the card: which collectives gloo
takes on CUDA tensors, and the dry run on a one-rank NCCL world and on
two gloo ranks sharing the card, each timed.

    python3 scripts/torch_multigpu_probe.py [--out chiprun_out/multigpu_probe.json]

``--device cpu`` runs the same on two gloo ranks on the CPU (no card).
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402


def _gloo_probe() -> dict:
    """Each collective called directly (no staging) on a tensor of this
    rank's device under gloo: "ok", or the error's first line."""
    import torch.distributed as dist

    from ate_replication_causalml_torch.parallel.multihost import rank_device

    dev = rank_device()
    world = dist.get_world_size()
    t = torch.arange(4, dtype=torch.float32, device=dev) + dist.get_rank()
    calls = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, device=dev), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(world * 4, device=dev)),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(world * 4, device=dev), torch.ones(world * 4, device=dev)),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe records what gloo refuses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        dist.barrier()  # re-align the ranks after a refusal
    return out


def main() -> int:
    from ate_replication_causalml_torch.observability import atomic_write_json
    from ate_replication_causalml_torch.parallel.dryrun import dryrun_multigpu
    from ate_replication_causalml_torch.parallel.multihost import _rank_device_for
    from ate_replication_causalml_torch.parallel.spawn import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "multigpu_probe.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rec: dict = {"torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version}
    if args.device == "cuda":
        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        try:
            _rank_device_for("cuda", 1, 2, None)
            rec["shared_card_without_gloo"] = "accepted"
        except ValueError as e:
            rec["shared_card_without_gloo"] = f"ValueError: {e}"
    t0 = time.perf_counter()
    rec["gloo_collectives"] = run_ranks(_gloo_probe, 2, backend="gloo", device=args.device,
                                        timeout=120)[0]
    rec["gloo_probe_s"] = time.perf_counter() - t0
    runs = [(2, "gloo")] if args.device == "cpu" else [(1, "nccl"), (2, "gloo")]
    for ranks, backend in runs:
        t0 = time.perf_counter()
        summary = dryrun_multigpu(ranks, backend, args.device, timeout=300)[0]
        rec[f"dryrun_{ranks}_{backend}"] = {"wall_s": time.perf_counter() - t0, **summary}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    atomic_write_json(args.out, rec)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
