"""Where the DR-RF forest's time goes on the card (torch port).

    python3 scripts/torch_forest_profile.py [--trees 256] [--depth 9]

Builds the notebook's biased frame (11,016 x 21) on the CUDA card,
fits one warm-up forest, then fits ``--trees`` trees under
``torch.profiler`` and prints one JSON object: wall time (with and
without the profiler), summed device time, the device idle share of
each wall (the profiler slows the host, so the share of the profiled
wall overstates idleness; the share of the unprofiled wall assumes the
device time is the same without the profiler), the port's three
kernels' share, and the top device kernels by summed time. It needs a
card (there is no CPU mode) and imports no JAX. A development tool:
``chip_smoke.py`` does not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ate_replication_causalml_torch.data.pipeline import PrepConfig, inject_bias, prepare_dataset  # noqa: E402
from ate_replication_causalml_torch.data.synthetic import make_ggl_like  # noqa: E402
from ate_replication_causalml_torch.models import forest as fo  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402

OUR_KERNELS = ("hist_accumulate", "hist_reduce", "route_kernel", "lookup_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=256)
    ap.add_argument("--depth", type=int, default=9)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_forest_profile: needs a CUDA card")
    frame = prepare_dataset(make_ggl_like(120_000, seed=0), PrepConfig(), device="cuda")
    frame_mod, _ = inject_bias(frame, PrepConfig())
    key = rnd.key(12325, device="cuda")
    fit = lambda: fo.fit_forest_classifier(frame_mod.x, frame_mod.w, key,
                                           n_trees=args.trees, depth=args.depth)
    fit()  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    wall_unprofiled = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev: dict[str, float] = {}  # device activity name -> summed microseconds
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us()
    total_us = sum(dev.values())
    ours_us = sum(v for k, v in dev.items() if any(o in k for o in OUR_KERNELS))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "script": "scripts/torch_forest_profile.py", "device": torch.cuda.get_device_name(0),
        "rows": frame_mod.n, "trees": args.trees, "depth": args.depth,
        "wall_unprofiled_s": wall_unprofiled, "wall_s": wall, "device_busy_s": total_us / 1e6,
        # Busy over the profiled wall; not clipped, so a busy time that
        # double-counts overlapping activities shows as a negative share.
        "device_idle_share": 1.0 - total_us / 1e6 / wall,
        "device_idle_share_unprofiled_wall": 1.0 - total_us / 1e6 / wall_unprofiled,
        "port_kernels_share_of_device": ours_us / total_us if total_us else None,
        "device_activities": len(dev),
        "top_device_us": [[k[:90], v] for k, v in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
