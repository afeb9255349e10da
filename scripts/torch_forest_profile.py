"""Where the forests' time goes on the card (torch port).

    python3 scripts/torch_forest_profile.py [--trees 256] [--depth 9]
    python3 scripts/torch_forest_profile.py --causal [--cf-trees 256] [--nuisance-trees 64]
    python3 scripts/torch_forest_profile.py --causal --repo DIR

Builds the notebook's biased frame (11,016 x 21) on the CUDA card, then
profiles the DR-RF row's classifier forest (``--trees`` trees of depth
``--depth``, the row's key) and, with ``--causal``, the "Causal
Forest(GRF)" row's grow stage as well (``--cf-trees`` trees of depth 8 on
the residuals of two ``--nuisance-trees``-tree regression forests, the
sweep's key split as ``fit_causal_forest`` splits it). Each stage runs
once to warm up and once timed without the profiler (every stage before
any profiling), then once under ``torch.profiler``, then once more
timed without it (``wall_after_profiler_s``: whether a process that has
run the profiler runs slower afterwards). Per stage: wall
time (unprofiled, profiled, after the profiler), summed device time,
the device idle share of each wall (the profiler slows the host, so the
share of the profiled wall overstates idleness; the share of the
unprofiled wall assumes the device time is the same without the
profiler), the port's kernels' share of the device time, the number of
device activities (kernels, copies, fills) and that number per grow
level (a level of one chunk: chunks x depth), and the top device
activities by summed time. ``--repo DIR`` profiles the package of
another checkout (for example the parent commit, unpacked with ``git
archive``) with this script. Prints one JSON object. It needs a card
(there is no CPU mode) and imports no JAX. A development tool:
``chip_smoke.py`` does not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import torch
from torch.profiler import ProfilerActivity, profile



def _package_root() -> str:
    """The checkout to import the package from: ``--repo`` or this one."""
    if "--repo" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--repo") + 1])
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


sys.path.insert(0, _package_root())

from ate_replication_causalml_torch.data.pipeline import PrepConfig, inject_bias, prepare_dataset  # noqa: E402
from ate_replication_causalml_torch.data.synthetic import make_ggl_like  # noqa: E402
from ate_replication_causalml_torch.models import causal_forest as cf  # noqa: E402
from ate_replication_causalml_torch.models import forest as fo  # noqa: E402
from ate_replication_causalml_torch.ops import random as rnd  # noqa: E402

# The port's device functions (csrc/), by substring of the trace's names.
OUR_KERNELS = ("hist_dense", "partition_", "hist_reduce", "pack_words", "route_kernel",
               "lookup_kernel", "route_advance_kernel", "traverse_kernel", "leaf_record_kernel")


def wall(fit) -> float:
    """Seconds of one ``fit``, the device synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_stage(fit, wall_unprofiled: float, levels: int) -> dict:
    """A profiled run of ``fit`` (``levels`` grow levels), then an
    unprofiled one."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = wall(fit)
    dev: dict[str, float] = {}  # device activity name -> summed microseconds
    n_device = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_device += 1
    total_us = sum(dev.values())
    ours_us = sum(v for k, v in dev.items() if any(o in k for o in OUR_KERNELS))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:15]
    return {
        "wall_unprofiled_s": wall_unprofiled, "wall_s": wall_s,
        "wall_after_profiler_s": wall(fit), "device_busy_s": total_us / 1e6,
        # Busy over the profiled wall; not clipped, so a busy time that
        # double-counts overlapping activities shows as a negative share.
        "device_idle_share": 1.0 - total_us / 1e6 / wall_s,
        "device_idle_share_unprofiled_wall": 1.0 - total_us / 1e6 / wall_unprofiled,
        "port_kernels_share_of_device": ours_us / total_us if total_us else None,
        "device_activities": len(dev),
        "device_kernels": n_device, "levels": levels,
        "device_kernels_per_level": n_device / levels,
        "top_device_us": [[k[:90], v] for k, v in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=int, default=256)
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--causal", action="store_true",
                    help="profile the causal row's grow stage as well")
    ap.add_argument("--cf-trees", type=int, default=256)
    ap.add_argument("--nuisance-trees", type=int, default=64)
    ap.add_argument("--repo", default=None,
                    help="profile the package of this checkout (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_forest_profile: needs a CUDA card")
    frame = prepare_dataset(make_ggl_like(120_000, seed=0), PrepConfig(), device="cuda")
    frame_mod, _ = inject_bias(frame, PrepConfig())
    x, w, y = frame_mod.x, frame_mod.w, frame_mod.y
    key = rnd.key(12325, device="cuda")
    chunks = -(-args.trees // fo.DEFAULT_TREE_CHUNK)
    stages = {"classifier_forest": (
        {"trees": args.trees, "depth": args.depth}, chunks * args.depth,
        lambda: fo.fit_forest_classifier(x, w, key, n_trees=args.trees, depth=args.depth))}
    if args.causal:
        sweep = rnd.fold_in(rnd.key(0, device="cuda"), zlib.crc32(b"causal_forest"))
        ky, kw, kc = rnd.split(sweep, 3).unbind(dim=0)
        nuisance = dict(n_trees=args.nuisance_trees, depth=args.depth)
        y_hat = fo.forest_oob_mean(fo.fit_forest_regressor(x, y, ky, **nuisance), x)
        w_hat = fo.forest_oob_mean(fo.fit_forest_regressor(x, w, kw, **nuisance), x)
        groups = -(-args.cf_trees // 2)
        stages["causal_grow"] = (
            {"trees": args.cf_trees, "depth": 8, "nuisance_trees": args.nuisance_trees},
            -(-groups // cf.DEFAULT_GROUP_CHUNK) * 8,
            lambda: cf.grow_causal_forest(x, w - w_hat, y - y_hat, kc, n_trees=args.cf_trees,
                                          depth=8))
    for _, _, fit in stages.values():
        fit()  # builds the kernels, warms the allocator
    walls = {name: wall(fit) for name, (_, _, fit) in stages.items()}
    out = {"script": "scripts/torch_forest_profile.py", "device": torch.cuda.get_device_name(0),
           "repo": _package_root(), "rows": frame_mod.n,
           "stages": {name: {**shape, **profile_stage(fit, walls[name], levels)}
                      for name, (shape, levels, fit) in stages.items()}}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
