"""How much host work the concurrent sweep's threads can overlap on the card.

    python3 scripts/torch_thread_dispatch.py [--ops 20000] [--threads 1 2 4]
    python3 scripts/torch_thread_dispatch.py --sweep-workers 1 2 4

The rows of the sweep are host-bound: their threads spend their time
issuing small PyTorch ops and ctypes kernel calls. This script measures
what T threads get done together, each on its own CUDA stream, for three
loops of ``--ops`` iterations a thread:

* ``torch_op``: ``y = x + 1`` on a one-element CUDA tensor (PyTorch's
  dispatch and one kernel launch);
* ``ctypes_kernel``: ``ops/pack.py::pack_codes`` on a (1, 3) int32 CUDA
  tensor (argument checks in Python, one ctypes call launching the
  ``pack_words`` kernel);
* ``python``: a pure-Python loop body of the same order of cost
  (``sum(range(40))``), a control that holds the GIL throughout.

For each loop and T it prints the wall, the total iterations a second
and the µs an iteration per thread; T threads that overlapped perfectly
would keep the µs an iteration of one thread. With ``--sweep-workers``
it also runs ``run_sweep(SweepConfig())`` (``ATE_TPU_PREDICT_PACK=1``,
as ``chip_smoke.py`` runs it) at each worker count into
``build/thread_dispatch_sweep/`` and prints its wall and each row's
seconds. Prints one JSON object a line, the card's name and power limit
first. It needs a card (there is no CPU mode) and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ate_replication_causalml_torch import pipeline  # noqa: E402
from ate_replication_causalml_torch.ops import pack  # noqa: E402


def loops(dev: torch.device) -> dict:
    x = torch.zeros(1, device=dev)
    codes = torch.zeros((1, 3), dtype=torch.int32, device=dev)

    def torch_op(n):
        for _ in range(n):
            x + 1

    def ctypes_kernel(n):
        for _ in range(n):
            pack.pack_codes(codes)

    def python(n):
        for _ in range(n):
            sum(range(40))

    return {"torch_op": torch_op, "ctypes_kernel": ctypes_kernel, "python": python}


def run_threads(body, n_threads: int, ops: int, dev: torch.device) -> float:
    """Wall seconds of ``n_threads`` threads, each on its own stream,
    each running ``body(ops)`` once, started together."""
    start = threading.Barrier(n_threads + 1)

    def work():
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            start.wait()
            body(ops)
            stream.synchronize()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return time.perf_counter() - t0


def sweep(workers: int) -> dict:
    out = os.path.join(REPO, "build", "thread_dispatch_sweep")
    shutil.rmtree(out, ignore_errors=True)
    os.environ[pack.ENV_PACK] = "1"
    t0 = time.perf_counter()
    rep = pipeline.run_sweep(pipeline.SweepConfig(), outdir=out, plots=False, log=lambda s: None,
                             workers=workers)
    wall = time.perf_counter() - t0
    return {"workers": workers, "wall_s": wall, "computed": rep.computed,
            "seconds": rep.timings_s,
            "rows": {r.method: [r.ate, r.se] for r in [rep.oracle, *rep.results]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ops", type=int, default=20_000)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--sweep-workers", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_thread_dispatch: needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "cpus": os.cpu_count(), "switch_interval_s": sys.getswitchinterval()}),
          flush=True)
    for name, body in loops(dev).items():
        run_threads(body, 1, min(args.ops, 2_000), dev)   # warm up (and build the kernels)
        for n in args.threads:
            wall = run_threads(body, n, args.ops, dev)
            print(json.dumps({"loop": name, "threads": n, "ops_per_thread": args.ops,
                              "wall_s": wall, "iterations_per_s": n * args.ops / wall,
                              "us_per_iteration_per_thread": 1e6 * wall / args.ops}), flush=True)
    for w in args.sweep_workers:
        print(json.dumps({"sweep": sweep(w)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
