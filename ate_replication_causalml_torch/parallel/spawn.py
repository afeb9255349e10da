"""Launch a function on N ranks of a fresh world, from one process.

``torchrun --nproc-per-node=N`` is how a user starts the port on N
cards; :func:`run_ranks` is the in-process counterpart the tests, the
dry run and ``chip_smoke.py`` use. It spawns the ranks with
``torch.multiprocessing`` (start method ``spawn``, so no child inherits
the parent's CUDA context), each rank joins the world with explicit
arguments on ``127.0.0.1`` (:func:`~.multihost.join_world`), runs
``fn(*args)`` and pickles its return value into a scratch directory;
the parent joins the ranks under a deadline, kills them all when it
passes, and returns the values in rank order. A rank that raised makes
the call raise with that rank's traceback. For CUDA ranks the parent
builds the kernels first and the ranks only load them
(``kernels/build.py``'s ``ATE_TPU_KERNELS_PREBUILT``), so ranks never
race on the build directory.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback
from typing import Callable

import torch

from ate_replication_causalml_torch.parallel.multihost import DEFAULT_TIMEOUT_S

#: Seconds the other ranks get to end after one rank failed.
_FAIL_GRACE_S = 5.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, backend: str | None, device: str,
                fn: Callable, args: tuple, out_dir: str, timeout: float) -> None:
    from ate_replication_causalml_torch.kernels import build
    from ate_replication_causalml_torch.parallel.multihost import join_world, leave_world

    if torch.device(device).type == "cuda":
        os.environ[build.PREBUILT_ENV] = "1"   # load the parent's build, never build
    else:
        # The ranks share the host's cores: each takes its share for its
        # intra-op threads instead of all of them.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        join_world(f"127.0.0.1:{port}", world, rank, backend=backend, device=device,
                   timeout=timeout)
        value = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(value, f)
        os.replace(os.path.join(out_dir, f"rank{rank}.pkl.tmp"),
                   os.path.join(out_dir, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        leave_world()


def run_ranks(fn: Callable, world_size: int, *, backend: str | None = "gloo",
              device: str = "cpu", args: tuple = (), timeout: float = DEFAULT_TIMEOUT_S,
              join_timeout: float | None = None, scratch: str | None = None) -> list:
    """``fn(*args)`` on ``world_size`` fresh ranks; their return values in
    rank order. ``fn`` must be importable by name (a module-level
    function) and its value picklable. ``timeout`` bounds each
    collective inside the world; ``join_timeout`` (default ``2 ×
    timeout``) bounds the whole call, after which every rank is killed
    and ``TimeoutError`` raised. ``scratch`` is the directory for the
    ranks' result files (a temporary one when None)."""
    import torch.multiprocessing as mp

    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if torch.device(device).type == "cuda":
        # Build every kernel here, once; the ranks only load them.
        from ate_replication_causalml_torch.kernels import build

        build.build_all()
    out_dir = tempfile.mkdtemp(prefix="ranks-", dir=scratch)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(r, world_size, port, backend, device, fn, tuple(args), out_dir,
                               float(timeout)))
             for r in range(world_size)]
    deadline = time.monotonic() + (2.0 * timeout if join_timeout is None else join_timeout)
    try:
        for p in procs:
            p.start()
        failed_at = None
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = time.monotonic()
            # A failed rank leaves the others waiting on a collective:
            # give them a moment to fail on their own, then stop them.
            if failed_at is not None and time.monotonic() - failed_at > _FAIL_GRACE_S:
                break
            time.sleep(0.05)
        alive = [p.name for p in procs if p.is_alive()]
        if alive and failed_at is None:
            raise TimeoutError(f"ranks {alive} did not finish before the deadline")
        errors = []
        for r in range(world_size):
            err = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif procs[r].exitcode != 0:
                errors.append(f"rank {r}: exit code {procs[r].exitcode}")
        if errors:
            raise RuntimeError("ranks failed:\n" + "\n".join(errors))
        values = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                values.append(pickle.load(f))
        return values
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
        shutil.rmtree(out_dir, ignore_errors=True)
