"""Joining a ``torch.distributed`` world: one process (rank) per card.

Port of ``ate_replication_causalml_tpu/parallel/multihost.py``. The JAX
package's world is one controller over every device; the port's is one
process per card, each with its own host dispatcher (the forests are
host-launch-bound, and host threads driving several cards from one
process collapse PyTorch's dispatch), joined by ``torch.distributed``.

:func:`init_multihost` joins the world from explicit arguments or from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Rank r uses
``cuda:{LOCAL_RANK}``, and the backend is ``nccl``; on the CPU it is
``gloo``. Ranks that share one card (more local ranks than cards) must
ask for ``backend="gloo"`` explicitly, and the call raises otherwise:
NCCL refuses two ranks on one device. Nothing falls back to the CPU: a
CUDA rank without a card raises. The world's ``timeout`` bounds every
collective, so a rank that never arrives fails the others instead of
hanging them.

The framework's parallel axes place on a multi-host world as in the JAX
package: ``boot`` / ``tree`` / ``fold`` are pure fan-out (one gather per
estimator) and go across hosts; ``data`` carries ``all_reduce`` sums and
stays within a host. :func:`make_pod_mesh` encodes that layout.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings

import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.parallel.mesh import BOOT_AXIS, DATA_AXIS

#: The default bound on one collective (seconds).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class WorldInfo:
    rank: int
    size: int
    local_rank: int
    local_size: int
    backend: str
    device: torch.device


_WORLD: WorldInfo | None = None


def world_info() -> WorldInfo | None:
    """How this process joined the world (None: it did not)."""
    return _WORLD


def rank_device() -> torch.device:
    """This rank's device (the CUDA device it was bound to, or the CPU);
    ``cuda`` when no world was joined and a card is present."""
    if _WORLD is not None:
        return _WORLD.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _rank_device_for(device, local_rank: int, local_size: int, backend: str | None) -> tuple:
    """(device, backend) of a rank, with the sharing and no-card refusals."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only 'gloo' runs there")
        return dev, "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no distributed backend for device type {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                           "pass device='cpu' to join the world on the CPU")
    n_cards = torch.cuda.device_count()
    if local_size > n_cards and backend != "gloo":
        raise ValueError(f"{local_size} ranks share {n_cards} card(s) on this host: NCCL takes "
                         "one rank per card; pass backend='gloo' explicitly to share a card")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return torch.device("cuda", local_rank % n_cards), backend or "nccl"


def join_world(coordinator_address: str, num_processes: int, process_id: int, *,
               backend: str | None = None, device=None, local_rank: int | None = None,
               local_size: int | None = None, timeout: float = DEFAULT_TIMEOUT_S) -> WorldInfo:
    """Initialize the process group with explicit arguments, whatever the
    world size (a world of one forms a real one-rank group): bind this
    rank's device, record how it joined. ``coordinator_address`` is
    ``host:port`` of rank 0's store."""
    global _WORLD
    import torch.distributed as dist

    local_rank = process_id if local_rank is None else int(local_rank)
    local_size = num_processes if local_size is None else int(local_size)
    dev, backend = _rank_device_for(device, local_rank, local_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=float(timeout)))
    _WORLD = WorldInfo(rank=int(process_id), size=int(num_processes), local_rank=local_rank,
                       local_size=local_size, backend=backend, device=dev)
    return _WORLD


def leave_world() -> None:
    """Destroy the process group this process joined (if any)."""
    global _WORLD
    import torch.distributed as dist

    from ate_replication_causalml_torch.parallel.mesh import set_mesh

    set_mesh(None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device=None,
    local_rank: int | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the world when running multi-process; True when a world of
    more than one rank exists afterwards.

    Explicit arguments must be complete (``coordinator_address`` as
    ``host:port``, ``num_processes``, ``process_id``): a partial set
    raises. Without them the world comes from torchrun's environment; no
    ``WORLD_SIZE`` there means a single-process run, which returns False
    and leaves everything working on one device. ``num_processes=1`` is
    the documented no-op and returns False. ``device`` is the rank's
    device type (``cuda`` unless ``"cpu"``); ``backend`` as the module
    docstring says."""
    if num_processes == 1:
        return False  # explicit single-process: documented no-op
    explicit = (coordinator_address, num_processes, process_id) != (None, None, None)

    def _done(ok: bool, how: str) -> bool:
        # World-shape telemetry: the event log records how this process
        # joined (or did not), and the gauges make a mis-sized world
        # visible in metrics.json.
        obs.emit("multihost_init", status="ok" if ok else "skipped", how=how)
        if ok:
            import torch.distributed as dist

            n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            obs.gauge("process_count", "ranks in the torch.distributed world").set(
                dist.get_world_size())
            obs.gauge("device_count", "cards visible to this rank").set(n_cards)
        return ok

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return _done(dist.get_world_size() > 1, "already_initialized")
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_multihost: coordinator_address, num_processes and process_id "
                             "must be given together")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id {process_id} outside a world of {num_processes}")
        join_world(coordinator_address, int(num_processes), int(process_id), backend=backend,
                   device=device, local_rank=local_rank, timeout=timeout)
        return _done(True, "initialized")
    env = os.environ
    if not env.get("WORLD_SIZE", "").strip():
        return _done(False, "not_detected")
    size = int(env["WORLD_SIZE"])
    if size == 1:
        return _done(False, "single_process")
    addr = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env['MASTER_PORT']}"
    lr = int(env.get("LOCAL_RANK", env["RANK"])) if local_rank is None else local_rank
    join_world(addr, size, int(env["RANK"]), backend=backend, device=device, local_rank=lr,
               local_size=int(env.get("LOCAL_WORLD_SIZE", size)), timeout=timeout)
    return _done(True, "initialized")


def make_pod_mesh(replicate_axis: str = BOOT_AXIS, data_axis: str = DATA_AXIS,
                  data_parallel_per_slice: int | None = None):
    """Two-axis mesh: (replicates across hosts, rows within a host). The
    replicate axis carries bootstrap/tree/fold fan-out, which tolerates
    the slower link between hosts; the data axis carries ``all_reduce``
    sums, so it stays on one host.

    ``data_parallel_per_slice`` defaults to the ranks of one host (the
    world's ``LOCAL_WORLD_SIZE``; the whole world when unknown). Ranks
    beyond a multiple of it stay idle, with a warning."""
    from ate_replication_causalml_torch.parallel.mesh import make_mesh, world_size

    n = world_size()
    if data_parallel_per_slice is None:
        data_parallel_per_slice = _WORLD.local_size if _WORLD is not None else n
    data_parallel_per_slice = min(max(1, data_parallel_per_slice), n)
    n_rep = n // data_parallel_per_slice
    used = n_rep * data_parallel_per_slice
    if used < n:
        warnings.warn(
            f"make_pod_mesh: {n - used} of {n} ranks idle (rank count not divisible by "
            f"data_parallel_per_slice={data_parallel_per_slice})", RuntimeWarning, stacklevel=2)
    return make_mesh((replicate_axis, data_axis), (n_rep, data_parallel_per_slice))
