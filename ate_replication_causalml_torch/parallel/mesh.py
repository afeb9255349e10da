"""Device meshes over the ranks of a ``torch.distributed`` world.

Port of ``ate_replication_causalml_tpu/parallel/mesh.py``. The JAX
package drives every device from one controller and lets XLA insert the
collectives; the port runs one process (rank) per card, and every rank
runs the same program. A :class:`Mesh` names the framework's parallel
axes over those ranks:

  * ``boot`` — bootstrap replicates (``ate_functions.R:192-194``)
  * ``tree`` — forest trees (randomForest / grf tree loops)
  * ``fold`` — CV / cross-fitting folds (``cv.glmnet``; ``double_ml``)
  * ``data`` — row sharding, with ``all_reduce`` sums for X'WX / X'Wz

A mesh over the ranks of a process group is built on
``torch.distributed.device_mesh`` (a one-rank group too: its collectives
run, as one-rank collectives); a process that joined no world gets a
mesh of axis sizes 1 whose collectives are identities, so the sharded
entry points run unchanged on one card.

A "sharding" here is a layout tag (:class:`Layout`: replicated, or rows
over one axis), not a property of a tensor: each rank holds either the
whole value or its block of rows (``shardio.DArray``).

The collectives below are the only ones the port issues. Each takes
the tensors on the rank's device: ``nccl`` on the card; ``gloo`` copies
a CUDA tensor through host memory itself (torch 2.11's gloo takes every
collective on CUDA tensors, ``scripts/torch_multigpu_probe.py``), and
the bytes it copies are metered at the call in
``collective_host_staging_bytes_total{op}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Sequence

import torch

from ate_replication_causalml_torch import observability as obs

# Canonical axis names used across the framework.
BOOT_AXIS = "boot"
TREE_AXIS = "tree"
FOLD_AXIS = "fold"
DATA_AXIS = "data"

STAGING_FAMILY = "collective_host_staging_bytes_total"


def _dist():
    import torch.distributed as dist

    return dist


def world_size() -> int:
    """Ranks in the world: 1 when no process group is initialized."""
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank: 0 when no process group is initialized."""
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this rank writes files (rank 0; every rank of a world of one)."""
    return world_rank() == 0


class Mesh:
    """Named axes over the ranks of the world.

    ``shape`` maps axis name to size, in axis order (the JAX
    ``Mesh.shape``). ``coord(axis)`` is this rank's index along an axis
    and ``group(axis)`` the process group of the ranks that share every
    other coordinate (None without a process group: the collectives are
    identities then). ``device`` is this rank's device. Meshes compare by
    identity, as they key caches."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], device_mesh=None,
                 device: torch.device | None = None):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")
        self.device_mesh = device_mesh
        self.device = device if device is not None else _rank_device()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise KeyError(f"axis {axis!r} is not in mesh axes {self.axis_names}")
        return self.axis_names.index(axis)

    def coord(self, axis: str) -> int:
        d = self._dim(axis)
        if self.device_mesh is None:
            return 0
        c = self.device_mesh.get_coordinate()
        if c is None:
            raise RuntimeError(f"rank {world_rank()} is not in this mesh")
        return int(c[d])

    def group(self, axis: str):
        self._dim(axis)
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={world_rank()}, device={self.device})"


def _rank_device() -> torch.device:
    from ate_replication_causalml_torch.parallel.multihost import rank_device

    return rank_device()


def make_mesh(axis_names: Sequence[str] = (BOOT_AXIS,), axis_sizes: Sequence[int] | None = None,
              devices: Sequence[int] | None = None) -> Mesh:
    """A mesh over the world's ranks (``devices``: the ranks to use, in
    order; default every rank). Default: one axis spanning them all.
    Multi-axis shapes reshape the rank list row-major, as the JAX package
    reshapes its device array; the first ``prod(axis_sizes)`` ranks are
    used. Every rank of the world must make the same meshes in the same
    order (building one creates process groups)."""
    ranks = list(range(world_size())) if devices is None else [int(r) for r in devices]
    if axis_sizes is None:
        axis_sizes = [len(ranks)] + [1] * (len(axis_names) - 1)
    n = math.prod(axis_sizes)
    if n > len(ranks) or n < 1:
        raise ValueError(f"mesh of shape {tuple(axis_sizes)} needs {n} ranks, have {len(ranks)}")
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise ValueError(f"mesh of shape {tuple(axis_sizes)} without a process group")
        return Mesh(axis_names, axis_sizes)
    from torch.distributed.device_mesh import DeviceMesh

    from ate_replication_causalml_torch.parallel.multihost import world_info

    info = world_info()
    dtype = "cuda" if info is not None and info.backend == "nccl" else "cpu"
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(tuple(axis_sizes))
    return Mesh(axis_names, axis_sizes, DeviceMesh(dtype, grid, mesh_dim_names=tuple(axis_names)))


# The process-wide default mesh (``set_mesh`` / lazy ``make_mesh``) plus
# a per-thread ``use_mesh`` override. The override is thread-local on
# purpose: the concurrent sweep runs stage bodies on worker threads, and
# a mesh-lane stage inside ``use_mesh(fold_mesh)`` must not hand the fold
# mesh to an unlaned stage calling ``get_mesh()`` from another thread —
# that caller would issue a collective outside the lane, in an order the
# other ranks do not share.
_DEFAULT_MESH: Mesh | None = None
_DEFAULT_MESH_LOCK = threading.Lock()
_TLS = threading.local()


def set_mesh(mesh: Mesh | None) -> None:
    global _DEFAULT_MESH
    with _DEFAULT_MESH_LOCK:
        _DEFAULT_MESH = mesh


def get_mesh() -> Mesh:
    """This thread's ``use_mesh`` override if one is live, else the
    process default (a one-axis mesh over every rank, built lazily)."""
    override = getattr(_TLS, "mesh", None)
    if override is not None:
        return override
    global _DEFAULT_MESH
    with _DEFAULT_MESH_LOCK:
        if _DEFAULT_MESH is None:
            _DEFAULT_MESH = make_mesh()
        return _DEFAULT_MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _TLS.mesh = prev


def shard_axis_size(mesh: Mesh, axis_name: str) -> int:
    return mesh.shape[axis_name]


def check_mesh(mesh, axis_name: str) -> None:
    """A sharded entry point's ``mesh`` must be a :class:`Mesh` with the
    axis it shards over."""
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}: its axes are {mesh.axis_names}")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a value's rows live: ``axis`` None = every rank holds the
    whole value (replicated); else each rank holds its block of rows
    along ``axis`` (dim 0 split evenly, in coordinate order)."""

    mesh: Mesh
    axis: str | None = None

    @property
    def is_fully_replicated(self) -> bool:
        return self.axis is None or self.mesh.shape[self.axis] == 1


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh)


def row_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> Layout:
    """Shard the leading (row) dimension across ``axis_name``."""
    return Layout(mesh, axis_name)


# ── collectives ───────────────────────────────────────────────────────


def _meter_host_copy(t: torch.Tensor, group, op: str, nbytes: int) -> None:
    """Meter the ``nbytes`` gloo copies through host memory (to the host
    and back) for a collective on the CUDA tensor ``t``."""
    if t.is_cuda and _dist().get_backend(group) == "gloo":
        # graftlint: disable=JGL021 — a port-only family: pre-creating it adds a key the JAX package's sweep never exports, and tests/test_torch_pipeline.py holds the two family sets equal
        obs.counter(STAGING_FAMILY, "bytes gloo copies through host memory for collectives "
                    "on CUDA tensors, by collective").inc(nbytes, op=op)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0 in ``axis`` coordinate
    order (the shapes must agree). Identity on an axis of size 1."""
    group = mesh.group(axis)
    if group is None:
        return t
    if t.dtype == torch.bool:  # gloo has no bool type
        return all_gather_cat(t.to(torch.uint8), mesh, axis).to(torch.bool)
    dist = _dist()
    src = t.contiguous()
    ranks = dist.get_world_size(group)
    nbytes = src.numel() * src.element_size()
    _meter_host_copy(src, group, "all_gather", nbytes * (1 + ranks))  # in, and every part out
    parts = [torch.empty_like(src) for _ in range(ranks)]
    # graftlint: disable=JGL018 — not a launch site: this IS the collective the laned launchers (shardio, the mesh lane's nodes) call under the lane lock
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of every rank's ``t`` over ``axis`` (a new tensor)."""
    group = mesh.group(axis)
    if group is None:
        return t
    dist = _dist()
    buf = t.detach().clone()
    _meter_host_copy(buf, group, "all_reduce", 2 * buf.numel() * buf.element_size())
    # graftlint: disable=JGL018 — not a launch site: this IS the collective the laned launchers (shardio, the mesh lane's nodes) call under the lane lock
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def barrier() -> None:
    """Wait for every rank of the world (no-op in a world of one)."""
    if world_size() > 1:
        _dist().barrier()
