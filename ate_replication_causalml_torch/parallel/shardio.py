"""Device-resident sharded artifacts — the metered host/device boundary
of the nuisance-artifact plane.

Port of ``ate_replication_causalml_tpu/parallel/shardio.py``. An
artifact lives on the ranks' devices under a declared
:class:`~.mesh.Layout` (replicated, or rows over one axis) as a
:class:`DArray`: this rank's block plus the layout and the global
shape. Every byte that crosses a layout boundary moves through the
functions below, which meter each call into
``artifact_transfer_bytes_total{artifact,path}`` (bytes, by path) and
``artifact_reshard_total{artifact,status}`` (calls, by status), the two
families ``scripts/check_metrics_schema.py`` requires.

Byte paths (``path=`` label values):

* ``host_upload``    — host → device commit of a host-resident leaf;
* ``device_reshard`` — device → device layout change (an all-gather
  when rows become replicated: a collective, which callers that own a
  mesh lane run inside ``lane_lock``, see scheduler/cache.py);
* ``device_handoff`` — a consumer took the device-resident form as-is:
  bytes that stayed on the device;
* ``host_gather``    — device → host: all-gather to replicated, then one
  copy to the host;
* ``host_bounce``    — the legacy materialize-and-reupload double copy,
  kept only as a metered before-number; the sweep never takes it.

Each rank meters the bytes it moves: an upload its own rows, a gather
the whole array it receives. A reshard's ``status`` is ``compiled`` for
the first call of a (shape, dtype, source, target) path and ``cached``
after it, the JAX package's labels (the port compiles nothing: the
split counts distinct paths), ``noop`` when the leaf is already in
layout and ``upload`` for host leaves.

Lane discipline is the caller's job; this module is policy-free data
movement. Everything is synchronous: a commit returns after the copy
and any collective completed on the rank's current stream's terms.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.parallel.mesh import (
    DATA_AXIS,
    Layout,
    Mesh,
    all_gather_cat,
)

BYTES_FAMILY = "artifact_transfer_bytes_total"
CALLS_FAMILY = "artifact_reshard_total"

PATH_UPLOAD = "host_upload"
PATH_RESHARD = "device_reshard"
PATH_HANDOFF = "device_handoff"
PATH_GATHER = "host_gather"
PATH_BOUNCE = "host_bounce"

_SEEN: set[tuple] = set()
_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True, eq=False)
class DArray:
    """A device-resident value under a layout: ``local`` is this rank's
    block (the whole value when replicated), ``shape`` the global shape."""

    local: torch.Tensor
    layout: Layout
    shape: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.local.element_size()


def _bytes_counter():
    return obs.counter(BYTES_FAMILY, "artifact-plane bytes moved by path (host_upload / "
                       "device_reshard / device_handoff / host_gather / host_bounce)")


def _calls_counter():
    return obs.counter(CALLS_FAMILY, "artifact-plane shard/gather/reshard calls by status")


def leaf_nbytes(leaf) -> int:
    """Payload bytes of one array-like leaf (a DArray's global bytes)."""
    if isinstance(leaf, DArray):
        return leaf.nbytes
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def tree_nbytes(tree) -> int:
    """Total payload bytes of a pytree of arrays."""
    return sum(leaf_nbytes(leaf) for leaf in pytree.tree_leaves(tree))


def row_sharding(mesh: Mesh, n: int, axis: str = DATA_AXIS) -> Layout:
    """Rows over ``axis`` for an n-row value when ``n`` divides the axis
    size, replicated otherwise (the JAX package's rule: the layout of an
    existing value whose shape its consumers depend on; shape-owning
    callers pad with :func:`shard_rows_padded` instead)."""
    return Layout(mesh, axis) if n % mesh.shape[axis] == 0 else Layout(mesh)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (and >= k: zero rows
    still occupy one empty shard per rank)."""
    return max(1, -(-n // k)) * k


def pad_rows(tree, multiple: int):
    """Zero-pad dim 0 of every (host) leaf up to the next ``multiple``.
    Returns ``(padded_tree, n)``, ``n`` the original row count."""
    leaves = pytree.tree_leaves(tree)
    if not leaves:
        return tree, 0
    ns = {int(np.shape(leaf)[0]) for leaf in leaves}
    if len(ns) != 1:
        raise ValueError(f"pad_rows: leaves disagree on row count: {sorted(ns)}")
    (n,) = ns
    target = pad_to_multiple(n, multiple)

    def per_leaf(leaf):
        host = np.asarray(leaf)
        if target == n:
            return host
        return np.pad(host, [(0, target - n)] + [(0, 0)] * (host.ndim - 1))

    return pytree.tree_map(per_leaf, tree), n


def row_mask(n: int, padded: int, dtype=np.float32) -> np.ndarray:
    """The (padded,) 0/1 row mask: 1 on the first ``n`` real rows, exact
    zeros on the pad, so ``sum(mask * x)`` drops the pad exactly."""
    mask = np.zeros((padded,), dtype=dtype)
    mask[:n] = 1.0
    return mask


def _block(n: int, layout: Layout) -> slice:
    """This rank's rows of an n-row value under ``layout``."""
    if layout.is_fully_replicated:
        return slice(0, n)
    a = layout.mesh.shape[layout.axis]
    if n % a:
        raise ValueError(f"{n} rows do not divide the {layout.axis!r} axis of size {a}")
    c = layout.mesh.coord(layout.axis)
    return slice(c * (n // a), (c + 1) * (n // a))


def _upload(leaf, dst: Layout) -> torch.Tensor:
    host = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    part = host[_block(host.shape[0], dst)] if host.ndim else host
    return torch.from_numpy(np.ascontiguousarray(part)).to(dst.mesh.device)


def _layout_of(leaf) -> Layout | None:
    return leaf.layout if isinstance(leaf, DArray) else None


def _replicate(leaf: DArray) -> torch.Tensor:
    """The whole value on this rank (an all-gather when rows are sharded)."""
    if leaf.layout.is_fully_replicated:
        return leaf.local
    return all_gather_cat(leaf.local, leaf.layout.mesh, leaf.layout.axis)


def _move_leaf(leaf, dst: Layout, artifact: str, calls, moved: list) -> DArray:
    """One device leaf (a DArray, or a tensor taken as replicated) onto
    ``dst``; ``moved`` accumulates the bytes that changed layout."""
    src = _layout_of(leaf)
    if src == dst or (src is not None and src.is_fully_replicated and dst.is_fully_replicated
                      and src.mesh is dst.mesh):
        calls.inc(1, artifact=artifact, status="noop")
        return leaf
    full = _replicate(leaf) if isinstance(leaf, DArray) else leaf
    sig = (tuple(full.shape), str(full.dtype), None if src is None else (id(src.mesh), src.axis),
           (id(dst.mesh), dst.axis))
    with _LOCK:
        seen = sig in _SEEN
        _SEEN.add(sig)
    out = DArray(full[_block(full.shape[0], dst)] if full.ndim else full, dst, tuple(full.shape))
    calls.inc(1, artifact=artifact, status="cached" if seen else "compiled")
    moved.append(leaf_nbytes(full))
    return out


def commit(tree, layout: Layout, artifact: str = "") -> Any:
    """Commit a fit's output onto its declared device-resident layout.
    Host (numpy) leaves upload this rank's rows (metered
    ``host_upload``); device leaves reshard (metered ``device_reshard``);
    leaves already in layout are noops."""
    b, c = _bytes_counter(), _calls_counter()
    moved: list[int] = []
    uploaded: list[int] = []

    def per_leaf(leaf):
        if isinstance(leaf, DArray) or (isinstance(leaf, torch.Tensor)
                                        and leaf.device == layout.mesh.device):
            return _move_leaf(leaf, layout, artifact, c, moved)
        local = _upload(leaf, layout)
        c.inc(1, artifact=artifact, status="upload")
        uploaded.append(local.numel() * local.element_size())
        return DArray(local, layout, tuple(np.shape(leaf)))

    out = pytree.tree_map(per_leaf, tree)
    if uploaded:
        b.inc(sum(uploaded), artifact=artifact, path=PATH_UPLOAD)
    if moved:
        b.inc(sum(moved), artifact=artifact, path=PATH_RESHARD)
    return out


def reshard(tree, layout: Layout, artifact: str = "") -> Any:
    """Device → device layout change onto ``layout`` (an all-gather when
    sharded rows become whole: lane-owning callers run it in the lane)."""
    b, c = _bytes_counter(), _calls_counter()
    moved: list[int] = []
    out = pytree.tree_map(lambda leaf: _move_leaf(leaf, layout, artifact, c, moved), tree)
    if moved:
        b.inc(sum(moved), artifact=artifact, path=PATH_RESHARD)
    return out


def handoff(tree, artifact: str = "") -> Any:
    """Meter a device-resident handoff: the consumer took the stored
    layout, so these bytes did not cross the host bus."""
    _bytes_counter().inc(tree_nbytes(tree), artifact=artifact, path=PATH_HANDOFF)
    return tree


def gather_host(tree, artifact: str = "") -> Any:
    """Device → host: all-gather each sharded leaf to replicated (a
    collective), then one copy to the host. Returns read-only numpy
    leaves: the host form is shared by every host consumer, so an
    in-place write must fail loudly."""
    b, c = _bytes_counter(), _calls_counter()
    moved: list[int] = []

    def per_leaf(leaf):
        if not isinstance(leaf, (DArray, torch.Tensor)):
            return leaf
        if isinstance(leaf, DArray) and not leaf.layout.is_fully_replicated:
            leaf = _move_leaf(leaf, Layout(leaf.layout.mesh), artifact, c, moved)
        t = leaf.local if isinstance(leaf, DArray) else leaf
        host = t.detach().cpu().numpy().copy()
        host.flags.writeable = False
        b.inc(host.nbytes, artifact=artifact, path=PATH_GATHER)
        return host

    out = pytree.tree_map(per_leaf, tree)
    if moved:
        # The all-gather feeding the copy is device traffic, metered too.
        b.inc(sum(moved), artifact=artifact, path=PATH_RESHARD)
    return out


def host_bounce(tree, artifact: str = "") -> Any:
    """The legacy double copy (whole value to the host, straight back to
    the device), kept only as a metered before-number: ``host_bounce``
    records both crossings, 2 × payload."""
    b = _bytes_counter()

    def per_leaf(leaf):
        full = _replicate(leaf) if isinstance(leaf, DArray) else torch.as_tensor(leaf)
        host = full.detach().cpu().numpy().copy()
        b.inc(2 * host.nbytes, artifact=artifact, path=PATH_BOUNCE)
        return torch.from_numpy(host).to(full.device)

    return pytree.tree_map(per_leaf, tree)


def shard_rows_padded(tree, mesh: Mesh, axis: str = DATA_AXIS, artifact: str = ""):
    """Pad dim 0 of every host leaf to the next ``axis``-size multiple and
    commit onto an even row layout. Returns ``(device_tree, mask, n)``:
    ``mask`` the row-sharded (padded,) 0/1 mask, ``n`` the real row count.
    :func:`gather_rows_padded` inverts it bit for bit."""
    padded, n = pad_rows(tree, mesh.shape[axis])
    layout = Layout(mesh, axis)
    dev = commit(padded, layout, artifact=artifact)
    first = pytree.tree_leaves(padded)
    target = int(np.shape(first[0])[0]) if first else 0
    mask = commit(row_mask(n, target), layout,
                  artifact=f"{artifact}_mask" if artifact else "row_mask")
    return dev, mask, n


def gather_rows_padded(tree, n: int, artifact: str = ""):
    """Inverse of :func:`shard_rows_padded`'s data leg: one metered host
    gather, then the pad rows dropped. Read-only numpy leaves of ``n``
    rows."""
    host = gather_host(tree, artifact=artifact)

    def per_leaf(leaf):
        if not isinstance(leaf, np.ndarray):
            return leaf
        out = leaf[:n]
        out.flags.writeable = False
        return out

    return pytree.tree_map(per_leaf, host)


def edge_byte_plan(nbytes: int, producer_lane: str | None, consumer_lane: str | None) -> dict:
    """Per-edge host/device byte accounting: a laned→laned edge (producer
    and consumer share a mesh lane) hands the artifact off on the device,
    zero host bytes; any other edge pays one gather to the host. The
    legacy materialize-and-reupload paid ``2 × nbytes`` on every edge."""
    laned_to_laned = producer_lane is not None and producer_lane == consumer_lane
    return {
        "host_bytes": 0 if laned_to_laned else nbytes,
        "device_bytes": nbytes if laned_to_laned else 0,
        "legacy_host_bytes": 2 * nbytes,
    }
