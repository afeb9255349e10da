"""The JAX package's forest dispatch plan, as plain Python.

Copied from ``ate_replication_causalml_tpu/models/forest.py``
(``dispatch_tree_target``, ``plan_tree_dispatch``, ``auto_tree_chunk``,
``plan_host_dispatch``, ``sharded_fit_plan``) with the TPU kernel's
memory model it reads (``ops/hist_pallas.py::batched_tree_cap``). The
port's growers do not need the plan to size their launches (their
chunking changes no number); the sharded fits need it for one thing:
the JAX sharded forest is the forest grown from
``split(key, n_disp · A · per_disp_dev)``, so the port must split the
same number of keys to grow the same trees. The numbers below are the
JAX package's TPU budgets (its HBM per chunk, its scoped-VMEM kernel
budget), kept as they are for that reason; they say nothing about the
H100's memory.
"""

from __future__ import annotations

from ate_replication_causalml_torch.ops.hist import mode_for_width, resolve_hist_mode_packed

# Trees per dispatched executable at 100k rows, scaled inversely with rows.
_DISPATCH_CHUNK_TARGET = 256
# HBM budget for the largest per-level operand of one vmapped tree chunk.
_CHUNK_BYTES_BUDGET = 2 << 30
# Rows per routing block of the streaming growers.
_ROUTE_BLOCK = 131072
# The classifier engine's padded histogram width (the causal engine's is 1).
HIST_M_FLOOR = 16
# The TPU histogram kernel's scoped-VMEM budget, lane width, row tile
# and partition block.
_VMEM_BUDGET = 100 * 1024 * 1024
_LANES = 128
_TILE = 2048
_PART_BLOCK = 8


def dispatch_tree_target(n_rows: int) -> int:
    """Trees per dispatch, scaled so one dispatch stays ~O(10 s)."""
    return max(16, _DISPATCH_CHUNK_TARGET * 100_000 // max(n_rows, 1))


def kernel_lanes(p: int, n_bins: int) -> int:
    """Lane width of the TPU kernel's histogram block."""
    f_pb = max(1, _LANES // n_bins)
    return -(-p // f_pb) * _LANES


def batched_tree_cap(max_nodes: int, n_weights: int, tile: int = _TILE, p: int = 21,
                     n_bins: int = 64, partition: bool = False) -> int:
    """Largest tree batch whose TPU kernel working set fits its budget."""
    lanes = kernel_lanes(p, n_bins)
    per_tree = 4 * n_weights * max_nodes * (lanes + tile)
    fixed = 2 * 4 * tile * lanes
    if partition:
        tp = tile + (max_nodes + 1) * _PART_BLOCK
        fixed += 4 * (tp * tile + tp * lanes + n_weights * tp)
    return max(1, (int(_VMEM_BUDGET * 0.9) - fixed) // max(per_tree, 1))


def streaming_hist_widths(depth: int, hist_floor: int = 1) -> tuple[int, ...]:
    """The kernel widths the streaming level loop requests, one per level:
    level 0 at the floor, level l >= 1 at max(2^(l-1), floor)."""
    if depth < 1:
        return ()
    return tuple(max(1, hist_floor) if level == 0 else max(1 << (level - 1), hist_floor)
                 for level in range(depth))


def hist_partition_active(hist_mode: str, depth: int, hist_floor: int, kernel_weights: int,
                          p: int, n_bins: int) -> bool:
    """Whether any level of a streaming grow resolves to the partition
    kernel under ``hist_mode``."""
    return any(mode_for_width(hist_mode, w, kernel_weights, p, n_bins).startswith("partition")
               for w in streaming_hist_widths(depth, hist_floor))


def auto_tree_chunk(n_rows: int, depth: int, cap: int, trees_per_unit: int = 1,
                    leaf_onehot: bool = False, streaming: bool = False, p: int = 21,
                    n_bins: int = 64, kernel_weights: int = 2, hist_floor: int = HIST_M_FLOOR,
                    hist_partition: bool = False) -> int:
    """Trees to grow per compiled chunk in the JAX package's memory model."""
    width = 1 << (depth if leaf_onehot else depth - 1)
    rows_eff = min(n_rows, _ROUTE_BLOCK) if streaming else n_rows
    per_tree = 4 * rows_eff * width * trees_per_unit
    hard_cap = 2 * cap if streaming else cap
    chunk = max(1, min(hard_cap, _CHUNK_BYTES_BUDGET // max(per_tree, 1)))
    if streaming:
        kernel_nodes = max(1 << max(0, depth - 2), hist_floor)
        chunk = min(chunk, max(1, batched_tree_cap(kernel_nodes, kernel_weights, p=p,
                                                   n_bins=n_bins, partition=hist_partition)
                               // trees_per_unit))
    return chunk


def plan_host_dispatch(total_units: int, unit_chunk: int,
                       target_units: int) -> tuple[int, int, int]:
    """(chunk, super_, n_disp) with ceil padding: full-width chunks, the
    last dispatch padded; ``n_disp · super_ · chunk`` keys cover the units."""
    chunk = max(1, min(unit_chunk, total_units))
    n_chunks = -(-total_units // chunk)
    super_ = max(1, min(target_units // chunk, n_chunks))
    n_disp = -(-n_chunks // super_)
    return chunk, super_, n_disp


def plan_tree_dispatch(n_rows: int, depth: int, per_dev_total: int, cap: int = 32,
                       trees_per_unit: int = 1, leaf_onehot: bool = False,
                       streaming: bool = False, p: int = 21, n_bins: int = 64,
                       kernel_weights: int = 2, hist_floor: int = HIST_M_FLOOR,
                       hist_partition: bool = False) -> tuple[int, int, int]:
    """(chunk, chunks_per_disp, n_disp) of a per-device tree workload."""
    budget = auto_tree_chunk(n_rows, depth, cap=cap, trees_per_unit=trees_per_unit,
                             leaf_onehot=leaf_onehot, streaming=streaming, p=p, n_bins=n_bins,
                             kernel_weights=kernel_weights, hist_floor=hist_floor,
                             hist_partition=hist_partition)
    return plan_host_dispatch(per_dev_total, budget,
                              max(1, dispatch_tree_target(n_rows) // trees_per_unit))


def sharded_fit_plan(n_rows: int, depth: int, per_dev_total: int, n_bins: int = 64, p: int = 21,
                     hist_mode: str | None = None,
                     hist_backend: str = "auto") -> tuple[int, int, int]:
    """The (chunk, chunks_per_disp, n_disp) plan of the JAX package's
    tree-sharded classifier under its "pallas" backend (histogram floor
    16), which the port's :func:`~.forest.fit_forest_sharded` follows;
    under ``hist_backend="pallas_interpret"`` the JAX package's floor is 1
    (its interpret mode pads no width), and so is the plan's."""
    mode = resolve_hist_mode_packed(hist_mode, n_bins)
    floor = 1 if hist_backend == "pallas_interpret" else HIST_M_FLOOR
    return plan_tree_dispatch(
        n_rows, depth, per_dev_total, streaming=True, p=p, n_bins=n_bins,
        hist_floor=floor,
        hist_partition=hist_partition_active(mode, depth, floor, 2, p, n_bins))


def sharded_causal_plan(n_rows: int, depth: int, per_dev_groups: int, k: int, p: int,
                        n_bins: int, hist_mode: str,
                        group_chunk: int | None = None) -> tuple[int, int, int]:
    """The JAX package's causal-grow plan (groups of ``k`` trees, five
    weight channels, histogram floor 1), with its explicit-smaller-chunk
    re-plan."""
    auto_chunk, chunks_per_disp, n_disp = plan_tree_dispatch(
        n_rows, depth, per_dev_groups, cap=16, trees_per_unit=k, leaf_onehot=False,
        streaming=True, p=p, n_bins=n_bins, kernel_weights=5, hist_floor=1,
        hist_partition=hist_partition_active(hist_mode, depth, 1, 5, p, n_bins))
    if group_chunk is not None and group_chunk < auto_chunk:
        return plan_host_dispatch(per_dev_groups, group_chunk,
                                  max(1, dispatch_tree_target(n_rows) // k))
    return auto_chunk, chunks_per_disp, n_disp
