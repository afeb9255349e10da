"""The port's public import surface against the JAX package's, read from
both source trees with ``ast`` (neither package is imported here).

For every module of the JAX package the port has the module of the same
path, and every public name of the JAX module — its top-level
functions, classes and assignments without a leading underscore, a
package ``__init__``'s imported names, and ``__all__`` — is a public
name of the port's module or of its ``__all__``. A package ``__all__``
of the JAX package is contained in the port's. The exceptions are
listed below, each with its reason, and every one of them must still be
needed: a name that the port gains comes off the list.

Run: ``python -m pytest tests/test_torch_public_surface.py -q``.
"""

from __future__ import annotations

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "ate_replication_causalml_tpu")
PORT_PKG = os.path.join(REPO, "ate_replication_causalml_torch")

#: JAX modules with no module of the same path in the port.
MODULE_EXCLUSIONS = {
    "ops/hist_pallas.py": "the Pallas histogram kernels and their dispatch; the port's are "
                          "ops/hist.py, ops/pack.py and csrc/hist.cu, csrc/hist_partition.cu",
    "ops/tree_pallas.py": "the Pallas route and lookup kernels; the port's are ops/tree.py and "
                          "csrc/route.cu, csrc/lookup.cu",
    "analysis/jaxast.py": "the linter's model of JAX programs; the port's is analysis/torchast.py",
    "utils/compile_cache.py": "XLA's persistent compile cache; the port's cache is "
                              "kernels/build.py's hash-named nvcc libraries",
    "utils/hostdevices.py": "XLA's virtual host devices; the port's ranks are torch.distributed "
                            "processes (parallel/spawn.py)",
}

#: JAX public names the port does not have: ``name`` (in any module) or
#: ``module::name``.
NAME_EXCLUSIONS = {
    # JAX-only.
    "install_jax_monitoring": "jax.monitoring's compile listeners; the port's is "
                              "observability/device.py::install_monitoring",
    "compile_event_count": "XLA's compile events; the port's is scenarios/batched.py's",
    "parallel/mesh.py::shard_map": "jax's shard_map; the port's ranks run torch.distributed",
    "exact_order_stats": "a TPU compile-time workaround; the port's quantile_bins gives the "
                         "same bits",
    "scenarios/matrix.py::scalar_generate_executable": "an XLA executable lowered and compiled "
                                                       "ahead of time; PyTorch ops compile "
                                                       "nothing ahead of time",
    "analysis/rules.py::JitAmbientState": "JGL001, a rule on jitted JAX code; the port's "
                                          "counterpart is TGL001",
    "analysis/rules.py::TracedPythonBranch": "JGL003, a rule on traced JAX values; the port's "
                                             "counterpart is TGL003",
    # The one-hot matmul formulations of the TPU's matrix unit: the port
    # routes rows with its kernels (route_advance, traverse) under every
    # backend name.
    "route_rows": "the one-hot matmul route; the port's rows go through ops/tree.py's kernels",
    "route_rows_blocked": "the blocked one-hot matmul route; the port's rows go through "
                          "ops/tree.py's kernels",
    "route_rows_packed": "the one-hot matmul route over packed codes; the port's rows go "
                         "through ops/tree.py's kernels",
    "bin_onehot": "the bin one-hot of the matmul histogram; the port's histograms are "
                  "ops/hist.py's kernels",
    "apply_trees_chunked": "the matmul forest apply; the port's is forest_apply (traverse)",
    "ops/pack.py::route_mac_model": "the MXU cost model of the packed matmul route",
    # Chunk helpers with no caller in the port.
    "pick_chunk": "a divisor search for the matmul route's row chunks",
    "pick_divisor": "a divisor search for the matmul route's row chunks",
    # Another form in the port.
    "utils/profiling.py::stage": "the port's is the StageTimer.stage method",
    # The benchmark's.
    "bench_record": "a BENCHMARK record through the registry; it comes with the port's "
                    "benchmark",
}

#: JAX public names that the port defines in another module: ``module::name``
#: → the port's module.
MOVED = {
    "observability/device.py::PAD_FRACTION_BOUNDS": "observability/registry.py",
    **{f"models/forest.py::{n}": "models/plan.py"
       for n in ("auto_tree_chunk", "dispatch_tree_target", "hist_partition_active",
                 "plan_host_dispatch", "plan_tree_dispatch", "sharded_fit_plan",
                 "streaming_hist_widths")},
}


def _modules(pkg: str) -> list[str]:
    out = []
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.relpath(os.path.join(dirpath, f), pkg).replace(os.sep, "/")
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def surface(path: str) -> tuple[set[str], list[str] | None]:
    """(public names, ``__all__`` or None) of one source file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    package = os.path.basename(path) == "__init__.py"
    names, all_ = set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        all_ = list(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif package and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    public = {n for n in names if not n.startswith("_")} | set(all_ or ())
    return public, all_


def excluded(rel: str, name: str) -> bool:
    return name in NAME_EXCLUSIONS or f"{rel}::{name}" in NAME_EXCLUSIONS


def gaps(rel: str) -> list[str]:
    """The JAX module's public names and ``__all__`` entries the port's
    module lacks, moved names found where MOVED says."""
    jax_names, jax_all = surface(os.path.join(JAX_PKG, rel))
    port_names, port_all = surface(os.path.join(PORT_PKG, rel))
    missing = []
    for name in sorted(jax_names - port_names):
        moved = MOVED.get(f"{rel}::{name}")
        if moved is None or name not in surface(os.path.join(PORT_PKG, moved))[0]:
            missing.append(name)
    if jax_all is not None:
        missing += [f"__all__:{n}" for n in sorted(set(jax_all) - set(port_all or ()))]
    return missing


JAX_MODULES = _modules(JAX_PKG)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_the_module_and_its_public_names(rel):
    if rel in MODULE_EXCLUSIONS:
        assert not os.path.exists(os.path.join(PORT_PKG, rel)), f"{rel} is ported: unlist it"
        return
    assert os.path.exists(os.path.join(PORT_PKG, rel)), f"the port has no {rel}"
    left = [g for g in gaps(rel) if not excluded(rel, g.removeprefix("__all__:"))]
    assert not left, f"{rel}: the port lacks {left}"


def test_every_exclusion_has_a_reason_and_is_still_needed():
    assert all(reason.strip() for reason in {**MODULE_EXCLUSIONS, **NAME_EXCLUSIONS}.values())
    used = set()
    for rel in JAX_MODULES:
        if rel in MODULE_EXCLUSIONS:
            continue
        for g in gaps(rel):
            name = g.removeprefix("__all__:")
            used.update(k for k in (name, f"{rel}::{name}") if k in NAME_EXCLUSIONS)
    assert set(NAME_EXCLUSIONS) - used == set()


def test_moved_names_are_where_stated():
    for key, port_rel in MOVED.items():
        rel, name = key.split("::")
        assert name in surface(os.path.join(JAX_PKG, rel))[0], key
        assert name in surface(os.path.join(PORT_PKG, port_rel))[0], (key, port_rel)


def test_package_all_and_estimators_all_equal_the_jax_packages():
    for rel in ("__init__.py", "estimators/__init__.py"):
        jax_all = surface(os.path.join(JAX_PKG, rel))[1]
        port_all = surface(os.path.join(PORT_PKG, rel))[1]
        assert port_all == jax_all, rel
