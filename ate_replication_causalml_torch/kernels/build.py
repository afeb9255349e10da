"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every source under ``csrc/`` is compiled on its own into a shared
library with a plain C interface, for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<lib>-<hash>.so csrc/<lib>.cu

A library exports one or more kernel entry points (``KERNELS``).

The libraries are built at first use, all ``nvcc`` processes started
together, into ``build/torch_kernels/`` at the repository root. A
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is never served by
a stale build. ``ptxas``' register and
shared-memory report lands beside each library as ``<name>-<hash>.log``.

The hash-named libraries are the port's compile cache:
``compile_cache_hits_total`` counts a library found on disk,
``compile_cache_misses_total`` an ``nvcc`` run, and
``kernel_builds_total`` every library loaded into the process, either
way: the serving daemon's proof that nothing is built after its warm
phase reads it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()`` (``hist_partition_clusters`` launches nothing: it
writes the occupancy query's answer); :func:`check` turns a non-zero code
into a :class:`~..resilience.errors.CudaKernelError`, as is a failed
build: the shard runner retries neither.

Ranks that share one build directory (several processes on one host)
must not race on it: the parent builds once (:func:`build_all`) and
starts the ranks with ``ATE_TPU_KERNELS_PREBUILT=1``, under which a rank
only loads the built libraries and raises if one is missing. Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.resilience.errors import CudaKernelError

#: Set to 1 in a process that must only load libraries built before it.
PREBUILT_ENV = "ATE_TPU_KERNELS_PREBUILT"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_D = ctypes.c_double

# library -> source file; each exports ate_<library>_error_string.
LIBRARIES = {
    "hist": "hist.cu",
    "hist_partition": "hist_partition.cu",
    "leaf_sums": "leaf_sums.cu",
    "route": "route.cu",
    "lookup": "lookup.cu",
    "lasso": "lasso.cu",
}

# entry name -> (library, C entry point, argtypes). Pointers and the
# stream go as c_void_p: ctypes would otherwise pass a 32-bit int.
KERNELS = {
    "hist": ("hist", "ate_hist",
             [_P, _I64, _I, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "partition_sort": ("hist_partition", "ate_partition_sort",
                       [_P, _I64, _I, _I, _I, _P, _I64, _I, _I, _P, _P, _P, _P, _P]),
    "hist_partition": ("hist_partition", "ate_hist_partition",
                       [_P, _I64, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]),
    "hist_partition_clusters": ("hist_partition", "ate_hist_partition_clusters",
                                [_I, _I, _I, _I, _I, _I, _I, _P]),
    "hist_partition_packed": ("hist_partition", "ate_hist_partition_packed",
                              [_P, _I64, _I, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P]),
    "pack_codes": ("hist_partition", "ate_pack_codes", [_P, _I64, _I, _P, _P]),
    "leaf_sums": ("leaf_sums", "ate_leaf_sums",
                  [_P, _I64, _I, _P, _I64, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "route": ("route", "ate_route",
              [_P, _I64, _I, _P, _P, _P, _I, _I, _P, _P]),
    "lookup": ("lookup", "ate_lookup",
               [_P, _I, _I, _I, _P, _I64, _P, _P]),
    "route_advance": ("route", "ate_route_advance",
                      [_P, _I64, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P]),
    "traverse": ("lookup", "ate_traverse",
                 [_P, _I64, _I, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P]),
    "leaf_record": ("lookup", "ate_leaf_record",
                    [_P, _I64, _I64, _I64, _P, _P, _I, _I, _P, _I64, _P, _P, _P]),
    "cd_path": ("lasso", "ate_cd_path",
                [_P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _I, _I, _P, _P, _P]),
    # The same library's host-side queries (the delay d, the largest p) and
    # the card tests' check of its float division.
    "cd_delay": ("lasso", "ate_cd_delay", []),
    "cd_max_p": ("lasso", "ate_cd_max_p", [_I]),
    "cd_div_check": ("lasso", "ate_cd_div_check", [_P, _P, _I64, _P, _P]),
}


@dataclasses.dataclass(frozen=True)
class Built:
    """One kernel entry point of a loaded library."""

    name: str
    library: str
    path: str
    fn: ctypes._CFuncPtr
    error_string: ctypes._CFuncPtr
    seconds: float      # nvcc wall time in this process (0.0 if reused)
    ptxas: str          # nvcc's -Xptxas -v report


_lock = threading.Lock()
_built: dict[str, Built] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise CudaKernelError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _target(lib: str) -> tuple[str, str, str]:
    src = os.path.join(CSRC_DIR, LIBRARIES[lib])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # The source and every shared header it may include.
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.join(BUILD_DIR, f"{lib}-{digest}")
    return src, stem + ".so", stem + ".log"


def _load(name: str, path: str, log: str, seconds: float) -> Built:
    lib_name, symbol, argtypes = KERNELS[name]
    lib = ctypes.CDLL(path)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, f"ate_{lib_name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    with open(log) as f:
        ptxas = f.read()
    return Built(name, lib_name, path, fn, err, seconds, ptxas)


def build_all() -> dict[str, Built]:
    """Build (one nvcc per library, all started together) and load every
    kernel not yet loaded."""
    with _lock:
        todo = [k for k in KERNELS if k not in _built]
        if not todo:
            return dict(_built)
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        hits = obs.counter("compile_cache_hits_total", "kernel libraries found built")
        misses = obs.counter("compile_cache_misses_total", "kernel libraries built by nvcc")
        for lib in sorted({KERNELS[k][0] for k in todo}):
            src, so, log = _target(lib)
            if os.path.isfile(so) and os.path.isfile(log):
                hits.inc(1)
                continue
            if os.environ.get(PREBUILT_ENV, "").strip() == "1":
                raise CudaKernelError(f"kernel library {lib} is not built at {so}, and "
                                      f"{PREBUILT_ENV}=1 forbids building it here")
            misses.inc(1)
            tmp = f"{so}.{os.getpid()}.tmp"
            # graftlint: disable=JGL005 — nvcc's log, the tmp half of tmp + os.replace: nvcc writes it, the build publishes it beside the library
            logf = open(log + ".tmp", "w")
            procs[lib] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=logf, stderr=subprocess.STDOUT,
            ), logf, tmp, so, log)
        failures = []
        for lib, (proc, logf, tmp, so, log) in procs.items():
            rc = proc.wait()
            logf.close()
            if rc != 0:
                with open(log + ".tmp") as f:
                    failures.append(f"{lib}: nvcc exit {rc}\n{f.read()}")
                continue
            os.replace(tmp, so)
            os.replace(log + ".tmp", log)
        if failures:
            raise CudaKernelError("CUDA kernel build failed:\n" + "\n".join(failures))
        seconds = time.perf_counter() - t0
        for name in todo:
            lib = KERNELS[name][0]
            _, so, log = _target(lib)
            _built[name] = _load(name, so, log, seconds if lib in procs else 0.0)
        # graftlint: disable=JGL021 — a port-only family: pre-creating it adds a key the JAX package's sweep never exports, and tests/test_torch_pipeline.py holds the two family sets equal
        obs.counter("kernel_builds_total", "kernel libraries built or loaded").inc(
            len({KERNELS[k][0] for k in todo}))
        return dict(_built)


def kernel(name: str) -> Built:
    """The loaded library of kernel ``name``, building all on first use."""
    built = _built.get(name)
    return built if built is not None else build_all()[name]


_count_lock = threading.Lock()


def count_launch(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` (one launch by default; a CUDA graph replay adds the
    launches it replays) to ``wrapper.<attr>``, the launch count that
    tests and ``chip_smoke.py`` read and reset, under a lock: the
    concurrent sweep's workers launch from several threads, and a bare
    ``+= 1`` there can lose increments."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


def check(built: Built, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = built.error_string(code).decode(errors="replace")
        raise CudaKernelError(f"CUDA kernel {built.name!r} failed: error {code} ({msg})")
