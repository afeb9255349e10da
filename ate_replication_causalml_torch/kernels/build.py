"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every source under ``csrc/`` is compiled on its own into a shared
library with a plain C interface, for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

The libraries are built at first use, all ``nvcc`` processes started
together, into ``build/torch_kernels/`` at the repository root. A
library's file name carries a hash of its source and flags, so an
edited source is never served by a stale build. ``ptxas``' register and
shared-memory report lands beside each library as ``<name>-<hash>.log``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Nothing here runs at import: the CPU tests import every
module on a machine without ``nvcc``.
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

# name -> (source file, C entry point, argtypes). Pointers and the
# stream go as c_void_p: ctypes would otherwise pass a 32-bit int.
KERNELS = {
    "hist": ("hist.cu", "ate_hist",
             [_P, _I64, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]),
    "route": ("route.cu", "ate_route",
              [_P, _I64, _I, _P, _P, _P, _I, _I, _P, _P]),
    "lookup": ("lookup.cu", "ate_lookup",
               [_P, _I, _I, _I, _P, _I64, _P, _P]),
}


@dataclasses.dataclass(frozen=True)
class Built:
    """One loaded kernel library."""

    name: str
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
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _target(name: str) -> tuple[str, str, str]:
    src = os.path.join(CSRC_DIR, KERNELS[name][0])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.join(BUILD_DIR, f"{name}-{digest}")
    return src, stem + ".so", stem + ".log"


def _load(name: str, path: str, log: str, seconds: float) -> Built:
    lib = ctypes.CDLL(path)
    _, symbol, argtypes = KERNELS[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, symbol + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    with open(log) as f:
        ptxas = f.read()
    return Built(name, path, fn, err, seconds, ptxas)


def build_all() -> dict[str, Built]:
    """Build (in parallel) and load every kernel library not yet loaded."""
    with _lock:
        todo = [k for k in KERNELS if k not in _built]
        if not todo:
            return dict(_built)
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            src, so, log = _target(name)
            if os.path.isfile(so) and os.path.isfile(log):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            logf = open(log + ".tmp", "w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=logf, stderr=subprocess.STDOUT,
            ), logf, tmp, so, log)
        failures = []
        for name, (proc, logf, tmp, so, log) in procs.items():
            rc = proc.wait()
            logf.close()
            if rc != 0:
                with open(log + ".tmp") as f:
                    failures.append(f"{name}: nvcc exit {rc}\n{f.read()}")
                continue
            os.replace(tmp, so)
            os.replace(log + ".tmp", log)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        seconds = time.perf_counter() - t0
        for name in todo:
            _, so, log = _target(name)
            _built[name] = _load(name, so, log, seconds if name in procs else 0.0)
        return dict(_built)


def kernel(name: str) -> Built:
    """The loaded library of kernel ``name``, building all on first use."""
    built = _built.get(name)
    return built if built is not None else build_all()[name]


def check(built: Built, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = built.error_string(code).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {built.name!r} failed: error {code} ({msg})")
