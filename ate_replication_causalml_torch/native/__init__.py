"""Native host runtime — the C++ cores behind the data pipeline.

Port of ``ate_replication_causalml_tpu/native/``. The reference's
host-side native code is R's C internals (the MT19937 RNG behind
``set.seed``/``sample``, ``read.csv``'s parser). This package keeps its
own copy of the JAX package's small C++ library (``rcompat.cpp``),
compiled on first use with the host ``g++`` and bound through ``ctypes``.
The library builds into ``build/torch_native/`` of the checkout (outside
the package, which may be read-only).

Everything here is host-side ingest and sampling; the card's compute
never calls into it. Every entry point has a pure-Python/NumPy
counterpart (``utils/rrandom.py``, ``data/pipeline.py``'s NumPy reader),
which the data pipeline falls back to when the build fails, as the JAX
package's does; ``native_status`` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "rcompat.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "torch_native")
_LIB_PATH = os.path.join(BUILD_DIR, "_rcompat.so")
_lock = threading.Lock()
_lib = None
_lib_error: str | None = None


def _build() -> None:
    # Compile to a per-process temp path and os.replace() it into place:
    # concurrent builders (pytest-xdist workers, the ranks of a world)
    # each produce a complete .so and the rename is atomic, so no process
    # can dlopen a half-written file. An flock on a sidecar serializes the
    # (cheap) compiles where the filesystem supports it.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp_path, _SRC]
    # Append mode (no truncation: another holder may have the fd), and a
    # best-effort unlink after release: correctness never rests on the
    # lock (the atomic rename does that), so a racing unlink/reopen at
    # worst runs one redundant compile.
    lock_path = f"{_LIB_PATH}.lock"
    lockfile = open(lock_path, "a")  # noqa: SIM115 — held across the build
    try:
        try:
            import fcntl

            fcntl.flock(lockfile, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # no flock: the atomic rename is still safe
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp_path, _LIB_PATH)
    finally:
        lockfile.close()
        for leftover in (tmp_path, lock_path):
            try:
                os.unlink(leftover)
            except OSError:
                pass


def load_library(rebuild: bool = False):
    """Compile (once, cached as ``build/torch_native/_rcompat.so``) and
    dlopen the native library. Returns None, with the reason in
    :func:`native_status`, when no toolchain is available; callers fall
    back to NumPy."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        if _lib_error is not None and not rebuild:
            return None  # don't re-run g++ on every call after a failed build
        _lib_error = None
        try:
            if rebuild or not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
            ):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.CalledProcessError) as e:
            _lib_error = str(e)
            return None
        lib.rcompat_new.restype = ctypes.c_void_p
        lib.rcompat_new.argtypes = [ctypes.c_uint32, ctypes.c_int]
        lib.rcompat_free.argtypes = [ctypes.c_void_p]
        lib.rcompat_runif.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.rcompat_sample_int.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.csv_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.csv_header.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
        lib.csv_read_f64.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    return load_library() is not None


def native_status() -> str:
    if load_library() is not None:
        return f"native: {_LIB_PATH}"
    return f"fallback (native build failed: {_lib_error})"


class NativeRCompatRNG:
    """C++-backed R-compatible RNG with the interface of
    :class:`~ate_replication_causalml_torch.utils.rrandom.RCompatRNG`
    (``runif`` / ``sample_int`` / ``sample_n_rows``)."""

    def __init__(self, seed: int, sample_kind: str = "rounding"):
        if sample_kind not in ("rounding", "rejection"):
            raise ValueError(f"bad sample_kind {sample_kind!r}")
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_lib_error}")
        self._lib = lib
        self.sample_kind = sample_kind
        self._h = lib.rcompat_new(
            ctypes.c_uint32(seed & 0xFFFFFFFF),
            0 if sample_kind == "rounding" else 1,
        )

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and getattr(self, "_lib", None):
            self._lib.rcompat_free(h)

    def runif(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self._lib.rcompat_runif(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n
        )
        return out

    def sample_int(self, n: int, size: int | None = None, replace: bool = False) -> np.ndarray:
        if size is None:
            size = n
        if not replace and size > n:
            raise ValueError("cannot take a sample larger than the population without replacement")
        out = np.empty(size, dtype=np.int64)
        self._lib.rcompat_sample_int(
            self._h, n, size, 1 if replace else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    def sample_n_rows(self, n_rows: int, size: int) -> np.ndarray:
        return self.sample_int(n_rows, size, replace=False)


def make_rcompat_rng(seed: int, sample_kind: str = "rounding", backend: str = "auto"):
    """R-compatible RNG factory: ``backend="auto"`` prefers the C++ core
    and falls back to the NumPy implementation; "native" requires the
    C++ core, "python" takes the NumPy one."""
    from ate_replication_causalml_torch.utils.rrandom import RCompatRNG

    if backend not in ("auto", "native", "python"):
        raise ValueError(
            f"unknown RNG backend {backend!r}: expected 'auto', 'native' or 'python'"
        )
    if backend == "python":
        return RCompatRNG(seed, sample_kind=sample_kind)
    if backend == "native" or native_available():
        return NativeRCompatRNG(seed, sample_kind=sample_kind)
    return RCompatRNG(seed, sample_kind=sample_kind)


def read_csv_native(path: str) -> tuple[list[str], np.ndarray]:
    """C++ numeric CSV reader (``read.csv`` equivalent): returns
    (header names, row-major float64 matrix with NaN for NA/blank).
    Raises RuntimeError if the native library is unavailable."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_lib_error}")
    bpath = path.encode()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.csv_dims(bpath, ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise FileNotFoundError(path)
    buf = ctypes.create_string_buffer(1 << 20)
    rc = lib.csv_header(bpath, buf, len(buf))
    if rc == -2:
        raise ValueError(f"{path}: header line longer than {len(buf)} bytes")
    if rc != 0:
        raise FileNotFoundError(path)
    header = buf.value.decode().split(",")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    if lib.csv_read_f64(
        bpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.value, cols.value,
    ) != 0:
        raise FileNotFoundError(path)
    return header, out
