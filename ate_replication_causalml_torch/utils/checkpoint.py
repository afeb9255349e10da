"""Model checkpointing: fitted forests and nuisances in one ``.npz``.

Port of ``ate_replication_causalml_tpu/utils/checkpoint.py``, and
archive-compatible with it in both directions. An object (the port's
dataclasses and NamedTuples, nested dicts, lists, tuples, scalars,
tensors, arrays) is stored as:

* its arrays, once each, under sequential keys ``arr_0``, ``arr_1``, …
  (a tensor is written as its host numpy array, dtype kept);
* a JSON manifest of the structure under ``__manifest__``, naming each
  record type by the JAX package's ``module:QualName``
  (``ate_replication_causalml_tpu.models.causal_forest:CausalForest``),
  translated through one explicit table (:data:`JAX_TYPES`);
* a SHA-256 digest over the manifest and every array's name, dtype,
  shape and bytes under ``__sha256__``.

The field order, the keys and the digest are the JAX package's, so the
same forest gives the same digest in both packages and each package's
``load_fitted`` verifies and loads the other's archive. No pickle: a
manifest may name only a type of the table, and any other name is
refused before anything is imported.

:func:`save_fitted` writes atomically (temporary file, fsync,
``os.replace``); :func:`load_fitted` recomputes the digest and raises
:class:`~..resilience.errors.CheckpointCorrupt`, naming the path, on a
mismatch, an unreadable or torn archive, or a missing manifest. Archives
without a digest load with a ``checkpoint_unverified`` event. Under
``ATE_TPU_CHAOS`` ``fs:corrupt_npz`` the archive is written truncated,
which is how the refusal path is proven.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import threading
from typing import Any

import numpy as np
import torch

from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience.errors import CheckpointCorrupt

__all__ = ["CheckpointCorrupt", "JAX_TYPES", "load_fitted", "save_fitted"]

_ARR = "__array__"
_MANIFEST = "__manifest__"
_DIGEST = "__sha256__"

_JAX_PKG = "ate_replication_causalml_tpu"

#: The record types a checkpoint may hold: the JAX package's manifest
#: name (module relative to its package, ``:`` QualName) → the port's
#: module and class of the same fields in the same order.
JAX_TYPES: dict[str, tuple[str, str]] = {
    "models.causal_forest:CausalForest": ("models.causal_forest", "CausalForest"),
    "models.causal_forest:FittedCausalForest": ("models.causal_forest", "FittedCausalForest"),
    "models.causal_forest:CatePredictions": ("models.causal_forest", "CatePredictions"),
    "models.causal_forest:AverageEffect": ("models.causal_forest", "AverageEffect"),
    "models.forest:Forest": ("models.forest", "Forest"),
    "models.forest:ForestPredictions": ("models.forest", "ForestPredictions"),
    "ops.glm:GlmResult": ("ops.glm", "GlmResult"),
    "ops.lasso:ElnetPath": ("ops.lasso", "ElnetPath"),
    "ops.lasso:CvGlmnetResult": ("ops.lasso", "CvGlmnetResult"),
}

_PORT_PKG = __name__.split(".", 1)[0]


def _port_class(module: str, name: str) -> type:
    import importlib

    return getattr(importlib.import_module(f"{_PORT_PKG}.{module}"), name)


@functools.lru_cache(maxsize=None)
def _manifest_names() -> dict[type, str]:
    """Port class → the JAX package's manifest name."""
    return {_port_class(*port): f"{_JAX_PKG}.{jax_name}" for jax_name, port in JAX_TYPES.items()}


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _type_name(obj, path: str) -> str:
    name = _manifest_names().get(type(obj))
    if name is None:
        raise TypeError(f"cannot checkpoint {type(obj).__name__} at {path!r}: not a "
                        "checkpointable record type (utils/checkpoint.py JAX_TYPES)")
    return name


def _encode(obj: Any, path: str, arrays: dict[str, np.ndarray]):
    """Structure manifest for ``obj``; arrays go out-of-band under
    sequential keys (tree paths can collide, so they appear only in the
    manifest)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        key = f"arr_{len(arrays)}"
        arrays[key] = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)
        return {_ARR: key, "path": path}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: _encode(getattr(obj, f.name), f"{path}.{f.name}", arrays)
                  for f in dataclasses.fields(obj)}
        return {"__dataclass__": _type_name(obj, path), "fields": fields}
    if _is_namedtuple(obj):
        fields = {name: _encode(val, f"{path}.{name}", arrays)
                  for name, val in zip(obj._fields, obj)}
        return {"__namedtuple__": _type_name(obj, path), "fields": fields}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"only string dict keys are checkpointable at {path}")
        return {"__dict__": {k: _encode(v, f"{path}.{k}", arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        kind = "__list__" if isinstance(obj, list) else "__tuple__"
        return {kind: [_encode(v, f"{path}[{i}]", arrays) for i, v in enumerate(obj)]}
    raise TypeError(f"cannot checkpoint {type(obj).__name__} at {path!r}")


def _resolve(qualname: str) -> type:
    """The port's class for a manifest's ``module:QualName``. Only the
    names of :data:`JAX_TYPES` resolve: a manifest is data, and letting
    it import arbitrary modules would make loading a checkpoint
    equivalent to executing it."""
    mod, _, name = qualname.partition(":")
    if mod.split(".", 1)[0] != _JAX_PKG:
        raise ValueError(f"checkpoint references type {qualname!r} outside {_JAX_PKG!r}; "
                         "refusing to import it")
    port = JAX_TYPES.get(f"{mod.split('.', 1)[-1]}:{name}")
    if port is None:
        raise ValueError(f"checkpoint references {qualname!r}, which is not a checkpointable "
                         "record type; refusing")
    return _port_class(*port)


def _decode(spec: Any, arrays) -> Any:
    if not isinstance(spec, dict):
        return spec
    if _ARR in spec:
        return arrays[spec[_ARR]]
    for kind in ("__dataclass__", "__namedtuple__"):
        if kind in spec:
            cls = _resolve(spec[kind])
            return cls(**{k: _decode(v, arrays) for k, v in spec["fields"].items()})
    if "__dict__" in spec:
        return {k: _decode(v, arrays) for k, v in spec["__dict__"].items()}
    if "__list__" in spec:
        return [_decode(v, arrays) for v in spec["__list__"]]
    if "__tuple__" in spec:
        return tuple(_decode(v, arrays) for v in spec["__tuple__"])
    raise ValueError(f"unrecognized checkpoint spec {spec!r}")


def _npz_path(path: str) -> str:
    # np.savez appends '.npz' when missing but np.load does not.
    return path if path.endswith(".npz") else path + ".npz"


def _content_digest(manifest_bytes: bytes, arrays: dict[str, np.ndarray]) -> str:
    """SHA-256 over the manifest and every array's name, dtype, shape and
    raw bytes in sorted key order: the content, not the zip container."""
    h = hashlib.sha256()
    h.update(manifest_bytes)
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def save_fitted(path: str, obj: Any) -> None:
    """Write ``obj`` to one compressed ``.npz`` (extension appended if
    missing), atomically, with the content digest embedded."""
    path = _npz_path(path)
    arrays: dict[str, np.ndarray] = {}
    manifest = _encode(obj, "root", arrays)
    manifest_bytes = json.dumps(manifest).encode()
    digest = _content_digest(manifest_bytes, arrays)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **{_MANIFEST: np.frombuffer(manifest_bytes, dtype=np.uint8),
                                      _DIGEST: np.frombuffer(digest.encode(), dtype=np.uint8)},
                                **arrays)
            f.flush()
            os.fsync(f.fileno())
        inj = chaos.active()
        if inj is not None:
            cut = inj.truncate_npz(os.path.getsize(tmp), site=path)
            if cut is not None:
                os.truncate(tmp, cut)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_fitted(path: str, device=None, verify: bool = True) -> Any:
    """Restore an object written by :func:`save_fitted` in either
    package. ``device``: where the arrays go, as tensors (None or True:
    ``cuda``, as every entry point of the port; ``"cpu"`` or a
    ``torch.device``), or False for host numpy arrays throughout.

    ``verify=True`` recomputes the embedded SHA-256 and raises
    :class:`CheckpointCorrupt`, naming ``path``, on a mismatch, an
    unreadable or torn archive, or a missing manifest."""
    path = _npz_path(path)
    dev = None if device is False else resolve_device(None if device is True else device)
    try:
        with np.load(path) as z:
            manifest_bytes = bytes(z[_MANIFEST])
            stored = bytes(z[_DIGEST]).decode() if _DIGEST in z.files else None
            arrays = {k: z[k] for k in z.files if k not in (_MANIFEST, _DIGEST)}
        manifest = json.loads(manifest_bytes.decode())
    except FileNotFoundError:
        raise
    except Exception as e:  # zipfile / zlib / KeyError / json: a torn or foreign file
        raise CheckpointCorrupt(path, f"unreadable archive ({e})") from e
    if verify:
        if stored is not None:
            actual = _content_digest(manifest_bytes, arrays)
            if actual != stored:
                raise CheckpointCorrupt(path, f"content digest mismatch (stored {stored[:12]}…, "
                                              f"archive hashes to {actual[:12]}…)")
        else:
            _events.emit("checkpoint_unverified", status="warning", path=path,
                         reason="no embedded digest")
    if dev is not None:
        arrays = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    return _decode(manifest, arrays)
