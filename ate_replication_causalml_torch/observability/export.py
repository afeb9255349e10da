"""Exporters: atomic file writes and the metrics.json / events.jsonl /
metrics.prom trio.

Port of ``ate_replication_causalml_tpu/observability/export.py``. Every
artifact the sweep writes beside its journal goes through
:func:`atomic_file` (a temporary file in the target directory, fsynced,
then ``os.replace``d), so a kill mid-write never leaves a
truncated ``report.json`` or ``metrics.json`` beside a valid
``results.jsonl``. :func:`write_run_artifacts` is the sweep's one call:
``metrics.json``, ``events.jsonl`` and the Prometheus textfile, in the
JAX package's layout and schema version.
"""

from __future__ import annotations

import contextlib
import json
import os
import stat
import threading
from typing import Iterator

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry

METRICS_BASENAME = "metrics.json"
EVENTS_BASENAME = "events.jsonl"
PROMTEXT_BASENAME = "metrics.prom"


@contextlib.contextmanager
def atomic_file(path: str) -> Iterator[str]:
    """Yield a temporary path in ``path``'s directory for the caller to
    write (a streaming writer never holds the whole artifact in memory).
    On a clean exit the file is fsynced and ``os.replace``d over
    ``path``; on an exception it is unlinked and ``path`` is left as it
    was. The same directory keeps the rename on one filesystem, so it is
    atomic. The file gets the mode a plain ``open(path, "w")`` would: an
    existing file keeps its own, a new one 0o666 under the umask."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.{threading.get_ident()}.tmp")
    os.close(os.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o666))
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        try:
            os.chmod(tmp, stat.S_IMODE(os.stat(path).st_mode))
        except FileNotFoundError:
            pass
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through :func:`atomic_file`."""
    with atomic_file(path) as tmp:
        with open(tmp, "w") as f:
            f.write(text)


def atomic_write_json(path: str, obj, sort_keys: bool = False) -> None:
    atomic_write_text(path, json.dumps(obj, indent=1, sort_keys=sort_keys) + "\n")


def write_metrics_json(path: str, registry: _registry.MetricsRegistry | None = None) -> dict:
    """Snapshot ``registry`` (default: the global one) to ``path``;
    returns the snapshot."""
    snap = (registry or _registry.REGISTRY).snapshot()
    atomic_write_json(path, snap)
    return snap


def write_events_jsonl(path: str, log: _events.EventLog | None = None) -> None:
    atomic_write_text(path, (log or _events.EVENTS).to_jsonl())


def write_run_artifacts(outdir: str) -> list[str]:
    """Write metrics.json, events.jsonl and metrics.prom into ``outdir``;
    returns their paths."""
    from ate_replication_causalml_torch.observability.promtext import write_prom_textfile

    paths = [os.path.join(outdir, b)
             for b in (METRICS_BASENAME, EVENTS_BASENAME, PROMTEXT_BASENAME)]
    write_metrics_json(paths[0])
    write_events_jsonl(paths[1])
    write_prom_textfile(paths[2])
    return paths
