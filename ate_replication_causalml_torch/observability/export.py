"""Exporters: atomic file writes and the metrics.json / events.jsonl /
metrics.prom trio.

Port of ``ate_replication_causalml_tpu/observability/export.py``. Every
artifact the sweep writes beside its journal goes through
:func:`atomic_write_text` (a temporary file in the target directory,
fsynced, then ``os.replace``d), so a kill mid-write never leaves a
truncated ``report.json`` or ``metrics.json`` beside a valid
``results.jsonl``. :func:`write_run_artifacts` is the sweep's one call:
``metrics.json``, ``events.jsonl`` and the Prometheus textfile, in the
JAX package's layout and schema version.
"""

from __future__ import annotations

import json
import os
import stat
import threading

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry

METRICS_BASENAME = "metrics.json"
EVENTS_BASENAME = "events.jsonl"
PROMTEXT_BASENAME = "metrics.prom"


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically: a temporary file in the
    same directory (``os.replace`` must not cross filesystems), fsynced,
    renamed over ``path``. The file gets the mode a plain ``open(path,
    "w")`` would: an existing file keeps its own, a new one 0o666 under
    the umask."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.{os.getpid()}.{threading.get_ident()}.tmp")
    fd = os.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o666)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
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


def atomic_write_json(path: str, obj) -> None:
    atomic_write_text(path, json.dumps(obj, indent=1) + "\n")


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
