"""Prometheus textfile exporter.

Port of ``ate_replication_causalml_tpu/observability/promtext.py``:
renders the registry in the Prometheus text exposition format, so a
run's output directory can be scraped through the node exporter's
textfile collector (``--collector.textfile.directory``). Names carry the
JAX package's ``ate_tpu_`` prefix, so one dashboard reads both packages.
Summary histograms export as ``_count`` / ``_sum`` plus ``_min`` /
``_max``; bucketed histograms as Prometheus histograms, cumulative
``_bucket{le=...}`` lines ending at ``+Inf`` == ``_count``.
"""

from __future__ import annotations

import re

from ate_replication_causalml_torch.observability import registry as _registry
from ate_replication_causalml_torch.observability.export import atomic_write_text

_NAME_SAFE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "ate_tpu_"


def _prom_name(name: str) -> str:
    return _PREFIX + _NAME_SAFE.sub("_", name)


def _prom_labels(label_key: str) -> str:
    """Registry label key (``k=v,k2=v2``) → ``{k="v",k2="v2"}``."""
    if not label_key:
        return ""
    parts = []
    for pair in label_key.split(","):
        k, _, v = pair.partition("=")
        v = v.replace("\\", r"\\").replace('"', r"\"")
        parts.append(f'{_NAME_SAFE.sub("_", k)}="{v}"')
    return "{" + ",".join(parts) + "}"


def _labels_with_le(label_key: str, le: str) -> str:
    """Registry label key plus the Prometheus ``le`` bucket label."""
    base = _prom_labels(label_key)
    pair = f'le="{le}"'
    return "{" + pair + "}" if not base else base[:-1] + "," + pair + "}"


def render_prom_from_snapshot(snap: dict) -> str:
    """The exposition text of a registry snapshot (``metrics.json``)."""
    lines: list[str] = []
    for kind, ptype in (("counters", "counter"), ("gauges", "gauge")):
        for name, samples in sorted(snap.get(kind, {}).items()):
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {ptype}")
            for key, val in sorted(samples.items()):
                lines.append(f"{pname}{_prom_labels(key)} {val!r}")
    for name, samples in sorted(snap.get("histograms", {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} summary")
        for key, s in sorted(samples.items()):
            lb = _prom_labels(key)
            for stat in ("count", "sum", "min", "max"):
                lines.append(f"{pname}_{stat}{lb} {s[stat]!r}")
    for name, samples in sorted(snap.get("bucket_histograms", {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for key, s in sorted(samples.items()):
            cum = 0
            for bound, c in zip(s["bounds"], s["buckets"]):
                cum += c
                lines.append(f"{pname}_bucket{_labels_with_le(key, repr(bound))} {cum}")
            lines.append(f"{pname}_bucket{_labels_with_le(key, '+Inf')} {s['count']}")
            lb = _prom_labels(key)
            lines.append(f"{pname}_sum{lb} {s['sum']!r}")
            lines.append(f"{pname}_count{lb} {s['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_prom_text(registry: _registry.MetricsRegistry | None = None) -> str:
    return render_prom_from_snapshot((registry or _registry.REGISTRY).snapshot())


def write_prom_textfile(path: str, registry: _registry.MetricsRegistry | None = None) -> None:
    """Atomic textfile write: the node exporter reads whole files, and a
    torn one would drop the scrape."""
    atomic_write_text(path, render_prom_text(registry))
