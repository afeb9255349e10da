"""The port's merged fleet artifacts against the JAX package's, on the CPU.

* The committed ``tests/data/fleet_dump`` (a JAX package micro fleet's
  dump): the port's ``write_fleet_artifacts`` on a copy reproduces the
  committed ``fleet_trace.json``, ``fleet_report.json`` and
  ``fleet_stat_health.json`` byte for byte, and
  ``python -m ate_replication_causalml_torch.observability.fleet_report
  <dump> --check`` passes; a tampered artifact fails the check (exit 1)
  and a directory without a manifest is refused (exit 2), as the JAX
  package's ``scripts/fleet_report.py`` does.
* The three builders equal the JAX package's on variants of that dump: a
  daemon that did not dump, a router without a trace, a daemon without
  metrics, orphan spans on both sides, incompatible sketches.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from ate_replication_causalml_torch.observability import fleet_report as tfr
from ate_replication_causalml_tpu.observability import fleet_report as jfr

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DUMP = os.path.join(_REPO, "tests", "data", "fleet_dump")
NAMES = (tfr.FLEET_TRACE_BASENAME, tfr.FLEET_REPORT_BASENAME, tfr.FLEET_STAT_HEALTH_BASENAME)


def _copy(tmp_path, name: str = "fleet_dump") -> str:
    dst = str(tmp_path / name)
    shutil.copytree(_DUMP, dst)
    return dst


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_write_fleet_artifacts_reproduces_the_committed_dump(tmp_path):
    dst = _copy(tmp_path)
    committed = {n: _bytes(os.path.join(_DUMP, n)) for n in NAMES}
    paths = tfr.write_fleet_artifacts(dst)
    assert [os.path.basename(p) for p in paths] == list(NAMES)
    for n in NAMES:
        assert _bytes(os.path.join(dst, n)) == committed[n], n
    assert (tfr.FLEET_REPORT_SCHEMA_VERSION, tfr.MAX_ORPHAN_IDS) == (
        jfr.FLEET_REPORT_SCHEMA_VERSION, jfr.MAX_ORPHAN_IDS)


def _run(*args, cwd=_REPO):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=120, cwd=cwd)


def test_check_entry_point_passes_and_fails_like_the_jax_script(tmp_path):
    dst = _copy(tmp_path)
    proc = _run("-m", "ate_replication_causalml_torch.observability.fleet_report", dst, "--check")
    assert proc.returncode == 0, proc.stderr
    assert "byte-identical" in proc.stdout
    with open(os.path.join(dst, tfr.FLEET_REPORT_BASENAME)) as f:
        rep = json.load(f)
    assert rep["requests"]["matched"] == rep["requests"]["router_spans"] > 0
    assert rep["requests"]["orphan_router"] == rep["requests"]["orphan_daemon"] == 0
    for tool in (["-m", "ate_replication_causalml_torch.observability.fleet_report"],
                 [os.path.join(_REPO, "scripts", "fleet_report.py")]):
        bad = _copy(tmp_path, f"tampered{len(tool)}")
        with open(os.path.join(bad, tfr.FLEET_STAT_HEALTH_BASENAME), "a") as f:
            f.write(" ")
        proc = _run(*tool, bad, "--check")
        assert proc.returncode == 1 and tfr.FLEET_STAT_HEALTH_BASENAME in proc.stderr
        proc = _run(*tool, str(tmp_path), "--check")
        assert proc.returncode == 2 and "not a fleet dump" in proc.stderr


def _edit_json(path: str, fn) -> None:
    with open(path) as f:
        obj = json.load(f)
    obj = fn(obj) or obj
    with open(path, "w") as f:
        json.dump(obj, f)


def _undumped(d):
    _edit_json(os.path.join(d, "fleet_manifest.json"),
               lambda m: m["backends"]["b0"].update(dumped=False))


def _no_router_trace(d):
    os.remove(os.path.join(d, "router", "trace.json"))


def _no_metrics(d):
    os.remove(os.path.join(d, "daemon-b1", "metrics.json"))


def _orphans(d):
    def drop_daemon_span(trace):
        evs = trace["traceEvents"]
        i = next(k for k, e in enumerate(evs) if e.get("name") == "serving_request")
        extra = dict(evs[i], args=dict(evs[i]["args"], request_id="ghost"))
        del evs[i]
        evs.append(extra)

    _edit_json(os.path.join(d, "daemon-b1", "trace.json"), drop_daemon_span)
    _edit_json(os.path.join(d, "fleet_manifest.json"),
               lambda m: m["router"]["requests"].update({"b0": {"ok": 99}}))


def _incompatible_sketch(d):
    def bump(rep):
        models = rep["state"]["models"]
        ch = next(iter(models[next(iter(models))]["channels"].values()))
        ch["total"]["n_bins"] = ch["total"]["n_bins"] + 1

    _edit_json(os.path.join(d, "daemon-b0", "stat_health.json"), bump)


VARIANTS = {"as_committed": None, "undumped": _undumped, "no_router_trace": _no_router_trace,
            "no_metrics": _no_metrics, "orphans": _orphans,
            "incompatible_sketch": _incompatible_sketch}


@pytest.mark.parametrize("variant", VARIANTS)
def test_builders_equal_jax(tmp_path, variant):
    d = _copy(tmp_path)
    if VARIANTS[variant] is not None:
        VARIANTS[variant](d)
    dump_t, dump_j = tfr.load_fleet_dump(d), jfr.load_fleet_dump(d)
    assert dump_t == dump_j
    assert tfr.build_fleet_trace(dump_t) == jfr.build_fleet_trace(dump_j)
    assert tfr.build_fleet_report(dump_t) == jfr.build_fleet_report(dump_j)
    for objective in (0.9, 0.5):
        assert tfr.build_fleet_stat_health(dump_t, objective) == \
            jfr.build_fleet_stat_health(dump_j, objective)
    jcopy = str(tmp_path / "jax")
    shutil.copytree(d, jcopy)
    tfr.write_fleet_artifacts(d)
    jfr.write_fleet_artifacts(jcopy)
    for n in NAMES:
        assert _bytes(os.path.join(d, n)) == _bytes(os.path.join(jcopy, n)), n


def test_load_refuses_a_directory_without_a_manifest(tmp_path):
    with pytest.raises(ValueError) as te:
        tfr.load_fleet_dump(str(tmp_path))
    with pytest.raises(ValueError) as je:
        jfr.load_fleet_dump(str(tmp_path))
    assert str(te.value) == str(je.value)
