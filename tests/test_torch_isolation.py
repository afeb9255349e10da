"""The torch package, chip_smoke.py and scripts/torch_stage_time_1m.py
import neither JAX nor the JAX package (nor triton): checked in a fresh
interpreter that imports every module of the port, and in one that
imports only the public surface.
Also the port's ``atomic_file``, the tmp-then-rename writer every
artifact goes through."""

import os
import stat
import subprocess
import sys

import pytest

from ate_replication_causalml_torch.observability import atomic_file

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = "ate_replication_causalml_torch"


def _port_modules() -> list[str]:
    mods = []
    root = os.path.join(_REPO, _PKG)
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, _REPO).replace(os.sep, ".")
        for f in sorted(files):
            if f.endswith(".py"):
                mods.append(rel if f == "__init__.py" else f"{rel}.{f[:-3]}")
    return sorted(mods)


def test_port_lists_its_modules():
    mods = _port_modules()
    for m in ("ops.random", "ops.hist", "ops.tree", "models.forest", "kernels.build",
              "estimators.aipw", "data.pipeline", "models.causal_forest",
              "estimators.causal_forest_est", "ops.pack", "ops.linalg", "estimators.dml",
              "estimators.ols", "estimators.ipw", "ops.lasso", "estimators.lasso_est",
              "estimators.belloni", "ops.qp", "estimators.balance", "pipeline", "viz",
              "scheduler", "scheduler.dag", "scheduler.cache", "scheduler.engine",
              "scheduler.prefetch", "observability", "observability.registry",
              "observability.events", "resilience", "resilience.watchdog",
              "observability.export", "observability.promtext", "observability.device",
              "observability.trace", "observability.critical_path", "resilience.errors",
              "resilience.backoff", "resilience.chaos", "parallel",
              "parallel.retry", "utils.profiling", "utils.checkpoint", "resilience.deadline",
              "observability.slo", "serving", "serving.protocol", "serving.admission",
              "serving.coalescer", "serving.fleet", "serving.daemon", "serving.client",
              "serving.__main__", "observability.sketch", "observability.stathealth",
              "observability.serving_report", "serving.admin", "serving.retrain",
              "serving.loadgen", "serving.router", "observability.fleet_report",
              "scenarios", "scenarios.dgp", "scenarios.batched", "scenarios.aggregate",
              "scenarios.matrix", "scenarios.frontier", "scenarios.__main__",
              "resilience.campaign", "resilience.invariants", "parallel.mesh",
              "parallel.multihost", "parallel.shardio", "parallel.spawn", "parallel.dryrun",
              "models.plan", "rbridge", "native", "analysis", "analysis.core",
              "analysis.scopes", "analysis.cache", "analysis.reporters", "analysis.torchast",
              "analysis.rules", "analysis.concurrency", "analysis.concurrency.extract",
              "analysis.concurrency.flow", "analysis.concurrency.model",
              "analysis.concurrency.rules"):
        assert f"{_PKG}.{m}" in mods


def test_port_and_chip_smoke_import_no_jax():
    code = "\n".join([
        "import importlib, sys",
        f"sys.path.insert(0, {_REPO!r})",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "import importlib.util",
        "spec = importlib.util.spec_from_file_location('torch_stage_time_1m', "
        f"{os.path.join(_REPO, 'scripts', 'torch_stage_time_1m.py')!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'ate_replication_causalml_tpu')",
        "       if m in sys.modules]",
        "assert not bad, f'imported: {bad}'",
        "import torch",
        "assert torch.backends.cuda.matmul.allow_tf32 is False",
        "assert torch.backends.cudnn.allow_tf32 is False",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """On a machine without CUDA the smoke script exits non-zero and
    prints no result line."""
    proc = subprocess.run([sys.executable, os.path.join(_REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script cannot import the port and fails."""
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    proc = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_public_surface_imports_no_jax_and_starts_no_cuda():
    """The JAX package's import lines, pointed at the port: the estimators,
    the package's result records, observability and serving (their lazy
    names included) load no jax and leave CUDA uninitialised."""
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {_REPO!r})",
        "from ate_replication_causalml_torch.estimators import (doubly_robust, double_ml,",
        "    causal_forest_report, EstimatorResult, Z_95)",
        "from ate_replication_causalml_torch import EstimatorResult as E2, ResultTable",
        "import ate_replication_causalml_torch.estimators as est",
        "import ate_replication_causalml_torch.observability as obs",
        "import ate_replication_causalml_torch.serving as srv",
        "for mod in (est, obs, srv):",
        "    for name in mod.__all__:",
        "        getattr(mod, name)",
        "assert E2 is EstimatorResult and srv.RetrainSupervisor.__name__ == 'RetrainSupervisor'",
        "bad = [m for m in ('jax', 'jaxlib', 'ate_replication_causalml_tpu') if m in sys.modules]",
        "assert not bad, f'imported: {bad}'",
        "import torch",
        "assert not torch.cuda.is_initialized()",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr


def test_atomic_file_keeps_the_old_file_on_an_exception(tmp_path):
    path = tmp_path / "report.json"
    path.write_text("old")
    with pytest.raises(RuntimeError):
        with atomic_file(str(path)) as tmp:
            with open(tmp, "w") as f:
                f.write("half a rep")
            raise RuntimeError("killed mid-write")
    assert path.read_text() == "old"
    assert os.listdir(tmp_path) == ["report.json"]


def test_atomic_file_replaces_and_keeps_the_mode(tmp_path):
    path = tmp_path / "report.json"
    path.write_text("old")
    os.chmod(path, 0o600)
    with atomic_file(str(path)) as tmp:
        with open(tmp, "w") as f:
            f.write("new")
    assert path.read_text() == "new"
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    assert os.listdir(tmp_path) == ["report.json"]
