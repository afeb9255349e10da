"""The torch package and chip_smoke.py import neither JAX nor the JAX
package (nor triton): checked in a fresh interpreter that imports every
module of the port."""

import os
import subprocess
import sys

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
              "serving.__main__"):
        assert f"{_PKG}.{m}" in mods


def test_port_and_chip_smoke_import_no_jax():
    code = "\n".join([
        "import importlib, sys",
        f"sys.path.insert(0, {_REPO!r})",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
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
