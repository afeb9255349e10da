"""The port's command-line tools where JAX is absent: ``python -m
ate_replication_causalml_torch.observability.promtext``,
``scripts/torch_loadgen.py`` and ``scripts/torch_serve_client.py``, each
run in a subprocess whose ``PYTHONPATH`` shadows ``jax`` with a package
that raises on import (the daemons they start inherit it), against
daemons of the port on the CPU (``--device cpu``).

Contracts: the promtext text is byte-identical to the JAX package's
``promtext.main`` on the same snapshot (stdout and file); the loadgen
record has the JAX package's ``scripts/loadgen.py`` record keys (top
level and ``server``), both scripts replaying one seeded schedule
against one port daemon, and ``--spawn --device cpu`` serves every
request over a stdio daemon; the client prints the JAX client's lines
and exits 0 (zero-compile window).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.utils.checkpoint import save_fitted
from ate_replication_causalml_tpu.observability import promtext as jprom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
LOADGEN_FLAGS = ["--features", str(P), "--requests", "24", "--seed", "7", "--rate", "400",
                 "--mix", "1:4,8:2,32:1"]


@pytest.fixture(scope="module")
def no_jax(tmp_path_factory):
    """An environment in which ``import jax`` raises."""
    block = tmp_path_factory.mktemp("block")
    (block / "jax").mkdir()
    (block / "jax" / "__init__.py").write_text("raise ImportError('jax is absent here')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(block), REPO]))
    out = subprocess.run([sys.executable, "-c", "import jax"], env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode != 0 and "jax is absent here" in out.stderr
    return env


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    rng = np.random.default_rng(23)
    n = 240
    x = torch.as_tensor(rng.normal(size=(n, P)).astype(np.float32))
    wt = torch.as_tensor((rng.random(n) - 0.5).astype(np.float32))
    yt = (1.0 + x[:, 0]) * wt + 0.3 * torch.as_tensor(rng.normal(size=n).astype(np.float32))
    forest = tcf.grow_causal_forest(x, wt, yt, rnd.key(4, device="cpu"), n_trees=4, depth=3,
                                    n_bins=16)
    path = str(tmp_path_factory.mktemp("ckpt") / "forest.npz")
    save_fitted(path, forest)
    return path


def _snapshot():
    """A registry snapshot with every section, labels needing escapes."""
    return {
        "counters": {"requests_total": {"": 12.0, 'model=a"b,bucket=8': 3.0},
                     "kernel builds": {"lib=hist": 2.0}},
        "gauges": {"queue_depth": {"": 0.5}, "serving_port": {"model=x\\y": 7777.0}},
        "histograms": {"latency_s": {"bucket=1": {"count": 4, "sum": 0.125, "min": 0.01,
                                                   "max": 0.07}}},
        "bucket_histograms": {"wait_s": {"": {"bounds": [0.001, 0.01, 0.1],
                                              "buckets": [1, 2, 0], "count": 4, "sum": 0.31}}},
    }


def test_promtext_cli_byte_identical_to_jax(tmp_path, no_jax):
    snap = tmp_path / "metrics.json"
    snap.write_text(json.dumps(_snapshot()))
    cmd = [sys.executable, "-m", "ate_replication_causalml_torch.observability.promtext",
           str(snap)]
    got = subprocess.run(cmd, env=no_jax, capture_output=True, timeout=120)
    assert got.returncode == 0, got.stderr.decode()
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        assert jprom.main([str(snap)]) == 0
    assert got.stdout == want.getvalue().encode() and b"ate_tpu_requests_total" in got.stdout
    mine, ref = tmp_path / "mine.prom", tmp_path / "ref.prom"
    assert subprocess.run(cmd + [str(mine)], env=no_jax, timeout=120).returncode == 0
    assert jprom.main([str(snap), str(ref)]) == 0
    assert mine.read_bytes() == ref.read_bytes()
    usage = subprocess.run(cmd[:3], env=no_jax, capture_output=True, timeout=120)
    assert usage.returncode == 2 and b"promtext" in usage.stderr


@contextlib.contextmanager
def _tcp_daemon(checkpoint, env, log):
    """A port daemon on the CPU on an ephemeral TCP port → its port."""
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ate_replication_causalml_torch.serving", "--checkpoint",
             checkpoint, "--port", "0", "--device", "cpu", "--buckets", "1,8,32"],
            env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + 120
        port = None
        while port is None:
            assert proc.poll() is None and time.monotonic() < deadline, open(log).read()
            for line in open(log).read().splitlines():
                if line.startswith("# serving on "):
                    port = int(line.rsplit(":", 1)[1])
            time.sleep(0.1)
        yield port
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def _run(cmd, env):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out


def test_loadgen_and_client_against_a_cpu_daemon(checkpoint, no_jax, tmp_path):
    """One port daemon, both packages' loadgen and client scripts: the
    port's run with jax absent and print the JAX scripts' keys and lines."""
    with _tcp_daemon(checkpoint, no_jax, tmp_path / "daemon.log") as port:
        target = ["--connect", f"127.0.0.1:{port}", "--concurrency", "2"]
        mine = json.loads(_run([sys.executable, os.path.join(REPO, "scripts", "torch_loadgen.py"),
                                *target, *LOADGEN_FLAGS], no_jax).stdout.splitlines()[-1])
        ref = json.loads(_run([sys.executable, os.path.join(REPO, "scripts", "loadgen.py"),
                               *target, *LOADGEN_FLAGS, "--id-prefix", "j"],
                              os.environ).stdout.splitlines()[-1])
        assert sorted(mine) == sorted(ref)
        assert sorted(mine["server"]) == sorted(ref["server"])
        for k in ("transport", "seed", "mix"):
            assert mine[k] == ref[k], k
        client = ["--port", str(port), "-n", "12", "--rows", "1,8", "--features", str(P)]
        lines = [_run([sys.executable, os.path.join(REPO, "scripts", script), *client],
                      env).stdout.splitlines()
                 for script, env in (("torch_serve_client.py", no_jax),
                                     ("serve_client.py", os.environ))]
        for got, want in zip(*lines):
            assert got.split(":")[0].split("=")[0] == want.split(":")[0].split("=")[0]
        assert len(lines[0]) == len(lines[1]) and lines[0][-1] == "# zero-compile window: OK"


def test_loadgen_spawns_a_cpu_stdio_daemon(checkpoint, no_jax):
    out = _run([sys.executable, os.path.join(REPO, "scripts", "torch_loadgen.py"), "--spawn",
                "--checkpoint", checkpoint, "--device", "cpu", "--buckets", "1,8,32",
                *LOADGEN_FLAGS], no_jax)
    record = json.loads(out.stdout.splitlines()[-1])
    assert record["transport"] == "stdio" and record["seed"] == 7
    assert record["server"]["compile_events_in_window"] == 0
    assert "jax is absent here" not in out.stderr
