"""The port's multi-GPU layer on gloo ranks on the CPU: the world
(``parallel/multihost.py``), meshes (``parallel/mesh.py``), the metered
artifact plane (``parallel/shardio.py``, held to
``tests/test_shardio.py``'s contract at 1, 2 and 4 ranks), a declared
layout in the nuisance cache, and classified retry (``parallel/retry.py``).

Each spawning test bounds its world with ``timeout=`` and joins its
ranks under a deadline (``parallel/spawn.py`` kills them past it).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from ate_replication_causalml_torch.parallel import mesh as pm
from ate_replication_causalml_torch.parallel import multihost as mh
from ate_replication_causalml_torch.parallel import shardio
from ate_replication_causalml_torch.parallel.retry import (
    inject_failures,
    require_all,
    run_shards,
)
from ate_replication_causalml_torch.parallel.spawn import run_ranks
from ate_replication_causalml_torch.resilience.errors import ChaosShardFault, DeadlineExceeded

TIMEOUT = 60.0
N = 64


def _vals(n: int = N) -> dict:
    rng = np.random.default_rng(3)
    return {"vec": rng.standard_normal(n).astype(np.float32),
            "mat": rng.standard_normal((n, 3)).astype(np.float64),
            "ids": rng.integers(0, 1 << 30, n).astype(np.int64)}


# ── world and meshes ──────────────────────────────────────────────────


def test_init_multihost_noop_and_misconfiguration(monkeypatch):
    assert mh.init_multihost(num_processes=1) is False
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mh.init_multihost() is False                 # no launcher: one process
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mh.init_multihost() is False
    with pytest.raises(ValueError, match="together"):
        mh.init_multihost(coordinator_address="127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="outside"):
        mh.init_multihost("127.0.0.1:1", 2, 5, device="cpu")
    with pytest.raises(ValueError, match="only 'gloo'"):
        mh.init_multihost("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    # A CUDA rank without a card raises; nothing falls back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.init_multihost("127.0.0.1:1", 2, 0)
    # Two ranks on one card: NCCL refuses, so the call raises unless gloo
    # is named; with gloo both ranks take the one card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="share"):
            mh._rank_device_for("cuda", 1, 2, backend)
    assert mh._rank_device_for("cuda", 1, 2, "gloo") == (torch.device("cuda", 0), "gloo")
    assert mh._rank_device_for("cuda", 0, 1, None) == (torch.device("cuda", 0), "nccl")


def test_use_mesh_override_is_thread_confined():
    """A mesh-lane stage's ``use_mesh`` must not leak into ``get_mesh()``
    on another thread (the JAX package's ``test_parallel.py`` contract)."""
    default = pm.get_mesh()
    fold_mesh = pm.make_mesh((pm.FOLD_AXIS,))
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def laned():
        with pm.use_mesh(fold_mesh):
            seen["laned"] = pm.get_mesh()
            inside.set()
            release.wait(10)
        seen["laned_after"] = pm.get_mesh()

    t = threading.Thread(target=laned)
    t.start()
    try:
        assert inside.wait(10)
        assert pm.get_mesh() is default
    finally:
        release.set()
        t.join(10)
    assert seen["laned"] is fold_mesh and seen["laned_after"] is default
    # No process group: a mesh of axis sizes 1 whose collectives are
    # identities, and the world is one rank that writes.
    assert fold_mesh.shape == {"fold": 1} and fold_mesh.group("fold") is None
    x = torch.arange(3.0)
    assert pm.all_gather_cat(x, fold_mesh, "fold") is x
    assert pm.world_size() == 1 and pm.is_writer()
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pm.make_mesh(("boot", "data"), (2, 1))


def test_worlds_join_and_pod_mesh_layout():
    """Two gloo ranks join from explicit arguments; on four ranks
    ``make_pod_mesh`` lays replicates across slices and rows within one."""
    got = run_ranks(bodies.world_body, 2, timeout=TIMEOUT)
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["size"] == 2 and g["backend"] == "gloo" and g["device"] == "cpu"
               and g["again"] is True for g in got)
    pod = run_ranks(bodies.pod_mesh_body, 4, args=(2,), timeout=TIMEOUT)
    assert [p["shape"] for p in pod] == [{"boot": 2, "data": 2}] * 4
    assert [p["coords"] for p in pod] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [p["data_group"] for p in pod] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [p["boot_group"] for p in pod] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert not any(p["warned"] for p in pod)


# ── the artifact plane ───────────────────────────────────────────────


def _check_shardio(out: dict, world: int) -> None:
    vals = _vals()
    assert out["world"] == world and out["layouts_ok"] and out["uneven_replicated"]
    for got in (out["host"], out["back"]):
        for k, v in vals.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    pad = out["padded"]
    n = 1001
    padded = shardio.pad_to_multiple(n, world)
    assert pad["n"] == n and pad["rows"] == [padded, padded]
    assert pad["local_rows"] == [padded // world] * 2
    np.testing.assert_array_equal(pad["mask"], shardio.row_mask(n, padded))
    for k, v in _vals(n).items():
        if k == "ids":
            continue
        assert np.array_equal(pad["back"][k], v)
    assert pad["back_readonly"]
    assert out["masked_sum"] == out["ints_sum"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shardio_round_trips_bit_identical(world):
    """Commit, gather, reshard away and back, and the padded row shard
    round-trip bit for bit (dtype included) at 1, 2 and 4 ranks; the
    masked sum over padded shards is the unpadded sum exactly."""
    vals = _vals()
    padded_vals = {k: v for k, v in _vals(1001).items() if k != "ids"}
    if world == 1:
        outs = [bodies.shardio_body(vals, padded_vals)]   # no process group
    else:
        outs = run_ranks(bodies.shardio_body, world, args=(vals, padded_vals), timeout=TIMEOUT)
    for out in outs:
        _check_shardio(out, world)
    if world == 1:
        return
    calls = outs[0]["calls"]
    assert calls.get("artifact=once,status=upload") == 1
    assert calls.get("artifact=once,status=compiled") == 1
    assert calls.get("artifact=once,status=cached") == 1
    assert calls.get("artifact=once,status=noop") == 1
    nbytes = 2048 * 4
    # Each rank meters what it moves: its rows up, the whole array back.
    assert sum(o["bytes"]["artifact=bytes_t,path=host_upload"] for o in outs) == nbytes
    for o in outs:
        b = o["bytes"]
        assert b["artifact=bytes_t,path=device_handoff"] == nbytes
        assert b["artifact=bytes_t,path=host_gather"] == nbytes
        assert b["artifact=bytes_t,path=device_reshard"] == nbytes   # the gather's all-gather
        assert b["artifact=bytes_t,path=host_bounce"] == 2 * nbytes
        assert np.array_equal(o["bytes_host"], np.arange(2048, dtype=np.float32))
        assert np.array_equal(o["bytes_bounced"], np.arange(2048, dtype=np.float32))
        assert o["host_writable"] is False


def test_row_sharding_and_pad_units():
    mesh = pm.make_mesh((pm.DATA_AXIS,))
    assert shardio.row_sharding(mesh, 7) == pm.row_sharded(mesh, pm.DATA_AXIS)
    assert [shardio.pad_to_multiple(n, k) for n, k in
            ((0, 8), (1, 8), (8, 8), (9, 8), (1001, 8), (7, 1))] == [8, 8, 8, 16, 1008, 7]
    with pytest.raises(ValueError, match="disagree"):
        shardio.pad_rows((np.zeros(3), np.zeros(4)), 8)
    for nb in (1, 4096, 1 << 22):
        assert shardio.edge_byte_plan(nb, "mesh", "mesh") == {
            "host_bytes": 0, "device_bytes": nb, "legacy_host_bytes": 2 * nb}
        for producer, consumer in (("mesh", None), (None, None), ("mesh", "other")):
            assert shardio.edge_byte_plan(nb, producer, consumer) == {
                "host_bytes": nb, "device_bytes": 0, "legacy_host_bytes": 2 * nb}


def test_sharded_artifact_fit_once_and_handed_whole():
    """A laned artifact declared row-sharded, on two ranks: fit once a
    rank, and every consumer (undeclared, "host", "device") gets the
    fit's tensor itself. Every rank computes it whole, so the shard
    plane moves nothing: no collective, no metered byte."""
    raw = np.arange(4096, dtype=np.float32)
    outs = run_ranks(bodies.cache_body, 2, args=(raw,), timeout=TIMEOUT)
    for o in outs:
        assert o["moved"] == {} and o["fits"] == 1 and o["all_the_fit"]
        assert np.array_equal(o["u1"], raw)


# ── classified retry ──────────────────────────────────────────────────


def test_run_shards_deadline_cuts_and_keeps_done_work():
    import time as _time

    def slow(i):
        _time.sleep(0.06)
        return i

    outs = run_shards(slow, 4, max_attempts=2, backoff_s=0.0, deadline_s=0.05, pool="dl")
    assert outs[0].ok and [o.ok for o in outs[1:]] == [False] * 3
    assert all(o.deadline and "DeadlineExceeded" in o.error and o.attempts == 0
               for o in outs[1:])
    with pytest.raises(DeadlineExceeded, match="3/4 shards failed"):
        require_all(outs)
    slept = []
    import ate_replication_causalml_torch.parallel.retry as retry_mod

    real = retry_mod.time.sleep
    retry_mod.time.sleep = slept.append
    try:
        outs = run_shards(inject_failures(lambda i: i, {0: 9}), 1, max_attempts=9,
                          backoff_s=10.0, deadline_s=0.5)
    finally:
        retry_mod.time.sleep = real
    assert not outs[0].ok and outs[0].attempts == 1 and slept == []


def test_run_shards_redispatch_and_retriable():
    def dying(i):
        raise ChaosShardFault("device lost")

    probes, redispatched = [], []

    def probe():
        probes.append(True)
        return ["cuda:0"]

    def redispatch(healthy):
        redispatched.append(list(healthy))
        return lambda i: ("healthy", i)

    outs = run_shards(dying, 3, max_attempts=3, backoff_s=0.0, probe=probe,
                      redispatch=redispatch)
    assert probes and redispatched == [["cuda:0"]]
    assert [o.result for o in outs] == [("healthy", i) for i in range(3)]

    # An explicit retriable tuple is opt-in: listed types retry, others
    # raise at once (even a type classify() would call transient).
    flaky = inject_failures(lambda i: i, {0: 1})
    assert require_all(run_shards(flaky, 2, backoff_s=0.0, retriable=(RuntimeError,))) == [0, 1]

    def bad(i):
        raise OSError("not listed")

    with pytest.raises(OSError):
        run_shards(bad, 1, backoff_s=0.0, retriable=(KeyError,))
