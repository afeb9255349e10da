"""The port's serving core (``serving/``, ``observability/slo.py``,
``resilience/deadline.py``, the warmed predicts of
``models/causal_forest.py``) against the JAX package's, on the CPU.

* Wire frames of both packages are byte-equal for the same header and
  arrays, and a torn or malformed frame raises the same typed error.
* ``BucketPlan``, ``FusionPlan``, ``Coalescer``, ``AdmissionController``,
  ``ServingLifecycle``, ``ReloadSupervisor`` and the SLO engine give the
  JAX package's decisions and close reasons on the same scripted inputs.
* An in-process port daemon (``device="cpu"``), buckets 4 and 16, serves
  two same-shape models: the JAX serving rig's synthetic forest exactly
  (``"jaxrig"``) and the same split tables with leaf statistics that are
  sums of drawn rows (``"default"``). Over >= 100 requests every served
  row is bit-identical to the port's offline ``predict_cate(oob=False)``
  on the concatenated rows (the port's predict is row-independent bit
  for bit), the default model's within |Δτ̂| <= 1e-6·(1 + |τ̂|) and
  |Δvar| <= 1e-6·(1 + var) of the JAX package's ``predict_cate`` on the
  same forest (the bound of ``tests/test_torch_causal_forest.py``:
  float32 sums in another order), with no kernel build and no graph
  capture in the window and both buckets used. The JAX rig's random leaf
  statistics are not sums of any rows: a leaf's Var(w̃) = Σw̃²/c − (Σw̃/c)²
  can cancel to near 0, where float32 τ̂ keeps ~4 digits in either
  package (the JAX package's own float32 τ̂ is 1.3e-4 from its float64
  τ̂ on one of its rows, the port's 2.0e-5), so that model is held bit
  for bit to the port's offline predict only. Then typed rejects,
  ``serve:`` chaos with bit-identical retried answers, a corrupt
  checkpoint refusing startup, fused buckets, and both packages' clients
  over a socketpair.

The CUDA graph of a warmed predict and the daemon on the card are
held to the eager call in the JAX-free ``tests/test_torch_kernels.py``
(``cuda`` marker, skipped here).
"""

import itertools
import os
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import observability as tobs
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.observability import slo as tslo
from ate_replication_causalml_torch.resilience import chaos as tchaos
from ate_replication_causalml_torch.resilience import deadline as tdeadline
from ate_replication_causalml_torch.resilience.errors import CheckpointCorrupt
from ate_replication_causalml_torch.serving import admission as tadm
from ate_replication_causalml_torch.serving import coalescer as tco
from ate_replication_causalml_torch.serving import protocol as tproto
from ate_replication_causalml_torch.serving.client import CateClient as TClient
from ate_replication_causalml_torch.serving.daemon import (
    CateServer,
    RejectedRequest,
    ServeConfig,
    serve_stream,
)
from ate_replication_causalml_torch.utils.checkpoint import save_fitted
from ate_replication_causalml_tpu import observability as jobs
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.observability import slo as jslo
from ate_replication_causalml_tpu.resilience import deadline as jdeadline
from ate_replication_causalml_tpu.serving import admission as jadm
from ate_replication_causalml_tpu.serving import coalescer as jco
from ate_replication_causalml_tpu.serving import protocol as jproto
from ate_replication_causalml_tpu.serving.client import CateClient as JClient

PKGS = {"jax": (jproto, jco, jadm, jdeadline, jslo, jobs),
        "torch": (tproto, tco, tadm, tdeadline, tslo, tobs)}


# ── wire frames ──────────────────────────────────────────────────────

FRAMES = {
    "header_only": ({"op": "ping"}, None),
    "predict": ({"op": "predict", "id": "r1", "model": "default", "deadline_ms": 12.5},
                {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}),
    "reply": ({"ok": True, "id": "r1", "model": "default", "model_version": 1},
              {"cate": np.linspace(-1, 1, 5, dtype=np.float32),
               "variance": np.full(5, 0.25, np.float32)}),
    "mixed_dtypes": ({"ok": False, "error": "overloaded", "retry_after_s": 0.05},
                     {"i": np.array([1, 2, 3], np.int64), "b": np.array([True, False]),
                      "f64": np.eye(2), "empty": np.zeros((0, 4), np.float32)}),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frames_byte_equal_and_decode_alike(case):
    header, arrays = FRAMES[case]
    buf = tproto.encode_frame(header, arrays)
    assert buf == jproto.encode_frame(header, arrays)
    import io

    got_h, got_a = tproto.read_frame(io.BytesIO(buf))
    want_h, want_a = jproto.read_frame(io.BytesIO(buf))
    assert got_h == want_h and sorted(got_a) == sorted(want_a)
    for k in want_a:
        assert got_a[k].dtype == want_a[k].dtype and np.array_equal(got_a[k], want_a[k])


def _torn(cut):
    buf = tproto.encode_frame({"op": "predict"}, {"x": np.ones((4, 3), np.float32)})
    return buf[:cut] if cut > 0 else buf[:len(buf) + cut]


def _evil(dt):
    return tproto.encode_frame({"arrays": {"x": {"dtype": dt, "shape": [1]}}})


# The JAX package's torn-frame cut points, then its garbage and oversize
# frames: (read or decode, bytes).
BAD_FRAMES = [("read", _torn(c)) for c in (1, 3, 4, 7, -5, -1)] + [
    ("decode", b"\x00\x00\x00\x0a{}"),
    ("decode", b"\x00\x00\x00\x02xy"),
    ("decode", tproto.encode_frame({"a": 1})[4:] + b"zz"),
    ("read", (tproto.MAX_FRAME_BYTES + 1).to_bytes(4, "big")),
    ("read", tproto.encode_frame({"arrays": {"x": {"dtype": "float32",
                                                     "shape": [1000, 1000]}}})),
    ("read", _evil("O")), ("read", _evil("U4")), ("read", _evil("M8[ns]")),
]


@pytest.mark.parametrize("i", range(len(BAD_FRAMES)))
def test_bad_frames_raise_the_same_typed_error(i):
    import io

    how, data = BAD_FRAMES[i]
    errors = []
    for proto in (tproto, jproto):
        with pytest.raises(proto.ProtocolError) as err:
            if how == "read":
                proto.read_frame(io.BytesIO(data))
            else:
                proto.decode_frame(data)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ── pure decisions: the same scripted inputs through both packages ────


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _run_coalescer(pkg: str, plan: str, window_s: float, script) -> list:
    """Drive one package's Coalescer through ``script``; the trace of
    every observable decision."""
    _, co_mod, _, dl_mod, _, _ = PKGS[pkg]
    clock = _Clock()
    expired: list = []
    co = co_mod.Coalescer(co_mod.BucketPlan.parse(plan), window_s, clock=clock,
                          on_expired=lambda reqs, now: expired.append(
                              ([r.request_id for r in reqs], now)))
    trace = []
    for op, *args in script:
        if op == "submit":
            rid, rows, model, budget_s = args
            budget = None if budget_s is None else dl_mod.Budget.after(budget_s, clock=clock)
            try:
                co.submit(co_mod.PendingRequest(rid, None, rows, clock(), model=model,
                                                budget=budget))
            except (ValueError, RuntimeError) as e:
                trace.append(("raise", type(e).__name__, str(e)))
        elif op == "tick":
            clock.t += args[0]
        elif op == "next":
            b = co.next_batch(timeout=0)
            trace.append(None if b is None else (
                [r.request_id for r in b.requests], b.rows, b.bucket, b.fill, b.close_reason,
                b.closed_mono, b.seq, b.model,
                [(r.batch_closed_mono, r.batch_seq, r.batch_bucket, r.batch_fill)
                 for r in b.requests]))
        elif op == "fill":
            trace.append([r.request_id for r in co.take_fill(args[0], args[1], clock())])
        elif op == "close":
            co.close()
        trace.append(("depth", co.pending_depth()))
    return trace + [("expired", expired)]


COALESCER_SCRIPTS = {
    "full_then_window": ("4,16", 1.0, [
        *[("submit", f"r{i}", 4, "", None) for i in range(4)], ("next",),
        ("submit", "small", 6, "", None), ("submit", "big", 14, "", None), ("next",),
        ("next",), ("tick", 1.0), ("next",), ("submit", "last", 1, "", None), ("close",),
        ("next",), ("next",), ("submit", "late", 1, "", None)]),
    "oldest_waiter_window": ("16", 1.0, [
        ("submit", "r0", 2, "", None), ("tick", 0.9), ("submit", "r1", 2, "", None),
        ("next",), ("tick", 0.2), ("next",), ("submit", "big", 17, "", None)]),
    "models_and_fill": ("1,8,64,256", 0.002, [
        ("submit", "a0", 3, "a", None), ("submit", "b0", 100, "b", None),
        ("submit", "a1", 17, "a", None), ("submit", "b1", 200, "b", None),
        ("next",), ("fill", "a", 40), ("tick", 0.002), ("next",), ("next",),
        ("submit", "a2", 256, "a", None), ("next",), ("fill", "b", 0)]),
    "deadlines": ("4,16", 0.5, [
        ("submit", "d0", 3, "", 0.1), ("submit", "d1", 2, "", None),
        ("submit", "d2", 1, "", 5.0), ("tick", 0.2), ("next",), ("fill", "", 16),
        ("tick", 0.4), ("next",), ("submit", "d3", 4, "", 0.0), ("next",)]),
}


@pytest.mark.parametrize("case", sorted(COALESCER_SCRIPTS))
def test_coalescer_decisions_equal_jax(case):
    plan, window, script = COALESCER_SCRIPTS[case]
    assert _run_coalescer("torch", plan, window, script) == _run_coalescer(
        "jax", plan, window, script)


def _plans(pkg: str) -> list:
    co_mod = PKGS[pkg][1]
    out = []
    for spec in ("64,1,8,8", "1,8,64,256", "4,16", "16", "2,3,5,7,11", "", "0,4", "a,b"):
        try:
            plan = co_mod.BucketPlan.parse(spec)
        except ValueError as e:
            out.append(("bad", str(e)))
            continue
        fusion = co_mod.FusionPlan.pair_adjacent(plan)
        out.append((plan.sizes, plan.max_rows,
                    [plan.bucket_for(r) for r in range(1, plan.max_rows + 2)],
                    fusion.groups, fusion.widths, [fusion.width_for(b) for b in plan.sizes]))
    return out


def _state_machines(pkg: str) -> list:
    """Admission, lifecycle and the reload supervisor through one script."""
    _, _, adm, _, _, _ = PKGS[pkg]
    trace = []
    a = adm.AdmissionController(max_depth=2)
    trace += [a.try_admit(), a.try_admit(), a.try_admit(), a.depth]
    a.release()
    trace += [a.try_admit(), a.try_admit(), a.depth]
    lc = adm.ServingLifecycle()
    calls = [lc.mark_recovered, lambda: lc.mark_fault("early"), lc.mark_ready, lc.mark_ready,
             lambda: lc.mark_fault("boom"), lambda: lc.mark_fault("again"), lc.mark_recovered,
             lc.mark_draining, lc.mark_draining, lc.mark_stopped, lc.mark_stopped]
    for call in calls:
        try:
            trace.append(("ok", call(), lc.state))
        except adm.InvalidTransition as e:
            trace.append(("invalid", str(e), lc.state))
    trace.append((lc.fault_count, lc.reload_count))
    lc2 = adm.ServingLifecycle()
    lc2.mark_ready()
    attempts, installed = [], []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("digest mismatch")
        return len(attempts)

    sup = adm.ReloadSupervisor(lc2, flaky, installed.append, inline=True)
    trace += [sup.report_fault("chaos"), lc2.state, sup.report_fault("again"), sup.retry(),
              lc2.state, list(installed), sup.retry()]
    return trace


def _slo_trace(pkg: str) -> list:
    """The SLO engine on the same hand-built registry history."""
    _, _, _, _, slo_mod, obs_mod = PKGS[pkg]
    reg = obs_mod.MetricsRegistry()
    clock = _Clock(0.0)
    slos = slo_mod.default_serving_slos(0.25, windows_s=(10.0, 60.0)) + slo_mod.fleet_slos(
        ("default", "t1"), windows_s=(10.0, 60.0))
    eng = slo_mod.SLOEngine(slos, registry=reg, clock=clock)
    req = reg.counter("serving_requests_total")
    fleet = reg.counter("serving_fleet_requests_total")
    lat = reg.bucket_histogram("serving_request_seconds")
    out = []
    for step, (ok, bad, slow) in enumerate([(10, 0, 0), (5, 2, 1), (0, 0, 3), (20, 1, 0)]):
        req.inc(ok, status="ok")
        req.inc(bad, status="rejected_overloaded")
        fleet.inc(ok, model="default", status="ok")
        fleet.inc(bad, model="t1", status="rejected_shed")
        fleet.inc(bad, model="t1", status="rejected_degraded")
        for v in [0.01] * ok + [0.5] * slow:
            lat.observe(v, status="ok")
        clock.t += 7.0
        out.append(eng.evaluate())
    out.append(eng.health())
    snap = reg.snapshot()["bucket_histograms"]
    out.append({k: {lk: {f: v for f, v in s.items()} for lk, s in fam.items()}
                for k, fam in snap.items()})
    return out


@pytest.mark.parametrize("which", ["plans", "state_machines", "slo"])
def test_pure_decisions_equal_jax(which):
    fn = {"plans": _plans, "state_machines": _state_machines, "slo": _slo_trace}[which]
    assert fn("torch") == fn("jax")


# ── the in-process daemon on the rig forest ──────────────────────────

N_REQUESTS = 120
SIZES = (1, 3, 4, 9, 16)  # cycles across both buckets of "4,16"
T, D, N, P, NB = 8, 3, 50, 4, 8
FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")


def _forest_arrays(seed: int) -> dict:
    """The JAX serving rig's synthetic forest (``tests/test_serving.py``)."""
    rng = np.random.default_rng(seed)
    return {
        "split_feat": rng.integers(0, P, size=(T, D, 1 << D)).astype(np.int32),
        "split_bin": rng.integers(0, NB - 1, size=(T, D, 1 << D)).astype(np.int32),
        "leaf_stats": (np.abs(rng.normal(size=(T, 1 << D, 5))) + 0.5).astype(np.float32),
        "in_sample": rng.uniform(size=(T, N)) < 0.5,
        "bin_edges": np.sort(rng.normal(size=(P, NB - 1)), axis=1).astype(np.float32),
    }


def _summed_leaf_stats(seed: int) -> np.ndarray:
    """Leaf statistics [c, Σw̃, Σỹ, Σw̃², Σw̃ỹ] of c drawn rows a leaf."""
    rng = np.random.default_rng(seed)
    out = np.zeros((T, 1 << D, 5))
    for t in range(T):
        for leaf in range(1 << D):
            c = int(rng.integers(2, 12))
            wt, yt = rng.normal(size=c), rng.normal(size=c)
            out[t, leaf] = (c, wt.sum(), yt.sum(), (wt * wt).sum(), (wt * yt).sum())
    return out.astype(np.float32)


def _torch_forest(a: dict) -> tcf.CausalForest:
    return tcf.CausalForest(**{k: torch.from_numpy(a[k]) for k in FIELDS}, ci_group_size=2)


def _config(ckpt: str, **kw) -> ServeConfig:
    base = dict(checkpoint=ckpt, buckets=tco.BucketPlan.parse("4,16"), window_s=0.002,
                max_depth=16, retry_after_s=0.005, device="cpu")
    base.update(kw)
    return ServeConfig(**base)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """Checkpoints + offline references (port and JAX package) + ONE
    running port daemon serving both models."""
    rig_arrays = _forest_arrays(0)
    a = dict(rig_arrays, leaf_stats=_summed_leaf_stats(2))
    forest, rig_forest = _torch_forest(a), _torch_forest(rig_arrays)
    root = tmp_path_factory.mktemp("serve")
    ckpt, rig_ckpt = str(root / "forest.npz"), str(root / "jaxrig.npz")
    save_fitted(ckpt, forest)
    save_fitted(rig_ckpt, rig_forest)
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(SIZES[i % len(SIZES)], P)).astype(np.float32)
          for i in range(N_REQUESTS)]
    rows = torch.from_numpy(np.concatenate(xs))
    off = tcf.predict_cate(forest, rows, oob=False)
    rig_off = tcf.predict_cate(rig_forest, rows, oob=False)
    jf = jcf.CausalForest(**{k: jnp.asarray(a[k]) for k in FIELDS}, ci_group_size=2)
    jout = jcf.predict_cate(jf, jnp.asarray(rows.numpy()), oob=False, row_backend="matmul")
    server = CateServer(_config(ckpt, fleet=(("jaxrig", rig_ckpt),)))
    phases = server.startup()
    yield dict(server=server, forest=forest, ckpt=ckpt, xs=xs, phases=phases,
               offline=(off.cate.numpy(), off.variance.numpy()),
               rig_offline=(rig_off.cate.numpy(), rig_off.variance.numpy()),
               jax=(np.asarray(jout.cate), np.asarray(jout.variance)),
               starts=np.cumsum([0] + [x.shape[0] for x in xs]))
    server.stop()  # enforces the no-build window over every test here


def _submit_retry(server, rid, x, on_fault=None):
    for _ in range(500):
        try:
            return server.submit(rid, x)
        except RejectedRequest as rej:
            if rej.code == "serve_fault" and on_fault is not None:
                on_fault(rid)
            elif rej.code not in ("overloaded", "degraded", "serve_fault"):
                raise
            time.sleep(rej.retry_after_s or 0.002)
    raise AssertionError(f"no progress on {rid}")


def _expect(rig, i, key="offline"):
    a, b = rig["starts"][i], rig["starts"][i + 1]
    return rig[key][0][a:b], rig[key][1][a:b]


def test_serving_bit_identity_jax_bound_and_no_build_window(rig):
    server, xs = rig["server"], rig["xs"]
    # A few one at a time (each alone in its window), then a burst that
    # packs the large bucket; every third request of the burst goes to
    # the JAX rig's forest (same shapes: the same warmed predicts, the
    # forest a runtime argument).
    results = [server.serve_one(f"r{i}", xs[i]) for i in range(5)]
    reqs = [(i, _submit_retry(server, f"r{i}", xs[i]) if i % 3 else
             server.serve_request(f"r{i}", xs[i], model="jaxrig"))
            for i in range(5, N_REQUESTS)]
    jc, jv = rig["jax"]
    for i, r in [(i, None) for i in range(5)] + reqs:
        if r is not None:
            assert r.wait(30) and r.error is None, r.error
        cate, var = results[i] if r is None else r.result
        key = "rig_offline" if r is not None and r.model == "jaxrig" else "offline"
        ec, ev = _expect(rig, i, key)
        assert np.array_equal(cate, ec) and np.array_equal(var, ev), (i, key)
        if key == "offline":
            a, b = rig["starts"][i], rig["starts"][i + 1]
            assert np.all(np.abs(cate - jc[a:b]) <= 1e-6 * (1 + np.abs(jc[a:b]))), i
            assert np.all(np.abs(var - jv[a:b]) <= 1e-6 * (1 + jv[a:b])), i
    assert server.builds_in_window() == {"kernel": 0.0, "graph": 0.0}
    assert server.compile_events_in_window() == 0.0
    used = {k for k, v in tobs.REGISTRY.peek("serving_batches_total").items() if v and k}
    assert {"bucket=4", "bucket=16"} <= used
    assert set(rig["phases"]) == {"load", "aot", "warm"}
    stats = server.stats()
    assert stats["state"] == "serving" and set(stats["phases"]) == set(tco.PHASES)
    assert set(stats["models"]) == {"default", "jaxrig"}
    assert len(server._predicts) == 2  # one warmed predict a bucket, shared


def test_serving_rejects_are_typed(rig):
    server = rig["server"]
    cases = [("bad_request", np.ones((3,), np.float32), {}),
             ("features", np.ones((2, 9), np.float32), {}),
             ("rows", np.ones((17, 4), np.float32), {}),
             ("float32", np.array([["a", "b", "c", "d"]]), {}),
             ("unknown_model", np.ones((1, 4), np.float32), {"model": "nope"}),
             ("deadline_exceeded", np.ones((1, 4), np.float32), {"deadline_ms": 0.0}),
             ("bad_request", np.ones((1, 4), np.float32), {"deadline_ms": "soon"})]
    for i, (match, x, kw) in enumerate(cases):
        with pytest.raises(RejectedRequest, match=match):
            server.serve_one(f"bad{i}", x, **kw)
    assert server.deadline_exceeded_counts().get("admission", 0) >= 1


def test_overload_burst_gets_typed_rejects(rig):
    server, xs = rig["server"], rig["xs"]
    admitted, codes = [], []
    for i in range(200):
        try:
            admitted.append(server.submit(f"o{i}", xs[4]))
        except RejectedRequest as rej:
            codes.append(rej.code)
            assert rej.retry_after_s == server.config.retry_after_s
    assert codes and set(codes) == {"overloaded"}
    for r in admitted:
        assert r.wait(30) and r.error is None
        assert np.array_equal(r.result[0], _expect(rig, 4)[0])


def test_serve_chaos_degrades_reloads_and_stays_bit_identical(rig):
    server, xs = rig["server"], rig["xs"]
    ids = [f"c{i}" for i in range(N_REQUESTS)]
    faulted, results = [], {}
    reloads = server.lifecycle.reload_count
    with tchaos.override("serve:p=0.25,seed=11"):
        for i, rid in enumerate(ids):
            req = _submit_retry(server, rid, xs[i], on_fault=faulted.append)
            assert req.wait(30) and req.error is None
            results[rid] = req.result
    assert faulted == [rid for rid in ids if tchaos._unit(11, "serve", rid) < 0.25] and faulted
    assert server.lifecycle.state == "serving"
    assert server.lifecycle.reload_count > reloads
    for i, rid in enumerate(ids):
        ec, ev = _expect(rig, i)
        assert np.array_equal(results[rid][0], ec) and np.array_equal(results[rid][1], ev)
    assert server.slo.health()["slos"]["availability"]["worst_burn_rate"] > 0.0


@pytest.mark.parametrize("client_pkg", ["jax", "torch"])
def test_client_drives_the_port_daemon_over_a_socketpair(rig, client_pkg):
    """The JAX package's client (and the port's) against the port's
    daemon: ping, predict, stats, and the ops not ported yet answered
    with the typed unknown-op error; a torn frame kills only its
    connection."""
    server, xs = rig["server"], rig["xs"]
    client_cls = JClient if client_pkg == "jax" else TClient
    a, b = socket.socketpair()
    rw = b.makefile("rwb")
    t = threading.Thread(target=serve_stream, args=(server, rw, rw), daemon=True)
    t.start()
    with client_cls(a.makefile("rb"), a.makefile("wb"), sock=a) as client:
        assert client.ping()["state"] == "serving"
        for i in range(3):
            cate, var, header = client.predict_full(xs[i], request_id=f"w{client_pkg}{i}",
                                                    deadline_ms=30_000)
            assert np.array_equal(cate, _expect(rig, i)[0])
            assert np.array_equal(var, _expect(rig, i)[1])
            assert header["model"] == "default" and header["model_version"] == 1
        stats = client.stats()
        assert stats["compile_events_in_window"] == 0 and stats["state"] == "serving"
        for op in ("dump", "rotate", "retire"):
            header, _ = client._roundtrip({"op": op, "model": "default", "checkpoint": "x"})
            assert header == {"ok": False, "error": "bad_request",
                              "message": f"unknown op {op!r}"}
    t.join(5)
    assert not t.is_alive()
    a2, b2 = socket.socketpair()
    rw2 = b2.makefile("rwb")
    t2 = threading.Thread(target=serve_stream, args=(server, rw2, rw2), daemon=True)
    t2.start()
    frame = tproto.encode_frame({"op": "ping"})
    a2.sendall(frame[:len(frame) - 2])
    a2.close()
    t2.join(5)
    assert not t2.is_alive() and server.lifecycle.state == "serving"


def test_startup_refuses_corrupt_checkpoint(tmp_path):
    ckpt = str(tmp_path / "forest.npz")
    save_fitted(ckpt, _torch_forest(_forest_arrays(3)))
    with open(ckpt, "r+b") as f:
        f.truncate(os.path.getsize(ckpt) * 2 // 3)
    server = CateServer(_config(ckpt))
    with pytest.raises(CheckpointCorrupt):
        server.startup()
    server.stop()  # before startup completed: no window, clean


def test_fused_buckets_masked_rows_zero_and_drain(tmp_path):
    """Bucket fusion: one masked predict a group; real rows bit-identical
    to the unmasked predict, masked rows exactly 0; a fused daemon serves
    bit-identical answers and drains with nothing dropped."""
    forest = _torch_forest(_forest_arrays(4))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, P)).astype(np.float32)
    plain = tcf.lower_predict_cate(forest, 16)(forest, x)
    mask = np.zeros(16, np.float32)
    mask[:11] = 1.0
    masked = tcf.lower_predict_cate_masked(forest, 16)(forest, x, mask)
    for got, want in ((masked.cate, plain.cate), (masked.variance, plain.variance)):
        assert np.array_equal(got[:11], want[:11]) and np.all(got[11:] == 0.0)
    with pytest.raises(TypeError, match="mask"):
        tcf.lower_predict_cate(forest, 16)(forest, x, mask)
    ckpt = str(tmp_path / "forest.npz")
    save_fitted(ckpt, forest)
    server = CateServer(_config(ckpt, buckets=tco.BucketPlan.parse("1,4,16"),
                                fuse_buckets=True))
    server.startup()
    xs = [rng.normal(size=(s, P)).astype(np.float32) for s in itertools.islice(
        itertools.cycle((1, 3, 5, 16)), 24)]
    reqs = [_submit_retry(server, f"f{i}", xi) for i, xi in enumerate(xs)]
    off = tcf.predict_cate(forest, torch.from_numpy(np.concatenate(xs)), oob=False)
    start = 0
    for r, xi in zip(reqs, xs):
        assert r.wait(30) and r.error is None
        n = xi.shape[0]
        assert np.array_equal(r.result[0], off.cate[start:start + n].numpy())
        start += n
    assert server.stats()["fused_buckets"] == [[1], [4, 16]]
    assert server.masked_fraction_mean() >= 0.0 and server.builds_in_window()["graph"] == 0
    assert server.drain(timeout_s=10) == "drained"
    assert server.lifecycle.state == "stopped"
