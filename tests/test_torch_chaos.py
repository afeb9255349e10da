"""The port's resilience layer (``resilience/``, ``parallel/retry.py``)
against the JAX package's, on the CPU.

Pure functions through both packages on the same inputs, equal outputs:
the ``ATE_TPU_CHAOS`` grammar, every injection decision over a grid of
specs and sites, the jittered backoff, the shard runner's outcomes on
planned faults, and the error classification, equal to the JAX
package's except where an exception is a CUDA error: the port classifies
those fatal (``resilience/errors.py`` says why). Then the chaos scopes in
the port's own code: ``shard:`` and ``device:drop`` in a forest's chunk
loop (the retried chunks give the clean forest bit for bit) and
``hang:scope=worker`` in the engine of both packages (planned stalls equal
observed ones). The sweep-level scopes (``stage:fail``, ``fs:torn_write``,
the worker stall under the watchdog) are in ``tests/test_torch_pipeline.py``,
on copies of its module's sweeps.
"""

import json

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import observability as tobs
from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.parallel import retry as tretry
from ate_replication_causalml_torch.resilience import backoff as tbackoff
from ate_replication_causalml_torch.resilience import chaos as tchaos
from ate_replication_causalml_torch.resilience import errors as terrors
from ate_replication_causalml_torch.scheduler import StageSpec, SweepEngine
from ate_replication_causalml_tpu import observability as jobs
from ate_replication_causalml_tpu.parallel import retry as jretry
from ate_replication_causalml_tpu.resilience import backoff as jbackoff
from ate_replication_causalml_tpu.resilience import chaos as jchaos
from ate_replication_causalml_tpu.resilience import errors as jerrors


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("ATE_TPU_CHAOS", raising=False)
    tchaos.reset()
    jchaos.reset()
    tobs.REGISTRY.reset()
    tobs.EVENTS.clear()
    yield
    tchaos.reset()
    jchaos.reset()


SPECS = [
    "shard:p=0.3,seed=7",
    "shard:p=0.5,seed=3,times=2,pool=forest;fs:torn_write;device:drop=1",
    "stage:fail=LASSO,times=2;fs:torn_write,times=2",
    "hang:scope=worker,ms=20,p=0.5,seed=11,times=2",
    "serve:p=0.4,seed=5,times=2;daemon:kill=2,seed=9",
    "rotate:retrain,corrupt,verify_ms=5,times=2;fs:corrupt_npz",
    "tamper:journal,delta=0.5;device:drop=2,times=1",
    " ; stage:fail=Direct Method ; ",
]
BAD_SPECS = ["nope:x=1", "stage:p=1.0", "shard:p=abc", "shard:p", "hang:ms=5",
             "hang:scope=dispatcher", "daemon:kill=-1", "device:drop=1.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_jax(spec):
    got, want = tchaos.parse_chaos(spec), jchaos.parse_chaos(spec)
    assert (got.spec, got.scopes) == (want.spec, want.scopes)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_spec_raises_in_both(spec):
    with pytest.raises(jerrors.ChaosSpecError) as jerr:
        jchaos.parse_chaos(spec)
    with pytest.raises(terrors.ChaosSpecError) as terr:
        tchaos.parse_chaos(spec)
    assert str(terr.value) == str(jerr.value)


def _decisions(mod, spec: str) -> dict:
    """Every injection decision of one armed spec over a grid of sites,
    in a fixed call order (budgets are stateful)."""
    inj = mod.ChaosInjector(mod.parse_chaos(spec))
    methods = ["oracle", "naive", "Direct Method", "Single-equation LASSO", "Usual LASSO",
               "Belloni et.al", "Causal Forest(GRF)"]
    line = json.dumps({"method": "naive", "ate": 0.25, "se": 0.1}) + "\n"
    return {
        "unit": [mod._unit(s, "shard", "p", str(i)) for s in (0, 7) for i in range(4)],
        "shard": [inj.shard_should_fail(pool, i, a) for pool in ("forest_classifier", "causal")
                  for i in range(12) for a in (1, 2, 3)],
        "stage_plan": sorted(inj.plan_stage_faults(methods)),
        "hang": [inj.hang_delay_s(scope, f"n{i}") for scope in ("worker", "dispatch")
                 for i in range(12) for _ in range(3)],
        "tamper": [inj.tamper_line(line, "j"), inj.tamper_line(line, "j")],
        "torn": [inj.torn_line(line, "j"), inj.torn_line(line, "j"), inj.torn_line(line, "j")],
        "devices": [inj.drop_devices([0, 1, 2, 3]) for _ in range(3)],
    }


def _injections(obs) -> list:
    return [(r["attrs"]["scope"], r["attrs"]["site"]) for r in obs.EVENTS.records()
            if r["name"] == "chaos_inject"]


@pytest.mark.parametrize("spec", SPECS)
def test_injection_decisions_equal_jax(spec):
    """The same decisions, the same ``chaos_inject`` events in the same
    order and the same ``chaos_injections_total`` counts."""
    jobs.EVENTS.clear()
    jobs.REGISTRY.reset()
    assert _decisions(tchaos, spec) == _decisions(jchaos, spec)
    assert _injections(tobs) == _injections(jobs)
    got = tobs.REGISTRY.snapshot()["counters"].get("chaos_injections_total")
    want = jobs.REGISTRY.snapshot()["counters"].get("chaos_injections_total")
    assert got == want


def test_arming_follows_the_env(monkeypatch):
    assert tchaos.active() is None
    monkeypatch.setenv("ATE_TPU_CHAOS", "stage:fail=naive")
    inj = tchaos.active()
    assert inj is tchaos.active() and inj.take_stage_fault("naive")
    assert not tchaos.active().take_stage_fault("naive")        # budget spent
    tchaos.reset()
    assert tchaos.active().take_stage_fault("naive")            # fresh budgets
    with tchaos.override("shard:p=1.0") as armed:
        assert armed.config.scope("shard")["p"] == 1.0
    assert tchaos.active().config.spec == "stage:fail=naive"


def test_backoff_equals_jax():
    for key in ("forest_classifier|3|1", "causal_forest|0|2", ""):
        for attempt in range(1, 7):
            for base in (0.0, 0.01, 0.25, 1.0):
                for cap in (None, 0.5):
                    assert (tbackoff.jittered_backoff_delay(key, attempt, base, cap_s=cap)
                            == jbackoff.jittered_backoff_delay(key, attempt, base, cap_s=cap))
    assert tretry.backoff_delay("p", 3, 2, 0.25) == jretry.backoff_delay("p", 3, 2, 0.25)


class _AcceleratorLike(RuntimeError):
    pass


EXCEPTIONS = [
    TypeError("x"), ValueError("x"), AssertionError("x"), KeyError("x"), IndexError("x"),
    AttributeError("x"), NameError("x"), NotImplementedError("x"), RecursionError("x"),
    RuntimeError("device lost"), OSError("disk"), TimeoutError("slow"), FileNotFoundError("f"),
    terrors.ChaosShardFault("x"), terrors.ChaosStageFault("x"), terrors.DeadlineExceeded("x"),
    terrors.NonFiniteResult("x"), terrors.CheckpointCorrupt("p", "r"),
    terrors.ChaosSpecError("x"), ZeroDivisionError("x"), Exception("x"), _AcceleratorLike("x"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
]


def _cuda_error(msg: str) -> torch.cuda.CudaError:
    """A ``torch.cuda.CudaError`` (its own constructor asks the CUDA
    runtime for the message, which a CPU build lacks)."""
    exc = torch.cuda.CudaError.__new__(torch.cuda.CudaError)
    RuntimeError.__init__(exc, msg)
    return exc


#: CUDA errors: RuntimeErrors the JAX package's rule retries, fatal in the port.
CUDA_EXCEPTIONS = [
    terrors.CudaKernelError("CUDA kernel 'hist' failed: error 700 (an illegal memory access)"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    _cuda_error("an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
]


@pytest.mark.parametrize("exc", EXCEPTIONS + CUDA_EXCEPTIONS,
                         ids=lambda e: f"{type(e).__name__}:{str(e)[:24]}")
def test_classify_equals_jax_but_for_cuda_errors(exc):
    got, want = terrors.classify(exc), jerrors.classify(exc)
    if any(exc is c for c in CUDA_EXCEPTIONS):
        assert (got, want) == ("fatal", "transient")
    else:
        assert got == want


def _plan_outcomes(retry, plan, n=5, **kw):
    outs = retry.run_shards(retry.inject_failures(lambda i: i * 10, plan), n, backoff_s=0.0,
                            pool="p", **kw)
    return [(o.index, o.result, o.attempts, o.ok, o.error) for o in outs]


@pytest.mark.parametrize("plan", [{}, {1: 1}, {0: 2, 3: 1}, {2: 3}, {4: 5}],
                         ids=["clean", "one_retry", "two_shards", "exhausted", "always"])
def test_run_shards_outcomes_equal_jax(plan):
    got = _plan_outcomes(tretry, plan, probe=lambda: [])
    assert got == _plan_outcomes(jretry, plan, probe=lambda: [])
    ok = all(o[3] for o in got)
    if ok:
        assert tretry.require_all(tretry.run_shards(lambda i: i, 3, pool="q")) == [0, 1, 2]
    else:
        outs = tretry.run_shards(tretry.inject_failures(lambda i: i, plan), 5, backoff_s=0.0,
                                 probe=lambda: [])
        with pytest.raises(RuntimeError, match="shards failed"):
            tretry.require_all(outs)
    snap = tobs.REGISTRY.snapshot()["counters"]
    assert snap["shard_attempts_total"]["pool=p"] == sum(o[2] for o in got)


def test_run_shards_raises_fatal_and_cuda_errors_at_once():
    calls = []

    def shard(i, exc):
        calls.append(i)
        raise exc

    for exc in (ValueError("bug"), terrors.CudaKernelError("CUDA kernel 'hist' failed")):
        calls.clear()
        with pytest.raises(type(exc)):
            tretry.run_shards(lambda i: shard(i, exc), 3, backoff_s=0.0)
        assert calls == [0]
    fatal = [r for r in tobs.EVENTS.records() if r["name"] == "shard_fatal"]
    assert len(fatal) == 2


def test_run_shards_retries_device_failures_and_reprobes(monkeypatch):
    """Out of device memory is transient: the shard retries after its
    jittered backoff, and every second device-origin failure of the pool
    re-probes the devices."""
    slept, probes, failed = [], [], set()
    monkeypatch.setattr("time.sleep", slept.append)

    def shard(i):
        if i < 3 and i not in failed:
            failed.add(i)
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return i * 10

    outs = tretry.run_shards(shard, 4, backoff_s=0.25, pool="oom",
                             probe=lambda: probes.append(1) or [])
    assert tretry.require_all(outs) == [0, 10, 20, 30]
    assert [o.attempts for o in outs] == [2, 2, 2, 1]
    assert slept == [tretry.backoff_delay("oom", i, 1, 0.25) for i in range(3)]
    assert len(probes) == 1
    reprobes = [r["attrs"] for r in tobs.EVENTS.records() if r["name"] == "device_reprobe"]
    assert [r["after_shard"] for r in reprobes] == [1]


def test_probe_devices_and_device_drop(monkeypatch):
    cpu = torch.device("cpu")
    assert tretry.probe_devices() == [cpu]
    assert tretry.probe_devices([cpu, cpu]) == [cpu, cpu]
    monkeypatch.setenv("ATE_TPU_CHAOS", "device:drop=1")
    tchaos.reset()
    assert tretry.probe_devices([cpu, cpu]) == [cpu]
    assert _injections(tobs) == [("device", "probe_devices")]


def _forest_data(n=300, p=5, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    y = (x[:, 1] + 0.5 * w + rng.normal(size=n)).astype(np.float32)
    return torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(y)


def _fields(forest) -> dict:
    return {f.name: getattr(forest, f.name) for f in __import__("dataclasses").fields(forest)
            if isinstance(getattr(forest, f.name), torch.Tensor)}


def test_shard_chaos_retries_give_the_clean_forests_bit_for_bit(monkeypatch):
    """``shard:`` faults in both forests' chunk loops: every selected
    chunk fails once and is retried, and the forests are the clean
    ones bit for bit; two device-origin failures re-probe the devices,
    where ``device:drop=1`` drops the CPU."""
    x, w, y = _forest_data()
    key = rnd.key(5, device="cpu")
    kw = dict(n_trees=48, depth=3, n_bins=16, tree_chunk=8, hist_mode="dense")
    ckw = dict(n_trees=32, depth=3, n_bins=16, group_chunk=4, hist_mode="dense")
    clean = tf.fit_forest_classifier(x, w, key, **kw)
    clean_cf = tcf.grow_causal_forest(x, w - 0.5, y - y.mean(), key, **ckw)
    monkeypatch.setattr("time.sleep", lambda s: None)      # the backoff
    spec = "shard:p=0.5,seed=2;device:drop=1"
    monkeypatch.setenv("ATE_TPU_CHAOS", spec)
    tchaos.reset()
    chaotic = tf.fit_forest_classifier(x, w, key, **kw)
    chaotic_cf = tcf.grow_causal_forest(x, w - 0.5, y - y.mean(), key, **ckw)
    for a, b in ((clean, chaotic), (clean_cf, chaotic_cf)):
        fa, fb = _fields(a), _fields(b)
        assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    planned = {(pool, i) for pool, n in (("forest_classifier", 6), ("causal_forest", 4))
               for i in range(n) if tchaos._unit(2, "shard", pool, str(i)) < 0.5}
    counters = tobs.REGISTRY.snapshot()["counters"]
    retries = {k.split("=")[1]: v for k, v in counters["shard_retries_total"].items() if k}
    assert planned and sum(retries.values()) == len(planned) > 0
    assert {(s, site) for s, site in _injections(tobs) if s == "shard"} == {
        ("shard", f"{pool}/{i}") for pool, i in planned}
    # Both fits of each forest dispatch every chunk once: an injected
    # fault raises before the instrumented thunk.
    assert counters["tree_dispatch_total"] == {"fit=forest_classifier": 12.0,
                                               "fit=causal_forest": 8.0}
    # A re-probe after every second injected failure of a pool.
    reprobes = [r["attrs"] for r in tobs.EVENTS.records() if r["name"] == "device_reprobe"]
    per_pool = [sum(p == pool for p, _ in planned) // 2
                for pool in ("forest_classifier", "causal_forest")]
    assert len(reprobes) == sum(per_pool) > 0 and all(r["healthy"] == 0 for r in reprobes)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_engine_hang_chaos_planned_equals_observed(package, monkeypatch):
    """``hang:scope=worker`` stalls the selected nodes of both packages'
    engines: nothing raises, the results are the stall-free ones, and
    the stalls observed are the ones the pure hash plans."""
    import importlib

    name = "ate_replication_causalml_tpu" if package == "jax" else "ate_replication_causalml_torch"
    sch = importlib.import_module(f"{name}.scheduler")
    ch = importlib.import_module(f"{name}.resilience.chaos")
    obs = importlib.import_module(f"{name}.observability")
    obs.EVENTS.clear()
    stages = [sch.StageSpec(f"s{i}", (lambda c, i=i: i)) for i in range(4)]
    with ch.override("hang:scope=worker,ms=20,p=0.5,seed=7") as inj:
        assert inj is not None
        results = sch.SweepEngine([], stages, workers=2, prefetch=False).run()
    assert results == {f"s{i}": i for i in range(4)}
    planned = {f"s{i}" for i in range(4) if ch._unit(7, "hang", "worker", f"s{i}") < 0.5}
    observed = {r["attrs"]["site"].split("/", 1)[1] for r in obs.EVENTS.records()
                if r["name"] == "chaos_inject" and r["attrs"].get("scope") == "hang"}
    assert planned == observed and planned
    assert tchaos._unit(7, "hang", "worker", "s1") == jchaos._unit(7, "hang", "worker", "s1")


def test_engine_span_parent():
    """Node and commit spans opened on worker threads carry the caller's
    root span as parent."""
    with tobs.span("run_sweep") as root:
        SweepEngine([], [StageSpec("s0", lambda c: 0), StageSpec("s1", lambda c: 1)],
                    commit=lambda s, v: None, workers=2, prefetch=False,
                    span_parent=root.span_id).run()
    recs = [r for r in tobs.EVENTS.records() if r["name"] in ("scheduler_node", "commit")]
    assert len(recs) == 4 and {r["parent_id"] for r in recs} == {root.span_id}
