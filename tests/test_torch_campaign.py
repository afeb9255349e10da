"""The port's chaos campaign (``resilience/campaign.py``,
``resilience/invariants.py``) against the JAX package's, on the CPU.

* The planner: ``plan_campaign`` at root seeds 7 and 8 equals the JAX
  package's episode for episode (workload, seed, atoms); ``draw_atom``
  equals it and stays inside its ranges; the scale's env overrides and
  config-time raises equal; an unknown workload raises the same way; the
  registry's names and order equal.
* One module-scoped micro campaign, ``plan_campaign(7, 3, workloads=
  ("sweep", "matrix", "serving"))`` on the CPU: all green, at least three
  scopes composed, answers bit-identical to the fault-free references,
  faults actually injected, and the JAX package's
  ``validate_campaign_report`` passes. The JAX package's registry judges
  the port's episode and reference directories to the port's verdicts,
  detail and data included.
* The planted ``tamper:journal`` matrix episode (the JAX test's
  ``TAMPER_SEED`` / ``TAMPER_ATOMS``): detected by bit identity alone,
  shrunk to the JAX test's minimal atoms, its repro line failing again
  through ``scripts/torch_chaos_campaign.py``, the report byte-identical
  across two runs of one seed, and a corrupted report refused.
* Refusals: no telemetry, a run directory that is not empty; with
  telemetry off the registry and the event log write nothing.
* A build planted in a serving window is judged, not raised: the daemon
  runs with ``strict_no_compile=False``, ``zero_compile_window`` fails
  and the shrinker reaches the planting atom.
* The daemon books a batch's phases before its callers wake, so a dump
  taken right after the last reply reconciles (found by this campaign: a
  serving episode read ``silent_drops=-1``).

The four-workload campaign and the fleet episode (three daemon processes)
are ``@slow``, as in the JAX package.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.resilience import campaign as cp
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience import invariants as inv
from ate_replication_causalml_tpu.resilience import campaign as jcp
from ate_replication_causalml_tpu.resilience import invariants as jinv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "scripts"))
from check_metrics_schema import validate_campaign_report  # noqa: E402

CPU = "cpu"
ROOT_SEED = 7
WORKLOADS = ("sweep", "matrix", "serving")
TAMPER_SEED = 17
TAMPER_ATOMS = (
    ("fs", "fs:torn_write,times=1"),
    ("stage", "stage:fail=naive#b0,times=1"),
    ("tamper", "tamper:journal,times=1"),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file (``tests/test_torch_qp.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(eps):
    return [(e.index, e.workload, e.seed, e.atoms, e.spec) for e in eps]


# ── the planner against the JAX package ───────────────────────────────


@pytest.mark.parametrize("seed", [7, 8])
def test_plan_campaign_equals_jax(seed):
    eps = cp.plan_campaign(seed, 8)
    assert _plan(eps) == _plan(jcp.plan_campaign(seed, 8)) == _plan(cp.plan_campaign(seed, 8))
    assert [e.workload for e in eps[:4]] == list(cp.WORKLOAD_ORDER) == list(jcp.WORKLOAD_ORDER)
    for e in eps:
        cfg = chaos.parse_chaos(e.spec)
        assert len(cfg.scopes) == len(e.atoms) >= 2
        for scope, _frag in e.atoms:
            assert scope in cfg.scopes and scope in cp.WORKLOADS[e.workload].scopes
    assert any(a.spec != b.spec for a, b in zip(eps, cp.plan_campaign(seed + 1, 8)))
    for wl in (("fleet",), ("matrix", "serving")):
        assert _plan(cp.plan_campaign(seed, 3, wl)) == _plan(jcp.plan_campaign(seed, 3, wl))


def test_default_plan_is_the_committed_record():
    with open(os.path.join(_REPO, "CHAOS_CAMPAIGN.json")) as f:
        record = json.load(f)
    eps = cp.plan_campaign(record["root_seed"], record["n_episodes"])
    assert [(e.workload, e.spec) for e in eps] == [
        (r["workload"], r["spec"]) for r in record["episodes"]]
    assert [e.seed for e in eps] == [639229, 378496, 341407, 236680]


def test_plan_campaign_rejects_unknown_workload():
    for mod in (cp, jcp):
        with pytest.raises(ValueError, match="unknown campaign workload 'nope'"):
            mod.plan_campaign(0, 2, workloads=("sweep", "nope"))


def test_scale_env_overrides_and_config_time_raise(monkeypatch):
    assert [cp.SCALES[k].__dict__ for k in sorted(cp.SCALES)] == [
        jcp.SCALES[k].__dict__ for k in sorted(jcp.SCALES)]
    monkeypatch.setenv(cp.ENV_REPS, "12")
    monkeypatch.setenv(cp.ENV_REQUESTS, "48")
    scale = cp.resolve_scale("micro")
    assert scale.matrix_reps == 12 and scale.serve_requests == 48
    assert scale.__dict__ == jcp.resolve_scale("micro").__dict__
    for bad in ("zero", "0", "-2"):
        monkeypatch.setenv(cp.ENV_REPS, bad)
        for mod in (cp, jcp):
            with pytest.raises(ValueError, match=cp.ENV_REPS):
                mod.resolve_scale("micro")
    monkeypatch.delenv(cp.ENV_REPS)
    for mod in (cp, jcp):
        with pytest.raises(ValueError, match="unknown campaign scale"):
            mod.resolve_scale("mega")
    for raw, want in (("-3", None), ("x", None), ("0", 0), ("11", 11)):
        monkeypatch.setenv(cp.ENV_SEED, raw)
        if want is None:
            for mod in (cp, jcp):
                with pytest.raises(ValueError, match=cp.ENV_SEED):
                    mod.default_seed()
        else:
            assert cp.default_seed() == jcp.default_seed() == want


def test_draw_atoms_equal_jax_and_stay_inside_declared_ranges():
    for i in range(20):
        d, jd = cp.Draw(3, "t", i), jcp.Draw(3, "t", i)
        for workload, spec in cp.WORKLOADS.items():
            for scope in spec.scopes + ("rotate",):
                assert cp.draw_atom(workload, scope, d) == jcp.draw_atom(workload, scope, jd)
        shard = chaos.parse_chaos(cp.draw_atom("sweep", "shard", d)).scope("shard")
        assert 0.15 <= shard["p"] <= 0.45 and shard["times"] in (1, 2)
        hang = chaos.parse_chaos(cp.draw_atom("serving", "hang", d)).scope("hang")
        assert hang["scope"] == "dispatch" and 10 <= hang["ms"] <= 50 and 0.2 <= hang["p"] <= 0.7
        assert chaos.parse_chaos(cp.draw_atom("matrix", "hang", d)).scope("hang")["scope"] == \
            "worker"
        serve = chaos.parse_chaos(cp.draw_atom("serving", "serve", d)).scope("serve")
        assert 0.08 <= serve["p"] <= 0.25 and serve["times"] in (1, 2)
        stage = chaos.parse_chaos(cp.draw_atom("matrix", "stage", d)).scope("stage")
        assert stage["fail"] in ("naive#b0", "ipw_logit#b0")
    with pytest.raises(ValueError, match="no campaign range"):
        cp.draw_atom("sweep", "device", cp.Draw(0))


def test_fleet_workload_registration_and_registry_order():
    d = cp.Draw(3, "t")
    atom = cp.draw_atom("fleet", "daemon", d)
    assert atom.startswith("daemon:kill=1,seed=") and atom == jcp.draw_atom("fleet", "daemon",
                                                                            jcp.Draw(3, "t"))
    chaos.parse_chaos(atom)
    assert cp._SCOPE_ORDER == jcp._SCOPE_ORDER and "daemon" in cp._SCOPE_ORDER
    assert cp.WORKLOADS["fleet"].scopes == ("daemon",) and "fleet" not in cp.WORKLOAD_ORDER
    assert cp.NONDETERMINISTIC_SCOPES == jcp.NONDETERMINISTIC_SCOPES == ("hang",)
    assert {k: v.scopes for k, v in cp.WORKLOADS.items()} == {
        k: v.scopes for k, v in jcp.WORKLOADS.items()}
    assert inv.registered_names() == jinv.registered_names()
    assert len(inv.registered_names()) == 9
    assert {k: v.workloads for k, v in inv.REGISTRY.items()} == {
        k: v.workloads for k, v in jinv.REGISTRY.items()}


# ── one module-scoped micro campaign, all green ───────────────────────


@pytest.fixture(scope="module")
def green_campaign(tmp_path_factory):
    episodes = cp.plan_campaign(ROOT_SEED, 3, workloads=WORKLOADS)
    outdir = str(tmp_path_factory.mktemp("torch_campaign") / "run")
    report = cp.run_campaign(outdir, root_seed=ROOT_SEED, episodes=episodes, scale="micro",
                             log=lambda s: None, device=CPU)
    return {"report": report, "outdir": outdir, "episodes": episodes}


def test_campaign_composes_three_scopes_across_three_workloads(green_campaign):
    episodes = green_campaign["episodes"]
    assert [e.workload for e in episodes] == list(WORKLOADS)
    assert len({s for e in episodes for s, _ in e.atoms}) >= 3
    assert max(len(e.atoms) for e in episodes) >= 3


def test_campaign_all_invariants_green_and_bit_identical(green_campaign):
    report = green_campaign["report"]
    assert report["violations"] == [] and report["shrink"] == []
    assert report["headline"] == "all green: 3 episodes x 9 invariants"
    for ep in report["episodes"]:
        verdicts = {v["invariant"]: v["verdict"] for v in ep["invariants"]}
        assert list(verdicts) == list(inv.registered_names())
        assert ep["status"] == "green" and "fail" not in verdicts.values(), (ep["workload"],
                                                                             verdicts)
        assert verdicts["bit_identity"] == "pass"
    (serving,) = [e for e in report["episodes"] if e["workload"] == "serving"]
    sv = {v["invariant"]: v["verdict"] for v in serving["invariants"]}
    for name in ("zero_compile_window", "serving_reconciliation", "typed_rejects_accounted",
                 "drain_no_loss", "stat_drift", "degraded_where_faulted"):
        assert sv[name] == "pass", name


def test_campaign_episodes_actually_injected_faults(green_campaign):
    outdir = green_campaign["outdir"]
    total = 0
    for ep in green_campaign["report"]["episodes"]:
        run = inv.RunArtifacts(os.path.join(outdir, f"ep{ep['index']:03d}"))
        total += len(run.faults())
        if ep["workload"] == "sweep":
            rows, torn = run.journal()
            assert [k for k, r in rows.items() if r.get("status", "ok") != "ok"] and torn >= 1
    assert total >= 3


def test_campaign_report_validates_and_counters_meter(green_campaign):
    assert validate_campaign_report(green_campaign["report"]) == []
    with open(os.path.join(green_campaign["outdir"], "campaign_report.json")) as f:
        assert validate_campaign_report(json.load(f)) == []
    eps = obs.REGISTRY.peek("chaos_campaign_episodes_total")
    assert sum(v for k, v in eps.items() if "status=green" in k) >= 3
    checks = obs.REGISTRY.peek("chaos_invariant_checks_total")
    assert sum(checks.values()) >= 3 * len(inv.registered_names())
    with open(os.path.join(green_campaign["outdir"], "campaign_walls.json")) as f:
        walls = json.load(f)
    assert len(walls["episode_wall_s"]) == 3 and all(w >= 0 for w in walls["episode_wall_s"])
    assert sorted(walls["reference_wall_s"]) == sorted(
        f"{e.workload}-{e.seed}" for e in green_campaign["episodes"])
    assert walls["shrink_wall_s"] == []


def test_jax_registry_judges_the_port_artifacts(green_campaign):
    """The JAX package's ``evaluate_all`` on the port's episode and
    reference directories gives the port's verdicts, detail and data."""
    outdir = green_campaign["outdir"]
    for ep, rec in zip(green_campaign["episodes"], green_campaign["report"]["episodes"]):
        run_dir = os.path.join(outdir, f"ep{ep.index:03d}")
        ref_dir = os.path.join(outdir, f"ref-{ep.workload}-{ep.seed}")
        jv = jinv.evaluate_all(jinv.RunArtifacts(run_dir), jinv.RunArtifacts(ref_dir))
        tv = inv.evaluate_all(inv.RunArtifacts(run_dir), inv.RunArtifacts(ref_dir))
        assert [v.as_json() for v in jv] == [v.as_json() for v in tv] == rec["invariants"]


# ── the planted violation: detect, shrink, repro fails again ──────────


@pytest.fixture(scope="module")
def tamper_campaign(tmp_path_factory):
    episode = cp.Episode(0, "matrix", TAMPER_SEED, TAMPER_ATOMS)
    outdir = str(tmp_path_factory.mktemp("torch_tamper") / "run")
    report = cp.run_campaign(outdir, root_seed=5, episodes=[episode], scale="micro",
                             log=lambda s: None, device=CPU)
    return {"report": report, "outdir": outdir}


def test_planted_tamper_detected_and_shrunk_to_minimal_subset(tamper_campaign):
    report = tamper_campaign["report"]
    assert report["violations"] == [0]
    verdicts = {v["invariant"]: v["verdict"] for v in report["episodes"][0]["invariants"]}
    # Invisible to the system's own readers: only bit identity against the
    # fault-free reference catches the tamper.
    assert verdicts["bit_identity"] == "fail"
    assert verdicts["journal_integrity"] == verdicts["degraded_where_faulted"] == "pass"
    (entry,) = report["shrink"]
    assert entry["failing"] == ["bit_identity"]
    assert entry["minimal_atoms"] == [{"scope": "tamper", "spec": "tamper:journal,times=1"}]
    assert entry["confirmed"] is True and entry["n_probe_runs"] >= 2
    for needle in ("ATE_TPU_CHAOS='tamper:journal,times=1'", "scripts/torch_chaos_campaign.py",
                   "--repro", "--workload matrix", f"--seed {TAMPER_SEED}", "--device cpu"):
        assert needle in entry["repro"], entry["repro"]
    assert report["headline"] == entry["repro"]
    assert validate_campaign_report(report) == []
    with open(os.path.join(tamper_campaign["outdir"], "campaign_walls.json")) as f:
        walls = json.load(f)
    assert list(walls["reference_wall_s"]) == [f"matrix-{TAMPER_SEED}"]
    assert len(walls["shrink_wall_s"]) == 1 and walls["shrink_wall_s"][0] > 0


def test_minimal_repro_refails_through_the_cli(tamper_campaign, tmp_path, capsys):
    import torch_chaos_campaign as cli

    # No --out, as the emitted line: repro mode makes a fresh temp dir.
    assert cli.main(["--repro", "--workload", "matrix", "--seed", str(TAMPER_SEED),
                     "--chaos", "tamper:journal,times=1", "--scale", "micro",
                     "--device", CPU]) == 1
    assert "REPRO RE-FAILS: ['bit_identity']" in capsys.readouterr().out
    assert cli.main(["--repro", "--workload", "matrix", "--seed", str(TAMPER_SEED),
                     "--chaos", "fs:torn_write,times=1", "--scale", "micro", "--device", CPU,
                     "--out", str(tmp_path / "clean")]) == 0
    with pytest.raises(SystemExit) as e:
        cli.main(["--repro", "--workload", "matrix", "--device", CPU])
    assert e.value.code == 2


def test_same_campaign_seed_byte_identical_report(tamper_campaign, tmp_path):
    outdir = str(tmp_path / "rerun")
    cp.run_campaign(outdir, root_seed=5,
                    episodes=[cp.Episode(0, "matrix", TAMPER_SEED, TAMPER_ATOMS)],
                    scale="micro", log=lambda s: None, device=CPU)
    with open(os.path.join(tamper_campaign["outdir"], "campaign_report.json"), "rb") as f:
        a = f.read()
    with open(os.path.join(outdir, "campaign_report.json"), "rb") as f:
        assert f.read() == a


def test_campaign_report_validator_rejects_corruption(tamper_campaign):
    good = tamper_campaign["report"]

    def corrupt(mutate):
        bad = json.loads(json.dumps(good))
        mutate(bad)
        return validate_campaign_report(bad)

    assert corrupt(lambda r: r["episodes"][0]["invariants"].pop())
    assert corrupt(lambda r: r["episodes"][0].update(status="green"))
    assert corrupt(lambda r: r.update(n_episodes=9))
    assert corrupt(lambda r: r.update(violations=[]))
    assert corrupt(lambda r: r["shrink"][0]["minimal_atoms"].append(
        {"scope": "serve", "spec": "serve:p=0.9,seed=1"}))
    assert corrupt(lambda r: r["shrink"][0].update(confirmed=False))
    assert corrupt(lambda r: r["shrink"][0].update(repro="python foo.py"))
    assert corrupt(lambda r: r.update(headline="all green"))


# ── refusals ──────────────────────────────────────────────────────────


def test_campaign_refuses_to_run_without_telemetry(tmp_path):
    obs.set_enabled(False)
    try:
        with pytest.raises(RuntimeError, match="ATE_TPU_TELEMETRY"):
            cp.run_campaign(str(tmp_path / "x"), root_seed=0, n_episodes=1,
                            workloads=("matrix",), device=CPU)
        with pytest.raises(RuntimeError, match="ATE_TPU_TELEMETRY"):
            cp.run_repro("matrix", 1, "fs:torn_write", str(tmp_path / "y"), device=CPU)
    finally:
        obs.set_enabled(None)
    assert not os.path.exists(tmp_path / "x") and not os.path.exists(tmp_path / "y")


def test_registry_and_event_log_write_nothing_with_telemetry_off():
    """``ATE_TPU_TELEMETRY=0`` gates every write, counters included (the
    JAX package's switch): a snapshot taken then holds no sample."""
    reg, log = obs.MetricsRegistry(), obs.EventLog()
    obs.set_enabled(False)
    try:
        reg.counter("c").inc(1, a="x")
        reg.counter("c").inc(0)
        reg.gauge("g").set(2.0)
        reg.histogram("h").observe(3.0)
        reg.bucket_histogram("b").observe(0.01)
        log.emit("e")
        with log.span("s"):
            pass
    finally:
        obs.set_enabled(None)
    snap = reg.snapshot()
    assert not any(snap[k] for k in ("counters", "gauges", "histograms", "bucket_histograms"))
    assert log.records() == []
    reg.counter("c").inc(1)
    assert reg.peek("c") == {"": 1.0}


def test_build_in_serving_window_is_judged_and_shrunk(tmp_path, monkeypatch):
    """A kernel build planted in the serving window (one counted wherever
    the serve scope refuses a request) does not abort the campaign: the
    daemon leaves the verdict to ``zero_compile_window``, which fails,
    and the shrinker reaches the serve atom alone."""
    take = chaos.ChaosInjector.take_serve_fault

    def planted(self, request_id):
        hit = take(self, request_id)
        if hit:
            obs.counter("kernel_builds_total").inc(1)
        return hit

    monkeypatch.setattr(chaos.ChaosInjector, "take_serve_fault", planted)
    serve = ("serve", "serve:p=0.5,seed=3,times=1")
    atoms = (serve, ("hang", "hang:scope=dispatch,ms=5.0,p=0.5,seed=1,times=1"))
    report = cp.run_campaign(str(tmp_path / "run"), root_seed=5,
                             episodes=[cp.Episode(0, "serving", 11, atoms)], scale="micro",
                             log=lambda s: None, device=CPU)
    verdicts = {v["invariant"]: v for v in report["episodes"][0]["invariants"]}
    assert report["violations"] == [0]
    assert verdicts["zero_compile_window"]["verdict"] == "fail", verdicts["zero_compile_window"]
    assert verdicts["bit_identity"]["verdict"] == "pass"
    (entry,) = report["shrink"]
    assert entry["failing"] == ["zero_compile_window"]
    assert entry["minimal_atoms"] == [{"scope": serve[0], "spec": serve[1]}]
    assert entry["confirmed"] is True
    assert validate_campaign_report(report) == []


def test_run_dir_reuse_is_refused(tmp_path):
    d = tmp_path / "ep"
    d.mkdir()
    (d / "stale.txt").write_text("x")
    with pytest.raises(ValueError, match="not empty"):
        cp._run_workload("matrix", str(d), 1, cp.MICRO, CPU)


# ── the daemon books a batch's phases before its callers wake ─────────


def test_reply_is_booked_before_the_caller_wakes(tmp_path, monkeypatch):
    """The serving report's reconciliation counts the phase histogram
    against the trace's request spans; a caller that dumps right after its
    reply must find that reply booked, however late the dispatcher's
    per-batch bookkeeping runs (slowed here by 0.3 s a batch)."""
    from ate_replication_causalml_torch.serving.coalescer import BucketPlan
    from ate_replication_causalml_torch.serving.daemon import CateServer, ServeConfig
    from ate_replication_causalml_torch.utils.checkpoint import save_fitted

    monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    ckpt = str(tmp_path / "m.npz")
    save_fitted(ckpt, cp._synthetic_serving_forest(np.random.default_rng(3)))
    server = CateServer(ServeConfig(checkpoint=ckpt, buckets=BucketPlan.parse("4"),
                                    window_s=0.002, device=CPU))
    server.startup()
    try:
        slow = server.stat.observe

        def observe(*a, **k):
            time.sleep(0.3)
            return slow(*a, **k)

        monkeypatch.setattr(server.stat, "observe", observe)
        before = server._phase_device_count()
        x = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
        for i in range(3):
            server.serve_request(f"r{i}", x)
            assert server._phase_device_count() == before + i + 1
        server.dump_artifacts(str(tmp_path / "dump"))
        with open(tmp_path / "dump" / "serving_report.json") as f:
            assert json.load(f)["reconciliation"]["silent_drops"] == 0
    finally:
        server.stop()


# ── heavy: all four workloads; the fleet episode ──────────────────────


@pytest.mark.slow
def test_heavy_campaign_all_four_workloads(tmp_path):
    report = cp.run_campaign(str(tmp_path / "heavy"), root_seed=ROOT_SEED, n_episodes=8,
                             scale="micro", log=lambda s: None, device=CPU)
    assert report["violations"] == []
    assert set(report["by_workload"]) == set(cp.WORKLOAD_ORDER)
    assert validate_campaign_report(report) == []


@pytest.mark.slow
def test_fleet_campaign_episode_sigkill_invariants(tmp_path):
    """Three daemon processes behind the router, the planned victim
    SIGKILLed mid-replay (seed 0: b2, which owns ring keys, so the kill
    makes failover traffic), judged by the whole registry."""
    verdicts = cp.run_repro("fleet", 0, "daemon:kill=1,seed=0", str(tmp_path),
                            scale="micro", log=lambda s: None, device=CPU)
    by = {v.invariant: v for v in verdicts}
    assert not [v for v in verdicts if v.verdict == "fail"], [
        (v.invariant, v.detail) for v in verdicts if v.verdict == "fail"]
    assert by["fleet_failover"].verdict == by["bit_identity"].verdict == "pass"
    assert by["fleet_failover"].data["killed"] == [
        min(("b0", "b1", "b2"), key=lambda n: chaos._unit(0, "daemon", n))]
