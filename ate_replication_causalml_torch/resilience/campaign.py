"""The chaos campaign: seeded multi-scope fault episodes over the real
workloads, judged by the invariant registry, shrunk to a one-line repro.

Port of ``ate_replication_causalml_tpu/resilience/campaign.py``:

* **the planner**: from one root seed, compose multi-scope
  ``ATE_TPU_CHAOS`` specs (each scope's parameters drawn from its declared
  range) across the workloads: the quick sweep, the scenario matrix, the
  serving daemon under a seeded replay, and a rotation under load. A fifth,
  ``fleet`` (three daemon processes behind the router, a ``daemon:``
  SIGKILL and a rolling rotation), is registered but opt-in, never in the
  default plan. Every draw is the pure sha256 hash of ``(root_seed,
  path)``, so one seed plans the same campaign in both packages;
* **the reference**: every episode runs against a fault-free run of the
  same workload seed (cached per ``(workload, seed)``), and
  :mod:`.invariants` judges the pair from their committed artifacts;
* **the shrinker**: a violation is delta-debugged (:func:`_ddmin`) over
  the episode's fault atoms to a minimal failing subset, confirmed by one
  fresh run, and emitted as a one-line repro through
  ``scripts/torch_chaos_campaign.py``.

``campaign_report.json`` is byte-identical for one root seed: it carries
no wall-clock (``campaign_walls.json`` beside it does). Every workload
runs on ``device`` (``cuda`` unless told otherwise); the workloads' modules
are imported when a workload runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Sequence

import numpy as np

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch import resolve_device
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.resilience import invariants as inv

ENV_SEED = "ATE_TPU_CAMPAIGN_SEED"
ENV_EPISODES = "ATE_TPU_CAMPAIGN_EPISODES"
ENV_REQUESTS = "ATE_TPU_CAMPAIGN_REQUESTS"
ENV_REPS = "ATE_TPU_CAMPAIGN_REPS"

SCHEMA_VERSION = 1

#: scopes whose injection sites depend on load (the daemon's stall sites
#: are batch-composition ids): left out of the summary's fault list so
#: reports and invariants stay deterministic. A stall changes no answer.
NONDETERMINISTIC_SCOPES = ("hang",)

#: canonical scope order inside a composed spec (stable spec strings).
_SCOPE_ORDER = ("shard", "fs", "device", "stage", "serve", "hang", "rotate", "tamper",
                "daemon")

def _env_int(name: str, default: int) -> int:
    """A positive integer knob, refused at config time when malformed."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a positive integer") from None
    if value < 1:
        raise ValueError(f"{name}={value}: expected a positive integer")
    return value


def default_seed() -> int:
    """``ATE_TPU_CAMPAIGN_SEED`` (0 allowed: a seed, not a budget)."""
    raw = os.environ.get(ENV_SEED, "").strip()
    if not raw:
        return 0
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{ENV_SEED}={raw!r}: expected an integer") from None
    if value < 0:
        raise ValueError(f"{ENV_SEED}={value}: expected >= 0")
    return value


# ── seeded pure draws ─────────────────────────────────────────────────


class Draw:
    """Stateless seeded draws: every value is the pure hash
    ``chaos._unit(root, "campaign", *path, name)``, independent of call
    order, so adding a draw never reshuffles the others."""

    def __init__(self, root: int, *path: object):
        self.root = int(root)
        self.path = tuple(str(p) for p in path)

    def sub(self, *path: object) -> "Draw":
        return Draw(self.root, *self.path, *path)

    def unit(self, name: str, lo: float = 0.0, hi: float = 1.0) -> float:
        return lo + chaos._unit(self.root, "campaign", *self.path, name) * (hi - lo)

    def int(self, name: str, lo: int = 1, hi: int = 999_983) -> int:
        u = chaos._unit(self.root, "campaign", *self.path, name)
        return lo + min(int(u * (hi - lo + 1)), hi - lo)

    def choice(self, name: str, options: Sequence):
        return options[self.int(name, 0, len(options) - 1)]


# ── episode budget (scale) ────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class CampaignScale:
    """Episode budget knobs. ``micro`` is the MICRO sweep of the pipeline
    tests; ``quick`` the heavier tier."""

    name: str
    sweep_n_obs: int
    sweep_pool: int
    sweep_trees: int
    sweep_depth: int
    sweep_balance_iters: int
    matrix_n: int
    matrix_reps: int
    matrix_width: int
    serve_requests: int
    serve_rate_hz: float


MICRO = CampaignScale(
    name="micro", sweep_n_obs=1200, sweep_pool=3000, sweep_trees=16, sweep_depth=4,
    sweep_balance_iters=600, matrix_n=128, matrix_reps=8, matrix_width=4,
    serve_requests=24, serve_rate_hz=800.0,
)
QUICK = CampaignScale(
    name="quick", sweep_n_obs=2000, sweep_pool=4000, sweep_trees=32, sweep_depth=5,
    sweep_balance_iters=1200, matrix_n=256, matrix_reps=24, matrix_width=8,
    serve_requests=80, serve_rate_hz=1500.0,
)
SCALES = {s.name: s for s in (MICRO, QUICK)}


def resolve_scale(scale: "str | CampaignScale") -> CampaignScale:
    """A named scale with the env budget overrides, checked at config time."""
    if isinstance(scale, CampaignScale):
        base = scale
    else:
        if scale not in SCALES:
            raise ValueError(f"unknown campaign scale {scale!r} (known: {sorted(SCALES)})")
        base = SCALES[scale]
    return dataclasses.replace(base, matrix_reps=_env_int(ENV_REPS, base.matrix_reps),
                               serve_requests=_env_int(ENV_REQUESTS, base.serve_requests))


# ── workloads and per-scope parameter ranges ──────────────────────────


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One campaign workload: its runner and the chaos scopes that mean
    something against it (the planner composes only these)."""

    name: str
    scopes: tuple[str, ...]
    run: Callable  # (outdir, seed, scale, device) -> None; commits artifacts


def draw_atom(workload: str, scope: str, d: Draw) -> str:
    """One seeded scope fragment from the scope's declared range for this
    workload: the campaign's range table."""
    if scope == "shard":
        return (f"shard:p={d.unit('p', 0.15, 0.45):.3f},"
                f"seed={d.int('seed')},times={d.int('times', 1, 2)}")
    if scope == "fs":
        return f"fs:torn_write,times={d.int('times', 1, 2)}"
    if scope == "stage":
        fail = (d.choice("fail", ("residual_balancing", "Propensity_Weighting", "Usual"))
                if workload == "sweep" else d.choice("fail", ("naive#b0", "ipw_logit#b0")))
        return f"stage:fail={fail},times=1"
    if scope == "serve":
        return (f"serve:p={d.unit('p', 0.08, 0.25):.3f},"
                f"seed={d.int('seed')},times={d.int('times', 1, 2)}")
    if scope == "hang":
        lane = "dispatch" if workload in ("serving", "rotation") else "worker"
        return (f"hang:scope={lane},ms={d.unit('ms', 10, 50):.1f},"
                f"p={d.unit('p', 0.2, 0.7):.3f},seed={d.int('seed')},times=1")
    if scope == "rotate":
        kind = d.choice("kind", ("corrupt", "mid_swap", "verify_ms"))
        if kind == "verify_ms":
            return f"rotate:verify_ms={d.unit('ms', 30, 90):.0f},times=1"
        return f"rotate:{kind},times=1"
    if scope == "daemon":
        # One SIGKILLed backend an episode: the victim is the pure (seed,
        # name) hash, so the registry can recompute the plan from the spec.
        return f"daemon:kill=1,seed={d.int('seed')}"
    raise ValueError(f"no campaign range declared for scope {scope!r}")


@dataclasses.dataclass(frozen=True)
class Episode:
    """One planned episode: a workload seed and the composed scope atoms.
    The spec, the shrinker's subsets and the repro line derive from these."""

    index: int
    workload: str
    seed: int
    atoms: tuple[tuple[str, str], ...]  # (scope, spec fragment)

    @property
    def spec(self) -> str:
        return compose(self.atoms)


def compose(atoms: Sequence[tuple[str, str]]) -> str:
    return ";".join(spec for _, spec in atoms)


def plan_campaign(root_seed: int, n_episodes: int,
                  workloads: Sequence[str] | None = None) -> list[Episode]:
    """The deterministic plan: workloads round-robin, a drawn subset of at
    least two applicable scopes an episode, seeded parameters a scope. A
    pure function of ``(root_seed, n_episodes, workloads)``."""
    names = tuple(workloads) if workloads else WORKLOAD_ORDER
    for w in names:
        if w not in WORKLOADS:
            raise ValueError(f"unknown campaign workload {w!r} (known: {sorted(WORKLOADS)})")
    episodes: list[Episode] = []
    for i in range(n_episodes):
        w = names[i % len(names)]
        d = Draw(root_seed, "ep", i)
        scopes = WORKLOADS[w].scopes
        k = d.int("nscopes", min(2, len(scopes)), len(scopes))
        ranked = sorted(scopes, key=lambda s: d.unit(f"pick.{s}"))
        chosen = sorted(ranked[:k], key=_SCOPE_ORDER.index)
        atoms = tuple((s, draw_atom(w, s, d.sub("scope", s))) for s in chosen)
        episodes.append(Episode(i, w, d.int("seed", 1, 1_000_000), atoms))
    return episodes


# ── fault-window capture ──────────────────────────────────────────────


class _FaultWindow:
    """The ``chaos_inject`` events a workload run emitted (a monotonic
    window over the process-global ring), the nondeterministic scopes
    left out: the summary's fault record the invariants judge against."""

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        return False

    def collect(self) -> list[dict]:
        out = []
        for r in obs.EVENTS.records():
            if r.get("name") != "chaos_inject" or r.get("start_mono_s", 0.0) < self.t0:
                continue
            at = r.get("attrs", {})
            if at.get("scope") in NONDETERMINISTIC_SCOPES:
                continue
            f = {"scope": at.get("scope"), "site": at.get("site")}
            if "kind" in at:
                f["kind"] = at["kind"]
            out.append(f)
        return sorted(out, key=lambda f: (f["scope"], f["site"], f.get("kind", "")))


def _write_summary(outdir: str, summary: dict) -> None:
    summary = dict(summary)
    summary["chaos_spec"] = os.environ.get(chaos.ENV_VAR, "").strip()
    obs.atomic_write_json(os.path.join(outdir, inv.SUMMARY_BASENAME), summary)


# ── the workload runners ──────────────────────────────────────────────


def _silent(_msg: str) -> None:
    pass


def _run_sweep_workload(outdir: str, seed: int, scale: CampaignScale, device):
    from ate_replication_causalml_torch.data.pipeline import PrepConfig
    from ate_replication_causalml_torch.pipeline import SWEEP_METHODS, SweepConfig, run_sweep

    cfg = dataclasses.replace(
        SweepConfig().quick(), prep=PrepConfig(n_obs=scale.sweep_n_obs),
        synthetic_pool=scale.sweep_pool, synthetic_seed=seed, seed=seed,
        dr_trees=scale.sweep_trees, dml_trees=scale.sweep_trees, cf_trees=scale.sweep_trees,
        cf_nuisance_trees=scale.sweep_trees, forest_depth=scale.sweep_depth,
        balance_iters=scale.sweep_balance_iters,
    )
    with _FaultWindow() as win:
        run_sweep(cfg, outdir=outdir, plots=False, log=_silent, device=device)
    _write_summary(outdir, {
        "workload": "sweep", "seed": seed, "journal": "results.jsonl",
        "expected_rows": ["oracle"] + list(SWEEP_METHODS), "faults": win.collect(),
    })


def _run_matrix_workload(outdir: str, seed: int, scale: CampaignScale, device):
    from ate_replication_causalml_torch.scenarios.dgp import STOCK_DGPS
    from ate_replication_causalml_torch.scenarios.matrix import (
        MatrixSpec,
        cell_row_id,
        plan_columns,
        run_matrix,
    )

    calib = dataclasses.replace(STOCK_DGPS["calibration"], n=scale.matrix_n)
    # rows=True: the invariants read the per-cell table (cells.jsonl, cell
    # resume), whatever the streaming default or ATE_TPU_SCENARIO_ROWS say.
    spec = MatrixSpec(dgps=(calib,), estimators=("naive", "ipw_logit"),
                      n_reps=scale.matrix_reps, batch_width=scale.matrix_width, seed=seed,
                      shard=False, rows=True)
    plans, _skipped = plan_columns(spec)
    batches = {f"{p.name}#b{bi}": [cell_row_id(p.dgp.name, p.estimator, r) for r in batch]
               for p in plans for bi, batch in enumerate(p.batches)}
    expected = [cell_row_id(p.dgp.name, p.estimator, r)
                for p in plans for r in range(spec.n_reps)]
    with _FaultWindow() as win:
        run_matrix(spec, outdir=outdir, log=_silent, device=device)
    _write_summary(outdir, {
        "workload": "matrix", "seed": seed, "journal": "cells.jsonl",
        "expected_rows": expected, "batches": batches, "faults": win.collect(),
    })


def _synthetic_serving_forest(rng):
    """The serving rigs' micro geometry (8 trees of depth 3, 4 features),
    drawn from ``rng`` in the JAX package's order: small enough that an
    episode's daemon starts fast, real enough that the whole predict path
    (routing, leaf statistics, variance) runs. Tensors on the CPU."""
    import torch

    from ate_replication_causalml_torch.models.causal_forest import CausalForest

    T, D, n, p, nb = 8, 3, 50, 4, 8
    return CausalForest(
        split_feat=torch.from_numpy(rng.integers(0, p, size=(T, D, 1 << D)).astype(np.int32)),
        split_bin=torch.from_numpy(rng.integers(0, nb - 1, size=(T, D, 1 << D))
                                   .astype(np.int32)),
        leaf_stats=torch.from_numpy((np.abs(rng.normal(size=(T, 1 << D, 5))) + 0.5)
                                    .astype(np.float32)),
        in_sample=torch.from_numpy(rng.uniform(size=(T, n)) < 0.5),
        bin_edges=torch.from_numpy(np.sort(rng.normal(size=(p, nb - 1)), axis=1)
                                   .astype(np.float32)),
        ci_group_size=2,
    )


def _offline_refs(outdir: str, forests: dict, queries: list, dev) -> None:
    """Each version's offline ``predict_cate`` of the replayed rows on
    ``dev``, before any daemon starts (so no build lands in a serving
    window), committed as ``refs.npz``: the bit-identity base."""
    import torch

    from ate_replication_causalml_torch.models.causal_forest import predict_cate

    cat = torch.from_numpy(np.concatenate(queries)).to(dev)
    refs = {}
    for v, forest in forests.items():
        on_dev = dataclasses.replace(forest, **{
            f.name: getattr(forest, f.name).to(dev) for f in dataclasses.fields(forest)
            if isinstance(getattr(forest, f.name), torch.Tensor)})
        out = predict_cate(on_dev, cat, oob=False)
        refs[f"cate_v{v}"] = out.cate.cpu().numpy()
        refs[f"var_v{v}"] = out.variance.cpu().numpy()
    np.savez(os.path.join(outdir, "refs.npz"), **refs)


def _counter_sum(name: str) -> float:
    return float(sum((obs.REGISTRY.peek(name) or {}).values()))


def _serve_retry(server, rid: str, x, max_attempts: int = 500):
    """Blocking serve with the polite client's retry. Through the span
    path (``serve_request``): a raw ``submit()`` never enters the serving
    report's phase section, and the reconciliation would count it as a
    silent drop."""
    from ate_replication_causalml_torch.serving.daemon import RejectedRequest

    for _ in range(max_attempts):
        try:
            return server.serve_request(rid, x, timeout=60.0)
        except RejectedRequest as rej:
            if rej.code in ("bad_request", "unknown_model", "retired_model"):
                raise
            time.sleep(rej.retry_after_s or 0.002)
    raise RuntimeError(f"no progress on request {rid}")


def _serving_workload(rotate: bool):
    def run(outdir: str, seed: int, scale: CampaignScale, device):
        from ate_replication_causalml_torch.serving import loadgen
        from ate_replication_causalml_torch.serving.coalescer import BucketPlan
        from ate_replication_causalml_torch.serving.daemon import CateServer, ServeConfig
        from ate_replication_causalml_torch.utils.checkpoint import save_fitted

        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        forests = {1: _synthetic_serving_forest(rng)}
        if rotate:
            forests[2] = _synthetic_serving_forest(rng)
        ckpt = os.path.join(outdir, "model-v1.npz")
        save_fitted(ckpt, forests[1])
        schedule = loadgen.build_schedule(seed, scale.serve_requests,
                                          rate_hz=scale.serve_rate_hz, mix="1:2,3:2,4:1",
                                          id_prefix=f"c{seed}x")
        queries = loadgen.build_queries(seed, schedule, features=4)
        _offline_refs(outdir, forests, queries, dev)

        rejected_before = _counter_sum("serving_rejected_total")
        rotation_status = None
        with _FaultWindow() as win:
            # The zero_compile_window invariant does the judging: a strict
            # stop() would abort the episode instead of recording a verdict.
            server = CateServer(ServeConfig(
                checkpoint=ckpt, buckets=BucketPlan.parse("4"), window_s=0.002,
                max_depth=32, retry_after_s=0.002, device=dev.type,
                strict_no_compile=False))
            server.startup()
            try:
                half = len(schedule) // 2 if rotate else len(schedule)
                reqs = [_serve_retry(server, s.request_id, queries[i])
                        for i, s in enumerate(schedule[:half])]
                if rotate:
                    # A candidate published through the retrain supervisor
                    # (the path the rotate: scope faults) between the two
                    # halves, so which version a request binds is fixed
                    # whatever the rotation's outcome.
                    sup = server.retrain_supervisor("default", lambda: forests[2],
                                                    publish_dir=outdir)
                    rotation_status = sup.run_once().status
                    reqs += [_serve_retry(server, s.request_id, queries[i])
                             for i, s in enumerate(schedule[half:], half)]
                compile_delta = server.compile_events_in_window()
                server.dump_artifacts(outdir)
                rejected_delta = _counter_sum("serving_rejected_total") - rejected_before
                drain_outcome = server.drain(timeout_s=60.0)
            finally:
                server.stop()  # idempotent after a clean drain

        np.savez(os.path.join(outdir, "answers.npz"),
                 rows=np.asarray([q.shape[0] for q in queries], np.int64),
                 versions=np.asarray([int(r.model_version or 1) for r in reqs], np.int64),
                 cate=np.concatenate([np.asarray(r.result[0]) for r in reqs]),
                 var=np.concatenate([np.asarray(r.result[1]) for r in reqs]))
        _write_summary(outdir, {
            "workload": "rotation" if rotate else "serving", "seed": seed,
            "n_requests": len(schedule), "request_ids": [s.request_id for s in schedule],
            "faults": win.collect(),
            "serving": {
                "compile_events_in_window": compile_delta,
                "drain_outcome": drain_outcome,
                "served": sum(1 for r in reqs if r.error is None),
                "rejected_metered_delta": rejected_delta,
                "rotation_status": rotation_status,
            },
        })

    return run


# ── the fleet workload ────────────────────────────────────────────────
#
# Three daemon processes (``python -m ate_replication_causalml_torch.serving``,
# each binding default, m2 and m3 to the same published v1 checkpoint)
# behind an in-process RouterServer, replayed through a CateClient on the
# router's port: the first half of the seeded schedule, one rolling
# rotation of "default" onto v2, the second half and, when a ``daemon:``
# scope is armed, a SIGKILL of the planned victim at the 3/4 mark. Every
# request must still be served (the router's failover and the client's
# resubmit), each bit for bit its bound version's offline reference. Not
# in WORKLOAD_ORDER: it runs through ``workloads=("fleet",)`` or
# ``run_repro("fleet", ...)``, so the default plans are those of the JAX
# package.


def _spawn_fleet_daemon(name: str, ckpt: str, dev, logdir: str):
    """One daemon process serving default, m2 and m3 from ``ckpt`` on
    ephemeral wire and admin ports, fault-free. Returns ``(proc, lines,
    stderr_thread)``; the ports are parsed from the captured stderr, which
    is also copied to ``<logdir>/<name>.log``."""
    import subprocess
    import sys
    import threading

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    for k in ("ATE_TPU_CHAOS", "ATE_TPU_METRICS_DIR", "ATE_TPU_SERVE_FLEET",
              "ATE_TPU_SERVE_ADMIN_PORT"):
        env.pop(k, None)  # the daemons run fault-free; chaos lives up here
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ate_replication_causalml_torch.serving",
         "--checkpoint", ckpt, "--port", "0", "--admin-port", "0",
         "--fleet", f"m2={ckpt},m3={ckpt}", "--buckets", "4", "--window-ms", "2",
         "--device", dev.type],
        cwd=root, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines: list[str] = []

    def _drain():
        # graftlint: disable=JGL005 — a live log streamed line by line from the daemon's stderr, read only after the process ends
        with open(os.path.join(logdir, f"{name}.log"), "w") as log:
            for line in proc.stderr:
                lines.append(line)
                log.write(line)

    t = threading.Thread(target=_drain, name=f"fleet-stderr-{name}", daemon=True)
    t.start()
    return proc, lines, t


def _fleet_ports(proc, lines, deadline_s: float = 180.0) -> tuple[int, int]:
    """``(serve_port, admin_port)`` from a daemon's stderr."""
    import re

    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        text = "".join(lines)
        served = re.search(r"# serving on [^:]+:(\d+)", text)
        admin = re.search(r"# admin endpoint on 127\.0\.0\.1:(\d+)", text)
        if served and admin:
            return int(served.group(1)), int(admin.group(1))
        if proc.poll() is not None:
            raise RuntimeError(f"fleet daemon exited rc={proc.returncode} before binding: "
                               f"{text[-2000:]}")
        time.sleep(0.05)
    raise RuntimeError("fleet daemon did not bind within the deadline")


def _peek_delta(name: str, before: dict) -> dict:
    now = obs.REGISTRY.peek(name) or {}
    return {k: v - before.get(k, 0.0) for k, v in now.items() if v - before.get(k, 0.0)}


def _run_fleet_workload(outdir: str, seed: int, scale: CampaignScale, device):
    import signal
    import threading

    from ate_replication_causalml_torch.serving import loadgen
    from ate_replication_causalml_torch.serving import router as rt
    from ate_replication_causalml_torch.serving.client import CateClient
    from ate_replication_causalml_torch.utils.checkpoint import save_fitted

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    forests = {1: _synthetic_serving_forest(rng), 2: _synthetic_serving_forest(rng)}
    ckpt_v1 = os.path.join(outdir, "model-v1.npz")
    ckpt_v2 = os.path.join(outdir, "model-v2.npz")
    save_fitted(ckpt_v1, forests[1])
    save_fitted(ckpt_v2, forests[2])
    schedule = loadgen.build_schedule(seed, scale.serve_requests, rate_hz=scale.serve_rate_hz,
                                      mix="1:2,3:2,4:1", id_prefix=f"f{seed}x",
                                      models=("default", "m2", "m3"))
    queries = loadgen.build_queries(seed, schedule, features=4)
    # Every model binds the same v1 and the rotation moves only "default"
    # to v2, so references keyed by version cover all three models.
    _offline_refs(outdir, forests, queries, dev)

    names = ("b0", "b1", "b2")
    inj = chaos.active()
    victims = inj.daemon_kill_plan(names) if inj is not None else ()
    req_before = dict(obs.REGISTRY.peek("router_requests_total") or {})
    fo_before = dict(obs.REGISTRY.peek("router_failover_total") or {})
    procs: dict[str, object] = {}
    router = serve_thread = None
    with _FaultWindow() as win:
        try:
            spawned = {n: _spawn_fleet_daemon(n, ckpt_v1, dev, outdir) for n in names}
            specs = []
            for n in names:
                proc, lines, _t = spawned[n]
                procs[n] = proc
                port, admin = _fleet_ports(proc, lines)
                specs.append(rt.BackendSpec(n, "127.0.0.1", port, admin))
            router = rt.RouterServer(rt.RouterConfig(backends=tuple(specs),
                                                     probe_interval_s=0.1))
            router.start()
            supervisor = rt.FleetSupervisor(router)
            bound: list[int] = []
            ready = threading.Event()
            serve_thread = threading.Thread(
                target=rt.serve_socket, args=(router,),
                kwargs={"on_bound": lambda p: (bound.append(p), ready.set())},
                name="fleet-router", daemon=True)
            serve_thread.start()
            if not ready.wait(timeout=30.0):
                raise RuntimeError("router did not bind")
            client = CateClient.connect("127.0.0.1", bound[0], timeout=60.0)
            half = len(schedule) // 2
            kill_at = (3 * len(schedule)) // 4
            rotation = None
            replies = []
            try:
                for i, sched in enumerate(schedule):
                    if i == half:
                        # The rolling rotation between the two halves: each
                        # daemon drains through its cordon and swaps
                        # "default" onto the same published v2, one a time.
                        rotation = supervisor.rotate_all(ckpt_v2, model="default",
                                                         timeout_s=120.0)
                    if i == kill_at:
                        for victim in victims:
                            if inj.record_daemon_kill(victim):
                                procs[victim].send_signal(signal.SIGKILL)
                    replies.append(client.predict_full(queries[i], request_id=sched.request_id,
                                                       model=sched.model, max_retries=64))
                if rotation is None:  # a one-request schedule
                    rotation = supervisor.rotate_all(ckpt_v2, model="default", timeout_s=120.0)
                # The kill must be observed before the dump: a probe tick can
                # take the victim out of the candidates before any forward
                # fails, so the remaining failures go over the ops channel
                # and the merged timeline always holds the breaker opening.
                for victim in victims:
                    for _ in range(router.config.failure_threshold):
                        if router.stats()["backends"][victim]["breaker"] == "open":
                            break
                        try:
                            router.call_backend(victim, {"op": "stats"})
                        except Exception:  # noqa: BLE001 - dead by plan
                            pass
                router.dump_fleet(os.path.join(outdir, "fleet_dump"))
                client_retries = dict(client.retry_counts)
            finally:
                client.close()
        finally:
            if router is not None:
                router.stop()
            for n in procs:
                if n not in victims:
                    procs[n].send_signal(signal.SIGTERM)
            for proc in procs.values():
                try:
                    proc.wait(timeout=60.0)
                except Exception:  # noqa: BLE001 - a wedged daemon must not
                    proc.kill()    # wedge the campaign
                    proc.wait(timeout=10.0)
            if serve_thread is not None:
                serve_thread.join(timeout=10.0)

    np.savez(os.path.join(outdir, "answers.npz"),
             rows=np.asarray([q.shape[0] for q in queries], np.int64),
             versions=np.asarray([int(h.get("model_version") or 1) for _, _, h in replies],
                                 np.int64),
             cate=np.concatenate([np.asarray(c) for c, _, _ in replies]),
             var=np.concatenate([np.asarray(v) for _, v, _ in replies]))
    _write_summary(outdir, {
        "workload": "fleet", "seed": seed, "n_requests": len(schedule),
        "request_ids": [s.request_id for s in schedule], "faults": win.collect(),
        "fleet": {
            "backends": list(names),
            "killed": sorted(victims),
            "served": len(replies),
            "rotation": rotation,
            "survivor_exit_codes": [procs[n].returncode for n in procs if n not in victims],
            "client_retries": client_retries,
            "router_requests_delta": _peek_delta("router_requests_total", req_before),
            "router_failover_delta": _peek_delta("router_failover_total", fo_before),
        },
    })


WORKLOADS: dict[str, WorkloadSpec] = {
    "sweep": WorkloadSpec("sweep", ("shard", "fs", "stage", "hang"), _run_sweep_workload),
    "matrix": WorkloadSpec("matrix", ("fs", "stage", "hang"), _run_matrix_workload),
    "serving": WorkloadSpec("serving", ("serve", "hang"), _serving_workload(rotate=False)),
    "rotation": WorkloadSpec("rotation", ("serve", "hang", "rotate"),
                             _serving_workload(rotate=True)),
    # Opt-in: three daemon processes a run, and adding it to the default
    # order would reshuffle every seed's plan.
    "fleet": WorkloadSpec("fleet", ("daemon",), _run_fleet_workload),
}
WORKLOAD_ORDER = ("sweep", "matrix", "serving", "rotation")


# ── episode execution ─────────────────────────────────────────────────


def _require_telemetry() -> None:
    """The fault accounting (summary fault lists, torn-line
    reconciliation, counter metering) reads the telemetry plane: with
    ``ATE_TPU_TELEMETRY=0`` every injection would be invisible and a
    green episode would read as a violation. Refused at config time."""
    if not obs.enabled():
        raise RuntimeError(
            "chaos campaigns need telemetry: ATE_TPU_TELEMETRY=0 hides every "
            "chaos_inject event the invariant registry accounts against — unset it "
            "to run a campaign")


def _run_workload(workload: str, outdir: str, seed: int, scale: CampaignScale,
                  device=None) -> inv.RunArtifacts:
    if os.path.isdir(outdir) and os.listdir(outdir):
        # A reused directory would resume the old journal, and its torn
        # lines would break the fault accounting.
        raise ValueError(f"campaign run dir {outdir!r} is not empty; every "
                         "episode/reference run needs a fresh directory")
    os.makedirs(outdir, exist_ok=True)
    WORKLOADS[workload].run(outdir, seed, scale, device)
    return inv.RunArtifacts(outdir)


def _episode_run(workload: str, seed: int, spec: str, outdir: str, scale: CampaignScale,
                 device=None) -> inv.RunArtifacts:
    """One workload run, chaos-armed by ``spec`` with fresh fault budgets;
    the environment variable is restored afterwards."""
    with chaos.override(spec or None):
        return _run_workload(workload, outdir, seed, scale, device)


def run_repro(workload: str, seed: int, spec: str, outdir: str,
              scale: "str | CampaignScale" = "micro",
              log: Callable[[str], None] = print, device=None) -> list[inv.Verdict]:
    """One episode, its fault-free reference and the whole registry: the
    unit the shrinker's one-line repro re-runs. The CLI exits nonzero when
    a verdict fails (that exit is the repro's contract)."""
    _require_telemetry()
    scale = resolve_scale(scale)
    obs.install_monitoring()
    ref = _episode_run(workload, seed, "", os.path.join(outdir, "ref"), scale, device)
    log(f"[repro] reference done; running {workload} under {spec!r}")
    run = _episode_run(workload, seed, spec, os.path.join(outdir, "episode"), scale, device)
    return inv.evaluate_all(run, ref)


# ── the shrinker ──────────────────────────────────────────────────────


def _ddmin(atoms: list, fails: Callable[[list], bool]) -> list:
    """Classic delta debugging over an atom list: returns a 1-minimal
    failing subset (removing any single tested chunk makes the failure
    disappear). ``fails`` must be deterministic."""
    cur = list(atoms)
    n = 2
    while len(cur) >= 2:
        chunk = max(1, len(cur) // n)
        subsets = [cur[i:i + chunk] for i in range(0, len(cur), chunk)]
        reduced = False
        for s in subsets:
            if len(s) < len(cur) and fails(s):
                cur, n, reduced = s, 2, True
                break
        if not reduced:
            for s in subsets:
                comp = [a for a in cur if a not in s]
                if comp and len(comp) < len(cur) and fails(comp):
                    cur, n, reduced = comp, max(n - 1, 2), True
                    break
        if not reduced:
            if n >= len(cur):
                break
            n = min(len(cur), n * 2)
    return cur


#: Public name: the frontier search shrinks failing knob vectors through
#: the delta-debugging core the campaign shrinks fault specs with.
ddmin = _ddmin


def shrink_episode(episode: Episode, failing: Sequence[str], ref: inv.RunArtifacts,
                   outdir: str, scale: CampaignScale, log: Callable[[str], None] = print,
                   device=None) -> dict:
    """Delta-debug ``episode.atoms`` to a minimal subset that still fails
    one of ``failing``, then confirm it with one fresh run. Every probe is
    a whole workload run against the shared reference: exact, because a
    chaos plan is a pure function of (spec, seed)."""
    cache: dict[str, bool] = {}
    runs = [0]

    def fails(atoms: list) -> bool:
        spec = compose(atoms)
        if spec in cache:
            return cache[spec]
        runs[0] += 1
        d = os.path.join(outdir, f"shrink-ep{episode.index:03d}-{runs[0]:02d}")
        log(f"[shrink] ep{episode.index}: probing {spec!r}")
        run = _episode_run(episode.workload, episode.seed, spec, d, scale, device)
        bad = any(v.invariant in failing and v.verdict == "fail"
                  for v in inv.evaluate_all(run, ref))
        cache[spec] = bad
        return bad

    minimal = _ddmin(list(episode.atoms), fails)
    spec_min = compose(minimal)
    # The repro must fail again on a clean directory, not merely have
    # failed once during the search.
    cache.pop(spec_min, None)
    confirmed = fails(minimal)
    repro = (f"ATE_TPU_CHAOS='{spec_min}' python scripts/torch_chaos_campaign.py --repro "
             f"--workload {episode.workload} --seed {episode.seed} --scale {scale.name} "
             f"--device {resolve_device(device).type}")
    return {
        "episode": episode.index,
        "workload": episode.workload,
        "seed": episode.seed,
        "failing": sorted(failing),
        "minimal_atoms": [{"scope": sc, "spec": sp} for sc, sp in minimal],
        "repro": repro,
        "confirmed": confirmed,
        "n_probe_runs": runs[0],
    }


# ── the campaign runner ───────────────────────────────────────────────


def run_campaign(
    outdir: str,
    root_seed: int | None = None,
    n_episodes: int | None = None,
    workloads: Sequence[str] | None = None,
    scale: "str | CampaignScale" = "micro",
    shrink: bool = True,
    episodes: Sequence[Episode] | None = None,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Run a campaign on ``device`` and write ``campaign_report.json`` into
    ``outdir``. ``episodes`` overrides the planner (a test plants a
    ``tamper:journal`` violation through the same engine). Returns the
    report; one root seed gives a byte-identical report file."""
    _require_telemetry()
    device = resolve_device(device)
    obs.install_monitoring()
    scale = resolve_scale(scale)
    if root_seed is None:
        root_seed = default_seed()
    if episodes is None:
        n = n_episodes if n_episodes is not None else _env_int(ENV_EPISODES, 4)
        episodes = plan_campaign(root_seed, n, workloads)
    os.makedirs(outdir, exist_ok=True)

    ep_counter = obs.counter("chaos_campaign_episodes_total",
                             "chaos-campaign episodes by workload and green/violated status")
    check_counter = obs.counter("chaos_invariant_checks_total",
                                "campaign invariant evaluations by invariant and verdict")
    refs: dict[tuple[str, int], inv.RunArtifacts] = {}
    report_eps: list[dict] = []
    violations: list[int] = []
    shrink_entries: list[dict] = []
    walls: list[float] = []
    ref_walls: dict[str, float] = {}
    shrink_walls: list[float] = []
    for ep in episodes:
        key = (ep.workload, ep.seed)
        if key not in refs:
            log(f"[campaign] reference: {ep.workload} seed={ep.seed}")
            t0 = time.monotonic()
            refs[key] = _episode_run(ep.workload, ep.seed, "",
                                     os.path.join(outdir, f"ref-{ep.workload}-{ep.seed}"),
                                     scale, device)
            ref_walls[f"{ep.workload}-{ep.seed}"] = round(time.monotonic() - t0, 3)
        t0 = time.monotonic()
        log(f"[campaign] ep{ep.index}: {ep.workload} under {ep.spec!r}")
        run = _episode_run(ep.workload, ep.seed, ep.spec,
                           os.path.join(outdir, f"ep{ep.index:03d}"), scale, device)
        walls.append(time.monotonic() - t0)
        verdicts = inv.evaluate_all(run, refs[key])
        for v in verdicts:
            check_counter.inc(1, invariant=v.invariant, verdict=v.verdict)
        failing = sorted(v.invariant for v in verdicts if v.verdict == "fail")
        status = "violated" if failing else "green"
        ep_counter.inc(1, workload=ep.workload, status=status)
        obs.emit("chaos_campaign_episode", status=status, workload=ep.workload,
                 episode=ep.index, spec=ep.spec)
        report_eps.append({
            "index": ep.index,
            "workload": ep.workload,
            "seed": ep.seed,
            "spec": ep.spec,
            "atoms": [{"scope": sc, "spec": sp} for sc, sp in ep.atoms],
            "status": status,
            "invariants": [v.as_json() for v in verdicts],
        })
        if failing:
            violations.append(ep.index)
            log(f"[campaign] ep{ep.index} VIOLATED: {failing}")
            if shrink:
                t0 = time.monotonic()
                shrink_entries.append(shrink_episode(ep, failing, refs[key], outdir, scale,
                                                     log, device))
                shrink_walls.append(round(time.monotonic() - t0, 3))

    by_workload: dict[str, dict[str, int]] = {}
    for rec in report_eps:
        by_workload.setdefault(rec["workload"], {"green": 0, "violated": 0})[rec["status"]] += 1
    if shrink_entries:
        headline = shrink_entries[0]["repro"]
    elif violations:
        headline = f"VIOLATED (unshrunk): episodes {violations}"
    else:
        headline = (f"all green: {len(report_eps)} episodes x "
                    f"{len(inv.registered_names())} invariants")
    report = {
        "schema_version": SCHEMA_VERSION,
        "root_seed": root_seed,
        "scale": scale.name,
        "invariant_registry": list(inv.registered_names()),
        "n_episodes": len(report_eps),
        "episodes": report_eps,
        "by_workload": by_workload,
        "violations": violations,
        "shrink": shrink_entries,
        "headline": headline,
    }
    # Sorted keys and no wall-clock: one root seed, one byte sequence.
    obs.atomic_write_text(os.path.join(outdir, "campaign_report.json"),
                          json.dumps(report, indent=2, sort_keys=True) + "\n")
    # The walls live beside the report, never in it.
    obs.atomic_write_json(os.path.join(outdir, "campaign_walls.json"),
                          {"episode_wall_s": [round(w, 3) for w in walls],
                           "reference_wall_s": ref_walls, "shrink_wall_s": shrink_walls})
    obs.gauge("chaos_campaign_episode_seconds",
              "wall seconds per chaos-campaign episode (last run)").set(max(walls, default=0.0))
    log(f"[campaign] {headline}")
    return report
