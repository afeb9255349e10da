"""Chaos harness: seeded, env-configurable fault injection.

Port of ``ate_replication_causalml_tpu/resilience/chaos.py``: the same
grammar, the same pure decisions, the same ``chaos_inject`` events and
``chaos_injections_total`` counts. One env var arms deterministic fault
injectors at the boundaries the sweep owns::

    ATE_TPU_CHAOS="shard:p=0.2,seed=7;fs:torn_write;device:drop=1"

Grammar: scopes separated by ``;``, each ``name:item,item,...`` where an
item is ``key=value`` or a bare flag. The scopes the port's sweep
honours, where the JAX package's sweep honours them:

* ``shard``: ``p`` (selection probability per ``(pool, shard)`` site),
  ``seed``, ``times`` (failing attempts per selected site, default 1),
  ``pool`` (substring filter). A selected shard's first ``times``
  attempts raise :class:`~.errors.ChaosShardFault`
  (``parallel/retry.py::run_shards``, the forests' chunk loops);
* ``device``: ``drop=k``: ``probe_devices`` reports the last ``k``
  devices unhealthy (``times`` probes affected; 0 = every probe);
* ``fs``: ``torn_write``: the next journal append is written truncated,
  the artifact a kill mid-append leaves; ``corrupt_npz``: the next
  checkpoint archive (``utils/checkpoint.py::save_fitted``) is written
  truncated, which ``load_fitted`` must refuse; ``times`` budgets each;
* ``stage``: ``fail=<substring>``: the first ``times`` sweep stages whose
  name contains the substring raise :class:`~.errors.ChaosStageFault`
  (graceful degradation);
* ``hang``: ``scope=worker,ms=..,p=..,seed=..,times=..``: a selected
  engine node (hashed by name) sleeps ``ms`` before it runs, the stall
  the engine's watchdog must report (``scope=dispatch``: the serving
  dispatcher sleeps inside a batch; ``scope=retrain``: the retrain
  supervisor's fit, hashed by model id, inside its heartbeat-stamped
  attempt); nothing raises;
* ``tamper``: ``journal,delta=..,times=..``: the next journaled row's
  ``ate`` is perturbed by ``delta`` after the in-memory copy was taken,
  silent corruption only a bit-identity check against a fault-free run
  can catch;
* ``serve``: ``p``, ``seed``, ``times``: a request id selected by the
  pure ``(seed, "serve", id)`` hash is refused typed on its first
  ``times`` attempts while the daemon degrades and reloads its
  checkpoint (``serving/daemon.py``);
* ``rotate``: the train-to-serve failure modes, each a bare flag
  budgeted by ``times``: ``retrain`` (the retrain supervisor's fit
  raises :class:`~.errors.ChaosRotateFault`, transient, so it is
  refit), ``corrupt`` (the next published candidate is truncated after
  its digest went in: the rotation's re-verify must refuse it),
  ``mid_swap`` (the rotation's installer raises between verify and
  swap: a typed refusal, never a half-installed model), and
  ``verify_ms=<float>`` (the rotation's verify sleeps that long while
  serving goes on).

The ``daemon`` scope belongs to the router, not ported yet: it parses
and has no effect, as in a JAX sweep.

Injection decisions are pure functions of ``(seed, scope, site)``, never
of call order or a global RNG, so a chaos run is reproducible and,
because retried shards carry their own keys, its surviving results are
bit for bit a fault-free run's. Decisions are host-side hashing: nothing
here touches a tensor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
from typing import Callable, Iterator, Sequence

from ate_replication_causalml_torch.observability import events as _events
from ate_replication_causalml_torch.observability import registry as _registry
from ate_replication_causalml_torch.resilience.errors import (
    ChaosShardFault,
    ChaosSpecError,
)

ENV_VAR = "ATE_TPU_CHAOS"

#: scope -> key -> expected type (bool keys are the bare flags).
_SCOPE_SCHEMA: dict[str, dict[str, type]] = {
    "shard": {"p": float, "seed": int, "times": int, "pool": str},
    "fs": {"torn_write": bool, "corrupt_npz": bool, "times": int},
    "device": {"drop": int, "times": int},
    "stage": {"fail": str, "times": int},
    "serve": {"p": float, "seed": int, "times": int},
    "hang": {"scope": str, "ms": float, "p": float, "seed": int,
             "times": int},
    "rotate": {"corrupt": bool, "mid_swap": bool, "retrain": bool,
               "verify_ms": float, "times": int},
    "tamper": {"journal": bool, "delta": float, "times": int},
    "daemon": {"kill": int, "seed": int},
}

#: lanes the ``hang`` scope may target — the heartbeat-stamped sites.
HANG_SCOPES = ("dispatch", "worker", "retrain")

_SCOPE_DEFAULTS: dict[str, dict[str, object]] = {
    "shard": {"p": 0.0, "seed": 0, "times": 1, "pool": ""},
    "fs": {"torn_write": False, "corrupt_npz": False, "times": 1},
    "device": {"drop": 0, "times": 0},  # times=0: every probe
    "stage": {"fail": "", "times": 1},
    "serve": {"p": 0.0, "seed": 0, "times": 1},
    "hang": {"scope": "", "ms": 0.0, "p": 0.0, "seed": 0, "times": 1},
    "rotate": {"corrupt": False, "mid_swap": False, "retrain": False,
               "verify_ms": 0.0, "times": 1},
    "tamper": {"journal": False, "delta": 1e-3, "times": 1},
    "daemon": {"kill": 0, "seed": 0},
}


def _record_injection(scope: str, site: str, **detail) -> None:
    """The single audit channel every injected fault reports through:
    one counter family + one ``chaos_inject`` event shape, shared by
    the injector and the plan-based wrapper so the two can never
    diverge.

    ``chaos_inject`` is a point event, emitted from inside the faulted
    work's own span — so the trace exporter (observability/trace.py)
    renders every injection as an instant marker on the worker/lane
    track that was running the victim, exactly where a reader of the
    timeline would look for the cause of the failure slice."""
    _registry.counter(
        "chaos_injections_total", "faults injected by the chaos harness"
    ).inc(1, scope=scope)
    _events.emit("chaos_inject", status="injected", scope=scope,
                 site=site, **detail)


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Parsed ``ATE_TPU_CHAOS`` spec: ``scopes[name][key]`` with
    defaults filled in. Only scopes named in the spec are armed."""

    spec: str
    scopes: dict  # name -> {key: value}

    def scope(self, name: str) -> dict | None:
        return self.scopes.get(name)


def parse_chaos(spec: str) -> ChaosConfig:
    """Parse the grammar above; unknown scopes/keys and uncoercible
    values raise :class:`ChaosSpecError` — a malformed chaos config must
    fail the run at arm time, not silently inject nothing."""
    scopes: dict[str, dict[str, object]] = {}
    for raw_scope in spec.split(";"):
        raw_scope = raw_scope.strip()
        if not raw_scope:
            continue
        name, sep, body = raw_scope.partition(":")
        name = name.strip()
        schema = _SCOPE_SCHEMA.get(name)
        if schema is None:
            raise ChaosSpecError(
                f"unknown chaos scope {name!r} in {spec!r} "
                f"(known: {', '.join(sorted(_SCOPE_SCHEMA))})"
            )
        params = dict(_SCOPE_DEFAULTS[name])
        if sep:
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                key, eq, value = item.partition("=")
                key = key.strip()
                if key not in schema:
                    raise ChaosSpecError(
                        f"unknown key {key!r} for chaos scope {name!r} "
                        f"(known: {', '.join(sorted(schema))})"
                    )
                typ = schema[key]
                if not eq:
                    if typ is not bool:
                        raise ChaosSpecError(
                            f"chaos key {name}:{key} needs a value "
                            f"({key}=<{typ.__name__}>)"
                        )
                    params[key] = True
                    continue
                try:
                    params[key] = (
                        value.strip() if typ is str
                        else typ(value.strip()) if typ is not bool
                        else value.strip().lower() in ("1", "true", "yes", "on")
                    )
                except ValueError as e:
                    raise ChaosSpecError(
                        f"chaos key {name}:{key}={value!r} is not a "
                        f"{typ.__name__}"
                    ) from e
        if name == "daemon" and int(params["kill"]) < 0:
            raise ChaosSpecError(
                f"daemon:kill={params['kill']} must be >= 0 "
                "(the number of fleet daemons to SIGKILL mid-replay)"
            )
        if name == "hang" and params["scope"] not in HANG_SCOPES:
            # scope is REQUIRED: a hang spec that names no lane injects
            # nothing, and an operator who believes stalls are flowing
            # while nothing runs is the exact silent failure this
            # config-time raise discipline exists to prevent.
            raise ChaosSpecError(
                f"hang:scope={params['scope']!r} is not a stamped lane "
                f"(scope is required; known: {', '.join(HANG_SCOPES)})"
            )
        scopes[name] = params
    return ChaosConfig(spec=spec, scopes=scopes)


def _unit(seed: int, *parts: str) -> float:
    """Deterministic uniform in [0, 1) from (seed, parts) — sha256, no
    global RNG, independent of call order."""
    h = hashlib.sha256(("%d|" % seed + "|".join(parts)).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


class ChaosInjector:
    """Stateful fault budgets over a parsed :class:`ChaosConfig`.

    *Selection* is stateless (hash of seed + site); *budgets* (``times``)
    are process state guarded by a lock, so one injector arms a whole
    run coherently across the sweep driver, shard loops and writers.
    """

    def __init__(self, config: ChaosConfig):
        self.config = config
        self._lock = threading.Lock()
        self._shard_left: dict[tuple[str, int], int] = {}
        fs = config.scope("fs") or _SCOPE_DEFAULTS["fs"]
        self._torn_left = int(fs["times"]) if fs.get("torn_write") else 0
        self._corrupt_left = int(fs["times"]) if fs.get("corrupt_npz") else 0
        self._serve_attempts: dict[str, int] = {}
        dev = config.scope("device")
        self._device_left = int(dev["times"]) if dev else 0
        self._device_unlimited = bool(dev) and int(dev["times"]) == 0
        stage = config.scope("stage")
        self._stage_left = int(stage["times"]) if stage else 0
        self._hang_attempts: dict[str, int] = {}
        rot = config.scope("rotate") or _SCOPE_DEFAULTS["rotate"]
        self._rotate_left = {kind: (int(rot["times"]) if rot.get(kind) else 0)
                             for kind in ("corrupt", "mid_swap", "retrain")}
        self._rotate_verify_left = int(rot["times"]) if float(rot["verify_ms"]) > 0 else 0
        tam = config.scope("tamper") or _SCOPE_DEFAULTS["tamper"]
        self._tamper_left = int(tam["times"]) if tam.get("journal") else 0

    # ── bookkeeping ───────────────────────────────────────────────────

    _record = staticmethod(_record_injection)

    # ── shard scope ───────────────────────────────────────────────────

    def shard_should_fail(self, pool: str, shard: int, attempt: int) -> bool:
        cfg = self.config.scope("shard")
        if cfg is None or cfg["p"] <= 0.0:
            return False
        if cfg["pool"] and cfg["pool"] not in pool:
            return False
        key = (pool, shard)
        with self._lock:
            left = self._shard_left.get(key)
            if left is None:
                selected = _unit(
                    int(cfg["seed"]), "shard", pool, str(shard)
                ) < float(cfg["p"])
                left = int(cfg["times"]) if selected else 0
            if left <= 0:
                self._shard_left[key] = 0
                return False
            self._shard_left[key] = left - 1
        self._record("shard", f"{pool}/{shard}", pool=pool, shard=shard,
                     attempt=attempt)
        return True

    def wrap_shard(
        self, shard_fn: Callable[[int], object], pool: str
    ) -> Callable[[int], object]:
        """The ``run_shards`` injection point: a selected shard's first
        ``times`` attempts raise before the real thunk runs (so the
        injected fault costs no device work, like a preemption would)."""
        attempts: dict[int, int] = {}

        def chaotic(i: int):
            attempts[i] = attempts.get(i, 0) + 1
            if self.shard_should_fail(pool, i, attempts[i]):
                raise ChaosShardFault(
                    f"chaos: injected shard fault (pool={pool!r}, shard={i}, "
                    f"attempt={attempts[i]})"
                )
            return shard_fn(i)

        return chaotic

    # ── fs scope ──────────────────────────────────────────────────────

    def torn_line(self, line: str, site: str) -> str:
        """Checkpoint-journal injection point: return ``line`` truncated
        mid-record (the artifact a kill mid-append leaves) while the
        budget lasts. The newline is kept so the tear stays confined to
        this record — the run continues, and the reader's torn-line
        skip + recompute-on-resume path is what gets exercised."""
        with self._lock:
            if self._torn_left <= 0:
                return line
            self._torn_left -= 1
        body = line.rstrip("\n")
        cut = max(1, len(body) // 2)
        self._record("fs", site, kind="torn_write", dropped_chars=len(body) - cut)
        return body[:cut] + "\n"

    def truncate_npz(self, nbytes: int, site: str) -> int | None:
        """Checkpoint-writer injection point: the length to truncate an
        ``nbytes``-long archive to (None: budget spent or scope off), so
        the file on disk is what a torn write would leave."""
        with self._lock:
            if self._corrupt_left <= 0:
                return None
            self._corrupt_left -= 1
        cut = max(1, (nbytes * 3) // 5)
        self._record("fs", site, kind="corrupt_npz", dropped_bytes=nbytes - cut)
        return cut

    # ── tamper scope ──────────────────────────────────────────────────

    def tamper_line(self, line: str, site: str) -> str:
        """Silent-corruption injection point: perturb the
        ``ate`` field of a serialized journal row by ``delta`` while the
        budget lasts. The returned line PARSES — no torn-line skip, no
        digest mismatch, no typed error: the corruption is invisible to
        every reader the system owns, which is exactly what the
        campaign's bit-identity invariant (and nothing else) must
        catch. Rows without a finite numeric ``ate`` (the journal's
        ``__config__`` header, already-failed rows) pass through
        without consuming budget, so the first REAL result row is the
        deterministic victim."""
        cfg = self.config.scope("tamper")
        if cfg is None or not cfg.get("journal"):
            return line
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return line
        ate = rec.get("ate") if isinstance(rec, dict) else None
        if isinstance(ate, bool) or not isinstance(ate, (int, float)):
            return line
        with self._lock:
            if self._tamper_left <= 0:
                return line
            self._tamper_left -= 1
        rec["ate"] = ate + float(cfg["delta"])
        self._record("tamper", site, kind="journal",
                     delta=float(cfg["delta"]), method=str(rec.get("method")))
        return json.dumps(rec) + "\n"

    # ── device scope ──────────────────────────────────────────────────

    def drop_devices(self, healthy: Sequence) -> list:
        """``probe_devices`` injection point: report the last ``drop``
        devices unhealthy, simulating a preempted slice / dropped
        tunnel. Deterministic — the same devices stay dead on re-probe,
        so redistribution onto the surviving subset is what's tested."""
        cfg = self.config.scope("device")
        devs = list(healthy)
        if cfg is None or int(cfg["drop"]) <= 0 or not devs:
            return devs
        if not self._device_unlimited:
            with self._lock:
                if self._device_left <= 0:
                    return devs
                self._device_left -= 1
        k = min(int(cfg["drop"]), len(devs))
        self._record("device", "probe_devices", dropped=k,
                     remaining=len(devs) - k)
        return devs[: len(devs) - k]

    # ── stage scope ───────────────────────────────────────────────────

    def take_stage_fault(self, method: str, *, record: bool = True) -> bool:
        """Whether this stage draws an injected fault (consuming one
        unit of the ``times`` budget). Selection is the substring match;
        the budget makes it first-``times``-matches — *in whatever order
        this is called*, which is why the concurrent sweep driver plans
        all stage faults up front in declared order
        (:meth:`plan_stage_faults`) instead of racing workers for the
        budget."""
        cfg = self.config.scope("stage")
        if cfg is None or not cfg["fail"] or cfg["fail"] not in method:
            return False
        with self._lock:
            if self._stage_left <= 0:
                return False
            self._stage_left -= 1
        if record:
            self._record("stage", method, fail=cfg["fail"])
        return True

    def record_stage_fault(self, method: str) -> None:
        """Emit the injection event/counter for a *planned* stage fault
        at the moment it is actually raised. Planning selects without
        recording so an aborted sweep never reports a fault injected on
        a stage that was skipped."""
        cfg = self.config.scope("stage")
        self._record("stage", method, fail=cfg["fail"] if cfg else "")

    def plan_stage_faults(self, methods: Sequence[str]) -> frozenset[str]:
        """Consume the stage-fault budget against ``methods`` in the
        given (declared) order and return the set that must fail —
        the deterministic plan the concurrent sweep injects from, so
        worker completion order can never change *which* stages the
        budget selects. Selection is recorded when the fault is raised
        (:meth:`record_stage_fault`), not here."""
        return frozenset(
            m for m in methods if self.take_stage_fault(m, record=False)
        )

    # ── serve scope ───────────────────────────────────────────────────

    def take_serve_fault(self, request_id: str | int) -> bool:
        """Serving-request injection point: whether THIS attempt of
        ``request_id`` draws an injected fault. Selection is the pure
        ``(seed, "serve", id)`` hash, per id and not per arrival order;
        a selected id's first ``times`` attempts fault, so a client that
        retries under the same id converges."""
        cfg = self.config.scope("serve")
        if cfg is None or cfg["p"] <= 0.0:
            return False
        rid = str(request_id)
        if _unit(int(cfg["seed"]), "serve", rid) >= float(cfg["p"]):
            return False
        with self._lock:
            attempt = self._serve_attempts.get(rid, 0) + 1
            self._serve_attempts[rid] = attempt
        if attempt > int(cfg["times"]):
            return False
        self._record("serve", f"req/{rid}", request_id=rid, attempt=attempt)
        return True

    # ── rotate scope ──────────────────────────────────────────────────

    def take_rotate_fault(self, kind: str, site: str) -> bool:
        """Fleet-rotation injection point: whether this ``kind``
        (``corrupt`` / ``mid_swap`` / ``retrain``) draws a fault,
        consuming one unit of its ``times`` budget. The kinds are
        budgeted independently, so one spec stacks failure modes
        (``rotate:retrain,corrupt,times=2``)."""
        with self._lock:
            if self._rotate_left.get(kind, 0) <= 0:
                return False
            self._rotate_left[kind] -= 1
        self._record("rotate", site, kind=kind)
        return True

    def rotate_verify_delay_s(self, site: str) -> float:
        """Slow-verify injection point: seconds the rotation's verify
        must sleep (0.0 when the scope is off or its budget spent)."""
        cfg = self.config.scope("rotate")
        if cfg is None or float(cfg["verify_ms"]) <= 0:
            return 0.0
        with self._lock:
            if self._rotate_verify_left <= 0:
                return 0.0
            self._rotate_verify_left -= 1
        delay = float(cfg["verify_ms"]) / 1e3
        self._record("rotate", site, kind="slow_verify", delay_s=delay)
        return delay

    # ── hang scope ────────────────────────────────────────────────────

    def hang_delay_s(self, scope: str, site: str) -> float:
        """Stall-injection point for the heartbeat-stamped lanes
       : seconds THIS unit of work must sleep, or 0.0. Only
        the configured ``scope`` lane is eligible; selection is the
        pure ``(seed, "hang", scope, site)`` hash (per site, not per
        arrival order), and a selected site's first ``times`` units
        stall. The sleep happens INSIDE
        the stamped work unit, so the lane's heartbeat age grows and
        the watchdog's detection path is exactly what a real wedge
        would walk. Nothing raises and no result changes — a stall-free
        rerun of the same stream is bit-identical by construction."""
        cfg = self.config.scope("hang")
        if (
            cfg is None or cfg["scope"] != scope
            or float(cfg["p"]) <= 0.0 or float(cfg["ms"]) <= 0.0
        ):
            return 0.0
        key = f"{scope}/{site}"
        if _unit(int(cfg["seed"]), "hang", scope, str(site)) >= float(cfg["p"]):
            return 0.0
        with self._lock:
            attempt = self._hang_attempts.get(key, 0) + 1
            self._hang_attempts[key] = attempt
        if attempt > int(cfg["times"]):
            return 0.0
        delay = float(cfg["ms"]) / 1e3
        self._record("hang", key, lane=scope, delay_s=delay,
                     attempt=attempt)
        return delay

def plan_faults(
    shard_fn: Callable[[int], object], fail_plan: dict[int, int]
) -> Callable[[int], object]:
    """Plan-based shard injection: ``fail_plan[i] = k`` makes shard
    ``i``'s first ``k`` attempts raise :class:`ChaosShardFault`. The
    exact-plan complement to the probabilistic ``shard`` scope (tests
    that need "shard 3 fails twice" rather than "20% of shards fail"),
    reporting through the same ``chaos_inject`` event channel."""
    remaining = dict(fail_plan)

    def chaotic(i: int):
        if remaining.get(i, 0) > 0:
            remaining[i] -= 1
            _record_injection("shard", f"plan/{i}", shard=i)
            raise ChaosShardFault(f"injected fault on shard {i}")
        return shard_fn(i)

    return chaotic


# ── process-wide arming ───────────────────────────────────────────────

_INJECTORS: dict[str, ChaosInjector] = {}
_ARM_LOCK = threading.Lock()


def active() -> ChaosInjector | None:
    """The armed injector for the current ``ATE_TPU_CHAOS`` value, or
    None when chaos is off. Injectors are cached per spec string so
    fault *budgets* are shared across injection points — one arming
    covers a whole run coherently. The cache lives until :func:`reset`:
    ``run_sweep`` resets at run start so each sweep gets full budgets
    (and so a malformed spec fails there, at config time); library
    callers driving injection points directly should do the same, or
    depleted budgets from an earlier run (including an A→B→A env
    flip back to an already-armed spec) silently inject nothing."""
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    inj = _INJECTORS.get(spec)
    if inj is None:
        with _ARM_LOCK:
            inj = _INJECTORS.get(spec)
            if inj is None:
                inj = _INJECTORS[spec] = ChaosInjector(parse_chaos(spec))
    return inj


def reset() -> None:
    """Drop all armed injectors (tests: fresh budgets per case)."""
    with _ARM_LOCK:
        _INJECTORS.clear()


@contextlib.contextmanager
def override(spec: str | None) -> Iterator[ChaosInjector | None]:
    """Test helper: arm ``spec`` (None/"" disarms) for the duration of
    the block with fresh budgets, restoring the env var after."""
    old = os.environ.get(ENV_VAR)
    reset()
    if spec:
        os.environ[ENV_VAR] = spec
    else:
        os.environ.pop(ENV_VAR, None)
    try:
        yield active()
    finally:
        if old is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = old
        reset()
