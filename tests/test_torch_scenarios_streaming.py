"""The scenario matrix's runner and streaming aggregates
(``scenarios/aggregate.py``, ``scenarios/matrix.py``) on the CPU, held
to the JAX package.

One port micro matrix (the two micro DGPs at n = 96 × naive, ipw_logit
and aipw_logit; 16 replicates in width-8 blocks) runs once in a
module-scoped fixture with its companion legs: a full-journal rerun, an
extension to 24 replicates (one new block a column), a rows-mode run at
the same width, and a rows-mode run with the sequential scheduler. The
JAX package's matrix runs once on the same spec (rows mode, float32).

Exact contracts: the streaming states equal ``fold_rows`` of the rows
run bit for bit (all 18 sums: one torch ``batch_stats``, every lane sum
in ``fixed_sum``'s order); the engine modes give equal states and equal
rows; the rerun computes nothing and the extension only the new blocks,
with 0 compile events (kernel builds and graph captures: none on the
CPU); the journal header is the JAX package's byte for byte; the
aggregate counts (cells, ok, se, cover and reject hits, histogram
cells) equal the JAX package's fold of its own rows.

Bounds: the float sums (Σerr, Σerr², Σtau) against the JAX package's
fold: |Δ| ≤ 1e-5·(1 + |ref|) (per-cell estimates within 2e-7 of the
JAX package's, ``tests/test_torch_scenarios.py``; 24 cells a column).
"""

import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch import scenarios as sc
from ate_replication_causalml_torch.resilience import chaos
from ate_replication_causalml_torch.scenarios import matrix as mx
from ate_replication_causalml_torch.scenarios.batched import (
    ScenarioEstimator,
    _est_naive,
    compile_event_count,
)
from ate_replication_causalml_tpu import scenarios as jsc

CPU = "cpu"
REPS = 16
WIDTH = 8
EXT = 8
N = 96
QUIET = dict(log=lambda s: None, device=CPU)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file: its small ops, multithreaded on
    a CPU the suite's parallel workers keep busy, wait on their threads
    (``tests/test_torch_qp.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── epilogue / AggState units ─────────────────────────────────────────


KNOWN = [
    (1.0, 0.1, 1.0),    # covered, rejects H0
    (1.0, 0.1, 2.0),    # err -1: outside the CI
    (2.0, float("nan"), 1.0),    # err +1 but SE-less: moments only
    (float("nan"), 0.1, 1.0),    # failed cell
]


def test_fold_rows_known_answers():
    state = sc.fold_rows(KNOWN, width=2)
    assert state.n_cells == 4 and state.n_ok == 3 and state.n_se == 2
    assert state.cover_hits == 1 and state.reject_hits == 2
    assert state.sum_err == 0.0 and state.sum_err2 == 2.0
    assert sum(state.hist_cells()) == 3
    assert state.hist_cells()[0] == 0 and state.hist_cells()[-1] == 0
    summ = state.summary()
    assert summ["n_failed"] == 1
    assert summ["coverage"] == 0.5 and summ["power"] == 1.0
    assert summ["bias"] == 0.0 and summ["rmse"] == pytest.approx((2.0 / 3.0) ** 0.5)
    with jax.enable_x64(False):
        ref = jsc.fold_rows(KNOWN, width=2)
    assert state.stats == ref.stats
    assert state.summary() == ref.summary()
    assert sc.STAT_FIELDS == jsc.STAT_FIELDS and sc.N_STATS == jsc.N_STATS
    assert sc.AGG_SCHEMA_TAG == jsc.AGG_SCHEMA_TAG


def test_agg_state_merges_by_addition_and_saturates():
    rows = [(0.5 * i, 0.1, 0.4 * i) for i in range(8)]
    whole = sc.fold_rows(rows, width=4)
    merged = sc.fold_rows(rows[:4], width=4).merge(sc.fold_rows(rows[4:], width=4))
    assert whole.stats == merged.stats
    with pytest.raises(ValueError):
        sc.AggState((0.0,) * (sc.N_STATS - 1))
    # a huge error lands in the overflow cell, a huge negative one in the
    # underflow cell (clamped before the integer cast)
    tail = sc.fold_rows([(1e30, 1.0, 0.0), (-1e30, 1.0, 0.0)], width=2)
    assert tail.hist_cells()[0] == 1 and tail.hist_cells()[-1] == 1


def test_batch_stats_same_bits_on_any_lane_order_of_padding():
    """The epilogue's sums are fixed_sum's: the same lanes give the same
    bits whether they come as float32 tensors built here or through
    fold_rows' numpy chunks."""
    rng = np.random.default_rng(0)
    ate = rng.normal(size=8).astype(np.float32)
    se = rng.uniform(0.05, 0.2, 8).astype(np.float32)
    tau = rng.normal(size=8).astype(np.float32)
    mask = np.asarray([1.0] * 6 + [0.0] * 2, np.float32)
    direct = sc.batch_stats(*(torch.from_numpy(a) for a in (ate, se, tau, mask)))
    folded = sc.fold_rows(list(zip(ate[:6], se[:6], tau[:6])), width=8)
    assert sc.AggState.from_array(direct).stats == folded.stats


# ── the micro matrix ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("torch_streaming") / "matrix")
    obs.install_monitoring()
    sc.clear_executables()
    spec = sc.micro_matrix_spec(n_reps=REPS, batch_width=WIDTH, n=N, rows=False)

    c0 = compile_event_count()
    rep = sc.run_matrix(spec, outdir=outdir, **QUIET)
    d_cold = compile_event_count() - c0
    header = open(os.path.join(outdir, "cells.jsonl")).readline()

    c0 = compile_event_count()
    rep_resumed = sc.run_matrix(spec, outdir=outdir, **QUIET)
    d_resume = compile_event_count() - c0

    spec_ext = dataclasses.replace(spec, n_reps=REPS + EXT)
    c0 = compile_event_count()
    rep_ext = sc.run_matrix(spec_ext, outdir=outdir, **QUIET)
    d_ext = compile_event_count() - c0

    rows_spec = dataclasses.replace(spec_ext, rows=True)
    rep_rows = sc.run_matrix(rows_spec, **QUIET)
    rep_rows_seq = sc.run_matrix(rows_spec, scheduler="sequential", **QUIET)
    rep_agg_seq = sc.run_matrix(spec_ext, scheduler="sequential", **QUIET)

    jspec = jsc.micro_matrix_spec(n_reps=REPS + EXT, batch_width=WIDTH, n=N, rows=True)
    with jax.enable_x64(False):
        jax_rows = jsc.run_matrix(jspec, log=lambda s: None)
    return dict(spec=spec, outdir=outdir, rep=rep, rep_resumed=rep_resumed, rep_ext=rep_ext,
                rep_rows=rep_rows, rep_rows_seq=rep_rows_seq, rep_agg_seq=rep_agg_seq,
                jax_rows=jax_rows, header=header, d_cold=d_cold, d_resume=d_resume,
                d_ext=d_ext)


def _by_column(cells):
    by: dict = {}
    for r in cells:
        by.setdefault(r["column"], []).append(r)
    return {c: sorted(rows, key=lambda r: r["rep"]) for c, rows in by.items()}


def _fold(rows):
    return sc.fold_rows([(r["ate"], r["se"], r["tau_true"]) for r in rows], width=WIDTH)


def test_streaming_run_is_aggregate_shaped(stream_run):
    rep = stream_run["rep"]
    assert rep.mode == "aggregate"
    assert rep.n_columns == 6 and not rep.skipped_columns
    assert rep.n_computed == 6 * REPS and rep.n_failed == 0
    assert not rep.cells
    assert rep.n_blocks == 6 * (REPS // WIDTH)
    assert set(rep.states) == set(rep.columns)
    for agg in rep.columns.values():
        assert agg["n_cells"] == REPS and agg["n_failed"] == 0
        assert {"coverage", "power", "bias", "rmse", "coverage_mc_se", "sketches"} <= set(agg)


def test_streaming_bit_identical_to_materialized_fold(stream_run):
    """Every column's resumed-and-extended streaming state equals the
    fold of the rows-mode cells in the same width-8 segments (all 18
    sums), and the engine modes agree bit for bit."""
    by_col = _by_column(stream_run["rep_rows"].cells)
    states = stream_run["rep_ext"].states
    assert set(by_col) == set(states)
    for col, rows in by_col.items():
        assert states[col].stats == _fold(rows).stats, col
        assert stream_run["rep_agg_seq"].states[col].stats == states[col].stats, col
    seq = {r["method"]: r for r in stream_run["rep_rows_seq"].cells}
    for r in stream_run["rep_rows"].cells:
        s = seq[r["method"]]
        assert (r["ate"], r["se"], r["tau_true"]) == (s["ate"], s["se"], s["tau_true"])


def test_block_resume_and_extend_reps_zero_compiles(stream_run):
    assert stream_run["d_cold"] == 0  # the CPU builds no kernel and captures no graph
    r = stream_run["rep_resumed"]
    assert r.n_computed == 0 and r.n_resumed == 6 * REPS and r.n_blocks == 0
    assert stream_run["d_resume"] == 0
    e = stream_run["rep_ext"]
    assert e.n_computed == 6 * EXT and e.n_resumed == 6 * REPS and e.n_blocks == 6
    assert stream_run["d_ext"] == 0
    for col, st in stream_run["rep"].states.items():
        assert st.n_cells == REPS, col


def test_journal_header_and_blocks(stream_run):
    """The header is the JAX package's for the same spec; the journal
    holds one packed record a block."""
    jspec = jsc.micro_matrix_spec(n_reps=REPS, batch_width=WIDTH, n=N, rows=False)
    assert json.loads(stream_run["header"]) == {"method": "__config__",
                                                "fingerprint": jspec.fingerprint()}
    assert stream_run["header"] == json.dumps({"method": "__config__",
                                               "fingerprint": jspec.fingerprint()}) + "\n"
    path = os.path.join(stream_run["outdir"], "cells.jsonl")
    blocks = 6 * ((REPS + EXT) // WIDTH)
    assert os.path.getsize(path) <= (blocks + 2) * 1024
    with open(path) as f:
        body = [json.loads(line) for line in f][1:]
    assert len(body) == blocks
    assert all(r["schema"] == sc.AGG_SCHEMA_TAG and len(r["stats"]) == sc.N_STATS
               and all(len(run) == 2 for run in r["reps"]) for r in body)


def test_states_against_the_jax_package(stream_run):
    """Counts equal, float sums within the stated bound, of the JAX
    package's fold of its own rows; its rows' coverage and power equal
    the port's rows'."""
    jax_cols = _by_column(stream_run["jax_rows"].cells)
    states = stream_run["rep_ext"].states
    fields = list(sc.STAT_FIELDS)
    for col, rows in jax_cols.items():
        with jax.enable_x64(False):
            ref = jsc.fold_rows([(r["ate"], r["se"], r["tau_true"]) for r in rows], width=WIDTH)
        got = states[col]
        for i, (g, w) in enumerate(zip(got.stats, ref.stats)):
            name = fields[i] if i < len(fields) else f"hist{i - len(fields)}"
            if name in ("sum_err", "sum_err2", "sum_tau"):
                assert abs(g - w) <= 1e-5 * (1 + abs(w)), (col, name, g, w)
            else:
                assert g == w, (col, name, g, w)
        port = stream_run["rep_rows"].columns[col]
        jx = stream_run["jax_rows"].columns[col]
        assert (port["n_cells"], port["n_ok"], port["coverage"], port["power"]) == (
            jx["n_cells"], jx["n_ok"], jx["coverage"], jx["power"])
    assert sc.compare_cells(stream_run["rep_rows"].cells, stream_run["jax_rows"].cells)[
        "missing"] == []


def test_rows_journal_staled_by_schema_tag_assert(tmp_path):
    base = sc.micro_matrix_spec(n_reps=8, batch_width=8, n=N, rows=False)
    spec = dataclasses.replace(base, dgps=base.dgps[1:])
    out = str(tmp_path / "agg")
    rep = sc.run_matrix(spec, outdir=out, **QUIET)
    journal = os.path.join(out, "cells.jsonl")
    rep_rows = sc.run_matrix(dataclasses.replace(spec, rows=True), outdir=out, **QUIET)
    assert rep_rows.n_resumed == 0 and rep_rows.n_computed == 3 * 8
    assert os.path.exists(journal + ".stale")

    out2 = str(tmp_path / "lying")
    rep2 = sc.run_matrix(spec, outdir=out2, **QUIET)
    journal2 = os.path.join(out2, "cells.jsonl")
    with open(journal2, "a") as f:
        f.write(json.dumps({"method": "hetero_confounded:naive:0",
                            "column": "hetero_confounded:naive", "rep": 0, "ate": 0.0,
                            "se": 1.0, "tau_true": 0.0, "status": "ok"}) + "\n")
    logs: list = []
    rep3 = sc.run_matrix(spec, outdir=out2, log=logs.append, device=CPU)
    assert os.path.exists(journal2 + ".stale")
    assert any("schema tag" in s for s in logs)
    assert rep3.n_resumed == 0 and rep3.n_computed == 3 * 8
    for col in rep2.states:
        assert rep3.states[col].stats == rep2.states[col].stats, col
    assert rep.n_computed == 3 * 8
    # the re-seeded header makes the set-aside journal resumable again
    rep4 = sc.run_matrix(spec, outdir=out2, **QUIET)
    assert rep4.n_computed == 0 and rep4.n_resumed == 3 * 8


def test_degrade_under_a_chaos_stage_fault(tmp_path):
    """A planned stage fault fails exactly its block (a failed-block
    record and a ``scenario_batch_failed`` event); the rerun recomputes
    only that block, to the fault-free run's state."""
    spec = sc.MatrixSpec(dgps=(dataclasses.replace(sc.STOCK_DGPS["calibration"], n=N),),
                         estimators=("naive", "ipw_logit"), n_reps=8, batch_width=4)
    clean = sc.run_matrix(spec, **QUIET)
    out = str(tmp_path / "chaos")
    obs.EVENTS.clear()
    with chaos.override("stage:fail=calibration:ipw_logit#b1"):
        rep = sc.run_matrix(spec, outdir=out, **QUIET)
    assert rep.n_failed == 4 and rep.n_computed == 12
    assert rep.columns["calibration:ipw_logit"]["n_failed"] == 4
    events = [e for e in obs.EVENTS.records() if e.get("name") == "scenario_batch_failed"]
    assert len(events) == 1 and events[0]["attrs"]["column"] == "calibration:ipw_logit"
    with open(os.path.join(out, "cells.jsonl")) as f:
        recs = [json.loads(line) for line in f][1:]
    assert [r["status"] for r in recs].count("failed") == 1
    again = sc.run_matrix(spec, outdir=out, **QUIET)
    assert again.n_computed == 4 and again.n_resumed == 12 and again.n_failed == 0
    for col, st in clean.states.items():
        assert again.states[col].stats == st.stats, col


def test_sigterm_drains_and_resumes(tmp_path, monkeypatch):
    """SIGTERM mid-matrix (the CLI's drain_on_sigterm): the in-flight
    block commits, the rest is not scheduled, and a rerun completes the
    matrix to the straight run's states."""
    calls = {"n": 0}

    def naive_then_term(spec, x, w, y, key):
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return _est_naive(spec, x, w, y, key)

    monkeypatch.setitem(sc.SCENARIO_ESTIMATORS, "naive_term",
                        ScenarioEstimator("naive_term", naive_then_term, vmapped=False,
                                          needs_tall=False))
    spec = sc.MatrixSpec(dgps=(dataclasses.replace(sc.STOCK_DGPS["calibration"], n=N),),
                         estimators=("naive_term",), n_reps=6, batch_width=2)
    out = str(tmp_path / "drain")
    rep = sc.run_matrix(spec, outdir=out, scheduler="sequential", drain_on_sigterm=True,
                        **QUIET)
    assert rep.drained and rep.n_computed == 2 and rep.n_blocks == 1
    rest = sc.run_matrix(spec, outdir=out, scheduler="sequential", **QUIET)
    assert rest.n_resumed == 2 and rest.n_computed == 4 and not rest.drained
    calls["n"] = 100
    straight = sc.run_matrix(spec, scheduler="sequential", **QUIET)
    assert rest.states == straight.states


def test_cli_writes_the_report(tmp_path):
    out = str(tmp_path / "cli")
    rep = mx.main(["--out", out, "--reps", "4", "--batch", "4", "--dgps", "calibration",
                   "--estimators", "naive", "--device", CPU])
    assert rep.n_computed == 4
    with open(os.path.join(out, "matrix_report.json")) as f:
        report = json.load(f)
    assert report["mode"] == "aggregate" and report["n_blocks"] == 1
    assert os.path.exists(os.path.join(out, "metrics.json"))
