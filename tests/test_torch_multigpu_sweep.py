"""``run_sweep(use_mesh=True)`` on two gloo ranks at the campaign's MICRO
scale (1,200 rows, 16 trees of depth 4, 600 ADMM iterations): the
``mesh:`` line, the rows in ``SWEEP_METHODS`` order and finite, the
concurrent engine's rows equal to the sequential sweep's, rank 0 alone
writing, a rerun computing nothing, and a one-rank run refusing to
resume a two-rank journal.

The sequential sweep and the dry run (``dryrun_multigpu``: every leg,
its sweep on the concurrent engine) run in two worlds at once: the plain
coordinate descent of Belloni's 462 columns, a Python loop, is most of
each sweep's minute on the CPU.
"""

from __future__ import annotations

import json
import math
import os
import threading

import pytest
import torch

import _torch_rank_bodies as bodies
from ate_replication_causalml_torch import pipeline as tp
from ate_replication_causalml_torch.parallel.dryrun import dryrun_multigpu, micro_sweep_config
from ate_replication_causalml_torch.parallel.spawn import run_ranks

A = 2


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_sweep")
    outs = {"seq": str(root / "seq"), "conc": str(root / "conc")}
    got: dict = {}

    def world(name, fn):
        try:
            got[name] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
            got[name] = e

    # The concurrent sweep is the dry run's sweep leg (every leg of
    # dryrun_multigpu on two gloo ranks, its sweep into outs["conc"]).
    threads = [threading.Thread(target=world, args=("seq", lambda: run_ranks(
                   bodies.sweep_body, A, backend="gloo", device="cpu",
                   args=(outs["seq"], "sequential", True), timeout=240))),
               threading.Thread(target=world, args=("dry", lambda: dryrun_multigpu(
                   A, backend="gloo", device="cpu", timeout=240, sweep_out=outs["conc"])))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v in got.values():
        if isinstance(v, BaseException):
            raise v
    got["conc"] = [{"run": {"rows": d["sweep"], "oracle": d["sweep_oracle"],
                            "computed": d["sweep_computed"], "mesh": [d["mesh_line"]]}}
                   for d in got["dry"]]
    return dict(outs=outs, **got)


def test_dryrun_legs_finite_on_two_ranks(swept):
    for d in swept["dry"]:
        assert d["mesh"] == (2, 1) and d["forest_trees"] == 2 * A
        assert all(math.isfinite(d[k]) for k in ("tau", "se", "cf_ate", "cf_se", "lambda_min"))


def _same(a, b) -> bool:
    """Rows equal bit for bit, NaN equal to NaN."""
    return len(a) == len(b) and all(
        x == y or (isinstance(x, float) and isinstance(y, float) and math.isnan(x)
                   and math.isnan(y)) for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def test_mesh_line_rows_in_order_and_finite(swept):
    for name in ("seq", "conc"):
        for rank in swept[name]:
            run = rank["run"]
            assert run["mesh"] == [f"mesh: {A} devices — tree + fold axes active"]
            assert [r[0] for r in run["rows"]] == list(tp.SWEEP_METHODS)
            assert all(math.isfinite(r[1]) and r[5] == "ok" for r in run["rows"])
            assert run["computed"] == len(tp.SWEEP_METHODS) + 1


def test_concurrent_rows_equal_sequential_and_ranks_agree(swept):
    seq = swept["seq"][0]["run"]
    for name in ("seq", "conc"):
        for rank in swept[name]:
            assert _same(rank["run"]["rows"], seq["rows"])
            assert rank["run"]["oracle"] == seq["oracle"]


def test_rank_zero_alone_writes_and_a_rerun_computes_nothing(swept):
    for name in ("seq", "conc"):
        with open(os.path.join(swept["outs"][name], "results.jsonl")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        # One header and one line a row: a second writer would double them.
        assert [r["method"] for r in recs].count("__config__") == 1
        assert len(recs) == 1 + len(tp.SWEEP_METHODS) + 1
        for f in ("report.json", "REPORT.md", "metrics.json", "events.jsonl"):
            assert os.path.exists(os.path.join(swept["outs"][name], f)), f
    for rank in swept["seq"]:
        assert rank["rerun"]["computed"] == 0
        assert rank["rerun"]["resumed"] == len(tp.SWEEP_METHODS) + 1
        assert _same(rank["rerun"]["rows"], rank["run"]["rows"])


def test_one_rank_resume_refuses_a_two_rank_journal(swept, tmp_path):
    """The mesh size is in the fingerprint: a one-rank run sets the
    two-rank journal aside instead of resuming its rows."""
    import shutil

    path = str(tmp_path / "results.jsonl")
    shutil.copy(os.path.join(swept["outs"]["seq"], "results.jsonl"), path)
    cpu = torch.device("cpu")
    cfg = micro_sweep_config()
    two = tp._Checkpoint(path, tp._fingerprint(cfg, None, cpu, A), log=lambda s: None,
                         write=False)
    assert len(two.done) == len(tp.SWEEP_METHODS) + 1
    one = tp._Checkpoint(path, tp._fingerprint(cfg, None, cpu), log=lambda s: None)
    assert one.done == {} and os.path.exists(path + ".stale")
