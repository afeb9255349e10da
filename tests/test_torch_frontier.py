"""The failure-frontier search (``scenarios/frontier.py``) and its
minimizer (``resilience/campaign.py::ddmin``) against the JAX package on
the CPU.

Exact contracts: ``ddmin``'s result and its probe sequence on the JAX
package's synthetic predicates; the knob vocabulary, the probed designs
and the fingerprints; the micro search's verdicts, coverages, failing
points, minimal knobs and probe counts equal the JAX package's (in
float32, as its search runs outside this suite), the ``repro`` lines
equal but for the module they name; two fresh runs write byte-identical
``FAILURE_ATLAS.json`` and a resumed run rewrites the same bytes,
computing no journaled probe again (only each failure's fresh
confirmation). Bias and RMSE in the atlas are within
2e-5·(1 + |ref|) of the JAX package's: per-cell estimates agree to float32
rounding (``tests/test_torch_scenarios.py``), and in the
overlap-violation corner the IPW weights, up to 1/0.02, amplify that
(seen: 1.5e-5 on a bias of 2.57).
"""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from ate_replication_causalml_torch import observability as obs
from ate_replication_causalml_torch.resilience import campaign as tcp
from ate_replication_causalml_torch.scenarios import frontier as fr
from ate_replication_causalml_tpu.resilience import campaign as jcp
from ate_replication_causalml_tpu.scenarios import frontier as jfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ATOMS = [("a", "a:1"), ("b", "b:1"), ("c", "c:1"), ("d", "d:1")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one thread for this file: its small ops, multithreaded on
    a CPU the suite's parallel workers keep busy, wait on their threads
    (``tests/test_torch_qp.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("need", [{("c", "c:1")}, {("a", "a:1"), ("d", "d:1")},
                                  {("b", "b:1"), ("c", "c:1"), ("d", "d:1")}, set(ATOMS)])
def test_ddmin_equals_the_campaigns(need):
    calls: dict = {"port": [], "jax": []}

    def pred(who):
        def fails(sub):
            calls[who].append(list(sub))
            return need <= set(sub)
        return fails

    got = tcp.ddmin(list(ATOMS), pred("port"))
    assert set(got) == need
    assert got == jcp.ddmin(list(ATOMS), pred("jax"))
    assert calls["port"] == calls["jax"]
    assert tcp._ddmin is tcp.ddmin
    assert tcp.ddmin([], pred("port")) == []


def test_knobs_designs_and_fingerprints_equal_jax():
    assert set(fr.KNOB_FIELDS) == set(jfr.KNOB_FIELDS)
    knobs = {"confounding": 6.0, "overlap": 0.02, "n": 256}
    assert fr.knobs_id(knobs) == jfr.knobs_id(knobs) == "confounding=6,n=256,overlap=0.02"
    assert fr.parse_knobs("confounding=6,n=256,overlap=0.02") == jfr.parse_knobs(
        "confounding=6,n=256,overlap=0.02")
    with pytest.raises(ValueError):
        fr.parse_knobs("wiggle=1")
    for port, ref in ((fr.micro_frontier_spec(3), jfr.micro_frontier_spec(3)),
                      (fr.default_frontier_spec(0), jfr.default_frontier_spec(0))):
        assert port.fingerprint() == ref.fingerprint()
        assert [a.points() for a in port.axes] == [a.points() for a in ref.axes]
        for axis in port.axes:
            for point in axis.points():
                assert fr.dgp_for(port.baseline, point).fields() == jfr.dgp_for(
                    ref.baseline, point).fields()
    with pytest.raises(ValueError, match="vmappable"):
        fr.FrontierSpec(axes=(), estimators=("aipw_rf",),
                        baseline=fr.micro_frontier_spec().baseline)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_frontier")
    out_a, out_b = str(base / "a"), str(base / "b")
    spec = fr.micro_frontier_spec()
    atlas_a = fr.run_frontier(spec, outdir=out_a, log=lambda s: None, device=CPU)
    atlas_b = fr.run_frontier(spec, outdir=out_b, log=lambda s: None, device=CPU)
    with jax.enable_x64(False):
        ref = jfr.run_frontier(jfr.micro_frontier_spec(), outdir=None, log=lambda s: None)
    return dict(spec=spec, out_a=out_a, out_b=out_b, atlas_a=atlas_a, atlas_b=atlas_b, ref=ref)


def _raw(out):
    with open(os.path.join(out, "FAILURE_ATLAS.json"), "rb") as f:
        return f.read()


def test_micro_frontier_equals_the_jax_package(micro):
    got, ref = micro["atlas_a"], micro["ref"]
    assert got["failures"], "the micro grid exposes the known corner"
    fail = got["failures"][0]
    assert fail["estimator"] == "ipw_logit"
    assert fail["knobs"] == fail["minimal_knobs"] == {"confounding": 6.0, "overlap": 0.02}
    assert fail["confirmed"] is True
    assert "ate_replication_causalml_torch.scenarios.frontier" in fail["repro"]
    assert len(got["failures"]) == len(ref["failures"])
    for g, r in zip(got["failures"], ref["failures"]):
        assert g["repro"].replace("causalml_torch", "causalml_tpu") == r["repro"]
        assert {k: v for k, v in g.items() if k != "repro"} == {
            k: v for k, v in r.items() if k != "repro"}
    assert got["probes"] == ref["probes"]
    for key in ("schema", "schema_version", "fingerprint", "baseline", "estimators",
                "n_reps", "refine_reps", "block_width"):
        assert got[key] == ref[key], key
    for ga, ra in zip(got["axes"], ref["axes"]):
        for gc, rc in zip(ga["cells"], ra["cells"]):
            for k in set(gc) | set(rc):
                if k in ("bias", "rmse") and rc[k] is not None:
                    assert abs(gc[k] - rc[k]) <= 2e-5 * (1 + abs(rc[k])), (k, gc, rc)
                else:
                    assert gc[k] == rc[k], (k, gc, rc)


def _computed_probes() -> float:
    snap = obs.REGISTRY.peek("scenario_frontier_probes_total") or {}
    return sum(v for k, v in snap.items() if "status=computed" in k)


def test_two_runs_byte_identical_and_resume_computes_nothing(micro):
    assert _raw(micro["out_a"]) == _raw(micro["out_b"])
    assert micro["atlas_a"]["probes"] == micro["atlas_b"]["probes"]
    before = _raw(micro["out_a"])
    c0 = _computed_probes()
    again = fr.run_frontier(micro["spec"], outdir=micro["out_a"], log=lambda s: None, device=CPU)
    assert _raw(micro["out_a"]) == before and again == micro["atlas_a"]
    # Every journaled probe block resumes; only each failure's fresh,
    # un-journaled confirmation (the JAX package's "trust nothing"
    # re-probe) is computed again.
    confirm_blocks = sum(-(-f["reps"] // micro["spec"].width())
                         for f in micro["atlas_a"]["failures"])
    assert _computed_probes() - c0 == confirm_blocks == 3
    header = open(os.path.join(micro["out_a"], "frontier.jsonl")).readline()
    assert json.loads(header)["fingerprint"] == jfr.micro_frontier_spec().fingerprint()
    with open(os.path.join(micro["out_a"], "FAILURE_ATLAS.json")) as f:
        assert json.load(f)["schema"] == jfr.FRONTIER_SCHEMA_TAG


def test_repro_line_confirms_the_failure(micro):
    fail = micro["atlas_a"]["failures"][0]
    args = fail["repro"].split()
    assert args[:3] == ["python", "-m", "ate_replication_causalml_torch.scenarios.frontier"]
    cmd = [sys.executable, "-m", args[2]] + [a.strip("'") for a in args[3:]] + ["--device", CPU]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["verdict"] == "failing"
    assert verdict["coverage"] == fail["coverage"]
