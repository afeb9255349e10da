"""The port's static analysis (``ate_replication_causalml_torch/analysis``)
held to the JAX package's analyzer on what they share, and its gate.

* The shared rules (JGL005–JGL010, JGL012–JGL021) over the JAX package's
  tree and ``scripts/`` give exactly the JAX linter's findings and
  suppressions: rule, path, line, column and message (JGL021 given the
  JAX package's ``observability/device.py``).
* The port's graftrace over the JAX tree reproduces the committed
  ``CONCURRENCY_MODEL.json`` byte for byte, and ``CONCURRENCY.md``'s
  generated section.
* The module-level fixtures of ``tests/test_graftlint.py`` and
  ``tests/test_concurrency_analysis.py`` that belong to the shared rules
  give the same findings through both analyzers at every scope.
* The gate passes on the shipped tree from a cold cache, warm and cold
  reports are identical, and the linter's process imports neither torch,
  jax nor the JAX package.

Every comparison here is exact (tolerance 0). Pure AST: no device.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

from ate_replication_causalml_torch import analysis as ta
from ate_replication_causalml_torch.analysis import concurrency as tconc
from ate_replication_causalml_torch.analysis import rules as trules
from ate_replication_causalml_torch.analysis import torchast
from ate_replication_causalml_tpu import analysis as ja
from ate_replication_causalml_tpu.analysis import rules as jrules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "ate_replication_causalml_tpu")
PORT_PKG = os.path.join(REPO, "ate_replication_causalml_torch")
JAX_DEVICE_PY = os.path.join(JAX_PKG, "observability", "device.py")

#: The JAX rules the port keeps (same id, semantics and messages).
SHARED = ("JGL005", "JGL006", "JGL007", "JGL008", "JGL009", "JGL010", "JGL012",
          "JGL013", "JGL014", "JGL015", "JGL016", "JGL017", "JGL018", "JGL019",
          "JGL020", "JGL021")

#: Every path scope the rules know, for the fixtures.
RELPATHS = ("pkg/mod.py", "pkg/ops/mod.py", "pkg/estimators/mod.py",
            "pkg/observability/mod.py", "pkg/observability/slo.py",
            "pkg/observability/export.py", "pkg/scheduler/engine.py",
            "pkg/serving/daemon.py", "pkg/serving/mod.py", "pkg/pipeline.py",
            "pkg/data/pipeline.py", "pkg/parallel/shardio.py", "pkg/parallel/mesh.py",
            "pkg/models/forest.py", "pkg/scenarios/matrix.py", "pkg/resilience/chaos.py",
            "pkg/resilience/watchdog.py", "observability/device.py")


def _tuples(findings):
    return [(f.rule, f.path, f.line, f.col, f.message) for f in findings]


def _fixtures(path: str) -> dict:
    tree = ast.parse(open(os.path.join(REPO, "tests", path), encoding="utf-8").read())
    return {n.targets[0].id: n.value.value for n in tree.body
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}


FIXTURES = {**_fixtures("test_graftlint.py"), **_fixtures("test_concurrency_analysis.py")}
SHARED_FIXTURES = sorted(n for n in FIXTURES if n[:6] in SHARED)


@pytest.fixture()
def jax_device_py():
    trules.set_device_py(JAX_DEVICE_PY)
    try:
        yield
    finally:
        trules.set_device_py(None)


@pytest.fixture(scope="module")
def jax_tree_runs():
    """Both analyzers' shared rules over the JAX package and scripts/."""
    trules.set_device_py(JAX_DEVICE_PY)
    try:
        paths = [JAX_PKG, os.path.join(REPO, "scripts")]
        return (ja.lint_paths(paths, select=list(SHARED), root=REPO),
                ta.lint_paths(paths, select=list(SHARED), root=REPO))
    finally:
        trules.set_device_py(None)


@pytest.mark.parametrize("rule", SHARED)
def test_shared_rule_matches_jax_linter_on_jax_tree(jax_tree_runs, rule):
    want, got = jax_tree_runs
    pick = lambda fs: _tuples(f for f in fs if f.rule == rule)
    assert pick(got.findings) == pick(want.findings)
    assert pick(got.suppressed) == pick(want.suppressed)
    assert got.files == want.files


def test_precreated_families_match_jax_device_py():
    assert trules.precreated_families(JAX_DEVICE_PY) == jrules.precreated_families()
    port = trules.precreated_families()
    # The port's install_monitoring loops over its REQUIRED_COUNTERS and
    # SWEEP_COUNTERS tuples, which the JAX package's reader does not follow.
    assert {"shard_attempts_total", "router_request_seconds", "sweep_stage_total"} <= port


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_model():
    tg = _load_script("torch_graftrace")
    return tconc.build_model(tg.build_program("ate_replication_causalml_tpu"))


def test_port_graftrace_reproduces_committed_jax_model(jax_model):
    with open(os.path.join(REPO, "CONCURRENCY_MODEL.json"), encoding="utf-8") as f:
        assert tconc.to_json(jax_model) == f.read()


def test_port_render_markdown_reproduces_concurrency_md(jax_model):
    """The port's ``render_markdown`` is the JAX package's, byte for byte,
    on the committed model and on the tree's, so it writes whatever the
    JAX package's ``graftrace.py --markdown`` writes into
    ``CONCURRENCY.md``. (The committed section is older than the
    committed model: the JAX package's own renderer does not reproduce it
    either, and both analyzers agree on that.)"""
    import json

    from ate_replication_causalml_tpu.analysis import concurrency as jconc

    with open(os.path.join(REPO, "CONCURRENCY_MODEL.json"), encoding="utf-8") as f:
        committed = json.load(f)
    with open(os.path.join(REPO, "CONCURRENCY.md"), encoding="utf-8") as f:
        doc = f.read()
    begin, end = "<!-- graftrace:begin -->", "<!-- graftrace:end -->"
    section = doc[doc.index(begin) + len(begin):doc.index(end)]
    for model in (committed, jax_model):
        port, jax_md = tconc.render_markdown(model), jconc.render_markdown(model)
        assert port == jax_md
        assert (section == "\n" + port) == (section == "\n" + jax_md)
        assert port.splitlines()[0] == section.splitlines()[1] == (
            "## Concurrency model (generated)")


@pytest.mark.parametrize("name", SHARED_FIXTURES)
def test_shared_fixture_same_findings_through_both(name, jax_device_py):
    source, rule = FIXTURES[name], name[:6]
    for rel in RELPATHS:
        want = ja.lint_source(source, relpath=rel, select=[rule])
        got = ta.lint_source(source, relpath=rel, select=[rule])
        assert _tuples(got.findings) == _tuples(want.findings), rel
        assert _tuples(got.suppressed) == _tuples(want.suppressed), rel


def test_shared_fixture_count():
    """Every module-level fixture of the two JAX test files is either a
    shared rule's (held here) or a JAX-only rule's (translated in
    ``test_torch_analysis_rules.py``)."""
    assert len(FIXTURES) == 61
    assert len(SHARED_FIXTURES) == 39
    assert {n[:6] for n in FIXTURES} - set(SHARED) == {
        "JGL001", "JGL002", "JGL003", "JGL004", "JGL011"}


def test_rule_table_pairs_each_torch_rule_with_its_jax_rule():
    rules = ta.all_rules()
    assert set(SHARED) < set(rules)
    torch_rules = {r for r in rules if r.startswith("TGL")}
    assert torch_rules == {"TGL001", "TGL002", "TGL003", "TGL004", "TGL011", "TGL022"}
    jax_rules = ja.all_rules()
    for rid in torch_rules - {"TGL022"}:
        jid = "JGL" + rid[3:]
        assert jid in jax_rules and jid not in rules
        assert jid in (rules[rid].__doc__ or ""), rid
    assert "JGL019" in rules["TGL022"].__doc__


def test_hot_path_table_names_real_functions():
    for rel, qual in torchast.HOT_PATH:
        path = os.path.join(PORT_PKG, rel)
        with open(path, encoding="utf-8") as f:
            module = ta.core.ModuleInfo(path, f"ate_replication_causalml_torch/{rel}", f.read())
        assert qual in torchast.collect_functions(module), (rel, qual)


def test_reporters_name_the_port_linter():
    import json

    res = ta.lint_source("import json\njson.dump({}, open('x', 'w'))\n", relpath="m.py")
    log = json.loads(ta.render_sarif(res))
    assert log["runs"][0]["tool"]["driver"]["name"] == "torch-graftlint"
    assert {"TGL003", "JGL005"} <= {r["id"] for r in log["runs"][0]["tool"]["driver"]["rules"]}
    assert "torch-graftlint: 2 finding(s)" in ta.render_human(res)
    assert json.loads(ta.render_json(res))["rules"]["TGL022"]["name"] == "cross-stream-handoff"


def test_cache_cold_warm_parity(tmp_path):
    tree = os.path.join(PORT_PKG, "scheduler")
    cache_dir = str(tmp_path / "cache")
    uncached = ta.lint_paths([tree], root=REPO)
    cold = ta.lint_paths([tree], root=REPO, cache=ta.ResultCache(cache_dir))
    warm = ta.lint_paths([tree], root=REPO, cache=ta.ResultCache(cache_dir))
    for r in (cold, warm):
        assert _tuples(r.findings) == _tuples(uncached.findings)
        assert _tuples(r.suppressed) == _tuples(uncached.suppressed)
    assert os.path.isfile(os.path.join(cache_dir, "torch-graftlint-cache.json"))


def test_gate_passes_cold_and_warm_reports_are_identical(tmp_path):
    env = dict(os.environ, PYTHON=sys.executable,
               TORCH_GRAFTLINT_CACHE=str(tmp_path / "cache"))
    runs = [subprocess.run(["bash", os.path.join(REPO, "scripts", "torch_check_static.sh")],
                           capture_output=True, text=True, cwd=REPO, timeout=300, env=env)
            for _ in range(2)]
    for proc in runs:
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "check_static(torch): OK" in proc.stdout
        assert "torch-graftlint: 0 finding(s)" in proc.stdout
        assert "model current" in proc.stdout
        assert "torch_check_concurrency_model: OK" in proc.stdout
    assert runs[0].stdout == runs[1].stdout


def test_linter_process_imports_no_torch_jax_or_jax_package():
    code = "\n".join([
        "import runpy, sys",
        f"sys.argv = [{os.path.join(REPO, 'scripts', 'torch_graftlint.py')!r}, '--list-rules']",
        "try:",
        f"    runpy.run_path(sys.argv[0], run_name='__main__')",
        "except SystemExit as e:",
        "    assert e.code == 0, e.code",
        "bad = [m for m in ('torch', 'jax', 'ate_replication_causalml_tpu') if m in sys.modules]",
        "assert not bad, bad",
        "print('clean')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "TGL003" in proc.stdout and proc.stdout.rstrip().endswith("clean")


def test_port_model_is_committed_and_valid():
    checker = _load_script("torch_check_concurrency_model")
    with open(checker.MODEL_PATH, encoding="utf-8") as f:
        raw = f.read()
    assert checker.validate_model(raw) == []
    tg = _load_script("torch_graftrace")
    assert tconc.to_json(tconc.build_model(tg.build_program())) == raw
