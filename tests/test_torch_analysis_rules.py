"""The port's torch rules (TGL001–TGL004, TGL011, TGL022): each JAX
fixture of the counterpart JGL rule (``tests/test_graftlint.py``),
translated to the port's idiom — ``jax.jit`` becomes a captured or
memoized body, ``jax.random`` the port's ``ops/random.py``, a traced
``if`` an ``.item()`` test in a captured function — fires at the same
lines as the JAX rule does on the original, and each quiet twin stays
quiet. Then the planted violations in the port's own files: each new
rule finds them, and the shipped file is quiet.

Every comparison is exact (finding lines, tolerance 0). Pure AST: no
device.
"""

import ast
import os

import pytest

from ate_replication_causalml_torch.analysis import lint_source, lint_sources
from ate_replication_causalml_torch.analysis import rules as trules
from ate_replication_causalml_tpu.analysis import lint_source as jax_lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "ate_replication_causalml_torch"


def _lines(source, rule, relpath="pkg/mod.py"):
    return [f.line for f in lint_source(source, relpath=relpath, select=[rule]).findings]


def _jax_lines(source, rule, relpath="pkg/mod.py"):
    return [f.line for f in jax_lint_source(source, relpath=relpath, select=[rule]).findings]


def _fixtures() -> dict:
    tree = ast.parse(open(os.path.join(REPO, "tests", "test_graftlint.py"),
                          encoding="utf-8").read())
    return {n.targets[0].id: n.value.value for n in tree.body
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}


#: The JAX rule fixtures of ``tests/test_graftlint.py``, by name.
JAX_FIXTURES = _fixtures()


def jax_fixture(name: str) -> str:
    return JAX_FIXTURES[name]


def _read(rel):
    with open(os.path.join(REPO, PKG, rel), encoding="utf-8") as f:
        return f.read()


# ---------------------------------------------------------------- TGL001

TGL001_BAD_DIRECT = """\
import functools
import torch

@functools.lru_cache(maxsize=None)
def quantilish(n):
    if torch.cuda.is_available():           # line 6
        return n
    return -n
"""

TGL001_BAD_TRANSITIVE = """\
import functools
import torch
import torch

def helper(x):
    dt = torch.float16 if torch.backends.cuda.matmul.allow_tf32 else torch.float32  # line 6
    return x.to(dt)

@functools.lru_cache(maxsize=None)
def entry(x, n):
    return helper(x) * n
"""

TGL001_BAD_ENV_AND_GLOBAL = """\
import os
import functools

_MODE = "fast"
_CACHE = {}

def set_mode(m):
    global _MODE
    _MODE = m

@functools.cache
def f(x):
    flag = os.environ.get("ATE_TPU_X")      # line 13
    if _MODE == "fast":                     # line 14
        _ = _CACHE
    return x
"""

TGL001_GOOD = """\
import functools
import torch

_CONST = 3.0

def dispatcher(x):
    # uncaptured host-side gate: allowed
    if torch.cuda.is_available():
        return _impl_a(x)
    return _impl_b(x)

@functools.lru_cache(maxsize=None)
def _impl_a(x):
    return x * _CONST

@functools.lru_cache(maxsize=None)
def _impl_b(x):
    return -x
"""

TGL001_LOCAL_SHADOW = (
    "import functools\n"
    "_SCRATCH = {}\n"
    "_SCRATCH[0] = 1\n"
    "@functools.cache\n"
    "def g(x):\n"
    "    _SCRATCH = x * 2\n"
    "    return _SCRATCH + 1\n"
)

TGL001_CALL_FORM = (
    "import torch\n"
    "def factory(sample):\n"
    "    def run(x):\n"
    "        return x if torch.cuda.device_count() == 1 else -x\n"
    "    return torch.cuda.make_graphed_callables(run, (sample,))\n"
)

TGL001_CAPTURE_REGION = (
    "import os\n"
    "import torch\n"
    "def helper(x):\n"
    "    return x * float(os.getenv('SCALE', '1'))\n"      # line 4
    "def capture(g, x):\n"
    "    y = helper(x)\n"
    "    with torch.cuda.graph(g):\n"
    "        out = helper(x)\n"
    "        scale = os.environ['SCALE']\n"                 # line 9
    "    return out, y, scale\n"
)

TGL001_CASES = [
    ("JGL001_BAD_DIRECT", TGL001_BAD_DIRECT, [6]),
    ("JGL001_BAD_TRANSITIVE", TGL001_BAD_TRANSITIVE, [6]),
    ("JGL001_BAD_ENV_AND_GLOBAL", TGL001_BAD_ENV_AND_GLOBAL, [13, 14]),
    ("JGL001_GOOD", TGL001_GOOD, []),
]


@pytest.mark.parametrize("jax_name,source,lines", TGL001_CASES, ids=[c[0] for c in TGL001_CASES])
def test_tgl001_translated_fixture_fires_where_jgl001_does(jax_name, source, lines):
    assert _jax_lines(jax_fixture(jax_name), "JGL001") == lines
    assert _lines(source, "TGL001") == lines


def test_tgl001_transitive_message_names_the_root():
    res = lint_source(TGL001_BAD_TRANSITIVE, relpath="m.py", select=["TGL001"])
    assert "reached via memoized 'entry'" in res.findings[0].message


def test_tgl001_local_shadow_and_call_form_and_capture_region():
    assert _lines(TGL001_LOCAL_SHADOW, "TGL001") == []
    assert _lines(TGL001_CALL_FORM, "TGL001") == [4]
    # The region's own read and the helper it reaches; the helper's call
    # outside the capture is not what makes it captured.
    assert _lines(TGL001_CAPTURE_REGION, "TGL001") == [4, 9]


# ---------------------------------------------------------------- TGL002

_R = "from ate_replication_causalml_torch.ops import random as rnd"


def _to_port_random(src: str) -> str:
    """JAX fixture -> the port's PRNG: same lines, ``ops/random.py``."""
    return src.replace("import jax\n", _R + "\n").replace("jax.random.", "rnd.")


TGL002_NAMES = ["JGL002_BAD_DOUBLE_SPEND", "JGL002_BAD_LOOP", "JGL002_BAD_DISCARD",
                "JGL002_GOOD", "JGL002_GOOD_LOOPS", "JGL002_BAD_FOLD_DUP", "JGL002_GOOD_FOLD",
                "JGL002_BAD_KEYS_ARRAY", "JGL002_GOOD_FOLD_RETHREAD",
                "JGL002_GOOD_FOLD_BRANCHES", "JGL002_BAD_FOLD_SAME_ARM",
                "JGL002_BAD_FOLD_DERIVED"]


@pytest.mark.parametrize("jax_name", TGL002_NAMES)
@pytest.mark.parametrize("relpath", ["pkg/mod.py", "pkg/scenarios/dgp.py"])
def test_tgl002_translated_fixture_fires_where_jgl002_does(jax_name, relpath):
    src = jax_fixture(jax_name)
    port = _to_port_random(src)
    assert "jax" not in port
    assert _lines(port, "TGL002", relpath) == _jax_lines(src, "JGL002", relpath)


@pytest.mark.parametrize("src", [
    "import jax\ndef sample(key, n):\n    return [jax.random.normal(key, (4,)) for _i in range(n)]\n",
    "import jax\ndef sample(key, n):\n    ks = jax.random.split(key, n)\n"
    "    return [jax.random.normal(ks[i], (4,)) for i in range(n)]\n",
    "import jax\ndef sample(key, n):\n    out = []\n"
    "    for i, key in enumerate(jax.random.split(key, n)):\n"
    "        out.append(jax.random.normal(key, (2,)))\n    return out\n",
    "import jax\ndef f(key):\n    return jax.random.split(key, 4)[1:]\n",
    "import jax\n\ndef f(key):\n    key = jax.random.fold_in(key, 7)\n"
    "    return jax.random.fold_in(key, 7)\n",
], ids=["comprehension", "hygienic", "tuple_target", "slice_return", "param_rethread"])
def test_tgl002_inline_jax_cases(src):
    for rel in ("pkg/mod.py", "pkg/scenarios/dgp.py"):
        assert _lines(_to_port_random(src), "TGL002", rel) == _jax_lines(src, "JGL002", rel)


def test_tgl002_messages_and_suppression():
    res = lint_source(_to_port_random(jax_fixture("JGL002_BAD_DOUBLE_SPEND")), relpath="m.py",
                      select=["TGL002"])
    assert "first use at line 4" in res.findings[0].message
    dup = _to_port_random(jax_fixture("JGL002_BAD_FOLD_DUP")).replace(
        "# line 5: same (key, data)", "# graftlint: disable=TGL002")
    res = lint_source(dup, relpath="pkg/scenarios/dgp.py", select=["TGL002"])
    assert res.findings == [] and [f.line for f in res.suppressed] == [5]


# ---------------------------------------------------------------- TGL003

TGL003_BAD = """\
import torch
import torch.nn.functional as F

# captured: torch.cuda.make_graphed_callables below
def relu_ish(x, y):
    if (x > 0).item():                      # line 6
        return x
    while (y > x).item():                   # line 8
        y = y - 1.0
    return y

graphed = torch.cuda.make_graphed_callables(relu_ish, (torch.zeros(1), torch.zeros(1)))
"""

TGL003_GOOD = """\
import functools
import torch
import torch

def f(x: torch.Tensor, mode, flag=None):
    if mode == "fast":          # a Python argument: fine
        return x
    if x.shape[0] > 2:          # shape is host metadata: fine
        return -x
    if x.dtype == torch.float32:  # dtype: fine
        return x * 2
    if flag is None:            # `is None` is decided on the host
        return x
    def inner(x):
        if x:                   # shadowed param of nested def: fine
            return 1
        return 0
    return x

g = torch.cuda.make_graphed_callables(f, (torch.zeros(3),))
"""

TGL003_CALL_FORM = (
    "import torch\n"
    "def body(x, flag):\n"
    "    if flag.item():\n"
    "        return -x\n"
    "    return x\n"
    "run = torch.cuda.make_graphed_callables(body, (torch.zeros(1), torch.zeros(1)))\n"
)


def test_tgl003_translated_fixtures_fire_where_jgl003_does():
    assert _jax_lines(jax_fixture("JGL003_BAD"), "JGL003") == [6, 8]
    assert _lines(TGL003_BAD, "TGL003") == [6, 8]
    assert _jax_lines(jax_fixture("JGL003_GOOD"), "JGL003") == []
    assert _lines(TGL003_GOOD, "TGL003") == []
    assert _lines(TGL003_CALL_FORM, "TGL003") == [3]
    # flag a Python bool (JAX: static_argnums) — quiet
    assert _lines(TGL003_CALL_FORM.replace("flag.item()", "flag"), "TGL003") == []


TGL003_FORMS = """\
import torch

def streaming_level_loop(codes: torch.Tensor, w: torch.Tensor, perm, n: int):
    a = codes.sum().item()                          # line 4
    b = w.tolist()                                  # line 5
    c = float(w.max())                              # line 6
    if (w > 0).any():                               # line 7
        pass
    torch.cuda.synchronize()                        # line 9
    idx = torch.nonzero(w)                          # line 10
    keep = w > 0
    d = w[keep]                                     # line 12
    e = torch.as_tensor(perm, device=w.device)      # line 13
    h = torch.from_numpy(perm)
    w.copy_(h)                                      # line 15
    f = w[:, 1:] * 2                                # static selection: fine
    if w.shape[0] > n:                              # shape: fine
        pass
    g = int(n)                                      # a Python int: fine
    return a, b, c, idx, d, e, f, g
"""


def test_tgl003_sync_forms_on_a_hot_function():
    rel = f"{PKG}/models/forest.py"
    assert _lines(TGL003_FORMS, "TGL003", rel) == [4, 5, 6, 7, 9, 10, 12, 13, 15]
    # Off the hot-path table the same body is not the rule's business.
    assert _lines(TGL003_FORMS, "TGL003", f"{PKG}/data/pipeline.py") == []
    assert _lines(TGL003_FORMS.replace("streaming_level_loop", "fit_once"), "TGL003", rel) == []


def test_tgl003_planted_item_in_streaming_level_loop():
    rel = f"{PKG}/models/forest.py"
    src = _read("models/forest.py")
    assert _lines(src, "TGL003", rel) == []
    anchor = "        perm = bitrev_perm(level)\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, anchor + "        n_live = ids.max().item()\n")
    line = planted[:planted.index("n_live")].count("\n") + 1
    res = lint_source(planted, relpath=rel, select=["TGL003"])
    assert [f.line for f in res.findings] == [line]
    assert "hot function 'streaming_level_loop'" in res.findings[0].message


def test_tgl003_shipped_hot_syncs_are_each_suppressed_with_a_reason():
    for rel in ("models/forest.py", "models/causal_forest.py", "ops/random.py", "ops/hist.py"):
        res = lint_source(_read(rel), relpath=f"{PKG}/{rel}", select=["TGL003"])
        assert res.findings == [], rel
        src = _read(rel).splitlines()
        for f in res.suppressed:
            comment = src[f.line - 2] if "disable=TGL003" in src[f.line - 2] else src[f.line - 1]
            assert "disable=TGL003 — " in comment, (rel, f.line)


# ---------------------------------------------------------------- TGL004

TGL004_BAD = """\
import numpy as np
import torch

def f(x, v):
    a = torch.as_tensor(x, dtype=torch.float64)     # line 5
    b = torch.zeros(3, dtype=torch.double)         # line 6
    c = torch.full((3,), v).double()               # line 7
    return a, b, c
"""

TGL004_GOOD = """\
import numpy as np
import torch

def f(x, v, out):
    a = torch.as_tensor(x, dtype=torch.float32)
    b = torch.full((3,), float(v), dtype=out.dtype)  # explicit dtype: fine
    c = out.dtype == torch.float64                  # a dtype test pins nothing
    return a, b, c
"""


def test_tgl004_translated_fixtures_fire_where_jgl004_does():
    for rel in ("pkg/ops/mod.py", "pkg/estimators/mod.py"):
        assert _jax_lines(jax_fixture("JGL004_BAD"), "JGL004", rel) == [5, 6, 7]
        assert _lines(TGL004_BAD, "TGL004", rel) == [5, 6, 7]
        assert _lines(TGL004_GOOD, "TGL004", rel) == []
    assert _lines(TGL004_BAD, "TGL004", "pkg/data/mod.py") == []


TGL004_PRECISION = """\
import torch

torch.backends.cuda.matmul.allow_tf32 = False               # the pin: fine
torch.backends.cudnn.allow_tf32 = True                      # line 4
torch.set_float32_matmul_precision("high")                  # line 5
torch.set_float32_matmul_precision("highest")               # fine
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = True   # line 7
with torch.autocast("cuda"):                                # line 8
    pass
"""


def test_tgl004_precision_forms_anywhere():
    for rel in ("pkg/mod.py", "pkg/serving/daemon.py", "pkg/ops/mod.py"):
        assert _lines(TGL004_PRECISION, "TGL004", rel) == [4, 5, 7, 8]


def test_tgl004_planted_allow_tf32_true():
    rel = f"{PKG}/__init__.py"
    src = _read("__init__.py")
    assert _lines(src, "TGL004", rel) == []
    anchor = "torch.backends.cuda.matmul.allow_tf32 = False\n"
    planted = src.replace(anchor, "torch.backends.cuda.matmul.allow_tf32 = True\n")
    assert planted != src
    line = src[:src.index(anchor)].count("\n") + 1
    assert _lines(planted, "TGL004", rel) == [line]


# ---------------------------------------------------------------- TGL011

TGL011_BAD = """\
import torch

def predict_values(leaf_stats, node_of_row, leaf_value):
    stats = torch.index_select(leaf_stats, 0, node_of_row)   # line 4: gather
    vals = leaf_value[node_of_row]                      # line 5: gather
    return stats, vals

def _tree_route_slow(codes, feat_ids):
    picked = codes[:, feat_ids]                         # line 9: gather
    return picked
"""

TGL011_GOOD = """\
import torch
import torch

def predict_values(leaf_stats, node_of_row, level):
    oh = torch.nn.functional.one_hot(node_of_row, leaf_stats.shape[0]).float()
    stats = oh @ leaf_stats                 # one-hot matmul
    table = leaf_stats[level][:4]           # constant index + slice: fine
    chans = [stats[..., i] for i in (1, 2)] # loop-constant index: fine
    return stats, table, chans

def grow_one(leaf_value, node_of_row):
    return leaf_value[node_of_row]          # grow path: out of scope
"""


def test_tgl011_translated_fixtures_fire_where_jgl011_does():
    rel = "pkg/models/causal_forest.py"
    assert _jax_lines(jax_fixture("JGL011_BAD"), "JGL011", rel) == [4, 5, 9]
    assert _lines(TGL011_BAD, "TGL011", rel) == [4, 5, 9]
    assert _lines(TGL011_BAD.replace("torch.index_select(leaf_stats, 0, node_of_row)",
                                     "leaf_stats.gather(0, node_of_row)"), "TGL011", rel) \
        == [4, 5, 9]
    assert _lines(TGL011_BAD, "TGL011", "pkg/ops/mod.py") == []
    assert _lines(TGL011_GOOD, "TGL011", "pkg/models/forest.py") == []
    src = TGL011_BAD.replace(
        "    vals = leaf_value[node_of_row]                      # line 5: gather",
        "    vals = leaf_value[node_of_row]  # graftlint: disable=TGL011")
    res = lint_source(src, relpath=rel, select=["TGL011"])
    assert [f.line for f in res.findings] == [4, 9]
    assert [f.line for f in res.suppressed] == [5]


# ---------------------------------------------------------------- TGL022

#: (file, the line removed or replaced, what stands in its place)
TGL022_PLANTS = {
    # The causal forest's warmed predict captures through models/forest.py's WarmGraph.
    "causal_forest_wait_stream": ("models/forest.py",
                                  "        torch.cuda.current_stream(dev).wait_stream(side)\n", ""),
    "cache_wait_event": ("scheduler/cache.py",
                         "            torch.cuda.current_stream(self._device).wait_event(event)\n",
                         "            pass\n"),
    "daemon_record_stream": ("serving/daemon.py", "                        t.record_stream(reader)\n",
                             "                        pass\n"),
}


@pytest.mark.parametrize("plant", sorted(TGL022_PLANTS))
def test_tgl022_planted_removal_is_found_and_the_shipped_file_is_quiet(plant):
    rel, line, stand_in = TGL022_PLANTS[plant]
    src = _read(rel)
    path = f"{PKG}/{rel}"
    assert lint_sources([(path, src)], select=["TGL022"]).findings == []
    assert src.count(line) == 1
    planted = src.replace(line, stand_in)
    got = lint_sources([(path, planted)], select=["TGL022"]).findings
    assert len(got) == 1, got
    assert got[0].rule == "TGL022" and got[0].path == path


TGL022_FIXTURES = {
    "no_join": ("""\
import torch

def side_work(x, dev):
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):            # line 5
        y = x * 2
    return y
""", [5]),
    "joined": ("""\
import torch

def side_work(x, dev):
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream(dev).wait_stream(side)
    y.record_stream(torch.cuda.current_stream(dev))
    return y
""", []),
    "event_store_without_wait": ("""\
import torch

class Cache:
    def __init__(self):
        self._values = {}
        self._events = {}

    def put(self, k, v):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream())
        self._values[k] = v
        self._events[k] = ev

    def get(self, k):
        ev = self._events.get(k)                 # line 15
        return self._values[k]
""", [15]),
}


@pytest.mark.parametrize("name", sorted(TGL022_FIXTURES))
def test_tgl022_fixtures(name):
    src, lines = TGL022_FIXTURES[name]
    res = lint_sources([("pkg/models/mod.py", src)], select=["TGL022"])
    assert [f.line for f in res.findings] == lines


# ------------------------------------------------ the card's sync report

def test_classify_sync_sites_holds_hot_sites_to_tgl003():
    """``chip_smoke.py``'s ``path_static`` gate: a site inside the hot path
    must be a TGL003 finding (suppressed in the tree), a site outside is
    reported for the record, and a hot site the rule missed is named."""
    sites = {f"{PKG}/models/forest.py:{_hot_line()}": 9,
             f"{PKG}/models/forest.py:1": 2}
    rep = trules.classify_sync_sites(REPO, sites)
    assert rep["missed"] == []
    assert list(rep["hot"]) == [f"{PKG}/models/forest.py:{_hot_line()}"]
    assert rep["hot"][f"{PKG}/models/forest.py:{_hot_line()}"]["function"] == \
        "streaming_level_loop"
    assert list(rep["other"]) == [f"{PKG}/models/forest.py:1"]
    # A hot line with no finding is missed.
    miss = f"{PKG}/models/forest.py:{_hot_line() + 1}"
    assert trules.classify_sync_sites(REPO, {miss: 1})["missed"] == [miss]


def _hot_line() -> int:
    src = _read("models/forest.py").splitlines()
    return next(i + 1 for i, ln in enumerate(src)
                if "perm_t = torch.as_tensor(perm, device=dev)" in ln)
