"""Contract tests for the port's R shim
(``ate_replication_causalml_torch/r/ate_functions_torch.R``), the checks of
``tests/test_rshim_contract.py`` run against the port's shim and bridge.

No R interpreter exists on either machine, so the shim cannot execute
here. Its contract is pinned from both sides instead:

* static: every ``.bridge()$name`` the shim calls exists in the port's
  ``rbridge`` and is passed the session's device; every exported wrapper
  the reference API needs is defined (``torch_init`` and
  ``causal_forest_torch`` in place of ``tpu_init`` and
  ``causal_forest_tpu``); delimiters balance; every quirk knob is declared
  and passed through; the driver notebook sources this shim;
* dynamic: the payload shapes reticulate marshals (``.cols`` sends a named
  list of plain numeric vectors, a dict of float lists in Python;
  ``.as_row`` reads ``res$Method/ATE/lower_ci/upper_ci`` and maps NaN to
  NA) round-trip through the port's bridge on the CPU.
"""

import inspect
import math
import os
import re

import numpy as np

from ate_replication_causalml_torch import rbridge
from tests.test_rshim_contract import _r_function_blocks, _reticulate_payload

_R_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "ate_replication_causalml_torch", "r",
)
_SHIM = os.path.join(_R_DIR, "ate_functions_torch.R")

_REQUIRED_EXPORTS = {
    "naive_ate", "ate_condmean_ols", "prop_score_weight", "prop_score_ols",
    "ate_condmean_lasso", "ate_lasso", "prop_score_lasso", "doubly_robust",
    "doubly_robust_glm", "belloni", "double_ml", "residual_balance_ATE",
    "logistic_propensity", "causal_forest_torch", "torch_init",
}

_COMPAT_KNOBS = {
    "doubly_robust": {"compat"},
    "doubly_robust_glm": {"compat"},
    "double_ml": {"se_mode", "crossfit"},
    "belloni": {"compat"},
    "causal_forest_torch": {"variance_compat"},
}


def _shim_source():
    with open(_SHIM) as f:
        return f.read()


def test_shim_bridge_targets_exist():
    src = _shim_source()
    assert 'reticulate::import("ate_replication_causalml_torch.rbridge")' in src
    targets = set(re.findall(r"\.bridge\(\)\$(\w+)", src))
    assert len(targets) == 14, sorted(targets)
    for name in targets:
        assert callable(getattr(rbridge, name, None)), f"shim calls rbridge.{name}: missing"
        assert "device" in inspect.signature(getattr(rbridge, name)).parameters, name


def _bridge_calls(src):
    """The argument text of each ``.bridge()$name(...)`` call."""
    out = []
    for m in re.finditer(r"\.bridge\(\)\$\w+\(", src):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        out.append(src[m.end() : i - 1])
    return out


def test_every_bridge_call_passes_the_device():
    calls = _bridge_calls(_shim_source())
    assert len(calls) == 14
    for call in calls:
        assert re.search(r"device = \.torch\$device\s*$", call), call


def test_shim_exports_reference_api():
    src = _shim_source()
    defined = set(re.findall(r"^(\w+) <- function\(", src, flags=re.M))
    missing = _REQUIRED_EXPORTS - defined
    assert not missing, f"shim missing exports: {sorted(missing)}"
    assert not {"tpu_init", "causal_forest_tpu"} & defined
    formals, body = _r_function_blocks(src)["torch_init"]
    assert re.search(r"\bpython\s*=\s*NULL", formals) and re.search(r"\bdevice\s*=\s*NULL", formals)
    assert ".torch$device <- device" in body


def test_shim_delimiters_balance():
    """(), {}, [] balance outside strings and comments."""
    cleaned = []
    for line in _shim_source().splitlines():
        line = re.sub(r'"[^"]*"', '""', line)
        cleaned.append(line.split("#", 1)[0])
    text = "\n".join(cleaned)
    for open_c, close_c in ("()", "{}", "[]"):
        assert text.count(open_c) == text.count(close_c), open_c + close_c
    depth = 0
    for ch in text:
        depth += ch == "("
        depth -= ch == ")"
        assert depth >= 0, "close-paren before open"
    assert depth == 0


def test_shim_exposes_compat_knobs():
    blocks = _r_function_blocks(_shim_source())
    for fn, knobs in _COMPAT_KNOBS.items():
        assert fn in blocks, f"shim missing {fn}"
        formals, body = blocks[fn]
        for knob in knobs:
            assert re.search(rf"\b{knob}\s*=", formals), (fn, knob)
            assert re.search(rf"\b{knob}\b", body), (fn, knob)


def test_bridge_accepts_every_shim_knob():
    bridge_name = {"causal_forest_torch": "causal_forest"}
    for fn, knobs in _COMPAT_KNOBS.items():
        params = inspect.signature(getattr(rbridge, bridge_name.get(fn, fn))).parameters
        for knob in knobs:
            assert knob in params, (fn, knob)


def test_driver_notebook_uses_the_shim():
    with open(os.path.join(_R_DIR, "ate_replication_torch.Rmd")) as f:
        rmd = f.read()
    assert 'source("ate_functions_torch.R")' in rmd and "torch_init()" in rmd
    assert 'reticulate::import("ate_replication_causalml_torch.rbridge")' in rmd
    assert "causal_forest_torch(" in rmd
    assert "tpu_init" not in rmd and "causal_forest_tpu" not in rmd


def _check_as_row_contract(res):
    assert isinstance(res["Method"], str)
    for k in ("ATE", "lower_ci", "upper_ci"):
        v = res[k]
        assert isinstance(v, float), (k, type(v))
        assert math.isfinite(v) or math.isnan(v)


def test_plain_list_payloads_round_trip():
    cols = _reticulate_payload()
    _check_as_row_contract(rbridge.naive_ate(cols, device="cpu"))
    _check_as_row_contract(rbridge.ate_condmean_ols(cols, device="cpu"))
    p = rbridge.logistic_propensity(cols, device="cpu")
    p_list = [float(v) for v in np.asarray(p)]
    assert len(p_list) == 400
    _check_as_row_contract(rbridge.prop_score_weight(cols, p_list, device="cpu"))
    _check_as_row_contract(rbridge.prop_score_ols(cols, p_list, device="cpu"))
    _check_as_row_contract(rbridge.ate_condmean_lasso(cols, device="cpu"))
    _check_as_row_contract(rbridge.doubly_robust(cols, num_trees=8, device="cpu"))


def test_compat_knob_values_change_results():
    """The corrected modes are selectable through the bridge and move the
    estimate on a confounded panel: the knob reaches the estimator."""
    cols = _reticulate_payload(n=600, seed=3)
    r_row = rbridge.doubly_robust_glm(cols, device="cpu")
    fixed_row = rbridge.doubly_robust_glm(cols, compat="fixed", device="cpu")
    assert r_row["ATE"] != fixed_row["ATE"]
    dml_r = rbridge.double_ml(cols, num_trees=8, device="cpu")
    dml_full = rbridge.double_ml(cols, num_trees=8, crossfit="full", device="cpu")
    assert dml_r["ATE"] != dml_full["ATE"]
    dml_pooled = rbridge.double_ml(cols, num_trees=8, se_mode="pooled", device="cpu")
    assert dml_pooled["lower_ci"] != dml_r["lower_ci"]
    for row in (r_row, fixed_row, dml_r, dml_full, dml_pooled):
        _check_as_row_contract(row)
