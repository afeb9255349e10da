"""The default frontier's two ``aipw_logit`` coverage gaps (n = 256,
p = 96, sparsity 0 and 4) are a float32 reduction gap, not a fault of the
port: the CPU port's lanes against the JAX package's obey the bound that
``scripts/torch_frontier_gap.py`` holds the card to (its docstring derives
it). Every lane determined in float32 (γ_n·κ < 1) is within
γ_n·κ·(|τ̂| + SE) in τ̂ and SE, and every lane whose coverage indicator or
finiteness differs is undetermined (a quasi-separated outcome fit). The
first 64 replicates of each point (two blocks) keep the file near 20 s.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from ate_replication_causalml_tpu.scenarios import batched as jb
from ate_replication_causalml_tpu.scenarios import frontier as jfr

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "scripts"))
import torch_frontier_gap as gap  # noqa: E402

REPS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_lanes(knobs: dict, reps: int) -> np.ndarray:
    spec = jfr.default_frontier_spec(0)
    dgp = jfr.dgp_for(spec.baseline, knobs)
    width = spec.width()
    with jax.enable_x64(False):
        exe = jb.column_executable(dgp, jb.SCENARIO_ESTIMATORS[gap.ESTIMATOR], width)
        root = jfr.FrontierSearch(spec, log=lambda s: None).root_key
        out = []
        for lo in range(0, reps, width):
            batch = tuple(range(lo, min(lo + width, reps)))
            a, s, t = exe(root, jb.pad_ids(dgp.name, batch, width))
            out.append(np.stack([np.asarray(x)[:len(batch)] for x in (a, s, t)]))
    return np.concatenate(out, axis=1).astype(np.float64)


@pytest.mark.parametrize("knobs", gap.POINTS, ids=lambda k: f"sparsity{k['sparsity']}")
def test_port_lanes_within_the_float32_bound_of_jax(knobs):
    port = gap.lanes(knobs, "cpu", REPS)
    ref = _jax_lanes(knobs, REPS)
    # The draw is the same bits in both packages; tau_true is a float32
    # mean over n rows, so it may differ in its last place.
    np.testing.assert_allclose(port[2], ref[2], rtol=0, atol=4 * gap.U32)
    kappa = gap.lane_kappas(knobs, REPS)
    res = gap.classify(port, ref, kappa, knobs["n"])
    assert res["held"], res
    # Not vacuous: the points hold undetermined lanes, and the determined
    # ones differ (a reduction gap, not equal bits).
    assert res["determined"] < REPS and res["max_abs_d_ate"] > 0.0
    # And the rule refuses a determined lane moved past its bound.
    i = int(np.nonzero((gap.gamma(knobs["n"]) * kappa < 1) & np.isfinite(port[1]))[0][0])
    bad = port.copy()
    bad[0, i] += 2 * gap.gamma(knobs["n"]) * kappa[i] * (abs(ref[0, i]) + ref[1, i])
    assert not gap.classify(bad, ref, kappa, knobs["n"])["held"]
