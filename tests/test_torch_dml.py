"""The "Double Machine Learning" row (``estimators/dml.py``) against the
JAX package at a small size: 1,600 rows × 21 covariates, 16 trees of
depth 8 per nuisance forest, under ``crossfit`` "r" and "full" and
``se_mode`` "r" and "pooled".

* The four nuisance forests of each run (captured where ``double_ml``
  fits them) equal the JAX package's field for field: the classifier
  weights are integers, so every histogram sum is exact.
* τ and SE within 1e-6: the vote fractions are exact, and the
  residual-on-residual regressions may sum the same float32 products in
  another order (seen at this size: no difference at all).
* Under ``ATE_TPU_PREDICT_PACK=1`` (the packed-code policy: the
  partition levels at widths 32 and 64 read packed words) the results
  are the unpacked ones bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data.frame import CausalFrame as TFrame
from ate_replication_causalml_torch.estimators import dml as td
from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import pack as tp
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_tpu.data.frame import CausalFrame as JFrame
from ate_replication_causalml_tpu.estimators import dml as jd

N, P, TREES, DEPTH = 1600, 21, 16, 8
FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges")
MODES = [("r", "r"), ("r", "pooled"), ("full", "r")]
BOUND = 1e-6


def _data(seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, P)).astype(np.float32)
    x[:, 4] = np.round(x[:, 4])
    w = (rng.random(N) < 1 / (1 + np.exp(-x[:, 0] - 0.5 * x[:, 4]))).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-(x[:, 1] + 0.4 * w)))).astype(np.float32)
    return x, w, y


def _capture(mp, module):
    """Record every forest ``module._fit_nuisance_forest`` returns."""
    seen = []
    real = module._fit_nuisance_forest

    def fit(*args, **kwargs):
        forest = real(*args, **kwargs)
        seen.append(forest)
        return forest

    mp.setattr(module, "_fit_nuisance_forest", fit)
    return seen


def _port_run(frame, key_data, crossfit, se_mode):
    with pytest.MonkeyPatch.context() as mp:
        forests = _capture(mp, td)
        res = td.double_ml(frame, n_trees=TREES, depth=DEPTH,
                           key=rnd.key_from_jax(key_data, device="cpu"), crossfit=crossfit,
                           se_mode=se_mode, device="cpu")
    return res, forests


@pytest.fixture(scope="module")
def runs():
    x, w, y = _data()
    tframe = TFrame(*(torch.as_tensor(a) for a in (x, w, y)))
    out = {}
    with pytest.MonkeyPatch.context() as env:
        env.delenv(tp.ENV_PACK, raising=False)
        env.delenv(th.HIST_MODE_ENV, raising=False)
        with jax.enable_x64(False):
            k = jax.random.key(5)
            key_data = np.asarray(jax.random.key_data(k))
            jframe = JFrame(*(jnp.asarray(a) for a in (x, w, y)))
            for crossfit, se_mode in MODES:
                with pytest.MonkeyPatch.context() as mp:
                    jforests = _capture(mp, jd)
                    ref = jd.double_ml(jframe, n_trees=TREES, depth=DEPTH, key=k,
                                       crossfit=crossfit, se_mode=se_mode)
                ref_f = [{f: np.asarray(getattr(fo, f)) for f in FIELDS} for fo in jforests]
                out[crossfit, se_mode] = dict(ref=ref, ref_forests=ref_f)
        for (crossfit, se_mode), d in out.items():
            d["got"], d["forests"] = _port_run(tframe, key_data, crossfit, se_mode)
    return dict(out=out, tframe=tframe, key_data=key_data)


@pytest.mark.parametrize("crossfit,se_mode", MODES)
def test_double_ml_equals_jax(runs, crossfit, se_mode):
    d = runs["out"][crossfit, se_mode]
    assert len(d["forests"]) == len(d["ref_forests"]) == 4
    for i, (mine, ref) in enumerate(zip(d["forests"], d["ref_forests"])):
        for f in FIELDS:
            got = getattr(mine, f).numpy()
            assert got.shape == ref[f].shape and np.array_equal(got, ref[f]), (i, f)
    got, ref = d["got"], d["ref"]
    assert got.method == ref.method == "Double Machine Learning"
    assert abs(got.ate - ref.ate) <= BOUND and abs(got.se - ref.se) <= BOUND, (
        got.ate - ref.ate, got.se - ref.se)
    assert np.isfinite(got.ate) and got.se > 0


def test_se_modes_share_the_forests(runs):
    """"r" and "pooled" fit the same forests and the same τ; only the SE
    combination differs."""
    a, b = runs["out"]["r", "r"], runs["out"]["r", "pooled"]
    assert a["got"].ate == b["got"].ate and a["got"].se != b["got"].se
    for fa, fb in zip(a["forests"], b["forests"]):
        assert torch.equal(fa.split_feat, fb.split_feat)


@pytest.mark.parametrize("crossfit", ["r", "full"])
def test_packed_policy_bit_for_bit(runs, crossfit, monkeypatch):
    """``ATE_TPU_PREDICT_PACK=1`` sends the partition widths (32 and 64 at
    depth 8) to the packed pass: the same forests, τ and SE bit for bit."""
    monkeypatch.setenv(tp.ENV_PACK, "1")
    monkeypatch.delenv(th.HIST_MODE_ENV, raising=False)
    calls = []
    real = th.bin_histogram_packed_plain
    monkeypatch.setattr(th, "bin_histogram_packed_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, forests = _port_run(runs["tframe"], runs["key_data"], crossfit, "r")
    base = runs["out"][crossfit, "r"]
    assert (got.ate, got.se) == (base["got"].ate, base["got"].se)
    for mine, ref in zip(forests, base["forests"]):
        for f in FIELDS:
            assert torch.equal(getattr(mine, f), getattr(ref, f)), f
    assert len(calls) == 4 * 2  # four forests of one chunk, two packed widths each


def test_bad_arguments_raise_as_in_jax():
    x, w, y = _data()
    tframe = TFrame(*(torch.as_tensor(a) for a in (x, w, y)))
    jframe = JFrame(*(jnp.asarray(a) for a in (x, w, y)))
    for kw, match in ((dict(se_mode="R"), "se_mode must be"), (dict(crossfit="half"), "crossfit must be")):
        with pytest.raises(ValueError, match=match):
            jd.double_ml(jframe, n_trees=2, depth=2, **kw)
        with pytest.raises(ValueError, match=match):
            td.double_ml(tframe, n_trees=2, depth=2, device="cpu", **kw)


def test_runs_on_the_card_unless_told_otherwise():
    """The entry point's default device is ``cuda``: without a card it
    raises instead of running on the CPU."""
    x, w, y = _data()
    tframe = TFrame(*(torch.as_tensor(a) for a in (x, w, y)))
    if torch.cuda.is_available():
        assert td.double_ml(tframe, n_trees=2, depth=2).se > 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.double_ml(tframe, n_trees=2, depth=2)
