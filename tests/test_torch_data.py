"""The port's L0 data stages equal the JAX package's: synthetic pool,
prepare_dataset (R-compatible sampling, z-scoring, na.omit), bias
injection, the CSV loader and the CausalFrame helpers."""

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.data import pipeline as tp
from ate_replication_causalml_torch.data import synthetic as ts
from ate_replication_causalml_torch.utils.rrandom import RCompatRNG as TorchRNG
from ate_replication_causalml_tpu.data import pipeline as jp
from ate_replication_causalml_tpu.data import synthetic as js
from ate_replication_causalml_tpu.utils.rrandom import RCompatRNG as JaxRNG


@pytest.fixture(scope="module")
def raw():
    return js.make_ggl_like(20_000, seed=7, true_ate=0.095)


def test_make_ggl_like_equal(raw):
    mine = ts.make_ggl_like(20_000, seed=7, true_ate=0.095)
    assert mine.keys() == raw.keys()
    for k in raw:
        assert np.array_equal(mine[k], raw[k]), k


def test_rcompat_rng_equal():
    a, b = TorchRNG(1991), JaxRNG(1991)
    assert np.array_equal(a.runif(1500), b.runif(1500))
    assert np.array_equal(a.sample_int(9000, 500), b.sample_int(9000, 500))
    a, b = TorchRNG(5, "rejection"), JaxRNG(5, "rejection")
    assert np.array_equal(a.sample_int(1000, 300, replace=True),
                          b.sample_int(1000, 300, replace=True))


@pytest.mark.parametrize("tdtype,ndtype", [(torch.float32, np.float32), (torch.float64, np.float64)])
def test_prepare_and_inject_bias_equal(raw, tdtype, ndtype):
    cfg_t = tp.PrepConfig(n_obs=8_000, seed=1991)
    cfg_j = jp.PrepConfig(n_obs=8_000, seed=1991)
    tf = tp.prepare_dataset(raw, cfg_t, dtype=tdtype, device="cpu")
    jf = jp.prepare_dataset(raw, cfg_j, rng=JaxRNG(1991), dtype=ndtype)
    for f in ("x", "w", "y"):
        assert np.array_equal(getattr(tf, f).numpy(), np.asarray(getattr(jf, f))), f
    assert tf.schema.covariates == jf.schema.covariates
    assert np.array_equal(tp.bias_drop_indices(tf, cfg_t), jp.bias_drop_indices(jf, cfg_j))
    tmod, tdrop = tp.inject_bias(tf, cfg_t)
    jmod, jdrop = jp.inject_bias(jf, cfg_j)
    assert np.array_equal(tdrop, jdrop)
    for f in ("x", "w", "y"):
        assert np.array_equal(getattr(tmod, f).numpy(), np.asarray(getattr(jmod, f))), f
    assert np.array_equal(tmod.design_matrix().numpy(), np.asarray(jmod.design_matrix()))
    assert np.array_equal(tmod.column("city").numpy(), np.asarray(jmod.column("city")))


def test_load_raw_csv_equal(tmp_path, raw):
    path = tmp_path / "ggl.csv"
    cols = list(raw)
    rows = np.stack([raw[c][:50] for c in cols], axis=1)
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i, r in enumerate(rows):
            vals = [repr(float(v)) for v in r]
            if i == 3:
                vals[0] = "NA"
            f.write(",".join(vals) + "\n")
    mine = tp.load_raw_csv(str(path))
    ref = jp.load_raw_csv(str(path))
    assert mine.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(mine[k], ref[k], equal_nan=True), k
    assert np.isnan(mine[cols[0]][3])


def test_frame_defaults_to_cuda():
    """Entry points run on the card unless told otherwise: without one,
    a default-device frame raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tp.prepare_dataset(ts.make_ggl_like(500, seed=1), tp.PrepConfig(n_obs=100))
