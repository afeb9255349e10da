"""The JAX package's explicit backend names in the port: every
``hist_backend`` its ``resolve_hist_backend`` passes through ("auto",
"xla", "onehot", "pallas", "pallas_bf16", "pallas_interpret"), the
``allow_lossy_bf16`` policy, and ``row_backend="pallas_interpret"``.

Contracts (all exact, on the CPU at small sizes):

* each name passes through the port's ``resolve_hist_backend`` as
  through the JAX package's, and ``check_hist_backend`` takes it (the
  sharded fits too, "onehot" refused there as in the JAX package);
* "pallas" is the port's kernels and "pallas_interpret" their plain
  versions: on the CPU both grow the "auto" forest field for field
  (classifier, continuous regressor, causal forest, one-rank sharded
  fits); "pallas_interpret" is refused for a CUDA device, naming
  "pallas" or "auto";
* ``allow_lossy_bf16`` turns "auto" into "pallas_bf16" only on a CUDA
  device from 8,192 rows at ≤ 128 bins, the JAX package's TPU rule
  (``tests/test_hist_pallas.py::test_resolve_backend_bf16_policy``, the
  device faked as the JAX test fakes its backend);
* ``predict_cate(row_backend="pallas_interpret")`` on the CPU equals
  ``row_backend=None`` bit for bit, and the warmed predict takes it.
"""

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import hist as th
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.parallel.mesh import make_mesh
from ate_replication_causalml_tpu.ops import hist_pallas as jh

JAX_NAMES = ("auto", "xla", "onehot", "pallas", "pallas_bf16", "pallas_interpret")
FOREST_FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "train_leaf", "bin_edges")
CAUSAL_FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")
KW = dict(n_trees=6, depth=4, n_bins=16)
CUDA = torch.device("cuda")  # a device object only: nothing is allocated on it


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(29)
    n, p = 360, 6
    x = rng.normal(size=(n, p)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])
    y01 = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(np.float32)
    ycont = (1.0 + x[:, 0] - 0.5 * x[:, 1] + rng.normal(size=n)).astype(np.float32)
    wt = (rng.random(n) - 0.5).astype(np.float32)
    yt = ((1.0 + x[:, 0]) * wt + 0.3 * rng.normal(size=n)).astype(np.float32)
    return tuple(torch.as_tensor(a) for a in (x, y01, ycont, wt, yt))


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_jax_name_passes_through_and_is_taken(name):
    if name != "auto":  # the JAX package resolves its "auto" per platform
        assert jh.resolve_hist_backend(name, n_rows=10**7, n_bins=64) == name
    assert th.resolve_hist_backend(name, n_rows=10**7, n_bins=64, device="cpu") == name
    assert th.resolve_hist_backend(name, n_rows=10**7, n_bins=64, device=CUDA,
                                   allow_lossy_bf16=True) == ("pallas_bf16" if name == "auto"
                                                              else name)
    tf.check_hist_backend(name, device="cpu")
    if name == "onehot":
        with pytest.raises(ValueError, match="sharded path"):
            tf.check_hist_backend(name, sharded=True, device="cpu")
    else:
        tf.check_hist_backend(name, sharded=True, device="cpu")
    if name == "pallas_interpret":
        with pytest.raises(ValueError, match="'pallas' or 'auto'"):
            tf.check_hist_backend(name, device=CUDA)
    else:
        tf.check_hist_backend(name, device=CUDA)


def test_unknown_names_are_refused():
    for name in ("pallas_fp8", "gather", ""):
        with pytest.raises(ValueError, match="not ported"):
            tf.check_hist_backend(name, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tcf._check_row_backend("onehot", "cpu")


def test_lossy_bf16_policy_mirrors_jax():
    """The JAX package's TPU rule on a CUDA device; the CPU unchanged."""
    big = th._PALLAS_ROWS_THRESHOLD
    assert big == jh._PALLAS_ROWS_THRESHOLD
    pick = lambda **kw: th.resolve_hist_backend("auto", device=CUDA, **kw)
    assert pick(n_rows=big, n_bins=64, integer_weights=True) == "auto"
    assert pick(n_rows=big, n_bins=64, integer_weights=False) == "auto"
    assert pick(n_rows=big, n_bins=64, allow_lossy_bf16=True) == "pallas_bf16"
    assert pick(n_rows=big, n_bins=128, allow_lossy_bf16=True) == "pallas_bf16"
    # Below the threshold, past 128 bins, or without the sizes: no upgrade.
    assert pick(n_rows=big - 1, n_bins=64, allow_lossy_bf16=True) == "auto"
    assert pick(n_rows=big, n_bins=200, allow_lossy_bf16=True) == "auto"
    assert pick(n_rows=big, allow_lossy_bf16=True) == "auto"
    assert pick(n_rows=1000, n_bins=64, integer_weights=True) == "auto"
    # On the CPU the flag changes nothing, as off a TPU in the JAX package.
    assert th.resolve_hist_backend("auto", n_rows=big, n_bins=64, allow_lossy_bf16=True,
                                   device="cpu") == "auto"


def _grow(kind, data, backend, key_seed=5, mesh=None):
    x, y01, ycont, wt, yt = data
    key = rnd.key(key_seed, device="cpu")
    if kind == "causal":
        kw = dict(n_trees=8, depth=4, n_bins=16, hist_backend=backend)
        if mesh is not None:
            return tcf.grow_causal_forest_sharded(x, wt, yt, key, mesh, **kw)
        return tcf.grow_causal_forest(x, wt, yt, key, **kw)
    y = y01 if kind == "classifier" else ycont
    if mesh is not None:
        return tf.fit_forest_sharded(x, y, key, mesh, hist_backend=backend, **KW)
    return tf.fit_forest_classifier(x, y, key, hist_backend=backend, **KW)


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["classifier", "regressor", "causal"])
def test_pallas_names_grow_the_auto_forest(data, kind, backend):
    auto, other = _grow(kind, data, "auto"), _grow(kind, data, backend)
    for f in CAUSAL_FIELDS if kind == "causal" else FOREST_FIELDS:
        assert torch.equal(getattr(other, f), getattr(auto, f)), (kind, backend, f)


@pytest.mark.parametrize("backend", ["pallas", "pallas_bf16", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["regressor", "causal"])
def test_sharded_fits_take_the_pallas_names(data, kind, backend):
    """On a one-rank tree mesh every key is grown here: the sharded fit
    under each name equals the unsharded fit under it."""
    mesh = make_mesh(("tree",))
    sharded, plain = _grow(kind, data, backend, mesh=mesh), _grow(kind, data, backend)
    for f in CAUSAL_FIELDS if kind == "causal" else FOREST_FIELDS:
        assert torch.equal(getattr(sharded, f), getattr(plain, f)), (kind, backend, f)


def test_bf16_classifier_is_the_auto_classifier(data):
    """"pallas_bf16" on a 0/1 target: every weight an integer that bf16
    holds exactly, so the "auto" forest field for field."""
    auto, bf16 = _grow("classifier", data, "auto", 7), _grow("classifier", data, "pallas_bf16", 7)
    for f in FOREST_FIELDS:
        assert torch.equal(getattr(bf16, f), getattr(auto, f)), f


def test_fit_causal_forest_takes_the_names(data):
    x, y01, ycont, _, _ = data
    from ate_replication_causalml_torch.data.frame import CausalFrame

    frame = CausalFrame(x, y01, (ycont > 1.0).to(torch.float32))
    kw = dict(key=rnd.key(3, device="cpu"), n_trees=4, depth=3, nuisance_trees=4,
              nuisance_depth=3, n_bins=16)
    auto = tcf.fit_causal_forest(frame, **kw)
    for backend in ("pallas", "pallas_interpret"):
        other = tcf.fit_causal_forest(frame, hist_backend=backend, **kw)
        assert torch.equal(other.y_hat, auto.y_hat) and torch.equal(other.w_hat, auto.w_hat)
        for f in CAUSAL_FIELDS:
            assert torch.equal(getattr(other.forest, f), getattr(auto.forest, f)), (backend, f)
    tcf.fit_causal_forest(frame, hist_backend="pallas_bf16", **kw)


@pytest.mark.parametrize("oob", [True, False])
def test_predict_cate_pallas_interpret_equals_default(data, oob):
    x = data[0]
    forest = _grow("causal", data, "auto")
    want = tcf.predict_cate(forest, x, oob=oob)
    got = tcf.predict_cate(forest, x, oob=oob, row_backend="pallas_interpret")
    assert torch.equal(got.cate, want.cate) and torch.equal(got.variance, want.variance)
    warm = tcf.lower_predict_cate(forest, 8, row_backend="pallas_interpret")
    served = warm(forest, x[:8].numpy())
    ref = tcf.predict_cate(forest, x[:8], oob=False)
    assert np.array_equal(served.cate, ref.cate.numpy())


def test_row_backend_pallas_interpret_refused_on_a_cuda_device():
    tcf._check_row_backend("pallas_interpret", "cpu")
    with pytest.raises(ValueError, match="'pallas' or 'auto'"):
        tcf._check_row_backend("pallas_interpret", CUDA)
    for name in tcf.ROW_BACKENDS[:-1]:
        tcf._check_row_backend(name, CUDA)
