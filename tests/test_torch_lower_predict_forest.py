"""``models/forest.py::lower_predict_forest``: the classifier forest's
fixed-shape predict (``oob=False``), warmed once and called as
``warm(forest, x)``.

On the CPU it is held with ``array_equal`` to the JAX package's AOT
executable (``lower_predict_forest(...).compile()``) and to its
``predict_forest`` on a JAX forest carried into the port, at tree counts
on both sides of XLA:CPU's 32-wide reduction windows. The ``cuda`` case
holds each graph replay on the card to the eager ``predict_forest`` there.
JAX is imported inside the CPU fixture only, so the ``cuda`` case runs on
a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lower_predict_forest.py -q -k card
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import forest as tf
from ate_replication_causalml_torch.ops import random as rnd
from ate_replication_causalml_torch.ops import tree as tt

N, P, TREES, DEPTH = 400, 7, 70, 4
FIELDS = ("split_feat", "split_bin", "leaf_value", "counts", "bin_edges", "train_leaf", "train_fp")
# Tree counts around XLA:CPU's reduction windows of 32: one window, one
# full window, a padded second window, three windows.
TREE_COUNTS = (1, 16, 33, 70)


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, P)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])
    w = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0] - x[:, 3]))).astype(np.float32)
    return x, w


def _first_trees(forest, k):
    """The forest's first ``k`` trees (either package's Forest)."""
    return dataclasses.replace(forest, **{
        f: getattr(forest, f)[:k] for f in ("split_feat", "split_bin", "leaf_value", "counts",
                                            "train_leaf")})


@pytest.fixture(scope="module")
def pair():
    """A JAX classifier forest (the JAX package's CPU default backend),
    the same forest in the port, and new query rows."""
    import jax
    import jax.numpy as jnp

    from ate_replication_causalml_tpu.models import forest as jf

    x, w = _data(3, N)
    with jax.enable_x64(False):
        jfo = jf.fit_forest_classifier(jnp.asarray(x), jnp.asarray(w), jax.random.key(12325),
                                       n_trees=TREES, depth=DEPTH)
    tfo = tf.forest_from_jax({f: np.asarray(getattr(jfo, f)) for f in FIELDS}, device="cpu")
    q, _ = _data(4, 64)
    return jf, jfo, tfo, q


#: XLA's default backend optimization level. tests/conftest.py runs
#: XLA:CPU at level 1 to halve compile times, and at level 1 a one-row
#: query's tree mean is summed in another order (its reduction windows
#: lie contiguous in memory and LLVM vectorizes them), so the reference
#: executable is compiled at the level the JAX package runs at.
XLA_DEFAULT_OPT_LEVEL = 3


@pytest.mark.parametrize("batch", (1, 64))
@pytest.mark.parametrize("trees", TREE_COUNTS)
def test_equals_jax_predict_forest_and_its_executable(pair, trees, batch):
    import jax
    import jax.numpy as jnp

    jf, jfo, tfo, q = pair
    jsub, tsub = _first_trees(jfo, trees), _first_trees(tfo, trees)
    x = q[:batch]
    with jax.enable_x64(False):
        aot = jf.lower_predict_forest(jsub, batch).compile(
            compiler_options={"xla_backend_optimization_level": XLA_DEFAULT_OPT_LEVEL}
        )(jsub, jnp.asarray(x))
        refs = [aot]
        if batch > 1:  # the harness's level sums these rows in the default order too
            refs.append(jf.predict_forest(jsub, jnp.asarray(x), oob=False))
    warm = tf.lower_predict_forest(tsub, batch)
    assert warm.graph is None  # the CPU takes the plain versions, directly
    got = warm(tsub, x)
    for ref in refs:
        for g, w in ((got.prob, ref.prob), (got.vote, ref.vote)):
            assert g.dtype == np.float32 and g.shape == (batch,)
            assert np.array_equal(g, np.asarray(w))
    eager = tf.predict_forest(tsub, torch.as_tensor(x))
    assert np.array_equal(got.prob, eager.prob.numpy())
    assert np.array_equal(got.vote, eager.vote.numpy())


def test_wrong_query_shape_raises(pair):
    _, _, tfo, q = pair
    warm = tf.lower_predict_forest(tfo, 8)
    for bad in (q[:7], q[:9], q[:8, :P - 1]):
        with pytest.raises(ValueError, match="x must be"):
            warm(tfo, bad)


def test_the_forest_is_a_runtime_argument(pair):
    """A warmed predict serves another forest of the same geometry."""
    _, _, tfo, q = pair
    a, b = _first_trees(tfo, 16), dataclasses.replace(tfo, **{
        f: getattr(tfo, f)[16:32] for f in ("split_feat", "split_bin", "leaf_value", "counts",
                                            "train_leaf")})
    warm = tf.lower_predict_forest(a, 64)
    for f in (a, b, a):
        want = tf.predict_forest(f, torch.as_tensor(q))
        got = warm(f, q)
        assert np.array_equal(got.prob, want.prob.numpy())
        assert np.array_equal(got.vote, want.vote.numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_replay_equals_eager_predict_forest(cuda):
    """Each replay of the captured graph is bit for bit the eager
    predict_forest on the card (40 trees: two reduction windows), one
    traverse launch a replay, no capture after warm, a same-geometry
    forest rebound and another geometry or query shape refused."""
    from ate_replication_causalml_torch import observability as obs

    x, w = _data(5, 2000)
    xc, wc = torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda)
    f1 = tf.fit_forest_classifier(xc, wc, rnd.key(1, device="cuda"), n_trees=40, depth=5)
    f2 = tf.fit_forest_classifier(xc, wc, rnd.key(2, device="cuda"), n_trees=40, depth=5)
    for batch in (64, 2000):
        warm = tf.lower_predict_forest(f1, batch)
        assert warm.graph is not None and warm.traverse_per_replay == 1
        captures = sum((obs.REGISTRY.peek("graph_captures_total") or {}).values())
        for f in (f1, f2, f1):
            q = np.ascontiguousarray(x[:batch][::-1])
            before = tt.traverse.launches
            got = warm(f, q)
            assert tt.traverse.launches - before == 1
            want = tf.predict_forest(f, torch.as_tensor(q, device=cuda))
            assert np.array_equal(got.prob, want.prob.cpu().numpy())
            assert np.array_equal(got.vote, want.vote.cpu().numpy())
        assert sum((obs.REGISTRY.peek("graph_captures_total") or {}).values()) == captures
        with pytest.raises(ValueError, match="x must be"):
            warm(f1, x[:batch - 1])
    with pytest.raises(ValueError, match="geometry"):
        warm(_first_trees(f1, 39), x[:2000])
